"""The search init of the ``pixflow_search_*`` presets
(``models/pixflow.py``): ``search_init`` scores every candidate offset of
every direction of a (2N, H, W) stack in one pass, and ``coarsest_start``
hands its flow to the coarsest level (or, under ``_fast``, to the
init-floor twin's exact solve).

On the CPU:

* the batched search equals, byte for byte, the per-direction search of
  the benchmark's frozen plain reference
  (``portbench.reference.pixflow.adjust_initial_flow``), entry by entry:
  at six's coarsest level (30 x 27) and the ``_fast`` twin's (29 x 26),
  for both orders of the hints, N = 1 and 3; a plane with no alpha (the
  NaN path at the zero offset); planes whose SAD maps tie (the first
  offset wins);
* the descents give the bytes they give with the per-direction search in
  its place: ``compute_optical_flow_pairs`` (which also equals the frozen
  reference's flows) and the row-tiled solver;
* the tracer's ``search_maps`` counts 19 maps a searched direction,
  eagerly and through a program's capture and replays, and none under
  ``pixflow_low``.

On the card (they skip without CUDA): the batched search equals the
per-direction one byte for byte at 30 x 27 and 29 x 26 on stacks of 2
and 8; a ``stitch_six`` at 9000 x 4000 under ``pixflow_search_20``,
replayed, equals ``portbench.reference``.  This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_search_init.py -q
"""

import numpy as np
import pytest
import torch

from panorama_opticalflow_tpu_torch import (StitchConfig,
                                            flow_params_by_name,
                                            synthesize_fisheye_set, to_torch)
from panorama_opticalflow_tpu_torch.models import pipeline
from panorama_opticalflow_tpu_torch.models import pixflow as pf
from panorama_opticalflow_tpu_torch.parallel import mesh, tiled
from panorama_opticalflow_tpu_torch.utils import programs, runtime, trace
from panorama_opticalflow_tpu_torch.utils.config import with_flow_params

from portbench import compare, inputs
from portbench.reference import config as rconfig
from portbench.reference import pipeline as rpipeline
from portbench.reference import pixflow as rpixflow

torch.set_num_threads(2)
runtime.settle_cpu_math()

PARAMS = flow_params_by_name("pixflow_search_20")
# the maps a searched direction scores: the zero offset and the box's 18
MAPS = 19
HINTS = {"left right": ("left", "right"), "right left": ("right", "left")}
SHAPES = {"six coarsest": (30, 27), "fast twin": (29, 26)}
# the descents' inputs: the finest level of each flow (104 rows) takes
# the kernels' plain contracts, the levels above it the plain path
HW = (208, 448)
KERNEL_MIN = 20000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file with --noconftest on "
                    "the machine with the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _planes(rng, n, h, w, dx=-3, device="cpu"):
    """A coarsest level's (2N, h, w) images and alphas, entry 2n + d the
    image d of pair n: a smooth texture, its partner shifted by ``dx``
    columns and up to a row, and re-gained, and alphas with an empty band
    and holes."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs, alphas = [], []
    for _ in range(n):
        ph = rng.random(4) * 6
        img = (0.5 + 0.25 * np.sin(xx / 2.7 + ph[0]) * np.cos(yy / 3.9 + ph[1])
               + 0.1 * np.sin((xx - yy) / 1.9 + ph[2])
               + 0.05 * rng.random((h, w)))
        dy = rng.integers(-1, 2)
        imgs += [img, np.roll(img, (dy, dx), axis=(0, 1)) * 1.1]
        for _ in range(2):
            a = (rng.random((h, w)) > 0.05).astype(np.float32)
            a[:, : int(rng.integers(0, 4))] = 0.0
            alphas.append(a)
    return (torch.tensor(np.stack(imgs), dtype=torch.float32, device=device),
            torch.tensor(np.stack(alphas), dtype=torch.float32,
                         device=device))


def _per_direction(imgs, alphas, hints, params=PARAMS):
    """The frozen reference's search, one direction at a time."""
    i1, a1 = pf._partner(imgs), pf._partner(alphas)
    return torch.stack([rpixflow.adjust_initial_flow(
        imgs[b], i1[b], alphas[b], a1[b], hints[b % 2], params)
        for b in range(imgs.shape[0])])


def _batched(imgs, alphas, hints, params=PARAMS):
    return pf.search_init(imgs, pf._partner(imgs), alphas,
                          pf._partner(alphas), hints, params)


@pytest.mark.parametrize("hints", HINTS.values(), ids=HINTS.keys())
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("hw", SHAPES.values(), ids=SHAPES.keys())
def test_batched_search_equals_the_per_direction_search(hw, n, hints):
    # each direction's hint points the way its partner is shifted
    imgs, alphas = _planes(np.random.default_rng(n), n, *hw,
                           dx=-3 if hints[0] == "left" else 3)
    got = _batched(imgs, alphas, hints)
    want = _per_direction(imgs, alphas, hints)
    assert got.shape == (2 * n, *hw, 2)
    assert torch.equal(_bits(got), _bits(want))
    assert got.abs().max() >= 2                 # the search moved pixels


def _stripes(h, w):
    """Pair planes whose SAD maps tie: columns of 0.25 and 0.75 (constant
    along y, even width: the exposure ratio is exactly 1), the partner
    shifted by one column; every odd horizontal offset, at every vertical
    one, matches exactly."""
    row = np.where(np.arange(w) % 2 == 0, 0.25, 0.75).astype(np.float32)
    img = np.broadcast_to(row, (h, w))
    imgs = torch.tensor(np.stack([img, np.roll(img, 1, axis=1)]))
    return imgs, torch.ones_like(imgs)


@pytest.mark.parametrize("case", ["zero alpha", "tied maps"])
def test_special_planes_equal_the_per_direction_search(case):
    hints = ("left", "right")
    if case == "zero alpha":
        imgs, alphas = _planes(np.random.default_rng(5), 2, 30, 27)
        # pair 0's image 1 has no alpha: direction 0 has no overlap (a NaN
        # exposure ratio and NaN maps: the zero offset's bias wins),
        # direction 1 no pixel to update
        alphas[1] = 0.0
    else:
        imgs, alphas = _stripes(29, 26)
    got = _batched(imgs, alphas, hints)
    assert torch.equal(_bits(got), _bits(_per_direction(imgs, alphas,
                                                        hints)))
    if case == "zero alpha":
        assert not got[:2].any() and got[2:].abs().max() >= 2
    else:
        # inside (rows past the first, columns the box's reach from the
        # border) the first of the tied offsets in scan order wins: dy -1,
        # then the leftmost odd dx of the box
        inner = (slice(1, None), slice(8, -8))
        assert (got[0][inner] == torch.tensor([-5.0, -1.0])).all()
        assert (got[1][inner] == torch.tensor([1.0, -1.0])).all()


def _pairs(n):
    sets = [inputs.four_input_set(*HW, inputs.item_rng(2**40 + 23, k), "cpu")
            for k in range(n)]
    ls, rs = zip(*(pipeline.compose_four(s) for s in sets))
    return torch.stack(ls), torch.stack(rs)


@pytest.fixture
def per_direction(monkeypatch):
    """Runs the descents with the per-direction search in the batched
    search's place."""
    def search(i0, i1, alpha0, alpha1, hints, params):
        return torch.stack([rpixflow.adjust_initial_flow(
            i0[b], i1[b], alpha0[b], alpha1[b], hints[b % 2], params)
            for b in range(i0.shape[0])])

    def use():
        monkeypatch.setattr(pf, "search_init", search)
    return use


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("alg", ["pixflow_search_20",
                                 "pixflow_search_20_fast"])
def test_flow_pairs_equal_the_per_direction_search(alg, n, per_direction):
    params = with_flow_params(StitchConfig(flow_alg=alg),
                              pallas_min_pixels=KERNEL_MIN).flow_params
    ls, rs = _pairs(n)
    with trace.recording() as rec:
        got = torch.stack(pf.compute_optical_flow_pairs(ls, rs, params))
    assert rec.search_maps == 2 * n * MAPS
    ref = torch.stack(rpixflow.optical_flow_pairs(
        ls, rs, rconfig.StitchConfig(
            flow_alg=alg, kernel_min_pixels=KERNEL_MIN).flow_params))
    per_direction()
    want = torch.stack(pf.compute_optical_flow_pairs(ls, rs, params))
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got), _bits(ref))
    assert got.abs().max() > 1.0                 # a real flow was solved


@pytest.mark.parametrize("alg,n,tc", [
    ("pixflow_search_20", 4, tiled.TileConfig(8, 24)),
    ("pixflow_search_20_fast", 8, tiled.TileConfig(8, 28)),
    ("pixflow_search_20_fast", 4, tiled.TileConfig(8, 24))],
    ids=["search top whole", "fast top whole", "fast top tiled"])
def test_tiled_flows_equal_the_per_direction_search(alg, n, tc,
                                                   per_direction):
    """The row-tiled solver searches the coarsest level (or the twin)
    computed whole, or on each halo-extended tile of it."""
    import dataclasses

    h, w = 512, 192
    photos, _ = synthesize_fisheye_set(h, w, n=2, seed=5, with_top=False)
    params = dataclasses.replace(flow_params_by_name(alg),
                                 relax_iters_per_phase=3)
    sizes = pf.pyramid_sizes(h // 2, w // 2, params)
    assert tiled.tiled_levels(sizes, n, tc)[-1] == (tc.level_halo == 24
                                                    and alg.endswith("fast"))

    def flows():
        return torch.cat(tiled.tiled_compute_optical_flow_pair(
            *(to_torch(p, "cpu").reshape(n, h // n, w, 4) for p in photos),
            params, ("left", "right"), mesh.InProcessRows(n), h, tc))

    with trace.recording() as rec:
        got = flows()
    assert rec.search_maps > 0 and rec.search_maps % MAPS == 0
    per_direction()
    assert torch.equal(_bits(got), _bits(flows()))


def _flows(ls, rs, params):
    return torch.cat(pf.compute_optical_flow_pairs(ls, rs, params))


class _Mark:
    """A stand-in for a timing event, all at one time."""

    def elapsed_time(self, other):
        return 0.0

    def synchronize(self):
        pass


class _Captured:
    """A stand-in for a captured program on the CPU: its construction runs
    the body once under ``trace.capturing``, as a capture does, and a call
    runs no Python of the body, as a replay does not: it hands the
    capture's record to the tracer."""

    def __init__(self, body, tensors, static, constants):
        self.name = body.__qualname__
        with programs._reading(constants), \
                trace.capturing(_Mark) as self.boundaries:
            self.outputs = body(*tensors, *static)

    def __call__(self, tensors):
        trace.replayed(self.name, self.boundaries)
        return self.outputs


@pytest.mark.parametrize("alg,maps", [("pixflow_search_20", MAPS),
                                      ("pixflow_search_20_fast", MAPS),
                                      ("pixflow_low", 0)])
def test_search_maps_count_through_capture_and_replays(alg, maps,
                                                       monkeypatch):
    """A key's eager call counts as it runs; its capture's count is kept
    with the program and counted by every replay (the capture's own
    replay included), never by the capture itself."""
    monkeypatch.setattr(programs, "_captures",
                        lambda device: not programs._disabled)
    monkeypatch.setattr(programs, "_Program", _Captured)
    programs.clear()
    params = with_flow_params(StitchConfig(flow_alg=alg),
                              pallas_min_pixels=KERNEL_MIN).flow_params
    ls, rs = _pairs(2)
    counts = []
    try:
        for _ in range(3):       # eager; capture and replay; replay
            with trace.recording() as rec:
                programs.run(_flows, (ls, rs), params)
            counts.append(rec.search_maps)
        (prog,) = programs._cache.values()
        assert prog.boundaries.search_maps == 2 * 2 * maps
    finally:
        programs.clear()
    assert counts == [2 * 2 * maps] * 3


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stack", [2, 8])
@pytest.mark.parametrize("hw", SHAPES.values(), ids=SHAPES.keys())
def test_batched_search_equals_the_per_direction_search_on_the_card(
        cuda, hw, stack):
    for seed, hints in enumerate(HINTS.values()):
        imgs, alphas = _planes(np.random.default_rng(seed + 7), stack // 2,
                               *hw, dx=-3 if hints[0] == "left" else 3,
                               device=cuda)
        if seed:
            alphas[1] = 0.0                      # the NaN path
        got = _batched(imgs, alphas, hints)
        want = _per_direction(imgs, alphas, hints)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), (hw, stack, hints)


def test_search20_chain_replay_equals_the_reference_on_the_card(cuda):
    """The benchmark cell's stitch: the 6-photo rig at 9000 x 4000 under
    ``pixflow_search_20``, its third call (a replay of the captured
    chain) against the frozen reference: every byte."""
    alg = "pixflow_search_20"
    photos, top = inputs.fisheye_set(4000, 9000,
                                     inputs.item_rng(2**33 + 19, 0), cuda)
    cfg = StitchConfig(flow_alg=alg)
    programs.clear()
    try:
        for _ in range(3):
            with trace.recording() as rec:
                out = pipeline.stitch_six(photos, top, cfg, device=cuda)
            torch.cuda.synchronize()
        assert rec.search_maps == 5 * 2 * MAPS
    finally:
        programs.clear()
        torch.cuda.empty_cache()
    ref = rpipeline.stitch_six(photos, top, rconfig.StitchConfig(flow_alg=alg))
    assert compare.numbers(out, ref) == {"footprint_px": 0,
                                         "mean_abs_diff": 0.0}
