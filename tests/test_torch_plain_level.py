"""The small pyramid levels (below ``pallas_min_pixels``) on hand-written
kernels: ``ops.kernels.small_relax_phase``, ``small_relax_phase_unfused``
and ``small_median5_diffuse``, and the gate in
``models.pixflow._level_core`` that sends a small level to them.

The kernels keep the plain branch's borders, so a level on them gives the
bits of the plain branch: ``relax_fast.relax_phase_fast`` (out-of-image
candidates rejected, the reflect-101 target of ``_blur_flow``), then
``im.median5`` and ``low_alpha_flow_diffusion``.  The CPU tests hold the
routing, the wrappers' checks and counters, and the route against the
plain branch and the benchmark's frozen reference.  The card tests (they
skip without CUDA) hold every small level of the benchmark's cells, the
wrappers and whole stitches to the plain branch on the card, every byte
equal.  This file imports no JAX, so on the machine with the card it runs
as

    python -m pytest --noconftest tests/test_torch_plain_level.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from panorama_opticalflow_tpu_torch import (StitchConfig,
                                            flow_params_by_name,
                                            synthesize_fisheye_set,
                                            synthesize_four_input_set)
from panorama_opticalflow_tpu_torch.models import pipeline
from panorama_opticalflow_tpu_torch.models import pixflow as pf
from panorama_opticalflow_tpu_torch.ops import image as im
from panorama_opticalflow_tpu_torch.ops import kernels as tk
from panorama_opticalflow_tpu_torch.ops.relax_exact import (
    _as_planes, _blur_flow, _from_planes, low_alpha_flow_diffusion)
from panorama_opticalflow_tpu_torch.ops.relax_fast import relax_phase_fast
from panorama_opticalflow_tpu_torch.utils import programs, runtime

runtime.settle_cpu_math()

SMALL = ("small_relax_phase", "small_relax_phase_unfused",
         "small_median5_diffuse")
# the levels below pallas_min_pixels of the benchmark's cells: six
# (pixflow_low on a 2000 x 1792 flow window), four and batch4 (pixflow_low,
# 2000 x 4950) and six_lowfast (pixflow_low_fast, 2000 x 1792: its 88 x 78
# top level is refined by the same branch)
SIX = [(244, 218), (220, 196), (198, 176), (178, 158), (160, 142),
       (144, 128), (130, 115), (117, 104), (105, 94), (95, 85), (86, 77),
       (77, 69), (69, 62), (62, 56), (56, 50), (50, 45), (45, 41), (41, 37),
       (37, 33), (33, 30)]
FOUR = [(160, 395), (144, 356), (130, 320), (117, 288), (105, 259),
        (95, 233), (86, 210), (77, 189), (69, 170), (62, 153), (56, 138),
        (50, 124), (45, 112), (41, 101), (37, 91), (33, 82), (30, 74)]
LOWFAST = [(268, 241), (214, 193), (171, 154), (137, 123), (110, 98),
           (88, 78)]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py runs these "
                    "kernels at six's and batch4's largest small levels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _level(rng, b, h, w, alpha="holes", noise=0.5, alg="pixflow_low",
           device="cpu"):
    """A refining level's inputs as ``_level_core`` gets them: textured
    images, their blurred gradients (i1g the partner's), alphas (``holes``:
    zero bands, a half-alpha patch and a hole in every other direction;
    ``ones``) and a smooth incoming flow with ``noise``."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = np.stack([0.5 + 0.2 * np.sin(xx / 3.1 + p) * np.cos(yy / 4.3 + p)
                     + 0.1 * np.sin((xx + yy) / 2.3 + 2 * p)
                     + 0.05 * rng.standard_normal((h, w))
                     for p in rng.random(b) * 6]).astype(np.float32)
    imgs = torch.from_numpy(imgs).to(device)
    alphas = np.ones((b, h, w), np.float32)
    if alpha == "holes":
        alphas[:, :, :max(w // 5, 1)] = 0.0
        alphas[:, h // 3:h // 2 + 1, w // 2:w // 2 + 4] = 0.5
        alphas[1::2, :, w - w // 6:] = 0.0
        alphas[::2, h - max(h // 7, 1):, :] = 0.0
    alphas = torch.from_numpy(alphas).to(device)
    params = flow_params_by_name(alg)
    gx, gy = pf._gradients(imgs, params)
    i1g = torch.stack([pf._partner(gx), pf._partner(gy)], dim=-1)
    f = np.stack([2 * np.sin(yy / 7.0) + 1.5 * np.cos(xx / 5.0),
                  np.cos(yy / 6.0) - 0.5 * np.sin(xx / 9.0)], -1)
    flow = np.stack([f] * b) + noise * rng.standard_normal((b, h, w, 2))
    flow = torch.from_numpy(flow.astype(np.float32)).to(device)
    return (gx.contiguous(), gy.contiguous(), i1g.contiguous(),
            alphas.contiguous(), pf._partner(alphas).contiguous(), flow,
            params)


def _plain_branch(i0x, i0y, i1g, a0, a1, flow, params):
    """The plain branch as ``_level_core`` ran every small level before the
    kernels: per phase the kernel warp (where ``warp_pallas``), then
    ``relax_phase_fast`` and ``im.median5``; then the diffusion."""
    nb = i0x.shape[0]
    update_mask = ((a0 > params.update_alpha_threshold)
                   & (a1 > params.update_alpha_threshold))
    blurred_flow = _blur_flow(flow, params)
    for _ in range(params.relax_phases):
        w1g = (tk.warp_tiled(i1g, flow) if params.warp_pallas
               else tk.warp_tiled_plain(i1g, flow))
        flow = _from_planes(im.median5(_as_planes(relax_phase_fast(
            flow, flow, w1g, i0x, i0y, blurred_flow, update_mask, params,
            params.relax_iters_per_phase, D=params.fast_window))), nb)
    return low_alpha_flow_diffusion(flow, a0, a1, params)


# ---------------------------------------------------------------------------
# CPU: the gate, the route's bits, the wrappers' checks and counters
# ---------------------------------------------------------------------------


def _route(monkeypatch, shape, params):
    """The kernel wrappers ``_level_core`` calls for a refining level of
    ``shape``, in order; each recorder calls the wrapper it replaces."""
    calls = []
    for k in tk.KERNELS:
        name = k.__name__
        monkeypatch.setattr(tk, name, lambda *a, k=k, name=name, **kw: (
            calls.append(name), k(*a, **kw))[1])
    b, h, w = shape
    inputs = _level(np.random.default_rng(1), b, h, w)[:-1]
    pf._level_core(*inputs, params, False)
    return calls


@pytest.mark.parametrize("shape", [(2, 33, 30), (2, 244, 218),
                                   (8, 30, 74), (2, 127, 511)])
def test_a_small_level_takes_three_launches(monkeypatch, shape):
    """Below pallas_min_pixels a single-phase level runs the warp, the
    small relax and the small median + diffusion, once each."""
    params = flow_params_by_name("pixflow_low")
    assert shape[1] * shape[2] < params.pallas_min_pixels
    assert _route(monkeypatch, shape, params) == [
        "warp_tiled", "small_relax_phase", "small_median5_diffuse"]


def test_a_kernel_level_keeps_its_kernels(monkeypatch):
    """At pallas_min_pixels the level keeps the kernel levels' contract."""
    params = dataclasses.replace(flow_params_by_name("pixflow_low"),
                                 pallas_min_pixels=40 * 50)
    assert _route(monkeypatch, (2, 40, 50), params) == [
        "warp_tiled", "relax_phase", "median5_diffuse"]
    assert _route(monkeypatch, (2, 40, 49), params) == [
        "warp_tiled", "small_relax_phase", "small_median5_diffuse"]


@pytest.mark.parametrize("phases,fuse", [(2, True), (3, True), (1, False)])
def test_other_schedules_on_a_small_level(monkeypatch, phases, fuse):
    """Multi-phase (or unfused) small levels: per phase the warp and the
    unfused small relax, median5 after each phase but the last and the
    small median + diffusion after the last."""
    params = dataclasses.replace(flow_params_by_name("pixflow_low"),
                                 relax_phases=phases, fuse_level_blurs=fuse)
    want = []
    for phase in range(phases):
        want += ["warp_tiled", "small_relax_phase_unfused"]
        want.append("median5" if phase < phases - 1
                    else "small_median5_diffuse")
    assert _route(monkeypatch, (2, 45, 41), params) == want


def test_use_pallas_false_keeps_the_plain_branch(monkeypatch):
    params = dataclasses.replace(flow_params_by_name("pixflow_low"),
                                 use_pallas=False)
    assert _route(monkeypatch, (2, 45, 41), params) == []


SCHEDULES = [
    ("pixflow_low", {}),
    ("pixflow_low_fast", {}),
    ("pixflow_low", {"relax_phases": 2, "relax_iters_per_phase": 2}),
    ("pixflow_low", {"fuse_level_blurs": False}),
    ("pixflow_low", {"warp_pallas": False})]


@pytest.mark.parametrize("alg,changes", SCHEDULES)
@pytest.mark.parametrize("shape", [(2, 33, 30), (4, 50, 45)])
def test_the_small_route_gives_the_plain_branch_bits(rng, alg, changes,
                                                     shape):
    """On the CPU the wrappers run their plain versions: the route gives
    every bit of the plain branch it replaced, whatever the schedule."""
    inputs = _level(rng, *shape, alg=alg)
    params = dataclasses.replace(inputs[-1], **changes)
    got = pf._level_core(*inputs[:-1], params, False)
    assert torch.equal(got, _plain_branch(*inputs[:-1], params))
    plain = dataclasses.replace(params, use_pallas=False)
    if params.warp_pallas:
        # the kernel warp's plain version is the plain branch's warp
        assert torch.equal(got, pf._level_core(*inputs[:-1], plain, False))


@pytest.mark.parametrize("alg,changes", SCHEDULES)
@pytest.mark.parametrize("shape", [(2, 40, 50), (4, 130, 140)])
def test_use_pallas_false_gives_the_plain_branch_at_kernel_sizes(
        rng, alg, changes, shape):
    """Without use_pallas a level of kernel size runs the plain branch
    (the small wrappers' plain versions), not the kernel levels'
    contract: every bit of it, whatever the schedule."""
    inputs = _level(rng, *shape, alg=alg)
    params = dataclasses.replace(inputs[-1], use_pallas=False,
                                 pallas_min_pixels=2000, **changes)
    assert shape[1] * shape[2] >= params.pallas_min_pixels
    assert torch.equal(pf._level_core(*inputs[:-1], params, False),
                       _plain_branch(*inputs[:-1], params))


def test_the_small_route_equals_the_benchmark_reference(rng):
    """A small level through the new wrappers gives the bits of the frozen
    plain reference's level at six's largest plain size."""
    from portbench.reference import pixflow as ref_pf
    from portbench.reference.config import StitchConfig as RefConfig

    inputs = _level(rng, 2, 244, 218)
    got = pf._level_core(*inputs[:-1], inputs[-1], False)
    ref = ref_pf._level_core(*inputs[:-1],
                             RefConfig(flow_alg="pixflow_low").flow_params,
                             False)
    assert torch.equal(got, ref)


def _relax_planes(rng, b=2, h=12, w=14):
    i0x, i0y, i1g, a0, a1, flow, params = _level(rng, b, h, w)
    fx, fy = pf._xy(flow)
    w1x, w1y = pf._xy(tk.warp_tiled_plain(i1g, flow))
    mask = ((a0 > 0.9) & (a1 > 0.9)).float()
    return [fx, fy, fx, fy, w1x, w1y, i0x, i0y, mask], params


@pytest.mark.parametrize("fused", [True, False])
def test_small_relax_wrappers_check_their_inputs(rng, fused):
    planes, params = _relax_planes(rng)
    if not fused:
        planes = planes[:8] + [planes[0], planes[1], planes[8]]
    fn = tk.small_relax_phase if fused else tk.small_relax_phase_unfused

    def call(k=None, value=None, iters=3, D=2, p=params):
        a = list(planes)
        if k is not None:
            a[k] = value
        return fn(*a, p, iters, D)

    with pytest.raises(TypeError):          # dtype
        call(0, planes[0].double())
    with pytest.raises(ValueError):         # shape
        call(4, planes[4][:1])
    with pytest.raises(ValueError):         # devices mixed
        call(6, torch.empty_like(planes[6], device="meta"))
    with pytest.raises(ValueError):         # not contiguous
        call(7, planes[7].transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):         # (B, H, W) planes
        fn(*(t[0] for t in planes), params, 3, 2)
    with pytest.raises(ValueError):
        call(iters=0)
    with pytest.raises(ValueError):
        call(D=0)
    with pytest.raises(ValueError):         # reflect-101 needs two
        fn(*(t[:, :1].contiguous() for t in planes), params, 3, 2)
    if fused:
        with pytest.raises(ValueError):
            call(p=dataclasses.replace(params, blurred_flow_kernel_width=0))


def test_small_median5_diffuse_checks_its_inputs(rng):
    x = torch.from_numpy(rng.standard_normal((4, 9, 11)).astype(np.float32))
    c = torch.rand(2, 9, 11)
    with pytest.raises(ValueError):         # (2B, H, W)
        tk.small_median5_diffuse(x[:3], c)
    with pytest.raises(ValueError):         # c is (B, H, W)
        tk.small_median5_diffuse(x, c[:1])
    with pytest.raises(TypeError):
        tk.small_median5_diffuse(x.double(), c)
    with pytest.raises(ValueError):
        tk.small_median5_diffuse(x, c, ksize=0)
    with pytest.raises(ValueError):
        tk.small_median5_diffuse(x[:, :1].contiguous(),
                                 c[:, :1].contiguous())


def test_small_wrappers_on_cpu_are_their_plain_versions(rng):
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing; reset_launch_counts covers the three."""
    planes, params = _relax_planes(rng, 2, 20, 23)
    tk.reset_launch_counts()
    got = tk.small_relax_phase(*planes, params, 3, 2)
    ref = tk.small_relax_phase_plain(*planes, params, 3, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    up = planes[:8] + [planes[2], planes[3], planes[8]]
    got = tk.small_relax_phase_unfused(*up, params, 2, 2)
    ref = tk.small_relax_phase_unfused_plain(*up, params, 2, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    x = torch.stack(got, 1).reshape(4, 20, 23)
    c = torch.rand(2, 20, 23)
    assert torch.equal(tk.small_median5_diffuse(x, c),
                       tk.small_median5_diffuse_plain(x, c))
    for name in SMALL:
        k = getattr(tk, name)
        assert k in tk.KERNELS and k.launches == 0
        k.launches = 3
    tk.reset_launch_counts()
    assert all(getattr(tk, name).launches == 0 for name in SMALL)


def test_expected_launches_count_the_small_levels():
    """chip_smoke's launch model: six's chain has 20 small levels a pair,
    _fast's 6 (its top level included), sched22 two phases of each."""
    import chip_smoke as cs

    low = flow_params_by_name("pixflow_low")
    n = cs.expected_launches(cs.HEADLINE_WINDOWS, 4000, low)
    assert n["small_relax_phase"] == n["small_median5_diffuse"] == 5 * 20
    assert n["relax_phase"] == 5 * 20 and n["warp_tiled"] == 5 * 40
    fast = flow_params_by_name("pixflow_low_fast")
    n = cs.expected_launches(cs.HEADLINE_WINDOWS, 4000, fast)
    assert n["small_relax_phase"] == 5 * 6
    sched = dataclasses.replace(low, relax_phases=2, relax_iters_per_phase=2)
    n = cs.expected_launches(cs.HEADLINE_WINDOWS, 4000, sched)
    assert n["small_relax_phase_unfused"] == 5 * 20 * 2
    assert n["median5"] == 5 * (2 * 20 + 20)
    assert n["small_median5_diffuse"] == 5 * 20
    assert n["small_relax_phase"] == 0


# ---------------------------------------------------------------------------
# the card: every small level of the cells, byte for byte
# ---------------------------------------------------------------------------


def _counts():
    return {name: getattr(tk, name).launches for name in SMALL}


def _level_on_card(rng, cuda, shape, **kw):
    """A level on the small kernels against the plain branch on the card;
    returns the kernels' launches."""
    changes = kw.pop("changes", {})
    inputs = _level(rng, *shape, device=cuda, **kw)
    params = dataclasses.replace(inputs[-1], **changes)
    before = _counts()
    got = pf._level_core(*inputs[:-1], params, False)
    launched = {k: n - before[k] for k, n in _counts().items()}
    torch.cuda.synchronize()
    ref = _plain_branch(*inputs[:-1], params)
    assert torch.equal(got, ref), (got != ref).float().mean().item()
    return launched


@pytest.mark.parametrize("hw", SIX, ids=[f"six{h}x{w}" for h, w in SIX])
def test_six_small_levels_equal_the_plain_branch(rng, cuda, hw):
    assert _level_on_card(rng, cuda, (2,) + hw) == {
        "small_relax_phase": 1, "small_relax_phase_unfused": 0,
        "small_median5_diffuse": 1}


@pytest.mark.parametrize("b", [2, 8])
@pytest.mark.parametrize("hw", FOUR, ids=[f"four{h}x{w}" for h, w in FOUR])
def test_four_small_levels_equal_the_plain_branch(rng, cuda, hw, b):
    """four's levels, and batch4's on a leading batch of 8."""
    assert _level_on_card(rng, cuda, (b,) + hw)["small_relax_phase"] == 1


@pytest.mark.parametrize("hw", LOWFAST,
                         ids=[f"lowfast{h}x{w}" for h, w in LOWFAST])
def test_lowfast_small_levels_equal_the_plain_branch(rng, cuda, hw):
    """six_lowfast's small levels and its 88 x 78 top level, which the
    same branch refines from the floor twin's flow."""
    assert _level_on_card(rng, cuda, (2,) + hw, alg="pixflow_low_fast")[
        "small_relax_phase"] == 1


@pytest.mark.parametrize("shape,kw", [
    ((2, 12, 9), {}),                          # smaller than a relax tile
    ((2, 2, 2), {}),                           # the smallest plane
    ((2, 45, 300), {"alpha": "ones"}),         # no hole: every pixel moves
    ((2, 130, 128), {"noise": 2.0}),           # candidates taken often
    ((4, 95, 85), {"changes": {"relax_phases": 2,
                               "relax_iters_per_phase": 2}}),
    ((2, 77, 189), {"changes": {"relax_phases": 3}}),
    ((2, 62, 153), {"changes": {"fuse_level_blurs": False}}),
    ((2, 50, 124), {"changes": {"relax_iters_per_phase": 10}}),
    ((2, 105, 259), {"noise": 2.0, "changes": {"relax_iters_per_phase": 5,
                                               "fast_window": 4}}),
    ((2, 56, 50), {"changes": {"fast_window": 3,
                               "fold_descent_sample": False}}),
    ((2, 41, 37), {"changes": {"w1_bf16": False,
                               "blurred_flow_kernel_width": 21}})])
def test_other_small_levels_equal_the_plain_branch(rng, cuda, shape, kw):
    """Tiny planes, alphas without holes, noisy flows, and the schedules
    and contract widths no preset sets: one relax launch a phase of up to
    SMALL_RELAX_ITERS iterations, one median + diffusion a level."""
    changes = kw.get("changes", {})
    launched = _level_on_card(rng, cuda, shape, **kw)
    phases = changes.get("relax_phases", 1)
    fused = phases == 1 and changes.get("fuse_level_blurs", True)
    # a phase of more than SMALL_RELAX_ITERS iterations in several launches
    runs = -(-changes.get("relax_iters_per_phase", 3)
             // tk.SMALL_RELAX_ITERS)
    assert launched == {
        "small_relax_phase": runs if fused else 0,
        "small_relax_phase_unfused": 0 if fused else runs * phases,
        "small_median5_diffuse": 1}


@pytest.mark.parametrize("ksize", [15, 7, 21])
@pytest.mark.parametrize("shape", [(4, 244, 218), (16, 160, 395),
                                   (4, 3, 200)])
def test_small_median5_diffuse_kernel_equals_plain(rng, cuda, shape,
                                                   ksize):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda)
    c = torch.from_numpy(rng.random((shape[0] // 2,) + shape[1:],
                                    np.float32)).to(cuda)
    n = tk.small_median5_diffuse.launches
    got = tk.small_median5_diffuse(x, c, ksize)
    assert tk.small_median5_diffuse.launches == n + 1
    assert torch.equal(got, tk.small_median5_diffuse_plain(x, c, ksize))


def _replay_and_plain(run, monkeypatch):
    """``run()`` as a program (eager call, capture and replay, a replay;
    the small kernels' launches of the last), then eagerly with the small
    wrappers replaced by their plain versions."""
    programs.clear()
    run()
    run()
    tk.reset_launch_counts()
    replayed = run()
    launches = _counts()
    programs.clear()
    for name in SMALL:
        monkeypatch.setattr(tk, name, getattr(tk, name + "_plain"))
    with programs.disable():
        plain = run()
    return replayed, plain, launches


@pytest.mark.parametrize("what", ["chain", "stitch_four", "stitch_pairs"])
def test_stitches_on_the_small_kernels_equal_the_plain_branch(
        cuda, monkeypatch, what):
    """A 6-photo chain (5 pairs), a four-input stitch and a batched descent
    of two pairs at 96 x 320, where every refining level is small: the
    replay on the kernels gives every byte of the stitch on the plain
    branch, one relax and one median + diffusion a level."""
    cfg = StitchConfig(flow_alg="pixflow_low")
    four = synthesize_four_input_set(96, 320, seed=1)
    if what == "chain":
        photos, top = synthesize_fisheye_set(96, 320, n=5, seed=7)
        run, pairs = (lambda: pipeline.stitch_six(photos, top, cfg,
                                                  device=cuda)), 5
    elif what == "stitch_four":
        run, pairs = (lambda: pipeline.stitch_four(four, cfg,
                                                   device=cuda)), 1
    else:
        stack = np.stack(four[:2])
        run, pairs = (lambda: pipeline.stitch_pairs(
            stack, stack[::-1].copy(), cfg, device=cuda)), 1
    replayed, plain, launches = _replay_and_plain(run, monkeypatch)
    assert launches["small_relax_phase"] > 0
    assert launches["small_relax_phase"] % pairs == 0
    assert launches["small_median5_diffuse"] == launches["small_relax_phase"]
    assert launches["small_relax_phase_unfused"] == 0
    assert torch.equal(replayed, plain)
    programs.clear()
