"""The blend field's eight-ray distances as one hand-written kernel:
``ops.kernels.blend_distances`` and its plain version
``blend_distances_plain`` (``ops.distance.eight_ray_min_distance`` of a
canvas map's pure-L pixels, code 100, and of its pure-R pixels, code 50).

The CPU tests hold the wrapper's route on the CPU to those two searches,
its checks and its counter, and ``stitcher.generate_blend`` to one call a
field.  The card tests (they skip without CUDA) hold the kernel to the
plain version run on the card, every bit equal, at the edges of its
contract and at the cells' shapes, and ``generate_blend`` through the
kernel to ``generate_blend`` with the plain distances.  This file imports
no JAX, so on the machine with the card it runs as

    python -m pytest --noconftest tests/test_torch_eight_ray_kernel.py -q
"""

import math

import numpy as np
import pytest
import torch

from panorama_opticalflow_tpu_torch.models import stitcher
from panorama_opticalflow_tpu_torch.ops import image as im
from panorama_opticalflow_tpu_torch.ops import kernels as tk
from panorama_opticalflow_tpu_torch.ops.distance import eight_ray_min_distance
from panorama_opticalflow_tpu_torch.utils import runtime
from panorama_opticalflow_tpu_torch.utils.config import StitchConfig

runtime.settle_cpu_math()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py times this "
                    "kernel at six's window and four's canvas)")
    return torch.device("cuda")


def _random_map(rng, shape, density: float) -> np.ndarray:
    """Codes with a ``density`` share of candidates, half L and half R; the
    rest empty or overlap."""
    u = rng.random(shape)
    rest = rng.choice(np.array([0, 150], np.uint8), shape)
    return np.where(u < density / 2, 100,
                    np.where(u < density, 50, rest)).astype(np.uint8)


def _canvas_map(rng, lead, h: int, w: int) -> np.ndarray:
    """A map like ``match_images``': empty, L-only, overlap, R-only and
    empty column bands whose seams wander down the rows, empty rows at the
    top and bottom, and 1 % of the pixels flipped to any code."""
    maps = []
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    for _ in range(int(np.prod(lead, dtype=int))):
        seams = [f * w + 0.05 * w * np.sin(y / (h / rng.uniform(2, 7))
                                           + rng.uniform(0, 6))
                 for f in (0.1, 0.35, 0.55, 0.85)]
        m = np.zeros((h, w), np.uint8)
        m[(x >= seams[0]) & (x < seams[1])] = 100
        m[(x >= seams[1]) & (x < seams[2])] = 150
        m[(x >= seams[2]) & (x < seams[3])] = 50
        m[: h // 20] = 0
        m[h - h // 25:] = 0
        flip = rng.random((h, w)) < 0.01
        m[flip] = rng.choice(np.array([0, 50, 100, 150], np.uint8),
                             int(flip.sum()))
        maps.append(m)
    return np.stack(maps).reshape(tuple(lead) + (h, w))


def _two_searches(codes, step, max_i, crop=0):
    """What ``generate_blend`` ran before the kernel."""
    return (im.crop_x(eight_ray_min_distance(codes == 100, step, max_i),
                      crop, -1),
            im.crop_x(eight_ray_min_distance(codes == 50, step, max_i),
                      crop, -1))


# ---------------------------------------------------------------------------
# CPU: the route, the checks, the counter, one call a field
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,step,max_i,crop", [
    ((37, 53), 1, 26.5, 0),
    ((37, 53), 3, 1e9, 0),
    ((40, 61), 7, 18.3, 9),
    ((3, 29, 41), 2, 20.5, 0),
    ((2, 31, 47), 5, 1e9, 6),
])
def test_cpu_route_equals_two_searches(rng, shape, step, max_i, crop):
    codes = torch.from_numpy(_random_map(rng, shape, 0.3))
    before = tk.blend_distances.launches
    got = tk.blend_distances(codes, step, max_i, crop)
    want = _two_searches(codes, step, max_i, crop)
    assert tk.blend_distances.launches == before
    for g, wv in zip(got, want):
        assert g.dtype == torch.float32
        assert g.shape == shape[:-1] + (shape[-1] - 2 * crop,)
        assert torch.equal(g, wv)
    assert all(torch.equal(g, wv) for g, wv in zip(
        tk.blend_distances_plain(codes, step, max_i, crop), want))


@pytest.mark.parametrize("bad,err", [
    ("dtype", TypeError), ("rank1", ValueError), ("rank4", ValueError),
    ("step0", ValueError), ("step_float", ValueError),
    ("crop", ValueError), ("device", ValueError)])
def test_wrapper_refuses(bad, err):
    codes = torch.zeros(12, 20, dtype=torch.uint8)
    step, crop = 2, 0
    if bad == "dtype":
        codes = codes.int()
    elif bad == "rank1":
        codes = codes[0]
    elif bad == "rank4":
        codes = codes[None, None]
    elif bad == "step0":
        step = 0
    elif bad == "step_float":
        step = 2.5
    elif bad == "crop":
        crop = 10
    else:
        codes = torch.zeros(12, 20, dtype=torch.uint8, device="meta")
    with pytest.raises(err):
        tk.blend_distances(codes, step, 10.0, crop)


def test_counter_is_a_kernel_counter():
    assert tk.blend_distances in tk.KERNELS
    tk.blend_distances.launches = 4
    tk.reset_launch_counts()
    assert tk.blend_distances.launches == 0


def _blend_forms(rng, device):
    """``generate_blend``'s four forms on one 280 x 600 canvas map (a stack
    of three for the last; ray stride 7, the selective blur on): a window
    across the seam with a tensor roll, the whole wrap-extended canvas,
    the field decimated by 2 and a stack."""
    cfg = StitchConfig(blend_step_div=40)
    one = torch.from_numpy(_canvas_map(rng, (), 280, 600)).to(device)
    stack = torch.from_numpy(_canvas_map(rng, (3,), 280, 600)).to(device)
    roll = torch.full((), 500, dtype=torch.int64, device=device)
    return {"window_tensor_roll": (one, cfg, (roll, 240), None),
            "whole": (one, cfg, None, None),
            "scale2": (one, cfg, None, 2),
            "stack": (stack, cfg, None, None)}


@pytest.mark.parametrize("form", ["window_tensor_roll", "whole", "scale2",
                                  "stack"])
def test_cpu_generate_blend_searches_once(rng, monkeypatch, form):
    """Every form of ``generate_blend`` makes one call of the wrapper, and
    the field it gives is the field of the two searches."""
    args = _blend_forms(rng, "cpu")[form]
    calls = []
    real = tk.blend_distances
    monkeypatch.setattr(tk, "blend_distances", lambda *a, **k: (
        calls.append(a[1:]), real(*a, **k))[1])
    got = stitcher.generate_blend(*args)
    assert len(calls) == 1
    monkeypatch.setattr(tk, "blend_distances", lambda c, s, m, crop=0:
                        _two_searches(c, s, m, crop))
    want = stitcher.generate_blend(*args)
    assert all(torch.equal(g, wv) for g, wv in zip(got, want))


# ---------------------------------------------------------------------------
# the card: every bit equal to the plain version, one launch a call
# ---------------------------------------------------------------------------


def _on_card(codes, step, max_i, crop=0):
    before = tk.blend_distances.launches
    got = tk.blend_distances(codes, step, max_i, crop)
    assert tk.blend_distances.launches == before + 1
    want = tk.blend_distances_plain(codes, step, max_i, crop)
    torch.cuda.synchronize()
    for g, wv in zip(got, want):
        same = g == wv
        assert torch.equal(g, wv), (
            f"{int((~same).sum())} of {same.numel()} distances differ, first "
            f"at {[int(i[0]) for i in torch.nonzero(~same, as_tuple=True)]}")
    return got


@pytest.mark.parametrize("step", [1, 2, 7, 20])
@pytest.mark.parametrize("density", [0.1, 0.3, 0.5, 0.7, 0.9])
def test_card_random_maps(rng, cuda, density, step):
    """97 x 203: neither a multiple of any stride."""
    codes = torch.from_numpy(_random_map(rng, (97, 203), density)).to(cuda)
    _on_card(codes, step, 1e9)


@pytest.mark.parametrize("step", [1, 2, 7, 20])
@pytest.mark.parametrize("edge", ["row0", "col0", "last_row", "last_col",
                                  "corners"])
def test_card_edge_candidates(rng, cuda, edge, step):
    """Candidates on one edge only (the boundary rule hides row 0 and
    column 0 from some rays), over an overlap-coded interior."""
    h, w = 61, 83
    m = np.full((h, w), 150, np.uint8)
    sel = {"row0": np.s_[0, :], "col0": np.s_[:, 0],
           "last_row": np.s_[-1, :], "last_col": np.s_[:, -1]}
    if edge == "corners":
        for y, x in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
            m[y, x] = 100
        m[0, 1::3] = 50
        m[1::4, 0] = 50
    else:
        line = m[sel[edge]]
        line[:] = _random_map(rng, line.shape, 0.6)
    _on_card(torch.from_numpy(m).to(cuda), step, 1e9)


@pytest.mark.parametrize("max_i", [5.5, 13.0, 37.5, 41.3, 1.0, 0.5])
@pytest.mark.parametrize("step", [1, 3, 7])
def test_card_max_i_binds(rng, cuda, max_i, step):
    """A cut shorter than both sides, whole and not; 0.5 keeps a pixel's
    own hit only."""
    codes = torch.from_numpy(_random_map(rng, (73, 91), 0.05)).to(cuda)
    _on_card(codes, step, max_i)


@pytest.mark.parametrize("code", [0, 50, 100, 150])
@pytest.mark.parametrize("step", [1, 20])
def test_card_uniform_maps(cuda, code, step):
    """All empty (+inf everywhere), all overlap, all of one class."""
    codes = torch.full((45, 67), code, dtype=torch.uint8, device=cuda)
    d_l, d_r = _on_card(codes, step, 1e9)
    assert bool(torch.isinf(d_l).all()) == (code != 100)
    assert bool(torch.isinf(d_r).all()) == (code != 50)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_card_stacks(rng, cuda, n):
    """Each map of a stack is searched alone: equal to the plain version
    on the stack and, map by map, to the kernel on the map alone."""
    codes = torch.from_numpy(np.stack([
        _random_map(rng, (53, 78), d) for d in np.linspace(0.1, 0.9, n)])
    ).to(cuda)
    got = _on_card(codes, 7, 40.5)
    for k in range(n):
        alone = tk.blend_distances(codes[k], 7, 40.5)
        assert all(torch.equal(g[k], a) for g, a in zip(got, alone))


@pytest.mark.parametrize("lead", [(), (3,)])
def test_card_strided_map_and_crop(rng, cuda, lead):
    """A decimated view (the field at scale 2 reads cs[..., ::2, ::2]) of a
    wrap-extended map, cut back by its extension."""
    big = torch.from_numpy(_canvas_map(rng, lead, 240, 500)).to(cuda)
    ext = im.wrap_extend_x(big[..., ::2, ::2], 25, -1)
    _on_card(ext, 3, 62.5, crop=25)
    _on_card(big[..., ::2, ::2], 3, 62.5)


@pytest.mark.parametrize("lead,h,w,step,max_i,crop", [
    ((), 4000, 3584, 20, 4500.0, 0),      # six's pair window
    ((), 2000, 1792, 10, 2250.0, 0),      # six_lowfast's, decimated by 2
    ((), 4000, 12600, 20, 4500.0, 1800),  # four's wrap-extended canvas
    ((4,), 4000, 12600, 20, 4500.0, 1800),  # batch4's stack
])
def test_card_cells(rng, cuda, lead, h, w, step, max_i, crop):
    codes = torch.from_numpy(_canvas_map(rng, lead, h, w)).to(cuda)
    _on_card(codes, step, max_i, crop)


@pytest.mark.parametrize("form", ["window_tensor_roll", "whole", "scale2",
                                  "stack"])
def test_card_generate_blend(rng, cuda, monkeypatch, form):
    """``generate_blend`` through the kernel against ``generate_blend``
    with the plain distances on the card: both outputs, every bit; one
    launch a call."""
    args = _blend_forms(rng, cuda)[form]
    before = tk.blend_distances.launches
    got = stitcher.generate_blend(*args)
    assert tk.blend_distances.launches == before + 1
    monkeypatch.setattr(tk, "blend_distances", tk.blend_distances_plain)
    want = stitcher.generate_blend(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(g, wv) for g, wv in zip(got, want))


def test_card_diagonal_scale_is_float32_sqrt2(cuda):
    """A lone candidate: its diagonal rays' distances are float32(i) times
    float32(sqrt 2), one rounded product."""
    codes = torch.zeros(41, 41, dtype=torch.uint8, device=cuda)
    codes[20, 20] = 100
    d_l, _ = _on_card(codes, 1, 1e9)
    i = torch.arange(1, 21, device=cuda)
    want = i.float() * torch.tensor(math.sqrt(2.0), dtype=torch.float32,
                                    device=cuda)
    assert torch.equal(d_l[20 - i, 20 - i], want)
    assert torch.equal(d_l[20 + i, 20 - i], want)


def test_expected_launches_count_one_search_a_pair():
    """chip_smoke's launch model: one launch a pair of the chain, none in
    the row-tiled stitch (its own row-tiled search)."""
    import chip_smoke as cs
    from panorama_opticalflow_tpu_torch.parallel import tiled
    from panorama_opticalflow_tpu_torch.utils.config import (
        flow_params_by_name)

    low = flow_params_by_name("pixflow_low")
    n = cs.expected_launches(cs.HEADLINE_WINDOWS, 4000, low)
    assert n["blend_distances"] == n["novel_view"] == 5
    n = cs.expected_launches(cs.HEADLINE_WINDOWS[:1], 4000, low,
                             tiles=(4, tiled.TileConfig(8, 32)))
    assert n["blend_distances"] == 0 and n["novel_view"] == 1
