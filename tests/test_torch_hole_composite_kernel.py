"""The final composite as one hand-written kernel:
``ops.kernels.hole_composite`` and its plain version
``hole_composite_plain`` (the codes' selects and
``ops.distance.two_class_hole_search`` for the overlap holes).

The CPU tests hold the hole search and the plain composite to a loop
over each pixel that walks the reference's Gather search as its source
states it (CPU/StitchTool.cpp:75-94), the wrapper's route on the CPU to
the plain version, its checks and its counter, and
``stitcher.gather_composite`` to one call a composite.  The card tests
(they skip without CUDA) hold the kernel to the plain version run on the
card, every byte equal, at the edges of its contract and at the cells'
shapes.  This file imports no JAX, so on the machine with the card it
runs as

    python -m pytest --noconftest tests/test_torch_hole_composite_kernel.py -q
"""

import numpy as np
import pytest
import torch

from panorama_opticalflow_tpu_torch.models import crop, stitcher
from panorama_opticalflow_tpu_torch.ops import kernels as tk
from panorama_opticalflow_tpu_torch.ops.distance import two_class_hole_search
from panorama_opticalflow_tpu_torch.utils import runtime
from panorama_opticalflow_tpu_torch.utils.config import StitchConfig

runtime.settle_cpu_math()

# the eight rays of the reference's search
RAYS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1), (1, -1), (-1, 1))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py times this "
                    "kernel at six's window and four's canvas)")
    return torch.device("cuda")


def _oracle_search(mask_l: np.ndarray, mask_r: np.ndarray, radius: int):
    """Gather's hole search pixel by pixel: each of the 8 rays visits
    j = 0, 1, ... while j < radius and stops at the edge; its hit is the
    first pure-L (2 j) or pure-R (2 j + 1) pixel, except column 0 on the
    rays with dx < 0 and row 0 on those with dy < 0; the least over the
    rays wins, so L wins a tie.  Returns (found, take_l)."""
    h, w = mask_l.shape
    found = np.zeros((h, w), bool)
    take_l = np.ones((h, w), bool)
    for y in range(h):
        for x in range(w):
            best = 2 * radius
            for dy, dx in RAYS:
                for j in range(radius):
                    yy, xx = y + j * dy, x + j * dx
                    if not (0 <= yy < h and 0 <= xx < w):
                        break
                    if (dx < 0 and xx == 0) or (dy < 0 and yy == 0):
                        continue
                    if mask_l[yy, xx]:
                        best = min(best, 2 * j)
                        break
                    if mask_r[yy, xx]:
                        best = min(best, 2 * j + 1)
                        break
            found[y, x] = best < 2 * radius
            take_l[y, x] = best % 2 == 0
    return found, take_l


def _oracle_composite(cmap, image_l, image_r, merged, radius, window=None):
    """The composite pixel by pixel (CPU/StitchTool.cpp:52-96) on numpy
    arrays of one canvas: the code's source, and for a hole (code 150)
    the oracle search's fill on the window's columns (none outside it)."""
    code = (cmap.astype(np.int64) + 75 * (merged[..., 3] > 0)) % 256
    h, w = cmap.shape
    roll, width = (0, w) if window is None else window
    cols = (np.arange(width) + int(roll)) % w
    found_w, take_w = _oracle_search(code[:, cols] == 100,
                                     code[:, cols] == 50, radius)
    out = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        for x in range(w):
            c = code[y, x]
            if c == 100:
                out[y, x] = image_l[y, x]
            elif c == 50:
                out[y, x] = image_r[y, x]
            elif c in (225, 175, 125):
                out[y, x] = merged[y, x]
            elif c == 150:
                p = (x - int(roll)) % w
                if p >= width:
                    continue
                if not found_w[y, p]:
                    out[y, x] = (0, 0, 0, 255)
                else:
                    out[y, x] = (image_l if take_w[y, p] else image_r)[y, x]
    return out


def _random_codes(rng, shape, density: float) -> np.ndarray:
    """Canvas-map codes: a ``density`` share of pure pixels (half L, half
    R), the rest overlap or empty."""
    u = rng.random(shape)
    rest = rng.choice(np.array([0, 150, 150], np.uint8), shape)
    return np.where(u < density / 2, 100,
                    np.where(u < density, 50, rest)).astype(np.uint8)


def _random_pair(rng, shape, density: float, opaque: float = 0.5):
    """(map, L, R, merged) numpy arrays: random codes and RGBA, the merged
    view opaque on an ``opaque`` share of the pixels."""
    cmap = _random_codes(rng, shape, density)
    image_l, image_r, merged = (rng.integers(0, 256, shape + (4,), np.uint8)
                                for _ in range(3))
    merged[..., 3] = np.where(rng.random(shape) < opaque,
                              np.maximum(merged[..., 3], 1), 0)
    return cmap, image_l, image_r, merged


def _t(*arrays, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


# ---------------------------------------------------------------------------
# CPU: the hole search and the plain composite against the loop oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("density", [0.05, 0.4])
@pytest.mark.parametrize("shape", [(19, 31), (1, 41), (41, 1)])
@pytest.mark.parametrize("radius", [1, 2, 7, 100])
def test_hole_search_matches_oracle(rng, radius, shape, density):
    codes = _random_codes(rng, shape, density)
    found, take_l = two_class_hole_search(*_t(codes == 100, codes == 50),
                                          radius)
    want_found, want_l = _oracle_search(codes == 100, codes == 50, radius)
    assert np.array_equal(found.numpy(), want_found)
    assert np.array_equal(take_l.numpy()[want_found], want_l[want_found])


def _search_both(m_l, m_r, radius):
    """two_class_hole_search and the oracle on one pair of masks, held
    equal; returns the oracle's (found, take_l)."""
    found, take_l = two_class_hole_search(*_t(m_l, m_r), radius)
    want_found, want_l = _oracle_search(m_l, m_r, radius)
    assert np.array_equal(found.numpy(), want_found)
    assert np.array_equal(take_l.numpy()[want_found], want_l[want_found])
    return want_found, want_l


@pytest.mark.parametrize("radius", [3, 7])
@pytest.mark.parametrize("rays", ["straight", "diagonal"])
def test_hole_search_ties_go_to_l(radius, rays):
    """A hole with an R and an L pixel at the same steps on two rays
    takes L; with the R one step nearer, R."""
    d = radius - 1
    for r_step, want_l in ((d, True), (d - 1, False)):
        m_l = np.zeros((15, 15), bool)
        m_r = np.zeros((15, 15), bool)
        m_r[7, 7 + r_step] = True
        if rays == "straight":
            m_l[7 + d, 7] = True
        else:
            m_l[7 - d, 7 - d] = True
        found, take_l = _search_both(m_l, m_r, radius)
        assert found[7, 7] and take_l[7, 7] == want_l


@pytest.mark.parametrize("radius", [2, 7, 100])
def test_hole_search_no_hit(radius):
    """Candidates off every ray of a hole, beyond the radius, or on the
    edges the boundary rule hides: nothing found there."""
    m_l = np.zeros((24, 30), bool)
    m_r = np.zeros((24, 30), bool)
    if 12 + radius < 30:
        m_l[12, 12 + radius] = True   # one step beyond the radius
    m_r[14, 13] = True                # a knight's move from (12, 12)
    m_l[0, 8] = True                  # row 0, above (10, 8)
    m_r[10, 0] = True                 # column 0, left of (10, 2) and (10, 8)
    found, _ = _search_both(m_l, m_r, radius)
    assert not found[12, 12] and not found[10, 8] and not found[10, 2]


def _windows(w: int):
    return {"none": None, "inside": (3, w - 9), "across_seam": (w - 5, 17),
            "tensor_roll": (torch.tensor(w - 7), w - 2), "whole": (4, w)}


@pytest.mark.parametrize("window", ["none", "inside", "across_seam",
                                    "tensor_roll", "whole"])
@pytest.mark.parametrize("radius", [3, 100])
def test_plain_composite_matches_oracle(rng, radius, window):
    """Both routes on the CPU (the wrapper, its plain version) and
    ``gather_composite``, every byte equal to the loop oracle."""
    args = _random_pair(rng, (21, 30), 0.2, opaque=0.4)
    win = _windows(30)[window]
    want = _oracle_composite(*args, radius,
                             None if win is None else (int(win[0]), win[1]))
    before = tk.hole_composite.launches
    got = tk.hole_composite(*_t(*args), radius, win)
    assert tk.hole_composite.launches == before
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tk.hole_composite_plain(*_t(*args), radius,
                                                  win).numpy(), want)
    cfg = StitchConfig(gather_search_radius=radius)
    assert np.array_equal(stitcher.gather_composite(
        *_t(*args), cfg, window=win).numpy(), want)


def test_plain_composite_of_a_stack_matches_each_alone(rng):
    args = _random_pair(rng, (3, 17, 26), 0.1)
    got = tk.hole_composite(*_t(*args), 7)
    assert got.shape == (3, 17, 26, 4)
    for k in range(3):
        assert np.array_equal(got[k].numpy(), _oracle_composite(
            *(a[k] for a in args), 7))


def test_codes_wrap_as_uint8(rng):
    """A map byte outside {0, 50, 100, 150} adds 75 modulo 256, as the
    plain version's uint8 sum: 25 + 75 reads as pure L, 231 + 75 as 50."""
    cmap, image_l, image_r, merged = _random_pair(rng, (9, 12), 0.3)
    cmap[::2] = rng.integers(0, 256, cmap[::2].shape, np.uint8)
    cmap[1, :4] = (25, 231, 50, 0)
    merged[1, :4, 3] = (9, 200, 0, 3)
    got = tk.hole_composite(*_t(cmap, image_l, image_r, merged), 5)
    assert np.array_equal(got.numpy(), _oracle_composite(
        cmap, image_l, image_r, merged, 5))
    assert np.array_equal(got[1, 0].numpy(), image_l[1, 0])
    assert np.array_equal(got[1, 1].numpy(), image_r[1, 1])


@pytest.mark.parametrize("bad,err", [
    ("dtype", TypeError), ("image_dtype", TypeError), ("rank1", ValueError),
    ("rank4", ValueError), ("shape", ValueError), ("radius0", ValueError),
    ("radius_big", ValueError), ("radius_float", ValueError),
    ("window_stack", ValueError), ("width0", ValueError),
    ("width_wide", ValueError), ("roll_dtype", ValueError),
    ("device", ValueError)])
def test_wrapper_refuses(bad, err):
    cmap = torch.zeros(12, 20, dtype=torch.uint8)
    img = torch.zeros(12, 20, 4, dtype=torch.uint8)
    imgs = [img, img, img]
    radius, window = 5, None
    if bad == "dtype":
        cmap = cmap.int()
    elif bad == "image_dtype":
        imgs[2] = img.float()
    elif bad == "rank1":
        cmap, imgs = cmap[0], [i[0] for i in imgs]
    elif bad == "rank4":
        cmap, imgs = cmap[None, None], [i[None, None] for i in imgs]
    elif bad == "shape":
        imgs[1] = img[:, :19]
    elif bad == "radius0":
        radius = 0
    elif bad == "radius_big":
        radius = tk.HOLE_RADIUS_MAX + 1
    elif bad == "radius_float":
        radius = 2.5
    elif bad == "window_stack":
        cmap, imgs = cmap[None], [i[None] for i in imgs]
        window = (0, 8)
    elif bad == "width0":
        window = (3, 0)
    elif bad == "width_wide":
        window = (3, 21)
    elif bad == "roll_dtype":
        window = (torch.tensor(3, dtype=torch.int32), 8)
    else:
        cmap = torch.zeros(12, 20, dtype=torch.uint8, device="meta")
        imgs = [torch.zeros(12, 20, 4, dtype=torch.uint8, device="meta")] * 3
    with pytest.raises(err):
        tk.hole_composite(cmap, *imgs, radius, window)


def test_counter_is_a_kernel_counter():
    assert tk.hole_composite in tk.KERNELS
    tk.hole_composite.launches = 3
    tk.reset_launch_counts()
    assert tk.hole_composite.launches == 0


@pytest.mark.parametrize("window", [None, (5, 20)])
def test_gather_composite_calls_the_wrapper_once(rng, monkeypatch, window):
    args = _t(*_random_pair(rng, (14, 32), 0.2))
    calls = []
    real = tk.hole_composite
    monkeypatch.setattr(tk, "hole_composite", lambda *a: (
        calls.append(a[4:]), real(*a))[1])
    cfg = StitchConfig()
    got = stitcher.gather_composite(*args, cfg, window=window)
    assert calls == [(cfg.gather_search_radius, window)]
    assert torch.equal(got, tk.hole_composite_plain(
        *args, cfg.gather_search_radius, window))


def test_expected_launches_count_one_composite_a_pair():
    """chip_smoke's launch model: one launch a pair of the chain, none in
    the row-tiled stitch (its own row-tiled search)."""
    import chip_smoke as cs
    from panorama_opticalflow_tpu_torch.parallel import tiled
    from panorama_opticalflow_tpu_torch.utils.config import (
        flow_params_by_name)

    low = flow_params_by_name("pixflow_low")
    n = cs.expected_launches(cs.HEADLINE_WINDOWS, 4000, low)
    assert n["hole_composite"] == n["novel_view"] == 5
    n = cs.expected_launches(cs.HEADLINE_WINDOWS[:1], 4000, low,
                             tiles=(4, tiled.TileConfig(8, 32)))
    assert n["hole_composite"] == 0 and n["novel_view"] == 1


# ---------------------------------------------------------------------------
# the card: every byte equal to the plain version, one launch a call
# ---------------------------------------------------------------------------


def _on_card(cmap, image_l, image_r, merged, radius, window=None):
    before = tk.hole_composite.launches
    got = tk.hole_composite(cmap, image_l, image_r, merged, radius, window)
    assert tk.hole_composite.launches == before + 1
    want = tk.hole_composite_plain(cmap, image_l, image_r, merged, radius,
                                   window)
    torch.cuda.synchronize()
    same = (got == want).all(-1)
    assert torch.equal(got, want), (
        f"{int((~same).sum())} of {same.numel()} pixels differ, first at "
        f"{[int(i[0]) for i in torch.nonzero(~same, as_tuple=True)]}")
    return got


@pytest.mark.parametrize("density", [0.02, 0.2, 0.6])
@pytest.mark.parametrize("radius", [1, 2, 7, 100])
def test_card_random_maps(rng, cuda, radius, density):
    """97 x 203 and a stack of 3, with a quarter of the holes' merged
    view transparent."""
    _on_card(*_t(*_random_pair(rng, (97, 203), density, 0.25),
                 device=cuda), radius)
    _on_card(*_t(*_random_pair(rng, (3, 41, 67), density, 0.25),
                 device=cuda), radius)


@pytest.mark.parametrize("shape", [(1, 300), (300, 1), (1, 1), (2, 257)])
@pytest.mark.parametrize("radius", [2, 100])
def test_card_thin_maps(rng, cuda, shape, radius):
    _on_card(*_t(*_random_pair(rng, shape, 0.1), device=cuda), radius)


@pytest.mark.parametrize("window", ["inside", "across_seam", "tensor_roll",
                                    "whole"])
@pytest.mark.parametrize("radius", [3, 100])
def test_card_windows(rng, cuda, radius, window):
    """The search on a window's columns, its column 0 hidden from the -x
    rays and its edges stopping the rays, whether or not it is safe."""
    args = _t(*_random_pair(rng, (45, 230), 0.05, 0.3), device=cuda)
    win = _windows(230)[window]
    if isinstance(win[0], torch.Tensor):
        win = (win[0].to(cuda), win[1])
    _on_card(*args, radius, win)


@pytest.mark.parametrize("code", [0, 50, 100, 150])
def test_card_uniform_maps(cuda, code):
    """All empty, all of one class, all holes (nothing found: black)."""
    cmap = torch.full((33, 70), code, dtype=torch.uint8, device=cuda)
    img = torch.arange(33 * 70 * 4, device=cuda).reshape(33, 70, 4) % 251
    img = img.to(torch.uint8)
    merged = torch.zeros_like(img)
    got = _on_card(cmap, img, img.flip(0), merged, 100)
    if code == 150:
        assert bool((got == torch.tensor([0, 0, 0, 255], dtype=torch.uint8,
                                         device=cuda)).all())


def _pair(seed: int, lead: tuple, h: int, w: int, l_span, r_span,
          holes: str, device):
    """(map, L, R, merged) of canvas pairs like a stitch hands over
    (``chip_smoke.hole_pair``): one pair where ``lead`` is (), else a
    stack."""
    import chip_smoke

    pair = chip_smoke.hole_pair(device, seed, int(np.prod(lead, dtype=int)),
                                h, w, l_span, r_span, holes)
    return pair if lead else tuple(t[0] for t in pair)


def _overlap_cols(cmap) -> np.ndarray:
    return (cmap == 150).reshape(-1, cmap.shape[-1]).any(0).cpu().numpy()


@pytest.mark.parametrize("holes", ["sparse", "dense"])
@pytest.mark.parametrize("safe", [True, False])
def test_card_six_window(cuda, safe, holes):
    """Six's 4000 x 3584 pair window across the seam of a 9000-wide
    canvas (the chain's first roll), its overlap inside the window and
    clear of every edge (safe) or across the canvas's x = 0 (not safe).
    Safe, the window's composite is the whole canvas's too."""
    w, roll, width, r = 9000, 8100, 3584, 100
    spans = (((8600, 2000), (400, 2900)) if safe
             else ((8000, 1500), (8700, 1500)))
    args = _pair(7, (), 4000, w, *spans, holes, cuda)
    cols = _overlap_cols(args[0])
    assert crop.gather_window_safe(cols, roll, width, r) == safe
    win = (torch.full((), roll, dtype=torch.int64, device=cuda), width)
    got = _on_card(*args, r, win)
    whole = _on_card(*args, r)
    if safe:
        assert torch.equal(got, whole)


@pytest.mark.parametrize("holes", ["sparse", "dense"])
def test_card_four_canvas(cuda, holes):
    """Four's pair on its whole 4000 x 9000 canvas (no window)."""
    _on_card(*_pair(11, (), 4000, 9000, (0, 5000), (4000, 5000), holes,
                    cuda), 100)


@pytest.mark.parametrize("holes", ["sparse", "dense"])
def test_card_stack_of_four(cuda, holes):
    """batch4's stack of 4 pairs of 4000 x 9000 canvases in one launch,
    each equal to the kernel on its pair alone."""
    args = _pair(13, (4,), 4000, 9000, (0, 5000), (4000, 5000), holes, cuda)
    got = _on_card(*args, 100)
    for k in range(4):
        assert torch.equal(got[k], tk.hole_composite(
            *(a[k] for a in args), 100))


@pytest.mark.parametrize("window", [None, "int", "tensor"])
def test_card_gather_composite(cuda, window):
    """``gather_composite`` through the kernel: one launch a call, every
    byte equal to the plain composite."""
    args = _pair(17, (), 600, 2000, (1700, 900), (200, 900), "sparse", cuda)
    cfg = StitchConfig()
    win = {None: None, "int": (1600, 1024),
           "tensor": (torch.full((), 1600, dtype=torch.int64, device=cuda),
                      1024)}[window]
    before = tk.hole_composite.launches
    got = stitcher.gather_composite(*args, cfg, window=win)
    assert tk.hole_composite.launches == before + 1
    want = tk.hole_composite_plain(*args, cfg.gather_search_radius, win)
    assert torch.equal(got, want)
