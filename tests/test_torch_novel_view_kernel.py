"""The novel-view stage as one hand-written kernel: ``ops.kernels.novel_view``
and its plain version ``novel_view_plain`` (the window's columns of both
canvases, the two samplers of ``ops.warp``, the deghosting combiner, the
merged window placed on a zero canvas).

The CPU tests hold the wrapper's route on the CPU to the composition it
replaces (``window_cols``, ``combine_novel_views`` on the window,
``place_cols``), the sampler rule, the checks and the counter, and the
kernel's constants to the sampler's.  The card tests (they skip without
CUDA) hold the kernel to the plain version run on the card, every byte
equal, at the cells' shapes and at the edges of its contract, and count
one launch a call.  This file imports no JAX, so on the machine with the
card it runs as

    python -m pytest --noconftest tests/test_torch_novel_view_kernel.py -q
"""

import inspect
import os
import re

import numpy as np
import pytest
import torch

from panorama_opticalflow_tpu_torch.models import novel_view
from panorama_opticalflow_tpu_torch.models.stitcher import (place_cols,
                                                          window_cols)
from panorama_opticalflow_tpu_torch.ops import kernels as tk
from panorama_opticalflow_tpu_torch.ops import warp
from panorama_opticalflow_tpu_torch.utils import runtime

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


def _stage(rng, lead, h, w, width, flow_scale=6.0, offset=0.0,
           device="cpu"):
    """A pair's novel-view inputs: RGBA canvases (lead, h, w, 4) with
    transparent patches, the window's smooth flows (lead, h, width, 2)
    scaled by ``flow_scale`` and moved by ``offset`` px, plus per-pixel
    noise, and a blend ramp across the window with exact 0s and 1s."""
    shape = tuple(lead)
    imgs = rng.integers(0, 256, shape + (2, h, w, 4), dtype=np.uint8)
    alpha = imgs[..., 3]
    alpha[rng.random(alpha.shape) < 0.1] = 0
    alpha[..., h // 3:h // 2, w // 4:w // 3] = 0
    yy, xx = np.mgrid[0:h, 0:width].astype(np.float32)
    flows = []
    for _ in range(2):
        ph = rng.random(2) * 6
        f = np.stack([np.sin(yy / 97.0 + ph[0]) + np.cos(xx / 131.0),
                      np.cos(yy / 71.0 + ph[1]) - np.sin(xx / 113.0)], -1)
        f = flow_scale * f + offset
        f = f + rng.standard_normal(shape + f.shape).astype(np.float32) * 2
        flows.append(f.astype(np.float32))
    ramp = np.clip(np.linspace(-0.2, 1.2, width, dtype=np.float32), 0, 1)
    blend = np.broadcast_to(ramp, shape + (h, width)).copy()
    blend[..., ::7, :] = rng.random(blend[..., ::7, :].shape)
    T = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return (T(imgs[..., 0, :, :, :]), T(imgs[..., 1, :, :, :]),
            T(flows[0]), T(flows[1]), T(blend))


def _composed(il, ir, flr, frl, blend, window):
    """The stage as the pipeline composed it: the window's columns, the
    combiner on them, the merged window at its columns of a zero canvas."""
    if window is None:
        return novel_view.combine_novel_views(il, ir, flr, frl, blend)
    roll, width = window
    merged = novel_view.combine_novel_views(
        window_cols(il, roll, width, dim=-2),
        window_cols(ir, roll, width, dim=-2), flr, frl, blend)
    return place_cols(merged, roll, il.shape[-2], dim=-2)


# ---------------------------------------------------------------------------
# CPU: the route, the sampler rule, the checks, the constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lead,h,w,window", [
    ((), 96, 300, (250, 120)),        # crosses the canvas seam
    ((), 96, 300, (0, 300)),
    ((), 96, 300, None),
    ((3,), 64, 200, None),
    ((3,), 64, 200, (170, 90)),
    ((), 260, 600, (400, 520)),       # the tiled sampler, across the seam
])
def test_cpu_route_equals_the_composition(rng, lead, h, w, window):
    """On the CPU the wrapper runs its plain version, which is the
    composition the pair bodies ran before the kernel, byte for byte."""
    width = w if window is None else window[1]
    args = _stage(rng, lead, h, w, width)
    want = _composed(*args, window)
    before = tk.novel_view.launches
    got = tk.novel_view(*args, window)
    assert got.shape == tuple(lead) + (h, w, 4) and got.dtype == torch.uint8
    assert torch.equal(got, want)
    assert torch.equal(novel_view.combine_novel_views(*args, window), want)
    assert torch.equal(tk.novel_view_plain(*args, window), want)
    assert tk.novel_view.launches == before
    if window is not None and window[1] < w:
        roll, width = window
        outside = torch.ones(w, dtype=torch.bool)
        outside[(torch.arange(width) + roll) % w] = False
        assert not got[..., outside, :].any()


def test_cpu_tensor_roll_equals_int_roll(rng):
    """A 0-d int64 roll, as a captured program holds it, gives the same
    canvas as the int."""
    args = _stage(rng, (), 80, 256, 100)
    roll = torch.full((), 200, dtype=torch.int64)
    assert torch.equal(tk.novel_view(*args, (roll, 100)),
                       tk.novel_view(*args, (200, 100)))


@pytest.mark.parametrize("h,width,tiled", [
    (255, 1000, False), (256, 511, False), (256, 512, True),
    (4000, 3584, True)])
def test_window_shape_picks_the_sampler(monkeypatch, h, width, tiled):
    """TILED_SAMPLER_MIN_H x _W on the window's shape, not the canvas's."""
    used = []
    for name in ("sample_nearest_wrap", "sample_nearest_wrap_tiled"):
        monkeypatch.setattr(tk, name, lambda img, f, t, name=name: (
            used.append(name) or torch.zeros_like(img)))
    z = torch.zeros
    tk.novel_view(z(1, h, 9000, 4, dtype=torch.uint8),
                  z(1, h, 9000, 4, dtype=torch.uint8),
                  z(1, h, width, 2), z(1, h, width, 2), z(1, h, width),
                  (5, width))
    assert used == ["sample_nearest_wrap_tiled" if tiled
                    else "sample_nearest_wrap"] * 2
    assert (tk.TILED_SAMPLER_MIN_H, tk.TILED_SAMPLER_MIN_W) == (256, 512)


@pytest.mark.parametrize("bad,err", [
    ("width", ValueError), ("flow_shape", ValueError),
    ("blend_dtype", TypeError), ("image_dtype", TypeError),
    ("roll_dtype", ValueError), ("dims", ValueError)])
def test_wrapper_refuses(rng, bad, err):
    il, ir, flr, frl, blend = _stage(rng, (), 32, 64, 40)
    window = (10, 40)
    if bad == "width":
        window = (0, 65)
    elif bad == "flow_shape":
        flr = flr[:, :39]
    elif bad == "blend_dtype":
        blend = blend.double()
    elif bad == "image_dtype":
        il = il.float()
    elif bad == "roll_dtype":
        window = (torch.full((), 3, dtype=torch.int32), 40)
    else:
        il, ir = il[0], ir[0]
    with pytest.raises(err):
        tk.novel_view(il, ir, flr, frl, blend, window)


def test_counter_is_a_kernel_counter():
    assert tk.novel_view in tk.KERNELS
    tk.novel_view.launches = 4
    tk.reset_launch_counts()
    assert tk.novel_view.launches == 0


def test_kernel_constants_are_the_samplers():
    """csrc/novel_view.cu's tile, margin and offset clamp are the tiled
    sampler's defaults, and its deghost constants the combiner's."""
    path = os.path.join(os.path.dirname(tk.__file__), "..", "csrc",
                        "novel_view.cu")
    with open(path) as f:
        src = f.read()

    def const(name):
        return float(re.search(rf"constexpr \w+ {name} = ([0-9.]+)f?;",
                               src).group(1))

    defaults = inspect.signature(warp.sample_nearest_wrap_tiled).parameters
    for name, key in (("TH", "tile_h"), ("TW", "tile_w"),
                      ("MARGIN", "margin"), ("MAX_OFF", "max_off")):
        assert const(name) == defaults[key].default
    assert const("COLOR_DIFF_COEF") == tk.K_COLOR_DIFF_COEF
    assert const("SOFTMAX_SHARPNESS") == tk.K_SOFTMAX_SHARPNESS
    assert const("FLOW_MAG_COEF") == tk.K_FLOW_MAG_COEF


# ---------------------------------------------------------------------------
# the card: every byte equal to the plain version, one launch a call
# ---------------------------------------------------------------------------


def _on_card(args, window):
    """The kernel and the plain version on the same inputs; returns both
    and checks the counter."""
    before = tk.novel_view.launches
    got = tk.novel_view(*args, window)
    assert tk.novel_view.launches == before + 1
    want = tk.novel_view_plain(*args, window)
    torch.cuda.synchronize()
    return got, want


def _assert_equal(got, want):
    same = (got == want).all(dim=-1)
    assert bool(same.all()), (
        f"{int((~same).sum())} of {same.numel()} pixels differ, first at "
        f"{[int(i[0]) for i in torch.nonzero(~same, as_tuple=True)]}")


@pytest.mark.parametrize("case", ["six_window_tensor_roll",
                                  "six_window_int_roll",
                                  "four_canvas"])
def test_card_cells(rng, cuda, case):
    """Six's 4000 x 3584 window in a 9000-wide canvas at a roll across the
    seam (roll + width > W), as the program passes it (a 0-d tensor) and
    as an int; four's whole 4000 x 9000 canvas with no window."""
    if case == "four_canvas":
        args = _stage(rng, (), 4000, 9000, 9000, device=cuda)
        window = None
    else:
        args = _stage(rng, (), 4000, 9000, 3584, device=cuda)
        roll = 8100
        if case == "six_window_tensor_roll":
            roll = torch.full((), roll, dtype=torch.int64, device=cuda)
        window = (roll, 3584)
    _assert_equal(*_on_card(args, window))


@pytest.mark.parametrize("lead,h,w,window", [
    ((4,), 512, 1024, None),               # the batched body's stack
    ((4,), 292, 3584, None),               # row tiles of a window + halo
    ((), 300, 700, None),                  # partial tiles in both axes
    ((), 300, 9000, (8500, 700)),          # the same as a window
    ((), 250, 700, None),                  # below 256 rows: exact
    ((), 200, 400, (300, 200)),            # small canvas: exact, seam
    ((3,), 96, 320, None),                 # exact on a stack
])
def test_card_shapes(rng, cuda, lead, h, w, window):
    width = w if window is None else window[1]
    _assert_equal(*_on_card(_stage(rng, lead, h, w, width, device=cuda),
                            window))


def test_card_row_tile_stack_as_tiled_combine_passes_it(rng, cuda):
    """``parallel.tiled._tiled_combine``'s call: each input halo-extended
    by rows of its neighbours, the stack of tiles combined as one."""
    il, ir, flr, frl, blend = _stage(rng, (), 1000, 3584, 3584, device=cuda)
    n, halo, rows = 4, 21, 250

    def tiles(a):
        pad = torch.cat([a[:1].expand(halo, *a.shape[1:]), a,
                         a[-1:].expand(halo, *a.shape[1:])])
        return torch.stack([pad[k * rows:k * rows + rows + 2 * halo]
                            for k in range(n)])

    args = [tiles(a) for a in (il, ir, flr, frl, blend)]
    before = tk.novel_view.launches
    got = novel_view.combine_novel_views(*args)
    assert tk.novel_view.launches == before + 1
    _assert_equal(got, tk.novel_view_plain(*args))


@pytest.mark.parametrize("offset,scale", [(0.0, 30.0), (150.0, 6.0),
                                          (-140.0, 25.0)])
def test_card_large_residuals_and_offsets(rng, cuda, offset, scale):
    """Residuals past +-8 (flows that vary by tens of px within a tile)
    and tile means past +-96 (flows moved by 140-150 px): both clamps."""
    args = _stage(rng, (), 512, 2048, 1536, flow_scale=scale, offset=offset,
                  device=cuda)
    _assert_equal(*_on_card(args, (1000, 1536)))


def test_card_half_way_tile_means(cuda):
    """Whole-number flows whose tile means are exactly k + 0.5 round half
    to even: half of a tile's offsets are k - 8, half k + 9, so the
    rounding decides which half's residual clamps.  And blend at exactly
    0 and 1 (one view stays put, the other takes the whole flow)."""
    h, w = 256, 1024
    img = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (h, w, 4), dtype=np.uint8)).to(cuda)
    col = torch.arange(w, device=cuda)
    row = torch.arange(h, device=cuda)
    # tile j's x offsets alternate by column between k_j - 8 and k_j + 9,
    # k_j in -3 .. 4: means k_j + 0.5, odd and even; the y offsets
    # likewise by row
    k = (col // 128 - 3).float()
    fx = (k - 8 + 17 * (col % 2).float()).expand(h, w)
    fy = ((col // 128) % 3 - 9).float().expand(h, w) \
        + 17 * (row % 2).float()[:, None]
    flow = torch.stack([fx, fy], -1).contiguous()
    for b in (1.0, 0.0):
        blend = torch.full((h, w), b, device=cuda)
        _assert_equal(*_on_card((img, img.roll(37, 1), flow, -flow, blend),
                                None))
