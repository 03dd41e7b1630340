"""The plain PyTorch versions of the port's CUDA kernels against their
Pallas twins, run in interpret mode on the CPU as
tests/test_pallas_interpret.py runs them, over the WHOLE plane.

Tolerances:
  * median5 bit-exact: a median only selects one of its inputs.
  * warp 2e-6 and median5+diffuse 1e-5, everywhere: same taps in the same
    order; XLA contracts multiply-adds into FMAs, PyTorch rounds each op.
  * relax, fused and unfused, 1e-5 everywhere at the interpret tests'
    cases (2 iterations).
    At the production schedule (3 iterations) a few isolated pixels take
    the other branch of a strict-< candidate test: most in a 2-px band at
    the canvas's first and last rows, where the edge-padded halo
    replicates the border pixel so that the 'from up/down' candidate ties
    the pixel's own error exactly and a 1-ulp rounding difference decides
    the take (5 of 38400 pixels here, rows 0, 1 and 95; other seeds also
    show a rare interior flip).  There the gate is 1e-5 on all but
    <= 5e-4 of the pixels.
The Pallas kernel itself is checked tile-size invariant (config.py's
claim): two tile sizes give bit-identical output, and the port's plain
version -- the whole plane as one window -- matches both.

The warp and relax kernels on the card gather the two non-zero taps of
each hat pass where the plain versions sum the dense window.  The two
forms are bit-identical (every other tap's weight is an exact zero); the
two-tap references at the end of this file hold that on the CPU.

The median kernels on the card select the median with the exchange
networks of csrc/median25_net.inc, on runs of eight outputs that share
sorted window columns and merged column pairs.  The tests at the end of this file parse that file
(the one nvcc includes), prove the network on all 2^25 zero-one inputs,
and hold an emulation of both kernels' tiles, runs and pass order equal to
the plain versions (tolerance 0.0: the median selects, and the blur keeps
the plain version's order of taps).

The kernel-vs-plain checks on the card are in tests/test_torch_card.py,
which imports no JAX.
"""

import dataclasses
import itertools
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from panorama_opticalflow_tpu.ops.pallas import kernels as jk
from panorama_opticalflow_tpu.utils.config import flow_params_by_name
from panorama_opticalflow_tpu_torch import to_numpy, to_torch
from panorama_opticalflow_tpu_torch.ops import kernels as tk
from panorama_opticalflow_tpu_torch.ops import relax_fast as trf
from panorama_opticalflow_tpu_torch.utils import runtime

torch.set_num_threads(2)
# The first multi-threaded torch.sqrt of a fresh process sometimes comes
# back at low accuracy on the pool's second thread (one process in about a
# hundred under load, up to 3831 ulp on half of the elements; every later
# call is right).  test_relax_plain_matches_pallas holds this file's first
# sqrt to 1e-5, and failed on that call: 49 values off by up to 2.36, the
# JAX side's bits the same in every process.  Take the first call here.
runtime.settle_cpu_math()


def T(a):
    return to_torch(a, "cpu")


@pytest.fixture
def interp():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _smooth_flow(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx = 20 * np.sin(yy / 37.0) + 5 * np.cos(xx / 53.0)
    fy = 8 * np.cos(yy / 29.0) - 3 * np.sin(xx / 41.0)
    return np.stack([fx, fy], -1).astype(np.float32)


def _relax_inputs(rng, b, h, w):
    mk = lambda s=0.1: rng.standard_normal((b, h, w)).astype(np.float32) * s
    i0x, i0y, w1x, w1y = mk(), mk(), mk(), mk()
    fx, fy = mk(0.5), mk(0.5)
    bx, by = fx + mk(0.1), fy + mk(0.1)
    mask = (rng.random((b, h, w)) > 0.1).astype(np.float32)
    return [fx, fy, bx, by, w1x, w1y, i0x, i0y, mask]


def _unfused_inputs(rng, b, h, w):
    """The fused inputs plus a given target (bfx, bfy) before the mask."""
    planes = _relax_inputs(rng, b, h, w)
    bf = [rng.standard_normal((b, h, w)).astype(np.float32) * 0.5
          for _ in range(2)]
    return planes[:8] + bf + planes[8:]


def _pallas_relax(planes, params, iters, D, tile):
    a = [jnp.asarray(p) for p in planes]
    fx, fy = jk.relax_phase_pallas(*a[:8], None, None, a[8], params, iters,
                                   D, tile=tile, fuse_bf=True)
    return np.stack([np.asarray(fx), np.asarray(fy)])


def _pallas_relax_unfused(planes, params, iters, D, tile):
    fx, fy = jk.relax_phase_pallas(*[jnp.asarray(p) for p in planes],
                                   params, iters, D, tile=tile)
    return np.stack([np.asarray(fx), np.asarray(fy)])


def _port_relax_unfused(planes, params, iters, D):
    return np.stack([to_numpy(t) for t in tk.relax_phase_unfused_plain(
        *[T(p) for p in planes], params, iters, D)])


@pytest.mark.parametrize("shape", [(4, 48, 96), (2, 45, 203)])
def test_median5_matches_pallas(rng, interp, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(jk.median5_pallas(jnp.asarray(x)))
    np.testing.assert_array_equal(to_numpy(tk.median5(T(x))), ref)


def test_warp_plain_matches_pallas(rng, interp):
    h, w = 200, 520
    img = rng.standard_normal((h, w, 2)).astype(np.float32)
    flow = _smooth_flow(h, w)
    imgs = np.stack([img, img[::-1]])
    flows = np.stack([flow, -flow])
    ref = np.asarray(jk.warp_tiled_pallas(jnp.asarray(imgs),
                                          jnp.asarray(flows)))
    got = to_numpy(tk.warp_tiled_plain(T(imgs), T(flows)))
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)


@pytest.mark.parametrize("b,h,w", [(2, 48, 96), (1, 45, 203)])
def test_median5_diffuse_plain_matches_pallas(rng, interp, b, h, w):
    x = rng.standard_normal((2 * b, h, w)).astype(np.float32)
    c = rng.random((b, h, w)).astype(np.float32)
    ref = np.asarray(jk.median5_diffuse_pallas(jnp.asarray(x), jnp.asarray(c)))
    got = to_numpy(tk.median5_diffuse_plain(T(x), T(c)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_relax_plain_matches_pallas(rng, interp):
    """test_relax_kernel_fused_bf_interpret's case: 2 iterations, D=2."""
    params = flow_params_by_name("pixflow_low")
    planes = _relax_inputs(rng, 1, 64, 128)
    ref = _pallas_relax(planes, params, 2, 2, (32, 128))
    got = np.stack([to_numpy(t) for t in tk.relax_phase_fused_plain(
        *[T(p) for p in planes], params, 2, 2)])
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_relax_plain_matches_pallas_production(rng, interp):
    """The production schedule (3 iterations, D=2, bf16 w1, folded
    descent sample) on both flow directions, at two Pallas tile sizes."""
    params = flow_params_by_name("pixflow_low_fast")
    assert (params.relax_iters_per_phase, params.fast_window) == (3, 2)
    assert params.w1_bf16 and params.fold_descent_sample
    planes = _relax_inputs(rng, 2, 96, 200)
    ref = _pallas_relax(planes, params, 3, 2, (32, 128))
    ref2 = _pallas_relax(planes, params, 3, 2, params.pallas_tile)
    np.testing.assert_array_equal(ref2, ref)   # tile-size invariant
    got = np.stack([to_numpy(t) for t in tk.relax_phase_fused_plain(
        *[T(p) for p in planes], params, 3, 2)])
    diff = np.abs(got - ref).max(axis=0)
    assert (diff > 1e-5).mean() <= 5e-4, np.argwhere(diff > 1e-5)
    assert np.median(diff) <= 1e-6


def test_relax_plain_unfolded_matches_pallas(rng, interp):
    params = dataclasses.replace(flow_params_by_name("pixflow_low"),
                                 fold_descent_sample=False, w1_bf16=False)
    planes = _relax_inputs(rng, 1, 48, 96)
    ref = _pallas_relax(planes, params, 2, 3, (32, 128))
    got = np.stack([to_numpy(t) for t in tk.relax_phase_fused_plain(
        *[T(p) for p in planes], params, 2, 3)])
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("D", [2, 3, 4])
@pytest.mark.parametrize("fold,w1_bf16", [(True, False), (False, False),
                                          (True, True)])
def test_relax_unfused_plain_matches_pallas(rng, interp, fold, w1_bf16, D):
    """test_relax_kernel_interpret's cases (2 iterations, a given target)
    over the whole plane, at D = 2, 3 and 4 (beyond the hat windows the
    CUDA kernel unrolls)."""
    params = dataclasses.replace(flow_params_by_name("pixflow_low"),
                                 fold_descent_sample=fold, w1_bf16=w1_bf16)
    planes = _unfused_inputs(rng, 1, 48, 96)
    ref = _pallas_relax_unfused(planes, params, 2, D, (32, 128))
    got = _port_relax_unfused(planes, params, 2, D)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_relax_unfused_plain_matches_pallas_production(rng, interp):
    """The unfused knob's schedule (3 iterations, D=2, bf16 w1, folded
    descent sample) on both flow directions, at the production tile; the
    share gate of the fused production test."""
    params = dataclasses.replace(flow_params_by_name("pixflow_low"),
                                 fuse_level_blurs=False)
    assert (params.relax_iters_per_phase, params.fast_window) == (3, 2)
    planes = _unfused_inputs(rng, 2, 96, 200)
    ref = _pallas_relax_unfused(planes, params, 3, 2, params.pallas_tile)
    got = _port_relax_unfused(planes, params, 3, 2)
    diff = np.abs(got - ref).max(axis=0)
    assert (diff > 1e-5).mean() <= 5e-4, np.argwhere(diff > 1e-5)
    assert np.median(diff) <= 1e-6


@pytest.mark.parametrize("fused", [True, False])
def test_relax_plain_matches_pallas_at_10_iterations(rng, interp, fused):
    """The widened contract: 10 iterations, beyond the 7 the CUDA kernel
    unrolls, on both flow directions at the production schedule; the share
    gate of the production tests (flipped strict-< takes grow with the
    iterations, mostly in the first and last rows)."""
    params = flow_params_by_name("pixflow_low_fast")
    if fused:
        planes = _relax_inputs(rng, 2, 96, 200)
        ref = _pallas_relax(planes, params, 10, 2, (32, 128))
        got = np.stack([to_numpy(t) for t in tk.relax_phase(
            *[T(p) for p in planes], params, 10, 2)])
    else:
        planes = _unfused_inputs(rng, 2, 96, 200)
        ref = _pallas_relax_unfused(planes, params, 10, 2, (32, 128))
        got = np.stack([to_numpy(t) for t in tk.relax_phase_unfused(
            *[T(p) for p in planes], params, 10, 2)])
    diff = np.abs(got - ref).max(axis=0)
    assert (diff > 1e-5).mean() <= 5e-4, np.argwhere(diff > 1e-5)
    assert np.median(diff) <= 1e-6


def test_median5_diffuse_plain_matches_pallas_at_width_17(rng, interp):
    """A width the CUDA kernel does not unroll; the Pallas kernel's window
    (24 spare rows) holds widths up to 19."""
    x = rng.standard_normal((2, 45, 203)).astype(np.float32)
    c = rng.random((1, 45, 203)).astype(np.float32)
    ref = np.asarray(jk.median5_diffuse_pallas(jnp.asarray(x),
                                               jnp.asarray(c), 17, 8.0))
    got = to_numpy(tk.median5_diffuse(T(x), T(c), 17, 8.0))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_median5_diffuse_plain_matches_jnp_ops_at_width_21(rng):
    """Width 21, wider than the Pallas kernel's window holds: against the
    kernel's contract made of the JAX package's jnp ops -- its 5x5 median
    of the edge-padded planes, its Gaussian taps, the separable blur x
    first, taps ascending, and the blend."""
    from panorama_opticalflow_tpu.ops import image as jim

    ksize, sigma, gr = 21, 8.0, 10
    x = rng.standard_normal((4, 45, 203)).astype(np.float32)
    c = rng.random((2, 45, 203)).astype(np.float32)
    h, w = x.shape[1:]
    taps = np.asarray(jim.gaussian_kernel_1d(ksize, sigma))
    med = jnp.stack([jim.median5(jnp.pad(jnp.asarray(p), gr, mode="edge"))
                     for p in x])
    acc = sum(float(taps[t]) * med[:, :, t:t + w] for t in range(ksize))
    blur = sum(float(taps[t]) * acc[:, t:t + h, :] for t in range(ksize))
    cc = jnp.repeat(jnp.asarray(c), 2, axis=0)
    ref = np.asarray(cc * blur + (1.0 - cc) * med[:, gr:gr + h, gr:gr + w])
    got = to_numpy(tk.median5_diffuse(T(x), T(c), ksize, sigma))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_wrappers_take_plain_version_on_cpu(rng):
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing."""
    tk.reset_launch_counts()
    params = flow_params_by_name("pixflow_low_fast")
    img = T(rng.standard_normal((2, 70, 150, 2)).astype(np.float32))
    flow = T(np.stack([_smooth_flow(70, 150)] * 2) * 0.1)
    assert torch.equal(tk.warp_tiled(img, flow), tk.warp_tiled_plain(img,
                                                                      flow))
    off = tk.warp_tile_offsets(flow)
    assert off.dtype == torch.int32 and tuple(off.shape) == (2, 2, 2, 2)
    assert torch.equal(tk.warp_tiled(img, flow, off),
                       tk.warp_tiled_plain(img, flow))
    x = T(rng.standard_normal((4, 40, 70)).astype(np.float32))
    c = T(rng.random((2, 40, 70)).astype(np.float32))
    assert torch.equal(tk.median5_diffuse(x, c),
                       tk.median5_diffuse_plain(x, c))
    planes = [T(p) for p in _relax_inputs(rng, 2, 40, 70)]
    got = tk.relax_phase(*planes, params, 3, 2)
    ref = tk.relax_phase_fused_plain(*planes, params, 3, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert torch.equal(tk.median5(x), tk.median5_plain(x))
    planes = [T(p) for p in _unfused_inputs(rng, 2, 40, 70)]
    got = tk.relax_phase_unfused(*planes, params, 2, 2)
    ref = tk.relax_phase_unfused_plain(*planes, params, 2, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    lv = [T(p) for p in rng.standard_normal((5, 2, 20, 23)).astype(
        np.float32)]
    level = (lv[0], lv[1], torch.stack(lv[2:4], -1), lv[4].abs(),
             lv[4].abs(), torch.zeros(2, 20, 23, 2), params)
    assert torch.equal(tk.exact_level(*level, 1, 2),
                       tk.exact_level_plain(*level, 1, 2))
    il, ir = (T(rng.integers(0, 256, (30, 60, 4), dtype=np.uint8))
              for _ in range(2))
    fl, fr = (T(rng.standard_normal((30, 40, 2)).astype(np.float32) * 3)
              for _ in range(2))
    bl = T(rng.random((30, 40)).astype(np.float32))
    assert torch.equal(tk.novel_view(il, ir, fl, fr, bl, (35, 40)),
                       tk.novel_view_plain(il, ir, fl, fr, bl, (35, 40)))
    codes = T(rng.choice(np.array([0, 50, 100, 150], np.uint8), (2, 30, 60)))
    assert all(torch.equal(a, b) for a, b in zip(
        tk.blend_distances(codes, 3, 20.5, 4),
        tk.blend_distances_plain(codes, 3, 20.5, 4)))
    cmap = T(rng.choice(np.array([0, 50, 100, 150], np.uint8), (30, 60)))
    merged = T(rng.integers(0, 256, (30, 60, 4), dtype=np.uint8))
    assert torch.equal(tk.hole_composite(cmap, il, ir, merged, 7, (35, 40)),
                       tk.hole_composite_plain(cmap, il, ir, merged, 7,
                                               (35, 40)))
    assert len(tk.KERNELS) == 12
    assert all(k.launches == 0 for k in tk.KERNELS)


def test_wrappers_reject_what_the_kernels_do_not_take(rng):
    params = flow_params_by_name("pixflow_low_fast")
    x = T(rng.standard_normal((4, 40, 70)).astype(np.float32))
    c = T(rng.random((2, 40, 70)).astype(np.float32))
    with pytest.raises(TypeError):
        tk.median5_diffuse(x.double(), c)
    with pytest.raises(ValueError):
        tk.median5_diffuse(x, c[:1])
    with pytest.raises(ValueError):
        tk.median5_diffuse(x.transpose(1, 2).contiguous().transpose(1, 2), c)
    with pytest.raises(ValueError):
        tk.warp_tiled(x, x)
    img = T(rng.standard_normal((1, 70, 150, 2)).astype(np.float32))
    off = tk.warp_tile_offsets(img)
    with pytest.raises(ValueError, match="offsets"):
        tk.warp_tiled(img, img, off[:, :1].contiguous())
    with pytest.raises(ValueError, match="offsets"):
        tk.warp_tiled(img, img, off.float())
    planes = [T(p) for p in _relax_inputs(rng, 1, 20, 30)]
    with pytest.raises(ValueError):
        tk.relax_phase(*planes, params, 3, 0)
    with pytest.raises(ValueError):
        tk.relax_phase(*planes[:-1], planes[-1][:, :10], params, 3, 2)
    with pytest.raises(TypeError):
        tk.median5(x.double())
    with pytest.raises(ValueError):
        tk.median5(x[0])
    with pytest.raises(ValueError):
        tk.median5(x.transpose(1, 2).contiguous().transpose(1, 2))
    planes = [T(p) for p in _unfused_inputs(rng, 1, 20, 30)]
    with pytest.raises(ValueError):
        tk.relax_phase_unfused(*planes, params, 0, 2)
    with pytest.raises(ValueError):       # bfy of another shape
        tk.relax_phase_unfused(*planes[:9], planes[9][:, :10], planes[10],
                               params, 3, 2)
    with pytest.raises(TypeError):        # the 9 planes of the fused kernel
        tk.relax_phase_unfused(*planes[:8], planes[10], params, 3, 2)


# ---------------------------------------------------------------------------
# the two-tap gather form of the hat passes (what the CUDA kernels compute)
# ---------------------------------------------------------------------------

# residuals that sit on the clamp, on exact integers, just below an integer
# (r - floor(r) rounds to 1.0), at +-0 and at negative fractions
_SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, 2.0, -2.0, 3.0, -3.0, 7.0, -7.0,
                     -1e-10, 1e-10, -1.0 - 1e-7, 0.5, -0.5, -1.25, 1.999,
                     -1.999, 2.999, -2.999, 7.999, -7.999, 8.5, -8.5, 30.0,
                     -30.0], np.float32)


def _two_taps(r, weight_fn):
    """floor(r) and the weights of taps floor(r), floor(r) + 1."""
    t0 = torch.floor(r)
    return t0.to(torch.int64), weight_fn(r - t0), weight_fn(r - (t0 + 1.0))


def _two_tap_sum(w0, v0, w1, v1):
    """0 + w0*v0 + w1*v1, each op rounded, in the dense sum's order."""
    return (torch.zeros_like(v0) + w0 * v0) + w1 * v1


def _warp_two_tap(img, flow):
    """tk.warp_tiled_plain with four reads an output: the two y taps, and
    at each of those window rows that row's own clamped x residual with its
    two x taps.  x sums first, taps ascending."""
    th, tw = tk.WARP_TILE
    m, lim = tk.WARP_MARGIN, tk.WARP_MARGIN - 1e-3
    nb, h, w, _ = img.shape
    off = trf.tile_offsets(flow, th, tw, tk.WARP_MAX_OFF).to(torch.int64)
    y = torch.arange(h)[:, None].expand(h, w)
    x = torch.arange(w)[None, :].expand(h, w)
    out = torch.empty_like(img)
    for b in range(nb):
        ox = off[b, y // th, x // tw, 0]
        oy = off[b, y // th, x // tw, 1]
        ry = torch.clamp(flow[b, ..., 1] - oy.to(torch.float32), -lim, lim)
        jy, wy0, wy1 = _two_taps(ry, trf._hat)
        xs = []
        for t in (jy, jy + 1):
            # the residual of the window row: rows of the tile, edge-extended
            yq = torch.clamp(y % th + t, 0, th - 1)
            gy = torch.clamp(y // th * th + yq, max=h - 1)
            rx = torch.clamp(flow[b, gy, x, 0] - ox.to(torch.float32),
                             -lim, lim)
            ix, wx0, wx1 = _two_taps(rx, trf._hat)
            assert int(ix.min()) >= -m and int(ix.max()) + 1 <= m
            sy = torch.clamp(y + t + oy, 0, h - 1)
            v0 = img[b, sy, torch.clamp(x + ox + ix, 0, w - 1)]
            v1 = img[b, sy, torch.clamp(x + ox + ix + 1, 0, w - 1)]
            xs.append(_two_tap_sum(wx0[..., None], v0, wx1[..., None], v1))
        out[b] = _two_tap_sum(wy0[..., None], xs[0], wy1[..., None], xs[1])
    return out


@pytest.mark.parametrize("h,w,seed", [(70, 150, 0), (130, 261, 1)])
def test_warp_two_tap_form_equals_plain(h, w, seed):
    rng = np.random.default_rng(seed)
    img = T(rng.standard_normal((2, h, w, 2)).astype(np.float32))
    flow = np.stack([_smooth_flow(h, w), -_smooth_flow(h, w)]) \
        + rng.standard_normal((2, h, w, 2)).astype(np.float32) * 0.4
    # a third of the pixels: an integer offset plus a special residual
    pick = rng.random((2, h, w, 2)) < 0.33
    special = rng.integers(-40, 40, (2, h, w, 2)).astype(np.float32) \
        + rng.choice(_SPECIAL, (2, h, w, 2))
    flow = T(np.where(pick, special, flow).astype(np.float32))
    assert torch.equal(_warp_two_tap(img, flow), tk.warp_tiled_plain(img, flow))


def _sample_maps_two_tap(w1_pad, dx, dy, D):
    """trf.sample_maps (S, the four neighbour maps, Gx, Gy) with two taps a
    pass; the x pass yields the hat and the dhat sums from one read."""
    h, w = dx.shape[-2:]
    r, lim = D + 1, D - 1e-3
    dx_ext = trf._pad2(torch.clamp(dx, -lim, lim), r, r, 1, 1)[:, None]
    dyc = torch.clamp(dy, -lim, lim)[:, None]
    xr, xw = h + 2 * r, w + 2
    ix, *_ = _two_taps(dx_ext, trf._hat)
    assert int(ix.min()) >= -D and int(ix.max()) + 1 <= D
    cols = (torch.arange(xw) + D)[None, None, None, :] + ix
    rows = w1_pad[..., :xr, :]
    v0 = torch.gather(rows, -1, cols.expand(rows.shape[:2] + (xr, xw)))
    v1 = torch.gather(rows, -1, (cols + 1).expand(rows.shape[:2] + (xr, xw)))
    x_hat, x_dhat = (_two_tap_sum(w0, v0, w1, v1) for _, w0, w1 in
                     (_two_taps(dx_ext, f) for f in (trf._hat, trf._dhat)))

    def y_pass(x_acc, weight_fn, ro, co):
        jy, w0, w1 = _two_taps(dyc, weight_fn)
        idx = (torch.arange(h)[:, None] + r + ro + jy).expand(
            x_acc.shape[:2] + (h, w))
        cut = x_acc[..., 1 + co:1 + co + w]
        return _two_tap_sum(w0, torch.gather(cut, -2, idx),
                            w1, torch.gather(cut, -2, idx + 1))

    nbrs = {"xp": y_pass(x_hat, trf._hat, 0, 1),
            "xm": y_pass(x_hat, trf._hat, 0, -1),
            "yp": y_pass(x_hat, trf._hat, 1, 0),
            "ym": y_pass(x_hat, trf._hat, -1, 0)}
    return (y_pass(x_hat, trf._hat, 0, 0), nbrs,
            y_pass(x_dhat, trf._hat, 0, 0), y_pass(x_hat, trf._dhat, 0, 0))


@pytest.mark.parametrize("D", [1, 2, 3])
def test_sample_maps_two_tap_form_equals_dense(D):
    rng = np.random.default_rng(D)
    b, h, w = 2, 37, 61
    w1 = T(rng.standard_normal((b, 2, h, w)).astype(np.float32))
    w1 = w1.to(torch.bfloat16).to(torch.float32)
    w1_pad = trf._pad2(w1, D + 1, D + 1, D + 1, D + 1)
    d = []
    for _ in range(2):
        a = rng.standard_normal((b, h, w)).astype(np.float32)
        pick = rng.random((b, h, w)) < 0.4
        d.append(T(np.where(pick, rng.choice(_SPECIAL, (b, h, w)), a)))
    S, nbrs, Gx, Gy = _sample_maps_two_tap(w1_pad, d[0], d[1], D)
    S0, nbrs0, Gx0, Gy0 = trf.sample_maps(w1_pad, d[0], d[1], D, True, True)
    assert torch.equal(S, S0)
    for key in ("xp", "xm", "yp", "ym"):
        assert torch.equal(nbrs[key], nbrs0[key]), key
    assert torch.equal(Gx, Gx0)
    assert torch.equal(Gy, Gy0)


# ---------------------------------------------------------------------------
# the median selection network and the run-of-four form of the median kernels
# ---------------------------------------------------------------------------

NET_FILE = os.path.join(os.path.dirname(os.path.abspath(tk.__file__)),
                        os.pardir, "csrc", "median25_net.inc")


def _median_network():
    """(sorter of one column on 5 wires, merger of two sorted columns on
    10 wires, selection on the 25 wires of a window given as two merged
    pairs and a sorted column, wire that holds the median), as nvcc reads
    them: one macro call a line, anything else a comment or a
    preprocessor line."""
    nets = {"COLSWAP": [], "PAIRSWAP": [], "CSWAP": [], "MEDIAN_AT": []}
    for line in open(NET_FILE):
        line = line.strip()
        m = re.fullmatch(r"PANO_([A-Z_]+)\((\d+)(?:, (\d+))?\)", line)
        if not m:
            assert not line or line[:2] == "//" or line[0] == "#", line
        elif m[1] == "MEDIAN_AT":
            nets[m[1]].append(int(m[2]))
        else:
            nets[m[1]].append((int(m[2]), int(m[3])))
    (at,) = nets["MEDIAN_AT"]
    return nets["COLSWAP"], nets["PAIRSWAP"], nets["CSWAP"], at


def _window_network():
    """The whole selection of one window on 25 wires (wire 5 * c + r =
    row r of column c): every column sorted, columns (0, 1) and (2, 3)
    merged, then the selection."""
    col, pair, net, at = _median_network()
    full = [(5 * c + i, 5 * c + j) for c in range(5) for i, j in col]
    full += [(o + i, o + j) for o in (0, 10) for i, j in pair]
    return full + net, at


def _exchange(v, net):
    for i, j in net:
        v[i], v[j] = min(v[i], v[j]), max(v[i], v[j])
    return v


def test_median_network_file_is_what_the_kernels_include():
    col, pair, net, at = _median_network()
    assert len(col) == 9 and all(0 <= i < j < 5 for i, j in col)
    assert all(0 <= i < j < 10 for i, j in pair)
    assert all(0 <= i < 25 and 0 <= j < 25 and i != j for i, j in net)
    assert 0 <= at < 25
    # a run of eight adjacent outputs (pano::MEDIAN_RUN) sorts 12 columns
    # and merges 6 pairs for its 8 windows: fewer than 99 exchanges an output
    assert (12 * len(col) + 6 * len(pair) + 8 * len(net)) / 8 < 99
    # the count chip_smoke.py's bound takes for a median: a column sort and
    # half a pair merge an output, and the selection's results that are read
    live, read = {at}, 0
    for i, j in reversed(net):
        read += (i in live) + (j in live)
        if i in live or j in live:
            live |= {i, j}
    import chip_smoke

    assert chip_smoke.MEDIAN_OPS == 2 * len(col) + len(pair) + read
    csrc = os.path.dirname(NET_FILE)
    common = open(os.path.join(csrc, "common.cuh")).read()
    assert common.count('#include "median25_net.inc"') == 3
    for name in ("median5.cu", "median5_diffuse.cu"):
        src = open(os.path.join(csrc, name)).read()
        assert "pano::median5_run(" in src
    # the 32-way sort of the first port is gone
    assert "k <<= 1" not in common and "0x7f800000" not in common


def test_median_column_sorter_and_pair_merger_on_all_zero_one_inputs():
    col, pair, _, _ = _median_network()
    for bits in itertools.product((0, 1), repeat=5):
        assert _exchange(list(bits), col) == sorted(bits)
    for a, b in itertools.product(range(6), repeat=2):
        v = [0] * (5 - a) + [1] * a + [0] * (5 - b) + [1] * b
        assert _exchange(list(v), pair) == sorted(v)


def test_median_network_selects_median_of_all_zero_one_inputs():
    """The 0-1 principle, bit-parallel: a network of min/max exchanges
    selects the 13th smallest of every 25 reals iff it does so for every
    25 zeros and ones.  Input n (0 <= n < 2^25) puts bit i of n on wire i;
    a wire is one packed vector of 2^25 bits (bit n % 64 of word n // 64),
    an exchange an AND and an OR, and the median wire must read 'at least
    13 ones' on all 33,554,432 inputs.  The selection takes its three
    parts in any order (a window is pair, pair, column or column, pair,
    pair): that is a permutation of the inputs, which 'all inputs' covers."""
    net, at = _window_network()
    words = np.arange(1 << 19, dtype=np.uint64)
    ones = ~np.uint64(0)
    low = [sum(1 << b for b in range(64) if b >> i & 1) for i in range(6)]
    wires = [np.full(1 << 19, low[i], np.uint64) if i < 6 else
             np.where(words >> np.uint64(i - 6) & np.uint64(1), ones,
                      np.uint64(0)) for i in range(25)]
    for i, j in net:
        wires[i], wires[j] = wires[i] & wires[j], wires[i] | wires[j]
    # popcount(n) = popcount(n % 64) + popcount(n // 64)
    high = np.zeros(1 << 19, np.int64)
    for b in range(19):
        high += (words >> np.uint64(b) & np.uint64(1)).astype(np.int64)
    at_least = np.array(
        [sum(1 << b for b in range(64) if bin(b).count("1") >= k)
         for k in range(8)], np.uint64)        # k = 7: no 6-bit number
    want = at_least[np.clip(13 - high, 0, 7)]
    assert np.array_equal(wires[at], want)


def _exchange_planes(wires, net):
    wires = list(wires)
    for i, j in net:
        wires[i], wires[j] = (torch.minimum(wires[i], wires[j]),
                              torch.maximum(wires[i], wires[j]))
    return wires


def _planes_with_ties(rng, shape):
    """Seeded planes with repeated values, +-0 and +-inf."""
    x = rng.standard_normal(shape).astype(np.float32)
    pick = rng.random(shape)
    x[pick < 0.25] = 0.5
    x[(pick >= 0.25) & (pick < 0.35)] = 0.0
    x[(pick >= 0.35) & (pick < 0.45)] = -0.0
    x[(pick >= 0.45) & (pick < 0.5)] = np.inf
    x[(pick >= 0.5) & (pick < 0.55)] = -np.inf
    return T(x)


@pytest.mark.parametrize("shape", [(2, 45, 203), (3, 7, 9), (1, 1, 1)])
def test_median_network_on_planes_equals_plain(rng, shape):
    """The network on the 25 shifted copies of an edge-padded plane."""
    net, at = _window_network()
    x = _planes_with_ties(rng, shape)
    h, w = shape[1:]
    xp = trf._pad2(x, 2, 2, 2, 2)
    wires = [xp[:, r:r + h, c:c + w] for c in range(5) for r in range(5)]
    assert torch.equal(_exchange_planes(wires, net)[at],
                       tk.median5_plain(x))


RUN = 8     # pano::MEDIAN_RUN: adjacent medians a thread and step


def _stage(x, y_first, x_first, rows, cols):
    """A block's shared-memory window: indices clamped to the plane."""
    h, w = x.shape[-2:]
    yy = torch.clamp(torch.arange(rows) + y_first, 0, h - 1)
    xx = torch.clamp(torch.arange(cols) + x_first, 0, w - 1)
    return x[..., yy[:, None], xx[None, :]]


def _median_runs(xs, rows, runs):
    """pano::median5_run on every run of a staged window: (rows, 8 * runs)
    medians from the window's rows x (8 * runs + 4) values.  A run loads 5
    rows of 12 values, sorts its 12 columns, merges the column pairs
    (0, 1), (2, 3), ..., and selects each of its 8 medians from two merged
    pairs and one column: window m is pairs m / 2, m / 2 + 1 and column
    m + 4 if m is even, column m and pairs (m + 1) / 2, (m + 1) / 2 + 1 if
    odd."""
    col, pair, net, at = _median_network()
    q = RUN * torch.arange(runs)
    cols = [_exchange_planes([xs[..., r:r + rows, :][..., q + c]
                              for r in range(5)], col)
            for c in range(RUN + 4)]
    pairs = [_exchange_planes(cols[2 * k] + cols[2 * k + 1], pair)
             for k in range(RUN // 2 + 2)]
    meds = []
    for m in range(RUN):
        k = (m + 1) // 2
        single = cols[m if m % 2 else m + 4]
        meds.append(_exchange_planes(pairs[k] + pairs[k + 1] + single,
                                     net)[at])
    return torch.stack(meds, -1).flatten(-2)   # run-major: column 8i + m


def _median5_tiles(x):
    """csrc/median5.cu: (32, 128) tiles, 16 runs a row."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, float("nan"))
    for y0 in range(0, h, 32):
        for x0 in range(0, w, 128):
            th = min(32, h - y0)
            xs = _stage(x, y0 - 2, x0 - 2, th + 4, 132)
            tw = min(128, w - x0)
            out[..., y0:y0 + th, x0:x0 + tw] = \
                _median_runs(xs, th, 128 // RUN)[..., :tw]
    return out


def _median5_diffuse_tiles(x, c, ksize, sigma):
    """csrc/median5_diffuse.cu: (64, 128) tiles; a tile stages its window,
    takes the medians of the tile and the blur margin in runs of eight,
    blurs along x in runs of four into (rows, tile width), then along y,
    and blends."""
    from panorama_opticalflow_tpu_torch.ops.image import gaussian_kernel_1d

    taps = [float(t) for t in gaussian_kernel_1d(ksize, sigma)]
    gr = ksize // 2
    h, w = x.shape[-2:]
    cc = c.repeat_interleave(2, dim=0)
    out = torch.full_like(x, float("nan"))
    for y0 in range(0, h, 64):
        for x0 in range(0, w, 128):
            th, tw = min(64, h - y0), min(128, w - x0)
            mh = th + 2 * gr
            mruns = -(-(tw + 2 * gr) // RUN)
            oruns = -(-tw // 4)
            xs = _stage(x, y0 - gr - 2, x0 - gr - 2, mh + 4,
                        RUN * mruns + 4)
            med = _median_runs(xs, mh, mruns)
            # the x pass runs on 4 * oruns columns; those past the medians
            # computed above feed no output
            need = 4 * oruns + 2 * gr
            med_x = torch.nn.functional.pad(med, (0, max(0, need
                                                         - med.shape[-1])))
            accx = torch.zeros(x.shape[:-2] + (mh, 4 * oruns))
            for t in range(ksize):
                accx = accx + taps[t] * med_x[..., t:t + 4 * oruns]
            blur = torch.zeros(x.shape[:-2] + (th, 4 * oruns))
            for t in range(ksize):
                blur = blur + taps[t] * accx[..., t:t + th, :]
            mc = med[..., gr:gr + th, gr:gr + tw]
            cv = cc[..., y0:y0 + th, x0:x0 + tw]
            out[..., y0:y0 + th, x0:x0 + tw] = \
                cv * blur[..., :tw] + (1.0 - cv) * mc
    return out


_RAGGED = [(2, 45, 203), (2, 1, 1), (2, 3, 2), (4, 33, 131), (2, 65, 129),
           (2, 64, 256)]


@pytest.mark.parametrize("shape", _RAGGED)
def test_median5_run_form_equals_plain(rng, shape):
    x = _planes_with_ties(rng, shape)
    assert torch.equal(_median5_tiles(x), tk.median5_plain(x))


@pytest.mark.parametrize("shape", _RAGGED)
@pytest.mark.parametrize("ksize", [15, 5])
def test_median5_diffuse_run_form_equals_plain(rng, shape, ksize):
    x = T(rng.standard_normal(shape).astype(np.float32))
    x[rng.random(shape) < 0.3] = 0.5
    c = T(rng.random((shape[0] // 2,) + shape[1:]).astype(np.float32))
    assert torch.equal(_median5_diffuse_tiles(x, c, ksize, 8.0),
                       tk.median5_diffuse_plain(x, c, ksize, 8.0))


def test_median5_diffuse_refuses_a_width_that_is_not_built(rng):
    """Widths below 1 are refused everywhere; on the CPU every other width
    is the plain version's (the card's limit is in test_torch_card.py)."""
    x = T(rng.standard_normal((2, 20, 30)).astype(np.float32))
    c = T(rng.random((1, 20, 30)).astype(np.float32))
    assert tk.DIFFUSE_WIDTHS == (3, 5, 7, 9, 11, 13, 15)
    for ksize in (0, -1, 2.5):
        with pytest.raises(ValueError, match="ksize"):
            tk.median5_diffuse(x, c, ksize)
    for ksize in (1, 4, 17, 31) + tk.DIFFUSE_WIDTHS:
        assert torch.equal(tk.median5_diffuse(x, c, ksize),
                           tk.median5_diffuse_plain(x, c, ksize))
