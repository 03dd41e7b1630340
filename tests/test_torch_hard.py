"""The port against the JAX package on hard scenes, on the CPU.

Every other fidelity gate runs on smooth scenes with shifts of at most 3
px (utils/data.synthesize_fisheye_set), where the solver's clamps never
engage.  Here a seeded, numpy-only generator (``hard_views``) makes two
views of one scene with:

  * broadband texture (a 1/f^1.2 spectrum with random phases, plus sharp
    edged patches);
  * 10-30 px of horizontal parallax (and up to 3 px vertical), varying
    across the overlap;
  * foreground discs nearer than the background (8-12 px more parallax),
    which disocclude background in one view;
  * an exposure step between the views (gain 1.3, offset +10).

What the scenes engage, asserted: the hat window (relax samples at
offsets beyond D - 1e-3 from the recentred warp, so the window clamp
binds) and the warp's per-tile integer offsets at and past its margin of
8 px.  What 10-30 px of parallax cannot engage: the solver runs at half
resolution, where the flow stays under ~21 px and within 3.3 px of its
64 x 128 tile's mean, so neither the warp's residual clamp (+-(8 - 1e-3))
nor its offset clamp (WARP_MAX_OFF, 96) binds.  Those two are held on
the finest level's own inputs with the incoming flow moved by 100 px in x
and 12 px more on half the columns (tile offsets at 96, residuals past
the margin).

Gates, as in tests/test_torch_pixflow.py and tests/test_torch_pipeline.py:

  * pixflow_low's flow at 256 x 256, each level that refines an incoming
    flow run by the port on the JAX level's very inputs: <= 1e-4 px on
    >= 99 % of the pixels; the coarsest level (zero init, exact path,
    chaotic at the ulp level: ROADMAP queue 3 item 9) by mean endpoint
    error <= 0.05 px;
  * the stitch (stitch_pair_auto on a 128 x 640 pair, pixflow_low_fast,
    the main path's preset): the golden gate of
    tests/test_golden.py::_check.  pixflow_low's stitch of such a pair
    leaves the golden gate within the JAX package itself: on broadband
    texture a sub-pixel flow difference moves a nearest sample to another
    texel, and the package's jitted and op-by-op runs of one pair differ
    through item 9 (on a 1/f^0.8 texture, flows by a mean of 0.05 px and
    stitches by SSIM 0.976, 3 % of the values off by more than 8; the port
    against the jitted run: SSIM 0.977).  That preset is held level by
    level above;
  * the finest level past the warp's clamps: the refining levels' gate.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from panorama_opticalflow_tpu.models import pipeline as jpl
from panorama_opticalflow_tpu.models import pixflow as jpf
from panorama_opticalflow_tpu.ops.pallas import kernels as jk
from panorama_opticalflow_tpu.utils import config as jcfg
from panorama_opticalflow_tpu_torch import (StitchConfig,
                                            flow_params_by_name, ssim,
                                            to_numpy, to_torch)
from panorama_opticalflow_tpu_torch.models import pipeline
from panorama_opticalflow_tpu_torch.models import pixflow as tpf
from panorama_opticalflow_tpu_torch.ops import kernels as tk
from panorama_opticalflow_tpu_torch.ops import relax_fast
from panorama_opticalflow_tpu_torch.utils import runtime

torch.set_num_threads(2)
runtime.settle_cpu_math()


def _texture(rng, h, w):
    """(h, w, 3) broadband texture in [0, 255]: a 1/f^1.2 amplitude
    spectrum with random phases, plus sharp-edged patches."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    amp = f ** -1.2
    amp[0, 0] = 0.0
    chans = []
    for _ in range(3):
        spec = amp * np.exp(2j * np.pi * rng.random(amp.shape))
        chans.append(np.fft.irfft2(spec, s=(h, w)))
    t = np.stack(chans, -1)
    lo, hi = np.percentile(t, (1, 99))
    t = (t - lo) / (hi - lo) * 200.0 + 28.0
    for _ in range(h * w // 400):
        y, x = rng.integers(0, h), rng.integers(0, w)
        t[y:y + rng.integers(2, 9), x:x + rng.integers(2, 9)] = \
            rng.uniform(0, 255, 3)
    return np.clip(t, 0, 255)


def hard_views(h: int, w: int, seed: int, ov: tuple[int, int]):
    """Two (h, w, 3) uint8 views of one scene; view 1 is seen with parallax
    d(x) from 10 px at column ov[0] to 30 px at ov[1] (constant beyond),
    foreground discs with 8-12 px more, and an exposure step."""
    rng = np.random.default_rng(seed)
    pad = 64
    bg = _texture(rng, h + 2 * pad, w + 2 * pad)
    xs = np.arange(w)
    d_bg = 10.0 + 20.0 * np.clip((xs - ov[0]) / max(1, ov[1] - ov[0]), 0, 1)
    d_y = 3.0 * np.clip((xs - ov[0]) / max(1, ov[1] - ov[0]), 0, 1)
    discs = []
    for _ in range(6):
        cy, cx = rng.uniform(0.15 * h, 0.85 * h), rng.uniform(*ov)
        discs.append((cy, cx, rng.uniform(0.08, 0.16) * h,
                      rng.uniform(8, 12), _texture(rng, h, w)))
    yy, xx = np.mgrid[0:h, 0:w]
    views = []
    for v in (0, 1):
        sy = np.clip(yy + pad + np.rint(v * d_y[xx]).astype(int), 0,
                     h + 2 * pad - 1)
        sx = np.clip(xx + pad + np.rint(v * d_bg[xx]).astype(int), 0,
                     w + 2 * pad - 1)
        img = bg[sy, sx]
        for cy, cx, rad, extra, tex in discs:
            # the disc sits at cx in view 0 and moves by its own parallax
            shift = v * (np.interp(cx, xs, d_bg) + extra)
            inside = (yy - cy) ** 2 + (xx + shift - cx) ** 2 < rad * rad
            img = np.where(inside[..., None],
                           tex[yy, np.clip(np.rint(xx + shift).astype(int),
                                           0, w - 1)], img)
        if v == 1:
            img = img * 1.3 + 10.0
        views.append(np.clip(img, 0, 255).astype(np.uint8))
    return views


def hard_pair(h: int, w: int, seed: int):
    """Two full-footprint RGBA images for the flow solver (a low-alpha band
    on the left of image 1, as tests/test_torch_pixflow.py's pair has)."""
    v0, v1 = hard_views(h, w, seed, (w // 8, 7 * w // 8))
    img0 = np.concatenate([v0, np.full((h, w, 1), 255, np.uint8)], -1)
    img1 = np.concatenate([v1, np.full((h, w, 1), 255, np.uint8)], -1)
    img1[:, : w // 10, 3] = 0
    return img0, img1


def hard_canvases(h: int, w: int, seed: int):
    """A stitch pair on the equirectangular canvas: L covers columns
    [0, 0.62 w), R covers [0.38 w, w), both views of one scene with the
    parallax ramp across the overlap."""
    a, b = int(0.38 * w), int(0.62 * w)
    v0, v1 = hard_views(h, w, seed, (a, b))
    cols = np.arange(w)
    out = []
    for v, keep in ((v0, cols < b), (v1, cols >= a)):
        img = np.zeros((h, w, 4), np.uint8)
        img[:, keep, :3] = v[:, keep]
        img[:, keep, 3] = 255
        out.append(img)
    return out


def _epe(a, b):
    return np.linalg.norm(a - b, axis=-1)


def _jax_levels(img0, img1, params):
    """The JAX package's pair solve, its levels jitted as its pipeline runs
    them; every level call as (imgs, alphas, flow or None, params, output)
    in numpy."""
    levels = []
    inner = jax.jit(jpf.patch_match_level_batched, static_argnums=(3, 4, 5))

    def record(imgs, alphas, flow, hints, p, knd=None):
        out = inner(imgs, alphas, flow, hints, p, knd)
        levels.append((np.asarray(imgs), np.asarray(alphas),
                       None if flow is None else np.asarray(flow), p,
                       np.asarray(out)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpf, "patch_match_level_batched", record)
        jpf.compute_optical_flow_pair(jnp.asarray(img0), jnp.asarray(img1),
                                      params)
    return levels, inner


@pytest.fixture(scope="module")
def hard_levels():
    """pixflow_low at 256 x 256 on a hard pair (levels below
    pallas_min_pixels: the plain level path on both sides)."""
    img0, img1 = hard_pair(256, 256, seed=2)
    jp = dataclasses.replace(jcfg.flow_params_by_name("pixflow_low"),
                             scan_coarse_levels=False)
    return _jax_levels(img0, img1, jp)


def _port_level(imgs, alphas, flow, p):
    imgs, alphas = to_torch(imgs, "cpu"), to_torch(alphas, "cpu")
    return to_numpy(tpf.patch_match_level_batched(
        imgs, alphas,
        tpf.coarsest_start(imgs, alphas, ("left", "right"), p)
        if flow is None else to_torch(flow, "cpu"), p, flow is None))


def _check_refined(got, ref, shape):
    d = _epe(got, ref)
    assert (d > 1e-4).mean() <= 0.01, (shape, (d > 1e-4).mean())


def _warp_clamps(flow):
    """(largest |tile offset|, largest |residual|) of the warp's recentring
    on a (B, H, W, 2) incoming flow: the per-64 x 128-tile integer offsets
    (clamped to WARP_MAX_OFF) and the flow left over, which the warp clamps
    to +-(WARP_MARGIN - 1e-3)."""
    off = to_numpy(tk.warp_tile_offsets(to_torch(flow, "cpu")))
    th, tw = tk.WARP_TILE
    per_px = off.repeat(th, 1).repeat(tw, 2)[:, :flow.shape[1],
                                             :flow.shape[2]]
    return np.abs(off).max(), np.abs(flow - per_px).max()


def test_flow_levels_match_jax_on_hard_scenes(hard_levels, monkeypatch):
    """Each level of the port on the JAX level's inputs; the finest level's
    incoming flow takes the warp's tile offsets to its margin, and some
    level's relax samples past its hat window."""
    levels, _ = hard_levels
    window = []
    inner = relax_fast.sample_maps

    def sample_maps(w1_pad, dx, dy, D, *a, **k):
        reach = torch.maximum(dx.abs().max(), dy.abs().max())
        window.append(float(reach) > D - 1e-3)
        return inner(w1_pad, dx, dy, D, *a, **k)

    monkeypatch.setattr(relax_fast, "sample_maps", sample_maps)
    n_refine = n_coarsest = 0
    for imgs, alphas, flow, p, ref in levels:
        got = _port_level(imgs, alphas, flow, p)
        if flow is None:
            n_coarsest += 1
            d = _epe(got, ref)
            assert d.mean() <= 0.05, (imgs.shape, d.mean())
        else:
            n_refine += 1
            _check_refined(got, ref, imgs.shape)
    assert n_coarsest == 1 and n_refine == 15
    assert any(window)
    finest_in = levels[-1][2]
    assert np.abs(finest_in).max() > tk.WARP_MARGIN
    assert _warp_clamps(finest_in)[0] >= tk.WARP_MARGIN


def test_finest_level_matches_jax_past_the_warp_clamps(hard_levels):
    """The finest level's inputs with its incoming flow moved by 100 px in
    x, and 12 px more on the left half of the columns: tile offsets
    clamped at WARP_MAX_OFF, residuals past the margin on the left half
    and within it on much of the right; the port's level on those inputs
    against the JAX level's at the refining levels' gate."""
    levels, jax_level = hard_levels
    imgs, alphas, flow, p, _ = levels[-1]
    flow = flow.copy()
    flow[..., 0] += 100.0
    flow[:, :, :flow.shape[2] // 2, 0] += 12.0
    max_off, residual = _warp_clamps(flow)
    assert max_off == tk.WARP_MAX_OFF
    assert residual > tk.WARP_MARGIN
    ref = np.asarray(jax_level(jnp.asarray(imgs), jnp.asarray(alphas),
                               jnp.asarray(flow), ("left", "right"), p))
    _check_refined(_port_level(imgs, alphas, flow, p), ref, imgs.shape)


def test_stitch_pair_auto_matches_jax_on_hard_scenes():
    alg = "pixflow_low_fast"
    image_l, image_r = hard_canvases(128, 640, seed=3)
    ref = np.asarray(jpl.stitch_pair_auto(
        jnp.asarray(image_l), jnp.asarray(image_r),
        jcfg.StitchConfig(flow_alg=alg)))
    got = to_numpy(pipeline.stitch_pair_auto(
        image_l, image_r, StitchConfig(flow_alg=alg), device="cpu"))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[..., 3], ref[..., 3])
    s = ssim(got, ref)
    assert s >= 0.995, s
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert (diff > 8).mean() < 0.01, (diff > 8).mean()
