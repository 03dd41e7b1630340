"""The port's ops and stitch geometry against the JAX package, both on the
CPU, on the same numpy inputs (mirrors test_image_ops.py,
test_stitcher.py and test_crop.py).

Tolerances:
  * integer / uint8 / selection ops (gray, threshold, median, distance
    fields, hole search, nearest samplers, crop plans): bit-exact;
  * f32 stencils (Gaussian, Sobel, warp, bilinear): <= 1e-6 -- same taps
    in the same order, only XLA's fused multiply-adds round differently;
  * resizes: <= 1e-5 -- the reference resamples planes with a banded
    matmul, the port with the same taps as a gather-sum;
  * box blur: <= 4e-6 -- a prefix-sum formulation whose rounding grows
    with the running sum, accumulated in another order than XLA's
    reduce-window rewrite; the blend field after its box blurs: <= 1e-4
    (running sums over up to ~1000 columns of values in [0, 1]).
The JAX side of the larger cases runs under jax.jit (one compile instead
of one per eager op).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from panorama_opticalflow_tpu.models import crop as jcrop
from panorama_opticalflow_tpu.models import stitcher as jst
from panorama_opticalflow_tpu.ops import distance as jd
from panorama_opticalflow_tpu.ops import image as jim
from panorama_opticalflow_tpu.ops import warp as jw
from panorama_opticalflow_tpu.utils import io as pio
from panorama_opticalflow_tpu.utils.config import StitchConfig
from panorama_opticalflow_tpu_torch import to_numpy, to_torch
from panorama_opticalflow_tpu_torch.models import crop as tcrop
from panorama_opticalflow_tpu_torch.models import stitcher as tst
from panorama_opticalflow_tpu_torch.ops import distance as td
from panorama_opticalflow_tpu_torch.ops import image as tim
from panorama_opticalflow_tpu_torch.ops import warp as tw

torch.set_num_threads(2)


def T(a):
    return to_torch(a, "cpu")


def _close(got, ref, atol):
    np.testing.assert_allclose(to_numpy(got), np.asarray(ref), atol=atol,
                               rtol=0)


def _equal(got, ref):
    np.testing.assert_array_equal(to_numpy(got), np.asarray(ref))


def _smooth_flow(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx = 20 * np.sin(yy / 37.0) + 5 * np.cos(xx / 53.0)
    fy = 8 * np.cos(yy / 29.0) - 3 * np.sin(xx / 41.0)
    return np.stack([fx, fy], -1).astype(np.float32)


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("inshape,outshape", [((40, 56), (20, 28)),
                                              ((31, 47), (28, 42)),
                                              ((24, 24), (27, 27))])
def test_resize_matches_jax(rng, method, inshape, outshape):
    img = rng.random(inshape, dtype=np.float32)
    _close(tim.resize(T(img), outshape, method),
           jim.resize(img, outshape, method), 1e-5)
    img3 = rng.random(inshape + (3,), dtype=np.float32)
    _close(tim.resize(T(img3), outshape, method),
           jim.resize(img3, outshape, method), 1e-5)


def test_resize_u8_bit_exact(rng):
    img = rng.integers(0, 256, (40, 60, 4), np.uint8)
    _equal(tim.resize_u8(T(img), (20, 30), "cubic"),
           jim.resize_u8(img, (20, 30), "cubic"))


@pytest.mark.parametrize("ksize,sigma", [(5, 0.25), (3, 0.5), (15, 8.0)])
def test_gaussian_blur_matches_jax(rng, ksize, sigma):
    img = rng.random((37, 45), dtype=np.float32)
    _close(tim.gaussian_blur(T(img), ksize, sigma),
           jim.gaussian_blur(img, ksize, sigma), 1e-6)
    # batched planes: the port filters the last two dims of (N, H, W)
    planes = rng.random((3, 20, 30), dtype=np.float32)
    ref = np.stack([np.asarray(jim.gaussian_blur(p, ksize, sigma))
                    for p in planes])
    _close(tim.gaussian_blur(T(planes), ksize, sigma), ref, 1e-6)


def test_sobel_median_box_match_jax(rng):
    img = rng.random((33, 41), dtype=np.float32)
    _close(tim.sobel_x(T(img)), jim.sobel_x(img), 1e-6)
    _close(tim.sobel_y(T(img)), jim.sobel_y(img), 1e-6)
    _equal(tim.median5(T(img)), jim.median5(img))
    for k in (3, 10):
        _close(tim.box_blur(T(img), k, k), jim.box_blur(img, k, k), 4e-6)


def test_gray_threshold_wrap_bit_exact(rng):
    img = rng.integers(0, 256, (25, 31, 4), np.uint8)
    _equal(tim.rgba_to_gray_u8(T(img)), jim.rgba_to_gray_u8(img))
    _equal(tim.threshold_binary(T(img[..., 0]), 140, 1),
           jim.threshold_binary(img[..., 0], 140, 1))
    _equal(tim.wrap_extend_x(T(img), 5), jim.wrap_extend_x(img, 5))
    _equal(tim.crop_x(tim.wrap_extend_x(T(img), 5), 5), img)


@pytest.mark.parametrize("step", [1, 3])
def test_eight_ray_distance_bit_exact(rng, step):
    mask = rng.random((17, 23)) < 0.08
    _equal(td.eight_ray_min_distance(T(mask), step, 11.0),
           jd.eight_ray_min_distance(mask, step, 11.0))
    _equal(td.eight_ray_min_distance(T(mask), step, 8.0, diag_scale=1.0),
           jd.eight_ray_min_distance(mask, step, 8.0, diag_scale=1.0))


@pytest.mark.parametrize("radius", [1, 2, 8, 100])
def test_two_class_hole_search_bit_exact(rng, radius):
    mask_l = rng.random((33, 41)) < 0.05
    mask_r = (rng.random((33, 41)) < 0.05) & ~mask_l
    got = td.two_class_hole_search(T(mask_l), T(mask_r), radius)
    ref = jd.two_class_hole_search(mask_l, mask_r, radius)
    for g, r in zip(got, ref):
        _equal(g, r)


def test_samplers_match_jax(rng):
    h, w = 300, 600
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    flow = _smooth_flow(h, w)
    t = rng.random((h, w)).astype(np.float32)
    _equal(tw.sample_nearest_wrap(T(img), T(flow), T(t)),
           jw.sample_nearest_wrap(img, flow, t))
    _equal(tw.sample_nearest_wrap_tiled(T(img), T(flow), T(t)),
           jw.sample_nearest_wrap_tiled(img, flow, t))
    _equal(tw.sample_nearest_wrap_tiled(T(img), T(flow), 0.5),
           jw.sample_nearest_wrap_tiled(img, flow, 0.5))
    g = rng.standard_normal((30, 40, 2)).astype(np.float32)
    cx = rng.random((30, 40)).astype(np.float32) * 45 - 3
    cy = rng.random((30, 40)).astype(np.float32) * 35 - 3
    _close(tw.bilinear_extend(T(g), T(cx), T(cy)),
           jw.bilinear_extend(g, cx, cy), 1e-6)


def _synthetic_pair(rng, h=24, w=40):
    l = rng.integers(0, 256, (h, w, 4), np.uint8)
    r = rng.integers(0, 256, (h, w, 4), np.uint8)
    l[..., 3] = 0
    r[..., 3] = 0
    l[:, : w * 5 // 8, 3] = 255
    r[:, w * 3 // 8:, 3] = 255
    return l, r


def test_match_extract_bit_exact(rng):
    l, r = _synthetic_pair(rng)
    m = tst.match_images(T(l), T(r))
    _equal(m, jst.match_images(l, r))
    _equal(tst.extract_overlap(T(l), m),
           jst.extract_overlap(l, to_numpy(m)))


_jax_blend = jax.jit(jst.generate_blend,
                     static_argnames=("cfg", "window", "scale"))
_jax_gather = jax.jit(jst.gather_composite, static_argnames=("cfg", "window"))


@pytest.mark.parametrize("h,w,scale", [(20, 40, 1), (272, 480, 1),
                                       (272, 480, 2)])
def test_generate_blend_matches_jax(rng, h, w, scale):
    """Full-canvas field, including the selective box blur (h >= 260)
    and the blend_scale=2 decimation with its grid drift."""
    l, r = _synthetic_pair(rng, h, w)
    m = np.asarray(jst.match_images(l, r))
    cfg = StitchConfig()
    jb, jm = _jax_blend(jnp.asarray(m), cfg, scale=scale)
    tb, tm = tst.generate_blend(T(m), cfg, scale=scale)
    _close(tb, jb, 1e-4 if h >= 260 else 1e-5)
    _close(tm, jm, 1e-4)


@pytest.mark.parametrize("l0,l1,r0,r1", [(200, 560, 480, 840),
                                         (880, 216, 960, 300)])
def test_windowed_blend_matches_jax(l0, l1, r0, r1):
    """Window inside the canvas and window across the x=0 seam."""
    h, w = 64, 1024
    cfg = StitchConfig()

    def canvas(x0, x1):
        a = np.zeros((h, w, 4), np.uint8)
        a[:, np.arange(x0, x0 + (x1 - x0) % w) % w, 3] = 255
        return a

    m = np.asarray(jst.match_images(canvas(l0, l1), canvas(r0, r1)))
    roll, width, gsafe = tcrop.pair_window(T(m), cfg)
    assert (roll, width, gsafe) == jcrop.pair_window(jnp.asarray(m), cfg)
    assert width < w
    for scale in (1, 2):
        jb, _ = _jax_blend(jnp.asarray(m), cfg, window=(roll, width),
                           scale=scale)
        tb, _ = tst.generate_blend(T(m), cfg, window=(roll, width),
                                   scale=scale)
        _close(tb, jb, 1e-5)


def test_gather_composite_bit_exact(rng):
    l, r = _synthetic_pair(rng, h=18, w=32)
    m = np.asarray(jst.match_images(l, r))
    merged = rng.integers(0, 256, l.shape, np.uint8)
    merged[..., 3] = 0
    merged[4:14, 12:16, 3] = 255
    cfg = StitchConfig()
    _equal(tst.gather_composite(T(m), T(l), T(r), T(merged), cfg),
           _jax_gather(m, l, r, merged, cfg))


def test_windowed_gather_bit_exact(rng):
    h, w = 48, 1024
    cfg = StitchConfig()
    il = np.zeros((h, w, 4), np.uint8)
    ir = np.zeros((h, w, 4), np.uint8)
    il[:, 200:560] = rng.integers(1, 255, (h, 360, 4), np.uint8)
    ir[:, 480:840] = rng.integers(1, 255, (h, 360, 4), np.uint8)
    il[:, 200:560, 3] = 255
    ir[:, 480:840, 3] = 255
    cmap = np.asarray(jst.match_images(il, ir))
    merged = np.zeros((h, w, 4), np.uint8)
    merged[:, 480:560] = 128
    merged[::3, 500:520, 3] = 0
    roll, width, gsafe = tcrop.pair_window(T(cmap), cfg)
    assert gsafe
    ref = _jax_gather(cmap, il, ir, merged, cfg, window=(roll, width))
    got = tst.gather_composite(T(cmap), T(il), T(ir), T(merged), cfg,
                               window=(roll, width))
    _equal(got, ref)
    _equal(got, _jax_gather(cmap, il, ir, merged, cfg))


def test_crop_plans_match_jax():
    cols = np.zeros(100, bool)
    cols[90:] = True
    cols[:10] = True
    assert tcrop.circular_interval(cols, 3) == jcrop.circular_interval(
        cols, 3)
    assert tcrop.circular_interval(np.zeros(10, bool), 1) is None
    for n in (1, 300, 511, 513, 5000):
        assert tcrop.choose_bucket(n, 4096) == jcrop.choose_bucket(n, 4096)
    w = 1024
    cols = np.zeros(w, bool)
    cols[10:60] = True
    assert tcrop.gather_window_safe(cols, 900, 512, 100) == \
        jcrop.gather_window_safe(cols, 900, 512, 100)


@pytest.mark.parametrize("h,w,alg", [(64, 256, "pixflow_low"),
                                     (48, 1280, "pixflow_low_fast")])
def test_plan_chain_windows_match_jax(h, w, alg):
    photos, top = pio.synthesize_fisheye_set(h, w, n=5, seed=0)
    cfg = StitchConfig(flow_alg=alg)
    ref = jcrop.plan_chain_windows([jnp.asarray(p) for p in photos],
                                   jnp.asarray(top), cfg)
    got = tcrop.plan_chain_windows([T(p) for p in photos], T(top), cfg)
    assert got == ref


def test_headline_windows_match_jax():
    """The 9000 x 4000 headline plan from its per-pair overlap columns
    (the footprints of synthesize_fisheye_set: the top cap spans every
    column, so pair i overlaps exactly photo i's band): every pair gets a
    4000 x 3584 window, rolls 8100 ... 6300, and pairs 1 and 5 run the
    full-canvas hole search."""
    h, w, n = 4000, 9000, 5
    band, halo = w / n, w / n * 0.35
    cfg = StitchConfig(flow_alg="pixflow_low_fast")
    step = tcrop.blend_step(h, w, cfg)
    assert step == jcrop.blend_step(h, w, cfg) == 20
    got = []
    for i in range(n):
        cols = (np.arange(w) - (i * band - halo / 2)) % w < band + halo
        roll, width = tcrop._window_from_cols(cols, cfg, 64, step)
        assert (roll, width) == jcrop._window_from_cols(cols, cfg, 64, step)
        safe = tcrop.gather_window_safe(cols, roll, width, 100)
        assert safe == jcrop.gather_window_safe(cols, roll, width, 100)
        got.append((roll, width, safe))
    assert got == [(8100, 3584, False), (900, 3584, True),
                   (2700, 3584, True), (4500, 3584, True),
                   (6300, 3584, False)]
