"""The port's 4-input single-pass stitch and the small ops that complete
its op layer, on the CPU against the JAX package on the same numpy inputs.

Tolerances:
  * saturating add, column pre-crop, compose_four, crop_window, the
    bounded first-hit fields: bit-exact (integer and selection ops; the
    distance fields hold small integers);
  * low-alpha diffusion <= 1e-5, the JAX test's own tolerance;
  * stitch_four against JAX's and against the pinned golden at the gate
    of tests/test_golden.py (alpha footprint exact, SSIM >= 0.995, < 1 %
    of values off by more than 8).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from panorama_opticalflow_tpu.models import crop as jcrop
from panorama_opticalflow_tpu.models import pipeline as jpl
from panorama_opticalflow_tpu.models import pixflow as jpf
from panorama_opticalflow_tpu.models import stitcher as jst
from panorama_opticalflow_tpu.ops import distance as jd
from panorama_opticalflow_tpu.ops import image as jim
from panorama_opticalflow_tpu.utils import config as jcfg
from panorama_opticalflow_tpu_torch import (StitchConfig,
                                            flow_params_by_name, ssim,
                                            synthesize_four_input_set,
                                            to_numpy, to_torch)
from panorama_opticalflow_tpu_torch.models import crop, pipeline, pixflow
from panorama_opticalflow_tpu_torch.models import stitcher
from panorama_opticalflow_tpu_torch.ops import distance as td
from panorama_opticalflow_tpu_torch.ops import image as tim
from panorama_opticalflow_tpu_torch.utils import runtime

torch.set_num_threads(2)
runtime.settle_cpu_math()

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")


def T(a):
    return to_torch(a, "cpu")


def _gate(out, golden):
    assert out.shape == golden.shape
    np.testing.assert_array_equal(out[..., 3], golden[..., 3])
    s = ssim(out, golden)
    assert s >= 0.995, s
    diff = np.abs(out.astype(np.int32) - golden.astype(np.int32))
    assert (diff > 8).mean() < 0.01, (diff > 8).mean()


def test_saturating_add_u8_matches_jax(rng):
    a = rng.integers(0, 256, (31, 47, 4), dtype=np.uint8)
    b = rng.integers(0, 256, (31, 47, 4), dtype=np.uint8)
    got = tim.saturating_add_u8(T(a), T(b))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        to_numpy(got), np.asarray(jim.saturating_add_u8(jnp.asarray(a),
                                                        jnp.asarray(b))))
    assert (to_numpy(got) == np.minimum(a.astype(int) + b, 255)).all()


def test_precrop_columns_matches_jax(rng):
    img = rng.integers(1, 256, (20, 33, 4), dtype=np.uint8)
    img[10, rng.random(33) < 0.4, 3] = 0     # middle-row alpha decides
    img[3, :, 3] = 0                         # another row's does not
    got = to_numpy(pipeline.precrop_columns(T(img)))
    np.testing.assert_array_equal(
        got, np.asarray(jpl.precrop_columns(jnp.asarray(img))))
    assert (got[:, img[10, :, 3] == 0] == 0).all()


@pytest.mark.parametrize("seed", [0, 3])
def test_compose_four_matches_jax(seed):
    photos = synthesize_four_input_set(40, 96, seed=seed)
    ref_l, ref_r = jpl.compose_four(jnp.stack([jnp.asarray(p)
                                               for p in photos]))
    for images in ([T(p) for p in photos], T(np.stack(photos))):
        got_l, got_r = pipeline.compose_four(images)
        np.testing.assert_array_equal(to_numpy(got_l), np.asarray(ref_l))
        np.testing.assert_array_equal(to_numpy(got_r), np.asarray(ref_r))


def _band_map(h, w, l_cols, r_cols):
    m = np.zeros((h, w), np.uint8)
    m[:, l_cols] += 100
    m[:, r_cols] += 50
    return m


@pytest.mark.parametrize("case", ["inside", "across the seam", "none"])
def test_crop_window_matches_jax(case):
    """Three canvas maps: an overlap band inside the canvas, one that
    crosses the x = 0 seam, and no overlap at all."""
    h, w = 64, 2048
    x = np.arange(w)
    m = {"inside": _band_map(h, w, x < 700, (x > 600) & (x < 1500)),
         "across the seam": _band_map(h, w, (x < 300) | (x > 1900),
                                      (x > 200) & (x < 2000)),
         "none": _band_map(h, w, x < 500, (x > 900) & (x < 1300))}[case]
    cfg = StitchConfig(flow_alg="pixflow_low_fast")
    jc = jcfg.StitchConfig(flow_alg="pixflow_low_fast")
    got = crop.crop_window(T(m), cfg)
    assert got == jcrop.crop_window(m, jc)
    assert got == crop.pair_window(T(m), cfg)[:2]
    assert got[1] < w


@pytest.mark.parametrize("radius", [1, 2, 8, 100])
def test_eight_ray_unit_min_distance_matches_jax(rng, radius):
    """Equal to the JAX package's field, and, as its test_stitcher.py
    holds, to the unit-stride scan field and the oracle of the two-class
    hole search."""
    mask = rng.random((33, 41)) < 0.06
    got = to_numpy(td.eight_ray_unit_min_distance(T(mask), radius))
    np.testing.assert_array_equal(
        got, np.asarray(jd.eight_ray_unit_min_distance(mask, radius)))
    np.testing.assert_array_equal(got, to_numpy(td.eight_ray_min_distance(
        T(mask), 1, float(radius), diag_scale=1.0)))

    mask_r = (rng.random((33, 41)) < 0.05) & ~mask
    d_r = to_numpy(td.eight_ray_unit_min_distance(T(mask_r), radius))
    found, take_l = (to_numpy(a) for a in td.two_class_hole_search(
        T(mask), T(mask_r), radius))
    np.testing.assert_array_equal(found, np.isfinite(np.minimum(got, d_r)))
    np.testing.assert_array_equal(take_l[found], (got <= d_r)[found])


@pytest.mark.parametrize("dy,dx", [(0, 1), (-1, 0), (1, -1)])
def test_bounded_first_hit_matches_jax(rng, dy, dx):
    mask = rng.random((20, 27)) < 0.08
    np.testing.assert_array_equal(
        to_numpy(td.bounded_first_hit(T(mask), 6, dy, dx)),
        np.asarray(jd.bounded_first_hit(jnp.asarray(mask), 6, dy, dx)))


def test_two_class_hole_search_on_a_stack_matches_each_alone(rng):
    ml = rng.random((3, 33, 41)) < 0.05
    mr = (rng.random((3, 33, 41)) < 0.05) & ~ml
    found, take_l = td.two_class_hole_search(T(ml), T(mr), 8)
    for k in range(3):
        f, t = td.two_class_hole_search(T(ml[k]), T(mr[k]), 8)
        assert torch.equal(found[k], f) and torch.equal(take_l[k], t)


def test_low_alpha_flow_diffusion_matches_jax(rng):
    params = flow_params_by_name("pixflow_low")
    flow = rng.standard_normal((40, 56, 2)).astype(np.float32) * 3
    a0 = rng.random((40, 56)).astype(np.float32)
    a1 = rng.random((40, 56)).astype(np.float32)
    ref = np.asarray(jpf.low_alpha_flow_diffusion(
        jnp.asarray(flow), jnp.asarray(a0), jnp.asarray(a1),
        jcfg.flow_params_by_name("pixflow_low")))
    got = to_numpy(pixflow.low_alpha_flow_diffusion(T(flow), T(a0), T(a1),
                                                    params))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    # opaque pixels keep their flow
    one = np.ones_like(a0)
    np.testing.assert_array_equal(to_numpy(pixflow.low_alpha_flow_diffusion(
        T(flow), T(one), T(one), params)), flow)


def test_prepare_matches_jax():
    photos = synthesize_four_input_set(96, 320, seed=1)
    image_l, image_r = pipeline.compose_four([T(p) for p in photos])
    ctx = stitcher.prepare(image_l, image_r, StitchConfig())
    ref = jst.prepare(jnp.asarray(to_numpy(image_l)),
                      jnp.asarray(to_numpy(image_r)), jcfg.StitchConfig())
    assert ctx._fields == ref._fields
    for name in ("map", "overlapped_l", "overlapped_r"):
        np.testing.assert_array_equal(to_numpy(getattr(ctx, name)),
                                      np.asarray(getattr(ref, name)))
    np.testing.assert_allclose(to_numpy(ctx.blend), np.asarray(ref.blend),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(to_numpy(ctx.merged_dis),
                               np.asarray(ref.merged_dis), atol=1e-4, rtol=0)


@pytest.mark.parametrize("alg", ["pixflow_low", "pixflow_low_fast"])
def test_stitch_four_matches_jax(alg):
    photos = synthesize_four_input_set(96, 320, seed=1)
    ref = np.asarray(jpl.stitch_four([jnp.asarray(p) for p in photos],
                                     jcfg.StitchConfig(flow_alg=alg)))
    got = to_numpy(pipeline.stitch_four(photos, StitchConfig(flow_alg=alg),
                                        device="cpu"))
    _gate(got, ref)


def test_stitch_four_matches_pinned_golden():
    photos = synthesize_four_input_set(96, 320, seed=1)
    golden = np.load(os.path.join(GOLDEN_DIR,
                                  "four_96x320_s1.npz"))["output"]
    cfg = StitchConfig(flow_alg="pixflow_low")
    got = to_numpy(pipeline.stitch_four(photos, cfg, device="cpu"))
    _gate(got, golden)
    # the footprint is the union of the pre-cropped inputs'
    image_l, image_r = pipeline.compose_four([T(p) for p in photos])
    union = (image_l[..., 3] > 0) | (image_r[..., 3] > 0)
    np.testing.assert_array_equal(got[..., 3] > 0, to_numpy(union))


def test_stitch_four_window_is_the_whole_canvas():
    """The two composed canvases overlap at four seams around the circle,
    so the window crop.pair_window derives is the whole canvas however wide
    it is; stitch_four then computes what use_crop=False computes."""
    photos = synthesize_four_input_set(64, 1280, seed=2)
    cfg = StitchConfig(flow_alg="pixflow_low_fast")
    image_l, image_r = pipeline.compose_four([T(p) for p in photos])
    cmap = stitcher.match_images(image_l, image_r)
    assert crop.pair_window(cmap, cfg) == (0, 1280, False)
    got = to_numpy(pipeline.stitch_four(photos, cfg, device="cpu"))
    np.testing.assert_array_equal(got, to_numpy(pipeline.stitch_four(
        photos, cfg, device="cpu", use_crop=False)))
    np.testing.assert_array_equal(got[..., 3] > 0,
                                  to_numpy((cmap > 0)))


def test_entry_points_default_to_the_card():
    """Without a device the new entry points go to ``cuda`` and raise
    where there is none, rather than carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default device works")
    photos = synthesize_four_input_set(24, 64, seed=0)
    cfg = StitchConfig(flow_alg="pixflow_low_fast")
    stack = np.stack(photos[:2])
    for call in (lambda: pipeline.stitch_four(photos, cfg),
                 lambda: pipeline.stitch_pairs(stack, stack, cfg),
                 lambda: pipeline.stitch_pair_debug(photos[0], photos[1],
                                                    cfg)):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
