"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports no JAX, so it runs on a machine with a card and
no JAX:

    python -m pytest --noconftest tests/test_torch_card.py -q

Every test skips when torch.cuda.is_available() is false.  Tolerances as
in chip_smoke.py: median5 bit-exact (a median only selects); warp 2e-6 and
median5+diffuse 1e-5 (both kernels build with -fmad=false and keep the
plain version's tap order); relax, fused and unfused, 1e-5 on all but
< 1e-4 of the pixels, where a 1-ulp difference may flip a strict-<
candidate take.  A stitch on the card against the same stitch on the CPU
is held at the golden gate of tests/test_golden.py.
"""

import os

import numpy as np
import pytest
import torch

from panorama_opticalflow_tpu_torch import (StitchConfig,
                                            flow_params_by_name, ssim,
                                            synthesize_fisheye_set, to_numpy,
                                            to_torch)
from panorama_opticalflow_tpu_torch.models import pipeline
from panorama_opticalflow_tpu_torch.ops import image as im
from panorama_opticalflow_tpu_torch.ops import kernels as tk
from panorama_opticalflow_tpu_torch.utils.config import with_flow_params

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "six_96x320_s7.npz")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py runs these "
                    "checks at the headline shapes)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _smooth_flow(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx = 20 * np.sin(yy / 37.0) + 5 * np.cos(xx / 53.0)
    fy = 8 * np.cos(yy / 29.0) - 3 * np.sin(xx / 41.0)
    return np.stack([fx, fy], -1).astype(np.float32)


def test_warp_kernel_matches_plain(rng, cuda):
    h, w = 203, 517
    img = to_torch(rng.standard_normal((2, h, w, 2)).astype(np.float32),
                   cuda)
    flow = to_torch(np.stack([_smooth_flow(h, w), -_smooth_flow(h, w)]),
                    cuda)
    n = tk.warp_tiled.launches
    got = tk.warp_tiled(img, flow)
    torch.cuda.synchronize()
    assert tk.warp_tiled.launches == n + 1
    assert (got - tk.warp_tiled_plain(img, flow)).abs().max().item() <= 2e-6


@pytest.mark.parametrize("variant", ["one channel", "three channels",
                                     "unaligned"])
def test_warp_kernel_one_channel_a_block_matches_plain(rng, cuda, variant):
    """Other channel counts than two, and two channels at an address off
    an 8-byte boundary, take the kernel's one-channel-a-block form."""
    h, w = 203, 517
    c = {"one channel": 1, "three channels": 3, "unaligned": 2}[variant]
    buf = to_torch(rng.standard_normal(2 * h * w * c + 1).astype(np.float32),
                   cuda)
    img = buf[1:].view(2, h, w, c) if variant == "unaligned" \
        else buf[:-1].view(2, h, w, c)
    assert (img.data_ptr() % 8 == 4) == (variant == "unaligned")
    flow = to_torch(np.stack([_smooth_flow(h, w), -_smooth_flow(h, w)]),
                    cuda)
    got = tk.warp_tiled(img, flow)
    torch.cuda.synchronize()
    assert (got - tk.warp_tiled_plain(img, flow)).abs().max().item() <= 2e-6


def test_warp_kernel_takes_given_offsets(rng, cuda):
    h, w = 203, 517
    img = to_torch(rng.standard_normal((2, h, w, 2)).astype(np.float32),
                   cuda)
    flow = to_torch(np.stack([_smooth_flow(h, w), -_smooth_flow(h, w)]),
                    cuda)
    off = tk.warp_tile_offsets(flow)
    assert torch.equal(tk.warp_tiled(img, flow, off),
                       tk.warp_tiled(img, flow))
    with pytest.raises(ValueError, match="offsets"):
        tk.warp_tiled(img, flow, off[:, :1].contiguous())
    with pytest.raises(ValueError, match="offsets"):
        tk.warp_tiled(img, flow, off.float())


def test_median5_diffuse_kernel_matches_plain(rng, cuda):
    x = to_torch(rng.standard_normal((4, 45, 203)).astype(np.float32), cuda)
    c = to_torch(rng.random((2, 45, 203)).astype(np.float32), cuda)
    got = tk.median5_diffuse(x, c)
    torch.cuda.synchronize()
    assert (got - tk.median5_diffuse_plain(x, c)).abs().max().item() <= 1e-5
    # with c = 0 the output is the median alone: bit-exact cv::medianBlur
    zero = torch.zeros_like(c)
    assert torch.equal(tk.median5_diffuse(x, zero), im.median5(x))


def test_median5_kernel_matches_plain(rng, cuda):
    for shape in ((4, 45, 203), (2, 300, 517)):
        x = to_torch(rng.standard_normal(shape).astype(np.float32), cuda)
        n = tk.median5.launches
        got = tk.median5(x)
        torch.cuda.synchronize()
        assert tk.median5.launches == n + 1
        assert torch.equal(got, tk.median5_plain(x))


# planes smaller than one tile ((32, 128) for median5, (64, 128) for
# median5+diffuse), H or W of 1 to 4 (every tap clamped), one short of and
# one over a tile multiple, rows that do and do not start on 16 bytes, an
# odd number of plane pairs
_MEDIAN_SHAPES = [(2, 1, 1), (2, 2, 3), (2, 4, 1), (2, 3, 200), (2, 200, 2),
                  (2, 31, 127), (2, 33, 129), (2, 63, 255), (2, 65, 257),
                  (2, 64, 128), (6, 70, 260), (2, 129, 384)]


@pytest.mark.parametrize("shape", _MEDIAN_SHAPES)
def test_median_kernels_match_plain_at_ragged_shapes(rng, cuda, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    x[rng.random(shape) < 0.3] = 0.5            # ties
    x = to_torch(x, cuda)
    c = to_torch(rng.random((shape[0] // 2,) + shape[1:]).astype(np.float32),
                 cuda)
    med = tk.median5(x)
    torch.cuda.synchronize()
    assert torch.equal(med, tk.median5_plain(x))
    got = tk.median5_diffuse(x, c)
    torch.cuda.synchronize()
    assert (got - tk.median5_diffuse_plain(x, c)).abs().max().item() <= 1e-5
    # with c = 0 the fused kernel is the median alone, bit for bit
    assert torch.equal(tk.median5_diffuse(x, torch.zeros_like(c)), med)


@pytest.mark.parametrize("ksize", [3, 7, 13])
def test_median5_diffuse_kernel_other_built_widths(rng, cuda, ksize):
    x = to_torch(rng.standard_normal((2, 70, 203)).astype(np.float32), cuda)
    c = to_torch(rng.random((1, 70, 203)).astype(np.float32), cuda)
    got = tk.median5_diffuse(x, c, ksize, 2.0)
    torch.cuda.synchronize()
    ref = tk.median5_diffuse_plain(x, c, ksize, 2.0)
    assert (got - ref).abs().max().item() <= 1e-5


def test_median5_diffuse_kernel_refuses_a_width_that_is_not_built(rng, cuda):
    x = to_torch(rng.standard_normal((2, 40, 70)).astype(np.float32), cuda)
    c = to_torch(rng.random((1, 40, 70)).astype(np.float32), cuda)
    n = tk.median5_diffuse.launches
    for ksize in (1, 8, 17):
        with pytest.raises(ValueError, match="built"):
            tk.median5_diffuse(x, c, ksize)
    assert tk.median5_diffuse.launches == n


def _relax_planes(rng, cuda, shape, unfused):
    mk = lambda s=0.1: to_torch(
        rng.standard_normal(shape).astype(np.float32) * s, cuda)
    fx, fy = mk(0.5), mk(0.5)
    mask = to_torch((rng.random(shape) > 0.1).astype(np.float32), cuda)
    target = [mk(0.5), mk(0.5)] if unfused else []
    return [fx, fy, fx + mk(), fy + mk(), mk(), mk(), mk(), mk(),
            *target, mask]


@pytest.mark.parametrize("iters", [2, 3])
def test_relax_unfused_kernel_matches_plain(rng, cuda, iters):
    params = flow_params_by_name("pixflow_low")
    planes = _relax_planes(rng, cuda, (2, 150, 300), unfused=True)
    n = tk.relax_phase_unfused.launches
    got = torch.stack(tk.relax_phase_unfused(*planes, params, iters, 2))
    torch.cuda.synchronize()
    assert tk.relax_phase_unfused.launches == n + 1
    ref = torch.stack(tk.relax_phase_unfused_plain(*planes, params, iters,
                                                   2))
    diff = (got - ref).abs().amax(dim=0)
    assert (diff > 1e-5).float().mean().item() < 1e-4


def test_relax_kernels_refuse_a_window_above_shared_memory(rng, cuda,
                                                           monkeypatch):
    """A block's window takes most of an H100's 227 KB.  On a card that
    allows less (here the limit an A100 reports) both wrappers raise
    before launching and name the need and the limit; so they do beyond
    the 7 iterations the windows are built for."""
    from panorama_opticalflow_tpu_torch.ops import build

    params = flow_params_by_name("pixflow_low")
    fused = _relax_planes(rng, cuda, (1, 64, 64), unfused=False)
    unfused = _relax_planes(rng, cuda, (1, 64, 64), unfused=True)
    with pytest.raises(ValueError, match="no kernel is built"):
        tk.relax_phase(*fused, params, 8, 2)
    with pytest.raises(ValueError, match="no kernel is built"):
        tk.relax_phase_unfused(*unfused, params, 8, 2)
    monkeypatch.setattr(build.load(), "pano_smem_limit", lambda: 163 * 1024)
    with pytest.raises(ValueError, match="shared memory.*166912"):
        tk.relax_phase(*fused, params, 3, 2)
    with pytest.raises(ValueError, match="shared memory.*166912"):
        tk.relax_phase_unfused(*unfused, params, 3, 2)


def test_relax_kernel_matches_plain(rng, cuda):
    params = flow_params_by_name("pixflow_low_fast")
    mk = lambda s=0.1: to_torch(
        rng.standard_normal((2, 150, 300)).astype(np.float32) * s, cuda)
    fx, fy = mk(0.5), mk(0.5)
    mask = to_torch((rng.random((2, 150, 300)) > 0.1).astype(np.float32),
                    cuda)
    planes = [fx, fy, fx + mk(), fy + mk(), mk(), mk(), mk(), mk(), mask]
    got = torch.stack(tk.relax_phase(*planes, params, 3, 2))
    torch.cuda.synchronize()
    ref = torch.stack(tk.relax_phase_fused_plain(*planes, params, 3, 2))
    diff = (got - ref).abs().amax(dim=0)
    assert (diff > 1e-5).float().mean().item() < 1e-4


def test_wrappers_raise_on_what_the_kernels_do_not_take(rng, cuda):
    x = to_torch(rng.standard_normal((4, 40, 70)).astype(np.float32), cuda)
    c = to_torch(rng.random((2, 40, 70)).astype(np.float32), cuda)
    with pytest.raises(ValueError):     # not contiguous
        tk.median5_diffuse(x.transpose(1, 2).contiguous().transpose(1, 2), c)
    with pytest.raises(ValueError):     # planes on two devices
        tk.median5_diffuse(x, c.cpu())
    with pytest.raises(TypeError):
        tk.median5_diffuse(x.half(), c)


def test_stitch_six_on_card_meets_golden_gate(cuda):
    photos, top = synthesize_fisheye_set(96, 320, n=5, seed=7)
    out = to_numpy(pipeline.stitch_six(
        photos, top, StitchConfig(flow_alg="pixflow_low"), device=cuda))
    golden = np.load(GOLDEN)["output"]
    np.testing.assert_array_equal(out[..., 3], golden[..., 3])
    assert ssim(out, golden) >= 0.995
    diff = np.abs(out.astype(np.int32) - golden.astype(np.int32))
    assert (diff > 8).mean() < 0.01


def test_stitch_six_sched22_on_card_matches_cpu(cuda):
    """The 2-phase x 2-iteration schedule with every fast level on the
    kernels (pallas_min_pixels=0): the unfused relax kernel and median5
    launch, and the card's stitch meets the golden gate against the same
    stitch on the CPU."""
    photos, top = synthesize_fisheye_set(96, 320, n=5, seed=7)
    cfg = with_flow_params(StitchConfig(flow_alg="pixflow_low_fast"),
                           relax_phases=2, relax_iters_per_phase=2,
                           pallas_min_pixels=0)
    tk.reset_launch_counts()
    out = to_numpy(pipeline.stitch_six(photos, top, cfg, device=cuda))
    assert tk.relax_phase_unfused.launches > 0
    assert tk.median5.launches == tk.relax_phase_unfused.launches
    assert tk.relax_phase.launches == tk.median5_diffuse.launches == 0
    ref = to_numpy(pipeline.stitch_six(photos, top, cfg, device="cpu"))
    np.testing.assert_array_equal(out[..., 3], ref[..., 3])
    assert ssim(out, ref) >= 0.995
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert (diff > 8).mean() < 0.01
