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
is held at the golden gate of tests/test_golden.py, a batched stitch on
the card too; against the card's own sequential stitch it is held at the
gate of tests/test_batching.py (more than 0.98 of the bytes equal, 99.9th
percentile of the absolute difference <= 8).  The widened contract of
the kernels (iteration counts, hat windows and blur widths beyond the
unrolled ones) is held against the plain versions at the relax gate of
the CPU's production tests (1e-5 on all but <= 5e-4 of the pixels: flipped
takes grow with the iterations).  The row-tiled stitch on the card is held
against the untiled stitch at the gates of tests/test_tiled.py, and as a
program against its eager run byte for byte.
"""

import os

import numpy as np
import pytest
import torch

from panorama_opticalflow_tpu_torch import (StitchConfig,
                                            flow_params_by_name, ssim,
                                            synthesize_fisheye_set,
                                            synthesize_four_input_set,
                                            to_numpy, to_torch)
from panorama_opticalflow_tpu_torch.models import crop, pipeline
from panorama_opticalflow_tpu_torch.ops import image as im
from panorama_opticalflow_tpu_torch.ops import kernels as tk
from panorama_opticalflow_tpu_torch.utils import programs, trace
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
    """Beyond the widest blur whose window fits a block's shared memory the
    wrapper raises and names the widest this card takes (73 on an H100)."""
    x = to_torch(rng.standard_normal((2, 40, 70)).astype(np.float32), cuda)
    c = to_torch(rng.random((1, 40, 70)).astype(np.float32), cuda)
    n = tk.median5_diffuse.launches
    for ksize in (75, 81, 200):
        with pytest.raises(ValueError, match="takes at most 73"):
            tk.median5_diffuse(x, c, ksize)
    with pytest.raises(ValueError, match="ksize"):
        tk.median5_diffuse(x, c, 0)
    assert tk.median5_diffuse.launches == n


@pytest.mark.parametrize("ksize", [1, 4, 17, 21, 31, 73])
def test_median5_diffuse_kernel_run_time_widths(rng, cuda, ksize):
    """Widths the kernel does not unroll run its run-time instance."""
    x = to_torch(rng.standard_normal((4, 70, 203)).astype(np.float32), cuda)
    c = to_torch(rng.random((2, 70, 203)).astype(np.float32), cuda)
    n = tk.median5_diffuse.launches
    got = tk.median5_diffuse(x, c, ksize, 8.0)
    torch.cuda.synchronize()
    assert tk.median5_diffuse.launches == n + 1
    ref = tk.median5_diffuse_plain(x, c, ksize, 8.0)
    assert (got - ref).abs().max().item() <= 1e-5


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
    """A block's window takes most of an H100's 227 KB.  Beyond the most
    iterations whose window fits (14 at D = 2), and on a card that allows
    less (here the limit an A100 reports), both wrappers raise before
    launching and name the need, the limit and the most iterations the
    card takes."""
    from panorama_opticalflow_tpu_torch.ops import build

    params = flow_params_by_name("pixflow_low")
    fused = _relax_planes(rng, cuda, (1, 64, 64), unfused=False)
    unfused = _relax_planes(rng, cuda, (1, 64, 64), unfused=True)
    with pytest.raises(ValueError, match="at D=2.*takes at most 14"):
        tk.relax_phase(*fused, params, 15, 2)
    with pytest.raises(ValueError, match="at D=2.*takes at most 14"):
        tk.relax_phase_unfused(*unfused, params, 15, 2)
    monkeypatch.setattr(build.load(), "pano_smem_limit", lambda: 163 * 1024)
    with pytest.raises(ValueError, match="shared memory.*166912"):
        tk.relax_phase(*fused, params, 3, 2)
    with pytest.raises(ValueError, match="shared memory.*166912"):
        tk.relax_phase_unfused(*unfused, params, 3, 2)


@pytest.mark.parametrize("iters,D", [(10, 2), (14, 2), (1, 1), (3, 4),
                                     (9, 3)])
@pytest.mark.parametrize("unfused", [False, True])
def test_relax_kernels_widened_contract_match_plain(rng, cuda, iters, D,
                                                    unfused):
    """Iteration counts and hat windows beyond the unrolled instances run
    the run-time instance (and (1, 1), (9, 3) the edges of both)."""
    params = flow_params_by_name("pixflow_low_fast")
    planes = _relax_planes(rng, cuda, (2, 150, 300), unfused=unfused)
    kernel = tk.relax_phase_unfused if unfused else tk.relax_phase
    plain = (tk.relax_phase_unfused_plain if unfused
             else tk.relax_phase_fused_plain)
    n = kernel.launches
    got = torch.stack(kernel(*planes, params, iters, D))
    torch.cuda.synchronize()
    assert kernel.launches == n + 1
    ref = torch.stack(plain(*planes, params, iters, D))
    diff = (got - ref).abs().amax(dim=0)
    assert (diff > 1e-5).float().mean().item() <= 5e-4


def test_box_blur_of_a_stack_equals_each_plane_alone(rng, cuda):
    """On the card a plane's running sums do not depend on the stack it
    sits in: a stack of 8 blurs to each plane's own bits."""
    x = to_torch(rng.random((8, 500, 1237)).astype(np.float32), cuda)
    for k in (7, 13, 2):
        got = im.box_blur(x, k, k)
        for p in range(8):
            assert torch.equal(got[p], im.box_blur(x[p], k, k))


def test_tiled_stitch_on_card_matches_untiled(cuda):
    """The in-process row-tiled stitch (n = 4) against the untiled stitch on
    the card, at tests/test_tiled.py's gates, with the fused-path kernels
    launched on the tile stacks."""
    from panorama_opticalflow_tpu_torch.parallel import tiled

    photos = synthesize_four_input_set(400, 900, seed=2)
    il, ir = pipeline.compose_four([to_torch(p, cuda) for p in photos])
    cfg = with_flow_params(StitchConfig(flow_alg="pixflow_low"),
                           pallas_min_pixels=0)
    ref = to_numpy(pipeline.stitch_pair(il, ir, cfg))
    tk.reset_launch_counts()
    out = to_numpy(tiled.tiled_stitch_pair(
        il, ir, cfg, 4, tc=tiled.TileConfig(min_tiled_rows=16,
                                            level_halo=32)))
    for k in (tk.warp_tiled, tk.relax_phase, tk.median5_diffuse):
        assert k.launches > 0, k.__name__
    inner = np.s_[16:-16]
    assert ssim(out[inner], ref[inner]) >= 0.995
    assert (out[inner] == ref[inner]).mean() > 0.97


def test_tiled_stitch_default_device_is_the_card(cuda):
    from panorama_opticalflow_tpu_torch.parallel import tiled

    photos = synthesize_four_input_set(96, 320, seed=1)
    il, ir = pipeline.compose_four([to_torch(p, "cpu") for p in photos])
    out = tiled.tiled_stitch_pair_auto(
        il, ir, StitchConfig(), 4, tc=tiled.TileConfig(8, 24))
    assert out.is_cuda and out.shape == (96, 320, 4)


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


# ---------------------------------------------------------------------------
# batched stitching: a leading 16 directions (medians: 32 planes), and the
# 4-input stitch
# ---------------------------------------------------------------------------


def test_fused_path_kernels_match_plain_with_a_leading_16(rng, cuda):
    """The three kernels of the fused level at a ragged shape with the
    leading batch of 8 pairs in flight: every direction against its plain
    version, and equal to the same direction launched alone (a plane's
    coefficient, mask and tile offsets are its own)."""
    nb, h, w = 16, 77, 205
    params = flow_params_by_name("pixflow_low")
    img = to_torch(rng.standard_normal((nb, h, w, 2)).astype(np.float32),
                   cuda)
    flow = to_torch(np.stack([_smooth_flow(h, w) * (1 + 0.1 * b)
                              for b in range(nb)]), cuda)
    got = tk.warp_tiled(img, flow)
    torch.cuda.synchronize()
    assert (got - tk.warp_tiled_plain(img, flow)).abs().max().item() <= 2e-6
    assert torch.equal(got[11], tk.warp_tiled(img[11:12].contiguous(),
                                              flow[11:12].contiguous())[0])

    x = to_torch(rng.standard_normal((2 * nb, h, w)).astype(np.float32),
                 cuda)
    c = to_torch(rng.random((nb, h, w)).astype(np.float32), cuda)
    got = tk.median5_diffuse(x, c)
    torch.cuda.synchronize()
    assert (got - tk.median5_diffuse_plain(x, c)).abs().max().item() <= 1e-5
    assert torch.equal(got[22:24], tk.median5_diffuse(
        x[22:24].contiguous(), c[11:12].contiguous()))
    assert torch.equal(tk.median5(x), tk.median5_plain(x))

    planes = _relax_planes(rng, cuda, (nb, h, w), unfused=False)
    got = torch.stack(tk.relax_phase(*planes, params, 3, 2))
    torch.cuda.synchronize()
    ref = torch.stack(tk.relax_phase_fused_plain(*planes, params, 3, 2))
    diff = (got - ref).abs().amax(dim=0)
    assert (diff > 1e-5).float().mean().item() < 1e-4
    alone = torch.stack(tk.relax_phase(
        *(p[11:12].contiguous() for p in planes), params, 3, 2))
    assert torch.equal(got[:, 11:12], alone)


def _golden_gate(out, ref):
    np.testing.assert_array_equal(out[..., 3], ref[..., 3])
    assert ssim(out, ref) >= 0.995
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert (diff > 8).mean() < 0.01


def test_stitch_four_on_card_meets_golden_gate(cuda):
    photos = synthesize_four_input_set(96, 320, seed=1)
    out = to_numpy(pipeline.stitch_four(
        photos, StitchConfig(flow_alg="pixflow_low"), device=cuda))
    golden = np.load(os.path.join(os.path.dirname(GOLDEN),
                                  "four_96x320_s1.npz"))["output"]
    _golden_gate(out, golden)


def test_stitch_four_default_device_is_the_card(cuda):
    photos = synthesize_four_input_set(48, 160, seed=1)
    cfg = StitchConfig(flow_alg="pixflow_low_fast")
    out = pipeline.stitch_four(photos, cfg)
    assert out.is_cuda
    out, inter = pipeline.stitch_pair_debug(photos[0], photos[1], cfg)
    assert out.is_cuda and all(v.is_cuda for v in inter.values())
    stack = np.stack(photos[:2])
    assert pipeline.stitch_pairs(stack, stack[::-1].copy(), cfg).is_cuda


def test_stitch_pairs_on_card_matches_cpu(cuda):
    """Three pairs at 96 x 320 with every fast level on the kernels
    (pallas_min_pixels=0): the batched stitch on the card launches each
    kernel as often as one pair would and meets the batching gate against
    the card's own sequential stitch.  Against the batched stitch on the
    CPU it is held at the golden gate, like every stitch on the card
    against the CPU: kernels and plain versions differ by flipped takes."""
    cfg = with_flow_params(StitchConfig(flow_alg="pixflow_low_fast"),
                           pallas_min_pixels=0)
    pairs = [pipeline.compose_four(
        [to_torch(p, "cpu") for p in synthesize_four_input_set(96, 320,
                                                               seed=k)])
        for k in (1, 2, 3)]
    ls = torch.stack([p[0] for p in pairs])
    rs = torch.stack([p[1] for p in pairs])
    tk.reset_launch_counts()
    one = to_numpy(pipeline.stitch_pair(ls[0].to(cuda), rs[0].to(cuda), cfg))
    per_pair = {k.__name__: k.launches for k in tk.KERNELS}
    assert per_pair["relax_phase"] == per_pair["median5_diffuse"] > 0
    tk.reset_launch_counts()
    out = to_numpy(pipeline.stitch_pairs(ls, rs, cfg, device=cuda))
    assert {k.__name__: k.launches for k in tk.KERNELS} == per_pair
    assert (out[0] == one).mean() > 0.98
    diff = np.abs(out[0].astype(int) - one.astype(int))
    assert np.percentile(diff, 99.9) <= 8
    ref = to_numpy(pipeline.stitch_pairs(ls, rs, cfg, device="cpu"))
    for got, want in zip(out, ref):
        _golden_gate(got, want)


# ---------------------------------------------------------------------------
# captured programs (utils/programs.py): a replay gives the eager run's
# bytes and launches, owns nothing the caller holds, and never falls back
# ---------------------------------------------------------------------------


def _eager_then_thrice(run):
    """``run()`` under programs.disable(), then three times as a program
    (its key's eager first call, the capture and its replay, a later
    replay)."""
    programs.clear()
    with programs.disable():
        eager = run()
    return eager, run(), run(), run()


def test_program_replays_give_the_eager_bytes(cuda):
    """A chain on narrower windows than its canvas (64 x 1280: 768-wide),
    stitch_four and stitch_pairs at N = 2: every byte of every replay equals
    the eager run's."""
    photos, top = synthesize_fisheye_set(64, 1280, n=5, seed=0)
    fast = StitchConfig(flow_alg="pixflow_low_fast")
    four = synthesize_four_input_set(96, 320, seed=1)
    low = StitchConfig(flow_alg="pixflow_low")
    stack = np.stack(four[:2])
    runs = {
        "chain": lambda: pipeline.stitch_six(photos, top, fast, device=cuda),
        "stitch_four": lambda: pipeline.stitch_four(four, low, device=cuda),
        "stitch_pairs": lambda: pipeline.stitch_pairs(
            stack, stack[::-1].copy(), low, device=cuda)}
    for name, run in runs.items():
        eager, *calls = _eager_then_thrice(run)
        assert len(programs.keys()) == 1, name
        assert programs.info()[0]["replays"] == 2, name
        for call in calls:
            assert torch.equal(call, eager), name
    programs.clear()


def test_tiled_program_replays_give_the_eager_bytes(cuda):
    """The in-process row-tiled stitch (n = 4, finest flow level tiled, the
    kernels on the tile stacks) as a program: every replay of the full
    canvas's key, and every call at two rolls of one window width (one
    program), equals its programs.disable() run byte for byte."""
    from panorama_opticalflow_tpu_torch.parallel import tiled

    photos = synthesize_four_input_set(256, 320, seed=1)
    il, ir = pipeline.compose_four([to_torch(p, cuda) for p in photos])
    cfg = with_flow_params(StitchConfig(flow_alg="pixflow_low"),
                           pallas_min_pixels=0)
    tc = tiled.TileConfig(8, 24)
    eager, *calls = _eager_then_thrice(
        lambda: tiled.tiled_stitch_pair(il, ir, cfg, 4, tc=tc))
    assert len(programs.keys()) == 1
    assert programs.info()[0]["replays"] == 2
    assert programs.info()[0]["launches_a_replay"]["relax_phase"] > 0
    for call in calls:
        assert torch.equal(call, eager)
    programs.clear()
    for roll in (32, 96, 32, 96):
        got = tiled.tiled_stitch_pair(il, ir, cfg, 4, tc=tc,
                                      window=(roll, 256, True))
        with programs.disable():
            want = tiled.tiled_stitch_pair(il, ir, cfg, 4, tc=tc,
                                           window=(roll, 256, True))
        assert torch.equal(got, want), roll
    assert len(programs.keys()) == 1
    assert programs.info()[0]["replays"] == 3
    programs.clear()


def test_program_results_are_the_callers(cuda):
    """Two pairs through one program: the first result stays as it was
    after the second replay, and each equals its eager run."""
    cfg = StitchConfig(flow_alg="pixflow_low_fast")
    pairs = [pipeline.compose_four([to_torch(p, cuda) for p in
                                    synthesize_four_input_set(96, 320,
                                                              seed=k)])
             for k in (1, 2)]
    programs.clear()
    pipeline.stitch_pair(*pairs[1], cfg)       # the key's eager call
    first = pipeline.stitch_pair(*pairs[0], cfg)
    kept = first.clone()
    second = pipeline.stitch_pair(*pairs[1], cfg)
    assert len(programs.keys()) == 1
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)
    with programs.disable():
        assert torch.equal(first, pipeline.stitch_pair(*pairs[0], cfg))
        assert torch.equal(second, pipeline.stitch_pair(*pairs[1], cfg))
    programs.clear()


def test_one_program_serves_every_roll_of_a_width(cuda):
    """The roll is the windowed program's input: one pair at three rolls
    of one 768-wide window is one program, and each result is its eager
    run's, byte for byte."""
    photos, top = synthesize_fisheye_set(64, 1280, n=5, seed=0)
    cfg = StitchConfig(flow_alg="pixflow_low_fast")
    image_l, image_r = to_torch(photos[1], cuda), to_torch(top, cuda)
    roll, width, _ = crop.plan_chain_windows(
        [to_torch(p, cuda) for p in photos], image_r, cfg)[1]
    assert width < 1280
    programs.clear()
    for r in (roll, roll + 64, roll, roll - 64):
        got = pipeline.stitch_pair_windowed(image_l, image_r, r % 1280,
                                            width, False, cfg)
        with programs.disable():
            want = pipeline.stitch_pair_windowed(image_l, image_r, r % 1280,
                                                 width, False, cfg)
        assert torch.equal(got, want), r
    assert len(programs.keys()) == 1
    assert programs.info()[0]["replays"] == 3
    programs.clear()


def test_program_with_a_host_read_raises_at_capture(cuda):
    ran = []

    def reads_the_host(x):
        ran.append(1)
        return x * x.sum().item()

    x = torch.ones(8, device=cuda)
    programs.clear()
    # the key's first call is its eager warm run; the second captures
    assert torch.equal(programs.run(reads_the_host, (x,)), x * 8)
    with pytest.raises(programs.ProgramError,
                       match="reads_the_host: capture failed"):
        programs.run(reads_the_host, (x,))
    # the warm run and the capture; no eager run takes the failed one's place
    assert len(ran) == 2
    assert programs.keys() == []
    torch.cuda.synchronize()
    assert torch.equal(programs.run(lambda t: t + 1, (x,)), x + 1)
    programs.clear()


def test_program_replay_counts_the_eager_launches(cuda):
    cfg = with_flow_params(StitchConfig(flow_alg="pixflow_low_fast"),
                           pallas_min_pixels=0)
    four = synthesize_four_input_set(96, 320, seed=1)
    programs.clear()
    tk.reset_launch_counts()
    with programs.disable():
        pipeline.stitch_four(four, cfg, device=cuda)
    eager = {k.__name__: k.launches for k in tk.KERNELS}
    assert eager["relax_phase"] == eager["median5_diffuse"] > 0
    # the key's eager first call, the capture with its replay, a replay:
    # each counts one stitch's launches
    for _ in range(3):
        tk.reset_launch_counts()
        pipeline.stitch_four(four, cfg, device=cuda)
        assert {k.__name__: k.launches for k in tk.KERNELS} == eager
    assert programs.info()[0]["replays"] == 2
    programs.clear()


def test_chain_body_does_not_wait_for_the_card(cuda):
    """After a warm run (which fills the card-side caches) the chain's
    body runs eagerly with no call that waits for the card: what
    torch.cuda.set_sync_debug_mode("error") refuses, a capture refuses."""
    photos, top = synthesize_fisheye_set(64, 1280, n=5, seed=0)
    cfg = StitchConfig(flow_alg="pixflow_search_20_fast")
    photos = [to_torch(p, cuda) for p in photos]
    top = to_torch(top, cuda)
    windows = crop.plan_chain_windows(photos, top, cfg)
    rolls = torch.tensor([r for r, _, _ in windows], device=cuda)
    shapes = tuple((wd, g) for _, wd, g in windows)
    pipeline._chain_body(top, rolls, *photos, shapes, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipeline._chain_body(top, rolls, *photos, shapes, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_replay_stage_times_tile_its_device_span(cuda):
    """A captured chain keeps its stages' boundaries as event nodes (nine
    stretches a pair: the blend, three of the flow's preparation, the
    coarsest level, the plain and the kernel levels, the combiner and the
    composite); in a recorded replay the stages' device times sum to the
    replay's device span (first boundary to last), which lies inside the
    call's own device span, and the replay's bytes equal an unrecorded
    one's."""
    photos, top = synthesize_fisheye_set(64, 1280, n=5, seed=0)
    cfg = with_flow_params(StitchConfig(flow_alg="pixflow_low"),
                           pallas_min_pixels=11000)

    def run():
        return pipeline.stitch_six(photos, top, cfg, device=cuda)

    programs.clear()
    run()
    want = run()
    (prog,) = programs._cache.values()
    pair = ["pair.blend", "pair.flow_prep", "pair.flow_prep",
            "pair.flow_coarsest", "pair.flow_plain_levels",
            "pair.flow_kernel_levels", "pair.flow_prep", "pair.novel_view",
            "pair.composite"]
    assert [b[0] for b in prog.boundaries] == pair * 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with trace.recording() as rec:
        start.record()
        got = run()
        end.record()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    (replay,) = rec.replays
    assert [name for name, _, _ in replay.stages] == pair * 5
    span = replay.stages[-1][2]
    covered = sum(b - a for _, a, b in replay.stages)
    assert all(b >= a >= 0 for _, a, b in replay.stages)
    assert 0.97 * span <= covered <= span + 1e-3
    assert span <= start.elapsed_time(end)
    assert set(rec.stage_ms()) == set(pair)
    programs.clear()


def test_floor_twin_scale_by_two_floats_is_the_tensor_product(rng, cuda):
    """On the card too: two Python floats give the products of a
    two-element float32 tensor, bit for bit (the init-floor twin's
    scale)."""
    up = to_torch(rng.standard_normal((2, 40, 50, 2)).astype(np.float32)
                  * 30, cuda)
    for (hh, ww), (th, tw) in (((64, 288), (26, 116)),
                               ((2000, 1792), (25, 23))):
        ref = up * torch.tensor([ww / tw, hh / th], dtype=torch.float32,
                                device=cuda)
        got = torch.stack([up[..., 0] * (ww / tw), up[..., 1] * (hh / th)],
                          -1)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
