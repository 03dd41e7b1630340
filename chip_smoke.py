#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from panorama_opticalflow_tpu_torch/
csrc/, then runs ten phases and prints one JSON object per phase line:

  A  the card (nvidia-smi name and power limit) and the kernel build;
  B  each kernel against its plain PyTorch version on the card
     (exact_level, every bit equal, at the cells' coarsest levels: six,
     four and batch4's; the small levels' relax, unfused relax and
     median5+diffuse, every bit equal to the plain branch's ops, timed
     beside them at six's largest plain level (2, 244, 218) and batch4's
     (8, 160, 395); novel_view, every byte equal to the stage's ops, at
     six's 4000x3584 window across the 9000-wide canvas's seam and on
     four's whole 4000x9000 canvas; blend_distances, every bit equal to
     the two eight-ray searches, on a canvas map at six's 4000x3584 window
     and at four's 4000x12600 wrap-extended canvas, bytes bound at 9 a
     pixel; hole_composite, every byte equal to the composite's ops, on a
     pair at six's 4000x3584 window across the 9000-wide canvas's seam and
     on four's whole 4000x9000 canvas, with dense and with sparse holes,
     bytes bound at 9 a pixel and 4 more a source pixel taken), at the
     9000x4000 headline's finest-level
     shapes, at a middle
     level of its pyramid and at a ragged small shape, with kernel and
     plain median times (CUDA events; the kernel table keeps the finest
     level's), the kernel's bound (bytes at the memory rate or operations at the float32
     peak, whichever is longer) and the time of one library call that
     computes the same function on the same inputs where there is one
     (F.grid_sample for the warp; for median5 torch.median over the 25
     values of each window of the replicate-padded plane); the unfused relax at 2 and 3
     iterations; the widened contract (relax at 10 iterations, the unfused
     relax at hat window D = 4, median5+diffuse at blur width 21: the
     kernels' run-time instances) at the ragged, middle and finest shapes;
     and the three fused-path kernels at the finest level of phase I's
     pyramid with its leading 16 directions (medians: 32 planes);
  C  the main path: stitch_six of the 6-photo 9000x4000 synthetic set
     (seed 0) with pixflow_low_fast, once warm and once timed; latency,
     peak device memory, each kernel's launch count against the count the
     pyramid implies, and an exact check of the output alpha footprint;
  D  compute_optical_flow_pair on a headline pair window (4000x3584) with
     the kernels and with use_pallas=False (the plain path on the card):
     both times and the endpoint error between them;
  E  the port on the card against tests/golden/six_96x320_s7.npz at the
     golden gate of tests/test_golden.py;
  F  the 36 MP schedules of tools/fidelity_36mp.py with pixflow_low:
     production (warmed once, then timed), sched22 (2 phases x 2
     iterations) and unfused (fuse_level_blurs=False), each timed with its
     launch counts, footprint, and RGB SSIM and bit-identical share
     against production;
  G  the search init: pixflow_search_20_fast at 9000x4000 (warm, then
     timed), and tests/golden/six_64x256_s3_search20.npz at phase E's gate;
  H  the 4-input stitch: stitch_four at 2250x1000 with pixflow_low (seed
     0), warm, then timed: latency, peak memory, the window the pair's own
     canvas map gives, launch counts against the expected ones, exact
     footprint; and tests/golden/four_96x320_s1.npz at phase E's gate;
  I  batched stitching: stitch_pairs on 8 composed 2250x1000 pairs (seeds
     0..7) against stitch_pair on each in sequence, in turns (sequential,
     batched, batched, sequential): both latencies, peak memory, launch
     counts (batched: one pair's; sequential: eight times that), and per
     pair the share of equal bytes and the largest absolute difference
     (tests/test_batching.py's gate: every byte equal);
  J  the row-tiled stitch (parallel/tiled.py) in process at n = 4 on one
     card, against the untiled stitch, in turns (untiled, tiled, tiled,
     untiled) after warm_up of each (both forms are programs, so both
     times are replays): J1 the stitch_four pair of phase
     H (pixflow_low, full canvas), J2 the second pair window of the
     9000x4000 chain (pixflow_low_fast, 4000x3584, flow tiles of 500
     rows).  Latency, peak memory and launches of both forms, the launches
     against expected_launches of the tiles, the level split and halo, and on the
     interior rows [16:-16] the SSIM (>= 0.995) and the share of equal
     bytes (> 0.97) against the untiled stitch.  With two or more cards
     also J1 with one torch.distributed rank a card under NCCL, every byte
     equal to the in-process form; else one line saying it was skipped;
  K  the captured programs (utils/programs.py) against programs.disable()
     for cell 1 (C's stitch), cell 2 (F's production stitch), H's
     stitch_four, I's eight batched pairs and J1 and J2 tiled (each run
     right after its phase J line): after programs.clear() the
     key's first call (eager, kernels and caches warm from the earlier
     phases) and its second (capture, instantiation, first replay), then
     eager and program in turns (eager, program, program, eager):
     latencies, launches against expected_launches for both forms, the
     device memory the held program keeps, and one profiled replay (device
     ms, device operations = the graph's kernel, copy and fill nodes, idle
     share, the host's graph launches and waits, and each hand-written
     kernel's launches as the profiler saw them on the card, held against
     the counters and expected_launches).  Gate: every byte of the
     program's output equal to the eager run's.

The entry points run as captured programs on the card: a key's first call
is eager, its second captures and replays, later calls replay.  So C, F,
G, H, I and J's untiled form call their stitch twice before they time it
(warm_up), and time a replay.  A replay adds to each kernel's launch
count what its capture saw; phase K checks that against the profiler.
Every timed stitch (C, F, G, H, I, J) runs with the launch
counts set to 0 just before it and read just after; the kernel table sums
those counts.  Then a
line with the kernel table, a line with nvidia-smi's name and power
limit, and as the last line {"ok": true, "device": {...}}.  Any failed
check raises, so the exit code is non-zero and no result line is printed.
It needs one CUDA card and exits non-zero at once without one.  Float32
everywhere: TF32 is switched off for matmuls and cuDNN before any work.

Three shorter modes, each after phase A:

    python3 chip_smoke.py --time-against CSRC    every kernel of this tree
        and of the sources in CSRC (an earlier commit's csrc/) on the same
        inputs, in turns: other, this, this, other
    python3 chip_smoke.py --profile WHAT         torch.profiler over one
        warm stitch (a program's replay): device time by kernel, launches,
        idle share, the host's graph launches and waits.  WHAT is
        a preset name (the 9000x4000 stitch_six), stitch4 (phase H's
        stitch), batched (phase I's 8 pairs, batched and one pair of the
        sequential form, and the launches of each stage in both forms) or
        tiled (phase J's two pairs, each tiled and untiled, both a
        program's replay; with the host's calls that wait for the card)
    python3 chip_smoke.py --cli-against ROOT     the CLI, one fresh
        process a stitch (stitch6 of the 9000x4000 set with
        pixflow_low_fast, stitch4 at 2250x1000 with pixflow_low), of the
        package in ROOT (an earlier commit's tree) and of this one, in
        turns: other, this, this, other, after one process each that
        builds its kernels; the CLI's own stage seconds and each
        process's wall seconds
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# kernel vs plain version on the same inputs: same taps in the same order,
# every product and sum rounded separately (-fmad=false) on both sides
WARP_TOL = 2e-6
MEDIAN_TOL = 1e-5
# relax: strict-< candidate takes may flip on a 1-ulp difference, so the
# gate is the share of pixels off by more than RELAX_TOL
RELAX_TOL = 1e-5
RELAX_MAX_SHARE = 1e-4
# the fused and the unfused level differ in the <= 7 px blur-border band
# (edge-replicated vs reflect-101) and in flipped takes
EPE_MEAN_TOL = 0.05
# a schedule knob against production at 36 MP (the JAX package recorded
# 0.9997+ for both knobs)
SCHEDULE_SSIM_MIN = 0.995
HEADLINE = (4000, 9000)
# phase B: a ragged shape, then a middle level and the finest level of a
# 4000 x 3584 pair window's pixflow_low_fast pyramid; the last two are timed
B_SHAPES = (("ragged", (2, 45, 203)), ("mid", (2, 655, 587)),
            ("headline", (2, 2000, 1792)))
# the finest level of phase I's pyramid: 8 pairs, both directions, of a
# 2250-wide canvas wrap-extended by 112 columns a side, at half resolution;
# only the fused path's kernels run there
B_BATCHED = ("batched", (16, 500, 1237))
FUSED_PATH = ("warp_tiled", "relax_phase", "median5_diffuse")
B_TIMED = ("mid", "headline", "batched")
# phases H and I: the 4-input stitch's canvas, its preset, the pairs in
# flight, and tests/test_batching.py's gate
FOUR = (1000, 2250)
FOUR_ALG = "pixflow_low"
BATCH_PAIRS = 8
BATCH_SAME_MIN = 1.0
BATCH_MAX_DIFF = 0
# phase J: tiles, the interior rows compared, tests/test_tiled.py's gates
TILED_N = 4
TILED_INNER = 16
TILED_SSIM_MIN = 0.995
TILED_SAME_MIN = 0.97
# the widened contract's relax cases: flipped takes grow with the
# iterations; the gate of the CPU's production relax tests
RELAX_WIDE_MAX_SHARE = 5e-4
# crop.plan_chain_windows of the seed-0 headline set: (roll, width,
# gather_safe) per pair
HEADLINE_WINDOWS = [(8100, 3584, False), (900, 3584, True),
                    (2700, 3584, True), (4500, 3584, True),
                    (6300, 3584, False)]
KERNEL_FILES = {
    "warp_tiled": ("csrc/warp_tiled.cu", 986),
    "relax_phase": ("csrc/relax_phase.cu", 732),
    "median5_diffuse": ("csrc/median5_diffuse.cu", 321),
    "relax_phase_unfused": ("csrc/relax_phase.cu", 732),
    "median5": ("csrc/median5.cu", 193),
    "exact_level": ("csrc/exact_level.cu", None),
    "small_relax_phase": ("csrc/relax_phase.cu", None),
    "small_relax_phase_unfused": ("csrc/relax_phase.cu", None),
    "small_median5_diffuse": ("csrc/median5_diffuse.cu", None),
    "novel_view": ("csrc/novel_view.cu", None),
    "blend_distances": ("csrc/eight_ray.cu", None),
    "hole_composite": ("csrc/hole_composite.cu", None),
}
# the 36 MP fidelity harness's schedule knobs (tools/fidelity_36mp.py)
SCHEDULES = {"production": {},
             "sched22": {"relax_phases": 2, "relax_iters_per_phase": 2},
             "unfused": {"fuse_level_blurs": False}}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events,
    after one warm-up run)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_a(smi: str) -> None:
    import torch

    from panorama_opticalflow_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "A", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
          "kernel_build_s": build_s, "built_now": build.build_seconds > 0,
          "ptxas": ptxas})


# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# device memory rate, and float32 rate outside the tensor cores.  That
# rate counts a fused multiply-add as two operations; the kernels are
# built with -fmad=false, so nothing fuses and the instruction ceiling is
# half of it.  The table gives the bound against both.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Operations a pixel of the least-work form of each kernel (two taps a hat
# pass, a median selection that shares its work between neighbouring
# windows), one for every multiply, add, compare, min/max, floor, sqrt and
# divide:
#   warp, two channels: the y residual and its two hat weights 12, at each
#     of two rows the x residual and its weights 12, a channel two x sums
#     and a y sum of (2 mul + 1 add) 9;
#   relax, an iteration: x pass A 18 (offset, two weights, two sums); pass
#     A 5 candidates x (y weights 9, two sums 6, error 20, compare 1) + 3;
#     x pass B 30 (hat and dhat sums); descent 75;
#   the fused relax adds the 15 x 15 separable blur of two planes, 2 x 2 x
#     15 x 2;
#   median of 25 by the exchange networks of csrc/median25_net.inc, in a
#     long run of adjacent outputs: a pixel sorts one window column (9
#     exchanges, min + max each: 18), merges half a pair of sorted columns
#     (13 exchanges a pair: 13) and selects from two merged pairs and a
#     column (30 exchanges, of whose 60 results the network reads 36).  A
#     window alone would take 101 exchanges; the kernels own runs of 8, at
#     82.5 min/max a pixel.  The diffusion adds two 15-tap passes and the
#     blend.
#   exact level: an error evaluation 51 (clamped position 6, cell and
#     fractions 4, a bilinear sum a channel 12, data and smoothness terms
#     12, regularisation 4, the sum 3); an iteration 7 evaluations (own
#     flow, 4 candidates, 2 for the gradient), 5 compares, 2 eps adds, the
#     gradient and step 8; a phase's median a window alone, a channel 101
#     exchanges; the target and the diffusion two 15-tap blurs of two
#     channels each, and the blend 8.
WARP_OPS = 12 + 2 * 12 + 2 * 9
RELAX_OPS_PER_ITER = 18 + (5 * 36 + 3) + 30 + 75
MEDIAN_OPS = 2 * 9 + 13 + 36
EXACT_ERR_OPS = 6 + 4 + 2 * 12 + 12 + 4 + 3
EXACT_ITER_OPS = 7 * EXACT_ERR_OPS + 5 + 2 + 8
# phase B's exact_level shapes: the coarsest level of the six-photo
# chain's pair windows, of the four-input canvas, and of four panoramas'
# batched descent (the table keeps the four-input level's times)
B_EXACT = (("six", (2, 30, 27)), ("four", (2, 27, 67)),
           ("batch4", (8, 27, 67)))
# phase B's small-level shapes (below pallas_min_pixels): the largest plain
# level of the six-photo chain's pyramid and of batch4's batched descent
# (the table keeps the six-photo level's times)
B_SMALL = (("six_small", (2, 244, 218)), ("batch4_small", (8, 160, 395)))
# phase B's novel-view shapes (1, H, window width) on a 9000-wide canvas:
# six's pair window, at the chain's first roll (across the seam), and
# four's whole canvas (the table keeps four's times)
B_NOVEL = (("six_window", (1, 4000, 3584)), ("four", (1, 4000, 9000)))
NOVEL_CANVAS_W, NOVEL_ROLL = 9000, 8100
# the novel view's operations a pixel: each view's source position 6, its
# tiled offsets and residuals 12; the combiner's flow magnitudes 10, colour
# difference and deghost 10, softmax arguments 12, softmax 10, weights 6,
# three channels' mix, rounding and clamp 18
NOVEL_VIEW_OPS = 2 * (6 + 12) + 10 + 10 + 12 + 10 + 6 + 18
# phase B's eight-ray shapes (1, H, W): a canvas map of six's pair window
# and of four's 9000-wide canvas, wrap-extended as generate_blend extends
# it (the table keeps four's times)
B_RAYS = (("six_window", (1, 4000, 3584)), ("four", (1, 4000, 12600)))
# the eight-ray search's operations a pixel: for each of 8 rays and 2
# classes the carried nearest candidate, the distance, its cut and the min
# 4; the 4 diagonal rays' product by sqrt 2 a class
RAY_OPS = 8 * 2 * 4 + 4 * 2
# phase B's composite shapes (1, H, W): a pair at six's window on a
# 9000-wide canvas, at the chain's first roll (across the seam), and on
# four's whole canvas (the table keeps four's times, sparse holes)
B_HOLES = (("six_window", (1, 4000, 3584)), ("four", (1, 4000, 9000)))
# the composite's operations a pixel: the code 2, its four tests and the
# select 5 (a hole's walk reads its neighbours, work the bound leaves out)
HOLE_OPS = 2 + 5


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations
    at the float32 peak, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops,
            "bound_ms_no_fma": max(t_bytes, 2 * t_ops)}


def kernel_cases(dev, rng, b: int, h: int, w: int) -> list[dict]:
    """The five kernels on seeded inputs of (b, h, w) planes.  Each case
    has the wrapper's call (``kernel``), the plain version's (``plain``),
    the tolerance, the bytes and operations of the bound, for the warp and
    median5 the one PyTorch call that computes the same function
    (``library``; none computes median5+diffuse or a relax phase), and for
    the warp the torch ops its wrapper runs before the launch (``glue``)
    and the wrapper's call on offsets made before (``launch``).  A
    ``check_only`` case is held against its plain version and not
    timed."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from panorama_opticalflow_tpu_torch import flow_params_by_name
    from panorama_opticalflow_tpu_torch.ops import kernels

    params = flow_params_by_name("pixflow_low_fast")
    iters, D = params.relax_iters_per_phase, params.fast_window
    kw = params.blurred_flow_kernel_width
    px = b * h * w

    def planes(shape, scale=0.1):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32) * scale).to(dev)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = np.stack([20 * np.sin(yy / 370.0) + 5 * np.cos(xx / 530.0),
                  8 * np.cos(yy / 290.0) - 3 * np.sin(xx / 410.0)], -1)
    f = f + rng.standard_normal(f.shape).astype(np.float32) * 0.3
    flow = torch.from_numpy(np.stack([f] * b).astype(np.float32)).to(dev)
    img = planes((b, h, w, 2), 1.0)
    # F.grid_sample takes channels-first images and sample positions scaled
    # to [-1, 1]; both are made outside the timed call
    pos = flow + torch.stack(torch.meshgrid(
        torch.arange(w, device=dev, dtype=torch.float32),
        torch.arange(h, device=dev, dtype=torch.float32), indexing="xy"), -1)
    grid = 2 * pos / torch.tensor([w - 1, h - 1], device=dev) - 1
    img_cf = img.permute(0, 3, 1, 2).contiguous()
    tiles = -(-h // 64) * -(-w // 128)
    off = kernels.warp_tile_offsets(flow)
    # the kernel's one-channel-a-block form: three channels, and two
    # channels at an address off an 8-byte boundary
    # (a generator of their own: the other cases keep their inputs)
    extra = np.random.default_rng(1)
    img3 = torch.from_numpy(
        extra.standard_normal((b, h, w, 3), np.float32)).to(dev)
    odd = torch.from_numpy(extra.standard_normal(
        b * h * w * 2 + 1, np.float32)).to(dev)[1:].view(b, h, w, 2)
    check(odd.data_ptr() % 8 == 4, "the offset view is 8-byte aligned")
    cases = [dict(name="warp_tiled", variant=variant, dims=list(im.shape),
                  tol=WARP_TOL, check_only=True,
                  kernel=lambda im=im: kernels.warp_tiled(im, flow),
                  plain=lambda im=im: kernels.warp_tiled_plain(im, flow))
             for variant, im in (("three channels", img3),
                                 ("unaligned", odd))]
    cases.append(dict(
        name="warp_tiled", dims=[b, h, w, 2], tol=WARP_TOL,
        kernel=lambda: kernels.warp_tiled(img, flow),
        plain=lambda: kernels.warp_tiled_plain(img, flow),
        library=lambda: F.grid_sample(
            img_cf, grid, mode="bilinear", padding_mode="border",
            align_corners=True).permute(0, 2, 3, 1),
        # the wrapper's two parts: its torch ops before the launch (the
        # per-tile offsets), and the call on offsets made before
        glue=lambda: kernels.warp_tile_offsets(flow),
        launch=lambda: kernels.warp_tiled(img, flow, off),
        nbytes=4 * (6 * px + 2 * b * tiles), ops=WARP_OPS * px))

    x = planes((2 * b, h, w), 0.5)
    c = torch.from_numpy(rng.random((b, h, w), np.float32)).to(dev)
    cases.append(dict(
        name="median5_diffuse", dims=[2 * b, h, w], tol=MEDIAN_TOL,
        kernel=lambda: kernels.median5_diffuse(x, c),
        plain=lambda: kernels.median5_diffuse_plain(x, c),
        nbytes=4 * 5 * px, ops=(MEDIAN_OPS + 2 * 2 * kw + 4) * 2 * px))
    cases.append(dict(
        name="median5", dims=[2 * b, h, w], tol=0.0,
        kernel=lambda: kernels.median5(x),
        plain=lambda: kernels.median5_plain(x),
        # the 25 values of each window of the edge-replicated plane, and
        # their median
        library=lambda: F.pad(x, (2, 2, 2, 2), mode="replicate").unfold(
            1, 5, 1).unfold(2, 5, 1).reshape(2 * b, h, w, 25).median(
                -1).values,
        nbytes=4 * 4 * px, ops=MEDIAN_OPS * 2 * px))

    shape = (b, h, w)
    fx, fy = planes(shape, 0.5), planes(shape, 0.5)
    mask = torch.from_numpy(
        (rng.random(shape) > 0.1).astype(np.float32)).to(dev)
    rp = [fx, fy, fx + planes(shape), fy + planes(shape), planes(shape),
          planes(shape), planes(shape), planes(shape), mask]
    relax = dict(tol=RELAX_TOL, max_share=RELAX_MAX_SHARE)
    cases.append(dict(
        name="relax_phase", dims=list(shape), iters=iters, **relax,
        kernel=lambda: kernels.relax_phase(*rp, params, iters, D),
        plain=lambda: kernels.relax_phase_fused_plain(*rp, params, iters, D),
        nbytes=4 * 11 * px,
        ops=(iters * RELAX_OPS_PER_ITER + 2 * 2 * kw * 2) * px))
    up = rp[:8] + [planes(shape, 0.5), planes(shape, 0.5), mask]
    # the widened contract: the kernels' run-time instances
    wide = dict(tol=RELAX_TOL, max_share=RELAX_WIDE_MAX_SHARE,
                check_only=True)
    cases.append(dict(
        name="relax_phase", variant="iters 10", dims=list(shape), iters=10,
        **wide, kernel=lambda: kernels.relax_phase(*rp, params, 10, D),
        plain=lambda: kernels.relax_phase_fused_plain(*rp, params, 10, D)))
    cases.append(dict(
        name="relax_phase_unfused", variant="D 4", dims=list(shape),
        iters=3, **wide,
        kernel=lambda: kernels.relax_phase_unfused(*up, params, 3, 4),
        plain=lambda: kernels.relax_phase_unfused_plain(*up, params, 3, 4)))
    cases.append(dict(
        name="median5_diffuse", variant="width 21", dims=[2 * b, h, w],
        tol=MEDIAN_TOL, check_only=True,
        kernel=lambda: kernels.median5_diffuse(x, c, 21),
        plain=lambda: kernels.median5_diffuse_plain(x, c, 21)))
    # the table keeps the last headline time: 3 iterations, the production
    # count of the fused kernel
    for it in (2, 3):
        cases.append(dict(
            name="relax_phase_unfused", dims=list(shape), iters=it, **relax,
            kernel=lambda it=it: kernels.relax_phase_unfused(*up, params, it,
                                                             D),
            plain=lambda it=it: kernels.relax_phase_unfused_plain(
                *up, params, it, D),
            nbytes=4 * 13 * px, ops=it * RELAX_OPS_PER_ITER * px))
    return cases


def exact_cases(dev, rng, b: int, h: int, w: int) -> list[dict]:
    """exact_level on a coarsest level of (b, h, w): textured images,
    their blurred gradients, alphas with holes and a zero flow, the
    pixflow_low schedule (4 phases of 15 iterations); its plain version is
    the loop of PyTorch ops it replaces, so the gate is every bit equal."""
    import numpy as np
    import torch

    from panorama_opticalflow_tpu_torch import flow_params_by_name
    from panorama_opticalflow_tpu_torch.models import pixflow
    from panorama_opticalflow_tpu_torch.ops import kernels

    params = flow_params_by_name("pixflow_low")
    phases = params.coarsest_relax_phases
    iters = params.coarsest_relax_iters_per_phase
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = np.stack([0.5 + 0.2 * np.sin(xx / 3.1 + p) * np.cos(yy / 4.3)
                     + 0.05 * rng.standard_normal((h, w))
                     for p in rng.random(b) * 6]).astype(np.float32)
    imgs = torch.from_numpy(imgs).to(dev)
    alphas = np.ones((b, h, w), np.float32)
    alphas[:, :, :w // 5] = 0.0
    alphas = torch.from_numpy(alphas).to(dev)
    gx, gy = pixflow._gradients(imgs, params)
    level = (gx, gy, torch.stack([pixflow._partner(gx),
                                  pixflow._partner(gy)], -1),
             alphas, pixflow._partner(alphas),
             torch.zeros((b, h, w, 2), device=dev), params, phases, iters)
    kw = params.blurred_flow_kernel_width
    ops = (phases * iters * EXACT_ITER_OPS + phases * 2 * 2 * 101
           + 2 * 2 * 2 * 2 * kw + 8)
    return [dict(name="exact_level", dims=[b, h, w], iters=iters, tol=0.0,
                 kernel=lambda: kernels.exact_level(*level),
                 plain=lambda: kernels.exact_level_plain(*level),
                 nbytes=4 * 10 * b * h * w, ops=ops * b * h * w)]


def small_cases(dev, rng, b: int, h: int, w: int) -> list[dict]:
    """The small levels' kernels on a level of (b, h, w) as ``_level_core``
    gets it (textured images, their blurred gradients, alphas with a hole,
    a smooth incoming flow and its warp), pixflow_low: each against its
    plain version, the plain branch's ops on the card, every bit equal."""
    import numpy as np
    import torch

    from panorama_opticalflow_tpu_torch import flow_params_by_name
    from panorama_opticalflow_tpu_torch.models import pixflow
    from panorama_opticalflow_tpu_torch.ops import kernels

    params = flow_params_by_name("pixflow_low")
    iters, D = params.relax_iters_per_phase, params.fast_window
    kw = params.blurred_flow_kernel_width
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = np.stack([0.5 + 0.2 * np.sin(xx / 3.1 + p) * np.cos(yy / 4.3)
                     + 0.05 * rng.standard_normal((h, w))
                     for p in rng.random(b) * 6]).astype(np.float32)
    imgs = torch.from_numpy(imgs).to(dev)
    alphas = np.ones((b, h, w), np.float32)
    alphas[:, :, :w // 5] = 0.0
    alphas = torch.from_numpy(alphas).to(dev)
    gx, gy = pixflow._gradients(imgs, params)
    i1g = torch.stack([pixflow._partner(gx), pixflow._partner(gy)], -1)
    f = np.stack([2 * np.sin(yy / 7.0) + 1.5 * np.cos(xx / 5.0),
                  np.cos(yy / 6.0) - 0.5 * np.sin(xx / 9.0)], -1)
    flow = torch.from_numpy(np.stack([f] * b).astype(np.float32)).to(dev)
    fx, fy = pixflow._xy(flow)
    w1x, w1y = pixflow._xy(kernels.warp_tiled(i1g.contiguous(), flow))
    a1 = pixflow._partner(alphas)
    mask = ((alphas > params.update_alpha_threshold)
            & (a1 > params.update_alpha_threshold)).float()
    rp = [fx, fy, fx, fy, w1x, w1y, gx, gy, mask]
    bfx, bfy = pixflow._xy(pixflow._blur_flow(flow, params))
    up = rp[:8] + [bfx, bfy, mask]
    x = torch.stack(kernels.small_relax_phase_plain(*rp, params, iters, D),
                    1).reshape(2 * b, h, w)
    c = (1.0 - alphas * a1).contiguous()
    px = b * h * w
    return [
        dict(name="small_relax_phase", dims=[b, h, w], iters=iters, tol=0.0,
             kernel=lambda: kernels.small_relax_phase(*rp, params, iters, D),
             plain=lambda: kernels.small_relax_phase_plain(*rp, params,
                                                           iters, D),
             nbytes=4 * 11 * px,
             ops=(iters * RELAX_OPS_PER_ITER + 2 * 2 * kw * 2) * px),
        dict(name="small_relax_phase_unfused", dims=[b, h, w], iters=iters,
             tol=0.0,
             kernel=lambda: kernels.small_relax_phase_unfused(
                 *up, params, iters, D),
             plain=lambda: kernels.small_relax_phase_unfused_plain(
                 *up, params, iters, D),
             nbytes=4 * 13 * px, ops=iters * RELAX_OPS_PER_ITER * px),
        dict(name="small_median5_diffuse", dims=[2 * b, h, w], tol=0.0,
             kernel=lambda: kernels.small_median5_diffuse(x, c),
             plain=lambda: kernels.small_median5_diffuse_plain(x, c),
             nbytes=4 * 5 * px, ops=(MEDIAN_OPS + 2 * 2 * kw + 4) * 2 * px)]


def novel_cases(dev, rng, b: int, h: int, width: int) -> list[dict]:
    """novel_view on a stack of b pairs of (h, NOVEL_CANVAS_W) canvases
    (random RGBA with transparent patches) with smooth flows and a blend
    ramp on a window ``width`` wide at NOVEL_ROLL (none where it is the
    whole canvas): against its plain version, the stage's PyTorch ops on
    the card, every byte equal.  Bytes: the window's flows, blend and two
    samples read once, the whole canvas written."""
    import numpy as np
    import torch

    from panorama_opticalflow_tpu_torch.ops import kernels

    w = NOVEL_CANVAS_W
    imgs = torch.from_numpy(rng.integers(0, 256, (2, b, h, w, 4),
                                         dtype=np.uint8)).to(dev)
    imgs[..., 3][torch.from_numpy(rng.random((2, b, h, w)) < 0.05).to(
        dev)] = 0
    yy, xx = np.mgrid[0:h, 0:width].astype(np.float32)
    f = np.stack([20 * np.sin(yy / 370.0) + 5 * np.cos(xx / 530.0),
                  8 * np.cos(yy / 290.0) - 3 * np.sin(xx / 410.0)], -1)
    flows = [torch.from_numpy(np.stack([s * f + rng.standard_normal(
        f.shape).astype(np.float32)] * b)).to(dev) for s in (1, -1)]
    blend = torch.linspace(0, 1, width, device=dev).expand(b, h, width)
    blend = blend.contiguous()
    window = None if width == w else (
        torch.full((), NOVEL_ROLL, dtype=torch.int64, device=dev), width)
    args = (imgs[0], imgs[1], *flows, blend, window)
    px = b * h * width
    return [dict(name="novel_view", dims=[b, h, w, width], tol=0.0,
                 kernel=lambda: kernels.novel_view(*args),
                 plain=lambda: kernels.novel_view_plain(*args),
                 nbytes=(2 * 8 + 4 + 2 * 4) * px + 4 * b * h * w,
                 ops=NOVEL_VIEW_OPS * px)]


def canvas_map(dev, rng, h: int, w: int):
    """A (h, w) canvas map like match_images': empty, L-only, overlap,
    R-only and empty column bands whose seams wander down the rows, empty
    rows at the top and bottom, and 1 % of the pixels flipped to any
    code."""
    import numpy as np
    import torch

    y = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    seams = [f * w + 0.05 * w * torch.sin(y / (h / float(rng.uniform(2, 7)))
                                          + float(rng.uniform(0, 6)))
             for f in (0.1, 0.35, 0.55, 0.85)]
    m = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    for (lo, hi), code in zip(zip(seams, seams[1:]), (100, 150, 50)):
        m[(x >= lo) & (x < hi)] = code
    m[: h // 20] = 0
    m[h - h // 25:] = 0
    flip = torch.from_numpy(rng.random((h, w)) < 0.01).to(dev)
    m[flip] = torch.from_numpy(rng.choice(
        np.array([0, 50, 100, 150], np.uint8), int(flip.sum()))).to(dev)
    return m


def ray_cases(dev, rng, b: int, h: int, w: int) -> list[dict]:
    """blend_distances on b canvas maps as generate_blend hands them over:
    a pair window's (w at most NOVEL_CANVAS_W), or the wrap-extended
    NOVEL_CANVAS_W canvas's (w wider), with the stride and the cut the
    canvas's size gives and the extension cropped.  Against its plain
    version, the two eight-ray searches on the card, every bit equal.
    Bytes: the map read once, two float32 distances written."""
    import torch

    import panorama_opticalflow_tpu_torch as port
    from panorama_opticalflow_tpu_torch.ops import image as im
    from panorama_opticalflow_tpu_torch.ops import kernels

    cfg = port.StitchConfig()
    cw = NOVEL_CANVAS_W
    step = max(1, min(h, cw) // cfg.blend_step_div)
    crop = 0 if w <= cw else cw // cfg.blend_extend_div
    maps = [canvas_map(dev, rng, h, w if w <= cw else cw) for _ in range(b)]
    codes = torch.stack([m if w <= cw else im.wrap_extend_x(m, crop, -1)
                         for m in maps])
    args = (codes, step, cw / 2.0, crop)
    return [dict(name="blend_distances", dims=[b, h, w, step, crop], tol=0.0,
                 kernel=lambda: kernels.blend_distances(*args),
                 plain=lambda: kernels.blend_distances_plain(*args),
                 nbytes=b * h * w + 2 * 4 * b * h * (w - 2 * crop),
                 ops=RAY_OPS * b * h * w)]


def hole_pair(dev, seed: int, b: int, h: int, w: int, l_span, r_span,
              holes: str):
    """(map, L, R, merged) of b pairs of (h, w) canvases: L's alpha
    footprint the circular columns l_span = (start, length), R's r_span,
    their edges wandering down the rows by up to 2 % of w; the merged view
    opaque on the overlap but for its holes (sparse: 0.2 % of the pixels
    and a 40 x 60 blob; dense: 40 % and a 600 x 500 blob reaching past the
    search radius) and on 1 % of the other pixels."""
    import torch

    from panorama_opticalflow_tpu_torch.models import stitcher

    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.arange(h, device=dev)[:, None].float()
    x = torch.arange(w, device=dev)[None, :]

    def footprint(start, length, phase):
        wob = (0.02 * w * torch.sin(y / (h / 3.0) + phase)).round().long()
        return ((x - start - wob) % w) < length

    shape = (b, h, w)
    image_l, image_r, merged = (
        torch.randint(0, 256, shape + (4,), generator=g, device=dev,
                      dtype=torch.uint8) for _ in range(3))
    image_l[..., 3] = torch.where(footprint(*l_span, 0.3),
                                  image_l[..., 3].clamp(min=1), 0)
    image_r[..., 3] = torch.where(footprint(*r_span, 1.7),
                                  image_r[..., 3].clamp(min=1), 0)
    cmap = stitcher.match_images(image_l, image_r)
    share, (bh, bw) = (0.002, (40, 60)) if holes == "sparse" else (
        0.4, (600, 500))
    u = torch.rand(shape, generator=g, device=dev)
    hole = u < share
    x_mid = (r_span[0] + (l_span[0] + l_span[1] - r_span[0]) % w // 2) % w
    hole[..., h // 2 - bh // 2: h // 2 + bh // 2,
         max(0, x_mid - bw // 2): x_mid + bw // 2] = True
    opaque = ((cmap == 150) & ~hole) | (u > 0.99)
    merged[..., 3] = torch.where(opaque, merged[..., 3].clamp(min=1), 0)
    return cmap, image_l, image_r, merged


def hole_cases(dev, rng, b: int, h: int, width: int) -> list[dict]:
    """hole_composite on b pairs as gather_composite hands them over: a
    pair window ``width`` wide at NOVEL_ROLL on a NOVEL_CANVAS_W canvas,
    its overlap clear of the window's and the canvas's edges (a safe
    window), or the whole canvas; dense holes, then sparse.  Against its
    plain version, the composite's PyTorch ops on the card, every byte
    equal.  Bytes: the map and the merged view read and the output written
    once, 9 a pixel, and a source pixel read where the code takes one."""
    import torch

    import panorama_opticalflow_tpu_torch as port
    from panorama_opticalflow_tpu_torch.ops import kernels

    w = NOVEL_CANVAS_W
    radius = port.StitchConfig().gather_search_radius
    if width < w:
        spans = ((NOVEL_ROLL + 500, 2000), (NOVEL_ROLL + 1300 - w, 2900))
        window = (torch.full((), NOVEL_ROLL, dtype=torch.int64, device=dev),
                  width)
    else:
        spans, window = ((0, 5000), (4000, 5000)), None
    cases = []
    for holes in ("dense", "sparse"):   # the table keeps the last
        pair = hole_pair(dev, int(rng.integers(1 << 31)), b, h, w, *spans,
                         holes)
        if window is not None:
            pair = tuple(t[0] for t in pair)
        args = (*pair, radius, window)
        code = pair[0] + 75 * (pair[3][..., 3] > 0).to(torch.uint8)
        taken = int(((code == 100) | (code == 50) | (code == 150)).sum())
        cases.append(dict(
            name="hole_composite", dims=[b, h, w, width], tol=0.0,
            variant=f"{holes} holes: {int((code == 150).sum())}",
            kernel=lambda args=args: kernels.hole_composite(*args),
            plain=lambda args=args: kernels.hole_composite_plain(*args),
            nbytes=9 * b * h * w + 4 * taken, ops=HOLE_OPS * b * h * w))
    return cases


def as_tensor(out):
    import torch

    return torch.stack(out) if isinstance(out, tuple) else out


def phase_b(dev) -> dict:
    """Each kernel against its plain version at a ragged shape, a middle
    level and the headline finest-level shapes; returns {kernel:
    {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by, ...}} with
    the finest level's times."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    results = {name: {"max_abs_err": 0.0} for name in KERNEL_FILES}
    shapes = ([(tag, shape, kernel_cases) for tag, shape in
               B_SHAPES + (B_BATCHED,)]
              + [(tag, shape, exact_cases) for tag, shape in B_EXACT]
              + [(tag, shape, small_cases) for tag, shape in B_SMALL]
              + [(tag, shape, novel_cases) for tag, shape in B_NOVEL]
              + [(tag, shape, ray_cases) for tag, shape in B_RAYS]
              + [(tag, shape, hole_cases) for tag, shape in B_HOLES])
    for tag, (b, h, w), cases in shapes:
        for case in cases(dev, rng, b, h, w):
            name = case["name"]
            if tag == "batched" and (name not in FUSED_PATH
                                     or case.get("check_only")):
                continue
            got = as_tensor(case["kernel"]())
            torch.cuda.synchronize()
            ref = as_tensor(case["plain"]())
            bit_equal = bool(torch.equal(got, ref))
            if got.dtype == torch.uint8:   # bytes: no wrap-around
                got, ref = got.int(), ref.int()
            else:   # the same infinity is no difference
                same_inf = torch.isinf(got) & (got == ref)
                got, ref = got.masked_fill(same_inf, 0), ref.masked_fill(
                    same_inf, 0)
            diff = (got - ref).abs()
            err = diff.max().item()
            rec = {"phase": "B", "kernel": name, "shape": tag,
                   "dims": case["dims"], "max_abs_err": err,
                   "bit_equal": bit_equal, "tol": case["tol"]}
            for key in ("iters", "variant"):
                if key in case:
                    rec[key] = case[key]
            if "max_share" in case:
                # a flipped strict-< take moves a pixel by more than the
                # tolerance: the gate is the share of such pixels
                share = (diff.amax(dim=0) > case["tol"]).float().mean().item()
                rec.update(share_over_tol=share, max_share=case["max_share"])
                ok = share < case["max_share"]
            else:
                ok = err <= case["tol"]
            if (tag in B_TIMED or cases is not kernel_cases) \
                    and not case.get("check_only"):
                timed = {"ms": cuda_ms(case["kernel"], 20),
                         "plain_ms": cuda_ms(case["plain"], 5),
                         "library_ms": None,
                         **bound(case["nbytes"], case["ops"])}
                if "library" in case:
                    timed["library_ms"] = cuda_ms(case["library"], 20)
                    # the warp: equal where the residual stays inside its
                    # clamp; median5: equal
                    timed["library_max_abs_diff"] = \
                        (got - case["library"]()).abs().max().item()
                if "glue" in case:
                    timed["glue_ms"] = cuda_ms(case["glue"], 20)
                    timed["launch_ms"] = cuda_ms(case["launch"], 20)
                rec.update(timed)
                if tag in ("headline", "four", "six_small"):
                    results[name].update(timed)   # the kernel table's
            results[name]["max_abs_err"] = max(err,
                                               results[name]["max_abs_err"])
            emit(rec)
            check(ok, f"{name} {tag}: {rec}")
            del got, ref, diff
        torch.cuda.empty_cache()
    return results


def time_against(other_csrc: str, dev) -> None:
    """The solver kernels' cases at B_SHAPES, and the composite's at
    B_HOLES where ``other_csrc`` has it, of this tree and of the sources in
    ``other_csrc`` (an earlier commit's csrc/ or a variant, same C
    interface) on the same inputs, timed in turns (other, this, this,
    other) within one process on one card."""
    import numpy as np
    import torch

    from panorama_opticalflow_tpu_torch.ops import build

    libs = {"other": build.open_library(os.path.abspath(other_csrc)),
            "this": build.load()}
    rng = np.random.default_rng(0)
    shapes = [(tag, shape, kernel_cases) for tag, shape in B_SHAPES]
    if hasattr(libs["other"], "pano_hole_composite"):
        shapes += [(tag, shape, hole_cases) for tag, shape in B_HOLES]
    for tag, (b, h, w), cases in shapes:
        for case in cases(dev, rng, b, h, w):
            if case.get("check_only"):
                continue
            times, outs = {"other": [], "this": []}, {}
            for side in ("other", "this", "this", "other"):
                build.use_library(libs[side])
                times[side].append(cuda_ms(case["kernel"], 20))
                outs[side] = as_tensor(case["kernel"]())
            build.use_library(libs["this"])
            emit({"phase": "time_against", "kernel": case["name"],
                  "shape": tag, "dims": case["dims"],
                  "iters": case.get("iters"),
                  "variant": case.get("variant"), "other_ms": times["other"],
                  "this_ms": times["this"],
                  "bit_same_share": (outs["this"] == outs["other"])
                  .float().mean().item(),
                  "max_abs_diff": (outs["this"].double()
                                   - outs["other"].double()).abs()
                  .max().item()})
        torch.cuda.empty_cache()


def device_rows(prof) -> list[tuple]:
    """(name, device ms, count) of every kernel a profile saw on the card,
    longest first."""
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3,
             e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    rows.sort(key=lambda r: -r[1])
    return rows


# the host's calls into the CUDA runtime that launch a graph or make the
# host wait for the card (a copy from pageable host memory waits for the
# stream to drain)
HOST_CALLS = ("cudaGraphLaunch", "cudaStreamSynchronize",
              "cudaDeviceSynchronize", "cudaMemcpyAsync", "cudaMemcpy")


def host_calls(prof) -> dict:
    return {e.key: e.count for e in prof.key_averages()
            if e.key in HOST_CALLS}


def device_profile(run) -> dict:
    """torch.profiler over one ``run()``: the card's time, its operations
    (kernels, copies and fills; for a program's replay, the graph's nodes
    that do work), the host's graph launches and waits, and the device
    rows (``device_rows``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled = time.perf_counter() - t0
    rows = device_rows(prof)
    return {"device_ms": sum(r[1] for r in rows),
            "device_ops": sum(r[2] for r in rows),
            "host_calls": host_calls(prof), "profiled_s": profiled,
            "rows": rows}


def profile_run(what: str, run, **more) -> None:
    """torch.profiler over one warm ``run()``: device time by kernel name,
    the launch count, the card's idle share and the host's graph launches
    and waits."""
    import torch

    from panorama_opticalflow_tpu_torch.utils import programs

    warm_up(run)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    prof = device_profile(run)
    rows = prof.pop("rows")
    emit({"phase": "profile", "what": what, **more,
          "latency_s_unprofiled": latency, **prof,
          "programs": programs.info(),
          "idle_share_of_unprofiled": 1 - prof["device_ms"] / 1e3 / latency,
          "hand_written": [
              {"name": k.split("(anonymous namespace)::")[1].split("(")[0],
               "ms": ms, "count": n} for k, ms, n in rows
              if k.startswith("void (anonymous namespace)::")],
          "top": [{"name": k[:80], "ms": ms, "count": n}
                  for k, ms, n in rows[:14]]})


def stage_launches(images_l, images_r, cfg) -> dict:
    """Launches on the card of each stage of a full-canvas pair stitch, on
    one pair ((H, W, 4) canvases) or on stacks: the stages run one by one,
    each under its own profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from panorama_opticalflow_tpu_torch.models import novel_view, stitcher

    counts, kept = {}, {}

    def stage(name, fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kept[name] = fn()
            torch.cuda.synchronize()
        counts[name] = sum(r[2] for r in device_rows(prof))

    def geometry():
        cmap = stitcher.match_images(images_l, images_r)
        return (cmap, stitcher.extract_overlap(images_l, cmap),
                stitcher.extract_overlap(images_r, cmap))

    stage("geometry", geometry)
    stage("blend", lambda: stitcher.generate_blend(kept["geometry"][0],
                                                   cfg)[0])
    stage("flow", lambda: novel_view.prepare_flows(*kept["geometry"][1:],
                                                   cfg))
    stage("combine", lambda: novel_view.combine_novel_views(
        *kept["geometry"][1:], *kept["flow"], kept["blend"]))
    stage("composite", lambda: stitcher.gather_composite(
        kept["geometry"][0], images_l, images_r, kept["combine"], cfg))
    return counts


def profile_what(what: str, dev) -> None:
    import panorama_opticalflow_tpu_torch as port
    from panorama_opticalflow_tpu_torch.models import pipeline

    if what == "stitch4":
        photos = [port.to_torch(p, dev) for p in
                  port.synthesize_four_input_set(*FOUR, seed=0)]
        cfg = port.StitchConfig(flow_alg=FOUR_ALG)
        profile_run(what, lambda: pipeline.stitch_four(photos, cfg,
                                                       device=dev),
                    canvas=list(FOUR), flow_alg=FOUR_ALG)
    elif what == "tiled":
        photos_d, top_d, _ = headline_set(dev)
        headline = tuple(t.cpu() for t in (photos_d[0], photos_d[1], top_d))
        del photos_d, top_d
        for c in tiled_cases(dev, headline):
            runs = tiled_runs(c, TILED_N)
            for form in ("tiled", "untiled"):
                profile_run(what, runs[form], form=form, tiles=TILED_N,
                            case=c["case"], flow_alg=c["cfg"].flow_alg)
            del runs, c
    elif what == "batched":
        ls, rs = batch_pairs(dev)
        cfg = port.StitchConfig(flow_alg=FOUR_ALG)
        profile_run(what, lambda: pipeline.stitch_pairs(ls, rs, cfg,
                                                        device=dev),
                    form="batched", pairs=BATCH_PAIRS, flow_alg=FOUR_ALG)
        profile_run(what, lambda: pipeline.stitch_pair(ls[0], rs[0], cfg),
                    form="sequential, one pair of the eight",
                    flow_alg=FOUR_ALG)
        emit({"phase": "profile", "what": "stage launches",
              "one_pair": stage_launches(ls[0], rs[0], cfg),
              "batched": stage_launches(ls, rs, cfg),
              "pairs": BATCH_PAIRS})
    else:
        photos_d, top_d, _ = headline_set(dev)
        cfg = port.StitchConfig(flow_alg=what)
        profile_run(what, lambda: pipeline.stitch_six(photos_d, top_d, cfg,
                                                      device=dev),
                    canvas=list(HEADLINE), flow_alg=what)


def expected_launches(windows, canvas_h: int, params, tiles=None) -> dict:
    """Kernel launches of one chain.  Per fast level the warp runs once per
    phase; a level of at least pallas_min_pixels runs the fused relax and
    median5+diffuse once if it is a single-phase fused level, else the
    unfused relax and median5 once per phase; a smaller level the small
    levels' fused relax and median5+diffuse once, else their unfused relax
    once per phase, median5 after each phase but the last and their
    median5+diffuse once (a small relax runs a phase of more than
    SMALL_RELAX_ITERS iterations in several launches).  With a raised pyramid floor
    (_fast) every level of pyramid_sizes is a fast level; otherwise the
    coarsest is exact.  The exact level (the coarsest, or the _fast
    presets' init-floor twin) runs exact_level once where a block holds
    it.  Every pair runs novel_view once, a stack of pairs or of row
    tiles once too, and blend_distances and hole_composite once, a stack
    of pairs once too (the row-tiled stitch searches its tiles with
    PyTorch ops).  ``tiles``
    = (n, TileConfig) counts the row-tiled
    stitch: a level runs tiled or whole by parallel.tiled.tiled_levels,
    and the pallas_min_pixels gate sees the shape its kernels get, a tiled
    level's halo-extended tile (ceil(rows / n) + 2 * halo rows).  In
    process the n tiles are one stack, so a level launches each kernel
    once, as untiled."""
    from panorama_opticalflow_tpu_torch.models import pixflow
    from panorama_opticalflow_tpu_torch.parallel import tiled

    from panorama_opticalflow_tpu_torch.ops import kernels

    phases = params.relax_phases
    fused = phases == 1 and params.fuse_level_blurs
    # a small level's relax launches a phase (D <= 3)
    runs = -(-params.relax_iters_per_phase // kernels.SMALL_RELAX_ITERS)
    n = dict.fromkeys(KERNEL_FILES, 0)
    for _, width, _ in windows:
        sizes = pixflow.pyramid_sizes(int(canvas_h * params.downscale_factor),
                                      int(width * params.downscale_factor),
                                      params)
        exact = (pixflow._sub_floor_sizes(*sizes[-1], params)
                 or sizes)[-1]
        n["exact_level"] += pixflow._exact_kernel_level(*exact, params)
        n["novel_view"] += 1
        n["blend_distances"] += tiles is None
        n["hole_composite"] += tiles is None
        if tiles is not None:
            nt, tc = tiles
            sizes = [(-(-h // nt) + 2 * tc.level_halo if t else h, w)
                     for (h, w), t in zip(sizes,
                                          tiled.tiled_levels(sizes, nt, tc))]
        fast = sizes if params.pyr_stop_size else sizes[:-1]
        big = sum(h * w >= params.pallas_min_pixels for h, w in fast)
        small = len(fast) - big
        n["warp_tiled"] += phases * len(fast)
        if fused:
            n["relax_phase"] += big
            n["median5_diffuse"] += big
            n["small_relax_phase"] += runs * small
            n["small_median5_diffuse"] += small
        else:
            n["relax_phase_unfused"] += phases * big
            n["median5"] += phases * big + max(phases - 1, 0) * small
            n["small_relax_phase_unfused"] += runs * phases * small
            n["small_median5_diffuse"] += small if phases else 0
    return n


def warm_up(run) -> tuple[float, float]:
    """``run()`` twice, so that the next call of a program is a replay:
    its key's eager first call, then its capture, instantiation and first
    replay.  Returns both calls' seconds."""
    import torch

    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs[0], secs[1]


def drive_run(run, inputs, warm: bool):
    """One timed ``run()`` (after ``warm_up`` if ``warm``), with the launch
    counts and the peak memory reset just before it and read just after.
    Returns the output and a record of the measurements, including
    whether the output's alpha footprint is exactly the union of the
    footprints of ``inputs`` (canvases, or stacks of canvases)."""
    import torch

    from panorama_opticalflow_tpu_torch.ops import kernels

    rec = {}
    if warm:
        rec["warm_s"], rec["capture_s"] = warm_up(run)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    rec["latency_s"] = time.perf_counter() - t0
    rec["launches"] = {k.__name__: k.launches for k in kernels.KERNELS}
    rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    union = inputs[0][..., 3] > 0
    for p in inputs[1:]:
        union = union | (p[..., 3] > 0)
    rec["alpha_footprint_exact"] = bool(torch.equal(out[..., 3] > 0, union))
    return out, rec


def drive(photos_d, top_d, cfg, dev, warm: bool):
    """``drive_run`` of one stitch_six."""
    from panorama_opticalflow_tpu_torch.models import pipeline

    return drive_run(lambda: pipeline.stitch_six(photos_d, top_d, cfg,
                                                 device=dev),
                     [top_d, *photos_d], warm)


def check_run(tag: str, out, rec, expected: dict, h: int, w: int) -> None:
    import torch

    check(tuple(out.shape[-3:]) == (h, w, 4) and out.dtype == torch.uint8,
          f"{tag}: output shape/dtype")
    for name, n in rec["launches"].items():
        check(n == expected[name],
              f"{tag} {name}: {n} launches, expected {expected[name]}")
    check(rec["alpha_footprint_exact"],
          f"{tag}: output alpha footprint != union of input alphas")


def headline_set(dev):
    import panorama_opticalflow_tpu_torch as port

    h, w = HEADLINE
    t0 = time.perf_counter()
    photos, top = port.synthesize_fisheye_set(h, w, n=5, seed=0)
    photos_d = [port.to_torch(p, dev) for p in photos]
    top_d = port.to_torch(top, dev)
    return photos_d, top_d, time.perf_counter() - t0


def phase_c(dev, photos_d, top_d, setup_s) -> tuple[dict, tuple]:
    """The main path at 9000 x 4000; returns the launch counts and the
    first pair's window inputs for phase D."""
    import panorama_opticalflow_tpu_torch as port
    from panorama_opticalflow_tpu_torch.models import crop, stitcher

    h, w = HEADLINE
    cfg = port.StitchConfig(flow_alg="pixflow_low_fast")
    windows = crop.plan_chain_windows(photos_d, top_d, cfg)
    check(windows == HEADLINE_WINDOWS, f"headline windows {windows}")
    expected = expected_launches(windows, h, cfg.flow_params)
    out, rec = drive(photos_d, top_d, cfg, dev, warm=True)
    emit({"phase": "C", "canvas": [h, w], "flow_alg": cfg.flow_alg,
          "windows": windows, "setup_s": setup_s, **rec,
          "expected_launches": expected,
          "out_shape": list(out.shape), "out_dtype": str(out.dtype)})
    check_run("phase C", out, rec, expected, h, w)
    for name in ("warp_tiled", "relax_phase", "median5_diffuse"):
        check(rec["launches"][name] > 0, f"phase C: {name} never launched")

    roll, width, _ = windows[0]
    cmap = stitcher.match_images(photos_d[0], top_d)
    pair = tuple(stitcher.window_cols(stitcher.extract_overlap(img, cmap),
                                      roll, width)
                 for img in (photos_d[0], top_d))
    return rec["launches"], pair


def phase_d(pair) -> None:
    """One headline pair window: the kernels against the plain path."""
    import torch

    from panorama_opticalflow_tpu_torch import flow_params_by_name
    from panorama_opticalflow_tpu_torch.models import pixflow

    fp = flow_params_by_name("pixflow_low_fast")
    flows, times = {}, {}
    for name, p in (("kernels", fp),
                    ("plain", dataclasses.replace(fp, use_pallas=False))):
        pixflow.compute_optical_flow_pair(*pair, p)   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flows[name] = pixflow.compute_optical_flow_pair(*pair, p)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
    epe = torch.cat([
        torch.linalg.vector_norm(a - b, dim=-1).flatten()
        for a, b in zip(flows["kernels"], flows["plain"])])
    epe_mean, epe_max = epe.mean().item(), epe.max().item()
    finite = all(bool(torch.isfinite(f).all()) for f in flows["kernels"])
    emit({"phase": "D", "window": list(pair[0].shape[:2]),
          "kernels_s": times["kernels"], "plain_s": times["plain"],
          "epe_mean": epe_mean, "epe_max": epe_max,
          "epe_mean_tol": EPE_MEAN_TOL, "finite": finite,
          "flow_abs_max": max(f.abs().max().item()
                              for f in flows["kernels"])})
    check(finite, "phase D flow not finite")
    check(epe_mean <= EPE_MEAN_TOL, f"phase D mean EPE {epe_mean}")


def ssim_card(a, b) -> float:
    """utils.data.ssim computed on the card: the same 11 x 11 Gaussian
    window (sigma 1.5), applied separably in float64, 'valid' borders,
    mean over channels.  Phase E holds it equal to the host version."""
    import numpy as np
    import torch

    i = np.arange(11) - 5.0
    k = np.exp(-(i ** 2) / (2 * 1.5 * 1.5))
    k = torch.tensor(k / k.sum(), dtype=torch.float64, device=a.device)

    def filt(x):
        h, w = x.shape
        rows = sum(k[t] * x[t:t + h - 10] for t in range(11))
        return sum(k[t] * rows[:, t:t + w - 10] for t in range(11))

    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    a = a.to(torch.float64)
    b = b.to(torch.float64)
    a, b = (a, b) if a.dim() == 3 else (a[..., None], b[..., None])
    vals = []
    for ch in range(a.shape[2]):
        x, y = a[..., ch], b[..., ch]
        mx, my = filt(x), filt(y)
        mxx, myy, mxy = mx * mx, my * my, mx * my
        sx = filt(x * x) - mxx
        sy = filt(y * y) - myy
        sxy = filt(x * y) - mxy
        s = ((2 * mxy + c1) * (2 * sxy + c2)) / ((mxx + myy + c1)
                                                 * (sx + sy + c2))
        vals.append(s.mean().item())
    return float(np.mean(vals))


def golden_gate(out, golden) -> dict:
    """tests/test_golden.py::_check on numpy arrays: alpha exact, SSIM >=
    0.995, < 1 % of the values off by more than 8."""
    import numpy as np

    import panorama_opticalflow_tpu_torch as port

    alpha_ok = bool(np.array_equal(out[..., 3], golden[..., 3]))
    s = port.ssim(out, golden)
    off8 = float((np.abs(out.astype(np.int32)
                         - golden.astype(np.int32)) > 8).mean())
    return {"alpha_exact": alpha_ok, "ssim": s,
            "share_off_by_more_than_8": off8,
            "gate_ok": alpha_ok and s >= 0.995 and off8 < 0.01}


def load_golden(name: str):
    import numpy as np

    return np.load(os.path.join(ROOT, "tests", "golden",
                                f"{name}.npz"))["output"]


def phase_e(dev) -> None:
    """The pinned 96 x 320 golden (pixflow_low, seed 7) at the gate of
    tests/test_golden.py::_check; also checks ssim_card against the host
    SSIM on it."""
    import torch

    import panorama_opticalflow_tpu_torch as port
    from panorama_opticalflow_tpu_torch.models import pipeline

    golden = load_golden("six_96x320_s7")
    photos, top = port.synthesize_fisheye_set(96, 320, n=5, seed=7)
    out = pipeline.stitch_six(photos, top,
                              port.StitchConfig(flow_alg="pixflow_low"),
                              device=dev)
    rec = golden_gate(port.to_numpy(out), golden)
    s_card = ssim_card(out, torch.from_numpy(golden).to(dev))
    emit({"phase": "E", "golden": "six_96x320_s7", **rec,
          "ssim_card": s_card})
    check(rec["gate_ok"], "phase E golden gate")
    check(abs(s_card - rec["ssim"]) < 1e-9, "ssim_card != host ssim")


def phase_f(dev, photos_d, top_d) -> dict:
    """pixflow_low at 9000 x 4000 under the fidelity harness's schedules;
    returns each run's launch counts."""
    import torch

    import panorama_opticalflow_tpu_torch as port
    from panorama_opticalflow_tpu_torch.models import crop
    from panorama_opticalflow_tpu_torch.utils.config import with_flow_params

    h, w = HEADLINE
    base = port.StitchConfig(flow_alg="pixflow_low")
    windows = crop.plan_chain_windows(photos_d, top_d, base)
    check(windows == HEADLINE_WINDOWS, f"phase F windows {windows}")
    prod, launches = None, {}
    for knob, changes in SCHEDULES.items():
        cfg = with_flow_params(base, **changes)
        params = cfg.flow_params
        expected = expected_launches(windows, h, params)
        # each schedule is a program of its own
        out, rec = drive(photos_d, top_d, cfg, dev, warm=True)
        if prod is None:
            prod = out
        else:
            rec["ssim_rgb_vs_production"] = ssim_card(out[..., :3],
                                                      prod[..., :3])
            rec["bit_same_share_vs_production"] = \
                (out == prod).double().mean().item()
        emit({"phase": "F", "schedule": knob, "flow_alg": base.flow_alg,
              "relax_phases": params.relax_phases,
              "relax_iters_per_phase": params.relax_iters_per_phase,
              "fuse_level_blurs": params.fuse_level_blurs,
              "windows": windows, **rec, "expected_launches": expected})
        check_run(f"phase F {knob}", out, rec, expected, h, w)
        if knob != "production":
            check(rec["ssim_rgb_vs_production"] >= SCHEDULE_SSIM_MIN,
                  f"phase F {knob}: SSIM vs production "
                  f"{rec['ssim_rgb_vs_production']}")
            for name in ("relax_phase_unfused", "median5"):
                check(rec["launches"][name] > 0,
                      f"phase F {knob}: {name} never launched")
        launches[knob] = rec["launches"]
        del out
    del prod
    torch.cuda.empty_cache()
    return launches


def phase_g(dev, photos_d, top_d) -> dict:
    """The search init: pixflow_search_20_fast at 9000 x 4000 and the
    search20 golden; returns the timed run's launch counts."""
    import panorama_opticalflow_tpu_torch as port
    from panorama_opticalflow_tpu_torch.models import crop, pipeline

    h, w = HEADLINE
    cfg = port.StitchConfig(flow_alg="pixflow_search_20_fast")
    windows = crop.plan_chain_windows(photos_d, top_d, cfg)
    expected = expected_launches(windows, h, cfg.flow_params)
    out, rec = drive(photos_d, top_d, cfg, dev, warm=True)
    emit({"phase": "G", "flow_alg": cfg.flow_alg,
          "search_distance": cfg.flow_params.search_distance,
          "windows": windows, **rec, "expected_launches": expected})
    check_run("phase G", out, rec, expected, h, w)
    del out

    photos, top = port.synthesize_fisheye_set(64, 256, n=5, seed=3)
    small = port.to_numpy(pipeline.stitch_six(
        photos, top, port.StitchConfig(flow_alg="pixflow_search_20"),
        device=dev))
    gate = golden_gate(small, load_golden("six_64x256_s3_search20"))
    emit({"phase": "G", "golden": "six_64x256_s3_search20", **gate})
    check(gate["gate_ok"], "phase G search20 golden gate")
    return rec["launches"]


def full_canvas_flow_window(w: int, cfg) -> list[tuple]:
    """The one window ``expected_launches`` counts for a pair stitched on
    the full canvas: its flow runs on the wrap-extended canvas."""
    return [(0, w + 2 * (w // cfg.flow_extend_div), False)]


def phase_h(dev) -> dict:
    """The 4-input single-pass stitch at 2250 x 1000 through its entry
    point, and its pinned golden; returns the timed run's launch counts."""
    import panorama_opticalflow_tpu_torch as port
    from panorama_opticalflow_tpu_torch.models import crop, pipeline, stitcher

    h, w = FOUR
    cfg = port.StitchConfig(flow_alg=FOUR_ALG)
    photos = [port.to_torch(p, dev)
              for p in port.synthesize_four_input_set(h, w, seed=0)]
    image_l, image_r = pipeline.compose_four(photos)
    window = crop.pair_window(stitcher.match_images(image_l, image_r), cfg)
    # four seams around the circle: the pair's window is the whole canvas
    check(window == (0, w, False), f"phase H window {window}")
    expected = expected_launches(full_canvas_flow_window(w, cfg), h,
                                 cfg.flow_params)
    out, rec = drive_run(lambda: pipeline.stitch_four(photos, cfg,
                                                      device=dev),
                         [image_l, image_r], warm=True)
    emit({"phase": "H", "canvas": [h, w], "flow_alg": cfg.flow_alg,
          "window": window, **rec, "expected_launches": expected})
    check_run("phase H", out, rec, expected, h, w)
    for name in FUSED_PATH:
        check(rec["launches"][name] > 0, f"phase H: {name} never launched")
    del out

    small = port.to_numpy(pipeline.stitch_four(
        port.synthesize_four_input_set(96, 320, seed=1), cfg, device=dev))
    gate = golden_gate(small, load_golden("four_96x320_s1"))
    emit({"phase": "H", "golden": "four_96x320_s1", **gate})
    check(gate["gate_ok"], "phase H golden gate")
    return rec["launches"]


def batch_pairs(dev):
    """Phase I's inputs: the composed canvases of BATCH_PAIRS 4-input sets
    (seeds 0, 1, ...) as two (N, H, W, 4) stacks on the card."""
    import torch

    import panorama_opticalflow_tpu_torch as port
    from panorama_opticalflow_tpu_torch.models import pipeline

    pairs = [pipeline.compose_four(
        [port.to_torch(p, dev)
         for p in port.synthesize_four_input_set(*FOUR, seed=k)])
        for k in range(BATCH_PAIRS)]
    return (torch.stack([p[0] for p in pairs]),
            torch.stack([p[1] for p in pairs]))


def phase_i(dev) -> dict:
    """stitch_pairs on 8 pairs against stitch_pair on each in sequence, in
    turns; returns the launch counts of the last batched run."""
    import numpy as np
    import torch

    import panorama_opticalflow_tpu_torch as port
    from panorama_opticalflow_tpu_torch.models import pipeline, pixflow

    h, w = FOUR
    cfg = port.StitchConfig(flow_alg=FOUR_ALG)
    ls, rs = batch_pairs(dev)
    window = full_canvas_flow_window(w, cfg)
    fw = window[0][1]
    f = cfg.flow_params.downscale_factor
    finest = pixflow.pyramid_sizes(int(h * f), int(fw * f),
                                   cfg.flow_params)[0]
    check((2 * BATCH_PAIRS, *finest) == B_BATCHED[1],
          f"phase I finest level {finest}, phase B checked {B_BATCHED[1]}")
    one = expected_launches(window, h, cfg.flow_params)
    expected = {"batched": one,
                "sequential": {k: BATCH_PAIRS * n for k, n in one.items()}}
    forms = {
        "batched": lambda: pipeline.stitch_pairs(ls, rs, cfg, device=dev),
        "sequential": lambda: torch.stack(
            [pipeline.stitch_pair(a, b, cfg) for a, b in zip(ls, rs)])}
    # each form's program: its key's eager call and its capture
    warm_up(forms["batched"])
    warm_up(lambda: pipeline.stitch_pair(ls[0], rs[0], cfg))
    outs, recs = {}, {"batched": [], "sequential": []}
    for form in ("sequential", "batched", "batched", "sequential"):
        out, rec = drive_run(forms[form], [ls, rs], warm=False)
        check_run(f"phase I {form}", out, rec, expected[form], h, w)
        check(out.shape[0] == BATCH_PAIRS, f"phase I {form}: {out.shape}")
        recs[form].append(rec)
        outs[form] = out
    agree = []
    for got, ref in zip(outs["batched"], outs["sequential"]):
        diff = np.abs(port.to_numpy(got).astype(np.int16)
                      - port.to_numpy(ref).astype(np.int16))
        agree.append({"same_share": float((diff == 0).mean()),
                      "max_abs_diff": int(diff.max())})
    emit({"phase": "I", "pairs": BATCH_PAIRS, "canvas": [h, w],
          "flow_alg": cfg.flow_alg, "finest_level": list(finest),
          "expected_launches": expected,
          **{f"{form}_{key}": [r[key] for r in recs[form]]
             for form in recs for key in ("latency_s", "launches",
                                          "max_memory_allocated_bytes")},
          "agreement": agree, "same_share_min": BATCH_SAME_MIN,
          "max_abs_diff_max": BATCH_MAX_DIFF})
    for k, a in enumerate(agree):
        check(a["same_share"] >= BATCH_SAME_MIN
              and a["max_abs_diff"] <= BATCH_MAX_DIFF,
              f"phase I pair {k}: batched against sequential {a}")
    for name in FUSED_PATH:
        check(recs["batched"][-1]["launches"][name] > 0,
              f"phase I: {name} never launched")
    return recs["batched"][-1]["launches"]


def tiled_cases(dev, headline=None) -> list[dict]:
    """Phase J's pairs: J1 the composed 2250 x 1000 stitch_four pair on the
    full canvas with pixflow_low; with ``headline`` (the 9000 x 4000 set's
    first two photos and top, on the host) also J2, the chain's second pair
    window with pixflow_low_fast (its left canvas and the chain's panorama
    after the first pair, made here)."""
    import panorama_opticalflow_tpu_torch as port
    from panorama_opticalflow_tpu_torch.models import pipeline
    from panorama_opticalflow_tpu_torch.parallel import tiled

    h, w = FOUR
    cfg = port.StitchConfig(flow_alg=FOUR_ALG)
    il, ir = pipeline.compose_four(
        [port.to_torch(p, dev)
         for p in port.synthesize_four_input_set(h, w, seed=0)])
    cases = [dict(case="J1", pair=(il, ir), cfg=cfg, window=None,
                  flow_windows=full_canvas_flow_window(w, cfg), hw=(h, w))]
    if headline is not None:
        p0, p1, top = (t.to(dev) for t in headline)
        fast = port.StitchConfig(flow_alg="pixflow_low_fast")
        r0 = pipeline.stitch_pair_windowed(p0, top, *HEADLINE_WINDOWS[0],
                                           fast)
        cases.append(dict(case="J2", pair=(p1, r0), cfg=fast,
                          window=HEADLINE_WINDOWS[1],
                          flow_windows=[HEADLINE_WINDOWS[1]], hw=HEADLINE))
        del p0, top
    for c in cases:
        c["tc"] = tiled.TileConfig.for_params(c["cfg"].flow_params)
    return cases


def tiled_runs(c, n: int, comm=None) -> dict:
    """The untiled and the tiled stitch of one phase J case."""
    from panorama_opticalflow_tpu_torch.models import pipeline
    from panorama_opticalflow_tpu_torch.parallel import tiled

    il, ir = c["pair"]

    def untiled():
        if c["window"] is None:
            return pipeline.stitch_pair(il, ir, c["cfg"])
        return pipeline.stitch_pair_windowed(il, ir, *c["window"], c["cfg"])

    def tiled_form():
        return tiled.tiled_stitch_pair(il, ir, c["cfg"], n, comm, c["tc"],
                                       window=c["window"], device=il.device)

    return {"untiled": untiled, "tiled": tiled_form}


def agreement(out, ref) -> dict:
    inner = slice(TILED_INNER, -TILED_INNER)
    return {"ssim_inner": ssim_card(out[inner], ref[inner]),
            "same_share_inner": (out[inner] == ref[inner]).double().mean()
            .item()}


def phase_j(dev, headline) -> dict:
    """The in-process row-tiled stitch at n = TILED_N against the untiled
    stitch, then phase K of each case's tiled program; returns J1's tiled
    launch counts."""
    import torch

    from panorama_opticalflow_tpu_torch.models import pixflow
    from panorama_opticalflow_tpu_torch.parallel import tiled

    launches = None
    for c in tiled_cases(dev, headline):
        h, w = c["hw"]
        params = c["cfg"].flow_params
        fw = c["flow_windows"][0][1]
        sizes = pixflow.pyramid_sizes(int(h * params.downscale_factor),
                                      int(fw * params.downscale_factor),
                                      params)
        split = tiled.tiled_levels(sizes, TILED_N, c["tc"])
        expected = {
            "untiled": expected_launches(c["flow_windows"], h, params),
            "tiled": expected_launches(c["flow_windows"], h, params,
                                       (TILED_N, c["tc"]))}
        forms = tiled_runs(c, TILED_N)
        for form in forms.values():
            warm_up(form)
        outs, recs = {}, {"untiled": [], "tiled": []}
        for form in ("untiled", "tiled", "tiled", "untiled"):
            out, rec = drive_run(forms[form], list(c["pair"]), warm=False)
            check_run(f"phase J {c['case']} {form}", out, rec,
                      expected[form], h, w)
            recs[form].append(rec)
            outs[form] = out
        agree = agreement(outs["tiled"], outs["untiled"])
        emit({"phase": "J", "case": c["case"], "canvas": [h, w],
              "flow_alg": c["cfg"].flow_alg, "window": c["window"],
              "tiles": TILED_N, "in_process": True,
              "flow_level_rows": [s[0] for s in sizes],
              "tiled_levels": sum(split), "whole_levels": len(split)
              - sum(split), "level_halo": c["tc"].level_halo,
              "min_tiled_rows": c["tc"].min_tiled_rows,
              "tile_rows_finest": -(-sizes[0][0] // TILED_N),
              "expected_launches": expected,
              **{f"{form}_{key}": [r[key] for r in recs[form]]
                 for form in recs for key in ("latency_s", "launches",
                                              "max_memory_allocated_bytes")},
              **agree, "ssim_min": TILED_SSIM_MIN,
              "same_share_min": TILED_SAME_MIN})
        check(agree["ssim_inner"] >= TILED_SSIM_MIN
              and agree["same_share_inner"] > TILED_SAME_MIN,
              f"phase J {c['case']}: tiled against untiled {agree}")
        for name in FUSED_PATH:
            check(recs["tiled"][-1]["launches"][name] > 0,
                  f"phase J {c['case']}: {name} never launched")
        if launches is None:
            launches = recs["tiled"][-1]["launches"]
        del outs
        program_cell(f"tiled_{c['case']}", forms["tiled"], list(c["pair"]),
                     expected["tiled"], (h, w))
        del forms, c
        torch.cuda.empty_cache()
    if torch.cuda.device_count() >= 2:
        distributed(dev)
    else:
        emit({"phase": "J", "distributed": "skipped: 1 GPU"})
    return launches


def _nccl_rank(rank: int, world: int, port: int, out_path: str) -> None:
    """One rank of phase J's NCCL run: J1's tiled stitch on card
    ``rank``."""
    import numpy as np
    import torch

    from panorama_opticalflow_tpu_torch.parallel import mesh

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world))
    comm = mesh.maybe_init_distributed(timeout_s=300)
    check(isinstance(comm, mesh.DistributedRows), "no NCCL group")
    dev = torch.device("cuda", rank)
    c = tiled_cases(dev)[0]
    run = tiled_runs(c, world, comm)["tiled"]
    run()    # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    if rank == 0:
        np.savez(out_path, out=out.cpu().numpy(), latency_s=latency)
    torch.distributed.destroy_process_group()


def distributed(dev) -> None:
    """Phase J1 with one torch.distributed rank a card under NCCL, against
    the in-process form on card 0: every byte equal, as the gloo ranks of
    tests/test_torch_tiled.py are."""
    import socket
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    world = min(TILED_N, torch.cuda.device_count())
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.npz")
        mp.spawn(_nccl_rank, args=(world, port, path), nprocs=world)
        got = np.load(path)
        out, latency = torch.from_numpy(got["out"]).to(dev), \
            float(got["latency_s"])
    c = tiled_cases(dev)[0]
    runs = tiled_runs(c, world)
    one_card = {}
    for form in ("tiled", "untiled"):
        _, rec = drive_run(runs[form], list(c["pair"]), warm=True)
        one_card[form] = rec["latency_s"]
    ref = runs["tiled"]()
    equal = bool(torch.equal(out, ref))
    emit({"phase": "J", "distributed": "nccl", "ranks": world,
          "case": "J1", "latency_s": latency,
          "one_card_latency_s": one_card, **agreement(out, ref),
          "equal_to_in_process": equal})
    check(equal, "phase J distributed: the NCCL ranks' stitch differs "
                 "from the in-process one")


# the hand-written kernels' symbols as the profiler names them, and the
# launch counters of each (one symbol serves both relax variants)
KERNEL_SYMBOLS = {"warp_tiled_kernel<": ("warp_tiled",),
                  "relax_phase_kernel<": ("relax_phase",
                                          "relax_phase_unfused"),
                  "median5_diffuse_kernel<": ("median5_diffuse",),
                  "median5_kernel<": ("median5",),
                  "exact_level_kernel(": ("exact_level",),
                  "novel_view_kernel<": ("novel_view",),
                  "eight_ray_kernel(": ("blend_distances",),
                  "hole_composite_kernel(": ("hole_composite",)}


def profiled_launches(rows, counted: dict, expected: dict, tag: str) -> dict:
    """Each hand-written kernel's launches as the profiler saw them on the
    card, held against the wrappers' counters of the same run and against
    ``expected``: a replay's counts are the capture's, so this is what
    shows that the graph ran each kernel node once."""
    seen = {}
    for symbol, names in KERNEL_SYMBOLS.items():
        seen[symbol[:-1]] = n = sum(c for name, _, c in rows
                                    if symbol in name)
        check(n == sum(counted[k] for k in names) ==
              sum(expected[k] for k in names),
              f"{tag}: {symbol[:-1]} ran {n} times on the card, counted "
              f"{[counted[k] for k in names]}, expected "
              f"{[expected[k] for k in names]}")
    return seen


def program_cell(cell: str, run, inputs, expected: dict, hw) -> None:
    """Phase K for one cell: ``run()`` is its entry point's call, a program
    on the card.  After programs.clear(), its key's first call (eager, with
    the kernels and caches of earlier phases warm) and second call
    (capture, instantiation, first replay); then programs.disable() against
    the program in turns (eager, program, program, eager); the memory the
    held program keeps; one profiled replay, whose kernel launches on the
    card are held against the counters and expected_launches.  Gate:
    every byte equal, launches as expected in both forms."""
    import torch

    from panorama_opticalflow_tpu_torch.ops import kernels
    from panorama_opticalflow_tpu_torch.utils import programs, trace

    def eager():
        with programs.disable():
            return run()

    programs.clear()
    torch.cuda.empty_cache()
    with trace.recording() as rec:
        first_call_s, capture_call_s = warm_up(run)
    (costs,) = programs.info()
    # the capture and the graph's instantiation, the span program.capture
    capture_s = sum(s.end_ns - s.start_ns for s in rec.spans
                    if s.name == "program.capture") / 1e9
    outs, recs = {}, {"eager": [], "program": []}
    forms = {"eager": eager, "program": run}
    for form in ("eager", "program", "program", "eager"):
        out, rec = drive_run(forms[form], inputs, warm=False)
        check_run(f"phase K {cell} {form}", out, rec, expected, *hw)
        if form in outs:
            check(torch.equal(out, outs[form]),
                  f"phase K {cell}: two {form} runs differ")
        recs[form].append(rec)
        outs[form] = out
    same = (outs["program"] == outs["eager"]).double().mean().item()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    kernels.reset_launch_counts()
    prof = device_profile(run)
    counted = {k.__name__: k.launches for k in kernels.KERNELS}
    on_card = profiled_launches(prof["rows"], counted, expected,
                                f"phase K {cell} profiled replay")
    latency = sorted(r["latency_s"] for r in recs["program"])[0]
    emit({"phase": "K", "cell": cell, "first_call_s": first_call_s,
          "capture_call_s": capture_call_s,
          "capture_s": capture_s,
          "constants_held": costs["constants"],
          **{f"{form}_{key}": [r[key] for r in recs[form]]
             for form in recs for key in ("latency_s",
                                          "max_memory_allocated_bytes",
                                          "launches")},
          "expected_launches": expected,
          "replay_launches_on_card": on_card,
          "reserved_bytes_with_program_held": held,
          "replay_device_ms": prof["device_ms"],
          "graph_device_ops": prof["device_ops"],
          "replay_host_calls": prof["host_calls"],
          "replay_idle_share": 1 - prof["device_ms"] / 1e3 / latency,
          "same_share": same})
    check(same == 1.0, f"phase K {cell}: program against eager, "
                       f"{same} of the bytes equal")
    del outs
    programs.clear()
    torch.cuda.empty_cache()


def phase_k_chains(dev, photos_d, top_d) -> None:
    """Phase K for cells 1 and 2: stitch_six at 9000 x 4000 with
    pixflow_low_fast and pixflow_low."""
    import panorama_opticalflow_tpu_torch as port
    from panorama_opticalflow_tpu_torch.models import pipeline

    h = HEADLINE[0]
    for alg in ("pixflow_low_fast", "pixflow_low"):
        cfg = port.StitchConfig(flow_alg=alg)
        program_cell(alg, lambda cfg=cfg: pipeline.stitch_six(
                         photos_d, top_d, cfg, device=dev),
                     [top_d, *photos_d],
                     expected_launches(HEADLINE_WINDOWS, h, cfg.flow_params),
                     HEADLINE)


def phase_k_pairs(dev) -> None:
    """Phase K for phase H's stitch_four and phase I's eight batched
    pairs."""
    import panorama_opticalflow_tpu_torch as port
    from panorama_opticalflow_tpu_torch.models import pipeline

    h, w = FOUR
    cfg = port.StitchConfig(flow_alg=FOUR_ALG)
    expected = expected_launches(full_canvas_flow_window(w, cfg), h,
                                 cfg.flow_params)
    photos = [port.to_torch(p, dev)
              for p in port.synthesize_four_input_set(h, w, seed=0)]
    program_cell("stitch_four", lambda: pipeline.stitch_four(
                     photos, cfg, device=dev),
                 list(pipeline.compose_four(photos)), expected, FOUR)
    ls, rs = batch_pairs(dev)
    program_cell(f"stitch_pairs_of_{BATCH_PAIRS}",
                 lambda: pipeline.stitch_pairs(ls, rs, cfg, device=dev),
                 [ls, rs], expected, FOUR)


STAGE_LINE = re.compile(r"(\w+) finished! RUNTIME \(sec\) = ([0-9.]+)")
TOTAL_LINE = re.compile(r"TotalRunTime \(sec\) = ([0-9.]+)")


def cli_run(root: str, argv: list[str]) -> dict:
    """One CLI process of the package in ``root``: its stage seconds and
    total (its own StageTimer lines; a stitch prints them) and the
    process's wall seconds."""
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "panorama_opticalflow_tpu_torch.cli", *argv],
        cwd=root, env={**os.environ, "PYTHONPATH": root},
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(done.returncode == 0,
          f"CLI {argv[0]} in {root}: exit {done.returncode}: "
          f"{done.stderr[-2000:]}")
    out = done.stdout + done.stderr
    total = TOTAL_LINE.search(out)
    return {"stages_s": {m.group(1): float(m.group(2))
                         for m in STAGE_LINE.finditer(out)},
            "total_s": float(total.group(1)) if total else None,
            "wall_s": wall}


def cli_against(other: str) -> None:
    """The CLI of the package in ``other`` and of this one, a fresh
    process a stitch, in turns (other, this, this, other) after one
    process each that builds its kernels: stitch6 of the 9000x4000
    synthetic set with pixflow_low_fast (cell 1) and stitch4 of the
    2250x1000 four-input set with pixflow_low."""
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    data = os.path.join(here, "build", "cli_data")
    h, w = HEADLINE
    sets = {"stitch6": (os.path.join(data, "six"), ["--height", str(h),
                                                    "--width", str(w)]),
            "stitch4": (os.path.join(data, "four"),
                        ["--height", str(FOUR[0]), "--width", str(FOUR[1]),
                         "--four"])}
    t0 = time.perf_counter()
    for d, size in sets.values():
        cli_run(here, ["synth", "--test_dir", d, *size])
    argv = {"stitch6": ["stitch6", "--test_dir", sets["stitch6"][0],
                        "--top_img", "top.tif",
                        "--flow_alg", "pixflow_low_fast"],
            "stitch4": ["stitch4", "--test_dir", sets["stitch4"][0],
                        "--flow_alg", FOUR_ALG]}
    emit({"phase": "cli", "setup_s": time.perf_counter() - t0,
          "other": other})
    for root in (other, here):
        cli_run(root, argv["stitch4"])     # builds the kernels
    for cmd in ("stitch6", "stitch4"):
        runs = {"other": [], "this": []}
        for form in ("other", "this", "this", "other"):
            runs[form].append(cli_run(other if form == "other" else here,
                                      argv[cmd]))
        emit({"phase": "cli", "command": cmd, **runs})


def main() -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--time-against", metavar="CSRC",
                      help="time every kernel against the sources in CSRC")
    mode.add_argument("--cli-against", metavar="ROOT",
                      help="time the CLI of the package in ROOT against "
                           "this one's, a fresh process a stitch")
    mode.add_argument("--profile", metavar="WHAT",
                      help="torch.profiler over one stitch: a preset name "
                           "(9000x4000 stitch_six), stitch4, batched or "
                           "tiled")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()

    phase_a(smi)
    if args.time_against or args.profile or args.cli_against:
        if args.time_against:
            time_against(args.time_against, dev)
        elif args.cli_against:
            cli_against(args.cli_against)
        else:
            profile_what(args.profile, dev)
        print(smi, flush=True)
        return
    results = phase_b(dev)
    photos_d, top_d, setup_s = headline_set(dev)
    launches_c, pair = phase_c(dev, photos_d, top_d, setup_s)
    torch.cuda.empty_cache()
    phase_d(pair)
    del pair
    torch.cuda.empty_cache()
    phase_e(dev)
    launches_f = phase_f(dev, photos_d, top_d)
    launches_g = phase_g(dev, photos_d, top_d)
    phase_k_chains(dev, photos_d, top_d)
    # phase J's second pair, kept on the host meanwhile
    headline = tuple(t.cpu() for t in (photos_d[0], photos_d[1], top_d))
    del photos_d, top_d
    torch.cuda.empty_cache()
    launches_h = phase_h(dev)
    launches_i = phase_i(dev)
    phase_k_pairs(dev)
    torch.cuda.empty_cache()
    launches_j = phase_j(dev, headline)
    counts = [launches_c, *launches_f.values(), launches_g, launches_h,
              launches_i, launches_j]
    launches = {name: sum(c[name] for c in counts) for name in KERNEL_FILES}
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on a main path")

    # one stitch of each preset, as counted in phase C and in phase F's
    # production run (each checked against expected_launches there)
    per_stitch = {"pixflow_low_fast": launches_c,
                  "pixflow_low": launches_f["production"],
                  "stitch_four": launches_h,
                  "stitch_pairs_of_8": launches_i,
                  "tiled_pair_n4": launches_j}
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": "panorama_opticalflow_tpu_torch/" + KERNEL_FILES[name][0],
         "replaces": ("panorama_opticalflow_tpu/ops/pallas/kernels.py:"
                      f"{KERNEL_FILES[name][1]}" if KERNEL_FILES[name][1]
                      else "none: kernel work beyond the JAX package"),
         "launches": launches[name],
         "launches_per_stitch": {alg: n[name]
                                 for alg, n in per_stitch.items()},
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "bound_ms_no_fma": r["bound_ms_no_fma"],
         "library_ms": r["library_ms"]}
        for name, r in results.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
