#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from panorama_opticalflow_tpu_torch/
csrc/, then runs nine phases and prints one JSON object per phase line:

  A  the card (nvidia-smi name and power limit) and the kernel build;
  B  each of the five kernels against its plain PyTorch version on the
     card, at the 9000x4000 headline's finest-level shapes, at a middle
     level of its pyramid and at a ragged small shape, with kernel and
     plain median times (CUDA events; the kernel table keeps the finest
     level's), the kernel's bound (bytes at the memory rate or operations at the float32
     peak, whichever is longer) and, for the warp, the time of
     F.grid_sample on the same inputs; the unfused relax at 2 and 3
     iterations; and the three fused-path kernels at the finest level of
     phase I's pyramid with its leading 16 directions (medians: 32 planes);
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
     pair the share of equal bytes (>= 0.98) and the 99.9th percentile of
     the absolute difference (<= 8).

Every timed stitch (C, F, G, H, I) runs with the launch counts set to 0 just
before it and read just after; the kernel table sums those counts.  Then a
line with the kernel table, a line with nvidia-smi's name and power
limit, and as the last line {"ok": true, "device": {...}}.  Any failed
check raises, so the exit code is non-zero and no result line is printed.
It needs one CUDA card and exits non-zero at once without one.  Float32
everywhere: TF32 is switched off for matmuls and cuDNN before any work.

Two shorter modes for work on the kernels, each after phase A:

    python3 chip_smoke.py --time-against CSRC    every kernel of this tree
        and of the sources in CSRC (an earlier commit's csrc/) on the same
        inputs, in turns: other, this, this, other
    python3 chip_smoke.py --profile WHAT         torch.profiler over one
        warm stitch: device time by kernel, launches, idle share.  WHAT is
        a preset name (the 9000x4000 stitch_six), stitch4 (phase H's
        stitch) or batched (phase I's 8 pairs, batched and one pair of the
        sequential form, and the launches of each stage in both forms)
"""

from __future__ import annotations

import dataclasses
import json
import os
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
BATCH_SAME_MIN = 0.98
BATCH_P999_MAX = 8
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
WARP_OPS = 12 + 2 * 12 + 2 * 9
RELAX_OPS_PER_ITER = 18 + (5 * 36 + 3) + 30 + 75
MEDIAN_OPS = 2 * 9 + 13 + 36


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
    the tolerance, the bytes and operations of the bound, and for the warp
    the one PyTorch call that computes the same function (``library``),
    the torch ops its wrapper runs before the launch (``glue``) and the
    wrapper's call on offsets made before (``launch``).  A ``check_only``
    case is held against its plain version and not timed."""
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
    for tag, (b, h, w) in B_SHAPES + (B_BATCHED,):
        for case in kernel_cases(dev, rng, b, h, w):
            name = case["name"]
            if tag == "batched" and (name not in FUSED_PATH
                                     or case.get("check_only")):
                continue
            got = as_tensor(case["kernel"]())
            torch.cuda.synchronize()
            diff = (got - as_tensor(case["plain"]())).abs()
            err = diff.max().item()
            rec = {"phase": "B", "kernel": name, "shape": tag,
                   "dims": case["dims"], "max_abs_err": err,
                   "tol": case["tol"]}
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
            if tag in B_TIMED and not case.get("check_only"):
                timed = {"ms": cuda_ms(case["kernel"], 20),
                         "plain_ms": cuda_ms(case["plain"], 5),
                         "library_ms": None,
                         **bound(case["nbytes"], case["ops"])}
                if "library" in case:
                    timed["library_ms"] = cuda_ms(case["library"], 20)
                    # equal where the residual stays inside its clamp
                    timed["library_max_abs_diff"] = \
                        (got - case["library"]()).abs().max().item()
                if "glue" in case:
                    timed["glue_ms"] = cuda_ms(case["glue"], 20)
                    timed["launch_ms"] = cuda_ms(case["launch"], 20)
                rec.update(timed)
                if tag == "headline":   # the kernel table's shape
                    results[name].update(timed)
            results[name]["max_abs_err"] = max(err,
                                               results[name]["max_abs_err"])
            emit(rec)
            check(ok, f"{name} {tag}: {rec}")
            del got, diff
        torch.cuda.empty_cache()
    return results


def time_against(other_csrc: str, dev) -> None:
    """Every kernel of this tree and of the sources in ``other_csrc`` (an
    earlier commit's csrc/, same C interface) on the same inputs, timed in
    turns (other, this, this, other) within one process on one card."""
    import numpy as np
    import torch

    from panorama_opticalflow_tpu_torch.ops import build

    libs = {"other": build.open_library(os.path.abspath(other_csrc)),
            "this": build.load()}
    rng = np.random.default_rng(0)
    for tag, (b, h, w) in B_SHAPES:
        for case in kernel_cases(dev, rng, b, h, w):
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
                  "iters": case.get("iters"), "other_ms": times["other"],
                  "this_ms": times["this"],
                  "bit_same_share": (outs["this"] == outs["other"])
                  .float().mean().item(),
                  "max_abs_diff": (outs["this"] - outs["other"]).abs()
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


def profile_run(what: str, run, **more) -> None:
    """torch.profiler over one warm ``run()``: device time by kernel name,
    the launch count and the card's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled = time.perf_counter() - t0
    rows = device_rows(prof)
    device_ms = sum(r[1] for r in rows)
    emit({"phase": "profile", "what": what, **more,
          "latency_s_unprofiled": latency, "latency_s_profiled": profiled,
          "device_ms": device_ms, "launches": sum(r[2] for r in rows),
          "idle_share_of_unprofiled": 1 - device_ms / 1e3 / latency,
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


def expected_launches(windows, canvas_h: int, params) -> dict:
    """Kernel launches of one chain.  Per fast level the warp runs once per
    phase; a level of at least pallas_min_pixels runs the fused relax and
    median5+diffuse once if it is a single-phase fused level, else the
    unfused relax and median5 once per phase.  With a raised pyramid floor
    (_fast) every level of pyramid_sizes is a fast level; otherwise the
    coarsest is exact."""
    from panorama_opticalflow_tpu_torch.models import pixflow

    phases = params.relax_phases
    fused = phases == 1 and params.fuse_level_blurs
    n = dict.fromkeys(KERNEL_FILES, 0)
    for _, width, _ in windows:
        sizes = pixflow.pyramid_sizes(int(canvas_h * params.downscale_factor),
                                      int(width * params.downscale_factor),
                                      params)
        fast = sizes if params.pyr_stop_size else sizes[:-1]
        big = sum(h * w >= params.pallas_min_pixels for h, w in fast)
        n["warp_tiled"] += phases * len(fast)
        if fused:
            n["relax_phase"] += big
            n["median5_diffuse"] += big
        else:
            n["relax_phase_unfused"] += phases * big
            n["median5"] += phases * big
    return n


def drive_run(run, inputs, warm: bool):
    """One timed ``run()`` (after a warm one if ``warm``), with the launch
    counts and the peak memory reset just before it and read just after.
    Returns the output and a record of the measurements, including
    whether the output's alpha footprint is exactly the union of the
    footprints of ``inputs`` (canvases, or stacks of canvases)."""
    import torch

    from panorama_opticalflow_tpu_torch.ops import kernels

    rec = {}
    if warm:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        rec["warm_s"] = time.perf_counter() - t0
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
        out, rec = drive(photos_d, top_d, cfg, dev, warm=prod is None)
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
    forms["batched"]()   # warm (phase H warmed the sequential form's ops)
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
                      "p999_abs_diff": float(np.percentile(diff, 99.9)),
                      "max_abs_diff": int(diff.max())})
    emit({"phase": "I", "pairs": BATCH_PAIRS, "canvas": [h, w],
          "flow_alg": cfg.flow_alg, "finest_level": list(finest),
          "expected_launches": expected,
          **{f"{form}_{key}": [r[key] for r in recs[form]]
             for form in recs for key in ("latency_s", "launches",
                                          "max_memory_allocated_bytes")},
          "agreement": agree, "same_share_min": BATCH_SAME_MIN,
          "p999_abs_diff_max": BATCH_P999_MAX})
    for k, a in enumerate(agree):
        check(a["same_share"] >= BATCH_SAME_MIN
              and a["p999_abs_diff"] <= BATCH_P999_MAX,
              f"phase I pair {k}: batched against sequential {a}")
    for name in FUSED_PATH:
        check(recs["batched"][-1]["launches"][name] > 0,
              f"phase I: {name} never launched")
    return recs["batched"][-1]["launches"]


def main() -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--time-against", metavar="CSRC",
                      help="time every kernel against the sources in CSRC")
    mode.add_argument("--profile", metavar="WHAT",
                      help="torch.profiler over one stitch: a preset name "
                           "(9000x4000 stitch_six), stitch4 or batched")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()

    phase_a(smi)
    if args.time_against or args.profile:
        if args.time_against:
            time_against(args.time_against, dev)
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
    del photos_d, top_d
    torch.cuda.empty_cache()
    launches_h = phase_h(dev)
    launches_i = phase_i(dev)
    counts = [launches_c, *launches_f.values(), launches_g, launches_h,
              launches_i]
    launches = {name: sum(c[name] for c in counts) for name in KERNEL_FILES}
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on a main path")

    # one stitch of each preset, as counted in phase C and in phase F's
    # production run (each checked against expected_launches there)
    per_stitch = {"pixflow_low_fast": launches_c,
                  "pixflow_low": launches_f["production"],
                  "stitch_four": launches_h,
                  "stitch_pairs_of_8": launches_i}
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": "panorama_opticalflow_tpu_torch/" + KERNEL_FILES[name][0],
         "replaces": "panorama_opticalflow_tpu/ops/pallas/kernels.py:"
                     f"{KERNEL_FILES[name][1]}",
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
