#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from panorama_opticalflow_tpu_torch/
csrc/, then runs five phases and prints one JSON object per phase:

  A  the card (nvidia-smi name and power limit) and the kernel build;
  B  each kernel against its plain PyTorch version on the card, at the
     9000x4000 headline's finest-level shapes and at a ragged small shape,
     with kernel and plain median times (CUDA events);
  C  the main path: stitch_six of the 6-photo 9000x4000 synthetic set
     (seed 0) with pixflow_low_fast, once warm and once timed; latency,
     peak device memory, each kernel's launch count against the count the
     pyramid implies, and an exact check of the output alpha footprint;
  D  compute_optical_flow_pair on a headline pair window (4000x3584) with
     the kernels and with use_pallas=False (the plain path on the card):
     both times and the endpoint error between them;
  E  the port on the card against tests/golden/six_96x320_s7.npz at the
     golden gate of tests/test_golden.py.

Then a line with the kernel table, a line with nvidia-smi's name and power
limit, and as the last line {"ok": true, "device": {...}}.  Any failed
check raises, so the exit code is non-zero and no result line is printed.
It needs one CUDA card and exits non-zero at once without one.  Float32
everywhere: TF32 is switched off for matmuls and cuDNN before any work.
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
HEADLINE = (4000, 9000)
# crop.plan_chain_windows of the seed-0 headline set: (roll, width,
# gather_safe) per pair
HEADLINE_WINDOWS = [(8100, 3584, False), (900, 3584, True),
                    (2700, 3584, True), (4500, 3584, True),
                    (6300, 3584, False)]
KERNEL_FILES = {
    "warp_tiled": ("csrc/warp_tiled.cu", 986),
    "relax_phase": ("csrc/relax_phase.cu", 732),
    "median5_diffuse": ("csrc/median5_diffuse.cu", 321),
}


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


def phase_b(dev) -> dict:
    """Each kernel against its plain version at a ragged shape and at the
    headline finest-level shapes; returns {kernel: {max_abs_err, ms,
    plain_ms}}."""
    import numpy as np
    import torch

    from panorama_opticalflow_tpu_torch import flow_params_by_name
    from panorama_opticalflow_tpu_torch.ops import kernels

    params = flow_params_by_name("pixflow_low_fast")
    iters, D = params.relax_iters_per_phase, params.fast_window
    rng = np.random.default_rng(0)

    def planes(shape, scale=0.1):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32) * scale).to(dev)

    def smooth_flow(b, h, w):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        f = np.stack([20 * np.sin(yy / 370.0) + 5 * np.cos(xx / 530.0),
                      8 * np.cos(yy / 290.0) - 3 * np.sin(xx / 410.0)], -1)
        f = f + rng.standard_normal(f.shape).astype(np.float32) * 0.3
        return torch.from_numpy(np.stack([f] * b).astype(np.float32)).to(dev)

    results = {name: {"max_abs_err": 0.0} for name in KERNEL_FILES}

    def record(name, tag, dims, err, tol, kernel_fn, plain_fn, extra=()):
        rec = {"phase": "B", "kernel": name, "shape": tag, "dims": dims,
               "max_abs_err": err, "tol": tol, **dict(extra)}
        if tag == "headline":
            rec["ms"] = cuda_ms(kernel_fn, 20)
            rec["plain_ms"] = cuda_ms(plain_fn, 5)
            results[name].update(ms=rec["ms"], plain_ms=rec["plain_ms"])
        results[name]["max_abs_err"] = max(err,
                                           results[name]["max_abs_err"])
        emit(rec)

    # ragged, then the finest level of a 4000 x 3584 pair window
    for tag, (b, h, w) in (("ragged", (2, 45, 203)),
                           ("headline", (2, 2000, 1792))):
        img = planes((b, h, w, 2), 1.0)
        flow = smooth_flow(b, h, w)
        got = kernels.warp_tiled(img, flow)
        torch.cuda.synchronize()
        err = (got - kernels.warp_tiled_plain(img, flow)).abs().max().item()
        record("warp_tiled", tag, [b, h, w, 2], err, WARP_TOL,
               lambda: kernels.warp_tiled(img, flow),
               lambda: kernels.warp_tiled_plain(img, flow))
        check(err <= WARP_TOL, f"warp_tiled {tag}: {err} > {WARP_TOL}")

        x = planes((2 * b, h, w), 0.5)
        c = torch.from_numpy(rng.random((b, h, w), np.float32)).to(dev)
        got = kernels.median5_diffuse(x, c)
        torch.cuda.synchronize()
        err = (got - kernels.median5_diffuse_plain(x, c)).abs().max().item()
        record("median5_diffuse", tag, [2 * b, h, w], err, MEDIAN_TOL,
               lambda: kernels.median5_diffuse(x, c),
               lambda: kernels.median5_diffuse_plain(x, c))
        check(err <= MEDIAN_TOL, f"median5_diffuse {tag}: {err}")

        shape = (b, h, w)
        fx, fy = planes(shape, 0.5), planes(shape, 0.5)
        mask = torch.from_numpy(
            (rng.random(shape) > 0.1).astype(np.float32)).to(dev)
        rp = [fx, fy, fx + planes(shape), fy + planes(shape), planes(shape),
              planes(shape), planes(shape), planes(shape), mask]
        got = torch.stack(kernels.relax_phase(*rp, params, iters, D))
        torch.cuda.synchronize()
        ref = torch.stack(kernels.relax_phase_fused_plain(*rp, params, iters,
                                                          D))
        diff = (got - ref).abs().amax(dim=0)
        err = diff.max().item()
        share = (diff > RELAX_TOL).float().mean().item()
        record("relax_phase", tag, list(shape), err, RELAX_TOL,
               lambda: kernels.relax_phase(*rp, params, iters, D),
               lambda: kernels.relax_phase_fused_plain(*rp, params, iters,
                                                       D),
               (("share_over_tol", share), ("max_share", RELAX_MAX_SHARE)))
        check(share < RELAX_MAX_SHARE, f"relax_phase {tag}: share {share}")
        del img, flow, got, ref, x, c, rp, diff
    torch.cuda.empty_cache()
    return results


def expected_launches(windows, canvas_h: int, params) -> dict:
    """Kernel launches of one chain: the warp once per fast level, the
    relax and median5+diffuse kernels once per fused level (H*W >=
    pallas_min_pixels).  With a raised pyramid floor (_fast) every level
    of pyramid_sizes is a fast level; otherwise the coarsest is exact."""
    from panorama_opticalflow_tpu_torch.models import pixflow

    warp = fused = 0
    for _, width, _ in windows:
        sizes = pixflow.pyramid_sizes(int(canvas_h * params.downscale_factor),
                                      int(width * params.downscale_factor),
                                      params)
        fast = sizes if params.pyr_stop_size else sizes[:-1]
        warp += len(fast)
        fused += sum(h * w >= params.pallas_min_pixels for h, w in fast)
    return {"warp_tiled": warp, "relax_phase": fused,
            "median5_diffuse": fused}


def phase_c(dev) -> tuple[dict, tuple]:
    """The main path at 9000 x 4000; returns the launch counts and the
    first pair's window inputs for phase D."""
    import torch

    import panorama_opticalflow_tpu_torch as port
    from panorama_opticalflow_tpu_torch.models import crop, pipeline
    from panorama_opticalflow_tpu_torch.models import stitcher
    from panorama_opticalflow_tpu_torch.ops import kernels

    h, w = HEADLINE
    cfg = port.StitchConfig(flow_alg="pixflow_low_fast")
    t0 = time.perf_counter()
    photos, top = port.synthesize_fisheye_set(h, w, n=5, seed=0)
    photos_d = [port.to_torch(p, dev) for p in photos]
    top_d = port.to_torch(top, dev)
    del photos, top
    setup_s = time.perf_counter() - t0
    windows = crop.plan_chain_windows(photos_d, top_d, cfg)
    check(windows == HEADLINE_WINDOWS, f"headline windows {windows}")
    expected = expected_launches(windows, h, cfg.flow_params)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipeline.stitch_six(photos_d, top_d, cfg, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    del out
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipeline.stitch_six(photos_d, top_d, cfg, device=dev)
    torch.cuda.synchronize()
    latency_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated()

    union = top_d[..., 3] > 0
    for p in photos_d:
        union |= p[..., 3] > 0
    footprint_ok = bool(torch.equal(out[..., 3] > 0, union))
    emit({"phase": "C", "canvas": [h, w], "flow_alg": cfg.flow_alg,
          "windows": windows, "setup_s": setup_s, "warm_s": warm_s,
          "latency_s": latency_s, "max_memory_allocated_bytes": peak,
          "launches": launches, "expected_launches": expected,
          "alpha_footprint_exact": footprint_ok,
          "out_shape": list(out.shape), "out_dtype": str(out.dtype)})
    check(tuple(out.shape) == (h, w, 4) and out.dtype == torch.uint8,
          "stitch_six output shape/dtype")
    for name, n in launches.items():
        check(n == expected[name] > 0,
              f"{name}: {n} launches, expected {expected[name]}")
    check(footprint_ok, "output alpha footprint != union of input alphas")

    roll, width, _ = windows[0]
    cmap = stitcher.match_images(photos_d[0], top_d)
    pair = tuple(stitcher.window_cols(stitcher.extract_overlap(img, cmap),
                                      roll, width)
                 for img in (photos_d[0], top_d))
    return launches, pair


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


def phase_e(dev) -> None:
    """The pinned 96 x 320 golden (pixflow_low, seed 7) at the gate of
    tests/test_golden.py::_check."""
    import numpy as np

    import panorama_opticalflow_tpu_torch as port
    from panorama_opticalflow_tpu_torch.models import pipeline

    golden = np.load(os.path.join(ROOT, "tests", "golden",
                                  "six_96x320_s7.npz"))["output"]
    photos, top = port.synthesize_fisheye_set(96, 320, n=5, seed=7)
    out = port.to_numpy(pipeline.stitch_six(
        photos, top, port.StitchConfig(flow_alg="pixflow_low"), device=dev))
    alpha_ok = bool(np.array_equal(out[..., 3], golden[..., 3]))
    s = port.ssim(out, golden)
    off8 = float((np.abs(out.astype(np.int32)
                         - golden.astype(np.int32)) > 8).mean())
    emit({"phase": "E", "golden": "six_96x320_s7", "alpha_exact": alpha_ok,
          "ssim": s, "share_off_by_more_than_8": off8})
    check(alpha_ok and s >= 0.995 and off8 < 0.01, "phase E golden gate")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()

    phase_a(smi)
    results = phase_b(dev)
    launches, pair = phase_c(dev)
    torch.cuda.empty_cache()
    phase_d(pair)
    del pair
    torch.cuda.empty_cache()
    phase_e(dev)

    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": "panorama_opticalflow_tpu_torch/" + KERNEL_FILES[name][0],
         "replaces": "panorama_opticalflow_tpu/ops/pallas/kernels.py:"
                     f"{KERNEL_FILES[name][1]}",
         "launches": launches[name], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, r in results.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
