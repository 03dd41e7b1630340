"""Kernel rooflines: the chip's published peaks, the work of a kernel's
call counted from its shapes, and its device time from the profiler's
trace.

A share is the least time the card could take for the call's work (its
bytes at the memory rate or its operations at the float32 rate,
whichever is longer) over the measured time, in percent.  The counts are
of the call's work, not of an implementation: every input byte read
once, every output byte written once, and the operations of the
least-work form of the arithmetic.  Frozen from the port's smoke run
(``chip_smoke.py``: ``bound``, ``WARP_OPS``, ``RELAX_OPS_PER_ITER`` and the
byte counts of ``kernel_cases``)."""

from __future__ import annotations

import math

# one H100 SXM at its 700 W limit (NVIDIA's data sheet): device memory
# rate, float32 rate outside the tensor cores (a fused multiply-add
# counted as two operations)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# L2 is 50 MB: a buffer this large is written between two timed launches
FLUSH_BYTES = 64 << 20

# operations a pixel, one for every multiply, add, compare, min/max,
# floor, sqrt and divide:
#   warp, two channels: the y residual and its two hat weights 12, at each
#     of two rows the x residual and its weights 12, a channel two x sums
#     and a y sum of (2 mul + 1 add) 9;
#   relax, an iteration: x pass A 18 (offset, two weights, two sums); pass
#     A 5 candidates x (y weights 9, two sums 6, error 20, compare 1) + 3;
#     x pass B 30 (hat and dhat sums); descent 75; the fused relax adds
#     the separable blur of the two target planes, 2 x 2 x width x 2
WARP_OPS = 12 + 2 * 12 + 2 * 9
RELAX_OPS_PER_ITER = 18 + (5 * 36 + 3) + 30 + 75
WARP_TILE = (64, 128)


def warp_work(b: int, h: int, w: int) -> tuple[int, int]:
    """(bytes, operations) of a two-channel warp of (b, h, w) planes:
    image and flow in, image out, and the per-tile offsets."""
    px = b * h * w
    tiles = math.ceil(h / WARP_TILE[0]) * math.ceil(w / WARP_TILE[1])
    return 4 * (6 * px + 2 * b * tiles), WARP_OPS * px


def relax_work(b: int, h: int, w: int, iters: int,
               blur_width: int) -> tuple[int, int]:
    """(bytes, operations) of the fused relax phase on (b, h, w) planes:
    nine planes in, two out."""
    px = b * h * w
    return 4 * 11 * px, (iters * RELAX_OPS_PER_ITER
                         + 2 * 2 * blur_width * 2) * px


def bound_seconds(nbytes: int, ops: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def traced_seconds(fn, reps: int = 20) -> float | None:
    """Median device seconds of ``fn()`` on the current stream, each call
    timed from the profiler's trace with L2 flushed before it, after one
    untimed call."""
    import torch

    from portbench import devtrace

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    return devtrace.call_seconds(fn, reps, flush.zero_,
                                 torch.cuda.synchronize)


def _planes(gen, shape, scale, device):
    import torch

    return torch.randn(shape, generator=gen, device=device) * scale


def kernel_share(kernel: str, planes, flow_alg: str, seed: int,
                 device) -> float | None:
    """The share of its roofline, in percent, of the port's wrapper of
    ``kernel`` (``warp_tiled`` or ``relax_phase``) on seeded (b, h, w)
    planes, with the preset's iterations, hat window and blur width;
    None off the card."""
    if device.type != "cuda":
        return None
    import torch

    from panorama_opticalflow_tpu_torch import flow_params_by_name
    from panorama_opticalflow_tpu_torch.ops import kernels

    b, h, w = planes
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & 0x7FFF_FFFF_FFFF_FFFF)
    params = flow_params_by_name(flow_alg)
    shape = (b, h, w)
    if kernel == "warp_tiled":
        yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
        xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
        field = torch.stack(torch.broadcast_tensors(
            20 * torch.sin(yy / 370.0) + 5 * torch.cos(xx / 530.0),
            8 * torch.cos(yy / 290.0) - 3 * torch.sin(xx / 410.0)), -1)
        flow = (field + _planes(gen, (b, h, w, 2), 0.3, device)).contiguous()
        img = _planes(gen, (b, h, w, 2), 1.0, device)
        seconds = traced_seconds(lambda: kernels.warp_tiled(img, flow))
        nbytes, ops = warp_work(b, h, w)
    elif kernel == "relax_phase":
        iters, window = params.relax_iters_per_phase, params.fast_window
        fx, fy = _planes(gen, shape, 0.5, device), _planes(gen, shape, 0.5,
                                                           device)
        mask = (torch.rand(shape, generator=gen, device=device)
                > 0.1).float()
        rp = [fx, fy, fx + _planes(gen, shape, 0.1, device),
              fy + _planes(gen, shape, 0.1, device)]
        rp += [_planes(gen, shape, 0.1, device) for _ in range(4)] + [mask]
        seconds = traced_seconds(lambda: kernels.relax_phase(
            *rp, params, iters, window))
        nbytes, ops = relax_work(b, h, w, iters,
                                 params.blurred_flow_kernel_width)
    else:
        raise ValueError(f"no roofline for kernel {kernel!r}")
    if seconds is None:
        return None
    return 100.0 * bound_seconds(nbytes, ops) / seconds


def cell_share(run, kernel: str) -> float | None:
    """``kernel_share`` at the planes the cell's configuration names for
    the kernel (its finest kernel level), with its preset and the seed."""
    planes = run.config.get("roofline_planes", {}).get(kernel)
    if planes is None:
        return None
    return kernel_share(kernel, planes, run.config["flow_alg"], run.seed,
                        run.device)
