"""Pixflow: pyramidal coarse-to-fine dense optical flow on tensors (port of
the reference's ``models/pixflow.py``, CPU/PixFlow.hpp:28-457).

Downscale, grey + alpha, pre-blur, a 0.9- (or 0.8-) factor pyramid, and
per level: Jacobi relaxation (4-neighbour propagation + descent), median
filter and low-alpha diffusion; then the final upsample and blur.  One
pyramid descent, ``compute_optical_flow_pairs``, solves N pairs on a
leading batch of 2N (entry 2n + d is direction d of pair n), each
direction as alone; ``compute_optical_flow_pair`` is its N = 1 case and
``compute_optical_flow`` that case's first direction.

The pyramid runs unrolled (the reference's rung scan only shrinks XLA
compiles, and its border padding differs); the port matches the
reference with ``scan_coarse_levels=False``.  The coarsest level (and the
init-floor twin of the ``_fast`` presets) starts from zero flow, or from
the brute-force search init of the ``pixflow_search_*`` presets, and
runs the exact gather path (``ops.relax_exact``; one CUDA kernel,
``kernels.exact_level``, at the sizes a block holds); every other level
the fast path of ``_level_core``: with ``use_pallas`` three kernel
launches a single-phase level, below ``pallas_min_pixels`` bit for bit
the plain branch, which ``use_pallas=False`` runs at every size.

The spans (``utils.trace``): the stages ``pair.flow_prep`` (downscale,
pre-blur and pyramid; then, a second stretch, the final upsample),
``pair.flow_floor_twin`` (the ``_fast`` presets' init-floor twin: its
resizes, init, exact solve and upsample to the coarsest level),
``pair.flow_coarsest``, and the other levels in one stage a run:
``pair.flow_plain_levels`` below ``pallas_min_pixels``,
``pair.flow_kernel_levels`` at or above it; within them a host range
``flow.level`` a level (and a twin size), its size in the range's
arguments.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from panorama_opticalflow_tpu_torch.utils.config import FlowParams
from panorama_opticalflow_tpu_torch.ops import image as im
from panorama_opticalflow_tpu_torch.ops import kernels
from panorama_opticalflow_tpu_torch.ops.relax_exact import (
    _as_planes, _blur_flow, _from_planes, low_alpha_flow_diffusion)
from panorama_opticalflow_tpu_torch.utils import programs, trace


def pyramid_sizes(h: int, w: int, params: FlowParams) -> list[tuple[int, int]]:
    """Level sizes, finest first (CPU/PixFlow.hpp:137-151): scale by the
    pyramid factor (+0.5 rounding) until either side would drop to
    <= pyr_min_image_size (<= pyr_stop_size for the _fast presets)."""
    stop = params.pyr_stop_size or params.pyr_min_image_size
    sizes = [(h, w)]
    while len(sizes) < params.pyr_max_levels:
        ph, pw = sizes[-1]
        nh = int(ph * params.pyr_scale_factor + 0.5)
        nw = int(pw * params.pyr_scale_factor + 0.5)
        if nh <= stop or nw <= stop:
            break
        sizes.append((nh, nw))
    return sizes


def _sub_floor_sizes(h: int, w: int,
                     params: FlowParams) -> list[tuple[int, int]]:
    """Sizes strictly below a raised pyramid floor (pyr_stop_size), down
    to the reference's pyr_min_image_size rule; [] when the floor is not
    raised.  Used by the coarsest-level init-floor solve."""
    if not params.pyr_stop_size or \
            params.pyr_stop_size <= params.pyr_min_image_size:
        return []
    return pyramid_sizes(
        h, w, dataclasses.replace(params, pyr_stop_size=0))[1:]


def _build_pyramid(img: torch.Tensor,
                   sizes: list[tuple[int, int]]) -> list[torch.Tensor]:
    """Progressive linear downscale (each level from the previous one)."""
    pyr = [img]
    for s in sizes[1:]:
        pyr.append(im.resize_planes(pyr[-1], s, "linear"))
    return pyr


def _xy(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 2) -> its two contiguous (B, H, W) channel planes."""
    return f[..., 0].contiguous(), f[..., 1].contiguous()


def _kernel_level(h: int, w: int, params: FlowParams) -> bool:
    """Whether a refining level of h x w runs the hand-written kernels."""
    return params.use_pallas and h * w >= params.pallas_min_pixels


def _exact_kernel_level(h: int, w: int, params: FlowParams) -> bool:
    """Whether an exact level of h x w runs the hand-written kernel: its
    planes fit one block's shared memory."""
    return (params.use_pallas and min(h, w) >= 2
            and h * w <= kernels.EXACT_LEVEL_MAX_PIXELS)


def _fast_level_ops(h: int, w: int, params: FlowParams) -> tuple:
    """A refining level's (warp, relax, relax_unfused, median, diffuse):
    with ``use_pallas`` the wrappers of the level's contract, else the
    plain branch as the small wrappers' plain versions."""
    if not params.use_pallas:
        return (kernels.warp_tiled_plain, kernels.small_relax_phase_plain,
                kernels.small_relax_phase_unfused_plain, im.median5,
                kernels.small_median5_diffuse_plain)
    warp = kernels.warp_tiled if params.warp_pallas else \
        kernels.warp_tiled_plain
    if _kernel_level(h, w, params):
        return (warp, kernels.relax_phase, kernels.relax_phase_unfused,
                kernels.median5, kernels.median5_diffuse)
    return (warp, kernels.small_relax_phase, kernels.small_relax_phase_unfused,
            kernels.median5, kernels.small_median5_diffuse)


def _level_runs(sizes: list[tuple[int, int]], params: FlowParams):
    """The levels below the coarsest, coarse to fine, in runs of one
    stage: (stage span's name, level indices)."""
    for kernel, levels in itertools.groupby(
            range(len(sizes) - 2, -1, -1),
            key=lambda lv: _kernel_level(*sizes[lv], params)):
        yield ("pair.flow_kernel_levels" if kernel
               else "pair.flow_plain_levels"), list(levels)


def _level_span(size: tuple[int, int]):
    return trace.span("flow.level", f"{size[0]}x{size[1]}")


def _level_core(i0x: torch.Tensor, i0y: torch.Tensor, i1g: torch.Tensor,
                a0: torch.Tensor, a1: torch.Tensor, flow: torch.Tensor,
                params: FlowParams, coarsest: bool) -> torch.Tensor:
    """Per-level relaxation on (B, H, W[, 2]) batched planes
    (CPU/PixFlow.hpp:306-339): relaxation phases + median, then the
    low-alpha diffusion.

    Non-coarsest levels take the fast path on the ops of
    ``_fast_level_ops``.  With ``params.use_pallas`` a level of at least
    ``pallas_min_pixels`` keeps the reference's TPU branches
    (edge-replicated windows): single-phase with ``fuse_level_blurs``
    ``kernels.relax_phase`` + ``kernels.median5_diffuse``, else per phase
    ``kernels.relax_phase_unfused`` + ``kernels.median5``, then the plain
    diffusion.  A smaller level, and every level without ``use_pallas``,
    keeps the plain branch's borders (out-of-image candidates rejected,
    reflect-101 blurs, the median edge-replicated), bit for bit:
    single-phase and fused ``small_relax_phase`` +
    ``small_median5_diffuse``, three launches with the warp; any other
    schedule its target blurred once, per phase
    ``small_relax_phase_unfused``, then ``median5`` after each phase but
    the last and ``small_median5_diffuse`` after the last; the kernels
    with ``use_pallas``, else their plain versions.  The coarsest level
    (and any ``relax_impl="exact"`` level) takes the exact gather path:
    with ``use_pallas`` a level of at most
    ``kernels.EXACT_LEVEL_MAX_PIXELS`` is the one kernel
    ``kernels.exact_level``, any larger one the plain loop
    (``kernels.exact_level_plain``)."""
    nb, h, w = i0x.shape
    phases = params.coarsest_relax_phases if coarsest else params.relax_phases
    iters = (params.coarsest_relax_iters_per_phase if coarsest
             else params.relax_iters_per_phase)

    if params.relax_impl == "fast" and not coarsest:
        update_mask = ((a0 > params.update_alpha_threshold)
                       & (a1 > params.update_alpha_threshold))
        kernel_level = _kernel_level(h, w, params)
        warp, relax, relax_unfused, median, diffuse = _fast_level_ops(
            h, w, params)
        kw, sigma = params.blurred_flow_kernel_width, params.blurred_flow_sigma

        def diffused(planes):
            return _from_planes(diffuse(planes, (1.0 - a0 * a1).contiguous(),
                                        kw, sigma), nb)

        if phases == 1 and params.fuse_level_blurs:
            # the relax op builds the blurred-flow target from f_base
            # (== the flow it blurs when there is exactly one phase); the
            # diffuse op does median + diffusion in one pass
            w1g = warp(i1g, flow)
            fx, fy = relax(*_xy(flow), *_xy(flow), *_xy(w1g), i0x, i0y,
                           update_mask.float(), params, iters,
                           params.fast_window)
            return diffused(torch.stack([fx, fy], dim=1).reshape(2 * nb, h, w))

        # the target is blurred once per level (reflect-101); each phase
        # re-centres the warp on its input flow (f_base), relaxes bounded
        # residuals against it and takes the median (a plain-border
        # level's last phase the median and the diffusion in one op)
        bfx, bfy = _xy(_blur_flow(flow, params))
        mask = update_mask.float()
        for phase in range(phases):
            w1g = warp(i1g, flow)
            fx, fy = relax_unfused(*_xy(flow), *_xy(flow), *_xy(w1g), i0x,
                                   i0y, bfx, bfy, mask, params, iters,
                                   params.fast_window)
            planes = torch.stack([fx, fy], dim=1).reshape(2 * nb, h, w)
            if not kernel_level and phase == phases - 1:
                return diffused(planes)
            flow = _from_planes(median(planes), nb)
    else:
        exact = (kernels.exact_level if _exact_kernel_level(h, w, params)
                 else kernels.exact_level_plain)
        return exact(i0x, i0y, i1g, a0, a1, flow, params, phases, iters)
    return low_alpha_flow_diffusion(flow, a0, a1, params)


# ---------------------------------------------------------------------------
# Coarsest-level search init (pixflow_search_* presets)
# ---------------------------------------------------------------------------


def _shift_clamped(arr: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = arr[clamp(y + dy), clamp(x + dx)] (replicate border)."""
    h, w = arr.shape[:2]
    r = max(abs(dy), abs(dx))
    if r == 0:
        return arr
    p = im.pad_axis(im.pad_axis(arr, 0, r, r, "edge"), 1, r, r, "edge")
    return p[r + dy:r + dy + h, r + dx:r + dx + w]


def _box5_zero(arr: torch.Tensor) -> torch.Tensor:
    """5x5 window sum, zero outside the image (patch SAD sums skip the
    out-of-bounds i0 patch rows/cols, CPU/PixFlow.hpp:163-180)."""
    h, w = arr.shape[:2]
    p = im.pad_axis(im.pad_axis(arr, 0, 2, 2, "constant"), 1, 2, 2,
                    "constant")
    out = torch.zeros_like(arr)
    for dy in range(5):
        for dx in range(5):
            out = out + p[dy:dy + h, dx:dx + w]
    return out


def search_box_offsets(hint: str, dist: int) -> list[tuple[int, int]]:
    """computeSearchBox offsets in the reference's scan order (dy outer,
    dx inner; CPU/PixFlow.hpp:207-224,249-263)."""
    ortho = (dist + 4) // 8
    if hint == "right":
        xs, ys = range(0, dist + 1), range(-ortho, ortho + 1)
    elif hint == "left":
        xs, ys = range(-dist, 1), range(-ortho, ortho + 1)
    elif hint == "down":
        xs, ys = range(-ortho, ortho + 1), range(0, dist + 1)
    elif hint == "up":
        xs, ys = range(-ortho, ortho + 1), range(-dist, 1)
    else:
        raise ValueError(f"unexpected direction {hint}")
    return [(dy, dx) for dy in ys for dx in xs]


@programs.device_constant
def _search_candidates(hint: str, dist: int, device: str) -> torch.Tensor:
    """(0, 0) and the search box offsets as (N, (dy, dx)) float32 on
    ``device``, made once: a copy from host memory waits for the card's
    stream, and a captured program cannot hold one."""
    return torch.tensor([(0, 0)] + search_box_offsets(hint, dist),
                        dtype=torch.float32, device=device)


def adjust_initial_flow(i0: torch.Tensor, i1: torch.Tensor,
                        alpha0: torch.Tensor, alpha1: torch.Tensor,
                        hint: str, params: FlowParams) -> torch.Tensor:
    """Brute-force init at the coarsest level (CPU/PixFlow.hpp:226-270) on
    (H, W) planes: every search offset is one shifted 5x5 box-summed SAD
    map; per-pixel argmin with a 0.8x bias toward zero flow.  Returns the
    (H, W, 2) integer-valued flow, zero where alpha0 is low."""
    ratio = torch.sum(alpha0 * alpha1 * i0) / torch.sum(alpha0 * alpha1 * i1)
    i1eq = i1 * ratio
    dist = params.search_distance
    offsets = search_box_offsets(hint, dist)
    h, w = i0.shape
    yy = torch.arange(h, device=i0.device)[:, None]
    xx = torch.arange(w, device=i0.device)[None, :]

    def patch_error(dy: int, dx: int) -> torch.Tensor:
        sad = _box5_zero(torch.abs(i0 - _shift_clamped(i1eq, dy, dx)))
        alpha = _box5_zero(alpha0 * _shift_clamped(alpha1, dy, dx))
        # 1 + length / dist in float32, as the reference evaluates it
        scale = np.float32(1.0) + np.float32((dx * dx + dy * dy) ** 0.5)             / np.float32(dist)
        e = sad / alpha * float(scale)
        # candidate centre must be in bounds (CPU/PixFlow.hpp:253)
        valid = ((yy + dy >= 0) & (yy + dy < h)
                 & (xx + dx >= 0) & (xx + dx < w))
        return torch.where(valid, e, float("inf"))

    err00 = patch_error(0, 0)
    # NaN err00 (zero alpha overlap) keeps zero flow in the reference's
    # strict comparisons: -inf makes the bias entry win
    bias = torch.where(torch.isnan(err00), float("-inf"), 0.8 * err00)
    errs = [bias] + [torch.nan_to_num(patch_error(dy, dx), nan=float("inf"))
                     for dy, dx in offsets]
    # first occurrence wins ties == the reference's strictly-less update
    choice = torch.argmin(torch.stack(errs), dim=0)
    cand = _search_candidates(hint, dist, str(i0.device))  # (N, (dy, dx))
    flow = cand[choice].flip(-1)                      # (H, W, (dx, dy))
    update = alpha0 > params.update_alpha_threshold
    return torch.where(update[..., None], flow, torch.zeros_like(flow))


def _initial_flow(i0: torch.Tensor, i1: torch.Tensor, alpha0: torch.Tensor,
                  alpha1: torch.Tensor, hint: str,
                  params: FlowParams) -> torch.Tensor:
    """The coarsest level's (H, W, 2) start: the search init when the
    preset searches and the direction is known, else zero flow."""
    if params.max_percentage > 0 and hint != "unknown":
        return adjust_initial_flow(i0, i1, alpha0, alpha1, hint, params)
    return torch.zeros(i0.shape + (2,), dtype=torch.float32,
                       device=i0.device)


def _gradients(imgs: torch.Tensor,
               params: FlowParams) -> tuple[torch.Tensor, torch.Tensor]:
    gk, gs = params.gradient_blur_kernel_width, params.gradient_blur_sigma
    return (im.gaussian_blur(im.sobel_x(imgs), gk, gs),
            im.gaussian_blur(im.sobel_y(imgs), gk, gs))


def _partner(x: torch.Tensor) -> torch.Tensor:
    """(2N, ...) planes, entry 2n + d the image d of pair n: each entry's
    partner, the other image of its pair."""
    return x.view((-1, 2) + x.shape[1:]).flip(1).reshape(x.shape)


def patch_match_level_batched(imgs: torch.Tensor, alphas: torch.Tensor,
                              flow: torch.Tensor | None,
                              hints: tuple[str, str],
                              params: FlowParams) -> torch.Tensor:
    """One pyramid level for both directions of N pairs:
    ``imgs``/``alphas`` (2N, H, W), entry 2n + d the image d of pair n;
    direction 2n + d solves the flow from that image to its partner with
    the hint hints[d].  ``flow`` is (2N, H, W, 2), or None at the coarsest
    level, which then starts from the initial flow (at a raised floor the
    caller passes the init-floor twin's flow instead:
    ``_twin_flow_batched``)."""
    nb = imgs.shape[0]
    gx, gy = _gradients(imgs, params)
    i1g = torch.stack([_partner(gx), _partner(gy)], dim=-1)
    a0, a1 = alphas, _partner(alphas)

    coarsest = flow is None
    if coarsest:
        i1 = _partner(imgs)
        flow = torch.stack([
            _initial_flow(imgs[b], i1[b], a0[b], a1[b], hints[b % 2], params)
            for b in range(nb)])

    return _level_core(gx, gy, i1g, a0, a1, flow, params, coarsest)


def _twin_flow_batched(imgs: torch.Tensor, alphas: torch.Tensor,
                       hints: tuple[str, str],
                       params: FlowParams) -> torch.Tensor:
    """Raised pyramid floor (_fast presets): the init-floor twin of the
    coarsest level for both directions of N pairs, (2N, H, W) planes as
    ``patch_match_level_batched`` takes them.  The images and alphas are
    resized progressively down to the sizes below the floor, the init +
    exact relaxation runs there, and its (2N, h, w, 2) flow is upsampled
    to (H, W) as the coarsest level's incoming flow.  A host range
    ``flow.level`` a size; the last one holds the solve and the
    upsample."""
    nb, hh, ww = imgs.shape
    planes = torch.cat([imgs, alphas])
    *down, (th, tw) = _sub_floor_sizes(hh, ww, params)
    for s in down:
        with _level_span(s):
            planes = im.resize_planes(planes, s, "linear")
    with _level_span((th, tw)):
        planes = im.resize_planes(planes, (th, tw), "linear")
        f_t = patch_match_level_batched(
            planes[:nb], planes[nb:], None, hints,
            dataclasses.replace(params, pyr_stop_size=0))
        up = _from_planes(im.resize_planes(_as_planes(f_t), (hh, ww),
                                           "cubic"), nb)
        # two Python floats: the products a two-element float32 tensor
        # gives
        return torch.stack([up[..., 0] * (ww / tw), up[..., 1] * (hh / th)],
                           -1)


def _preprocess(rgba: torch.Tensor, params: FlowParams,
                out_hw: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Downscale + grey/alpha floats + pre-blur (CPU/PixFlow.hpp:78-103)
    of an (N, H, W, 4) stack."""
    r = im.resize_u8(rgba, out_hw, "cubic", row_axis=1)
    g = im.rgba_to_gray_u8(r).float() / 255.0
    a = r[..., 3].float() / 255.0
    g = im.gaussian_blur(g, params.pre_blur_kernel_width,
                         params.pre_blur_sigma)
    return g, a


def _final_flow(planes: torch.Tensor, hw: tuple[int, int],
                params: FlowParams) -> torch.Tensor:
    """Upsample (2B, h, w) flow planes to the input resolution, rescale
    and blur (CPU/PixFlow.hpp:124-133)."""
    planes = im.resize_planes(planes, hw, "linear")
    planes = planes * (1.0 / params.downscale_factor)
    return im.gaussian_blur(planes, params.final_flow_blur_kernel_width,
                            params.final_flow_blur_sigma)


def compute_optical_flow_pairs(rgba0: torch.Tensor, rgba1: torch.Tensor,
                               params: FlowParams, hint01: str = "left",
                               hint10: str = "right"
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both flow directions of N pairs in one batched pyramid descent on a
    leading batch of 2N: (N, H, W, 4) uint8 stacks in, (flows 0->1, flows
    1->0) out, each (N, H, W, 2) float32 at the input resolution.  Every
    pair is solved as ``compute_optical_flow_pair`` solves it alone."""
    n, h, w = rgba0.shape[:3]
    dh = int(h * params.downscale_factor)
    dw = int(w * params.downscale_factor)

    def interleave(x0, x1):
        return torch.stack([x0, x1], dim=1).reshape(2 * n, dh, dw)

    sizes = pyramid_sizes(dh, dw, params)
    with trace.span("pair.flow_prep", stage=True):
        g0, a0 = _preprocess(rgba0, params, (dh, dw))
        g1, a1 = _preprocess(rgba1, params, (dh, dw))
        p_g = _build_pyramid(interleave(g0, g1), sizes)
        p_a = _build_pyramid(interleave(a0, a1), sizes)
    hints = (hint01, hint10)

    top = len(sizes) - 1
    flow = None
    if _sub_floor_sizes(*sizes[top], params):
        with trace.span("pair.flow_floor_twin", stage=True):
            flow = _twin_flow_batched(p_g[top], p_a[top], hints, params)
    with trace.span("pair.flow_coarsest", stage=True), \
            _level_span(sizes[top]):
        flow = patch_match_level_batched(p_g[top], p_a[top], flow, hints,
                                         params)
    for stage, levels in _level_runs(sizes, params):
        with trace.span(stage, stage=True):
            for level in levels:
                with _level_span(sizes[level]):
                    flow = _from_planes(im.resize_planes(
                        _as_planes(flow), sizes[level], "cubic"), 2 * n)
                    flow = flow * (1.0 / params.pyr_scale_factor)
                    flow = patch_match_level_batched(
                        p_g[level], p_a[level], flow, hints, params)

    with trace.span("pair.flow_prep", stage=True):
        flow = _from_planes(_final_flow(_as_planes(flow), (h, w), params),
                            2 * n)
    flow = flow.view(n, 2, h, w, 2)
    return flow[:, 0], flow[:, 1]


def compute_optical_flow_pair(rgba0: torch.Tensor, rgba1: torch.Tensor,
                              params: FlowParams, hint01: str = "left",
                              hint10: str = "right"
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both flow directions of one pair, (H, W, 4) uint8 inputs: returns
    (flow 0->1, flow 1->0), each (H, W, 2) float32 at the input
    resolution.  The N = 1 case of ``compute_optical_flow_pairs``."""
    flow01, flow10 = compute_optical_flow_pairs(rgba0[None], rgba1[None],
                                                params, hint01, hint10)
    return flow01[0], flow10[0]


def compute_optical_flow(rgba0: torch.Tensor, rgba1: torch.Tensor,
                         params: FlowParams, hint: str) -> torch.Tensor:
    """The solver for one direction (CPU/PixFlow.hpp:72-135): returns the
    (H, W, 2) float32 flow from ``rgba0`` to ``rgba1``, (H, W, 4) uint8,
    at the input resolution.  The first direction of
    ``compute_optical_flow_pair`` with ``hint`` for both directions, which
    solves it as alone."""
    return compute_optical_flow_pair(rgba0, rgba1, params, hint, hint)[0]
