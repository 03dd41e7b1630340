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
reference with ``scan_coarse_levels=False``.  ``coarsest_start`` gives
the flow the coarsest level refines: the init-floor twin's of the
``_fast`` presets, else the brute-force search init of the
``pixflow_search_*`` presets (``search_init``, all candidates of all
directions in one pass), else zero flow.  The coarsest level (and the
twin) runs the exact gather path (``ops.relax_exact``; one CUDA kernel,
``kernels.exact_level``, at the sizes a block holds); every other level
the fast path of ``_level_core``: with ``use_pallas`` three kernel
launches a single-phase level, below ``pallas_min_pixels`` bit for bit
the plain branch, which ``use_pallas=False`` runs at every size.

The spans (``utils.trace``): the stages ``pair.flow_prep`` (downscale,
pre-blur and pyramid; then, a second stretch, the final upsample),
``pair.flow_floor_twin`` (the ``_fast`` presets' init-floor twin: its
resizes, exact solve and upsample to the coarsest level),
``pair.flow_search_init`` (the search init, at the coarsest level or,
splitting the twin's stage in two, at the twin's),
``pair.flow_coarsest``, and the other levels in one stage a run:
``pair.flow_plain_levels`` below ``pallas_min_pixels``,
``pair.flow_kernel_levels`` at or above it; within them a host range
``flow.level`` a level (and a twin size), its size in the range's
arguments.  The tracer's counter ``search_maps`` counts the SAD maps the
search init scores, 19 a direction at the presets' search distance.
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


def _box5_zero(arr: torch.Tensor) -> torch.Tensor:
    """5x5 window sum over the last two axes, zero outside the image
    (patch SAD sums skip the out-of-bounds i0 patch rows/cols,
    CPU/PixFlow.hpp:163-180): 25 adds, dy outer, dx inner."""
    h, w = arr.shape[-2:]
    p = im.pad_axis(im.pad_axis(arr, -2, 2, 2, "constant"), -1, 2, 2,
                    "constant")
    out = torch.zeros_like(arr)
    for dy in range(5):
        for dx in range(5):
            out = out + p[..., dy:dy + h, dx:dx + w]
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


def _searches(hints: tuple[str, str], params: FlowParams) -> bool:
    """Whether the coarsest level starts from the search init."""
    return params.max_percentage > 0 and any(h != "unknown" for h in hints)


@programs.device_constant
def _search_candidates(hints: tuple[str, str], dist: int, nb: int, h: int,
                       w: int, device: str) -> tuple:
    """The search's tables for (nb, h, w) planes whose entry b searches
    with hints[b % 2], made once on ``device`` (a copy from host memory
    waits for the card's stream, and a captured program cannot hold one).
    Candidate k is the zero offset, then the box's offsets in scan order
    (an "unknown" entry: the zero offset throughout, so zero flow).
    Returns

    * ``index`` (K, nb, h, w) int64: the flat position in the (nb, h, w)
      planes of the pixel candidate k's replicate-shifted plane reads;
    * ``valid`` (K, nb, h, w): candidate k's centre is inside the plane
      (CPU/PixFlow.hpp:253);
    * ``scale`` (K, nb, 1, 1) float32: 1 + length / dist, evaluated in
      float32 as the reference does;
    * ``flows`` (nb * K, 2) float32: row b * K + k the (dx, dy) of
      candidate k of entry b, and ``base`` (nb, 1, 1) int64: b * K."""
    box = len(search_box_offsets("right", dist))
    offsets = np.array([
        [(0, 0)] + (search_box_offsets(hints[b % 2], dist)
                    if hints[b % 2] != "unknown" else [(0, 0)] * box)
        for b in range(nb)])                              # (nb, K, (dy, dx))
    k = offsets.shape[1]
    dy = offsets[..., 0].T[:, :, None, None]
    dx = offsets[..., 1].T[:, :, None, None]
    ys = np.arange(h)[:, None] + dy
    xs = np.arange(w)[None, :] + dx
    valid = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    index = (np.arange(nb)[:, None, None] * (h * w)
             + np.clip(ys, 0, h - 1) * w + np.clip(xs, 0, w - 1))
    scale = np.array([[np.float32(1.0)
                       + np.float32((x * x + y * y) ** 0.5) / np.float32(dist)
                       for y, x in entry] for entry in offsets.tolist()],
                     dtype=np.float32).T[:, :, None, None]
    flows = offsets[..., ::-1].astype(np.float32)
    base = np.arange(nb)[:, None, None] * k

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (dev(index), dev(valid), dev(scale), dev(flows.reshape(-1, 2)),
            dev(base))


def search_init(i0: torch.Tensor, i1: torch.Tensor, alpha0: torch.Tensor,
                alpha1: torch.Tensor, hints: tuple[str, str],
                params: FlowParams) -> torch.Tensor:
    """Brute-force init at the coarsest level (CPU/PixFlow.hpp:226-270) on
    (B, H, W) planes: entry b searches the flow from ``i0[b]`` to
    ``i1[b]`` with the hint hints[b % 2] ("unknown": zero flow).  Every
    candidate offset (the zero offset, then the search box's) is one
    replicate-shifted, 5x5 box-summed SAD map of the exposure-equalised
    ``i1`` over the box-summed alpha overlap, scaled by 1 + length /
    distance; per pixel the argmin with a 0.8x bias toward zero flow.

    All candidates of all entries run in one pass, and each entry gets the
    bits it gets searched alone: every op is elementwise, a gather or the
    argmin over the candidates, but the exposure ratio's two sums, which
    are taken one plane at a time, each of a plane of its own (a batched
    reduction may order its adds otherwise).  Returns the (B, H, W, 2)
    integer-valued flow, zero where alpha0 is low."""
    nb, h, w = i0.shape
    overlap = alpha0 * alpha1
    num = torch.stack([torch.sum(overlap[b] * i0[b]) for b in range(nb)])
    den = torch.stack([torch.sum(overlap[b] * i1[b]) for b in range(nb)])
    i1eq = i1 * (num / den)[:, None, None]
    index, valid, scale, flows, base = _search_candidates(
        tuple(hints), params.search_distance, nb, h, w, str(i0.device))
    shifted = torch.stack([i1eq, alpha1]).flatten(1)[:, index]
    box = _box5_zero(torch.stack([torch.abs(i0 - shifted[0]),
                                  alpha0 * shifted[1]]))
    err = torch.where(valid, box[0] / box[1] * scale, float("inf"))
    # NaN err00 (zero alpha overlap) keeps zero flow in the reference's
    # strict comparisons: -inf makes the bias entry win
    bias = torch.where(torch.isnan(err[0]), float("-inf"), 0.8 * err[0])
    errs = torch.cat([bias[None],
                      torch.nan_to_num(err[1:], nan=float("inf"))])
    # first occurrence wins ties == the reference's strictly-less update
    flow = flows[torch.argmin(errs, dim=0) + base]    # (B, H, W, (dx, dy))
    trace.count_search_maps(index.shape[0] * sum(
        hints[b % 2] != "unknown" for b in range(nb)))
    update = alpha0 > params.update_alpha_threshold
    return torch.where(update[..., None], flow, torch.zeros_like(flow))


@programs.device_constant
def _zero_flow(shape: tuple, device: str) -> torch.Tensor:
    """Zero flow of ``shape``, made once: a level reads the flow it
    refines and never writes it."""
    return torch.zeros(shape, dtype=torch.float32, device=device)


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
                              flow: torch.Tensor, params: FlowParams,
                              coarsest: bool = False) -> torch.Tensor:
    """One pyramid level for both directions of N pairs:
    ``imgs``/``alphas`` (2N, H, W), entry 2n + d the image d of pair n;
    direction 2n + d refines ``flow`` (2N, H, W, 2) from that image to its
    partner.  The ``coarsest`` level refines ``coarsest_start``'s flow on
    the exact path, but above a raised pyramid floor, where that is the
    init-floor twin's flow, it refines it as any other level."""
    gx, gy = _gradients(imgs, params)
    i1g = torch.stack([_partner(gx), _partner(gy)], dim=-1)
    exact = coarsest and not _sub_floor_sizes(*imgs.shape[1:], params)
    return _level_core(gx, gy, i1g, alphas, _partner(alphas), flow, params,
                       exact)


def _search_stage(imgs: torch.Tensor, alphas: torch.Tensor,
                  hints: tuple[str, str], params: FlowParams) -> torch.Tensor:
    """The search init of both directions of N pairs, the stage
    ``pair.flow_search_init``."""
    with trace.span("pair.flow_search_init", stage=True):
        return search_init(imgs, _partner(imgs), alphas, _partner(alphas),
                           hints, params)


def coarsest_start(imgs: torch.Tensor, alphas: torch.Tensor,
                   hints: tuple[str, str], params: FlowParams
                   ) -> torch.Tensor:
    """The (2N, H, W, 2) flow the coarsest level of (2N, H, W) planes
    (entry 2n + d the image d of pair n, direction d with the hint
    hints[d]) refines: above a raised pyramid floor (the _fast presets)
    the init-floor twin's flow, else the search init of the
    ``pixflow_search_*`` presets, else zero flow.  The twin and the
    search are stages of their own (``pair.flow_floor_twin``,
    ``pair.flow_search_init``); zero flow is a constant and runs
    nothing."""
    if _sub_floor_sizes(*imgs.shape[1:], params):
        return _twin_flow_batched(imgs, alphas, hints, params)
    if _searches(hints, params):
        return _search_stage(imgs, alphas, hints, params)
    return _zero_flow(imgs.shape + (2,), str(imgs.device))


def _twin_flow_batched(imgs: torch.Tensor, alphas: torch.Tensor,
                       hints: tuple[str, str],
                       params: FlowParams) -> torch.Tensor:
    """Raised pyramid floor (_fast presets): the init-floor twin of the
    coarsest level for both directions of N pairs, (2N, H, W) planes as
    ``coarsest_start`` takes them.  The images and alphas are resized
    progressively down to the sizes below the floor, the start (zero or
    the search init) and the exact relaxation run there, and the (2N, h,
    w, 2) flow is upsampled to (H, W) as the coarsest level's incoming
    flow.  The stage ``pair.flow_floor_twin``, split in two stretches by
    the search init's stage where the preset searches; a host range
    ``flow.level`` a size, the last one in each stretch."""
    nb, hh, ww = imgs.shape
    *down, (th, tw) = _sub_floor_sizes(hh, ww, params)
    twin = dataclasses.replace(params, pyr_stop_size=0)

    def solve(planes, flow):
        f_t = patch_match_level_batched(planes[:nb], planes[nb:], flow, twin,
                                        coarsest=True)
        up = _from_planes(im.resize_planes(_as_planes(f_t), (hh, ww),
                                           "cubic"), nb)
        # two Python floats: the products a two-element float32 tensor
        # gives
        return torch.stack([up[..., 0] * (ww / tw), up[..., 1] * (hh / th)],
                           -1)

    with trace.span("pair.flow_floor_twin", stage=True):
        planes = torch.cat([imgs, alphas])
        for s in down:
            with _level_span(s):
                planes = im.resize_planes(planes, s, "linear")
        with _level_span((th, tw)):
            planes = im.resize_planes(planes, (th, tw), "linear")
            if not _searches(hints, params):
                return solve(planes, _zero_flow((nb, th, tw, 2),
                                                str(imgs.device)))
    flow = _search_stage(planes[:nb], planes[nb:], hints, twin)
    with trace.span("pair.flow_floor_twin", stage=True), \
            _level_span((th, tw)):
        return solve(planes, flow)


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
    flow = coarsest_start(p_g[top], p_a[top], hints, params)
    with trace.span("pair.flow_coarsest", stage=True), \
            _level_span(sizes[top]):
        flow = patch_match_level_batched(p_g[top], p_a[top], flow, params,
                                         coarsest=True)
    for stage, levels in _level_runs(sizes, params):
        with trace.span(stage, stage=True):
            for level in levels:
                with _level_span(sizes[level]):
                    flow = _from_planes(im.resize_planes(
                        _as_planes(flow), sizes[level], "cubic"), 2 * n)
                    flow = flow * (1.0 / params.pyr_scale_factor)
                    flow = patch_match_level_batched(
                        p_g[level], p_a[level], flow, params)

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
