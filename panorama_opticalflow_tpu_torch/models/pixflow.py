"""Pixflow: pyramidal coarse-to-fine dense optical flow on tensors (port of
the reference's ``models/pixflow.py``, CPU/PixFlow.hpp:28-457).

Downscale, grey + alpha, pre-blur, a 0.9- (or 0.8-) factor pyramid, and
per level: Jacobi relaxation (4-neighbour propagation + descent), median
filter and low-alpha diffusion; then the final upsample and blur.  Both
flow directions of a pair are solved together on a leading batch of 2.

The pyramid runs unrolled (the reference's rung scan only shrinks XLA
compiles, and its border padding differs); the port matches the
reference with ``scan_coarse_levels=False``.  The coarsest level (and the
init-floor twin of the ``_fast`` presets) runs the exact gather path;
every other level the fast path of ``_level_core``.
"""

from __future__ import annotations

import dataclasses

import torch

from panorama_opticalflow_tpu_torch.utils.config import FlowParams
from panorama_opticalflow_tpu_torch.ops import image as im
from panorama_opticalflow_tpu_torch.ops import kernels
from panorama_opticalflow_tpu_torch.ops.relax_fast import relax_phase_fast
from panorama_opticalflow_tpu_torch.ops.warp import bilinear_extend


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


def error_function(cand: torch.Tensor, i0x: torch.Tensor, i0y: torch.Tensor,
                   i1g: torch.Tensor, blurred_flow: torch.Tensor,
                   params: FlowParams) -> torch.Tensor:
    """errorFunction (CPU/PixFlow.hpp:427-456) on one direction: ``cand``
    and ``i1g`` are (H, W, 2), returns the (H, W) error."""
    h, w = cand.shape[:2]
    xs = torch.arange(w, dtype=torch.float32, device=cand.device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=cand.device)[:, None]
    g1 = bilinear_extend(i1g, xs + cand[..., 0], ys + cand[..., 1])
    dx = i0x - g1[..., 0]
    dy = i0y - g1[..., 1]
    data = torch.sqrt(dx * dx + dy * dy)
    fd = blurred_flow - cand
    smooth = torch.sqrt(fd[..., 0] * fd[..., 0] + fd[..., 1] * fd[..., 1])
    reg = (params.vertical_regularization_coef * torch.abs(cand[..., 1])
           + params.horizontal_regularization_coef
           * torch.abs(cand[..., 0])) / w
    return data + params.smoothness_coef * smooth + reg


def _shift_with_valid(arr: torch.Tensor, dy: int, dx: int):
    """out[y, x] = arr[y - dy, x - dx], zero outside; plus the validity
    map."""
    h, w = arr.shape[:2]
    out = torch.zeros_like(arr)
    out[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        arr[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)]
    yy = torch.arange(h, device=arr.device)[:, None]
    xx = torch.arange(w, device=arr.device)[None, :]
    valid = (yy - dy >= 0) & (yy - dy < h) & (xx - dx >= 0) & (xx - dx < w)
    return out, valid


def relax_iteration(flow, i0x, i0y, i1g, blurred_flow, update_mask,
                    params: FlowParams) -> torch.Tensor:
    """One Jacobi round on one direction: 4-neighbour propagation
    (strictly-better proposals, CPU/PixFlow.hpp:342-362) + one
    finite-difference descent step (CPU/PixFlow.hpp:364-386)."""
    def err(c):
        return error_function(c, i0x, i0y, i1g, blurred_flow, params)

    inf = torch.tensor(float("inf"), device=flow.device)
    best_flow = flow
    best_err = err(flow)
    for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        cand, valid = _shift_with_valid(flow, dy, dx)
        e = torch.where(valid, err(cand), inf)
        take = e < best_err
        best_flow = torch.where(take[..., None], cand, best_flow)
        best_err = torch.where(take, e, best_err)

    eps = params.grad_epsilon
    zero = torch.zeros((), device=flow.device)
    epsv = torch.full((), eps, device=flow.device)
    ex = err(best_flow + torch.stack([epsv, zero]))
    ey = err(best_flow + torch.stack([zero, epsv]))
    grad = torch.stack([(ex - best_err) / eps, (ey - best_err) / eps], dim=-1)
    new = best_flow - params.gradient_step_size * grad
    return torch.where(update_mask[..., None], new, flow)


def _as_planes(f: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 2) flow -> (2B, H, W) channel-split planes."""
    b, h, w, _ = f.shape
    return f.permute(0, 3, 1, 2).reshape(b * 2, h, w)


def _from_planes(p: torch.Tensor, b: int) -> torch.Tensor:
    _, h, w = p.shape
    return p.reshape(b, 2, h, w).permute(0, 2, 3, 1).contiguous()


def _blur_flow(flow: torch.Tensor, params: FlowParams) -> torch.Tensor:
    nb = flow.shape[0]
    return _from_planes(im.gaussian_blur(
        _as_planes(flow), params.blurred_flow_kernel_width,
        params.blurred_flow_sigma), nb)


def _level_core(i0x: torch.Tensor, i0y: torch.Tensor, i1g: torch.Tensor,
                a0: torch.Tensor, a1: torch.Tensor, flow: torch.Tensor,
                params: FlowParams, coarsest: bool) -> torch.Tensor:
    """Per-level relaxation on (B, H, W[, 2]) batched planes
    (CPU/PixFlow.hpp:306-339): relaxation phases + median, then the
    low-alpha diffusion.

    Non-coarsest levels take the fast path.  With ``params.use_pallas``
    the per-phase warp is the CUDA kernel ``kernels.warp_tiled``, and a
    single-phase level of at least ``pallas_min_pixels`` takes the fused
    branch (``kernels.relax_phase`` + ``kernels.median5_diffuse``) -- the
    reference's TPU branch, whatever the device: the wrappers pick the
    kernel or its plain version by where the tensors live."""
    nb, h, w = i0x.shape
    update_mask = ((a0 > params.update_alpha_threshold)
                   & (a1 > params.update_alpha_threshold))
    phases = params.coarsest_relax_phases if coarsest else params.relax_phases
    iters = (params.coarsest_relax_iters_per_phase if coarsest
             else params.relax_iters_per_phase)

    if params.relax_impl == "fast" and not coarsest:
        fused = (params.use_pallas and h * w >= params.pallas_min_pixels
                 and phases == 1 and params.fuse_level_blurs)

        def warp_b(f_base):
            # per-phase gradient recentring (batched over B)
            if params.use_pallas and params.warp_pallas:
                return kernels.warp_tiled(i1g, f_base)
            return kernels.warp_tiled_plain(i1g, f_base)

        if fused:
            # the relax kernel builds the blurred-flow target from f_base
            # (== the flow it blurs when there is exactly one phase); a
            # fused kernel does median + diffusion in one pass
            w1g = warp_b(flow)
            fx, fy = kernels.relax_phase(
                flow[..., 0].contiguous(), flow[..., 1].contiguous(),
                flow[..., 0].contiguous(), flow[..., 1].contiguous(),
                w1g[..., 0].contiguous(), w1g[..., 1].contiguous(),
                i0x, i0y, update_mask.float(), params, iters,
                params.fast_window)
            planes = torch.stack([fx, fy], dim=1).reshape(2 * nb, h, w)
            out = kernels.median5_diffuse(
                planes, (1.0 - a0 * a1).contiguous(),
                params.blurred_flow_kernel_width, params.blurred_flow_sigma)
            return _from_planes(out, nb)
        if params.use_pallas and h * w >= params.pallas_min_pixels:
            raise NotImplementedError(
                "multi-phase levels and fuse_level_blurs=False need the "
                "median5 and unfused relax kernels, not ported yet")

        blurred_flow = _blur_flow(flow, params)
        for _ in range(phases):
            w1g = warp_b(flow)
            flow = relax_phase_fast(flow, flow, w1g, i0x, i0y, blurred_flow,
                                    update_mask, params, iters,
                                    D=params.fast_window)
            flow = _from_planes(im.median5(_as_planes(flow)), nb)
    else:
        blurred_flow = _blur_flow(flow, params)
        for _ in range(phases):
            outs = []
            for b in range(nb):
                f = flow[b]
                for _ in range(iters):
                    f = relax_iteration(f, i0x[b], i0y[b], i1g[b],
                                        blurred_flow[b], update_mask[b],
                                        params)
                outs.append(f)
            flow = _from_planes(im.median5(_as_planes(torch.stack(outs))), nb)
    # low-alpha diffusion (C8b), blur on channel-split planes
    blurred = _blur_flow(flow, params)
    c = (1.0 - a0 * a1)[..., None]
    return c * blurred + (1.0 - c) * flow


def patch_match_level_batched(imgs: torch.Tensor, alphas: torch.Tensor,
                              flow: torch.Tensor | None,
                              hints: tuple[str, str],
                              params: FlowParams) -> torch.Tensor:
    """One pyramid level for both directions of a pair: ``imgs``/``alphas``
    (2, H, W); direction b solves flow from imgs[b] to imgs[1-b].
    ``flow`` is (2, H, W, 2), or None at the coarsest level."""
    gk, gs = params.gradient_blur_kernel_width, params.gradient_blur_sigma
    gx = im.gaussian_blur(im.sobel_x(imgs), gk, gs)
    gy = im.gaussian_blur(im.sobel_y(imgs), gk, gs)
    i1g = torch.stack([gx.flip(0), gy.flip(0)], dim=-1)
    a0, a1 = alphas, alphas.flip(0)

    coarsest = flow is None
    if coarsest and _sub_floor_sizes(*imgs.shape[1:], params):
        # raised pyramid floor (_fast presets): init + exact relaxation on
        # a <= pyr_min_image_size twin, then refine this level on the fast
        # path off the upsampled init
        tiny = _sub_floor_sizes(*imgs.shape[1:], params)
        imgs_t, alphas_t = imgs, alphas
        for s in tiny:
            imgs_t = im.resize_planes(imgs_t, s, "linear")
            alphas_t = im.resize_planes(alphas_t, s, "linear")
        f_t = patch_match_level_batched(
            imgs_t, alphas_t, None, hints,
            dataclasses.replace(params, pyr_stop_size=0))
        hh, ww = imgs.shape[1:]
        th, tw = tiny[-1]
        up = _from_planes(im.resize_planes(_as_planes(f_t), (hh, ww),
                                           "cubic"), 2)
        scale = torch.tensor([ww / tw, hh / th], dtype=torch.float32,
                             device=up.device)
        flow = up * scale
        coarsest = False
    elif coarsest:
        if params.max_percentage > 0 and any(h != "unknown" for h in hints):
            raise NotImplementedError("search init (max_percentage > 0) is "
                                      "not ported yet")
        flow = torch.zeros(imgs.shape + (2,), dtype=torch.float32,
                           device=imgs.device)

    return _level_core(gx, gy, i1g, a0, a1, flow, params, coarsest)


def _preprocess(rgba: torch.Tensor, params: FlowParams,
                out_hw: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Downscale + grey/alpha floats + pre-blur (CPU/PixFlow.hpp:78-103)."""
    r = im.resize_u8(rgba, out_hw, "cubic")
    g = im.rgba_to_gray_u8(r).float() / 255.0
    a = r[..., 3].float() / 255.0
    g = im.gaussian_blur(g, params.pre_blur_kernel_width,
                         params.pre_blur_sigma)
    return g, a


def compute_optical_flow_pair(rgba0: torch.Tensor, rgba1: torch.Tensor,
                              params: FlowParams, hint01: str = "left",
                              hint10: str = "right"
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both flow directions of a pair in one batched pyramid descent:
    returns (flow 0->1, flow 1->0), each (H, W, 2) float32 at the input
    resolution of the (H, W, 4) uint8 inputs."""
    h, w = rgba0.shape[:2]
    dh = int(h * params.downscale_factor)
    dw = int(w * params.downscale_factor)
    g0, a0 = _preprocess(rgba0, params, (dh, dw))
    g1, a1 = _preprocess(rgba1, params, (dh, dw))

    sizes = pyramid_sizes(dh, dw, params)
    p_g = _build_pyramid(torch.stack([g0, g1]), sizes)
    p_a = _build_pyramid(torch.stack([a0, a1]), sizes)
    hints = (hint01, hint10)

    n = len(sizes)
    flow = patch_match_level_batched(p_g[n - 1], p_a[n - 1], None, hints,
                                     params)
    for level in range(n - 2, -1, -1):
        flow = _from_planes(im.resize_planes(_as_planes(flow), sizes[level],
                                             "cubic"), 2)
        flow = flow * (1.0 / params.pyr_scale_factor)
        flow = patch_match_level_batched(p_g[level], p_a[level], flow, hints,
                                         params)

    planes = im.resize_planes(_as_planes(flow), (h, w), "linear")
    planes = planes * (1.0 / params.downscale_factor)
    planes = im.gaussian_blur(planes, params.final_flow_blur_kernel_width,
                              params.final_flow_blur_sigma)
    flow = _from_planes(planes, 2)
    return flow[0], flow[1]
