"""Pixflow, the pyramidal dense optical flow (CPU/PixFlow.hpp:28-457):
downscale, grey + alpha, pre-blur, a pyramid, per level relaxation,
median and low-alpha diffusion, then the final upsample and blur.  Both
directions of N pairs are solved on a leading batch of 2N (entry 2n + d
is direction d of pair n), each as alone."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import image as im
from portbench.reference import relax
from portbench.reference.config import FlowParams
from portbench.reference.sample import bilinear_extend, warp_tiled


def pyramid_sizes(h: int, w: int, params: FlowParams) -> list[tuple[int, int]]:
    """Finest first (CPU/PixFlow.hpp:137-151)."""
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
    if not params.pyr_stop_size or \
            params.pyr_stop_size <= params.pyr_min_image_size:
        return []
    return pyramid_sizes(
        h, w, dataclasses.replace(params, pyr_stop_size=0))[1:]


def _build_pyramid(img: torch.Tensor,
                   sizes: list[tuple[int, int]]) -> list[torch.Tensor]:
    pyr = [img]
    for s in sizes[1:]:
        pyr.append(im.resize_planes(pyr[-1], s, "linear"))
    return pyr


def error_function(cand, i0x, i0y, i1g, blurred_flow,
                   params: FlowParams) -> torch.Tensor:
    """errorFunction (CPU/PixFlow.hpp:427-456) on (B, H, W, 2)
    candidates."""
    h, w = cand.shape[-3:-1]
    xs = torch.arange(w, dtype=cand.dtype, device=cand.device)[None, :]
    ys = torch.arange(h, dtype=cand.dtype, device=cand.device)[:, None]
    g1 = bilinear_extend(i1g, xs + cand[..., 0], ys + cand[..., 1],
                         batched=cand.dim() == 4)
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
    h, w = arr.shape[-3:-1]
    out = torch.zeros_like(arr)
    out[..., max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0), :] = \
        arr[..., max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0), :]
    yy = torch.arange(h, device=arr.device)[:, None]
    xx = torch.arange(w, device=arr.device)[None, :]
    valid = (yy - dy >= 0) & (yy - dy < h) & (xx - dx >= 0) & (xx - dx < w)
    return out, valid


def relax_iteration(flow, i0x, i0y, i1g, blurred_flow, update_mask,
                    params: FlowParams) -> torch.Tensor:
    """One Jacobi round of the exact path: strictly better 4-neighbour
    proposals (CPU/PixFlow.hpp:342-362), one finite-difference descent
    step (CPU/PixFlow.hpp:364-386)."""
    def err(c):
        return error_function(c, i0x, i0y, i1g, blurred_flow, params)

    best_flow = flow
    best_err = err(flow)
    for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        cand, valid = _shift_with_valid(flow, dy, dx)
        e = torch.where(valid, err(cand), float("inf"))
        take = e < best_err
        best_flow = torch.where(take[..., None], cand, best_flow)
        best_err = torch.where(take, e, best_err)
    eps = params.grad_epsilon
    zero = torch.zeros((), dtype=flow.dtype, device=flow.device)
    epsv = torch.full((), eps, dtype=flow.dtype, device=flow.device)
    ex = err(best_flow + torch.stack([epsv, zero]))
    ey = err(best_flow + torch.stack([zero, epsv]))
    grad = torch.stack([(ex - best_err) / eps, (ey - best_err) / eps], dim=-1)
    new = best_flow - params.gradient_step_size * grad
    return torch.where(update_mask[..., None], new, flow)


def _as_planes(f: torch.Tensor) -> torch.Tensor:
    b, h, w, _ = f.shape
    return f.permute(0, 3, 1, 2).reshape(b * 2, h, w)


def _from_planes(p: torch.Tensor, b: int) -> torch.Tensor:
    _, h, w = p.shape
    return p.reshape(b, 2, h, w).permute(0, 2, 3, 1).contiguous()


def _blur_flow(flow: torch.Tensor, params: FlowParams) -> torch.Tensor:
    return _from_planes(im.gaussian_blur(
        _as_planes(flow), params.blurred_flow_kernel_width,
        params.blurred_flow_sigma), flow.shape[0])


def _xy(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return f[..., 0].contiguous(), f[..., 1].contiguous()


def _level_core(i0x, i0y, i1g, a0, a1, flow, params: FlowParams,
                coarsest: bool) -> torch.Tensor:
    """Relaxation phases + median, then low-alpha diffusion
    (CPU/PixFlow.hpp:306-339).  Every level but the coarsest takes the
    fast path; levels of at least ``kernel_min_pixels`` follow the
    kernels' contracts, fused when single-phase."""
    nb, h, w = i0x.shape
    update_mask = ((a0 > params.update_alpha_threshold)
                   & (a1 > params.update_alpha_threshold))
    phases = params.coarsest_relax_phases if coarsest else params.relax_phases
    iters = (params.coarsest_relax_iters_per_phase if coarsest
             else params.relax_iters_per_phase)
    if not coarsest:
        kernel_level = h * w >= params.kernel_min_pixels
        if kernel_level and phases == 1 and params.fuse_level_blurs:
            w1g = warp_tiled(i1g, flow)
            fx, fy = relax.relax_fused(
                *_xy(flow), *_xy(flow), *_xy(w1g), i0x, i0y,
                update_mask.to(flow.dtype), params, iters,
                params.fast_window)
            planes = torch.stack([fx, fy], dim=1).reshape(2 * nb, h, w)
            out = relax.median5_diffuse(
                planes, (1.0 - a0 * a1).contiguous(),
                params.blurred_flow_kernel_width, params.blurred_flow_sigma)
            return _from_planes(out, nb)
        blurred_flow = _blur_flow(flow, params)
        if kernel_level:
            bfx, bfy = _xy(blurred_flow)
            mask = update_mask.to(flow.dtype)
        for _ in range(phases):
            w1g = warp_tiled(i1g, flow)
            if kernel_level:
                fx, fy = relax.relax_unfused(
                    *_xy(flow), *_xy(flow), *_xy(w1g), i0x, i0y, bfx, bfy,
                    mask, params, iters, params.fast_window)
                planes = im.median5(
                    torch.stack([fx, fy], dim=1).reshape(2 * nb, h, w))
            else:
                planes = im.median5(_as_planes(relax.relax_phase_fast(
                    flow, flow, w1g, i0x, i0y, blurred_flow, update_mask,
                    params, iters, params.fast_window)))
            flow = _from_planes(planes, nb)
    else:
        blurred_flow = _blur_flow(flow, params)
        for _ in range(phases):
            f = flow
            for _ in range(iters):
                f = relax_iteration(f, i0x, i0y, i1g, blurred_flow,
                                    update_mask, params)
            flow = _from_planes(im.median5(_as_planes(f)), nb)
    return low_alpha_flow_diffusion(flow, a0, a1, params)


def low_alpha_flow_diffusion(flow, alpha0, alpha1,
                             params: FlowParams) -> torch.Tensor:
    """flow <- lerp(flow, gauss15x15sigma8(flow), 1 - a0*a1)
    (CPU/PixFlow.hpp:388-405)."""
    blurred = _blur_flow(flow.reshape((-1,) + flow.shape[-3:]),
                         params).reshape(flow.shape)
    c = (1.0 - alpha0 * alpha1)[..., None]
    return c * blurred + (1.0 - c) * flow


def _shift_clamped(arr: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    h, w = arr.shape[:2]
    r = max(abs(dy), abs(dx))
    if r == 0:
        return arr
    p = im.pad_axis(im.pad_axis(arr, 0, r, r, "edge"), 1, r, r, "edge")
    return p[r + dy:r + dy + h, r + dx:r + dx + w]


def _box5_zero(arr: torch.Tensor) -> torch.Tensor:
    h, w = arr.shape[:2]
    p = im.pad_axis(im.pad_axis(arr, 0, 2, 2, "constant"), 1, 2, 2,
                    "constant")
    out = torch.zeros_like(arr)
    for dy in range(5):
        for dx in range(5):
            out = out + p[dy:dy + h, dx:dx + w]
    return out


def search_box_offsets(hint: str, dist: int) -> list[tuple[int, int]]:
    """computeSearchBox, dy outer and dx inner
    (CPU/PixFlow.hpp:207-224,249-263)."""
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


def adjust_initial_flow(i0, i1, alpha0, alpha1, hint: str,
                        params: FlowParams) -> torch.Tensor:
    """The coarsest level's brute-force search (CPU/PixFlow.hpp:226-270):
    per offset a shifted 5x5 box-summed SAD, per pixel the argmin with a
    0.8x bias toward zero flow; zero where alpha0 is low."""
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
        scale = np.float32(1.0) + np.float32((dx * dx + dy * dy) ** 0.5) \
            / np.float32(dist)
        e = sad / alpha * float(scale)
        valid = ((yy + dy >= 0) & (yy + dy < h)
                 & (xx + dx >= 0) & (xx + dx < w))
        return torch.where(valid, e, float("inf"))

    err00 = patch_error(0, 0)
    bias = torch.where(torch.isnan(err00), float("-inf"), 0.8 * err00)
    errs = [bias] + [torch.nan_to_num(patch_error(dy, dx), nan=float("inf"))
                     for dy, dx in offsets]
    choice = torch.argmin(torch.stack(errs), dim=0)
    cand = torch.tensor([(0, 0)] + offsets, dtype=i0.dtype, device=i0.device)
    flow = cand[choice].flip(-1)
    update = alpha0 > params.update_alpha_threshold
    return torch.where(update[..., None], flow, torch.zeros_like(flow))


def _initial_flow(i0, i1, alpha0, alpha1, hint: str,
                  params: FlowParams) -> torch.Tensor:
    if params.max_percentage > 0 and hint != "unknown":
        return adjust_initial_flow(i0, i1, alpha0, alpha1, hint, params)
    return torch.zeros(i0.shape + (2,), dtype=i0.dtype, device=i0.device)


def _gradients(imgs: torch.Tensor, params: FlowParams):
    gk, gs = params.gradient_blur_kernel_width, params.gradient_blur_sigma
    return (im.gaussian_blur(im.sobel_x(imgs), gk, gs),
            im.gaussian_blur(im.sobel_y(imgs), gk, gs))


def _floor_twin_flow(planes: torch.Tensor, hw: tuple[int, int], solve,
                     params: FlowParams) -> torch.Tensor:
    """Raised pyramid floor (_fast presets): init + exact relaxation on
    the sizes below the floor, upsampled to ``hw``."""
    tiny = _sub_floor_sizes(*hw, params)
    for s in tiny:
        planes = im.resize_planes(planes, s, "linear")
    f_t = solve(planes, dataclasses.replace(params, pyr_stop_size=0))
    (hh, ww), (th, tw) = hw, tiny[-1]
    up = _from_planes(im.resize_planes(_as_planes(f_t), (hh, ww), "cubic"),
                      f_t.shape[0])
    return torch.stack([up[..., 0] * (ww / tw), up[..., 1] * (hh / th)], -1)


def _partner(x: torch.Tensor) -> torch.Tensor:
    """Each entry's partner, the other image of its pair."""
    return x.view((-1, 2) + x.shape[1:]).flip(1).reshape(x.shape)


def patch_match_level(imgs, alphas, flow, hints: tuple[str, str],
                      params: FlowParams) -> torch.Tensor:
    """One pyramid level for both directions of N pairs: (2N, H, W)
    images and alphas, ``flow`` (2N, H, W, 2) or None at the coarsest."""
    nb = imgs.shape[0]
    gx, gy = _gradients(imgs, params)
    i1g = torch.stack([_partner(gx), _partner(gy)], dim=-1)
    a0, a1 = alphas, _partner(alphas)
    coarsest = flow is None
    if coarsest and _sub_floor_sizes(*imgs.shape[1:], params):
        flow = _floor_twin_flow(
            torch.cat([imgs, alphas]), imgs.shape[1:],
            lambda p, tp: patch_match_level(p[:nb], p[nb:], None, hints, tp),
            params)
        coarsest = False
    elif coarsest:
        i1 = _partner(imgs)
        flow = torch.stack([
            _initial_flow(imgs[b], i1[b], a0[b], a1[b], hints[b % 2], params)
            for b in range(nb)])
    return _level_core(gx, gy, i1g, a0, a1, flow, params, coarsest)


def _preprocess(rgba: torch.Tensor, params: FlowParams,
                out_hw: tuple[int, int]):
    """Downscale, grey and alpha, pre-blur (CPU/PixFlow.hpp:78-103) of an
    (N, H, W, 4) stack."""
    r = im.resize_u8(rgba, out_hw, "cubic", row_axis=rgba.dim() - 3)
    g = (im.rgba_to_gray_u8(r).float() / 255.0).to(params.dtype)
    a = (r[..., 3].float() / 255.0).to(params.dtype)
    g = im.gaussian_blur(g, params.pre_blur_kernel_width,
                         params.pre_blur_sigma)
    return g, a


def _final_flow(planes: torch.Tensor, hw: tuple[int, int],
                params: FlowParams) -> torch.Tensor:
    planes = im.resize_planes(planes, hw, "linear")
    planes = planes * (1.0 / params.downscale_factor)
    return im.gaussian_blur(planes, params.final_flow_blur_kernel_width,
                            params.final_flow_blur_sigma)


def optical_flow_pairs(rgba0: torch.Tensor, rgba1: torch.Tensor,
                       params: FlowParams, hint01: str = "left",
                       hint10: str = "right"):
    """Both flow directions of N pairs, (N, H, W, 4) uint8 stacks in,
    (flows 0->1, flows 1->0) out, each (N, H, W, 2) in ``params.dtype``."""
    n, h, w = rgba0.shape[:3]
    dh = int(h * params.downscale_factor)
    dw = int(w * params.downscale_factor)
    g0, a0 = _preprocess(rgba0, params, (dh, dw))
    g1, a1 = _preprocess(rgba1, params, (dh, dw))

    def interleave(x0, x1):
        return torch.stack([x0, x1], dim=1).reshape(2 * n, dh, dw)

    sizes = pyramid_sizes(dh, dw, params)
    p_g = _build_pyramid(interleave(g0, g1), sizes)
    p_a = _build_pyramid(interleave(a0, a1), sizes)
    hints = (hint01, hint10)
    top = len(sizes) - 1
    flow = patch_match_level(p_g[top], p_a[top], None, hints, params)
    for level in range(top - 1, -1, -1):
        flow = _from_planes(im.resize_planes(_as_planes(flow), sizes[level],
                                             "cubic"), 2 * n)
        flow = flow * (1.0 / params.pyr_scale_factor)
        flow = patch_match_level(p_g[level], p_a[level], flow, hints, params)
    flow = _from_planes(_final_flow(_as_planes(flow), (h, w), params), 2 * n)
    flow = flow.view(n, 2, h, w, 2)
    return flow[:, 0], flow[:, 1]
