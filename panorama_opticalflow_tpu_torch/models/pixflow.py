"""Pixflow: pyramidal coarse-to-fine dense optical flow on tensors (port of
the reference's ``models/pixflow.py``, CPU/PixFlow.hpp:28-457).

Downscale, grey + alpha, pre-blur, a 0.9- (or 0.8-) factor pyramid, and
per level: Jacobi relaxation (4-neighbour propagation + descent), median
filter and low-alpha diffusion; then the final upsample and blur.  Both
flow directions of a pair are solved together on a leading batch of 2,
and ``compute_optical_flow_pairs`` solves N pairs in one pyramid descent
on a leading batch of 2N (entry 2n + d is direction d of pair n).

The pyramid runs unrolled (the reference's rung scan only shrinks XLA
compiles, and its border padding differs); the port matches the
reference with ``scan_coarse_levels=False``.  The coarsest level (and the
init-floor twin of the ``_fast`` presets) starts from zero flow, or from
the brute-force search init of the ``pixflow_search_*`` presets, and
runs the exact gather path; every other level the fast path of
``_level_core``.  ``compute_optical_flow`` solves one direction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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
    """errorFunction (CPU/PixFlow.hpp:427-456): ``cand`` and ``i1g`` are
    (H, W, 2), returns the (H, W) error; or all with a leading batch of
    directions."""
    h, w = cand.shape[-3:-1]
    xs = torch.arange(w, dtype=torch.float32, device=cand.device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=cand.device)[:, None]
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
    """out[..., y, x, :] = arr[..., y - dy, x - dx, :] of a flow, zero
    outside; plus the (H, W) validity map."""
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
    """One Jacobi round: 4-neighbour propagation (strictly-better
    proposals, CPU/PixFlow.hpp:342-362) + one finite-difference descent
    step (CPU/PixFlow.hpp:364-386).  On one direction ((H, W, 2) flow,
    (H, W) planes) or on a leading batch of directions, each iterated
    exactly as alone: every op is a gather or elementwise."""
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


def _xy(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 2) -> its two contiguous (B, H, W) channel planes."""
    return f[..., 0].contiguous(), f[..., 1].contiguous()


def _level_core(i0x: torch.Tensor, i0y: torch.Tensor, i1g: torch.Tensor,
                a0: torch.Tensor, a1: torch.Tensor, flow: torch.Tensor,
                params: FlowParams, coarsest: bool) -> torch.Tensor:
    """Per-level relaxation on (B, H, W[, 2]) batched planes
    (CPU/PixFlow.hpp:306-339): relaxation phases + median, then the
    low-alpha diffusion.

    Non-coarsest levels take the fast path.  With ``params.use_pallas``
    the per-phase warp is the CUDA kernel ``kernels.warp_tiled``, and a
    level of at least ``pallas_min_pixels`` runs the kernels: a
    single-phase level with ``fuse_level_blurs`` the fused branch
    (``kernels.relax_phase`` + ``kernels.median5_diffuse``), any other
    level ``kernels.relax_phase_unfused`` + ``kernels.median5`` per
    phase -- the reference's TPU branches, whatever the device: the
    wrappers pick the kernel or its plain version by where the tensors
    live."""
    nb, h, w = i0x.shape
    update_mask = ((a0 > params.update_alpha_threshold)
                   & (a1 > params.update_alpha_threshold))
    phases = params.coarsest_relax_phases if coarsest else params.relax_phases
    iters = (params.coarsest_relax_iters_per_phase if coarsest
             else params.relax_iters_per_phase)

    if params.relax_impl == "fast" and not coarsest:
        kernel_level = params.use_pallas and h * w >= params.pallas_min_pixels

        def warp_b(f_base):
            # per-phase gradient recentring (batched over B)
            if params.use_pallas and params.warp_pallas:
                return kernels.warp_tiled(i1g, f_base)
            return kernels.warp_tiled_plain(i1g, f_base)

        if kernel_level and phases == 1 and params.fuse_level_blurs:
            # the relax kernel builds the blurred-flow target from f_base
            # (== the flow it blurs when there is exactly one phase); a
            # fused kernel does median + diffusion in one pass
            w1g = warp_b(flow)
            fx, fy = kernels.relax_phase(
                *_xy(flow), *_xy(flow), *_xy(w1g), i0x, i0y,
                update_mask.float(), params, iters, params.fast_window)
            planes = torch.stack([fx, fy], dim=1).reshape(2 * nb, h, w)
            out = kernels.median5_diffuse(
                planes, (1.0 - a0 * a1).contiguous(),
                params.blurred_flow_kernel_width, params.blurred_flow_sigma)
            return _from_planes(out, nb)

        # the target is blurred once per level (reflect-101); each phase
        # re-centres the warp on its input flow (f_base), relaxes bounded
        # residuals against it and takes the median
        blurred_flow = _blur_flow(flow, params)
        if kernel_level:
            bfx, bfy = _xy(blurred_flow)
            mask = update_mask.float()
        for _ in range(phases):
            w1g = warp_b(flow)
            if kernel_level:
                fx, fy = kernels.relax_phase_unfused(
                    *_xy(flow), *_xy(flow), *_xy(w1g), i0x, i0y, bfx, bfy,
                    mask, params, iters, params.fast_window)
                planes = kernels.median5(
                    torch.stack([fx, fy], dim=1).reshape(2 * nb, h, w))
            else:
                planes = im.median5(_as_planes(relax_phase_fast(
                    flow, flow, w1g, i0x, i0y, blurred_flow, update_mask,
                    params, iters, D=params.fast_window)))
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


def low_alpha_flow_diffusion(flow: torch.Tensor, alpha0: torch.Tensor,
                             alpha1: torch.Tensor,
                             params: FlowParams) -> torch.Tensor:
    """flow <- lerp(flow, gauss15x15sigma8(flow), 1 - a0*a1)
    (CPU/PixFlow.hpp:388-405) on an (H, W, 2) flow and (H, W) alphas, or
    on a leading batch of them; the blur runs on channel-split planes."""
    blurred = _blur_flow(flow.reshape((-1,) + flow.shape[-3:]),
                         params).reshape(flow.shape)
    c = (1.0 - alpha0 * alpha1)[..., None]
    return c * blurred + (1.0 - c) * flow


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
    inf = torch.tensor(float("inf"), device=i0.device)

    def patch_error(dy: int, dx: int) -> torch.Tensor:
        sad = _box5_zero(torch.abs(i0 - _shift_clamped(i1eq, dy, dx)))
        alpha = _box5_zero(alpha0 * _shift_clamped(alpha1, dy, dx))
        # 1 + length / dist in float32, as the reference evaluates it
        scale = np.float32(1.0) + np.float32((dx * dx + dy * dy) ** 0.5)             / np.float32(dist)
        e = sad / alpha * float(scale)
        # candidate centre must be in bounds (CPU/PixFlow.hpp:253)
        valid = ((yy + dy >= 0) & (yy + dy < h)
                 & (xx + dx >= 0) & (xx + dx < w))
        return torch.where(valid, e, inf)

    err00 = patch_error(0, 0)
    # NaN err00 (zero alpha overlap) keeps zero flow in the reference's
    # strict comparisons: -inf makes the bias entry win
    bias = torch.where(torch.isnan(err00), -inf, 0.8 * err00)
    errs = [bias] + [torch.nan_to_num(patch_error(dy, dx), nan=float("inf"))
                     for dy, dx in offsets]
    # first occurrence wins ties == the reference's strictly-less update
    choice = torch.argmin(torch.stack(errs), dim=0)
    cand = torch.tensor([(0, 0)] + offsets, dtype=torch.float32,
                        device=i0.device)             # (N, (dy, dx))
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


def _floor_twin_flow(planes: torch.Tensor, hw: tuple[int, int], solve,
                     params: FlowParams) -> torch.Tensor:
    """Raised pyramid floor (_fast presets): ``planes`` (images and
    alphas, (N, H, W)) are resized progressively down to the sizes below
    the floor, ``solve(small_planes, twin_params)`` runs the init +
    exact relaxation there, and its (B, h, w, 2) flow is upsampled to
    ``hw`` as this level's incoming flow."""
    tiny = _sub_floor_sizes(*hw, params)
    for s in tiny:
        planes = im.resize_planes(planes, s, "linear")
    f_t = solve(planes, dataclasses.replace(params, pyr_stop_size=0))
    (hh, ww), (th, tw) = hw, tiny[-1]
    up = _from_planes(im.resize_planes(_as_planes(f_t), (hh, ww), "cubic"),
                      f_t.shape[0])
    return up * torch.tensor([ww / tw, hh / th], dtype=torch.float32,
                             device=up.device)


def patch_match_level(i0: torch.Tensor, i1: torch.Tensor,
                      alpha0: torch.Tensor, alpha1: torch.Tensor,
                      flow: torch.Tensor | None, hint: str,
                      params: FlowParams) -> torch.Tensor:
    """One pyramid level for one direction (CPU/PixFlow.hpp:272-340):
    (H, W) planes, ``flow`` (H, W, 2) or None at the coarsest level."""
    gx, gy = _gradients(torch.stack([i0, i1]), params)
    i1g = torch.stack([gx[1], gy[1]], dim=-1)

    coarsest = flow is None
    if coarsest and _sub_floor_sizes(*i0.shape, params):
        flow = _floor_twin_flow(
            torch.stack([i0, i1, alpha0, alpha1]), i0.shape,
            lambda p, tp: patch_match_level(*p, None, hint, tp)[None],
            params)[0]
        coarsest = False
    elif coarsest:
        flow = _initial_flow(i0, i1, alpha0, alpha1, hint, params)

    return _level_core(gx[:1], gy[:1], i1g[None], alpha0[None],
                       alpha1[None], flow[None], params, coarsest)[0]


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
    level."""
    nb = imgs.shape[0]
    gx, gy = _gradients(imgs, params)
    i1g = torch.stack([_partner(gx), _partner(gy)], dim=-1)
    a0, a1 = alphas, _partner(alphas)

    coarsest = flow is None
    if coarsest and _sub_floor_sizes(*imgs.shape[1:], params):
        # raised pyramid floor (_fast presets): init + exact relaxation on
        # a <= pyr_min_image_size twin, then refine this level on the fast
        # path off the upsampled init
        flow = _floor_twin_flow(
            torch.cat([imgs, alphas]), imgs.shape[1:],
            lambda p, tp: patch_match_level_batched(p[:nb], p[nb:], None,
                                                    hints, tp),
            params)
        coarsest = False
    elif coarsest:
        i1 = _partner(imgs)
        flow = torch.stack([
            _initial_flow(imgs[b], i1[b], a0[b], a1[b], hints[b % 2], params)
            for b in range(nb)])

    return _level_core(gx, gy, i1g, a0, a1, flow, params, coarsest)


def _preprocess(rgba: torch.Tensor, params: FlowParams,
                out_hw: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Downscale + grey/alpha floats + pre-blur (CPU/PixFlow.hpp:78-103)
    of an (H, W, 4) image or an (N, H, W, 4) stack."""
    r = im.resize_u8(rgba, out_hw, "cubic", row_axis=rgba.dim() - 3)
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


def compute_optical_flow(rgba0: torch.Tensor, rgba1: torch.Tensor,
                         params: FlowParams, hint: str) -> torch.Tensor:
    """The solver for one direction (CPU/PixFlow.hpp:72-135): returns the
    (H, W, 2) float32 flow from ``rgba0`` to ``rgba1``, (H, W, 4) uint8,
    at the input resolution."""
    h, w = rgba0.shape[:2]
    dh = int(h * params.downscale_factor)
    dw = int(w * params.downscale_factor)
    i0, a0 = _preprocess(rgba0, params, (dh, dw))
    i1, a1 = _preprocess(rgba1, params, (dh, dw))

    sizes = pyramid_sizes(dh, dw, params)
    pyr = _build_pyramid(torch.stack([i0, i1, a0, a1]), sizes)

    n = len(sizes)
    flow = patch_match_level(*pyr[n - 1], None, hint, params)
    for level in range(n - 2, -1, -1):
        flow = im.resize(flow, sizes[level], "cubic")
        flow = flow * (1.0 / params.pyr_scale_factor)
        flow = patch_match_level(*pyr[level], flow, hint, params)
    return _from_planes(_final_flow(_as_planes(flow[None]), (h, w), params),
                        1)[0]


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
    g0, a0 = _preprocess(rgba0, params, (dh, dw))
    g1, a1 = _preprocess(rgba1, params, (dh, dw))

    def interleave(x0, x1):
        return torch.stack([x0, x1], dim=1).reshape(2 * n, dh, dw)

    sizes = pyramid_sizes(dh, dw, params)
    p_g = _build_pyramid(interleave(g0, g1), sizes)
    p_a = _build_pyramid(interleave(a0, a1), sizes)
    hints = (hint01, hint10)

    top = len(sizes) - 1
    flow = patch_match_level_batched(p_g[top], p_a[top], None, hints, params)
    for level in range(top - 1, -1, -1):
        flow = _from_planes(im.resize_planes(_as_planes(flow), sizes[level],
                                             "cubic"), 2 * n)
        flow = flow * (1.0 / params.pyr_scale_factor)
        flow = patch_match_level_batched(p_g[level], p_a[level], flow, hints,
                                         params)

    flow = _from_planes(_final_flow(_as_planes(flow), (h, w), params), 2 * n)
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
