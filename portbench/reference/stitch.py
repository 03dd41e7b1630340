"""One pair's stitch on the shared equirectangular canvas
(CPU/StitchTool.cpp, CPU/OpticalFlow.cpp): canvas map, overlap
extraction, seam-blend field, bidirectional flow, novel-view combination
with softmax deghosting, and the final composite with its hole search.

Canvases are (H, W, 4) uint8 RGBA (or (N, H, W, 4) stacks where said);
alpha is the footprint.  Map codes: 0 empty, 100 L only, 50 R only, 150
overlap."""

from __future__ import annotations

import torch

from portbench.reference import image as im
from portbench.reference.config import StitchConfig
from portbench.reference.distance import (eight_ray_min_distance,
                                          two_class_hole_search)
from portbench.reference.pixflow import optical_flow_pairs
from portbench.reference.sample import (sample_nearest_wrap,
                                        sample_nearest_wrap_tiled)

# deghost constants (CPU/OpticalFlow.cpp:57-59)
K_COLOR_DIFF_COEF = 10.0
K_SOFTMAX_SHARPNESS = 10.0
K_FLOW_MAG_COEF = 100.0
# canvases at least this large take the tiled point sampler
TILED_SAMPLER_MIN_H = 256
TILED_SAMPLER_MIN_W = 512


def match_images(image_l: torch.Tensor, image_r: torch.Tensor) -> torch.Tensor:
    """The canvas map (CPU/StitchTool.cpp:38-50)."""
    a_l = im.threshold_binary(image_l[..., 3], 0, 100)
    a_r = im.threshold_binary(image_r[..., 3], 0, 50)
    return (a_l + a_r).to(torch.uint8)


def extract_overlap(image: torch.Tensor,
                    canvas_map: torch.Tensor) -> torch.Tensor:
    mask = (canvas_map > 140).to(torch.uint8)
    return image * mask[..., None]


def _window_index(roll: int, width: int, w: int, device) -> torch.Tensor:
    return (torch.arange(width, device=device) + roll) % w


def window_cols(a: torch.Tensor, roll: int, width: int,
                dim: int = 1) -> torch.Tensor:
    """Columns [roll, roll + width) of ``a`` along ``dim``, circularly."""
    return a.index_select(dim, _window_index(roll, width, a.shape[dim],
                                             a.device))


def place_cols(a_w: torch.Tensor, roll: int, w: int,
               dim: int = 1) -> torch.Tensor:
    """``window_cols``'s inverse on a zero canvas ``w`` wide."""
    shape = list(a_w.shape)
    shape[dim] = w
    return a_w.new_zeros(shape).index_copy_(
        dim, _window_index(roll, a_w.shape[dim], w, a_w.device), a_w)


def generate_blend(canvas_map: torch.Tensor, cfg: StitchConfig,
                   window: tuple | None = None) -> torch.Tensor:
    """The seam-blend field (CPU/StitchTool.cpp:98-191): dL / (dL + dR)
    from the 8-ray strided distances to the pure regions, the selective
    and the global box blur.  ``window`` = (roll, width) computes it on
    that column window with every size-derived constant taken from the
    full canvas; without one ``canvas_map`` may be an (N, H, W) stack.
    The field is computed on a canvas decimated by
    ``cfg.blend_scale_resolved`` and upsampled."""
    h, w = canvas_map.shape[-2:]
    step = max(1, min(h, w) // cfg.blend_step_div)
    max_i = w / 2.0
    none_val = 10.0 * w
    s = cfg.blend_scale_resolved
    step_s = max(1, step // s)
    windowed = window is not None and window[1] < w
    if windowed:
        roll, width = window
        center = window_cols(canvas_map, roll, width)
        out_w = width
    else:
        center = canvas_map
        out_w = w
    cs = center[..., ::s, ::s] if s > 1 else center
    if windowed:
        d_l = eight_ray_min_distance(cs == 100, step_s, max_i / s)
        d_r = eight_ray_min_distance(cs == 50, step_s, max_i / s)
    else:
        length_s = (w // cfg.blend_extend_div) // s
        ext = im.wrap_extend_x(cs, length_s, -1)
        d_l = im.crop_x(eight_ray_min_distance(ext == 100, step_s, max_i / s),
                        length_s, -1)
        d_r = im.crop_x(eight_ray_min_distance(ext == 50, step_s, max_i / s),
                        length_s, -1)
    if s > 1:
        d_l = d_l * s
        d_r = d_r * s
    nv = torch.full((), none_val, dtype=torch.float32, device=d_l.device)
    d_l = torch.where(torch.isinf(d_l), nv, d_l)
    d_r = torch.where(torch.isinf(d_r), nv, d_r)
    counted = d_l / (d_l + d_r)
    merged_dis = torch.minimum(d_l, d_r)
    zero = torch.zeros_like(counted)
    blend = torch.where(cs == 100, zero,
                        torch.where(cs == 50, zero + 1.0,
                                    torch.where(cs == 150, counted,
                                                zero + 0.5)))
    merged_dis = torch.where(cs == 150, merged_dis, zero)
    h_s, out_w_s = blend.shape[-2:]
    # blocks whose top-left distance exceeds the stride get a rows/130
    # box blur (CPU/StitchTool.cpp:130-142), then a rows/400 global one
    k_sel = h // cfg.blend_smooth_kernel_div
    if k_sel >= 2:
        ks = max(1, k_sel // s)
        blurred = im.box_blur(blend, ks, ks)
        hq, wq = h_s // step_s, out_w_s // step_s
        sel = merged_dis[..., : hq * step_s: step_s,
                         : wq * step_s: step_s] > step
        dev = blend.device
        qy = torch.arange(hq, device=dev) * step_s + step_s < h_s
        if windowed:
            gx = (torch.arange(wq, device=dev) * step_s * s + window[0]) % w
            qx = gx + step < w
        else:
            qx = torch.arange(wq, device=dev) * step_s * s + step < w
        sel = sel & qy[:, None] & qx[None, :]
        sel_full = torch.zeros(blend.shape, dtype=torch.bool, device=dev)
        sel_full[..., : hq * step_s, : wq * step_s] = sel.repeat_interleave(
            step_s, -2).repeat_interleave(step_s, -1)
        blend = torch.where(sel_full, blurred, blend)
    k_glob = h // cfg.blend_global_blur_div
    if k_glob >= 2:
        kg = max(1, k_glob // s)
        blend = im.box_blur(blend, kg, kg)
    if s > 1:
        blend = im.resize_planes(blend, (h, out_w), "linear")
    return blend.float()


def prepare_flows(image_l: torch.Tensor, image_r: torch.Tensor,
                  cfg: StitchConfig):
    """Both flows on the wrap-extended overlap images of (N, H, W, 4)
    stacks (CPU/OpticalFlow.cpp:102-145)."""
    length = image_l.shape[-2] // cfg.flow_extend_div
    flow_lr, flow_rl = optical_flow_pairs(
        im.wrap_extend_x(image_l, length, -2),
        im.wrap_extend_x(image_r, length, -2), cfg.flow_params,
        "left", "right")
    return im.crop_x(flow_lr, length, -2), im.crop_x(flow_rl, length, -2)


def combine_novel_views(image_l, image_r, flow_l_to_r, flow_r_to_l,
                        blend) -> torch.Tensor:
    """combineNovelViews (CPU/OpticalFlow.cpp:30-92): L sampled through
    flowRtoL scaled by the blend, R through flowLtoR scaled by 1 - blend;
    transparent where either sample is, else a ghost-gated softmax mix
    (stable form: upstream's raw exponentials overflow)."""
    h, w = image_l.shape[-3:-1]
    blend_r = blend
    blend_l = 1.0 - blend_r
    sampler = (sample_nearest_wrap_tiled
               if h >= TILED_SAMPLER_MIN_H and w >= TILED_SAMPLER_MIN_W
               else sample_nearest_wrap)
    color_l = sampler(image_l, flow_r_to_l, blend_r).float()
    color_r = sampler(image_r, flow_l_to_r, blend_l).float()
    flow_l_to_r = flow_l_to_r.float()
    flow_r_to_l = flow_r_to_l.float()

    def mag(f):
        return torch.sqrt(f[..., 0] * f[..., 0] + f[..., 1] * f[..., 1]) / w

    mag_lr, mag_rl = mag(flow_l_to_r), mag(flow_r_to_l)
    color_diff = (torch.abs(color_l[..., 0] - color_r[..., 0])
                  + torch.abs(color_l[..., 1] - color_r[..., 1])
                  + torch.abs(color_l[..., 2] - color_r[..., 2])) / 255.0
    deghost = torch.tanh(color_diff * K_COLOR_DIFF_COEF)
    alpha_l = color_l[..., 3] / 255.0
    alpha_r = color_r[..., 3] / 255.0
    a_l = K_SOFTMAX_SHARPNESS * blend_l * alpha_l \
        * (1.0 + K_FLOW_MAG_COEF * mag_rl)
    a_r = K_SOFTMAX_SHARPNESS * blend_r * alpha_r \
        * (1.0 + K_FLOW_MAG_COEF * mag_lr)
    m = torch.maximum(a_l, a_r)
    exp_l = torch.exp(a_l - m)
    exp_r = torch.exp(a_r - m)
    sum_exp = exp_l + exp_r + 1e-5 * torch.exp(-m)
    softmax_l = exp_l / sum_exp
    softmax_r = exp_r / sum_exp
    w_l = (blend_l + deghost * (softmax_l - blend_l))[..., None]
    w_r = (blend_r + deghost * (softmax_r - blend_r))[..., None]
    rgb = color_l[..., :3] * w_l + color_r[..., :3] * w_r
    rgb_u8 = torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)
    out = torch.cat([rgb_u8, torch.full(rgb_u8.shape[:-1] + (1,), 255,
                                        dtype=torch.uint8,
                                        device=rgb_u8.device)], dim=-1)
    transparent = (color_l[..., 3] == 0) | (color_r[..., 3] == 0)
    return torch.where(transparent[..., None],
                       torch.zeros(4, dtype=torch.uint8, device=out.device),
                       out)


def gather_composite(ctx_map, image_l, image_r, merged_middle,
                     cfg: StitchConfig,
                     window: tuple | None = None) -> torch.Tensor:
    """The final composite (CPU/StitchTool.cpp:52-96): code = Map +
    75*(merged alpha > 0); 100 -> L, 50 -> R, {225, 175, 125} -> merged,
    150 (an overlap hole) -> L or R of the nearest pure region within
    ``gather_search_radius`` steps (L wins ties), else opaque black.
    ``window`` runs the hole search on that column window."""
    w = ctx_map.shape[-1]
    code = ctx_map + im.threshold_binary(merged_middle[..., 3], 0, 75)
    r = cfg.gather_search_radius
    black = torch.tensor([0, 0, 0, 255], dtype=torch.uint8,
                         device=image_l.device)

    def hole_from(codes, img_l, img_r):
        found, take_l = two_class_hole_search(codes == 100, codes == 50, r)
        return torch.where(found[..., None],
                           torch.where(take_l[..., None], img_l, img_r),
                           black)

    if window is None:
        hole = hole_from(code, image_l, image_r)
    else:
        roll, width = window
        hole = place_cols(hole_from(window_cols(code, roll, width),
                                    window_cols(image_l, roll, width),
                                    window_cols(image_r, roll, width)),
                          roll, w)
    zero = torch.zeros((4,), dtype=torch.uint8, device=image_l.device)
    out = torch.where((code == 100)[..., None], image_l, zero)
    out = torch.where((code == 50)[..., None], image_r, out)
    is_merged = (code == 225) | (code == 175) | (code == 125)
    out = torch.where(is_merged[..., None], merged_middle, out)
    return torch.where((code == 150)[..., None], hole, out)
