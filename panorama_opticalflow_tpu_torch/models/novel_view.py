"""Asymmetric bidirectional novel-view synthesis with softmax deghosting
(port of the reference's ``models/novel_view.py``,
CPU/OpticalFlow.cpp:9-145)."""

from __future__ import annotations

import torch

from panorama_opticalflow_tpu_torch.utils.config import StitchConfig
from panorama_opticalflow_tpu_torch.models.pixflow import (
    compute_optical_flow_pair, compute_optical_flow_pairs)
from panorama_opticalflow_tpu_torch.ops import image as im
from panorama_opticalflow_tpu_torch.ops.warp import (
    sample_nearest_wrap, sample_nearest_wrap_tiled)

# Deghost constants (CPU/OpticalFlow.cpp:57-59)
K_COLOR_DIFF_COEF = 10.0
K_SOFTMAX_SHARPNESS = 10.0
K_FLOW_MAG_COEF = 100.0

# Canvases at least this large take the tiled sampler, smaller ones the
# exact gather -- the reference's switch, kept so both packages sample
# identically at every canvas size.
TILED_SAMPLER_MIN_H = 256
TILED_SAMPLER_MIN_W = 512


def prepare_flows(image_l: torch.Tensor, image_r: torch.Tensor,
                  cfg: StitchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional flow on the wrap-extended overlap images
    (CPU/OpticalFlow.cpp:102-145): (flow L->R, flow R->L), (H, W, 2); or,
    on (N, H, W, 4) stacks, the flows of N pairs from one pyramid
    descent, (N, H, W, 2)."""
    length = image_l.shape[-2] // cfg.flow_extend_div
    solve = (compute_optical_flow_pairs if image_l.dim() == 4
             else compute_optical_flow_pair)
    flow_lr, flow_rl = solve(
        im.wrap_extend_x(image_l, length, -2),
        im.wrap_extend_x(image_r, length, -2),
        cfg.flow_params, "left", "right")
    return im.crop_x(flow_lr, length, -2), im.crop_x(flow_rl, length, -2)


def combine_novel_views(image_l: torch.Tensor, image_r: torch.Tensor,
                        flow_l_to_r: torch.Tensor, flow_r_to_l: torch.Tensor,
                        blend: torch.Tensor) -> torch.Tensor:
    """combineNovelViews (CPU/OpticalFlow.cpp:30-92): colorL samples imageL
    through flowRtoL scaled by blendR, colorR samples imageR through
    flowLtoR scaled by blendL; transparent where either sample has zero
    alpha, otherwise a ghost-gated softmax mix.  Images (H, W, 4), flows
    (H, W, 2) and blend (H, W), or all with a leading N."""
    h, w = image_l.shape[-3:-1]
    blend_r = blend
    blend_l = 1.0 - blend_r
    sampler = (sample_nearest_wrap_tiled
               if h >= TILED_SAMPLER_MIN_H and w >= TILED_SAMPLER_MIN_W
               else sample_nearest_wrap)
    color_l = sampler(image_l, flow_r_to_l, blend_r).float()
    color_r = sampler(image_r, flow_l_to_r, blend_l).float()

    def mag(f):
        return torch.sqrt(f[..., 0] * f[..., 0] + f[..., 1] * f[..., 1]) / w

    mag_lr, mag_rl = mag(flow_l_to_r), mag(flow_r_to_l)
    color_diff = (torch.abs(color_l[..., 0] - color_r[..., 0])
                  + torch.abs(color_l[..., 1] - color_r[..., 1])
                  + torch.abs(color_l[..., 2] - color_r[..., 2])) / 255.0
    deghost = torch.tanh(color_diff * K_COLOR_DIFF_COEF)
    alpha_l = color_l[..., 3] / 255.0
    alpha_r = color_r[..., 3] / 255.0

    # numerically-stable softmax (the reference's raw exps overflow)
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
