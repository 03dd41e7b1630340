"""Asymmetric bidirectional novel-view synthesis with softmax deghosting
(port of the reference's ``models/novel_view.py``,
CPU/OpticalFlow.cpp:9-145)."""

from __future__ import annotations

import torch

from panorama_opticalflow_tpu_torch.utils.config import StitchConfig
from panorama_opticalflow_tpu_torch.models.pixflow import (
    compute_optical_flow_pair, compute_optical_flow_pairs)
from panorama_opticalflow_tpu_torch.ops import image as im
from panorama_opticalflow_tpu_torch.ops import kernels
from panorama_opticalflow_tpu_torch.utils import trace


def prepare_flows(image_l: torch.Tensor, image_r: torch.Tensor,
                  cfg: StitchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional flow on the wrap-extended overlap images
    (CPU/OpticalFlow.cpp:102-145): (flow L->R, flow R->L), (H, W, 2); or,
    on (N, H, W, 4) stacks, the flows of N pairs from one pyramid
    descent, (N, H, W, 2)."""
    length = image_l.shape[-2] // cfg.flow_extend_div
    solve = (compute_optical_flow_pairs if image_l.dim() == 4
             else compute_optical_flow_pair)
    with trace.span("pair.flow_prep", stage=True):
        wide_l = im.wrap_extend_x(image_l, length, -2)
        wide_r = im.wrap_extend_x(image_r, length, -2)
    flow_lr, flow_rl = solve(wide_l, wide_r, cfg.flow_params, "left",
                             "right")
    return im.crop_x(flow_lr, length, -2), im.crop_x(flow_rl, length, -2)


def combine_novel_views(image_l: torch.Tensor, image_r: torch.Tensor,
                        flow_l_to_r: torch.Tensor, flow_r_to_l: torch.Tensor,
                        blend: torch.Tensor,
                        window: tuple | None = None) -> torch.Tensor:
    """combineNovelViews (CPU/OpticalFlow.cpp:30-92): colorL samples imageL
    through flowRtoL scaled by blendR, colorR samples imageR through
    flowLtoR scaled by blendL; transparent where either sample has zero
    alpha, otherwise a ghost-gated softmax mix.  Images (H, W, 4), flows
    (H, W, 2) and blend (H, W), or all with a leading N.  With ``window``
    = (roll, width) the images are whole canvases, the flows and blend
    the window's, and the merged window comes back at its columns of a
    zero canvas.  One call of the ``ops.kernels.novel_view`` kernel on a
    card; its plain version, ``combine_views_plain`` on the window, on the
    CPU."""
    return kernels.novel_view(image_l, image_r, flow_l_to_r, flow_r_to_l,
                              blend, window)
