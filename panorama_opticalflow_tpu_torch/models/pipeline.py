"""End-to-end stitch pipeline: the 6-input iterative chain (port of the
reference's ``models/pipeline.py``, CPU/main.cpp:47-110).

``stitch_six`` plans every pair's overlap window up front from the input
alphas, then runs the chain as a plain loop over pairs, each pair one
windowed pass: geometry, windowed blend field, windowed bidirectional
flow, windowed combine, full-canvas composite.
"""

from __future__ import annotations

import numpy as np
import torch

from panorama_opticalflow_tpu_torch.utils.config import StitchConfig
from panorama_opticalflow_tpu_torch import to_torch
from panorama_opticalflow_tpu_torch.models import crop, novel_view, stitcher
from panorama_opticalflow_tpu_torch.models.stitcher import window_cols


def _as_canvas(img, device) -> torch.Tensor:
    if isinstance(img, torch.Tensor):
        return img.to(device)
    return to_torch(np.asarray(img, np.uint8), device)


def stitch_pair(image_l: torch.Tensor, image_r: torch.Tensor,
                cfg: StitchConfig) -> torch.Tensor:
    """Stitch one canvas pair on the full canvas (the body of the
    reference's per-part loop, CPU/main.cpp:60-101)."""
    canvas_map = stitcher.match_images(image_l, image_r)
    ol = stitcher.extract_overlap(image_l, canvas_map)
    orr = stitcher.extract_overlap(image_r, canvas_map)
    blend, _ = stitcher.generate_blend(canvas_map, cfg)
    flow_lr, flow_rl = novel_view.prepare_flows(ol, orr, cfg)
    merged = novel_view.combine_novel_views(ol, orr, flow_lr, flow_rl, blend)
    return stitcher.gather_composite(canvas_map, image_l, image_r, merged,
                                     cfg)


def stitch_pair_windowed(image_l: torch.Tensor, image_r: torch.Tensor,
                         roll: int, width: int, gather_safe: bool,
                         cfg: StitchConfig) -> torch.Tensor:
    """One pair on the (roll, width) column window: the flow, blend field
    and combiner run on the window only (flow is zero elsewhere, so the
    merged view is transparent there); the hole search runs on the window
    when ``gather_safe`` (crop.gather_window_safe), else on the full
    canvas."""
    h, w = image_l.shape[:2]
    canvas_map = stitcher.match_images(image_l, image_r)
    ol = stitcher.extract_overlap(image_l, canvas_map)
    orr = stitcher.extract_overlap(image_r, canvas_map)
    blend_w, _ = stitcher.generate_blend(canvas_map, cfg,
                                         window=(roll, width))
    flow_lr_w, flow_rl_w = crop.cropped_flows_window(ol, orr, roll, width,
                                                     cfg)
    merged_w = novel_view.combine_novel_views(
        window_cols(ol, roll, width), window_cols(orr, roll, width),
        flow_lr_w, flow_rl_w, blend_w)
    merged = torch.zeros((h, w, 4), dtype=torch.uint8, device=image_l.device)
    merged[:, :width] = merged_w
    merged = torch.roll(merged, roll, dims=1)
    window = (roll, width) if gather_safe else None
    return stitcher.gather_composite(canvas_map, image_l, image_r, merged,
                                     cfg, window=window)


def stitch_pair_auto(image_l, image_r, cfg: StitchConfig,
                     window: tuple | None = None,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """stitch_pair with overlap-cropped work.  ``window`` is a planned
    (roll, width, gather_safe), e.g. from crop.plan_chain_windows; when
    None it is derived from the pair's canvas map."""
    image_l = _as_canvas(image_l, device)
    image_r = _as_canvas(image_r, device)
    if window is None:
        window = crop.pair_window(stitcher.match_images(image_l, image_r),
                                  cfg)
    roll, width, gsafe = window
    return stitch_pair_windowed(image_l, image_r, roll, width, gsafe, cfg)


def stitch_six(images: list, top, cfg: StitchConfig,
               device: str | torch.device = "cuda", on_part=None,
               use_crop: bool = True) -> torch.Tensor:
    """Iterative 6-input stitch (CPU/main.cpp:60-105): R starts as the top
    image and accumulates the panorama; L is photo i for i = 1..5.  Inputs
    are (H, W, 4) uint8 arrays or tensors, moved to ``device``; returns the
    (H, W, 4) uint8 panorama on ``device``.  ``on_part(i, result)`` is
    called after each pair."""
    photos = [_as_canvas(p, device) for p in images]
    result = _as_canvas(top, device)
    windows = (crop.plan_chain_windows(photos, result, cfg) if use_crop
               else [None] * len(photos))
    for i, (image_l, window) in enumerate(zip(photos, windows), start=1):
        if window is None:
            result = stitch_pair(image_l, result, cfg)
        else:
            result = stitch_pair_windowed(image_l, result, *window, cfg)
        if on_part is not None:
            on_part(i, result)
    return result
