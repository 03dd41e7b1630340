"""Stitch geometry on the shared equirectangular canvas (port of the
reference's ``models/stitcher.py``, CPU/StitchTool.cpp): canvas map,
overlap extraction, seam-blend field and final composite.

Canvases are (H, W, 4) uint8 RGBA tensors; alpha encodes the footprint.
Map codes: 0 = empty, 100 = L only, 50 = R only, 150 = overlap.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from panorama_opticalflow_tpu_torch.utils.config import StitchConfig
from panorama_opticalflow_tpu_torch.ops import image as im
from panorama_opticalflow_tpu_torch.ops import kernels


class StitchContext(NamedTuple):
    """Per-pair stitch state (the reference's Stitchtools fields)."""

    map: torch.Tensor           # (H, W) uint8 canvas map, {0, 50, 100, 150}
    overlapped_l: torch.Tensor  # (H, W, 4) uint8, L masked to the overlap
    overlapped_r: torch.Tensor  # (H, W, 4) uint8, R masked to the overlap
    blend: torch.Tensor         # (H, W) float32 in [0, 1]
    merged_dis: torch.Tensor    # (H, W) float32, to the nearest pure region


def match_images(image_l: torch.Tensor, image_r: torch.Tensor) -> torch.Tensor:
    """Canvas map from the two alpha footprints (CPU/StitchTool.cpp:38-50)."""
    a_l = im.threshold_binary(image_l[..., 3], 0, 100)
    a_r = im.threshold_binary(image_r[..., 3], 0, 50)
    return (a_l + a_r).to(torch.uint8)


def extract_overlap(image: torch.Tensor,
                    canvas_map: torch.Tensor) -> torch.Tensor:
    """Zero the image outside the overlap (CPU/StitchTool.cpp:17-33)."""
    mask = (canvas_map > 140).to(torch.uint8)
    return image * mask[..., None]


def _window_index(roll, width: int, w: int, device) -> torch.Tensor:
    """Canvas columns (roll + [0, width)) mod w; ``roll`` is an int or a
    0-d int64 tensor on ``device`` (a program's input: one program serves
    every roll of a width)."""
    return (torch.arange(width, device=device) + roll) % w


def window_cols(a: torch.Tensor, roll, width: int,
                dim: int = 1) -> torch.Tensor:
    """Columns [roll, roll + width) of ``a`` along ``dim`` (circularly): the
    canvas rolled left by ``roll``, cut to ``width``."""
    return a.index_select(dim, _window_index(roll, width, a.shape[dim],
                                             a.device))


def place_cols(a_w: torch.Tensor, roll, w: int, dim: int = 1) -> torch.Tensor:
    """``window_cols``'s inverse: the window (``dim`` its columns) at
    columns [roll, roll + width) (circularly) of a zero canvas ``w``
    wide."""
    shape = list(a_w.shape)
    shape[dim] = w
    return a_w.new_zeros(shape).index_copy_(
        dim, _window_index(roll, a_w.shape[dim], w, a_w.device), a_w)


def generate_blend(canvas_map: torch.Tensor, cfg: StitchConfig,
                   window: tuple | None = None, scale: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Seam-blend weight field over the overlap (CPU/StitchTool.cpp:98-191):
    ``blend = dL / (dL + dR)`` from the 8-ray strided distances to the
    pure-L / pure-R regions, then the selective and global box blurs.

    ``window`` = (roll, width) computes the field on that column window
    only, with every size-derived constant still taken from the full
    canvas (the reference's SSIM-gated approximation).  ``scale`` (default
    ``cfg.blend_scale_resolved``) decimates the whole field computation,
    reproducing the reference as it is: the block grid uses
    ``step // scale`` and the row test runs in decimated units, and the
    selective smoothing reduces to an identity where
    ``k_sel // scale < 2``.  Without a window ``canvas_map`` may be a
    stack (N, H, W): the fields of N canvases, each made as alone.  The
    distances are ``ops.kernels.blend_distances``: on a card one kernel
    launch a call, for both classes and the whole stack.
    Returns (blend, merged_dis), float32."""
    h, w = canvas_map.shape[-2:]
    step = max(1, min(h, w) // cfg.blend_step_div)
    max_i = w / 2.0
    none_val = 10.0 * w
    s = cfg.blend_scale_resolved if scale is None else scale
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
        d_l, d_r = kernels.blend_distances(cs, step_s, max_i / s)
    else:
        length_s = (w // cfg.blend_extend_div) // s
        d_l, d_r = kernels.blend_distances(im.wrap_extend_x(cs, length_s, -1),
                                           step_s, max_i / s, crop=length_s)
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

    # selective smoothing: blocks whose top-left MergedDis > step get a
    # rows/130 box blur (CPU/StitchTool.cpp:130-142), then a global
    # rows/400 box blur (CPU/StitchTool.cpp:143)
    k_sel = h // cfg.blend_smooth_kernel_div
    if k_sel >= 2:
        ks = max(1, k_sel // s)
        blurred = im.box_blur(blend, ks, ks)
        hq, wq = h_s // step_s, out_w_s // step_s
        sel = merged_dis[..., : hq * step_s: step_s,
                         : wq * step_s: step_s] > step
        dev = blend.device
        # a block starting at q*step is processed iff q*step + step < dim
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
        merged_dis = im.resize_planes(merged_dis, (h, out_w), "linear")
    return blend.float(), merged_dis


def prepare(image_l: torch.Tensor, image_r: torch.Tensor,
            cfg: StitchConfig) -> StitchContext:
    """Stitchtools::prepare (CPU/StitchTool.cpp:7-36)."""
    canvas_map = match_images(image_l, image_r)
    blend, merged_dis = generate_blend(canvas_map, cfg)
    return StitchContext(canvas_map, extract_overlap(image_l, canvas_map),
                         extract_overlap(image_r, canvas_map), blend,
                         merged_dis)


def gather_composite(ctx_map: torch.Tensor, image_l: torch.Tensor,
                     image_r: torch.Tensor, merged_middle: torch.Tensor,
                     cfg: StitchConfig, window: tuple | None = None
                     ) -> torch.Tensor:
    """Final composite (CPU/StitchTool.cpp:52-96): code = Map + 75*(merged
    alpha > 0); 100 -> L, 50 -> R, {225, 175, 125} -> merged, 150 (an
    overlap hole) -> L or R of the nearest pure region within
    ``gather_search_radius`` ray steps (L wins ties), else opaque black.

    ``window`` = (roll, width) runs the hole search on that column window
    (bit-identical when crop.gather_window_safe holds).  Without a window
    the arguments may be stacks with a leading N: the canvases are then
    composited together, each as alone.  The stage is
    ``ops.kernels.hole_composite``: on a card one kernel launch a call
    that walks the rays from each hole pixel, for a pair or the whole
    stack; on the CPU its plain version."""
    return kernels.hole_composite(ctx_map, image_l, image_r, merged_middle,
                                  cfg.gather_search_radius, window)
