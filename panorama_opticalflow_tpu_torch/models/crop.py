"""Overlap-aware flow cropping (port of the reference's ``models/crop.py``).

The composite depends on flow values only near the overlap band, so the
flow, blend field, combiner and (when provably exact) the hole search run
on a column window: the minimal circular interval covering the overlap
plus a margin and the cols/20 continuity extension, rolled to be
contiguous and bucketed to a multiple of 256 columns.
"""

from __future__ import annotations

import numpy as np
import torch

from panorama_opticalflow_tpu_torch.utils.config import StitchConfig
from panorama_opticalflow_tpu_torch.models.stitcher import window_cols
from panorama_opticalflow_tpu_torch.utils import trace

_WIDTH_QUANTUM = 256


def circular_interval(cols: np.ndarray, margin: int) -> tuple[int, int] | None:
    """Smallest circular interval [start, start+length) covering all True
    columns, grown by ``margin``; None when no overlap exists."""
    w = cols.shape[0]
    idx = np.flatnonzero(cols)
    if idx.size == 0:
        return None
    if idx.size == w:
        return 0, w
    # the largest gap of False columns determines the complement
    ext = np.concatenate([idx, idx[:1] + w])
    gaps = np.diff(ext)
    g = int(np.argmax(gaps))
    start = int(ext[g + 1] % w)
    length = w - int(gaps[g] - 1)
    start = (start - margin) % w
    length = min(w, length + 2 * margin)
    return start, length


def choose_bucket(length: int, w: int) -> int:
    bw = max(2 * _WIDTH_QUANTUM, -(-length // _WIDTH_QUANTUM) * _WIDTH_QUANTUM)
    return w if bw >= w else bw


def blend_step(h: int, w: int, cfg: StitchConfig) -> int:
    """Selective-smoothing block stride (CPU/StitchTool.cpp:121)."""
    return max(1, min(h, w) // cfg.blend_step_div)


def _window_from_cols(cols: np.ndarray, cfg: StitchConfig, margin: int,
                      step: int = 1) -> tuple[int, int]:
    """(roll, width) covering overlap + margin + extension; ``roll`` is
    aligned down to a multiple of the blend block stride ``step`` and the
    bucket gets step-1 extra columns so alignment never clips coverage."""
    w = cols.shape[0]
    ext = w // cfg.flow_extend_div
    iv = circular_interval(cols, margin + ext)
    if iv is None:
        return 0, choose_bucket(1, w)
    start, length = iv
    width = choose_bucket(length + step - 1, w)
    if width >= w:
        return 0, w
    slack = (width - length - step + 1) // 2
    s = (start - slack) % w
    return s - s % step, width


def gather_window_safe(cols: np.ndarray, roll: int, width: int,
                       radius: int) -> bool:
    """True when the hole search may run on the (roll, width) window
    bit-identically: every overlap column sits >= radius inside the window
    and >= radius away from the true canvas x-edges."""
    w = cols.shape[0]
    if width >= w:
        return False
    idx = np.flatnonzero(cols)
    if idx.size == 0:
        return True
    if cols[:radius].any() or cols[w - radius:].any():
        return False
    p = (idx - roll) % w
    return bool((p >= radius).all() and (p <= width - 1 - radius).all())


def overlap_columns(canvas_map: torch.Tensor) -> np.ndarray:
    """Per-column 'has overlap' flags, fetched to the host."""
    cols = (canvas_map == 150).any(dim=0)
    trace.host_sync()
    return cols.cpu().numpy()


def pair_window(canvas_map: torch.Tensor, cfg: StitchConfig,
                margin: int = 64) -> tuple[int, int, bool]:
    """(roll, width, gather_safe) for one pair from its canvas map."""
    cols = overlap_columns(canvas_map)
    h, w = canvas_map.shape
    roll, width = _window_from_cols(cols, cfg, margin, blend_step(h, w, cfg))
    return roll, width, gather_window_safe(cols, roll, width,
                                           cfg.gather_search_radius)


def crop_window(canvas_map: torch.Tensor, cfg: StitchConfig,
                margin: int = 64) -> tuple[int, int]:
    """(roll, width) such that rolling the canvas left by ``roll`` makes
    columns [0, width) cover overlap + margin + extension; width == W
    means no crop."""
    return pair_window(canvas_map, cfg, margin)[:2]


def plan_chain_windows(photos: list[torch.Tensor], top: torch.Tensor,
                       cfg: StitchConfig, margin: int = 64
                       ) -> list[tuple[int, int, bool]]:
    """(roll, width, gather_safe) crop windows for every pair of the
    6-input chain, from the input alphas alone: pair i stitches photo i
    against the accumulated panorama, whose footprint is the union of the
    top photo and photos 0..i-1."""
    acc = top[..., 3] > 0
    cols = []
    for p in photos:
        al = p[..., 3] > 0
        cols.append((al & acc).any(dim=0))
        acc = acc | al
    trace.host_sync()
    cols = torch.stack(cols).cpu().numpy()
    h, w = top.shape[:2]
    step = blend_step(h, w, cfg)
    windows = []
    for c in cols:
        roll, width = _window_from_cols(c, cfg, margin, step)
        windows.append((roll, width, gather_window_safe(
            c, roll, width, cfg.gather_search_radius)))
    return windows


def cropped_flows_window(image_l: torch.Tensor, image_r: torch.Tensor,
                         roll: int, width: int, cfg: StitchConfig):
    """Bidirectional flow on the rolled column window (window-sized
    flows); the full wrap-extended path when the window is the whole
    canvas."""
    from panorama_opticalflow_tpu_torch.models.novel_view import prepare_flows
    from panorama_opticalflow_tpu_torch.models.pixflow import \
        compute_optical_flow_pair

    if width >= image_l.shape[1]:
        return prepare_flows(image_l, image_r, cfg)
    with trace.span("pair.flow_prep", stage=True):
        window_l = window_cols(image_l, roll, width)
        window_r = window_cols(image_r, roll, width)
    return compute_optical_flow_pair(window_l, window_r, cfg.flow_params,
                                     "left", "right")
