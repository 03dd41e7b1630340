"""The reference's entry points: the 6-input chain (CPU/main.cpp:47-110)
with its crop windows planned from the input alphas, the 4-input single
pass (CPU_4Input/main.cpp:47-119), and N full-canvas pairs at once.

A pair runs on a column window (the overlap, a margin and the cols/20
continuity extension, rolled contiguous and bucketed to 256 columns):
flow, blend field and combiner there, the hole search there too where
that is bit-identical to the full canvas."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import image as im
from portbench.reference import stitch as st
from portbench.reference.config import StitchConfig
from portbench.reference.pixflow import optical_flow_pairs

_WIDTH_QUANTUM = 256
_MARGIN = 64


def circular_interval(cols: np.ndarray, margin: int):
    """Smallest circular [start, start + length) covering every True
    column, grown by ``margin``; None without overlap."""
    w = cols.shape[0]
    idx = np.flatnonzero(cols)
    if idx.size == 0:
        return None
    if idx.size == w:
        return 0, w
    ext = np.concatenate([idx, idx[:1] + w])
    gaps = np.diff(ext)
    g = int(np.argmax(gaps))
    start = int(ext[g + 1] % w)
    length = w - int(gaps[g] - 1)
    return (start - margin) % w, min(w, length + 2 * margin)


def _bucket(length: int, w: int) -> int:
    bw = max(2 * _WIDTH_QUANTUM, -(-length // _WIDTH_QUANTUM) * _WIDTH_QUANTUM)
    return w if bw >= w else bw


def _blend_step(h: int, w: int, cfg: StitchConfig) -> int:
    return max(1, min(h, w) // cfg.blend_step_div)


def _window_from_cols(cols: np.ndarray, cfg: StitchConfig,
                      step: int) -> tuple[int, int]:
    """(roll, width); the roll aligned down to the blend block stride."""
    w = cols.shape[0]
    iv = circular_interval(cols, _MARGIN + w // cfg.flow_extend_div)
    if iv is None:
        return 0, _bucket(1, w)
    start, length = iv
    width = _bucket(length + step - 1, w)
    if width >= w:
        return 0, w
    slack = (width - length - step + 1) // 2
    s = (start - slack) % w
    return s - s % step, width


def _gather_safe(cols: np.ndarray, roll: int, width: int,
                 radius: int) -> bool:
    """Every overlap column >= radius inside the window and away from the
    canvas's x-edges."""
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


def _window(cols: np.ndarray, h: int, cfg: StitchConfig):
    w = cols.shape[0]
    roll, width = _window_from_cols(cols, cfg, _blend_step(h, w, cfg))
    return roll, width, _gather_safe(cols, roll, width,
                                     cfg.gather_search_radius)


def plan_chain_windows(photos, top, cfg: StitchConfig) -> list[tuple]:
    """(roll, width, gather_safe) of each pair of the chain from the
    input alphas: pair i overlaps photo i with the union of the top
    photo and photos 0..i-1."""
    acc = (top[..., 3] > 0).cpu().numpy()
    windows = []
    for p in photos:
        al = (p[..., 3] > 0).cpu().numpy()
        windows.append(_window((al & acc).any(axis=0), top.shape[0], cfg))
        acc = acc | al
    return windows


def stitch_pair_windowed(image_l, image_r, window,
                         cfg: StitchConfig) -> torch.Tensor:
    """One pair on its (roll, width, gather_safe) window."""
    roll, width, gather_safe = window
    w = image_l.shape[1]
    canvas_map = st.match_images(image_l, image_r)
    ol = st.extract_overlap(image_l, canvas_map)
    orr = st.extract_overlap(image_r, canvas_map)
    blend_w = st.generate_blend(canvas_map, cfg, window=(roll, width))
    if width >= w:
        flow_lr, flow_rl = st.prepare_flows(ol[None], orr[None], cfg)
    else:
        flow_lr, flow_rl = optical_flow_pairs(
            st.window_cols(ol, roll, width)[None],
            st.window_cols(orr, roll, width)[None], cfg.flow_params)
    merged_w = st.combine_novel_views(
        st.window_cols(ol, roll, width), st.window_cols(orr, roll, width),
        flow_lr[0], flow_rl[0], blend_w)
    merged = st.place_cols(merged_w, roll, w)
    return st.gather_composite(canvas_map, image_l, image_r, merged, cfg,
                               window=(roll, width) if gather_safe else None)


def stitch_six(photos, top, cfg: StitchConfig) -> torch.Tensor:
    """The 6-input chain (CPU/main.cpp:60-105): the panorama starts as the
    top photo; pair i stitches photo i against it."""
    result = top
    for image_l, window in zip(photos,
                               plan_chain_windows(photos, top, cfg)):
        result = stitch_pair_windowed(image_l, result, window, cfg)
    return result


def compose_four(images) -> tuple[torch.Tensor, torch.Tensor]:
    """Column pre-crop (zero every column whose middle-row alpha is zero,
    CPU_4Input/main.cpp:65-76), then L = 1 + 3 and R = 2 + 4 with
    saturation (CPU_4Input/main.cpp:79-80)."""
    def precrop(image):
        mid = image[image.shape[0] // 2, :, 3]
        return image * (mid != 0).to(image.dtype)[None, :, None]

    i1, i2, i3, i4 = (precrop(images[k]) for k in range(4))
    return im.saturating_add_u8(i1, i3), im.saturating_add_u8(i2, i4)


def stitch_four(images, cfg: StitchConfig) -> torch.Tensor:
    """The 4-input single pass on the window of its own canvas map."""
    image_l, image_r = compose_four(images)
    cols = (st.match_images(image_l, image_r) == 150).any(dim=0)
    return stitch_pair_windowed(
        image_l, image_r, _window(cols.cpu().numpy(), image_l.shape[0], cfg),
        cfg)


def stitch_pairs(images_l, images_r, cfg: StitchConfig) -> torch.Tensor:
    """N full-canvas pairs, (N, H, W, 4) stacks, each stitched as alone."""
    canvas_map = st.match_images(images_l, images_r)
    blend = st.generate_blend(canvas_map, cfg)
    ol = st.extract_overlap(images_l, canvas_map)
    orr = st.extract_overlap(images_r, canvas_map)
    flow_lr, flow_rl = st.prepare_flows(ol, orr, cfg)
    merged = st.combine_novel_views(ol, orr, flow_lr, flow_rl, blend)
    return st.gather_composite(canvas_map, images_l, images_r, merged, cfg)
