"""Flow visualisation for the debug dumps (CPU/OpticalFlow.cpp:147-204):
grey disparity (normalised x displacement), HSV colour wheel and a sparse
vector field on a 12-px grid.  Numpy and cv2 on the host, the port's own
copy of the reference's ``utils/visualize.py``."""

from __future__ import annotations

import numpy as np


def flow_as_grey_disparity(flow: np.ndarray) -> np.ndarray:
    """visualizeFlowAsGreyDisparity (CPU/OpticalFlow.cpp:147-158)."""
    disp = np.asarray(flow)[..., 0].astype(np.float64)
    lo, hi = disp.min(), disp.max()
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    return ((disp - lo) * scale).astype(np.uint8)


def flow_color_wheel(flow: np.ndarray) -> np.ndarray:
    """visualizeFlowColorWheel (CPU/OpticalFlow.cpp:185-204): hue from
    direction, brightness from magnitude; returns (H, W, 3) uint8 RGB."""
    import cv2

    f = np.asarray(flow, np.float64)
    mag = np.sqrt(f[..., 0] ** 2 + f[..., 1] ** 2)
    max_disp = max(f.shape[0], f.shape[1]) / 20.0
    with np.errstate(invalid="ignore"):
        fx = f[..., 0] / mag
        fy = f[..., 1] / mag
    brightness = 0.25 + 0.75 * np.minimum(1.0, mag / max_disp)
    hue = (np.arctan2(fy, fx) + np.pi) / (2 * np.pi)
    hsv = np.zeros(f.shape[:2] + (3,), np.uint8)
    hsv[..., 0] = np.nan_to_num(180.0 * hue).astype(np.uint8)
    hsv[..., 1] = (255.0 * brightness).astype(np.uint8)
    hsv[..., 2] = (255.0 * brightness).astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def flow_as_vector_field(flow: np.ndarray, image: np.ndarray,
                         grid: int = 12, arrow_len: float = 7.0) -> np.ndarray:
    """visualizeFlowAsVectorField (CPU/OpticalFlow.cpp:160-183)."""
    import cv2

    out = np.ascontiguousarray(np.asarray(image)[..., :3]).copy()
    f = np.asarray(flow, np.float64)
    h, w = f.shape[:2]
    for y in range(grid, h - grid, grid):
        for x in range(grid, w - grid, grid):
            fx, fy = f[y, x]
            mag = np.hypot(fx, fy) + 0.1
            cv2.line(out, (x, y),
                     (int(x + fx / mag * arrow_len),
                      int(y + fy / mag * arrow_len)),
                     (0, 0, 0), 1, cv2.LINE_AA)
    return out


def stack_horizontal(images: list[np.ndarray]) -> np.ndarray:
    """stackHorizontal (CPU/util.hpp:56-65)."""
    return np.concatenate(images, axis=1)
