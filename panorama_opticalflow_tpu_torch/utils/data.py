"""Synthetic inputs and the quality metrics, numpy only.

Copies of the JAX package's ``utils/io.synthesize_fisheye_set`` and
``synthesize_four_input_set`` and of ``utils/metrics.ssim`` and
``endpoint_error``, so that a run on the card imports nothing of that
package; ``tests/test_torch_no_jax.py`` holds them equal to the
originals.
"""

from __future__ import annotations

import numpy as np


def synthesize_fisheye_set(
    h: int, w: int, n: int = 5, overlap_frac: float = 0.35, seed: int = 0,
    with_top: bool = True,
) -> tuple[list[np.ndarray], np.ndarray | None]:
    """``n`` pre-registered (h, w, 4) uint8 RGBA photos whose footprints
    are vertical bands (wrapping at 360 degrees) with ``overlap_frac``
    overlap between neighbours, plus an optional top cap, all views of
    one smooth random panorama with small per-photo shifts and gains."""
    rng = np.random.default_rng(seed)
    freqs = 6
    yy = np.linspace(0, 2 * np.pi, h)[:, None]
    xx = np.linspace(0, 2 * np.pi, w, endpoint=False)[None, :]
    scene = np.zeros((h, w, 3))
    for _ in range(freqs):
        fy, fx = rng.integers(1, 6, 2)
        phase = rng.uniform(0, 2 * np.pi, 3)
        amp = rng.uniform(20, 60, 3)
        for c in range(3):
            scene[..., c] += amp[c] * np.sin(fy * yy + fx * xx + phase[c])
    scene = (scene - scene.min()) / (np.ptp(scene) + 1e-9) * 255.0

    band = w / n
    halo = band * overlap_frac
    photos = []
    for i in range(n):
        x0 = i * band - halo / 2
        x1 = (i + 1) * band + halo / 2
        img = np.zeros((h, w, 4), np.uint8)
        cols = (np.arange(w) - x0) % w < (x1 - x0)
        shift = int(rng.integers(-3, 4))
        gain = rng.uniform(0.92, 1.08)
        rolled = np.roll(scene, shift, axis=1) * gain
        img[..., :3] = np.clip(rolled, 0, 255).astype(np.uint8)
        img[:, cols, 3] = 255
        img[..., :3] *= (img[..., 3:] > 0)
        photos.append(img)

    top = None
    if with_top:
        top = np.zeros((h, w, 4), np.uint8)
        rows = np.arange(h) < int(h * 0.22)
        top[..., :3] = np.clip(scene * rng.uniform(0.95, 1.05), 0, 255)
        top[rows, :, 3] = 255
        top[..., :3] *= (top[..., 3:] > 0)
    return photos, top


def synthesize_four_input_set(h: int, w: int,
                              seed: int = 0) -> list[np.ndarray]:
    """4 wide-angle photos: 1/3 compose canvas L, 2/4 compose canvas R
    (CPU_4Input/main.cpp:54-80); opposite cameras do not overlap."""
    photos, _ = synthesize_fisheye_set(h, w, n=4, overlap_frac=0.3,
                                       seed=seed, with_top=False)
    return photos


def endpoint_error(flow_a: np.ndarray, flow_b: np.ndarray) -> float:
    """Mean Euclidean endpoint error between two (H, W, 2) flow fields."""
    d = np.asarray(flow_a, np.float64) - np.asarray(flow_b, np.float64)
    return float(np.sqrt((d ** 2).sum(-1)).mean())


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Mean SSIM over channels of two (H, W[, C]) arrays (Wang et al.
    2004: Gaussian 11x11 window, sigma 1.5, K1 = 0.01, K2 = 0.03)."""
    from scipy.signal import convolve2d

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    i = np.arange(11) - 5.0
    k = np.exp(-(i ** 2) / (2 * 1.5 * 1.5))
    k /= k.sum()
    win = np.outer(k, k)

    def filt(img):
        return convolve2d(img, win, mode="valid")

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for ch in range(a.shape[2]):
        x, y = a[..., ch], b[..., ch]
        mx, my = filt(x), filt(y)
        mxx, myy, mxy = mx * mx, my * my, mx * my
        sx = filt(x * x) - mxx
        sy = filt(y * y) - myy
        sxy = filt(x * y) - mxy
        s = ((2 * mxy + c1) * (2 * sxy + c2)) / ((mxx + myy + c1)
                                                 * (sx + sy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))
