"""Core 2-D image primitives on tensors (port of the reference's
``ops/image.py``).

OpenCV semantics as in the reference: half-pixel-centre resizes (bicubic
a = -0.75, taps clamped), GaussianBlur with BORDER_REFLECT_101, Sobel
ksize=1 and medianBlur with BORDER_REPLICATE, box blur with
BORDER_REFLECT_101 and OpenCV's even-kernel anchor, fixed-point gray.

Layout: filters act on the LAST two dims, so (H, W) planes and batched
(..., H, W) planes go through the same call; ``resize`` keeps the
reference's (H, W) / (H, W, C) image signature and ``resize_planes``
takes (..., H, W).  Every filter is written as shift + multiply-add in a
fixed tap order (no cuDNN convolution, no TF32), so results match the
reference to f32 rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Padding along one axis (numpy pad semantics, via an index gather)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _pad_index(n: int, lo: int, hi: int, mode: str) -> np.ndarray:
    return np.pad(np.arange(n), (lo, hi), mode=mode)


def pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int,
             mode: str) -> torch.Tensor:
    """np.pad along one axis; ``mode`` is 'edge', 'reflect' (reflect-101),
    'wrap' or 'constant' (zeros)."""
    if lo == 0 and hi == 0:
        return x
    axis = axis % x.dim()
    if mode == "constant":
        parts = []
        for n in (lo, None, hi):
            if n is None:
                parts.append(x)
            elif n:
                shape = list(x.shape)
                shape[axis] = n
                parts.append(torch.zeros(shape, dtype=x.dtype, device=x.device))
        return torch.cat(parts, dim=axis)
    idx = torch.from_numpy(_pad_index(x.shape[axis], lo, hi, mode))
    return x.index_select(axis, idx.to(x.device))


# ---------------------------------------------------------------------------
# Resize (separable static-weight gather + weighted sum)
# ---------------------------------------------------------------------------


def _cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """OpenCV bicubic kernel (a = -0.75)."""
    t = np.abs(t)
    w1 = ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0
    w2 = a * (((t - 5.0) * t + 8.0) * t - 4.0)
    return np.where(t <= 1.0, w1, np.where(t < 2.0, w2, 0.0))


@functools.lru_cache(maxsize=None)
def _resize_axis_plan(in_size: int, out_size: int, method: str):
    """Static (indices, weights) for resampling one axis: idx (out, K)
    int64 clamped to [0, in_size-1], w (out, K) float32, half-pixel
    centres.  Same plan as the reference's ``_resize_axis_plan``."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    x0 = np.floor(src)
    f = src - x0
    x0 = x0.astype(np.int64)
    if method == "linear":
        taps = np.stack([x0, x0 + 1], axis=1)
        w = np.stack([1.0 - f, f], axis=1)
    elif method == "cubic":
        taps = np.stack([x0 - 1, x0, x0 + 1, x0 + 2], axis=1)
        w = _cubic_weight(taps - src[:, None])
        w = w / w.sum(axis=1, keepdims=True)
    else:
        raise ValueError(method)
    idx = np.clip(taps, 0, in_size - 1).astype(np.int64)
    return idx, w.astype(np.float32)


def _resize_axis(x: torch.Tensor, axis: int, out_size: int,
                 method: str) -> torch.Tensor:
    axis = axis % x.dim()
    idx, w = _resize_axis_plan(x.shape[axis], out_size, method)
    wshape = [1] * x.dim()
    wshape[axis] = out_size
    acc = None
    for m in range(idx.shape[1]):
        g = x.index_select(axis, torch.from_numpy(idx[:, m]).to(x.device))
        wm = torch.from_numpy(np.ascontiguousarray(w[:, m])).to(
            x.device).view(wshape)
        acc = g * wm if acc is None else acc + g * wm
    return acc


def resize_planes(x: torch.Tensor, out_hw: tuple[int, int],
                  method: str) -> torch.Tensor:
    """Resize (..., H, W) float planes (rows first, then columns)."""
    out_h, out_w = out_hw
    x = x.float()
    if out_h != x.shape[-2]:
        x = _resize_axis(x, -2, out_h, method)
    if out_w != x.shape[-1]:
        x = _resize_axis(x, -1, out_w, method)
    return x


def resize(img: torch.Tensor, out_hw: tuple[int, int], method: str,
           row_axis: int = 0) -> torch.Tensor:
    """Separable resize of an (H, W) or (H, W, C) array to float32
    (cv::resize INTER_LINEAR / INTER_CUBIC sampling, no anti-alias).
    ``row_axis=1`` resizes an (N, H, W, C) stack."""
    out_h, out_w = out_hw
    x = img.float()
    if out_h != img.shape[row_axis]:
        x = _resize_axis(x, row_axis, out_h, method)
    if out_w != img.shape[row_axis + 1]:
        x = _resize_axis(x, row_axis + 1, out_w, method)
    return x


def resize_u8(img: torch.Tensor, out_hw: tuple[int, int], method: str,
              row_axis: int = 0) -> torch.Tensor:
    """Resize a uint8 image with OpenCV-style round+saturate."""
    out = resize(img, out_hw, method, row_axis)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# Separable filters on the last two dims
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel for sigma > 0 (exp formula, normalised)."""
    c = (ksize - 1) * 0.5
    i = np.arange(ksize, dtype=np.float64)
    k = np.exp(-((i - c) ** 2) / (2.0 * sigma * sigma))
    k = k / k.sum()
    return k.astype(np.float32)


def _conv_axis(x: torch.Tensor, kernel: np.ndarray, pad_mode: str,
               axis: int) -> torch.Tensor:
    """1-D correlation along ``axis``: shift + multiply-add, taps in
    order."""
    k = kernel.shape[0]
    r = k // 2
    p = pad_axis(x, axis, r, k - 1 - r, pad_mode)
    n = x.shape[axis]
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + float(kernel[i]) * p.narrow(axis, i, n)
    return out


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """cv::GaussianBlur, BORDER_REFLECT_101, over the last two dims."""
    kern = gaussian_kernel_1d(ksize, sigma)
    x = _conv_axis(x, kern, "reflect", -2)
    return _conv_axis(x, kern, "reflect", -1)


def sobel_x(x: torch.Tensor) -> torch.Tensor:
    """cv::Sobel dx ksize=1 ([-1, 0, 1]), BORDER_REPLICATE."""
    p = pad_axis(x, -1, 1, 1, "edge")
    return p[..., 2:] - p[..., :-2]


def sobel_y(x: torch.Tensor) -> torch.Tensor:
    """cv::Sobel dy ksize=1, BORDER_REPLICATE."""
    p = pad_axis(x, -2, 1, 1, "edge")
    return p[..., 2:, :] - p[..., :-2, :]


def median5(x: torch.Tensor) -> torch.Tensor:
    """5x5 median, BORDER_REPLICATE (cv::medianBlur), over the last two
    dims: the 13th smallest of the 25 window shifts."""
    h, w = x.shape[-2:]
    p = pad_axis(pad_axis(x, -2, 2, 2, "edge"), -1, 2, 2, "edge")
    stack = torch.stack([p[..., dy:dy + h, dx:dx + w]
                         for dy in range(5) for dx in range(5)])
    return torch.kthvalue(stack, 13, dim=0).values


def box_blur(x: torch.Tensor, ksize_w: int, ksize_h: int) -> torch.Tensor:
    """cv::blur, BORDER_REFLECT_101, OpenCV's anchor (window
    [i - k//2, i + k - 1 - k//2]); prefix-sum formulation."""
    def along(v: torch.Tensor, k: int, axis: int) -> torch.Tensor:
        if k <= 1:
            return v
        p = pad_axis(v, axis, k // 2, k - 1 - k // 2, "reflect")
        cs = torch.cumsum(p, dim=axis, dtype=torch.float32)
        cs = pad_axis(cs, axis, 1, 0, "constant")
        n = v.shape[axis]
        return (cs.narrow(axis, k, n) - cs.narrow(axis, 0, n)) / float(k)

    v = along(x.float(), ksize_h, -2)
    return along(v, ksize_w, -1)


# ---------------------------------------------------------------------------
# Colour / alpha utilities
# ---------------------------------------------------------------------------


def rgba_to_gray_u8(img: torch.Tensor) -> torch.Tensor:
    """OpenCV-bit-exact RGBA(uint8) -> gray(uint8):
    (9798 R + 19235 G + 3735 B + 16384) >> 15."""
    r = img[..., 0].to(torch.int32)
    g = img[..., 1].to(torch.int32)
    b = img[..., 2].to(torch.int32)
    y = (9798 * r + 19235 * g + 3735 * b + 16384) >> 15
    return y.to(torch.uint8)


def threshold_binary(src: torch.Tensor, thresh: float,
                     maxval: float) -> torch.Tensor:
    """cv::threshold THRESH_BINARY: maxval where src > thresh else 0."""
    hi = torch.full((), maxval, dtype=src.dtype, device=src.device)
    return torch.where(src > thresh, hi, torch.zeros_like(hi))


def saturating_add_u8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint8 saturating add (cv::Mat operator+ semantics)."""
    s = a.to(torch.int16) + b.to(torch.int16)
    return torch.clamp(s, max=255).to(torch.uint8)


def wrap_extend_x(img: torch.Tensor, length: int,
                  axis: int = 1) -> torch.Tensor:
    """Periodic wrap-extension of the column axis (1 of an (H, W[, C])
    array; -2 also serves an (N, H, W, C) stack) by ``length`` columns
    each side: the equirectangular canvas wraps at 360 degrees."""
    if length == 0:
        return img
    n = img.shape[axis]
    return torch.cat([img.narrow(axis, n - length, length), img,
                      img.narrow(axis, 0, length)], dim=axis)


def crop_x(img: torch.Tensor, length: int, axis: int = 1) -> torch.Tensor:
    """Undo wrap_extend_x."""
    return img.narrow(axis, length, img.shape[axis] - 2 * length)
