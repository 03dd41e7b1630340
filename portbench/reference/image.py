"""2-D image primitives with OpenCV's semantics: half-pixel-centre
resizes (bicubic a = -0.75, taps clamped), GaussianBlur with
BORDER_REFLECT_101, Sobel ksize=1 and medianBlur with BORDER_REPLICATE, box
blur with BORDER_REFLECT_101 and OpenCV's even-kernel anchor, fixed-point
grey.  Filters act on the last two dims, as shift + multiply-add in a
fixed tap order."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _pad_index(n: int, lo: int, hi: int, mode: str,
               device: str) -> torch.Tensor:
    return torch.from_numpy(np.pad(np.arange(n), (lo, hi),
                                   mode=mode)).to(device)


def pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int,
             mode: str) -> torch.Tensor:
    """np.pad along one axis: 'edge', 'reflect' (reflect-101), 'wrap' or
    'constant' (zeros)."""
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
                parts.append(torch.zeros(shape, dtype=x.dtype,
                                         device=x.device))
        return torch.cat(parts, dim=axis)
    return x.index_select(axis, _pad_index(x.shape[axis], lo, hi, mode,
                                           str(x.device)))


def _cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    t = np.abs(t)
    w1 = ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0
    w2 = a * (((t - 5.0) * t + 8.0) * t - 4.0)
    return np.where(t <= 1.0, w1, np.where(t < 2.0, w2, 0.0))


def _resize_axis_plan(in_size: int, out_size: int, method: str):
    """(K, out) source indices, clamped, and float32 weights."""
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
    return np.ascontiguousarray(idx.T), np.ascontiguousarray(
        w.astype(np.float32).T)


@functools.lru_cache(maxsize=None)
def _resize_axis_taps(in_size: int, out_size: int, method: str,
                      device: str):
    idx, w = _resize_axis_plan(in_size, out_size, method)
    return torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


def _resize_axis(x: torch.Tensor, axis: int, out_size: int,
                 method: str) -> torch.Tensor:
    axis = axis % x.dim()
    idx, w = _resize_axis_taps(x.shape[axis], out_size, method,
                               str(x.device))
    wshape = [1] * x.dim()
    wshape[axis] = out_size
    acc = None
    for ix, wm in zip(idx, w):
        g = x.index_select(axis, ix) * wm.to(x.dtype).view(wshape)
        acc = g if acc is None else acc + g
    return acc


def _floating(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.float()


def resize_planes(x: torch.Tensor, out_hw: tuple[int, int],
                  method: str) -> torch.Tensor:
    """Resize (..., H, W) planes, rows first; integer planes become
    float32, float planes keep their type."""
    out_h, out_w = out_hw
    x = _floating(x)
    if out_h != x.shape[-2]:
        x = _resize_axis(x, -2, out_h, method)
    if out_w != x.shape[-1]:
        x = _resize_axis(x, -1, out_w, method)
    return x


def resize_u8(img: torch.Tensor, out_hw: tuple[int, int], method: str,
              row_axis: int = 0) -> torch.Tensor:
    """Resize an (H, W, C) uint8 image (``row_axis=1``: an (N, H, W, C)
    stack) with OpenCV's round and saturate."""
    out_h, out_w = out_hw
    x = img.float()
    if out_h != img.shape[row_axis]:
        x = _resize_axis(x, row_axis, out_h, method)
    if out_w != img.shape[row_axis + 1]:
        x = _resize_axis(x, row_axis + 1, out_w, method)
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel for sigma > 0."""
    c = (ksize - 1) * 0.5
    i = np.arange(ksize, dtype=np.float64)
    k = np.exp(-((i - c) ** 2) / (2.0 * sigma * sigma))
    k = k / k.sum()
    return k.astype(np.float32)


def _conv_axis(x: torch.Tensor, kernel: np.ndarray, pad_mode: str,
               axis: int) -> torch.Tensor:
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
    p = pad_axis(x, -1, 1, 1, "edge")
    return p[..., 2:] - p[..., :-2]


def sobel_y(x: torch.Tensor) -> torch.Tensor:
    p = pad_axis(x, -2, 1, 1, "edge")
    return p[..., 2:, :] - p[..., :-2, :]


def median5(x: torch.Tensor) -> torch.Tensor:
    """cv::medianBlur 5x5, BORDER_REPLICATE, over the last two dims."""
    h, w = x.shape[-2:]
    p = pad_axis(pad_axis(x, -2, 2, 2, "edge"), -1, 2, 2, "edge")
    stack = torch.stack([p[..., dy:dy + h, dx:dx + w]
                         for dy in range(5) for dx in range(5)])
    return torch.kthvalue(stack, 13, dim=0).values


def box_blur(x: torch.Tensor, ksize_w: int, ksize_h: int) -> torch.Tensor:
    """cv::blur, BORDER_REFLECT_101, OpenCV's anchor, by running sums
    taken one (H, W) plane at a time."""
    def along(v: torch.Tensor, k: int, axis: int) -> torch.Tensor:
        if k <= 1:
            return v
        p = pad_axis(v, axis, k // 2, k - 1 - k // 2, "reflect")
        cs = torch.cumsum(p, dim=axis, dtype=torch.float32)
        cs = pad_axis(cs, axis, 1, 0, "constant")
        n = v.shape[axis]
        return (cs.narrow(axis, k, n) - cs.narrow(axis, 0, n)) / float(k)

    def plane(v: torch.Tensor) -> torch.Tensor:
        return along(along(v, ksize_h, -2), ksize_w, -1)

    x = x.float()
    if x.dim() == 2:
        return plane(x)
    flat = x.reshape((-1,) + x.shape[-2:])
    return torch.stack([plane(v) for v in flat]).reshape(x.shape)


def rgba_to_gray_u8(img: torch.Tensor) -> torch.Tensor:
    """(9798 R + 19235 G + 3735 B + 16384) >> 15."""
    r = img[..., 0].to(torch.int32)
    g = img[..., 1].to(torch.int32)
    b = img[..., 2].to(torch.int32)
    return ((9798 * r + 19235 * g + 3735 * b + 16384) >> 15).to(torch.uint8)


def threshold_binary(src: torch.Tensor, thresh: float,
                     maxval: float) -> torch.Tensor:
    hi = torch.full((), maxval, dtype=src.dtype, device=src.device)
    return torch.where(src > thresh, hi, torch.zeros_like(hi))


def saturating_add_u8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a.to(torch.int16) + b.to(torch.int16)
    return torch.clamp(s, max=255).to(torch.uint8)


def wrap_extend_x(img: torch.Tensor, length: int,
                  axis: int = 1) -> torch.Tensor:
    """The equirectangular canvas wraps: ``length`` columns each side."""
    if length == 0:
        return img
    n = img.shape[axis]
    return torch.cat([img.narrow(axis, n - length, length), img,
                      img.narrow(axis, 0, length)], dim=axis)


def crop_x(img: torch.Tensor, length: int, axis: int = 1) -> torch.Tensor:
    return img.narrow(axis, length, img.shape[axis] - 2 * length)
