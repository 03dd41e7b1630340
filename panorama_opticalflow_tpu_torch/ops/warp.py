"""Flow-guided sampling primitives (port of the reference's
``ops/warp.py``).

* ``bilinear_extend`` -- clamp-to-edge bilinear of the flow error
  function (CPU/PixFlow.hpp:407-425): coordinates clamped to
  [0, W-2] x [0, H-2] before taking the 2x2 cell.
* ``sample_nearest_wrap`` -- the novel-view point sampler
  (CPU/OpticalFlow.cpp:9-28): truncation, one horizontal wrap, vertical
  clamp.
* ``sample_nearest_wrap_tiled`` -- the same sampler as a per-tile block
  fetch plus a bounded residual selection, the reference's production
  path for large canvases; kept so the port matches it at every canvas.
"""

from __future__ import annotations

import torch

from panorama_opticalflow_tpu_torch.ops.image import pad_axis


def bilinear_extend(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` ((H, W) or (H, W, C) float32) at float coords
    ``x``/``y`` (any common shape); returns that shape (+ channel)."""
    h, w = img.shape[:2]
    x = torch.clamp(x, 0.0, w - 2.0)
    y = torch.clamp(y, 0.0, h - 2.0)
    x0 = x.to(torch.int64)
    y0 = y.to(torch.int64)
    xr = x - x0.to(x.dtype)
    yr = y - y0.to(y.dtype)

    flat = img.reshape((h * w,) + tuple(img.shape[2:]))
    base = y0 * w + x0
    f00 = flat[base]
    f10 = flat[base + 1]
    f01 = flat[base + w]
    f11 = flat[base + w + 1]
    if img.dim() == 3:
        xr = xr[..., None]
        yr = yr[..., None]
    return f00 + (f10 - f00) * xr + (f01 - f00) * yr \
        + (f00 + f11 - f10 - f01) * xr * yr


def _source_offsets(flow: torch.Tensor, t) -> tuple[torch.Tensor, torch.Tensor]:
    """Truncated source coords (sx, sy) of x + t*flow, int64."""
    h, w = flow.shape[:2]
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None]
    sx = torch.trunc(xs + flow[..., 0] * t).to(torch.int64)
    sy = torch.trunc(ys + flow[..., 1] * t).to(torch.int64)
    return sx, sy


def sample_nearest_wrap(img: torch.Tensor, flow: torch.Tensor,
                        t) -> torch.Tensor:
    """generateNovelViewPoint for every pixel: img[clamp_y(int(y+t*fy)),
    wrap_x(int(x+t*fx))].  ``img`` (H, W, C), ``flow`` (H, W, 2), ``t`` a
    scalar or (H, W) factor."""
    h, w = img.shape[:2]
    sx, sy = _source_offsets(flow, t)
    # single wrap, exactly like the reference's two ifs
    sx = torch.where(sx > w - 1, sx - w, sx)
    sx = torch.where(sx < 0, sx + w, sx)
    sy = torch.clamp(sy, 0, h - 1)
    flat = img.reshape(h * w, -1)
    return flat[sy * w + sx].reshape(img.shape)


def sample_nearest_wrap_tiled(
    img: torch.Tensor, flow: torch.Tensor, t,
    tile_h: int = 64, tile_w: int = 128, margin: int = 8, max_off: int = 96,
) -> torch.Tensor:
    """``sample_nearest_wrap`` as a per-(tile_h, tile_w) block fetch at
    the tile's clamped rounded mean integer offset, then two nearest
    select passes over the residual window [-margin, margin] (x over the
    block rows with the residual edge-extended, then y).  Residuals
    beyond ``margin`` and tile offsets beyond ``max_off`` clamp, exactly
    as in the reference."""
    h, w, c = img.shape
    dev = img.device
    hp = -(-h // tile_h) * tile_h
    wp = -(-w // tile_w) * tile_w
    ty, tx = hp // tile_h, wp // tile_w
    nt = ty * tx

    sx, sy = _source_offsets(flow, t)
    ox = sx - torch.arange(w, device=dev)[None, :]
    oy = torch.clamp(sy, 0, h - 1) - torch.arange(h, device=dev)[:, None]

    # channel-split planes; y edge-pad (clamp), x wrap-pad (the single
    # horizontal wrap), then tile-pad bottom/right with edge
    pad = max_off + margin
    img_p = img.permute(2, 0, 1)
    img_p = pad_axis(img_p, 1, pad, pad, "edge")
    img_p = pad_axis(img_p, 2, pad, pad, "wrap")
    img_p = pad_axis(pad_axis(img_p, 1, 0, hp - h, "edge"),
                     2, 0, wp - w, "edge")

    def tiles(a):
        a = pad_axis(pad_axis(a, 0, 0, hp - h, "edge"), 1, 0, wp - w, "edge")
        return (a.reshape(ty, tile_h, tx, tile_w).permute(0, 2, 1, 3)
                .reshape(nt, tile_h, tile_w))

    ox_t = tiles(ox)
    oy_t = tiles(oy)
    off_x = torch.clamp(torch.round(ox_t.float().mean(dim=(1, 2))),
                        -max_off, max_off).to(torch.int64)
    off_y = torch.clamp(torch.round(oy_t.float().mean(dim=(1, 2))),
                        -max_off, max_off).to(torch.int64)

    bh, bw = tile_h + 2 * margin, tile_w + 2 * margin
    tys = torch.arange(ty, device=dev).repeat_interleave(tx)
    txs = torch.arange(tx, device=dev).repeat(ty)
    rows = (tys * tile_h + off_y + pad - margin)[:, None] \
        + torch.arange(bh, device=dev)[None, :]
    cols = (txs * tile_w + off_x + pad - margin)[:, None] \
        + torch.arange(bw, device=dev)[None, :]
    blocks = img_p[:, rows[:, :, None], cols[:, None, :]]  # (c, T, bh, bw)

    rx = torch.clamp(ox_t - off_x[:, None, None], -margin, margin)
    ry = torch.clamp(oy_t - off_y[:, None, None], -margin, margin)
    # the x pass selects column x + rx on every block row (residual
    # edge-extended vertically), the y pass then picks row y + ry: both
    # pure selections, written as gathers
    rx_ext = pad_axis(rx, 1, margin, margin, "edge")          # (T, bh, tw)
    xsel = rx_ext + margin + torch.arange(tile_w, device=dev)
    accx = blocks.gather(3, xsel[None].expand(c, -1, -1, -1))
    ysel = ry + margin + torch.arange(tile_h, device=dev)[:, None]
    out = accx.gather(2, ysel[None].expand(c, -1, -1, -1))   # (c, T, th, tw)
    out = (out.reshape(c, ty, tx, tile_h, tile_w).permute(0, 1, 3, 2, 4)
           .reshape(c, hp, wp))
    return out.permute(1, 2, 0)[:h, :w]
