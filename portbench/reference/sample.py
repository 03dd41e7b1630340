"""Flow-guided sampling: the error function's clamp-to-edge bilinear
(CPU/PixFlow.hpp:407-425), the novel view's point sampler
(CPU/OpticalFlow.cpp:9-28) in its per-tile form for large canvases, and
the per-tile warp whose contract the solver's warp kernel computes."""

from __future__ import annotations

import torch

from portbench.reference.image import pad_axis


def bilinear_extend(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    batched: bool = False) -> torch.Tensor:
    """``img`` at coords ``x``/``y`` clamped to [0, W-2] x [0, H-2];
    with ``batched`` entry b of (B, ...) samples image b."""
    lead = 1 if batched else 0
    h, w = img.shape[lead:lead + 2]
    x = torch.clamp(x, 0.0, w - 2.0)
    y = torch.clamp(y, 0.0, h - 2.0)
    x0 = x.to(torch.int64)
    y0 = y.to(torch.int64)
    xr = x - x0.to(x.dtype)
    yr = y - y0.to(y.dtype)
    chan = tuple(img.shape[lead + 2:])
    flat = img.reshape((-1,) + chan)
    base = y0 * w + x0
    if batched:
        first = torch.arange(img.shape[0], device=img.device) * (h * w)
        base = base + first.view((-1,) + (1,) * (base.dim() - 1))
    f00 = flat[base]
    f10 = flat[base + 1]
    f01 = flat[base + w]
    f11 = flat[base + w + 1]
    if chan:
        xr = xr[..., None]
        yr = yr[..., None]
    return f00 + (f10 - f00) * xr + (f01 - f00) * yr \
        + (f00 + f11 - f10 - f01) * xr * yr


def _source_offsets(flow: torch.Tensor, t):
    h, w = flow.shape[-3:-1]
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None]
    sx = torch.trunc(xs + flow[..., 0] * t).to(torch.int64)
    sy = torch.trunc(ys + flow[..., 1] * t).to(torch.int64)
    return sx, sy


def sample_nearest_wrap(img: torch.Tensor, flow: torch.Tensor,
                        t) -> torch.Tensor:
    """img[clamp_y(int(y + t*fy)), wrap_x(int(x + t*fx))]: truncation, one
    horizontal wrap, vertical clamp; (H, W, C) or a leading N."""
    h, w = img.shape[-3:-1]
    sx, sy = _source_offsets(flow, t)
    sx = torch.where(sx > w - 1, sx - w, sx)
    sx = torch.where(sx < 0, sx + w, sx)
    sy = torch.clamp(sy, 0, h - 1)
    idx = sy * w + sx
    if img.dim() == 4:
        idx = idx + (torch.arange(img.shape[0], device=img.device)
                     * (h * w))[:, None, None]
    return img.reshape(-1, img.shape[-1])[idx].reshape(img.shape)


def sample_nearest_wrap_tiled(img: torch.Tensor, flow: torch.Tensor, t,
                              tile_h: int = 64, tile_w: int = 128,
                              margin: int = 8,
                              max_off: int = 96) -> torch.Tensor:
    """The point sampler as a block fetch per (tile_h, tile_w) tile at the
    tile's clamped rounded mean integer offset, then a nearest selection
    over the residual window [-margin, margin], x then y; residuals
    beyond ``margin`` and offsets beyond ``max_off`` clamp."""
    if img.dim() == 3:
        if isinstance(t, torch.Tensor) and t.dim() == 2:
            t = t[None]
        return sample_nearest_wrap_tiled(img[None], flow[None], t, tile_h,
                                         tile_w, margin, max_off)[0]
    n, h, w, c = img.shape
    dev = img.device
    hp = -(-h // tile_h) * tile_h
    wp = -(-w // tile_w) * tile_w
    ty, tx = hp // tile_h, wp // tile_w
    nt = ty * tx
    sx, sy = _source_offsets(flow, t)
    ox = sx - torch.arange(w, device=dev)[None, :]
    oy = torch.clamp(sy, 0, h - 1) - torch.arange(h, device=dev)[:, None]

    pad = max_off + margin
    img_p = pad_axis(img, 1, pad, pad, "edge")
    img_p = pad_axis(img_p, 2, pad, pad, "wrap")
    img_p = pad_axis(pad_axis(img_p, 1, 0, hp - h, "edge"),
                     2, 0, wp - w, "edge")

    def tiles(a):
        a = pad_axis(pad_axis(a, 1, 0, hp - h, "edge"), 2, 0, wp - w, "edge")
        return (a.reshape(n, ty, tile_h, tx, tile_w).permute(0, 1, 3, 2, 4)
                .reshape(n, nt, tile_h, tile_w))

    ox_t = tiles(ox)
    oy_t = tiles(oy)
    off_x = torch.clamp(torch.round(ox_t.float().mean(dim=(2, 3))),
                        -max_off, max_off).to(torch.int64)
    off_y = torch.clamp(torch.round(oy_t.float().mean(dim=(2, 3))),
                        -max_off, max_off).to(torch.int64)
    bh, bw = tile_h + 2 * margin, tile_w + 2 * margin
    tys = torch.arange(ty, device=dev).repeat_interleave(tx)
    txs = torch.arange(tx, device=dev).repeat(ty)
    rows = (tys * tile_h + off_y + pad - margin)[..., None] \
        + torch.arange(bh, device=dev)
    cols = (txs * tile_w + off_x + pad - margin)[..., None] \
        + torch.arange(bw, device=dev)
    which = torch.arange(n, device=dev)[:, None, None, None]
    blocks = img_p[which, rows[..., :, None], cols[..., None, :]]
    blocks = blocks.permute(0, 4, 1, 2, 3)
    rx = torch.clamp(ox_t - off_x[..., None, None], -margin, margin)
    ry = torch.clamp(oy_t - off_y[..., None, None], -margin, margin)
    rx_ext = pad_axis(rx, 2, margin, margin, "edge")
    xsel = rx_ext + margin + torch.arange(tile_w, device=dev)
    accx = blocks.gather(4, xsel[:, None].expand(-1, c, -1, -1, -1))
    ysel = ry + margin + torch.arange(tile_h, device=dev)[:, None]
    out = accx.gather(3, ysel[:, None].expand(-1, c, -1, -1, -1))
    out = (out.reshape(n, c, ty, tx, tile_h, tile_w)
           .permute(0, 1, 2, 4, 3, 5).reshape(n, c, hp, wp))
    return out.permute(0, 2, 3, 1)[:, :h, :w]


def _hat(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


def tile_offsets(flow: torch.Tensor, tile_h: int, tile_w: int,
                 max_off: int) -> torch.Tensor:
    """clip(rint(mean flow), +-max_off) per tile of a (B, H, W, 2) flow
    edge-padded to the tile grid: (B, ty, tx, 2) int32 as (ox, oy)."""
    nb, h, w, _ = flow.shape
    hp = -(-h // tile_h) * tile_h
    wp = -(-w // tile_w) * tile_w
    flow_p = flow
    if hp > h:
        flow_p = torch.cat([flow_p, flow_p[:, -1:].expand(-1, hp - h, -1, -1)],
                           dim=1)
    if wp > w:
        flow_p = torch.cat([flow_p, flow_p[:, :, -1:].expand(-1, -1, wp - w,
                                                             -1)], dim=2)
    mean = flow_p.reshape(nb, hp // tile_h, tile_h, wp // tile_w, tile_w,
                          2).mean(dim=(2, 4))
    return torch.clamp(torch.round(mean), -max_off, max_off).to(torch.int32)


# the warp kernel's tile, residual margin and offset clamp
WARP_TILE = (64, 128)
WARP_MARGIN = 8
WARP_MAX_OFF = 96


def warp_tiled(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """W(x) = img(x + flow(x)), bilinear, clamp-to-edge, on (B, H, W, C)
    images and (B, H, W, 2) flows: per (64, 128) tile the integer offset
    clip(rint(mean flow)), the residual clamped to +-(margin - 1e-3) and
    applied by two separable hat passes, x over the block rows (residual
    edge-extended), then y."""
    tile_h, tile_w = WARP_TILE
    margin, max_off = WARP_MARGIN, WARP_MAX_OFF
    nb, h, w, c = img.shape
    dev = img.device
    hp = -(-h // tile_h) * tile_h
    wp = -(-w // tile_w) * tile_w
    ty, tx = hp // tile_h, wp // tile_w
    nt = ty * tx
    off = tile_offsets(flow, tile_h, tile_w, max_off).reshape(nb, nt, 2)
    pad = max_off + margin + 1
    planes = img.permute(0, 3, 1, 2)
    big = pad_axis(pad_axis(planes, -2, pad, pad + hp - h, "edge"), -1, pad,
                   pad + wp - w, "edge")
    bh, bw = tile_h + 2 * margin + 1, tile_w + 2 * margin + 1
    tys = torch.arange(ty, device=dev).repeat_interleave(tx)
    txs = torch.arange(tx, device=dev).repeat(ty)
    off = off.to(torch.int64)
    rows = (tys[None] * tile_h + off[..., 1] + pad - margin)[..., None] \
        + torch.arange(bh, device=dev)
    cols = (txs[None] * tile_w + off[..., 0] + pad - margin)[..., None] \
        + torch.arange(bw, device=dev)
    bidx = torch.arange(nb, device=dev)[:, None, None, None]
    blocks = big.permute(0, 2, 3, 1)[bidx, rows[:, :, :, None],
                                     cols[:, :, None, :]]
    blocks = blocks.permute(0, 1, 4, 2, 3)
    flow_p = pad_axis(pad_axis(flow, 1, 0, hp - h, "edge"), 2, 0, wp - w,
                      "edge")
    f_t = (flow_p.reshape(nb, ty, tile_h, tx, tile_w, 2)
           .permute(0, 1, 3, 2, 4, 5).reshape(nb, nt, tile_h, tile_w, 2))
    res = f_t - off[:, :, None, None, :].to(f_t.dtype)
    lim = margin - 1e-3
    rx = torch.clamp(res[..., 0], -lim, lim)
    ry = torch.clamp(res[..., 1], -lim, lim)
    rx_ext = pad_axis(rx, 2, margin, margin + 1, "edge")[:, :, None]
    accx = torch.zeros((nb, nt, c, bh, tile_w), dtype=img.dtype, device=dev)
    for ox in range(-margin, margin + 1):
        accx = accx + _hat(rx_ext - ox) * blocks[..., ox + margin:
                                                 ox + margin + tile_w]
    ry = ry[:, :, None]
    accy = torch.zeros((nb, nt, c, tile_h, tile_w), dtype=img.dtype,
                       device=dev)
    for oy in range(-margin, margin + 1):
        accy = accy + _hat(ry - oy) * accx[..., oy + margin:
                                           oy + margin + tile_h, :]
    return (accy.reshape(nb, ty, tx, c, tile_h, tile_w)
            .permute(0, 1, 4, 2, 5, 3).reshape(nb, hp, wp, c))[:, :h, :w]
