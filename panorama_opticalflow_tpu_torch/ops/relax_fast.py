"""Gather-free relaxation (port of the reference's ``ops/relax_fast.py``).

Two coarse-to-fine identities turn the per-candidate bilinear fetch of
the error function (CPU/PixFlow.hpp:407-456) into stencils:

1. warp recentring: the level's incoming flow ``f_base`` is applied to
   the gradient images once, ``W1g(u) = I1g(u + f_base(u))``, so in-level
   candidates only need samples at a bounded offset ``f - f_base``;
2. a bounded bilinear sample is a hat-weighted sum of shifted views,
   evaluated separably (an x pass, then y passes), which also yields the
   neighbour-offset sample maps and the analytic derivative maps.

On a leading batch of flow directions, ``relax_phase_fast`` is the plain
branch's relaxation: the plain version of the small levels' relax kernels
(``ops.kernels.small_relax_phase*``, levels below
``FlowParams.pallas_min_pixels``), which ``use_pallas=False`` runs at
every level.  ``warp_by_flow_tiled`` is the plain version of the CUDA
warp kernel (``ops.kernels.warp_tiled``).
"""

from __future__ import annotations

import torch

from panorama_opticalflow_tpu_torch.utils.config import FlowParams
from panorama_opticalflow_tpu_torch.ops.image import pad_axis


def _hat(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


def _dhat(t: torch.Tensor) -> torch.Tensor:
    # d/dt max(0, 1-|t|): -sign(t) inside the support
    return torch.where(torch.abs(t) < 1.0, -torch.sign(t),
                       torch.zeros_like(t))


def _pad2(x: torch.Tensor, top: int, bottom: int, left: int, right: int,
          mode: str = "edge") -> torch.Tensor:
    """Pad the last two dims."""
    return pad_axis(pad_axis(x, -2, top, bottom, mode), -1, left, right, mode)


def tile_offsets(flow: torch.Tensor, tile_h: int, tile_w: int,
                 max_off: int) -> torch.Tensor:
    """Per-tile integer warp offsets ``clip(rint(mean flow), +-max_off)``
    of a (B, H, W, 2) flow edge-padded to the tile grid: (B, ty, tx, 2)
    int32 as (ox, oy).  Shared by the plain warp and the CUDA kernel's
    wrapper, so both take the same offsets."""
    nb, h, w, _ = flow.shape
    hp = -(-h // tile_h) * tile_h
    wp = -(-w // tile_w) * tile_w
    # edge padding at the far end only: the last row and column repeated
    # (one copy, and no index tensor to send to the device)
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


def warp_by_flow_tiled(img: torch.Tensor, flow: torch.Tensor,
                       tile_h: int = 64, tile_w: int = 128, margin: int = 8,
                       max_off: int = 96) -> torch.Tensor:
    """W(x) = img(x + flow(x)), bilinear, clamp-to-edge, on (B, H, W, C)
    images and (B, H, W, 2) flows.

    Per (tile_h, tile_w) tile: integer offset = clip(rint(mean flow)); the
    residual, clamped to +-(margin - 1e-3), is applied by two separable
    hat passes -- x over the block rows (residual edge-extended), then y.
    """
    nb, h, w, c = img.shape
    dev = img.device
    hp = -(-h // tile_h) * tile_h
    wp = -(-w // tile_w) * tile_w
    ty, tx = hp // tile_h, wp // tile_w
    nt = ty * tx
    off = tile_offsets(flow, tile_h, tile_w, max_off).reshape(nb, nt, 2)

    # edge padding to the tile grid and by the block reach is clamped
    # indexing into the plane
    pad = max_off + margin + 1
    planes = img.permute(0, 3, 1, 2)                       # (B, C, H, W)
    big = _pad2(planes, pad, pad + hp - h, pad, pad + wp - w)

    bh, bw = tile_h + 2 * margin + 1, tile_w + 2 * margin + 1
    tys = torch.arange(ty, device=dev).repeat_interleave(tx)
    txs = torch.arange(tx, device=dev).repeat(ty)
    off = off.to(torch.int64)
    rows = (tys[None] * tile_h + off[..., 1] + pad - margin)[..., None] \
        + torch.arange(bh, device=dev)                     # (B, T, bh)
    cols = (txs[None] * tile_w + off[..., 0] + pad - margin)[..., None] \
        + torch.arange(bw, device=dev)                     # (B, T, bw)
    bidx = torch.arange(nb, device=dev)[:, None, None, None]
    blocks = big.permute(0, 2, 3, 1)[bidx, rows[:, :, :, None],
                                     cols[:, :, None, :]]  # (B,T,bh,bw,C)
    blocks = blocks.permute(0, 1, 4, 2, 3)                 # (B,T,C,bh,bw)

    flow_p = pad_axis(pad_axis(flow, 1, 0, hp - h, "edge"), 2, 0, wp - w,
                      "edge")
    f_t = (flow_p.reshape(nb, ty, tile_h, tx, tile_w, 2)
           .permute(0, 1, 3, 2, 4, 5).reshape(nb, nt, tile_h, tile_w, 2))
    res = f_t - off[:, :, None, None, :].to(torch.float32)
    lim = margin - 1e-3
    rx = torch.clamp(res[..., 0], -lim, lim)
    ry = torch.clamp(res[..., 1], -lim, lim)

    rx_ext = pad_axis(rx, 2, margin, margin + 1, "edge")[:, :, None]
    accx = torch.zeros((nb, nt, c, bh, tile_w), dtype=img.dtype, device=dev)
    for ox in range(-margin, margin + 1):
        sl = blocks[..., ox + margin:ox + margin + tile_w]
        accx = accx + _hat(rx_ext - ox) * sl
    ry = ry[:, :, None]
    accy = torch.zeros((nb, nt, c, tile_h, tile_w), dtype=img.dtype,
                       device=dev)
    for oy in range(-margin, margin + 1):
        sl = accx[..., oy + margin:oy + margin + tile_h, :]
        accy = accy + _hat(ry - oy) * sl
    out = (accy.reshape(nb, ty, tx, c, tile_h, tile_w)
           .permute(0, 1, 4, 2, 5, 3).reshape(nb, hp, wp, c))[:, :h, :w]
    return out


def sample_maps(w1_pad: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                D: int, with_neighbors: bool, with_grad: bool,
                with_sample: bool = True):
    """Separable hat-window sampling of the (B, 2, H+2(D+1), W+2(D+1))
    pre-padded warped-gradient planes at offsets (dx, dy), each (B, H, W).

    The x pass ``X(r,c) = sum_ox hat(dx(r,c)-ox) W1[r, c+ox]`` runs over
    rows [-(D+1), H+D+1) and cols [-1, W+1) with dx edge-extended; each
    sample map is then a y pass over X.  Returns (S, nbrs, Gx, Gy), each
    (B, 2, H, W): the sample at (x+dx, y+dy); the samples at the +-1
    offsets ('xp','xm','yp','ym' = +(0,1),(0,-1),(1,0),(-1,0)); and the
    analytic derivatives of S in dx and dy."""
    h, w = dx.shape[-2:]
    pad = D + 1
    lim = D - 1e-3
    dxc = torch.clamp(dx, -lim, lim)
    dyc = torch.clamp(dy, -lim, lim)
    r = D + 1
    dx_ext = _pad2(dxc, r, r, 1, 1)[:, None]
    xr, xw = h + 2 * r, w + 2
    dyc = dyc[:, None]

    def x_pass(weight_fn):
        acc = torch.zeros(w1_pad.shape[:2] + (xr, xw), dtype=torch.float32,
                          device=dx.device)
        for ox in range(-D, D + 1):
            v = w1_pad[..., :xr, pad - 1 + ox:pad - 1 + ox + xw]
            acc = acc + weight_fn(dx_ext - ox) * v
        return acc

    def y_pass(x_acc, weight_fn, ro, co):
        acc = torch.zeros(w1_pad.shape[:2] + (h, w), dtype=torch.float32,
                          device=dx.device)
        for oy in range(-D, D + 1):
            v = x_acc[..., r + oy + ro:r + oy + ro + h, 1 + co:1 + co + w]
            acc = acc + weight_fn(dyc - oy) * v
        return acc

    x_hat = x_pass(_hat)
    S = y_pass(x_hat, _hat, 0, 0) if with_sample else None
    nbrs = None
    if with_neighbors:
        nbrs = {
            "xp": y_pass(x_hat, _hat, 0, 1),
            "xm": y_pass(x_hat, _hat, 0, -1),
            "yp": y_pass(x_hat, _hat, 1, 0),
            "ym": y_pass(x_hat, _hat, -1, 0),
        }
    Gx = Gy = None
    if with_grad:
        Gy = y_pass(x_hat, _dhat, 0, 0)
        Gx = y_pass(x_pass(_dhat), _hat, 0, 0)
    return S, nbrs, Gx, Gy


def shift_edge(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """shifted[..., y, x] = a[..., y - dy, x - dx], edge padded."""
    h, w = a.shape[-2:]
    p = _pad2(a, max(dy, 0), max(-dy, 0), max(dx, 0), max(-dx, 0))
    y0, x0 = max(-dy, 0), max(-dx, 0)
    return p[..., y0:y0 + h, x0:x0 + w]


def _err_terms(i0x, i0y, sx, sy, cfx, cfy, bfx, bfy, params: FlowParams, w):
    d0 = i0x - sx
    d1 = i0y - sy
    data = torch.sqrt(d0 * d0 + d1 * d1)
    fdx = bfx - cfx
    fdy = bfy - cfy
    smooth = torch.sqrt(fdx * fdx + fdy * fdy)
    reg = (params.vertical_regularization_coef * torch.abs(cfy)
           + params.horizontal_regularization_coef * torch.abs(cfx)) / w
    return data + params.smoothness_coef * smooth + reg


def relax_phase_fast(flow: torch.Tensor, f_base: torch.Tensor,
                     w1g: torch.Tensor, i0x: torch.Tensor, i0y: torch.Tensor,
                     blurred_flow: torch.Tensor, update_mask: torch.Tensor,
                     params: FlowParams, iters: int, D: int = 3
                     ) -> torch.Tensor:
    """``iters`` Jacobi rounds of 4-neighbour propagation + descent on a
    batch: flows (B, H, W, 2), w1g (B, H, W, 2), i0x/i0y (B, H, W),
    update_mask (B, H, W) bool.  Out-of-image candidates are rejected
    (validity masks), as in ops.relax_exact.relax_iteration."""
    nb, h, w = i0x.shape
    pad = D + 1
    if params.w1_bf16:
        # quantise once at load, arithmetic stays f32 (kernel parity)
        w1g = w1g.to(torch.bfloat16).to(torch.float32)
    w1_pad = _pad2(w1g.permute(0, 3, 1, 2), pad, pad, pad, pad)
    cols = torch.arange(w, device=i0x.device)[None, :]
    rows = torch.arange(h, device=i0x.device)[:, None]
    valid = {"xp": cols >= 1, "xm": cols < w - 1,
             "yp": rows >= 1, "ym": rows < h - 1}
    fx, fy = flow[..., 0], flow[..., 1]
    bxb, byb = f_base[..., 0], f_base[..., 1]
    bfx, bfy = blurred_flow[..., 0], blurred_flow[..., 1]
    smooth = params.smoothness_coef

    for _ in range(iters):
        # ---- pass A: propagation ----
        S, nbrs, _, _ = sample_maps(w1_pad, fx - bxb, fy - byb, D, True, False)
        best_fx, best_fy = fx, fy
        best_sx, best_sy = S[:, 0], S[:, 1]
        best_e = _err_terms(i0x, i0y, best_sx, best_sy, fx, fy, bfx, bfy,
                            params, w)
        # candidate from LEFT: its sample at x is the left neighbour's own
        # +x map shifted right by one; same pattern for the others
        for key, dy, dx in (("xp", 0, 1), ("yp", 1, 0), ("xm", 0, -1),
                            ("ym", -1, 0)):
            cfx = shift_edge(fx, dy, dx)
            cfy = shift_edge(fy, dy, dx)
            samp = shift_edge(nbrs[key], dy, dx)
            e = _err_terms(i0x, i0y, samp[:, 0], samp[:, 1], cfx, cfy,
                           bfx, bfy, params, w)
            e = torch.where(valid[key], e, float("inf"))
            take = e < best_e
            best_fx = torch.where(take, cfx, best_fx)
            best_fy = torch.where(take, cfy, best_fy)
            best_e = torch.where(take, e, best_e)
            best_sx = torch.where(take, samp[:, 0], best_sx)
            best_sy = torch.where(take, samp[:, 1], best_sy)

        # ---- pass B: descent at the accepted flow ----
        ddx, ddy = best_fx - bxb, best_fy - byb
        if params.fold_descent_sample:
            # reuse the accepted candidate's sample from pass A
            _, _, Gx, Gy = sample_maps(w1_pad, ddx, ddy, D, False, True,
                                       with_sample=False)
            s2x, s2y = best_sx, best_sy
        else:
            S2, _, Gx, Gy = sample_maps(w1_pad, ddx, ddy, D, False, True)
            s2x, s2y = S2[:, 0], S2[:, 1]
        d0 = i0x - s2x
        d1 = i0y - s2y
        q = torch.sqrt(d0 * d0 + d1 * d1)
        inv_q = torch.where(q > 1e-12, 1.0 / q, torch.zeros_like(q))
        ddata_dfx = -(d0 * Gx[:, 0] + d1 * Gx[:, 1]) * inv_q
        ddata_dfy = -(d0 * Gy[:, 0] + d1 * Gy[:, 1]) * inv_q
        fdx = bfx - best_fx
        fdy = bfy - best_fy
        s = torch.sqrt(fdx * fdx + fdy * fdy)
        inv_s = torch.where(s > 1e-12, 1.0 / s, torch.zeros_like(s))
        gx = (ddata_dfx + smooth * (-fdx * inv_s)
              + params.horizontal_regularization_coef
              * torch.sign(best_fx) / w)
        gy = (ddata_dfy + smooth * (-fdy * inv_s)
              + params.vertical_regularization_coef
              * torch.sign(best_fy) / w)
        fx = torch.where(update_mask,
                         best_fx - params.gradient_step_size * gx, fx)
        fy = torch.where(update_mask,
                         best_fy - params.gradient_step_size * gy, fy)
    return torch.stack([fx, fy], dim=-1)
