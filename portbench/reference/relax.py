"""The relaxation of the flow solver's fast levels: warp recentring, then
bounded hat-window sampling as shifted views (an x pass, then y passes),
4-neighbour propagation and one descent step an iteration.

``relax_phase_fast`` is the level path below the kernels' size (validity
masks, the reflect-101 target blur done by the caller);
``relax_fused``, ``relax_unfused`` and ``median5_diffuse`` are the
contracts of the solver's relax and median kernels on larger levels: the
whole edge-padded plane iterated as one window."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.config import FlowParams
from portbench.reference.image import gaussian_kernel_1d, pad_axis


def _hat(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


def _dhat(t: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(t) < 1.0, -torch.sign(t),
                       torch.zeros_like(t))


def pad2(x: torch.Tensor, top: int, bottom: int, left: int, right: int,
         mode: str = "edge") -> torch.Tensor:
    return pad_axis(pad_axis(x, -2, top, bottom, mode), -1, left, right, mode)


def sample_maps(w1_pad: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                D: int, with_neighbors: bool, with_grad: bool,
                with_sample: bool = True):
    """Hat-window samples of the (B, 2, H+2(D+1), W+2(D+1)) padded planes
    at offsets (dx, dy): (S, the samples at the four +-1 offsets, dS/dx,
    dS/dy), each (B, 2, H, W)."""
    h, w = dx.shape[-2:]
    pad = D + 1
    lim = D - 1e-3
    dxc = torch.clamp(dx, -lim, lim)
    dyc = torch.clamp(dy, -lim, lim)
    r = D + 1
    dx_ext = pad2(dxc, r, r, 1, 1)[:, None]
    xr, xw = h + 2 * r, w + 2
    dyc = dyc[:, None]

    def x_pass(weight_fn):
        acc = torch.zeros(w1_pad.shape[:2] + (xr, xw), dtype=w1_pad.dtype,
                          device=dx.device)
        for ox in range(-D, D + 1):
            v = w1_pad[..., :xr, pad - 1 + ox:pad - 1 + ox + xw]
            acc = acc + weight_fn(dx_ext - ox) * v
        return acc

    def y_pass(x_acc, weight_fn, ro, co):
        acc = torch.zeros(w1_pad.shape[:2] + (h, w), dtype=w1_pad.dtype,
                          device=dx.device)
        for oy in range(-D, D + 1):
            v = x_acc[..., r + oy + ro:r + oy + ro + h, 1 + co:1 + co + w]
            acc = acc + weight_fn(dyc - oy) * v
        return acc

    x_hat = x_pass(_hat)
    S = y_pass(x_hat, _hat, 0, 0) if with_sample else None
    nbrs = None
    if with_neighbors:
        nbrs = {"xp": y_pass(x_hat, _hat, 0, 1),
                "xm": y_pass(x_hat, _hat, 0, -1),
                "yp": y_pass(x_hat, _hat, 1, 0),
                "ym": y_pass(x_hat, _hat, -1, 0)}
    Gx = Gy = None
    if with_grad:
        Gy = y_pass(x_hat, _dhat, 0, 0)
        Gx = y_pass(x_pass(_dhat), _hat, 0, 0)
    return S, nbrs, Gx, Gy


def shift_edge(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """shifted[..., y, x] = a[..., y - dy, x - dx], edge padded."""
    h, w = a.shape[-2:]
    p = pad2(a, max(dy, 0), max(-dy, 0), max(dx, 0), max(-dx, 0))
    y0, x0 = max(-dy, 0), max(-dx, 0)
    return p[..., y0:y0 + h, x0:x0 + w]


def _quantised(w1: torch.Tensor, params: FlowParams) -> torch.Tensor:
    if params.w1_bf16:
        return w1.to(torch.bfloat16).to(params.dtype)
    return w1


# the candidates of the propagation, in their order of trial
_NEIGHBOURS = (("xp", 0, 1), ("yp", 1, 0), ("xm", 0, -1), ("ym", -1, 0))


def relax_phase_fast(flow, f_base, w1g, i0x, i0y, blurred_flow, update_mask,
                     params: FlowParams, iters: int, D: int) -> torch.Tensor:
    """``iters`` rounds of propagation and descent on (B, H, W, 2) flows;
    out-of-image candidates are rejected."""
    nb, h, w = i0x.shape
    pad = D + 1
    w1_pad = pad2(_quantised(w1g, params).permute(0, 3, 1, 2), pad, pad, pad,
                  pad)
    cols = torch.arange(w, device=i0x.device)[None, :]
    rows = torch.arange(h, device=i0x.device)[:, None]
    valid = {"xp": cols >= 1, "xm": cols < w - 1,
             "yp": rows >= 1, "ym": rows < h - 1}
    fx, fy = flow[..., 0], flow[..., 1]
    bxb, byb = f_base[..., 0], f_base[..., 1]
    bfx, bfy = blurred_flow[..., 0], blurred_flow[..., 1]
    smooth = params.smoothness_coef

    def err(sx, sy, cfx, cfy):
        d0 = i0x - sx
        d1 = i0y - sy
        data = torch.sqrt(d0 * d0 + d1 * d1)
        fdx = bfx - cfx
        fdy = bfy - cfy
        sm = torch.sqrt(fdx * fdx + fdy * fdy)
        reg = (params.vertical_regularization_coef * torch.abs(cfy)
               + params.horizontal_regularization_coef * torch.abs(cfx)) / w
        return data + smooth * sm + reg

    for _ in range(iters):
        S, nbrs, _, _ = sample_maps(w1_pad, fx - bxb, fy - byb, D, True, False)
        best_fx, best_fy = fx, fy
        best_sx, best_sy = S[:, 0], S[:, 1]
        best_e = err(best_sx, best_sy, fx, fy)
        for key, dy, dx in _NEIGHBOURS:
            cfx = shift_edge(fx, dy, dx)
            cfy = shift_edge(fy, dy, dx)
            samp = shift_edge(nbrs[key], dy, dx)
            e = err(samp[:, 0], samp[:, 1], cfx, cfy)
            e = torch.where(valid[key], e, float("inf"))
            take = e < best_e
            best_fx = torch.where(take, cfx, best_fx)
            best_fy = torch.where(take, cfy, best_fy)
            best_e = torch.where(take, e, best_e)
            best_sx = torch.where(take, samp[:, 0], best_sx)
            best_sy = torch.where(take, samp[:, 1], best_sy)
        _, _, Gx, Gy = sample_maps(w1_pad, best_fx - bxb, best_fy - byb, D,
                                   False, True, with_sample=False)
        d0 = i0x - best_sx
        d1 = i0y - best_sy
        q = torch.sqrt(d0 * d0 + d1 * d1)
        inv_q = torch.where(q > 1e-12, 1.0 / q, torch.zeros_like(q))
        ddx = -(d0 * Gx[:, 0] + d1 * Gx[:, 1]) * inv_q
        ddy = -(d0 * Gy[:, 0] + d1 * Gy[:, 1]) * inv_q
        fdx = bfx - best_fx
        fdy = bfy - best_fy
        s = torch.sqrt(fdx * fdx + fdy * fdy)
        inv_s = torch.where(s > 1e-12, 1.0 / s, torch.zeros_like(s))
        gx = (ddx + smooth * (-fdx * inv_s)
              + params.horizontal_regularization_coef * torch.sign(best_fx)
              / w)
        gy = (ddy + smooth * (-fdy * inv_s)
              + params.vertical_regularization_coef * torch.sign(best_fy)
              / w)
        fx = torch.where(update_mask, best_fx - params.gradient_step_size * gx,
                         fx)
        fy = torch.where(update_mask, best_fy - params.gradient_step_size * gy,
                         fy)
    return torch.stack([fx, fy], dim=-1)


def _reg_w(params: FlowParams, w: int) -> tuple[float, float]:
    """(vreg/w, hreg/w) rounded to float32, as the kernels take them."""
    return (float(np.float32(params.vertical_regularization_coef / w)),
            float(np.float32(params.horizontal_regularization_coef / w)))


def _relax_window(fxp, fyp, bxb, byb, bfx, bfy, w1, i0xp, i0yp, mp,
                  params: FlowParams, iters: int, D: int, w: int):
    """The kernels' iterations on edge-padded (B, Hp, Wp) planes, halo
    iters + D + 2; ``w1`` (B, 2, H, W) unpadded.  Shifts replicate the
    window's edge (no validity masks)."""
    halo = iters + D + 2
    w1_pad = pad2(_quantised(w1, params), halo + D + 1, halo + D + 1,
                  halo + D + 1, halo + D + 1)
    vreg_w, hreg_w = _reg_w(params, w)
    smooth = params.smoothness_coef
    step = params.gradient_step_size

    def err(sx, sy, cfx, cfy):
        d0 = i0xp - sx
        d1 = i0yp - sy
        data = torch.sqrt(d0 * d0 + d1 * d1)
        fdx = bfx - cfx
        fdy = bfy - cfy
        sm = torch.sqrt(fdx * fdx + fdy * fdy)
        return data + smooth * sm + vreg_w * torch.abs(cfy) \
            + hreg_w * torch.abs(cfx)

    for _ in range(iters):
        S, nbrs, _, _ = sample_maps(w1_pad, fxp - bxb, fyp - byb, D, True,
                                    False)
        best_fx, best_fy = fxp, fyp
        best_sx, best_sy = S[:, 0], S[:, 1]
        best_e = err(best_sx, best_sy, fxp, fyp)
        for key, dy, dx in _NEIGHBOURS:
            cfx = shift_edge(fxp, dy, dx)
            cfy = shift_edge(fyp, dy, dx)
            samp = shift_edge(nbrs[key], dy, dx)
            e = err(samp[:, 0], samp[:, 1], cfx, cfy)
            take = e < best_e
            best_fx = torch.where(take, cfx, best_fx)
            best_fy = torch.where(take, cfy, best_fy)
            best_e = torch.where(take, e, best_e)
            best_sx = torch.where(take, samp[:, 0], best_sx)
            best_sy = torch.where(take, samp[:, 1], best_sy)
        _, _, Gx, Gy = sample_maps(w1_pad, best_fx - bxb, best_fy - byb, D,
                                   False, True, with_sample=False)
        d0 = i0xp - best_sx
        d1 = i0yp - best_sy
        q = torch.sqrt(d0 * d0 + d1 * d1)
        inv_q = torch.where(q > 1e-12, 1.0 / q, torch.zeros_like(q))
        ddx = -(d0 * Gx[:, 0] + d1 * Gx[:, 1]) * inv_q
        ddy = -(d0 * Gy[:, 0] + d1 * Gy[:, 1]) * inv_q
        fdx = bfx - best_fx
        fdy = bfy - best_fy
        sv = torch.sqrt(fdx * fdx + fdy * fdy)
        inv_s = torch.where(sv > 1e-12, 1.0 / sv, torch.zeros_like(sv))
        gx = ddx + smooth * (-fdx * inv_s) + hreg_w * torch.sign(best_fx)
        gy = ddy + smooth * (-fdy * inv_s) + vreg_w * torch.sign(best_fy)
        upd = mp > 0
        fxp = torch.where(upd, best_fx - step * gx, fxp)
        fyp = torch.where(upd, best_fy - step * gy, fyp)
    return fxp, fyp


def _crop(fxp, fyp, halo: int, h: int, w: int):
    return (fxp[..., halo:halo + h, halo:halo + w],
            fyp[..., halo:halo + h, halo:halo + w])


def relax_fused(fx, fy, bx, by, w1x, w1y, i0x, i0y, mask,
                params: FlowParams, iters: int, D: int):
    """The fused relax kernel's contract on (B, H, W) planes: the target
    is the separable Gaussian (x first) of the f_base planes ``bx``/``by``
    edge-padded by the halo and a further kernel radius."""
    nb, h, w = fx.shape
    halo = iters + D + 2
    kw = params.blurred_flow_kernel_width
    gr = kw // 2
    taps = gaussian_kernel_1d(kw, params.blurred_flow_sigma)
    hp, wp = h + 2 * halo, w + 2 * halo

    def blur_valid(a):
        acc = torch.zeros((nb, hp + 2 * gr, wp), dtype=a.dtype,
                          device=a.device)
        for t in range(kw):
            acc = acc + float(taps[t]) * a[..., t:t + wp]
        out = torch.zeros((nb, hp, wp), dtype=a.dtype, device=a.device)
        for t in range(kw):
            out = out + float(taps[t]) * acc[..., t:t + hp, :]
        return out

    n = halo + gr
    bxg, byg = pad2(bx, n, n, n, n), pad2(by, n, n, n, n)
    bxb = bxg[..., gr:gr + hp, gr:gr + wp]
    byb = byg[..., gr:gr + hp, gr:gr + wp]
    fxp, fyp, i0xp, i0yp, mp = (pad2(a, halo, halo, halo, halo)
                                for a in (fx, fy, i0x, i0y, mask))
    out = _relax_window(fxp, fyp, bxb, byb, blur_valid(bxg), blur_valid(byg),
                        torch.stack([w1x, w1y], dim=1), i0xp, i0yp, mp,
                        params, iters, D, w)
    return _crop(*out, halo, h, w)


def relax_unfused(fx, fy, bx, by, w1x, w1y, i0x, i0y, bfx, bfy, mask,
                  params: FlowParams, iters: int, D: int):
    """The unfused relax kernel's contract: the target ``bfx``/``bfy``
    given, edge-padded by the halo like every other plane."""
    nb, h, w = fx.shape
    halo = iters + D + 2
    padded = [pad2(a, halo, halo, halo, halo)
              for a in (fx, fy, bx, by, bfx, bfy, i0x, i0y, mask)]
    out = _relax_window(*padded[:6], torch.stack([w1x, w1y], dim=1),
                        *padded[6:], params, iters, D, w)
    return _crop(*out, halo, h, w)


def median5_diffuse(x: torch.Tensor, c: torch.Tensor, ksize: int,
                    sigma: float) -> torch.Tensor:
    """``c * gauss(med5(x)) + (1 - c) * med5(x)`` on (2B, H, W) planes
    with (B, H, W) coefficients: the median of the edge-replicated input
    over the blur margin, the blur separable (x first) over that
    field."""
    taps = gaussian_kernel_1d(ksize, sigma)
    gr = ksize // 2
    h, w = x.shape[-2:]
    xp = pad2(x, gr + 2, gr + 2, gr + 2, gr + 2)
    mh, mw = h + 2 * gr, w + 2 * gr
    stack = torch.stack([xp[..., dy:dy + mh, dx:dx + mw]
                         for dy in range(5) for dx in range(5)])
    med = torch.kthvalue(stack, 13, dim=0).values
    del stack
    acc = torch.zeros(x.shape[:-2] + (mh, w), dtype=x.dtype, device=x.device)
    for t in range(ksize):
        acc = acc + float(taps[t]) * med[..., t:t + w]
    blur = torch.zeros_like(x)
    for t in range(ksize):
        blur = blur + float(taps[t]) * acc[..., t:t + h, :]
    med_c = med[..., gr:gr + h, gr:gr + w]
    cc = c.repeat_interleave(2, dim=0)
    return cc * blur + (1.0 - cc) * med_c
