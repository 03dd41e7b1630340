"""Directional first-hit distance fields of the stitch's seam blend and
hole search (CPU/StitchTool.cpp:75-94, 148-191): per direction a suffix
min-scan over that direction's lines; flips for negative directions, a
row shear for the diagonals, a stride reshape for the ray step.
Candidates in column 0 are invisible to -x rays and in row 0 to -y rays,
as upstream.  (H, W) masks or (N, H, W) stacks."""

from __future__ import annotations

import math

import torch

_INF = float("inf")


def _first_hit_steps(mask: torch.Tensor, axis: int,
                     reverse: bool) -> torch.Tensor:
    n = mask.shape[axis]
    shape = [1] * mask.dim()
    shape[axis] = n
    idx = torch.arange(n, dtype=torch.float32,
                       device=mask.device).view(shape).expand(mask.shape)
    if reverse:
        vals = torch.where(mask, idx, torch.full_like(idx, -_INF))
        return idx - torch.cummax(vals, dim=axis).values
    vals = torch.where(mask, idx, torch.full_like(idx, _INF))
    return torch.cummin(vals.flip(axis), dim=axis).values.flip(axis) - idx


def _strided_first_hit(mask: torch.Tensor, axis: int, step: int,
                       reverse: bool) -> torch.Tensor:
    if step == 1:
        return _first_hit_steps(mask, axis, reverse)
    ax = axis % mask.dim()
    n = mask.shape[ax]
    nq = -(-n // step)
    lead, tail = list(mask.shape[:ax]), list(mask.shape[ax + 1:])
    m = torch.cat([mask, mask.new_zeros(lead + [nq * step - n] + tail)], ax)
    d = _first_hit_steps(m.reshape(lead + [nq, step] + tail), ax,
                         reverse) * step
    return d.reshape(lead + [nq * step] + tail).narrow(ax, 0, n)


def _shear_by_row(a: torch.Tensor, wc: int) -> torch.Tensor:
    """out[..., y, x + y] = a[..., y, x]."""
    lead, (h, w) = a.shape[:-2], a.shape[-2:]
    p = torch.cat([a, a.new_zeros(lead + (h, wc + 1 - w))], -1)
    return p.reshape(lead + (-1,))[..., : h * wc].reshape(lead + (h, wc))


def _unshear_by_row(a: torch.Tensor, w: int) -> torch.Tensor:
    lead, (h, wc) = a.shape[:-2], a.shape[-2:]
    flat = torch.cat([a.reshape(lead + (-1,)), a.new_zeros(lead + (h,))], -1)
    return flat.reshape(lead + (h, wc + 1))[..., :w]


def _shear(mask: torch.Tensor, sign: int) -> torch.Tensor:
    """Diagonals become columns: sign=+1 keeps x - y, sign=-1 x + y."""
    h, w = mask.shape[-2:]
    wc = w + h - 1
    if sign > 0:
        return _shear_by_row(mask.flip(-2), wc).flip(-2)
    return _shear_by_row(mask, wc)


def _unshear(arr: torch.Tensor, sign: int, w: int) -> torch.Tensor:
    if sign > 0:
        return _unshear_by_row(arr.flip(-2), w).flip(-2)
    return _unshear_by_row(arr, w)


def _without_first(mask: torch.Tensor, col: bool, row: bool) -> torch.Tensor:
    out = mask.clone()
    if col:
        out[..., :, 0] = False
    if row:
        out[..., 0, :] = False
    return out


def eight_ray_min_distance(mask: torch.Tensor, step: int,
                           max_i: float) -> torch.Tensor:
    """Min distance to a True pixel along the 8 rays with stride
    ``step``, i < max_i; diagonal rays measure i*sqrt(2); +inf where no
    ray hits."""
    w = mask.shape[-1]
    no_col0 = _without_first(mask, True, False)
    no_row0 = _without_first(mask, False, True)
    no_both = _without_first(mask, True, True)

    def keep(d):
        return torch.where(d < max_i, d, torch.full_like(d, _INF))

    dists = [
        keep(_strided_first_hit(mask, -1, step, reverse=False)),
        keep(_strided_first_hit(no_col0, -1, step, reverse=True)),
        keep(_strided_first_hit(mask, -2, step, reverse=False)),
        keep(_strided_first_hit(no_row0, -2, step, reverse=True)),
    ]
    sq2 = math.sqrt(2.0)
    for m, sign, rev in ((mask, +1, False), (no_both, +1, True),
                         (no_col0, -1, False), (no_row0, -1, True)):
        d = keep(_strided_first_hit(_shear(m, sign), -2, step, rev))
        dists.append(_unshear(d, sign, w) * sq2)
    out = dists[0]
    for d in dists[1:]:
        out = torch.minimum(out, d)
    return out


def _shift_fill(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., y, x] = a[..., y + dy, x + dx]; ``fill`` outside."""
    h, w = a.shape[-2:]
    out = torch.full_like(a, fill)
    ys, ye = max(-dy, 0), h - max(dy, 0)
    xs, xe = max(-dx, 0), w - max(dx, 0)
    if ye > ys and xe > xs:
        out[..., ys:ye, xs:xe] = a[..., ys + dy:ye + dy, xs + dx:xe + dx]
    return out


_I16_INF = 32000


def two_class_hole_search(mask_l: torch.Tensor, mask_r: torch.Tensor,
                          radius: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather's hole search (CPU/StitchTool.cpp:77-94): the nearest L or
    R pixel along the 8 unit-step rays within ``radius`` steps, L winning
    ties, as v = 2*d + (class == R) under min().  Returns (found,
    take_l)."""
    inf = torch.full(mask_l.shape, _I16_INF, dtype=torch.int16,
                     device=mask_l.device)
    v0 = torch.where(mask_l, torch.zeros_like(inf),
                     torch.where(mask_r, torch.ones_like(inf), inf))
    either = mask_l | mask_r
    no_row0 = _without_first(either, False, True)
    v_nc0 = torch.where(_without_first(either, True, False), v0, inf)
    v_nr0 = torch.where(no_row0, v0, inf)
    v_nb = torch.where(_without_first(no_row0, True, False), v0, inf)

    def ray(v, dy, dx):
        d = v
        k = 1
        while k < radius:
            d = torch.minimum(d, _shift_fill(d, dy * k, dx * k, _I16_INF)
                              + 2 * k)
            k <<= 1
        return d

    out = ray(v0, 0, 1)
    for v, dy, dx in ((v_nc0, 0, -1), (v0, 1, 0), (v_nr0, -1, 0),
                      (v0, 1, 1), (v_nb, -1, -1),
                      (v_nc0, 1, -1), (v_nr0, -1, 1)):
        out = torch.minimum(out, ray(v, dy, dx))
    return out < 2 * radius, (out & 1) == 0
