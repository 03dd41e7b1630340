"""Directional first-hit distance fields (port of the reference's
``ops/distance.py``).

The reference's per-pixel 8-ray searches (CPU/StitchTool.cpp:75-94 and
148-191) become, per direction, a suffix min-scan over that direction's
lines: flips for the negative directions, a row shear for the diagonals
and a stride reshape for the ray step.  The scans are ``torch.cummin`` /
``torch.cummax`` (the reference's ``lax.associative_scan``); min and max
are exact, so the fields are bit-identical to the reference's, including
its boundary rule (candidates in column 0 are invisible to -x rays and in
row 0 to -y rays).
"""

from __future__ import annotations

import math

import torch

_INF = float("inf")


def _first_hit_steps(mask: torch.Tensor, axis: int,
                     reverse: bool) -> torch.Tensor:
    """Steps (>= 0) along ``axis`` to the first True at-or-after each
    position in scan direction; +inf where none."""
    n = mask.shape[axis]
    shape = [1] * mask.dim()
    shape[axis] = n
    idx = torch.arange(n, dtype=torch.float32,
                       device=mask.device).view(shape).expand(mask.shape)
    if reverse:
        # looking toward decreasing index: first True at-or-before
        vals = torch.where(mask, idx, torch.full_like(idx, -_INF))
        best = torch.cummax(vals, dim=axis).values
        return idx - best
    vals = torch.where(mask, idx, torch.full_like(idx, _INF))
    best = torch.cummin(vals.flip(axis), dim=axis).values.flip(axis)
    return best - idx


def _strided_first_hit(mask: torch.Tensor, axis: int, step: int,
                       reverse: bool) -> torch.Tensor:
    """First-hit pixel distance along ``axis`` (0 or 1 of an (H, W) mask)
    visiting only positions i, i+step, i+2*step, ..."""
    if step == 1:
        return _first_hit_steps(mask, axis, reverse)
    n = mask.shape[axis]
    nq = -(-n // step)
    pad = nq * step - n
    if axis == 0:
        m = torch.cat([mask, mask.new_zeros((pad, mask.shape[1]))], 0)
        m = m.reshape(nq, step, mask.shape[1])
        d = _first_hit_steps(m, 0, reverse) * step
        return d.reshape(nq * step, mask.shape[1])[:n]
    m = torch.cat([mask, mask.new_zeros((mask.shape[0], pad))], 1)
    m = m.reshape(mask.shape[0], nq, step)
    d = _first_hit_steps(m, 1, reverse) * step
    return d.reshape(mask.shape[0], nq * step)[:, :n]


def _shear_by_row(a: torch.Tensor, wc: int) -> torch.Tensor:
    """out[y, x + y] = a[y, x]; output (H, wc), unsourced entries zero."""
    h, w = a.shape
    p = torch.cat([a, a.new_zeros((h, wc + 1 - w))], 1)
    return p.reshape(-1)[: h * wc].reshape(h, wc)


def _unshear_by_row(a: torch.Tensor, w: int) -> torch.Tensor:
    """Inverse of _shear_by_row: out[y, x] = a[y, x + y], output (H, w)."""
    h, wc = a.shape
    flat = torch.cat([a.reshape(-1), a.new_zeros(h)])
    return flat.reshape(h, wc + 1)[:, :w]


def _shear(mask: torch.Tensor, sign: int) -> torch.Tensor:
    """Reindex so diagonals become columns.  sign=+1 conserves x - y (the
    (+1,+1)/(-1,-1) diagonals), sign=-1 conserves x + y."""
    h, w = mask.shape
    wc = w + h - 1
    if sign > 0:
        return _shear_by_row(mask.flip(0), wc).flip(0)
    return _shear_by_row(mask, wc)


def _unshear(arr: torch.Tensor, sign: int, w: int) -> torch.Tensor:
    if sign > 0:
        return _unshear_by_row(arr.flip(0), w).flip(0)
    return _unshear_by_row(arr, w)


def eight_ray_min_distance(mask: torch.Tensor, step: int, max_i: float,
                           diag_scale: float | None = None) -> torch.Tensor:
    """Min distance from each pixel to a True pixel of ``mask`` along the
    reference's 8 rays with stride ``step``, visiting i in
    [0, step, 2*step, ...) with i < max_i.  Straight rays measure i,
    diagonal rays i*diag_scale (sqrt(2) by default).  +inf where no ray
    hits."""
    h, w = mask.shape
    no_col0 = mask.clone()
    no_col0[:, 0] = False
    no_row0 = mask.clone()
    no_row0[0, :] = False
    no_both = no_col0.clone()
    no_both[0, :] = False

    def keep(d):
        return torch.where(d < max_i, d, torch.full_like(d, _INF))

    dists = [
        keep(_strided_first_hit(mask, 1, step, reverse=False)),
        keep(_strided_first_hit(no_col0, 1, step, reverse=True)),
        keep(_strided_first_hit(mask, 0, step, reverse=False)),
        keep(_strided_first_hit(no_row0, 0, step, reverse=True)),
    ]
    sq2 = math.sqrt(2.0) if diag_scale is None else diag_scale
    for m, sign, rev in ((mask, +1, False), (no_both, +1, True),
                         (no_col0, -1, False), (no_row0, -1, True)):
        d = keep(_strided_first_hit(_shear(m, sign), 0, step, rev))
        dists.append(_unshear(d, sign, w) * sq2)

    out = dists[0]
    for d in dists[1:]:
        out = torch.minimum(out, d)
    return out


_I16_INF = 32000  # sentinel; adds stay < int16 max


def _shift_i16(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = a[y + dy, x + dx]; the sentinel outside the array."""
    h, w = a.shape
    out = torch.full_like(a, _I16_INF)
    ys, ye = max(-dy, 0), h - max(dy, 0)
    xs, xe = max(-dx, 0), w - max(dx, 0)
    if ye > ys and xe > xs:
        out[ys:ye, xs:xe] = a[ys + dy:ye + dy, xs + dx:xe + dx]
    return out


def two_class_hole_search(mask_l: torch.Tensor, mask_r: torch.Tensor,
                          radius: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather's hole search for both classes in one int16 doubling field:
    v = 2*d + (class == R), so min() orders by distance with L winning
    ties (CPU/StitchTool.cpp:77-94).  Rays are bounded by ``radius``
    unit steps and stop at the array edge.  Returns (found, take_l)."""
    inf = torch.full(mask_l.shape, _I16_INF, dtype=torch.int16,
                     device=mask_l.device)
    v0 = torch.where(mask_l, torch.zeros_like(inf),
                     torch.where(mask_r, torch.ones_like(inf), inf))
    either = mask_l | mask_r
    h, w = v0.shape
    row0 = torch.zeros_like(either)
    row0[0, :] = True
    col0 = torch.zeros_like(either)
    col0[:, 0] = True
    v_nc0 = torch.where(col0 & either, inf, v0)
    v_nr0 = torch.where(row0 & either, inf, v0)
    v_nb = torch.where((row0 | col0) & either, inf, v0)

    def ray(v, dy, dx):
        d = v
        k = 1
        while k < radius:
            d = torch.minimum(d, _shift_i16(d, dy * k, dx * k) + 2 * k)
            k <<= 1
        return d

    out = ray(v0, 0, 1)
    for v, dy, dx in ((v_nc0, 0, -1), (v0, 1, 0), (v_nr0, -1, 0),
                      (v0, 1, 1), (v_nb, -1, -1),
                      (v_nc0, 1, -1), (v_nr0, -1, 1)):
        out = torch.minimum(out, ray(v, dy, dx))
    found = out < 2 * radius  # v = 2d + c < 2r  <=>  d < r
    take_l = (out & 1) == 0
    return found, take_l
