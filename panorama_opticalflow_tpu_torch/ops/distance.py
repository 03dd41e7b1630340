"""Directional first-hit distance fields (port of the reference's
``ops/distance.py``).

The reference's per-pixel 8-ray searches (CPU/StitchTool.cpp:75-94 and
148-191) become, per direction, a suffix min-scan over that direction's
lines: flips for the negative directions, a row shear for the diagonals
and a stride reshape for the ray step.  The scans are ``torch.cummin`` /
``torch.cummax`` (the reference's ``lax.associative_scan``); min and max
are exact, so the fields are bit-identical to the reference's, including
its boundary rule (candidates in column 0 are invisible to -x rays and in
row 0 to -y rays).  Every field takes (H, W) masks or a stack (N, H, W) of
N canvases, each searched as alone.
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
    """First-hit pixel distance along ``axis`` (-2 or -1 of (..., H, W)
    masks) visiting only positions i, i+step, i+2*step, ..."""
    if step == 1:
        return _first_hit_steps(mask, axis, reverse)
    ax = axis % mask.dim()
    n = mask.shape[ax]
    nq = -(-n // step)
    lead, tail = list(mask.shape[:ax]), list(mask.shape[ax + 1:])
    m = torch.cat([mask, mask.new_zeros(lead + [nq * step - n] + tail)], ax)
    # the axis split into (nq, step): a ray visits one residue class
    d = _first_hit_steps(m.reshape(lead + [nq, step] + tail), ax,
                         reverse) * step
    return d.reshape(lead + [nq * step] + tail).narrow(ax, 0, n)


def _shear_by_row(a: torch.Tensor, wc: int) -> torch.Tensor:
    """out[..., y, x + y] = a[..., y, x]; output (..., H, wc), unsourced
    entries zero."""
    lead, (h, w) = a.shape[:-2], a.shape[-2:]
    p = torch.cat([a, a.new_zeros(lead + (h, wc + 1 - w))], -1)
    return p.reshape(lead + (-1,))[..., : h * wc].reshape(lead + (h, wc))


def _unshear_by_row(a: torch.Tensor, w: int) -> torch.Tensor:
    """Inverse of _shear_by_row: out[..., y, x] = a[..., y, x + y], output
    (..., H, w)."""
    lead, (h, wc) = a.shape[:-2], a.shape[-2:]
    flat = torch.cat([a.reshape(lead + (-1,)), a.new_zeros(lead + (h,))], -1)
    return flat.reshape(lead + (h, wc + 1))[..., :w]


def _roll_x(a: torch.Tensor, shift) -> torch.Tensor:
    """``torch.roll`` along the last dim; ``shift`` is an int, or a 1-D
    integer tensor on ``a``'s device with one shift for each entry of the
    leading dim."""
    if isinstance(shift, int):
        return torch.roll(a, shift, dims=-1) if shift else a
    wc = a.shape[-1]
    s = shift.view((-1,) + (1,) * (a.dim() - 1))
    idx = (torch.arange(wc, device=a.device) - s) % wc
    return torch.gather(a, -1, idx.expand(a.shape))


def _shifts(h: int, sign: int, row_offset, total_h: int):
    """The column shift a shear adds on top of its reshape, from the global
    row offset of local row 0 (an int, or a tensor of one a leading
    entry)."""
    return total_h - h - row_offset if sign > 0 else row_offset


def _shear(mask: torch.Tensor, sign: int, row_offset=0,
           total_h: int | None = None) -> torch.Tensor:
    """Reindex so diagonals become columns.  sign=+1 conserves x - y (the
    (+1,+1)/(-1,-1) diagonals), sign=-1 conserves x + y:
    out[y, x - (y + off) + (TH - 1)] = mask[y, x] for sign=+1,
    out[y, x + (y + off)] = mask[y, x] for sign=-1.  Row tiles pass the
    global row offset ``row_offset`` of their local row 0 (an int, or a
    1-D tensor of one for each entry of a leading tile dim) and the global
    height ``total_h``; a diagonal is then the same column in every
    tile."""
    h, w = mask.shape[-2:]
    th = h if total_h is None else total_h
    wc = w + th - 1
    shift = _shifts(h, sign, row_offset, th)
    if sign > 0:
        return _roll_x(_shear_by_row(mask.flip(-2), wc), shift).flip(-2)
    return _roll_x(_shear_by_row(mask, wc), shift)


def _unshear(arr: torch.Tensor, sign: int, w: int, row_offset=0,
             total_h: int | None = None) -> torch.Tensor:
    """Inverse of ``_shear`` to width ``w``."""
    h = arr.shape[-2]
    th = h if total_h is None else total_h
    neg = -_shifts(h, sign, row_offset, th)
    if sign > 0:
        return _unshear_by_row(_roll_x(arr.flip(-2), neg), w).flip(-2)
    return _unshear_by_row(_roll_x(arr, neg), w)


def _without_first(mask: torch.Tensor, col: bool, row: bool) -> torch.Tensor:
    """``mask`` with column 0 and/or row 0 cleared: candidates there are
    invisible to -x and -y rays."""
    out = mask.clone()
    if col:
        out[..., :, 0].fill_(False)
    if row:
        out[..., 0, :].fill_(False)
    return out


def eight_ray_min_distance(mask: torch.Tensor, step: int, max_i: float,
                           diag_scale: float | None = None) -> torch.Tensor:
    """Min distance from each pixel to a True pixel of ``mask`` ((H, W), or
    (N, H, W) for N canvases at once) along the reference's 8 rays with
    stride ``step``, visiting i in [0, step, 2*step, ...) with i < max_i.
    Straight rays measure i, diagonal rays i*diag_scale (sqrt(2) by
    default).  +inf where no ray hits."""
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
    sq2 = math.sqrt(2.0) if diag_scale is None else diag_scale
    for m, sign, rev in ((mask, +1, False), (no_both, +1, True),
                         (no_col0, -1, False), (no_row0, -1, True)):
        d = keep(_strided_first_hit(_shear(m, sign), -2, step, rev))
        dists.append(_unshear(d, sign, w) * sq2)

    out = dists[0]
    for d in dists[1:]:
        out = torch.minimum(out, d)
    return out


def _shift_fill(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., y, x] = a[..., y + dy, x + dx]; ``fill`` outside the
    array."""
    h, w = a.shape[-2:]
    out = torch.full_like(a, fill)
    ys, ye = max(-dy, 0), h - max(dy, 0)
    xs, xe = max(-dx, 0), w - max(dx, 0)
    if ye > ys and xe > xs:
        out[..., ys:ye, xs:xe] = a[..., ys + dy:ye + dy, xs + dx:xe + dx]
    return out


def bounded_first_hit(mask: torch.Tensor, radius: int, dy: int,
                      dx: int) -> torch.Tensor:
    """Steps to the first True of ``mask`` along the unit direction
    (dy, dx), visiting i = 0, 1, 2, ... with i < radius; +inf where no
    hit.  Rays stop at the array edge.  Pointer-doubling min-plus: after
    the k-th pass d holds the exact first-hit distance within [0, 2^k)
    steps."""
    d = torch.full(mask.shape, _INF, dtype=torch.float32, device=mask.device)
    d = torch.where(mask, torch.zeros_like(d), d)
    k = 1
    while k < radius:
        d = torch.minimum(d, _shift_fill(d, dy * k, dx * k, _INF) + k)
        k <<= 1
    return torch.where(d < radius, d, torch.full_like(d, _INF))


def eight_ray_unit_min_distance(mask: torch.Tensor,
                                radius: int) -> torch.Tensor:
    """Min raw-step distance to a True pixel along the reference's 8 rays
    at unit stride, bounded by ``radius`` (Gather's hole search,
    CPU/StitchTool.cpp:75-94: straight and diagonal rays both count raw
    steps).  Boundary semantics match eight_ray_min_distance(mask, 1,
    radius, diag_scale=1.0).  The pipeline uses the fused
    two_class_hole_search; this single-class form is its semantic
    reference."""
    no_col0 = _without_first(mask, True, False)
    no_row0 = _without_first(mask, False, True)
    no_both = _without_first(mask, True, True)
    out = bounded_first_hit(mask, radius, 0, 1)
    for m, dy, dx in ((no_col0, 0, -1), (mask, 1, 0), (no_row0, -1, 0),
                      (mask, 1, 1), (no_both, -1, -1),
                      (no_col0, 1, -1), (no_row0, -1, 1)):
        out = torch.minimum(out, bounded_first_hit(m, radius, dy, dx))
    return out


_I16_INF = 32000  # sentinel; adds stay < int16 max


def two_class_hole_search(mask_l: torch.Tensor, mask_r: torch.Tensor,
                          radius: int,
                          row0_excluded: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather's hole search for both classes in one int16 doubling field:
    v = 2*d + (class == R), so min() orders by distance with L winning
    ties (CPU/StitchTool.cpp:77-94).  Rays are bounded by ``radius``
    unit steps and stop at the array edge.  Masks are (H, W), or
    (N, H, W) for N canvases searched together.  ``row0_excluded`` marks
    the pixels of the canvas's row 0, invisible to -y rays; by default
    the array's row 0 (row tiles pass where global row 0 lies).  Returns
    (found, take_l).  Exact for ``radius`` up to 256 (the passes' sums
    stay below int16's 32767).  It is the contract of the composite
    kernel (``ops.kernels.hole_composite``, whose plain version calls it)
    and the row-tiled path's search (``parallel.tiled._tiled_gather``)."""
    inf = torch.full(mask_l.shape, _I16_INF, dtype=torch.int16,
                     device=mask_l.device)
    v0 = torch.where(mask_l, torch.zeros_like(inf),
                     torch.where(mask_r, torch.ones_like(inf), inf))
    either = mask_l | mask_r
    if row0_excluded is None:
        no_row0 = _without_first(either, False, True)
    else:
        no_row0 = either & ~row0_excluded
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
    found = out < 2 * radius  # v = 2d + c < 2r  <=>  d < r
    take_l = (out & 1) == 0
    return found, take_l
