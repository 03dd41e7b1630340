"""Row-tiled stitch with halo exchange (port of the reference's
``parallel/tiled.py``, its shard_map form ``tiled_compute_optical_flow_pair``
/ ``_tiled_stitch_pair_body``).

The canvas and every pyramid level are cut into row tiles; x stays whole
in a tile, so the wrap extensions of the equirectangular canvas stay
local.  The tile bodies are written once over a leading tile axis,
``(T, h_loc, ...)``, against a row communicator (``parallel.mesh``): in
process all n tiles form one stack (T = n) on one device; under
``torch.distributed`` a rank holds one tile (T = 1).

* elementwise stages (map, overlap, combine weights) are local;
* stencil stages run on halo-extended tiles and crop the margin;
* resizes between levels gather source rows by global index from the
  halo-extended tile, with the untiled resize's taps in its order, so a
  tiled resize gives the untiled resize's bits;
* the blend field's distance scans run row-local in x; in y and along the
  diagonals each tile scans its own rows and the tiles exchange a
  (step, W) summary (``_sharded_strided_first_hit_axis0``), exact;
* pyramid levels too small to tile are computed whole from the gathered
  rows.  A level's solver is the port's ``pixflow.patch_match_level_batched``
  on the halo-extended tile stack, with the same CUDA kernels as the
  untiled path; the coarsest level starts from ``pixflow.coarsest_start``
  (the init-floor twin's flow, the search init or zero flow), as in
  ``pixflow.compute_optical_flow_pairs``.

Two documented deviations from the untiled program come along from the
reference as they are: (a) the global top and bottom rows of stencil
stages see reflect fill instead of each op's own border; (b) flow
sampling in the relaxation is clamped to the halo, so |flow_y| beyond the
level's halo is truncated.  Two behaviours follow from the tile shape:
``FlowParams.pallas_min_pixels`` and the combiner's sampler switch look
at the extended tile's shape, and the tiled warp's 64 x 128 grid starts at
each extended tile's row 0.  The tiled blend ignores ``blend_scale``
(``_tiled_generate_blend``).  What the reference's TPU machinery needs
(hybrid flow mode, kernel gates inside shard_map, miscompile canaries, the
rung scan) has no counterpart.

On a card the in-process stitch (``InProcessRows``) is one captured
program a static key (``utils.programs``), the counterpart of the
reference's ``_tiled_stitch_jit``; a ``DistributedRows`` stitch runs
eagerly (``tiled_stitch_pair``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from panorama_opticalflow_tpu_torch import _as_canvas
from panorama_opticalflow_tpu_torch.models import novel_view, pixflow, stitcher
from panorama_opticalflow_tpu_torch.models.stitcher import (place_cols,
                                                          window_cols)
from panorama_opticalflow_tpu_torch.ops import image as im
from panorama_opticalflow_tpu_torch.ops.distance import (
    _shear, _strided_first_hit, _unshear, two_class_hole_search)
from panorama_opticalflow_tpu_torch.parallel.mesh import InProcessRows, RowComm
from panorama_opticalflow_tpu_torch.utils import programs
from panorama_opticalflow_tpu_torch.utils.config import (FlowParams,
                                                         StitchConfig)

MEDIAN_RADIUS = 2   # the port's median is 5 x 5


def derive_level_halo(params: FlowParams, flow_sample_margin: int = 22) -> int:
    """Receptive radius of one pyramid level's stencil chain, plus a margin
    for the flow-guided gradient sampling: the gradient (1 + gk//2), the
    blurred-flow target (bk//2), per phase ``iters`` one-pixel propagations
    and the 5 x 5 median, the final diffusion blur (bk//2).  The warp's
    |flow_y| reach is unbounded (deviation (b)); ``flow_sample_margin``
    covers it."""
    grad = 1 + params.gradient_blur_kernel_width // 2
    bk = params.blurred_flow_kernel_width // 2
    phases = params.relax_phases * (params.relax_iters_per_phase
                                    + MEDIAN_RADIUS)
    return grad + bk + phases + bk + flow_sample_margin


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """min_tiled_rows: a level whose tiles would hold fewer rows is
    computed whole.  level_halo: rows each tile borrows from each neighbour
    at a level; must cover ``derive_level_halo(params, 0)``."""

    min_tiled_rows: int = 48
    level_halo: int = 48

    @classmethod
    def for_params(cls, params: FlowParams, **kw) -> "TileConfig":
        return cls(level_halo=derive_level_halo(params), **kw)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tiled_levels(sizes: list[tuple[int, int]], n: int,
                 tc: TileConfig) -> list[bool]:
    """Which pyramid levels run tiled: those whose rows // n exceed both the
    minimum and the halo (one neighbour exchange reaches far enough)."""
    return [h // n >= max(tc.min_tiled_rows, tc.level_halo + 1)
            for h, _ in sizes]


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------


def _crop_rows(x: torch.Tensor, halo: int) -> torch.Tensor:
    return x[:, halo:x.shape[1] - halo] if halo else x


def _tiled_stencil(x: torch.Tensor, fn, radius: int,
                   comm: RowComm) -> torch.Tensor:
    """A local stencil of receptive radius ``radius`` on row tiles:
    halo-extend, apply, crop."""
    return _crop_rows(fn(comm.exchange_rows(x, radius)), radius)


def _my_rows(full: torch.Tensor, rows: int, comm: RowComm) -> torch.Tensor:
    """This process's tiles of ``rows`` rows each from a global (R, ...)
    array, zero-padded below to n * rows."""
    pad = comm.n * rows - full.shape[0]
    if pad:
        full = torch.cat([full, full.new_zeros((pad,) + full.shape[1:])])
    return full.reshape((comm.n, rows) + full.shape[1:])[comm.tile_slice()]


def _tile_rows0(comm: RowComm, rows: int, device) -> torch.Tensor:
    """(T,) int64: the global row of local row 0 of each of this process's
    tiles of ``rows`` rows, made on the device (no host copy, which would
    wait for the stream to drain)."""
    t = comm.tile_slice()
    return torch.arange(t.start, t.stop, device=device) * rows


# ---------------------------------------------------------------------------
# Tiled resize along rows (global-index gather)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowResizePlan:
    """Static plan for a row-tiled axis-0 resize H_a -> H_b over n tiles."""

    h_a: int            # rows a tile holds (ceil(H_a / n))
    h_b: int            # output rows a tile holds
    halo: int           # source halo needed
    idx: np.ndarray     # (n * h_b, K) global source rows (clamped)
    w: np.ndarray       # (n * h_b, K) weights
    args: tuple         # make_row_resize_plan's (h_from, h_to, n, method)


@functools.lru_cache(maxsize=None)
def make_row_resize_plan(h_from: int, h_to: int, n: int,
                         method: str) -> RowResizePlan:
    idx, w = im._resize_axis_plan(h_from, h_to, method)
    h_a, h_b = _cdiv(h_from, n), _cdiv(h_to, n)
    # pad the plan to n*h_b rows (repeat the last row; outputs there are pad)
    pad = n * h_b - h_to
    idx_p = np.concatenate([idx, np.repeat(idx[-1:], pad, 0)], 0)
    w_p = np.concatenate([w, np.repeat(w[-1:], pad, 0)], 0)
    halo = 0
    for d in range(n):
        rows = idx_p[d * h_b:(d + 1) * h_b]
        halo = max(halo, d * h_a - int(rows.min()),
                   int(rows.max()) - (d * h_a + h_a - 1))
    return RowResizePlan(h_a, h_b, max(halo, 0), idx_p, w_p,
                         (h_from, h_to, n, method))


@programs.device_constant
def _plan_taps(plan_args: tuple, start: int, stop: int, ext_rows: int,
               device: str):
    """(K, T, h_b) int64 local source rows, in halo-extended tiles of
    ``ext_rows`` rows, of the tiles [start, stop) of the plan
    ``make_row_resize_plan(*plan_args)``, and their (K, T, h_b) weights, on
    ``device``; made once, so a resize sends nothing to the device."""
    plan = make_row_resize_plan(*plan_args)
    tiles = slice(start, stop)
    n_k = plan.idx.shape[1]
    g = np.arange(start, stop)[:, None, None]
    rows = plan.idx.reshape(-1, plan.h_b, n_k)[tiles] \
        - (g * plan.h_a - plan.halo)
    local = np.clip(rows, 0, ext_rows - 1).astype(np.int64)
    wts = plan.w.reshape(-1, plan.h_b, n_k)[tiles]
    return tuple(torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 0))
                                  ).to(device) for a in (local, wts))


def _tiled_resize_rows(x: torch.Tensor, plan: RowResizePlan,
                       comm: RowComm) -> torch.Tensor:
    """Axis-1 resize of (T, h_a, ...) row tiles by the plan: each output row
    gathers its source rows by global index from the halo-extended tile and
    sums them with the untiled resize's weights in its tap order
    (``image._resize_axis``), so it has the untiled resize's bits."""
    ext = comm.exchange_rows(x.float(), plan.halo)
    tiles = comm.tile_slice()
    local, wts = _plan_taps(plan.args, tiles.start, tiles.stop, ext.shape[1],
                            str(x.device))
    trail = (1,) * (ext.dim() - 2)
    t_idx = torch.arange(local.shape[1], device=x.device)[:, None]
    acc = None
    for ix, wm in zip(local, wts):
        g = ext[t_idx, ix] * wm.view(wm.shape + trail)
        acc = g if acc is None else acc + g
    return acc


def _tiled_resize_cols(x: torch.Tensor, out_w: int,
                       method: str) -> torch.Tensor:
    """Column resize of (T, h, W, ...) tiles: row-local (x is whole)."""
    x = x.float()
    if out_w == x.shape[2]:
        return x
    return im._resize_axis(x, 2, out_w, method)


def _tiled_resize(x, plan: RowResizePlan, out_w: int, method: str,
                  comm: RowComm) -> torch.Tensor:
    return _tiled_resize_cols(_tiled_resize_rows(x, plan, comm), out_w,
                              method)


# ---------------------------------------------------------------------------
# Tiled eight-ray distance field
# ---------------------------------------------------------------------------


def _sharded_strided_first_hit_axis0(mask: torch.Tensor, step: int,
                                     reverse: bool,
                                     comm: RowComm) -> torch.Tensor:
    """Row-tiled ``distance._strided_first_hit`` along rows of (T, h, W)
    masks: each tile scans its own rows on the stride-decimated view, the
    tiles exchange one (step, W) summary each (the first hit of each class
    and column in the tile), and the two are combined.

    Decimation classes are global (y mod step): a tile's rows sit at offset
    (g*h) mod step of a padded buffer so that the (blocks, step, W) view
    aligns classes across tiles; positions are global decimated indices
    q = y // step.  Output: pixel distance (steps * ``step``) to the first
    True at-or-after (at-or-before for ``reverse``) each row in its class;
    +inf where none."""
    t, h, w = mask.shape
    dev = mask.device
    hb = _cdiv(h + step, step) * step
    nb = hb // step
    offs = _tile_rows0(comm, h, dev)
    sh = (offs % step)[:, None]
    t_idx = torch.arange(t, device=dev)[:, None]
    src = torch.arange(hb, device=dev)[None, :] - sh          # (T, hb)
    inside = ((src >= 0) & (src < h))[..., None]
    buf = mask[t_idx, src.clamp(0, h - 1)] & inside
    mb = buf.view(t, nb, step, w)
    base_q = torch.div(offs, step, rounding_mode="floor").float()
    q = (torch.arange(nb, dtype=torch.float32, device=dev)
         .view(1, nb, 1, 1) + base_q.view(t, 1, 1, 1)).expand(mb.shape)
    inf = float("inf")
    if not reverse:
        pos = torch.where(mb, q, torch.full_like(q, inf))
        local = torch.cummin(pos.flip(1), dim=1).values.flip(1)
        later = comm.min_over_later(local[:, 0])           # (T, step, w)
        dist = (torch.minimum(local, later[:, None]) - q) * step
    else:
        pos = torch.where(mb, q, torch.full_like(q, -inf))
        local = torch.cummax(pos, dim=1).values
        earlier = comm.max_over_earlier(local[:, -1])
        dist = (q - torch.maximum(local, earlier[:, None])) * step
    return dist.reshape(t, hb, w)[t_idx, sh + torch.arange(h, device=dev)]


def _tiled_eight_ray_multi(masks: list, step: int, max_i: float,
                           diag_scale: float, comm: RowComm) -> list:
    """Row-tiled ``distance.eight_ray_min_distance`` of M (T, h, W) masks;
    pad rows below the canvas must be False.  x scans are row-local; the y
    and diagonal scans use the summary exchange, with the diagonals
    sheared by global row index, so no tile needs another's mask.  The M
    masks are concatenated along x, so each scan direction runs once.
    Semantics and bits are the untiled op's, including the reference's
    boundary rule (column 0 invisible to -x rays, global row 0 to -y
    rays)."""
    t, h, w = masks[0].shape
    hp = h * comm.n
    m = len(masks)
    inf = float("inf")

    def keep(d):
        return torch.where(d < max_i, d, torch.full_like(d, inf))

    offs = _tile_rows0(comm, h, masks[0].device)
    g_rows = torch.arange(h, device=masks[0].device)[None, :] + offs[:, None]
    row0 = (g_rows == 0)[:, :, None]                           # (T, h, 1)
    col0 = torch.zeros(w, dtype=torch.bool, device=masks[0].device)
    col0[:1].fill_(True)

    d_x = []
    for mask in masks:
        no_col0 = mask & ~col0
        d_x.append(torch.minimum(
            keep(_strided_first_hit(mask, -1, step, reverse=False)),
            keep(_strided_first_hit(no_col0, -1, step, reverse=True))))

    def scan_cat(parts, reverse):
        return _sharded_strided_first_hit_axis0(torch.cat(parts, dim=-1),
                                                step, reverse, comm)

    yp_cat = scan_cat(masks, False)
    ym_cat = scan_cat([f & ~row0 for f in masks], True)

    ws = w + hp - 1

    def shear(mask, sign):
        return _shear(mask, sign, row_offset=offs, total_h=hp)

    sh_pp, sh_pp_ex, sh_pm, sh_pm_ex = [], [], [], []
    for full in masks:
        f_nr0 = full & ~row0
        f_nc0 = full & ~col0
        sh_pp.append(shear(full, +1))            # (+1, +1) down
        sh_pp_ex.append(shear(f_nr0 & ~col0, +1))  # (-1, -1) up
        sh_pm.append(shear(f_nc0, -1))           # (+1, -1) down
        sh_pm_ex.append(shear(f_nr0, -1))        # (-1, +1) up
    diag = ((scan_cat(sh_pp, False), +1), (scan_cat(sh_pp_ex, True), +1),
            (scan_cat(sh_pm, False), -1), (scan_cat(sh_pm_ex, True), -1))

    outs = []
    for k in range(m):
        cols = slice(k * w, (k + 1) * w)
        out = torch.minimum(d_x[k], torch.minimum(keep(yp_cat[..., cols]),
                                                  keep(ym_cat[..., cols])))
        for cat_d, sign in diag:
            dist = keep(cat_d[..., k * ws:(k + 1) * ws])
            out = torch.minimum(out, _unshear(dist, sign, w, row_offset=offs,
                                              total_h=hp) * diag_scale)
        outs.append(out)
    return outs


def _tiled_eight_ray(mask: torch.Tensor, step: int, max_i: float,
                     diag_scale: float, comm: RowComm) -> torch.Tensor:
    """Single-mask form of ``_tiled_eight_ray_multi``."""
    return _tiled_eight_ray_multi([mask], step, max_i, diag_scale, comm)[0]


# ---------------------------------------------------------------------------
# Tiled pixflow
# ---------------------------------------------------------------------------


def _tiled_gaussian_blur(x, ksize: int, sigma: float, comm: RowComm):
    """Gaussian blur of (T, h, W[, C]) tiles; channels (if any) first in
    the blur, as the untiled path blurs channel-split planes."""
    def blur(e):
        if e.dim() == 3:
            return im.gaussian_blur(e, ksize, sigma)
        return im.gaussian_blur(e.movedim(-1, 1), ksize, sigma).movedim(1, -1)
    return _tiled_stencil(x, blur, ksize // 2, comm)


def _build_tiled_pyramid(img, sizes, tiled, comm: RowComm, dh: int) -> list:
    """Finest -> coarsest pyramid of (T, h, W) tiles; the levels too small
    to tile are whole (R, W) planes made from the gathered rows (the
    transition happens once)."""
    if not tiled[0]:
        pyr = [comm.all_gather_rows(img)[:dh]]
        for s in sizes[1:]:
            pyr.append(im.resize_planes(pyr[-1], s, "linear"))
        return pyr
    pyr, whole = [img], False
    for k in range(1, len(sizes)):
        prev = pyr[-1]
        (ph, _), (nh, nw) = sizes[k - 1], sizes[k]
        if not whole and tiled[k]:
            plan = make_row_resize_plan(ph, nh, comm.n, "linear")
            cur = _tiled_resize(prev, plan, nw, "linear", comm)
        else:
            if not whole:
                prev = comm.all_gather_rows(prev)[:ph]
                whole = True
            cur = im.resize_planes(prev, (nh, nw), "linear")
        pyr.append(cur)
    return pyr


def _to_b(fc: torch.Tensor) -> torch.Tensor:
    """(..., h, w, 4) flow channels [f01x, f01y, f10x, f10y] -> the solver's
    (2*lead, h, w, 2) directions."""
    lead = fc.shape[:-3]
    b = torch.stack([fc[..., :2], fc[..., 2:]], dim=len(lead))
    return b.reshape((-1,) + fc.shape[-3:-1] + (2,))


def _to_c(fb: torch.Tensor, tiled: bool) -> torch.Tensor:
    """Inverse of ``_to_b``: (2T, h, w, 2) -> (T, h, w, 4), or (2, h, w, 2)
    -> (h, w, 4) for a whole level."""
    fb = fb.reshape((-1, 2) + fb.shape[1:])
    fc = torch.cat([fb[:, 0], fb[:, 1]], dim=-1)
    return fc if tiled else fc[0]


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(T, h, w) planes of the two images -> (2T, h, w), entry 2t + d image
    d of tile t (the solver's pairs)."""
    return torch.stack([a, b], dim=1).reshape((-1,) + a.shape[1:])


def _upsample_whole(flow_c, level, sizes, tiled, comm: RowComm,
                    params: FlowParams):
    """Cubic upsample of a whole-level (h, w, 4) flow toward ``level - 1``;
    cut into this process's tiles when that level is tiled."""
    nh, nw = sizes[level - 1]
    up = im.resize(flow_c, (nh, nw), "cubic") * (1.0 / params.pyr_scale_factor)
    if tiled[level - 1]:
        up = _my_rows(up, _cdiv(nh, comm.n), comm)
    return up


def tiled_compute_optical_flow_pair(
        rgba0: torch.Tensor, rgba1: torch.Tensor, params: FlowParams,
        hints: tuple[str, str], comm: RowComm, h_global: int,
        tc: TileConfig = TileConfig()) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-tiled ``pixflow.compute_optical_flow_pair``: (T, h_loc, W, 4)
    uint8 tiles of the two images (global rows ``h_global``, pad rows
    below), both directions solved together on one set of tiled pyramids.
    The flow rides through the tiled resizes and blurs as (T, h, w, 4)
    channels [f01x, f01y, f10x, f10y]; returns (flow01, flow10), (T, h_loc,
    W, 2) each."""
    n = comm.n
    h_loc, w = rgba0.shape[1:3]
    if h_loc * n < h_global:
        raise ValueError(f"{n} tiles of {h_loc} rows hold fewer than "
                         f"{h_global}")
    need = derive_level_halo(params, flow_sample_margin=0)
    if tc.level_halo < need:
        raise ValueError(f"level_halo {tc.level_halo} < the level's "
                         f"receptive radius {need}")
    dh = int(h_global * params.downscale_factor)
    dw = int(w * params.downscale_factor)
    plan_ds = make_row_resize_plan(h_global, dh, n, "cubic")

    def prep(rgba):
        r = _tiled_resize(rgba, plan_ds, dw, "cubic", comm)
        r = torch.clamp(torch.round(r), 0, 255).to(torch.uint8)
        g = im.rgba_to_gray_u8(r).float() / 255.0
        a = r[..., 3].float() / 255.0
        return _tiled_gaussian_blur(g, params.pre_blur_kernel_width,
                                    params.pre_blur_sigma, comm), a

    i0, a0 = prep(rgba0)
    i1, a1 = prep(rgba1)
    sizes = pixflow.pyramid_sizes(dh, dw, params)
    tiled = tiled_levels(sizes, n, tc)
    p_i0, p_i1, p_a0, p_a1 = (_build_tiled_pyramid(p, sizes, tiled, comm, dh)
                              for p in (i0, i1, a0, a1))
    halo = tc.level_halo

    def solve(imgs, alphas, fb):
        coarsest = fb is None
        if coarsest:
            fb = pixflow.coarsest_start(imgs, alphas, hints, params)
        return pixflow.patch_match_level_batched(imgs, alphas, fb, params,
                                                 coarsest)

    flow_c = None
    for level in range(len(sizes) - 1, -1, -1):
        lh = sizes[level][0]
        if not tiled[level]:
            imgs = torch.stack([p_i0[level], p_i1[level]])
            alphas = torch.stack([p_a0[level], p_a1[level]])
            fb = None if flow_c is None else _to_b(flow_c)
            flow_c = _to_c(solve(imgs, alphas, fb), tiled=False)
            if level > 0:
                flow_c = _upsample_whole(flow_c, level, sizes, tiled, comm,
                                         params)
            continue
        ex = functools.partial(comm.exchange_rows, halo=halo)
        imgs = _interleave(ex(p_i0[level]), ex(p_i1[level]))
        alphas = _interleave(ex(p_a0[level]), ex(p_a1[level]))
        fb = None if flow_c is None else _to_b(ex(flow_c))
        flow_c = _crop_rows(_to_c(solve(imgs, alphas, fb), tiled=True),
                            halo)
        if level > 0:
            nh, nw = sizes[level - 1]
            plan = make_row_resize_plan(lh, nh, n, "cubic")
            flow_c = _tiled_resize(flow_c, plan, nw, "cubic", comm) \
                * (1.0 / params.pyr_scale_factor)

    if not tiled[0]:
        flow_c = _my_rows(flow_c, _cdiv(dh, n), comm)
    plan_up = make_row_resize_plan(dh, h_global, n, "linear")
    flow_c = _tiled_resize(flow_c, plan_up, w, "linear", comm)
    flow_c = flow_c * (1.0 / params.downscale_factor)
    flow_c = _tiled_gaussian_blur(flow_c, params.final_flow_blur_kernel_width,
                                  params.final_flow_blur_sigma, comm)
    return flow_c[..., :2], flow_c[..., 2:]


def tiled_compute_optical_flow(rgba0: torch.Tensor, rgba1: torch.Tensor,
                               params: FlowParams, hint: str, comm: RowComm,
                               h_global: int,
                               tc: TileConfig = TileConfig()) -> torch.Tensor:
    """Row-tiled ``pixflow.compute_optical_flow``: the flow from ``rgba0``
    to ``rgba1`` as (T, h_loc, W, 2) tiles.  It runs the pair solver, whose
    first direction is solved exactly as alone, and keeps that direction."""
    return tiled_compute_optical_flow_pair(rgba0, rgba1, params,
                                           (hint, hint), comm, h_global,
                                           tc)[0]


# ---------------------------------------------------------------------------
# Tiled stitch
# ---------------------------------------------------------------------------


def _global_rows(comm: RowComm, h_loc: int, device,
                 halo: int = 0) -> torch.Tensor:
    """(T, h_loc + 2*halo, 1): the global row of each local row of tiles of
    h_loc rows extended by ``halo`` rows each side."""
    offs = _tile_rows0(comm, h_loc, device)
    return (torch.arange(-halo, h_loc + halo, device=device)[None, :]
            + offs[:, None])[..., None]


def _tiled_generate_blend(canvas_map: torch.Tensor, cfg: StitchConfig,
                          comm: RowComm, h_global: int,
                          window: tuple | None = None):
    """Row-tiled ``stitcher.generate_blend`` on (T, h_loc, W) map tiles.

    ``window`` = (roll, width) computes the field on that column window
    only.  As the reference's tiled blend does, the tiled field ignores
    ``blend_scale``: it is the full-resolution field on every preset, so a
    tiled ``_fast`` stitch differs from the untiled one there.  The
    selective smoothing's block grid is the untiled one: each tile adds the
    blocks whose top-left global row it holds, and the tiles' grids are
    summed.  (The reference samples each tile's rows at local multiples of
    the ray stride and scatters them by global row, which drops blocks when
    a tile's rows are not a multiple of the stride.)  Pad rows below the
    canvas are masked out.  Returns (blend, merged_dis), (T, h_loc,
    width)."""
    t, h_loc, w = canvas_map.shape
    dev = canvas_map.device
    step = max(1, min(h_global, w) // cfg.blend_step_div)
    max_i = w / 2.0
    live = _global_rows(comm, h_loc, dev) < h_global

    windowed = window is not None and window[1] < w
    if windowed:
        roll, width = window
        center = window_cols(canvas_map, roll, width, dim=2)
        d_l, d_r = _tiled_eight_ray_multi(
            [(center == 100) & live, (center == 50) & live], step, max_i,
            math.sqrt(2.0), comm)
        out_w = width
    else:
        length = w // cfg.blend_extend_div
        ext = im.wrap_extend_x(canvas_map, length, -1)
        d_l, d_r = _tiled_eight_ray_multi(
            [(ext == 100) & live, (ext == 50) & live], step, max_i,
            math.sqrt(2.0), comm)
        d_l = im.crop_x(d_l, length, -1)
        d_r = im.crop_x(d_r, length, -1)
        center = canvas_map
        out_w = w

    nv = torch.full((), 10.0 * w, dtype=torch.float32, device=dev)
    d_l = torch.where(torch.isinf(d_l), nv, d_l)
    d_r = torch.where(torch.isinf(d_r), nv, d_r)
    counted = d_l / (d_l + d_r)
    merged_dis = torch.minimum(d_l, d_r)
    zero = torch.zeros_like(counted)
    blend = torch.where(center == 100, zero,
                        torch.where(center == 50, zero + 1.0,
                                    torch.where(center == 150, counted,
                                                zero + 0.5)))
    merged_dis = torch.where(center == 150, merged_dis, zero)

    k_sel = h_global // cfg.blend_smooth_kernel_div
    if k_sel >= 2:
        blurred = _tiled_stencil(blend, lambda e: im.box_blur(e, k_sel, k_sel),
                                 k_sel, comm)
        hq, wq = h_global // step, out_w // step
        grids = []
        for i, g in enumerate(comm.tile_index()):
            grid = merged_dis.new_zeros((hq, wq))
            q0 = _cdiv(g * h_loc, step)
            q1 = min(hq, _cdiv((g + 1) * h_loc, step))
            if q1 > q0:
                rows = torch.arange(q0, q1, device=dev) * step - g * h_loc
                grid[q0:q1] = merged_dis[i].index_select(0, rows)[
                    :, :wq * step:step]
            grids.append(grid)
        sel = comm.all_gather_tiles(torch.stack(grids)).sum(0) > step
        qy_ok = torch.arange(hq, device=dev) * step + step < h_global
        if windowed:
            gx = (torch.arange(wq, device=dev) * step + window[0]) % w
            qx_ok = gx + step < w
        else:
            qx_ok = torch.arange(wq, device=dev) * step + step < w
        sel = sel & qy_ok[:, None] & qx_ok[None, :]
        sel_full = torch.zeros((comm.n * h_loc, out_w), dtype=torch.bool,
                               device=dev)
        sel_full[:hq * step, :wq * step] = sel.repeat_interleave(
            step, 0).repeat_interleave(step, 1)
        my_sel = _my_rows(sel_full, h_loc, comm)
        blend = torch.where(my_sel, blurred, blend)

    k_glob = h_global // cfg.blend_global_blur_div
    if k_glob >= 2:
        blend = _tiled_stencil(blend, lambda e: im.box_blur(e, k_glob, k_glob),
                               k_glob, comm)
    return blend.float(), merged_dis


def _tiled_combine(ol, orr, flr, frl, blend, comm: RowComm,
                   tc: TileConfig) -> torch.Tensor:
    """Row-tiled ``novel_view.combine_novel_views``: the samplers reach
    +-|t * flow_y| rows, so every input is halo-extended by the level halo,
    combined and cropped."""
    halo = tc.level_halo
    args = [comm.exchange_rows(a, halo) for a in (ol, orr, flr, frl, blend)]
    return _crop_rows(novel_view.combine_novel_views(*args), halo)


def _tiled_gather(canvas_map, image_l, image_r, merged, cfg: StitchConfig,
                  comm: RowComm, h_global: int,
                  window: tuple | None = None) -> torch.Tensor:
    """Row-tiled ``stitcher.gather_composite``: the hole search's rays reach
    gather_search_radius - 1 rows, so its codes are halo-extended with an
    invalid code (255) and global row 0 is excluded by global index.
    ``window`` = (roll, width) runs the hole search on that window (the
    caller checked crop.gather_window_safe)."""
    r = cfg.gather_search_radius
    code = canvas_map + im.threshold_binary(merged[..., 3], 0, 75)
    t, h_loc, w = code.shape
    dev = code.device
    live = _global_rows(comm, h_loc, dev) < h_global
    code_l = torch.where(live, code, torch.full_like(code, 255))
    row0 = _global_rows(comm, h_loc, dev, halo=r) == 0
    black = torch.zeros((4,), dtype=torch.uint8, device=dev)
    black[3:].fill_(255)

    def hole_from(codes, img_l, img_r):
        ext = comm.exchange_rows(codes, r, fill=255)
        found, take_l = two_class_hole_search(
            ext == 100, ext == 50, r,
            row0_excluded=row0.expand(ext.shape))
        found = _crop_rows(found, r)
        take_l = _crop_rows(take_l, r)
        return torch.where(found[..., None],
                           torch.where(take_l[..., None], img_l, img_r),
                           black)

    if window is None:
        hole = hole_from(code_l, image_l, image_r)
    else:
        roll, width = window
        hole = place_cols(hole_from(*(window_cols(a, roll, width, dim=2)
                                      for a in (code_l, image_l, image_r))),
                          roll, w, dim=2)

    zero = torch.zeros((4,), dtype=torch.uint8, device=dev)
    out = torch.where((code == 100)[..., None], image_l, zero)
    out = torch.where((code == 50)[..., None], image_r, out)
    is_merged = (code == 225) | (code == 175) | (code == 125)
    out = torch.where(is_merged[..., None], merged, out)
    return torch.where((code == 150)[..., None], hole, out)


def _tiled_stitch_pair_body(image_l, image_r, *, cfg: StitchConfig,
                            comm: RowComm, h_global: int,
                            tc: TileConfig = TileConfig(),
                            window: tuple | None = None) -> torch.Tensor:
    """The tiled stitch of (T, h_loc, W, 4) tiles.  With ``window`` =
    (roll, width, gather_safe) and width < W the flow, blend and combine
    stages run on the planned column window only, as the untiled
    ``pipeline.stitch_pair_windowed``; the hole search too when
    gather_safe."""
    canvas_map = stitcher.match_images(image_l, image_r)
    ol = stitcher.extract_overlap(image_l, canvas_map)
    orr = stitcher.extract_overlap(image_r, canvas_map)
    w = canvas_map.shape[2]
    params = cfg.flow_params
    hints = ("left", "right")

    if window is not None and window[1] < w:
        roll, width, gsafe = window
        blend_w, _ = _tiled_generate_blend(canvas_map, cfg, comm, h_global,
                                           window=(roll, width))
        ol_w = window_cols(ol, roll, width, dim=2)
        or_w = window_cols(orr, roll, width, dim=2)
        flr_w, frl_w = tiled_compute_optical_flow_pair(
            ol_w, or_w, params, hints, comm, h_global, tc)
        merged = place_cols(_tiled_combine(ol_w, or_w, flr_w, frl_w, blend_w,
                                           comm, tc), roll, w, dim=2)
        return _tiled_gather(canvas_map, image_l, image_r, merged, cfg, comm,
                             h_global, window=(roll, width) if gsafe else None)

    blend, _ = _tiled_generate_blend(canvas_map, cfg, comm, h_global)
    length = w // cfg.flow_extend_div
    flr, frl = tiled_compute_optical_flow_pair(
        im.wrap_extend_x(ol, length, 2), im.wrap_extend_x(orr, length, 2),
        params, hints, comm, h_global, tc)
    merged = _tiled_combine(ol, orr, im.crop_x(flr, length, 2),
                            im.crop_x(frl, length, 2), blend, comm, tc)
    return _tiled_gather(canvas_map, image_l, image_r, merged, cfg, comm,
                         h_global)


def _tiled_stitch(image_l, image_r, cfg: StitchConfig, comm: RowComm,
                  tc: TileConfig, window: tuple | None) -> torch.Tensor:
    """The tiled stitch of global (H, W, 4) canvases: rows padded to a
    multiple of n with transparent rows, this process's tiles stitched,
    the panorama gathered and cropped back to H rows."""
    h = image_l.shape[0]
    h_loc = _cdiv(h, comm.n)
    out = _tiled_stitch_pair_body(
        _my_rows(image_l, h_loc, comm), _my_rows(image_r, h_loc, comm),
        cfg=cfg, comm=comm, h_global=h, tc=tc, window=window)
    return comm.all_gather_rows(out)[:h]


def _tiled_stitch_program_body(image_l: torch.Tensor, image_r: torch.Tensor,
                               *args) -> torch.Tensor:
    """The in-process tiled stitch as one program (the counterpart of the
    reference's ``_tiled_stitch_jit``): ``args`` is the window's roll (a
    0-d int64 tensor, present only when ``width`` is not None), then n,
    the TileConfig, the window's width (None: the whole canvas), its
    gather flag and the config.  The padding to a multiple of n runs
    inside, so the canvases' shape carries the global rows."""
    *roll, n, tc, width, gather_safe, cfg = args
    window = None if width is None else (roll[0], width, gather_safe)
    return _tiled_stitch(image_l, image_r, cfg, InProcessRows(n), tc, window)


def tiled_stitch_pair(image_l, image_r, cfg: StitchConfig, n: int,
                      comm: RowComm | None = None,
                      tc: TileConfig = TileConfig(),
                      window: tuple | None = None,
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """Stitch one canvas pair row-tiled over ``n`` tiles: global (H, W, 4)
    uint8 arrays or tensors in (moved to ``device``), the (H, W, 4) uint8
    panorama out.  Rows are padded to a multiple of n with transparent
    rows, stitched tiled and cropped back.  ``comm`` defaults to
    ``InProcessRows(n)`` (all tiles in this process); a ``DistributedRows``
    stitches this rank's tile and gathers the panorama on every rank.
    ``window`` is a planned (roll, width[, gather_safe]) overlap window,
    e.g. from ``crop.pair_window`` or ``crop.plan_chain_windows``.

    With an ``InProcessRows`` communicator the stitch is a program
    (``utils.programs``) keyed by the canvases' shape, n, ``tc``, the
    window's width and gather flag and ``cfg``; the roll is its input, so
    one program serves every roll of a width.  A ``DistributedRows``
    stitch runs eagerly, by its type: its collectives run under gloo on
    CPU tensors, and NCCL collectives inside a CUDA graph are untried."""
    comm = InProcessRows(n) if comm is None else comm
    if comm.n != n:
        raise ValueError(f"n={n} but the communicator has {comm.n} tiles")
    image_l = _as_canvas(image_l, device)
    image_r = _as_canvas(image_r, device)
    width, gsafe, rolls = None, False, ()
    if window is not None and window[1] < image_l.shape[1]:
        roll, width, gsafe = (*window, False)[:3]
        gsafe = bool(gsafe)
        # a fill on the card: a copy from host memory would wait for the
        # stream
        rolls = (torch.full((), roll, dtype=torch.int64,
                            device=image_l.device),)
    if isinstance(comm, InProcessRows):
        return programs.run(_tiled_stitch_program_body,
                            (image_l, image_r, *rolls), n, tc, width, gsafe,
                            cfg)
    window = None if width is None else (*rolls, width, gsafe)
    return _tiled_stitch(image_l, image_r, cfg, comm, tc, window)


def tiled_stitch_pair_auto(image_l, image_r, cfg: StitchConfig, n: int,
                           comm: RowComm | None = None,
                           tc: TileConfig = TileConfig(),
                           device: str | torch.device = "cuda"
                           ) -> torch.Tensor:
    """``tiled_stitch_pair`` with the overlap window derived from the
    pair's canvas map, as ``pipeline.stitch_pair_auto`` derives it."""
    from panorama_opticalflow_tpu_torch.models import crop

    image_l = _as_canvas(image_l, device)
    image_r = _as_canvas(image_r, device)
    window = crop.pair_window(stitcher.match_images(image_l, image_r), cfg)
    return tiled_stitch_pair(image_l, image_r, cfg, n, comm, tc,
                             window=window, device=device)
