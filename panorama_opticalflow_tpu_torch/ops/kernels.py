"""The hand-written CUDA kernels of the solver's main path, their
wrappers and their plain PyTorch versions (counterpart of the reference's
``ops/pallas/kernels.py``).

=============================  ======================================  =================================
wrapper                        replaces (reference Pallas kernel)      plain version
=============================  ======================================  =================================
``warp_tiled``                 ``warp_tiled_pallas``                   ``warp_tiled_plain``
``relax_phase``                ``relax_phase_pallas(fuse_bf=True)``    ``relax_phase_fused_plain``
``relax_phase_unfused``        ``relax_phase_pallas(fuse_bf=False)``   ``relax_phase_unfused_plain``
``median5_diffuse``            ``median5_diffuse_pallas``              ``median5_diffuse_plain``
``median5``                    ``median5_pallas``                      ``ops.image.median5``
``exact_level``                none: kernel work beyond the reference  ``exact_level_plain``
``small_relax_phase``          none: kernel work beyond the reference  ``small_relax_phase_plain``
``small_relax_phase_unfused``  none: kernel work beyond the reference  ``small_relax_phase_unfused_plain``
``small_median5_diffuse``      none: kernel work beyond the reference  ``small_median5_diffuse_plain``
``novel_view``                 none: kernel work beyond the reference  ``novel_view_plain``
``blend_distances``            none: kernel work beyond the reference  ``blend_distances_plain``
``hole_composite``             none: kernel work beyond the reference  ``hole_composite_plain``
=============================  ======================================  =================================

A wrapper checks its inputs and raises on anything the kernel does not
take.  The plain versions take every iteration count, hat window and blur
width the reference's kernels take; the CUDA kernels take every one whose
block window fits the card's shared memory (and, for relax, the pixels a
block's threads own), with unrolled instances for the presets' values and
one instance that reads its geometry at run time for the rest.  Beyond the
card's limit a wrapper raises and names it.  For tensors on the CPU it runs the plain version; for CUDA tensors
it launches the kernel (built from ``csrc/`` on first use, see
``ops.build``) and raises if the launch is refused -- there is no
fallback.  Each wrapper counts its kernel launches in its ``launches``
attribute.  The plain versions compute exactly the kernel's contract,
border semantics included: the kernel levels' edge-replicated windows;
the small levels' (``small_*``, levels below ``pallas_min_pixels``) the
validity masks and reflect-101 blurs of the plain level path
(``ops.relax_fast``, ``ops.image``), whose ops are their plain versions,
so that a small level gives the plain branch's bits on the card;
``exact_level`` those of the exact loop, ``ops.relax_exact``;
``novel_view`` those of the novel-view stage's ops (``ops.warp``'s
samplers, the combiner, the window's columns); ``blend_distances`` the
reference's ray boundary rule (``ops.distance.eight_ray_min_distance``);
``hole_composite`` the hole search's (``ops.distance.
two_class_hole_search``) and the window's columns.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from panorama_opticalflow_tpu_torch.utils.config import FlowParams
from panorama_opticalflow_tpu_torch.ops.distance import (
    eight_ray_min_distance, two_class_hole_search)
from panorama_opticalflow_tpu_torch.ops.image import (crop_x, gaussian_blur,
                                                      gaussian_kernel_1d,
                                                      median5 as median5_plain,
                                                      threshold_binary)
from panorama_opticalflow_tpu_torch.ops.relax_exact import (
    _as_planes, _blur_flow, _from_planes, low_alpha_flow_diffusion,
    relax_iteration)
from panorama_opticalflow_tpu_torch.ops.relax_fast import (
    _pad2, relax_phase_fast, sample_maps, shift_edge, tile_offsets,
    warp_by_flow_tiled)
from panorama_opticalflow_tpu_torch.ops.warp import (
    sample_nearest_wrap, sample_nearest_wrap_tiled)

WARP_TILE = (64, 128)
WARP_MARGIN = 8
WARP_MAX_OFF = 96
# blur widths csrc/median5_diffuse.cu unrolls; any other width runs its
# run-time instance
DIFFUSE_WIDTHS = (3, 5, 7, 9, 11, 13, 15)
# the largest exact level (h * w pixels) models/pixflow hands to the
# exact_level kernel: one block holds every plane of a direction, 41 bytes
# a pixel of shared memory (168 KB at this size; an H100 gives a block 227)
EXACT_LEVEL_MAX_PIXELS = 4096
# the most relax iterations one launch of a small level's kernel runs (its
# halo grows by 2 D rows an iteration); a longer phase is several launches
SMALL_RELAX_ITERS = 3


def _check(name: str, tensors: dict, shapes: dict) -> torch.device:
    """Same device, float32, contiguous, and the expected shapes."""
    dev = None
    for key, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {key} must be a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shapes[key])}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, not {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _card_limit(name: str, what: str, need_of, values, value) -> None:
    """Raise unless ``need_of(value)`` (the shared-memory bytes a block
    needs, <= 0 where the window cannot run at all) fits the card; the
    error names the largest of ``values`` that does."""
    from panorama_opticalflow_tpu_torch.ops import build

    limit = build.load().pano_smem_limit()
    need = need_of(value)
    if 0 < need <= limit:
        return
    fit = [v for v in values if 0 < need_of(v) <= limit]
    most = f"at most {max(fit)}" if fit else "none"
    why = (f"needs {need} bytes of shared memory per block, the card "
           f"allows {limit}" if need > 0 else "does not fit a block")
    raise ValueError(f"{name}: {what}={value} {why}; this card takes "
                     f"{most}")


def _launch(name: str, fn, *args) -> None:
    from panorama_opticalflow_tpu_torch.ops import build

    rc = getattr(build.load(), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError "
                           f"{rc})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# 1. tiled flow warp
# ---------------------------------------------------------------------------


def warp_tiled_plain(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The warp kernel's contract on (B, H, W, C) / (B, H, W, 2)."""
    return warp_by_flow_tiled(img, flow, *WARP_TILE, WARP_MARGIN,
                              WARP_MAX_OFF)


def warp_tile_offsets(flow: torch.Tensor) -> torch.Tensor:
    """The warp's per-tile integer offsets of a (B, H, W, 2) flow:
    (B, ty, tx, 2) int32, made with torch ops outside the kernel."""
    return tile_offsets(flow, *WARP_TILE, WARP_MAX_OFF).contiguous()


def warp_tiled(img: torch.Tensor, flow: torch.Tensor,
               offsets: torch.Tensor | None = None) -> torch.Tensor:
    """W(x) = img(x + flow(x)), bilinear, clamp-to-edge, per-(64, 128)-tile
    integer offset + separable residual hat passes.  ``img`` (B, H, W, C)
    and ``flow`` (B, H, W, 2) float32; returns (B, H, W, C).  ``offsets``
    is ``warp_tile_offsets(flow)`` where the caller already holds it."""
    if img.dim() != 4 or flow.dim() != 4:
        raise ValueError("warp_tiled: img (B, H, W, C) and flow (B, H, W, 2)")
    nb, h, w, c = img.shape
    dev = _check("warp_tiled", {"img": img, "flow": flow},
                 {"img": (nb, h, w, c), "flow": (nb, h, w, 2)})
    tiles = (nb, -(-h // WARP_TILE[0]), -(-w // WARP_TILE[1]), 2)
    if offsets is not None and (
            offsets.dtype != torch.int32 or tuple(offsets.shape) != tiles
            or offsets.device != dev or not offsets.is_contiguous()):
        raise ValueError(f"warp_tiled: offsets must be contiguous int32 "
                         f"{tiles} on {dev}")
    if dev.type == "cpu":
        return warp_tiled_plain(img, flow)
    off = warp_tile_offsets(flow) if offsets is None else offsets
    out = torch.empty_like(img)
    _launch("warp_tiled", "pano_warp_tiled", img.data_ptr(), flow.data_ptr(),
            off.data_ptr(), out.data_ptr(), nb, c, h, w, *WARP_TILE,
            WARP_MARGIN, float(WARP_MARGIN - 1e-3), _stream())
    warp_tiled.launches += 1
    return out


warp_tiled.launches = 0


# ---------------------------------------------------------------------------
# 2. fused median5 + low-alpha diffusion
# ---------------------------------------------------------------------------


def median5_diffuse_plain(x: torch.Tensor, c: torch.Tensor,
                          ksize: int = 15, sigma: float = 8.0
                          ) -> torch.Tensor:
    """``c * gauss(med5(x)) + (1 - c) * med5(x)`` on (2B, H, W) planes
    with (B, H, W) coefficients (planes 2b, 2b+1 share c[b]).  The median
    field covers the blur margin, computed from the edge-replicated input,
    and the blur is separable (x first, taps in order) over that field."""
    taps = gaussian_kernel_1d(ksize, sigma)
    gr = ksize // 2
    h, w = x.shape[-2:]
    xp = _pad2(x, gr + 2, gr + 2, gr + 2, gr + 2)
    mh, mw = h + 2 * gr, w + 2 * gr
    stack = torch.stack([xp[..., dy:dy + mh, dx:dx + mw]
                         for dy in range(5) for dx in range(5)])
    med = torch.kthvalue(stack, 13, dim=0).values
    acc = torch.zeros(x.shape[:-2] + (mh, w), dtype=x.dtype, device=x.device)
    for t in range(ksize):
        acc = acc + float(taps[t]) * med[..., t:t + w]
    blur = torch.zeros_like(x)
    for t in range(ksize):
        blur = blur + float(taps[t]) * acc[..., t:t + h, :]
    med_c = med[..., gr:gr + h, gr:gr + w]
    cc = c.repeat_interleave(2, dim=0)
    return cc * blur + (1.0 - cc) * med_c


def median5_diffuse(x: torch.Tensor, c: torch.Tensor, ksize: int = 15,
                    sigma: float = 8.0) -> torch.Tensor:
    """Fused per-level median + low-alpha diffusion on (2B, H, W) flow
    planes with (B, H, W) coefficients ``c = 1 - a0*a1``, for any blur
    width ``ksize`` >= 1.  The kernel unrolls its blurs for the widths
    ``DIFFUSE_WIDTHS`` (every preset uses 15) and reads any other width at
    run time, up to the widest whose window fits the card's shared memory
    (73 on an H100)."""
    if x.dim() != 3 or x.shape[0] % 2:
        raise ValueError("median5_diffuse: x must be (2B, H, W)")
    if int(ksize) != ksize or ksize < 1:
        raise ValueError(f"median5_diffuse: ksize must be >= 1, got {ksize}")
    p2, h, w = x.shape
    dev = _check("median5_diffuse", {"x": x, "c": c},
                 {"x": (p2, h, w), "c": (p2 // 2, h, w)})
    if dev.type == "cpu":
        return median5_diffuse_plain(x, c, ksize, sigma)
    if ksize not in DIFFUSE_WIDTHS:   # an unrolled window fits every card
        from panorama_opticalflow_tpu_torch.ops import build

        _card_limit("median5_diffuse", "ksize",
                    build.load().pano_median5_diffuse_smem, range(1, 81),
                    ksize)
    taps = np.ascontiguousarray(gaussian_kernel_1d(ksize, sigma))
    out = torch.empty_like(x)
    _launch("median5_diffuse", "pano_median5_diffuse", x.data_ptr(),
            c.data_ptr(), out.data_ptr(), p2, h, w,
            taps.ctypes.data_as(ctypes.c_void_p), ksize, _stream())
    median5_diffuse.launches += 1
    return out


median5_diffuse.launches = 0


# ---------------------------------------------------------------------------
# 3. median5 alone (multi-phase and unfused levels)
# ---------------------------------------------------------------------------


def median5(x: torch.Tensor) -> torch.Tensor:
    """cv::medianBlur 5x5, BORDER_REPLICATE, on (P, H, W) float32 planes;
    bit-identical to its plain version ``ops.image.median5``."""
    if x.dim() != 3:
        raise ValueError("median5: x must be (P, H, W)")
    dev = _check("median5", {"x": x}, {"x": x.shape})
    if dev.type == "cpu":
        return median5_plain(x)
    out = torch.empty_like(x)
    _launch("median5", "pano_median5", x.data_ptr(), out.data_ptr(),
            *x.shape, _stream())
    median5.launches += 1
    return out


median5.launches = 0


# ---------------------------------------------------------------------------
# 4. relax phase: the blurred-flow target fused in, or given
# ---------------------------------------------------------------------------


def _reg_w(params: FlowParams, w: int) -> tuple[float, float]:
    """(vreg/w, hreg/w) rounded to float32, as the reference kernel takes
    them."""
    return (float(np.float32(params.vertical_regularization_coef / w)),
            float(np.float32(params.horizontal_regularization_coef / w)))


def _relax_window(fxp, fyp, bxb, byb, bfx, bfy, w1, i0xp, i0yp, mp,
                  params: FlowParams, iters: int, D: int, w: int):
    """The iterations both relax kernels run, on one edge-padded window:
    every plane (B, Hp, Wp) already padded by halo = iters + D + 2, and
    ``w1`` (B, 2, H, W) unpadded.  Shifts replicate the window edge (no
    validity masks) and the x passes edge-extend the offsets.  Returns
    the iterated (fx, fy) windows."""
    if params.w1_bf16:
        w1 = w1.to(torch.bfloat16).to(torch.float32)
    halo = iters + D + 2
    w1_pad = _pad2(w1, halo + D + 1, halo + D + 1, halo + D + 1,
                   halo + D + 1)
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
        for key, dy, dx in (("xp", 0, 1), ("yp", 1, 0), ("xm", 0, -1),
                            ("ym", -1, 0)):
            cfx = shift_edge(fxp, dy, dx)
            cfy = shift_edge(fyp, dy, dx)
            samp = shift_edge(nbrs[key], dy, dx)
            e = err(samp[:, 0], samp[:, 1], cfx, cfy)
            take = e < best_e
            best_fx = torch.where(take, cfx, best_fx)
            best_fy = torch.where(take, cfy, best_fy)
            best_e = torch.where(take, e, best_e)
            if params.fold_descent_sample:
                best_sx = torch.where(take, samp[:, 0], best_sx)
                best_sy = torch.where(take, samp[:, 1], best_sy)

        fold = params.fold_descent_sample
        S2, _, Gx, Gy = sample_maps(w1_pad, best_fx - bxb, best_fy - byb, D,
                                    False, True, with_sample=not fold)
        s2x, s2y = (best_sx, best_sy) if fold else (S2[:, 0], S2[:, 1])
        d0 = i0xp - s2x
        d1 = i0yp - s2y
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
    crop = np.s_[..., halo:halo + h, halo:halo + w]
    return fxp[crop], fyp[crop]


def relax_phase_fused_plain(fx, fy, bx, by, w1x, w1y, i0x, i0y, mask,
                            params: FlowParams, iters: int, D: int):
    """The fused relax kernel's contract on (B, H, W) planes: returns
    (fx', fy').

    Every plane is edge-padded by halo = iters + D + 2 and the padded
    plane is iterated as one window (``_relax_window``); the
    regularisation target is the separable Gaussian (x first) of the
    f_base planes edge-padded by a further kernel radius.  The output
    crops the halo.  The kernel runs the same math per output tile on
    the tile's halo window; the two agree wherever the halo covers the
    iterations' reach."""
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
    bxg, byg = _pad2(bx, n, n, n, n), _pad2(by, n, n, n, n)
    bxb = bxg[..., gr:gr + hp, gr:gr + wp]
    byb = byg[..., gr:gr + hp, gr:gr + wp]
    fxp, fyp, i0xp, i0yp, mp = (_pad2(a, halo, halo, halo, halo)
                                for a in (fx, fy, i0x, i0y, mask))
    out = _relax_window(fxp, fyp, bxb, byb, blur_valid(bxg), blur_valid(byg),
                        torch.stack([w1x, w1y], dim=1), i0xp, i0yp, mp,
                        params, iters, D, w)
    return _crop(*out, halo, h, w)


def relax_phase_unfused_plain(fx, fy, bx, by, w1x, w1y, i0x, i0y, bfx, bfy,
                              mask, params: FlowParams, iters: int, D: int):
    """The unfused relax kernel's contract on (B, H, W) planes: returns
    (fx', fy').  As ``relax_phase_fused_plain``, with the regularisation
    target given as ``bfx``/``bfy`` and edge-padded by the halo like every
    other plane (the reference pads it so, kernels.py:394-396)."""
    nb, h, w = fx.shape
    halo = iters + D + 2
    padded = [_pad2(a, halo, halo, halo, halo)
              for a in (fx, fy, bx, by, bfx, bfy, i0x, i0y, mask)]
    out = _relax_window(*padded[:6], torch.stack([w1x, w1y], dim=1),
                        *padded[6:], params, iters, D, w)
    return _crop(*out, halo, h, w)


def _relax_check(name: str, planes: dict, iters: int,
                 D: int) -> torch.device:
    if planes["fx"].dim() != 3:
        raise ValueError(f"{name}: planes must be (B, H, W)")
    if D < 1 or iters < 1:
        raise ValueError(f"{name}: needs D >= 1 and iters >= 1, "
                         f"got D={D}, iters={iters}")
    return _check(name, planes, {k: planes["fx"].shape for k in planes})


def _relax_smem_check(name: str, params: FlowParams, iters: int, D: int,
                      fuse_bf: bool) -> None:
    """Raise when the kernel refuses the geometry: a block's halo window
    grows with ``iters`` and ``D``, and must fit the card's shared memory
    and the 4096 pixels a block's threads own, with at least 8 tile rows
    (at D = 2: at most 14 iterations on an H100).  The error names the
    most iterations this card takes at ``D``."""
    from panorama_opticalflow_tpu_torch.ops import build

    kw = params.blurred_flow_kernel_width
    lib = build.load()
    if fuse_bf and lib.pano_relax_smem(iters, D, kw, 1) == 0:
        raise ValueError(f"{name}: the blur scratch of a {kw}-tap target "
                         f"does not fit at iters={iters}, D={D}")
    _card_limit(f"{name} at D={D}", "iters",
                lambda it: lib.pano_relax_smem(it, D, kw, int(fuse_bf)),
                range(1, 65), iters)


def _relax_scalars(params: FlowParams, w: int, D: int) -> tuple:
    vreg_w, hreg_w = _reg_w(params, w)
    return (float(D - 1e-3), params.smoothness_coef,
            params.gradient_step_size, vreg_w, hreg_w,
            int(params.fold_descent_sample), int(params.w1_bf16))


def relax_phase(fx, fy, bx, by, w1x, w1y, i0x, i0y, mask,
                params: FlowParams, iters: int, D: int):
    """``iters`` relaxation iterations on (B, H, W) float32 planes with the
    blurred-flow target computed from ``bx``/``by`` (f_base) in the
    kernel (single-phase levels).  ``mask`` is 1.0 where updatable.
    Returns (fx', fy')."""
    planes = {"fx": fx, "fy": fy, "bx": bx, "by": by, "w1x": w1x,
              "w1y": w1y, "i0x": i0x, "i0y": i0y, "mask": mask}
    dev = _relax_check("relax_phase", planes, iters, D)
    kw = params.blurred_flow_kernel_width
    if kw < 1:
        raise ValueError(f"relax_phase: blur width >= 1, got {kw}")
    if dev.type == "cpu":
        return relax_phase_fused_plain(fx, fy, bx, by, w1x, w1y, i0x, i0y,
                                       mask, params, iters, D)
    _relax_smem_check("relax_phase", params, iters, D, True)
    nb, h, w = fx.shape
    ofx = torch.empty_like(fx)
    ofy = torch.empty_like(fy)
    taps = np.ascontiguousarray(
        gaussian_kernel_1d(kw, params.blurred_flow_sigma))
    _launch("relax_phase", "pano_relax_phase_fused",
            *(t.data_ptr() for t in planes.values()), ofx.data_ptr(),
            ofy.data_ptr(), nb, h, w, iters, D,
            taps.ctypes.data_as(ctypes.c_void_p), kw,
            *_relax_scalars(params, w, D), _stream())
    relax_phase.launches += 1
    return ofx, ofy


relax_phase.launches = 0


def relax_phase_unfused(fx, fy, bx, by, w1x, w1y, i0x, i0y, bfx, bfy, mask,
                        params: FlowParams, iters: int, D: int):
    """``iters`` relaxation iterations on (B, H, W) float32 planes against
    the given blurred-flow target ``bfx``/``bfy`` (each phase of a
    multi-phase or unfused level; ``bx``/``by`` is the phase's f_base).
    ``mask`` is 1.0 where updatable.  Returns (fx', fy')."""
    planes = {"fx": fx, "fy": fy, "bx": bx, "by": by, "w1x": w1x,
              "w1y": w1y, "i0x": i0x, "i0y": i0y, "bfx": bfx, "bfy": bfy,
              "mask": mask}
    dev = _relax_check("relax_phase_unfused", planes, iters,
                       D)
    if dev.type == "cpu":
        return relax_phase_unfused_plain(fx, fy, bx, by, w1x, w1y, i0x, i0y,
                                         bfx, bfy, mask, params, iters, D)
    _relax_smem_check("relax_phase_unfused", params, iters, D, False)
    nb, h, w = fx.shape
    ofx = torch.empty_like(fx)
    ofy = torch.empty_like(fy)
    _launch("relax_phase_unfused", "pano_relax_phase_unfused",
            *(t.data_ptr() for t in planes.values()), ofx.data_ptr(),
            ofy.data_ptr(), nb, h, w, iters, D,
            *_relax_scalars(params, w, D), _stream())
    relax_phase_unfused.launches += 1
    return ofx, ofy


relax_phase_unfused.launches = 0

# ---------------------------------------------------------------------------
# 5. the exact relaxation of a small level, one block a direction
# ---------------------------------------------------------------------------


def exact_level_plain(i0x, i0y, i1g, a0, a1, flow, params: FlowParams,
                      phases: int, iters: int) -> torch.Tensor:
    """The exact level's contract on (B, H, W) planes with (B, H, W, 2)
    ``i1g`` and ``flow``: the blurred-flow target of ``flow``, ``phases``
    x (``iters`` ``relax_iteration`` rounds, then the 5x5 median), then
    the low-alpha diffusion.  Returns the (B, H, W, 2) flow."""
    nb = i0x.shape[0]
    update_mask = ((a0 > params.update_alpha_threshold)
                   & (a1 > params.update_alpha_threshold))
    blurred_flow = _blur_flow(flow, params)
    for _ in range(phases):
        f = flow
        for _ in range(iters):
            f = relax_iteration(f, i0x, i0y, i1g, blurred_flow,
                                update_mask, params)
        flow = _from_planes(median5_plain(_as_planes(f)), nb)
    return low_alpha_flow_diffusion(flow, a0, a1, params)


def _f32(v: float) -> float:
    return float(np.float32(v))


def exact_level(i0x, i0y, i1g, a0, a1, flow, params: FlowParams,
                phases: int, iters: int) -> torch.Tensor:
    """One exact pyramid level, both directions of every pair at once:
    (B, H, W) float32 ``i0x``, ``i0y``, ``a0``, ``a1`` and (B, H, W, 2)
    ``i1g`` and ``flow``; returns the (B, H, W, 2) flow, bit for bit
    ``exact_level_plain``'s on the same device.  The kernel holds a
    direction's planes in one block: H and W of at least 2, and at most
    the pixels whose planes fit the card's shared memory."""
    if i0x.dim() != 3:
        raise ValueError("exact_level: planes must be (B, H, W)")
    if min(phases, iters) < 0:
        raise ValueError(f"exact_level: phases and iters must be >= 0, "
                         f"got {phases}, {iters}")
    nb, h, w = i0x.shape
    kw = params.blurred_flow_kernel_width
    if min(h, w) < 2 or not 1 <= kw <= 80:
        raise ValueError(f"exact_level: needs H, W >= 2 and a blur width "
                         f"of 1 to 80, got {(h, w)} and {kw}")
    dev = _check("exact_level", {"i0x": i0x, "i0y": i0y, "i1g": i1g,
                                 "a0": a0, "a1": a1, "flow": flow},
                 {"i0x": (nb, h, w), "i0y": (nb, h, w),
                  "i1g": (nb, h, w, 2), "a0": (nb, h, w),
                  "a1": (nb, h, w), "flow": (nb, h, w, 2)})
    if dev.type == "cpu":
        return exact_level_plain(i0x, i0y, i1g, a0, a1, flow, params,
                                 phases, iters)
    from panorama_opticalflow_tpu_torch.ops import build

    _card_limit("exact_level", "pixels", build.load().pano_exact_level_smem,
                range(1, 8193), h * w)
    taps = np.ascontiguousarray(
        gaussian_kernel_1d(kw, params.blurred_flow_sigma))
    out = torch.empty_like(flow)
    # a division by a Python number is, on the card, PyTorch's product
    # with the reciprocal taken in double and rounded to float32
    _launch("exact_level", "pano_exact_level", i0x.data_ptr(),
            i0y.data_ptr(), i1g.data_ptr(), a0.data_ptr(), a1.data_ptr(),
            flow.data_ptr(), out.data_ptr(), nb, h, w, phases, iters,
            taps.ctypes.data_as(ctypes.c_void_p), kw,
            _f32(params.update_alpha_threshold), _f32(params.smoothness_coef),
            _f32(params.vertical_regularization_coef),
            _f32(params.horizontal_regularization_coef),
            _f32(1.0 / w), _f32(params.grad_epsilon),
            _f32(1.0 / params.grad_epsilon), _f32(params.gradient_step_size),
            _stream())
    exact_level.launches += 1
    return out


exact_level.launches = 0

# ---------------------------------------------------------------------------
# 6. the small levels (below pallas_min_pixels): the plain branch's borders
# ---------------------------------------------------------------------------


def _small_relax_plain(fx, fy, f_base, w1x, w1y, i0x, i0y, target, mask,
                       params: FlowParams, iters: int, D: int):
    out = relax_phase_fast(torch.stack([fx, fy], -1), f_base,
                           torch.stack([w1x, w1y], -1), i0x, i0y, target,
                           mask > 0, params, iters, D)
    return out[..., 0].contiguous(), out[..., 1].contiguous()


def small_relax_phase_plain(fx, fy, bx, by, w1x, w1y, i0x, i0y, mask,
                            params: FlowParams, iters: int, D: int):
    """The small relax kernel's contract on (B, H, W) planes: the plain
    level's relaxation (``ops.relax_fast.relax_phase_fast``: a candidate
    from outside the image is none) against the reflect-101 Gaussian of
    f_base, the y pass first (``ops.relax_exact._blur_flow``).  Returns
    (fx', fy')."""
    f_base = torch.stack([bx, by], -1)
    return _small_relax_plain(fx, fy, f_base, w1x, w1y, i0x, i0y,
                              _blur_flow(f_base, params), mask, params,
                              iters, D)


def small_relax_phase_unfused_plain(fx, fy, bx, by, w1x, w1y, i0x, i0y, bfx,
                                    bfy, mask, params: FlowParams,
                                    iters: int, D: int):
    """As ``small_relax_phase_plain`` against the given target
    ``bfx``/``bfy``."""
    return _small_relax_plain(fx, fy, torch.stack([bx, by], -1), w1x, w1y,
                              i0x, i0y, torch.stack([bfx, bfy], -1), mask,
                              params, iters, D)


def small_median5_diffuse_plain(x: torch.Tensor, c: torch.Tensor,
                                ksize: int = 15, sigma: float = 8.0
                                ) -> torch.Tensor:
    """The plain level's median and low-alpha diffusion on (2B, H, W)
    planes with (B, H, W) coefficients ``c = 1 - a0*a1``: ``im.median5``
    (edge-replicated), then ``c * gauss(med) + (1 - c) * med`` with the
    reflect-101 Gaussian, y pass first
    (``ops.relax_exact.low_alpha_flow_diffusion``)."""
    med = median5_plain(x)
    cc = c.repeat_interleave(2, dim=0)
    return cc * gaussian_blur(med, ksize, sigma) + (1.0 - cc) * med


def _small_check(name: str, h: int, w: int) -> None:
    if min(h, w) < 2:
        raise ValueError(f"{name}: needs H, W >= 2 (reflect-101 borders), "
                         f"got {(h, w)}")


def _small_scalars(params: FlowParams, w: int, D: int) -> tuple:
    """The kernel's scalars in the plain ops' float32 values; a division
    by a Python number is, on the card, PyTorch's product with the
    reciprocal taken in double and rounded to float32."""
    return (float(D - 1e-3), params.smoothness_coef,
            params.gradient_step_size,
            _f32(params.vertical_regularization_coef),
            _f32(params.horizontal_regularization_coef), _f32(1.0 / w),
            int(params.fold_descent_sample), int(params.w1_bf16))


def _small_launches(wrapper, entry: str, planes: dict, params: FlowParams,
                    iters: int, D: int, *taps) -> tuple:
    """``iters`` iterations in launches of at most SMALL_RELAX_ITERS
    (fewer where a wide hat window leaves no room in a block), each from
    the flow the last one wrote; counts them on ``wrapper``."""
    from panorama_opticalflow_tpu_torch.ops import build

    name = wrapper.__name__
    lib = build.load()
    limit = lib.pano_smem_limit()
    kw, fused = params.blurred_flow_kernel_width, int(bool(taps))
    fit = [k for k in range(min(iters, SMALL_RELAX_ITERS), 0, -1)
           if 0 < lib.pano_small_relax_smem(k, D, kw, fused) <= limit]
    if not fit:
        raise ValueError(f"{name} at D={D}: not one iteration's window fits "
                         f"a block on this card")
    nb, h, w = planes["fx"].shape
    rest = [t.data_ptr() for t in list(planes.values())[2:]]
    fx, fy = planes["fx"], planes["fy"]
    for done in range(0, iters, fit[0]):
        ofx, ofy = torch.empty_like(fx), torch.empty_like(fy)
        _launch(name, entry, fx.data_ptr(), fy.data_ptr(), *rest,
                ofx.data_ptr(), ofy.data_ptr(), nb, h, w,
                min(fit[0], iters - done), D, *taps,
                *_small_scalars(params, w, D), _stream())
        wrapper.launches += 1
        fx, fy = ofx, ofy
    return fx, fy


def small_relax_phase(fx, fy, bx, by, w1x, w1y, i0x, i0y, mask,
                      params: FlowParams, iters: int, D: int):
    """``iters`` relaxation iterations of a small level on (B, H, W)
    float32 planes, the target computed in the kernel from ``bx``/``by``
    (f_base): bit for bit ``small_relax_phase_plain`` on the same device.
    ``mask`` is 1.0 where updatable.  Returns (fx', fy').  One launch up
    to SMALL_RELAX_ITERS iterations."""
    planes = {"fx": fx, "fy": fy, "bx": bx, "by": by, "w1x": w1x,
              "w1y": w1y, "i0x": i0x, "i0y": i0y, "mask": mask}
    dev = _relax_check("small_relax_phase", planes, iters, D)
    _small_check("small_relax_phase", *fx.shape[1:])
    kw = params.blurred_flow_kernel_width
    if kw < 1:
        raise ValueError(f"small_relax_phase: blur width >= 1, got {kw}")
    if dev.type == "cpu":
        return small_relax_phase_plain(fx, fy, bx, by, w1x, w1y, i0x, i0y,
                                       mask, params, iters, D)
    taps = np.ascontiguousarray(
        gaussian_kernel_1d(kw, params.blurred_flow_sigma))
    return _small_launches(small_relax_phase, "pano_small_relax_phase_fused",
                           planes, params, iters, D,
                           taps.ctypes.data_as(ctypes.c_void_p), kw)


small_relax_phase.launches = 0


def small_relax_phase_unfused(fx, fy, bx, by, w1x, w1y, i0x, i0y, bfx, bfy,
                              mask, params: FlowParams, iters: int, D: int):
    """``iters`` relaxation iterations of a small level on (B, H, W)
    float32 planes against the given target ``bfx``/``bfy`` (each phase of
    a multi-phase or unfused level): bit for bit
    ``small_relax_phase_unfused_plain`` on the same device.  Returns
    (fx', fy').  One launch up to SMALL_RELAX_ITERS iterations."""
    planes = {"fx": fx, "fy": fy, "bx": bx, "by": by, "w1x": w1x,
              "w1y": w1y, "i0x": i0x, "i0y": i0y, "bfx": bfx, "bfy": bfy,
              "mask": mask}
    dev = _relax_check("small_relax_phase_unfused", planes, iters, D)
    _small_check("small_relax_phase_unfused", *fx.shape[1:])
    if dev.type == "cpu":
        return small_relax_phase_unfused_plain(fx, fy, bx, by, w1x, w1y, i0x,
                                               i0y, bfx, bfy, mask, params,
                                               iters, D)
    return _small_launches(small_relax_phase_unfused,
                           "pano_small_relax_phase_unfused", planes, params,
                           iters, D)


small_relax_phase_unfused.launches = 0


def small_median5_diffuse(x: torch.Tensor, c: torch.Tensor, ksize: int = 15,
                          sigma: float = 8.0) -> torch.Tensor:
    """A small level's median and low-alpha diffusion on (2B, H, W) flow
    planes with (B, H, W) coefficients ``c = 1 - a0*a1``: bit for bit
    ``small_median5_diffuse_plain`` on the same device.  Any blur width
    whose window fits the card's shared memory (the kernel unrolls 15)."""
    if x.dim() != 3 or x.shape[0] % 2:
        raise ValueError("small_median5_diffuse: x must be (2B, H, W)")
    if int(ksize) != ksize or ksize < 1:
        raise ValueError(f"small_median5_diffuse: ksize must be >= 1, got "
                         f"{ksize}")
    p2, h, w = x.shape
    dev = _check("small_median5_diffuse", {"x": x, "c": c},
                 {"x": (p2, h, w), "c": (p2 // 2, h, w)})
    _small_check("small_median5_diffuse", h, w)
    if dev.type == "cpu":
        return small_median5_diffuse_plain(x, c, ksize, sigma)
    if ksize not in DIFFUSE_WIDTHS:   # a window of up to 15 taps fits
        from panorama_opticalflow_tpu_torch.ops import build

        _card_limit("small_median5_diffuse", "ksize",
                    build.load().pano_median5_diffuse_smem, range(1, 81),
                    ksize)
    taps = np.ascontiguousarray(gaussian_kernel_1d(ksize, sigma))
    out = torch.empty_like(x)
    _launch("small_median5_diffuse", "pano_small_median5_diffuse",
            x.data_ptr(), c.data_ptr(), out.data_ptr(), p2, h, w,
            taps.ctypes.data_as(ctypes.c_void_p), ksize, _stream())
    small_median5_diffuse.launches += 1
    return out


small_median5_diffuse.launches = 0

# ---------------------------------------------------------------------------
# 7. the novel-view stage: both samplers, the combiner, the window's place
# ---------------------------------------------------------------------------

# Deghost constants (CPU/OpticalFlow.cpp:57-59)
K_COLOR_DIFF_COEF = 10.0
K_SOFTMAX_SHARPNESS = 10.0
K_FLOW_MAG_COEF = 100.0

# Windows at least this large take the tiled sampler, smaller ones the
# exact gather -- the reference's switch, kept so both packages sample
# identically at every canvas size.
TILED_SAMPLER_MIN_H = 256
TILED_SAMPLER_MIN_W = 512


def _tiled_sampler(h: int, w: int) -> bool:
    return h >= TILED_SAMPLER_MIN_H and w >= TILED_SAMPLER_MIN_W


def combine_views_plain(image_l: torch.Tensor, image_r: torch.Tensor,
                        flow_l_to_r: torch.Tensor, flow_r_to_l: torch.Tensor,
                        blend: torch.Tensor) -> torch.Tensor:
    """combineNovelViews (CPU/OpticalFlow.cpp:30-92): colorL samples imageL
    through flowRtoL scaled by blendR, colorR samples imageR through
    flowLtoR scaled by blendL; transparent where either sample has zero
    alpha, otherwise a ghost-gated softmax mix.  Images (H, W, 4), flows
    (H, W, 2) and blend (H, W), or all with a leading N."""
    h, w = image_l.shape[-3:-1]
    blend_r = blend
    blend_l = 1.0 - blend_r
    sampler = (sample_nearest_wrap_tiled if _tiled_sampler(h, w)
               else sample_nearest_wrap)
    color_l = sampler(image_l, flow_r_to_l, blend_r).float()
    color_r = sampler(image_r, flow_l_to_r, blend_l).float()

    def mag(f):
        return torch.sqrt(f[..., 0] * f[..., 0] + f[..., 1] * f[..., 1]) / w

    mag_lr, mag_rl = mag(flow_l_to_r), mag(flow_r_to_l)
    color_diff = (torch.abs(color_l[..., 0] - color_r[..., 0])
                  + torch.abs(color_l[..., 1] - color_r[..., 1])
                  + torch.abs(color_l[..., 2] - color_r[..., 2])) / 255.0
    deghost = torch.tanh(color_diff * K_COLOR_DIFF_COEF)
    alpha_l = color_l[..., 3] / 255.0
    alpha_r = color_r[..., 3] / 255.0

    # numerically-stable softmax (the reference's raw exps overflow)
    a_l = K_SOFTMAX_SHARPNESS * blend_l * alpha_l \
        * (1.0 + K_FLOW_MAG_COEF * mag_rl)
    a_r = K_SOFTMAX_SHARPNESS * blend_r * alpha_r \
        * (1.0 + K_FLOW_MAG_COEF * mag_lr)
    m = torch.maximum(a_l, a_r)
    exp_l = torch.exp(a_l - m)
    exp_r = torch.exp(a_r - m)
    sum_exp = exp_l + exp_r + 1e-5 * torch.exp(-m)
    softmax_l = exp_l / sum_exp
    softmax_r = exp_r / sum_exp

    w_l = (blend_l + deghost * (softmax_l - blend_l))[..., None]
    w_r = (blend_r + deghost * (softmax_r - blend_r))[..., None]
    rgb = color_l[..., :3] * w_l + color_r[..., :3] * w_r
    rgb_u8 = torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)
    out = torch.cat([rgb_u8, torch.full(rgb_u8.shape[:-1] + (1,), 255,
                                        dtype=torch.uint8,
                                        device=rgb_u8.device)], dim=-1)
    transparent = (color_l[..., 3] == 0) | (color_r[..., 3] == 0)
    return torch.where(transparent[..., None],
                       torch.zeros(4, dtype=torch.uint8, device=out.device),
                       out)


def novel_view_plain(image_l: torch.Tensor, image_r: torch.Tensor,
                     flow_l_to_r: torch.Tensor, flow_r_to_l: torch.Tensor,
                     blend: torch.Tensor, window: tuple | None = None
                     ) -> torch.Tensor:
    """The novel-view kernel's contract: the window's columns of both
    canvases (``models.stitcher.window_cols``), ``combine_views_plain`` on
    them with the window's flows and blend, and the merged window at its
    columns of a zero canvas (``place_cols``).  No window: the whole
    canvas, unrolled."""
    if window is None:
        return combine_views_plain(image_l, image_r, flow_l_to_r,
                                   flow_r_to_l, blend)
    from panorama_opticalflow_tpu_torch.models.stitcher import (place_cols,
                                                              window_cols)

    roll, width = window
    merged = combine_views_plain(window_cols(image_l, roll, width, dim=-2),
                                 window_cols(image_r, roll, width, dim=-2),
                                 flow_l_to_r, flow_r_to_l, blend)
    return place_cols(merged, roll, image_l.shape[-2], dim=-2)


def _rows_of(t: torch.Tensor, pixel: int) -> torch.Tensor:
    """``t`` where its pixels lie dense along a row (``pixel`` floats
    each, 8-byte aligned for a flow); else a contiguous copy.  A window
    or a wrap-cropped flow is a view with a longer row stride."""
    if (t.stride(-1) == 1 and (pixel == 1 or t.stride(-2) == pixel)
            and all(s % pixel == 0 for s in t.stride()[:-1])
            and t.data_ptr() % (4 * pixel) == 0):
        return t
    return t.contiguous()


def novel_view(image_l: torch.Tensor, image_r: torch.Tensor,
               flow_l_to_r: torch.Tensor, flow_r_to_l: torch.Tensor,
               blend: torch.Tensor, window: tuple | None = None
               ) -> torch.Tensor:
    """The novel-view stage of a pair, or of a stack of N pairs: canvases
    (..., H, W, 4) uint8, the window's flows (..., H, width, 2) and blend
    (..., H, width) float32, the window (roll, width) with the roll an int
    or a 0-d int64 tensor on the canvases' device (read there, never on the
    host); no window is roll 0 and width W.  Returns the (..., H, W, 4)
    uint8 canvas of the merged view, zero outside the window, bit for bit
    ``novel_view_plain``'s on the same device.  The window's shape picks
    the sampler (tiled at TILED_SAMPLER_MIN_H x _W and above).  One launch
    a call."""
    if image_l.dim() not in (3, 4):
        raise ValueError("novel_view: canvases must be (H, W, 4) or "
                         "(N, H, W, 4)")
    lead, (h, w) = image_l.shape[:-3], image_l.shape[-3:-1]
    roll, width = (0, w) if window is None else window
    if not 1 <= width <= w:
        raise ValueError(f"novel_view: window width {width} outside "
                         f"[1, {w}]")
    shapes = {"image_l": (*lead, h, w, 4), "image_r": (*lead, h, w, 4),
              "flow_l_to_r": (*lead, h, width, 2),
              "flow_r_to_l": (*lead, h, width, 2),
              "blend": (*lead, h, width)}
    args = {"image_l": image_l, "image_r": image_r,
            "flow_l_to_r": flow_l_to_r, "flow_r_to_l": flow_r_to_l,
            "blend": blend}
    for key, t in args.items():
        want = torch.uint8 if key.startswith("image") else torch.float32
        if not isinstance(t, torch.Tensor) or t.dtype != want:
            raise TypeError(f"novel_view: {key} must be a {want} tensor")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"novel_view: {key} has shape "
                             f"{tuple(t.shape)}, expected {shapes[key]}")
        if t.device != image_l.device:
            raise ValueError(f"novel_view: {key} is on {t.device}, not "
                             f"{image_l.device}")
    if isinstance(roll, torch.Tensor) and (
            roll.dtype != torch.int64 or roll.numel() != 1
            or roll.device != image_l.device):
        raise ValueError(f"novel_view: a tensor roll must be one int64 on "
                         f"{image_l.device}")
    if image_l.device.type == "cpu":
        return novel_view_plain(image_l, image_r, flow_l_to_r, flow_r_to_l,
                                blend, window)
    if image_l.device.type != "cuda":
        raise ValueError(f"novel_view: unsupported device {image_l.device}")
    flat = (-1, h, w, 4)
    img_l, img_r = (t.reshape(flat).contiguous() for t in (image_l, image_r))
    flr, frl = (_rows_of(f.reshape(-1, h, width, 2), 2)
                for f in (flow_l_to_r, flow_r_to_l))
    if flr.stride() != frl.stride():
        flr, frl = flr.contiguous(), frl.contiguous()
    bl = _rows_of(blend.reshape(-1, h, width), 1)
    nb = img_l.shape[0]
    out = (torch.empty if width == w else torch.zeros)(
        (nb, h, w, 4), dtype=torch.uint8, device=image_l.device)
    tensor_roll = isinstance(roll, torch.Tensor)
    # a division by a Python number is, on the card, PyTorch's product with
    # the float32 reciprocal
    _launch("novel_view", "pano_novel_view", img_l.data_ptr(),
            img_r.data_ptr(), flr.data_ptr(), frl.data_ptr(), bl.data_ptr(),
            out.data_ptr(), nb, h, w, width, flr.stride(0), flr.stride(1),
            bl.stride(0), bl.stride(1),
            roll.data_ptr() if tensor_roll else None,
            0 if tensor_roll else int(roll),
            float(np.float32(1.0) / np.float32(width)),
            int(_tiled_sampler(h, width)), _stream())
    novel_view.launches += 1
    return out.reshape(*lead, h, w, 4)


novel_view.launches = 0

# ---------------------------------------------------------------------------
# 8. the blend field's eight-ray distances, both classes of a canvas map
# ---------------------------------------------------------------------------

# canvas map codes of the two pure regions (models.stitcher.match_images)
CODE_L, CODE_R = 100, 50


def blend_distances_plain(codes: torch.Tensor, step: int, max_i: float,
                          crop: int = 0
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The eight-ray kernel's contract: ``eight_ray_min_distance`` of the
    pure-L pixels (code 100) and of the pure-R pixels (code 50) of a canvas
    map, each cut to its columns [crop, W - crop)."""
    d_l = eight_ray_min_distance(codes == CODE_L, step, max_i)
    d_r = eight_ray_min_distance(codes == CODE_R, step, max_i)
    return crop_x(d_l, crop, -1), crop_x(d_r, crop, -1)


def blend_distances(codes: torch.Tensor, step: int, max_i: float,
                    crop: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The strided eight-ray min distances of a canvas map to its pure-L
    and to its pure-R pixels: ``codes`` an (H, W) or (N, H, W) uint8 map
    (any strides; each map of a stack searched alone), the ray stride
    ``step`` >= 1 and the cut ``max_i``.  Returns float32 (d_l, d_r) of the
    map's columns [crop, W - crop), +inf where no ray hits, bit for bit
    ``blend_distances_plain``'s on the same device.  One launch a call."""
    if not isinstance(codes, torch.Tensor) or codes.dtype != torch.uint8:
        raise TypeError("blend_distances: codes must be a uint8 tensor")
    if codes.dim() not in (2, 3) or min(codes.shape) < 1:
        raise ValueError(f"blend_distances: codes must be a non-empty "
                         f"(H, W) or (N, H, W) map, got {tuple(codes.shape)}")
    if int(step) != step or step < 1:
        raise ValueError(f"blend_distances: step must be an int >= 1, got "
                         f"{step}")
    h, w = codes.shape[-2:]
    if int(crop) != crop or not 0 <= 2 * crop < w:
        raise ValueError(f"blend_distances: crop {crop} leaves no column of "
                         f"{w}")
    dev = codes.device
    if dev.type == "cpu":
        return blend_distances_plain(codes, step, max_i, crop)
    if dev.type != "cuda":
        raise ValueError(f"blend_distances: unsupported device {dev}")
    flat = codes if codes.dim() == 3 else codes[None]
    nb, wout = flat.shape[0], w - 2 * crop
    out = torch.full((2, nb, h, wout), float("inf"), dtype=torch.float32,
                     device=dev)
    # the plain ops compare with max_i and multiply by sqrt(2) as float32
    # scalars
    _launch("blend_distances", "pano_eight_ray", flat.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), nb, h, w, *flat.stride(),
            int(step), int(crop), wout, _f32(max_i), _f32(math.sqrt(2.0)),
            _stream())
    blend_distances.launches += 1
    if codes.dim() == 2:
        return out[0, 0], out[1, 0]
    return out[0], out[1]


blend_distances.launches = 0

# ---------------------------------------------------------------------------
# 9. the final composite, with the overlap holes' eight-ray search
# ---------------------------------------------------------------------------

# the largest search radius the plain version's int16 doubling field holds
# exactly: its sentinel 32000 plus 2 (2^p - 1), for the 2^p >= radius its
# passes reach, stays below 32767
HOLE_RADIUS_MAX = 256


def hole_composite_plain(ctx_map: torch.Tensor, image_l: torch.Tensor,
                         image_r: torch.Tensor, merged: torch.Tensor,
                         radius: int, window: tuple | None = None
                         ) -> torch.Tensor:
    """The composite kernel's contract: code = map + 75 (merged alpha >
    0); 100 -> L, 50 -> R, {225, 175, 125} -> merged, 150 -> the fill of
    ``ops.distance.two_class_hole_search`` at ``radius`` on the window's
    columns (``models.stitcher.window_cols``, placed back by
    ``place_cols``: 0 outside the window) or on the whole canvas, opaque
    black where it finds nothing; any other code 0."""
    merged_a = threshold_binary(merged[..., 3], 0, 75)
    code = ctx_map + merged_a
    black = torch.zeros(4, dtype=torch.uint8, device=image_l.device)
    black[3:].fill_(255)

    def hole_from(codes, img_l, img_r):
        found, take_l = two_class_hole_search(codes == CODE_L,
                                              codes == CODE_R, radius)
        return torch.where(found[..., None],
                           torch.where(take_l[..., None], img_l, img_r),
                           black)

    if window is None:
        hole = hole_from(code, image_l, image_r)
    else:
        from panorama_opticalflow_tpu_torch.models.stitcher import (
            place_cols, window_cols)

        roll, width = window
        hole = place_cols(hole_from(window_cols(code, roll, width),
                                    window_cols(image_l, roll, width),
                                    window_cols(image_r, roll, width)),
                          roll, ctx_map.shape[-1])

    zero = torch.zeros((4,), dtype=torch.uint8, device=image_l.device)
    out = torch.where((code == CODE_L)[..., None], image_l, zero)
    out = torch.where((code == CODE_R)[..., None], image_r, out)
    is_merged = (code == 225) | (code == 175) | (code == 125)
    out = torch.where(is_merged[..., None], merged, out)
    return torch.where((code == 150)[..., None], hole, out)


def _rgba_rows(t: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``t`` as a contiguous (N, H, W, 4) stack whose pixels are 4-byte
    aligned (the kernel loads a pixel as one word)."""
    t = t.reshape(shape).contiguous()
    return t.clone() if t.data_ptr() % 4 else t


def hole_composite(ctx_map: torch.Tensor, image_l: torch.Tensor,
                   image_r: torch.Tensor, merged: torch.Tensor, radius: int,
                   window: tuple | None = None) -> torch.Tensor:
    """The final composite of a pair, or of a stack of N pairs: the canvas
    map (..., H, W) and the canvases L, R and the merged view (..., H, W,
    4), all uint8; the hole search's ``radius`` (1 to HOLE_RADIUS_MAX); the
    search's window (roll, width) with the roll an int or a 0-d int64
    tensor on the canvases' device (read there, never on the host), for
    one pair only; no window is the whole canvas.  Returns the (..., H, W,
    4) uint8 composite, bit for bit ``hole_composite_plain``'s on the same
    device.  One launch a call."""
    args = {"ctx_map": ctx_map, "image_l": image_l, "image_r": image_r,
            "merged": merged}
    for key, t in args.items():
        if not isinstance(t, torch.Tensor) or t.dtype != torch.uint8:
            raise TypeError(f"hole_composite: {key} must be a uint8 tensor")
    if ctx_map.dim() not in (2, 3) or min(ctx_map.shape) < 1:
        raise ValueError(f"hole_composite: ctx_map must be a non-empty "
                         f"(H, W) or (N, H, W) map, got "
                         f"{tuple(ctx_map.shape)}")
    dev = ctx_map.device
    for key in ("image_l", "image_r", "merged"):
        t = args[key]
        if tuple(t.shape) != tuple(ctx_map.shape) + (4,):
            raise ValueError(f"hole_composite: {key} has shape "
                             f"{tuple(t.shape)}, expected "
                             f"{tuple(ctx_map.shape) + (4,)}")
        if t.device != dev:
            raise ValueError(f"hole_composite: {key} is on {t.device}, not "
                             f"{dev}")
    if int(radius) != radius or not 1 <= radius <= HOLE_RADIUS_MAX:
        raise ValueError(f"hole_composite: radius must be an int in [1, "
                         f"{HOLE_RADIUS_MAX}], got {radius}")
    h, w = ctx_map.shape[-2:]
    roll, width = (0, w) if window is None else window
    if window is not None and ctx_map.dim() != 2:
        raise ValueError("hole_composite: a window takes one pair, not a "
                         "stack")
    if not 1 <= width <= w:
        raise ValueError(f"hole_composite: window width {width} outside "
                         f"[1, {w}]")
    if isinstance(roll, torch.Tensor) and (
            roll.dtype != torch.int64 or roll.numel() != 1
            or roll.device != dev):
        raise ValueError(f"hole_composite: a tensor roll must be one int64 "
                         f"on {dev}")
    if dev.type == "cpu":
        return hole_composite_plain(ctx_map, image_l, image_r, merged,
                                    int(radius), window)
    if dev.type != "cuda":
        raise ValueError(f"hole_composite: unsupported device {dev}")
    codes = ctx_map.reshape(-1, h, w).contiguous()
    nb = codes.shape[0]
    img_l, img_r, mrg = (_rgba_rows(t, (nb, h, w, 4))
                         for t in (image_l, image_r, merged))
    out = torch.empty((nb, h, w, 4), dtype=torch.uint8, device=dev)
    tensor_roll = isinstance(roll, torch.Tensor)
    _launch("hole_composite", "pano_hole_composite", codes.data_ptr(),
            img_l.data_ptr(), img_r.data_ptr(), mrg.data_ptr(),
            out.data_ptr(), nb, h, w,
            roll.data_ptr() if tensor_roll else None,
            0 if tensor_roll else int(roll), int(width), int(radius),
            _stream())
    hole_composite.launches += 1
    return out.reshape(image_l.shape)


hole_composite.launches = 0

KERNELS = (warp_tiled, relax_phase, median5_diffuse,
           relax_phase_unfused, median5, exact_level, small_relax_phase,
           small_relax_phase_unfused, small_median5_diffuse, novel_view,
           blend_distances, hole_composite)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
