"""End-to-end stitch pipelines (port of the reference's
``models/pipeline.py``): the 6-input iterative chain (CPU/main.cpp:47-110),
the 4-input single pass (CPU_4Input/main.cpp:47-119), N pairs stitched
together, and the debug variant that keeps its intermediates.

``stitch_six`` plans every pair's overlap window up front from the input
alphas, then runs the chain, each pair one windowed pass: geometry,
windowed blend field, windowed bidirectional flow, windowed combine,
full-canvas composite.  ``stitch_four`` composes its two canvases and
takes one such pass.  ``stitch_pairs`` is the full-canvas ``stitch_pair``
of N pairs with one pyramid descent for all their flows (what ``vmap``
over ``stitch_pair`` gives the reference).

On a card each of these runs as a captured program (``utils.programs``),
the counterpart of the reference's jitted programs: the windowed pair
body (``_stitch_pair_windowed_body`` there) keyed by its window's width,
the whole chain (``_chain_windowed_jit``) keyed by the planned widths
(the rolls are an input of both, as the reference traces them), and the
full-canvas pass (the jitted ``stitch_pair``) keyed by the stack's N.  The
window planning reads the host and stays outside them.

The spans (``utils.trace``): an entry's call is ``stitch.six``,
``stitch.four`` or ``stitch.pairs``, with the window plan (``plan``) and
``compose_four`` (``compose``) inside; a pair body's stages, whose
device boundaries a captured program keeps, are ``pair.blend``,
``pair.flow_*`` (the flow's own, in ``crop``, ``novel_view`` and
``pixflow``), ``pair.novel_view`` and ``pair.composite``.  They tile the
body: every operation it launches runs inside one of them.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from panorama_opticalflow_tpu_torch.utils.config import StitchConfig
from panorama_opticalflow_tpu_torch import _as_canvas, to_numpy
from panorama_opticalflow_tpu_torch.ops import image as im
from panorama_opticalflow_tpu_torch.models import crop, novel_view, stitcher
from panorama_opticalflow_tpu_torch.utils import programs, trace


def _stitch_pair_full(image_l: torch.Tensor, image_r: torch.Tensor,
                      cfg: StitchConfig) -> tuple[torch.Tensor, dict]:
    """One full-canvas pass over a pair, or over two (N, H, W, 4) stacks of
    N pairs (every stage takes either): the output and the intermediates
    the reference can dump."""
    with trace.span("pair.blend", stage=True):
        ctx = stitcher.prepare(image_l, image_r, cfg)
    flow_lr, flow_rl = novel_view.prepare_flows(ctx.overlapped_l,
                                                ctx.overlapped_r, cfg)
    with trace.span("pair.novel_view", stage=True):
        merged = novel_view.combine_novel_views(
            ctx.overlapped_l, ctx.overlapped_r, flow_lr, flow_rl, ctx.blend)
    with trace.span("pair.composite", stage=True):
        out = stitcher.gather_composite(ctx.map, image_l, image_r, merged,
                                        cfg)
    return out, {
        "Map": ctx.map,
        "Blend": ctx.blend,
        "OverlappedL": ctx.overlapped_l,
        "OverlappedR": ctx.overlapped_r,
        "mergedmiddle": merged,
        "flowLtoR": flow_lr,
        "flowRtoL": flow_rl,
    }


def _stitch_pair_full_body(image_l: torch.Tensor, image_r: torch.Tensor,
                           cfg: StitchConfig) -> torch.Tensor:
    """The full-canvas program's body: ``_stitch_pair_full``'s output."""
    return _stitch_pair_full(image_l, image_r, cfg)[0]


def stitch_pair(image_l: torch.Tensor, image_r: torch.Tensor,
                cfg: StitchConfig) -> torch.Tensor:
    """Stitch one canvas pair on the full canvas (the body of the
    reference's per-part loop, CPU/main.cpp:60-101); a program keyed by
    the canvases' shape on a card."""
    return programs.run(_stitch_pair_full_body, (image_l, image_r), cfg)


def stitch_pairs(images_l, images_r, cfg: StitchConfig,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """``stitch_pair`` of N pairs at once, on the full canvas: (N, H, W, 4)
    uint8 stacks (arrays or tensors, moved to ``device``) in, the
    (N, H, W, 4) uint8 panoramas out.  The flows of all pairs come from one
    pyramid descent on a leading batch of 2N, and the blend field, the
    combiner and the composite run on the stacks.  On a card one program
    a stack size N."""
    with trace.span("stitch.pairs"):
        return stitch_pair(_as_canvas(images_l, device),
                           _as_canvas(images_r, device), cfg)


def stitch_pair_debug(image_l, image_r, cfg: StitchConfig,
                      device: str | torch.device = "cuda"
                      ) -> tuple[torch.Tensor, dict]:
    """stitch_pair that also returns the intermediates the reference can
    dump (Map, Blend, OverlappedL/R, mergedmiddle, flows -- the commented
    imwrites at CPU/main.cpp:73-76,91 and the visualisers of
    CPU/OpticalFlow.cpp:147-204).  It runs eagerly: the reference's debug
    path is its split programs, whose intermediates a single program
    would not keep."""
    return _stitch_pair_full(_as_canvas(image_l, device),
                             _as_canvas(image_r, device), cfg)


def dump_intermediates(inter: dict, out_dir: str, tag: str,
                       flow_alg: str) -> None:
    """Write the debug intermediates like the reference's (commented)
    dumps, plus the three flow visualisations side by side."""
    from panorama_opticalflow_tpu_torch.utils import visualize
    from panorama_opticalflow_tpu_torch.utils.io import write_image_fast

    os.makedirs(out_dir, exist_ok=True)
    inter = {k: to_numpy(v) for k, v in inter.items()}

    def w8(name, arr):
        write_image_fast(os.path.join(out_dir, f"{tag}_{name}.png"), arr)

    w8("Map", inter["Map"])
    w8("Blend", (inter["Blend"] * 255).astype("uint8"))
    w8("OverlappedL", inter["OverlappedL"])
    w8("OverlappedR", inter["OverlappedR"])
    w8("mergedmiddle", inter["mergedmiddle"])
    for key in ("flowLtoR", "flowRtoL"):
        flow = inter[key]
        grey = visualize.flow_as_grey_disparity(flow)
        wheel = visualize.flow_color_wheel(flow)
        field = visualize.flow_as_vector_field(flow, inter["OverlappedL"])
        vis = visualize.stack_horizontal(
            [np.stack([grey] * 3, -1), wheel, field])
        w8(f"{key}_{flow_alg}", vis)


def _stitch_pair_windowed_body(image_l: torch.Tensor,
                               image_r: torch.Tensor, roll, width: int,
                               gather_safe: bool,
                               cfg: StitchConfig) -> torch.Tensor:
    """One pair on the (roll, width) column window: the flow, blend field
    and combiner run on the window only (flow is zero elsewhere, so the
    merged view is transparent there); the hole search runs on the window
    when ``gather_safe`` (crop.gather_window_safe), else on the full
    canvas.  ``roll`` is an int or a 0-d int64 tensor on the canvases'
    device, as it is traced in the reference."""
    with trace.span("pair.blend", stage=True):
        canvas_map = stitcher.match_images(image_l, image_r)
        ol = stitcher.extract_overlap(image_l, canvas_map)
        orr = stitcher.extract_overlap(image_r, canvas_map)
        blend_w, _ = stitcher.generate_blend(canvas_map, cfg,
                                             window=(roll, width))
    flow_lr_w, flow_rl_w = crop.cropped_flows_window(ol, orr, roll, width,
                                                     cfg)
    with trace.span("pair.novel_view", stage=True):
        merged = novel_view.combine_novel_views(ol, orr, flow_lr_w,
                                                flow_rl_w, blend_w,
                                                (roll, width))
    window = (roll, width) if gather_safe else None
    with trace.span("pair.composite", stage=True):
        return stitcher.gather_composite(canvas_map, image_l, image_r,
                                         merged, cfg, window=window)


def stitch_pair_windowed(image_l: torch.Tensor, image_r: torch.Tensor,
                         roll: int, width: int, gather_safe: bool,
                         cfg: StitchConfig) -> torch.Tensor:
    """``_stitch_pair_windowed_body`` as a program keyed by (width,
    gather_safe, cfg) and the canvases' shape; the roll is an input, as
    the reference's windowed program traces it."""
    roll = torch.full((), roll, dtype=torch.int64, device=image_l.device)
    return programs.run(_stitch_pair_windowed_body,
                        (image_l, image_r, roll), width, gather_safe, cfg)


def stitch_pair_auto(image_l, image_r, cfg: StitchConfig,
                     window: tuple | None = None,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """stitch_pair with overlap-cropped work.  ``window`` is a planned
    (roll, width, gather_safe), e.g. from crop.plan_chain_windows; when
    None it is read from the pair's canvas map on the host, eagerly, before
    the windowed program runs (the reference's geometry program, host
    read, windowed program)."""
    image_l = _as_canvas(image_l, device)
    image_r = _as_canvas(image_r, device)
    if window is None:
        with trace.span("plan"):
            window = crop.pair_window(
                stitcher.match_images(image_l, image_r), cfg)
    roll, width, gsafe = window
    return stitch_pair_windowed(image_l, image_r, roll, width, gsafe, cfg)


def _chain_body(top: torch.Tensor, rolls: torch.Tensor, *args
                ) -> torch.Tensor:
    """The whole 6-input chain in one body: ``args`` is the photos, then
    each pair's (width, gather_safe) and the config; pair i stitches photo
    i against the panorama so far, on its window at ``rolls[i]``."""
    *photos, shapes, cfg = args
    result = top
    for i, (image_l, (width, gsafe)) in enumerate(zip(photos, shapes)):
        result = _stitch_pair_windowed_body(image_l, result, rolls[i],
                                            width, gsafe, cfg)
    return result


def stitch_six(images: list, top, cfg: StitchConfig,
               device: str | torch.device = "cuda", on_part=None,
               use_crop: bool = True) -> torch.Tensor:
    """Iterative 6-input stitch (CPU/main.cpp:60-105): R starts as the top
    image and accumulates the panorama; L is photo i for i = 1..5.  Inputs
    are (H, W, 4) uint8 arrays or tensors, moved to ``device``; returns the
    (H, W, 4) uint8 panorama on ``device``.  ``on_part(i, result)`` is
    called after each pair.

    With ``use_crop`` every pair's window is planned up front from the
    input alphas (one host read) and, without ``on_part``, the whole chain
    is one program keyed by the windows' widths and gather flags, the
    rolls its input: on a card a stitch is one graph replay, as it is one
    dispatch in the reference (``_chain_windowed_jit``).  The reference
    scans one pair body and so needs every pair's window to share its
    width; a captured graph does not, and the port has no such condition.
    With ``use_crop=False`` every pair is the full-canvas program.  With
    ``on_part`` the pairs run eagerly, one by one (the reference's split
    programs), under ``programs.disable()``."""
    with trace.span("stitch.six"):
        photos = [_as_canvas(p, device) for p in images]
        result = _as_canvas(top, device)
        windows = [None] * len(photos)
        if use_crop:
            with trace.span("plan"):
                windows = crop.plan_chain_windows(photos, result, cfg)
        if on_part is None and use_crop:
            # each roll a fill on the card: a copy from host memory would
            # wait for the stream
            rolls = torch.stack([torch.full((), r, dtype=torch.int64,
                                            device=result.device)
                                 for r, _, _ in windows])
            return programs.run(_chain_body, (result, rolls, *photos),
                                tuple((wd, g) for _, wd, g in windows), cfg)
        with (programs.disable() if on_part is not None
              else contextlib.nullcontext()):
            for i, (image_l, window) in enumerate(zip(photos, windows),
                                                  start=1):
                if window is None:
                    result = stitch_pair(image_l, result, cfg)
                else:
                    result = stitch_pair_windowed(image_l, result, *window,
                                                  cfg)
                if on_part is not None:
                    on_part(i, result)
        return result


def precrop_columns(image: torch.Tensor) -> torch.Tensor:
    """4-input column pre-crop (CPU_4Input/main.cpp:65-76): zero every
    column whose middle-row alpha is zero."""
    mid = image[image.shape[0] // 2, :, 3]
    keep = (mid != 0).to(image.dtype)[None, :, None]
    return image * keep


def compose_four(images) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-crop and composite 4 wide-angle photos (a (4, H, W, 4) uint8
    tensor or a list of four) into the two canvases (opposite cameras do
    not overlap): L = 1 + 3, R = 2 + 4 (CPU_4Input/main.cpp:79-80).  It
    stays eager on a card: 22 small launches, no program."""
    i1, i2, i3, i4 = (precrop_columns(images[k]) for k in range(4))
    return im.saturating_add_u8(i1, i3), im.saturating_add_u8(i2, i4)


def stitch_four(images: list, cfg: StitchConfig,
                device: str | torch.device = "cuda",
                use_crop: bool = True) -> torch.Tensor:
    """Single-pass 4-input stitch (CPU_4Input/main.cpp:47-119): four
    (H, W, 4) uint8 arrays or tensors, moved to ``device``; returns the
    (H, W, 4) uint8 panorama on ``device``.  With ``use_crop`` the pair
    runs on the window derived from its own canvas map."""
    with trace.span("stitch.four"):
        with trace.span("compose"):
            image_l, image_r = compose_four([_as_canvas(p, device)
                                             for p in images])
        if use_crop:
            return stitch_pair_auto(image_l, image_r, cfg, device=device)
        return stitch_pair(image_l, image_r, cfg)
