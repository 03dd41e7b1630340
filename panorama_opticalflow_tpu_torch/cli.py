"""Command-line entry points of the port, parity with the reference mains.

  stitch6: 6-input iterative stitch (CPU/main.cpp:47-110) -- reads
    1.tif..5.tif plus a top image from --test_dir, writes
    ProcessResult{1..4}.png and FinalResult.png; --resume picks up from
    the newest ProcessResult{i}.png.
  stitch4: 4-input single-pass stitch (CPU_4Input/main.cpp:47-119) --
    reads 1.tif..4.tif, writes FinalResult.png.
  synth: generate a synthetic 6-input test set, or with --four the
    4-input wide-angle set.

  python -m panorama_opticalflow_tpu_torch.cli stitch6 --test_dir DIR \
      --top_img top.tif --flow_alg pixflow_low_fast [--device cuda] \
      [--resume] [--debug_dump DIR] [--profile_dir DIR]

Both stitches run on --device (default cuda).  --debug_dump writes every
pair's intermediates and flow visualisations (the pair then runs on the
full canvas); --profile_dir writes one torch.profiler Chrome trace a
stage.  File I/O is the port's ``utils.io`` (PIL, or the native PNG/TIFF
codec where it builds).
"""

from __future__ import annotations

import argparse
import os
import sys

from panorama_opticalflow_tpu_torch import (
    synthesize_fisheye_set, synthesize_four_input_set, to_numpy, to_torch)
from panorama_opticalflow_tpu_torch.utils import io as pio
from panorama_opticalflow_tpu_torch.utils.config import StitchConfig
from panorama_opticalflow_tpu_torch.utils.runtime import (
    StageTimer, init_runtime, log)


def _require(args, name: str) -> None:
    if not getattr(args, name):
        sys.exit(f"missing required command line argument: --{name}")


def _find(test_dir: str, name: str) -> str:
    for ext in ("", ".tif", ".tiff", ".png"):
        path = os.path.join(test_dir, name + ext)
        if os.path.exists(path):
            return path
    raise pio.PanoIOError(
        f"failed to load image: {os.path.join(test_dir, name)}")


def _load_to(device, paths: list[str]) -> list:
    """The images of ``paths`` on ``device``: each is uploaded while the
    loader's thread decodes the next."""
    return [to_torch(img, device) for _, img in pio.PrefetchLoader(paths)]


def cmd_stitch6(args) -> None:
    import torch

    from panorama_opticalflow_tpu_torch.models import crop, pipeline
    from panorama_opticalflow_tpu_torch.utils import programs

    _require(args, "test_dir")
    _require(args, "top_img")
    _require(args, "flow_alg")
    cfg = StitchConfig(flow_alg=args.flow_alg)
    device = torch.device(args.device)
    timer = StageTimer(device)

    # --resume: the reference's de-facto checkpointing is the per-part
    # ProcessResult{i}.png (R is just the previous output,
    # CPU/main.cpp:64-65,97-100) -- pick up from the newest one.
    start = 1
    first = _find(args.test_dir, args.top_img)
    if args.resume:
        for i in range(4, 0, -1):
            path = os.path.join(args.test_dir, f"ProcessResult{i}.png")
            if os.path.exists(path):
                first, start = path, i + 1
                log.info("resuming from %s (parts 1..%d done)", path, i)
                break

    result, *images = _load_to(device, [first] + [
        _find(args.test_dir, str(i)) for i in range(start, 6)])
    # plan every pair's overlap window up front (one host sync for all)
    windows = crop.plan_chain_windows(images, result, cfg)

    for i, (image_l, window) in enumerate(zip(images, windows), start=start):
        # eager (programs.disable): a process stitches one chain, whose
        # pairs share two or three window keys; a capture and its
        # instantiation cost more than the replays they would buy here
        with timer.stage(f"Part{i}"), programs.disable():
            if args.debug_dump:
                result, inter = pipeline.stitch_pair_debug(
                    image_l, result, cfg, device=device)
                pipeline.dump_intermediates(inter, args.debug_dump,
                                            f"part{i}", args.flow_alg)
            else:
                result = pipeline.stitch_pair_auto(image_l, result, cfg,
                                                   window=window,
                                                   device=device)
        name = "FinalResult.png" if i == 5 else f"ProcessResult{i}.png"
        pio.write_image_fast(os.path.join(args.test_dir, name),
                             to_numpy(result))
    timer.total()


def cmd_stitch4(args) -> None:
    import torch

    from panorama_opticalflow_tpu_torch.models import pipeline

    _require(args, "test_dir")
    _require(args, "flow_alg")
    cfg = StitchConfig(flow_alg=args.flow_alg)
    device = torch.device(args.device)
    timer = StageTimer(device)

    images = _load_to(device, [_find(args.test_dir, str(i))
                               for i in range(1, 5)])
    with timer.stage("Stitch"):
        if args.debug_dump:
            image_l, image_r = pipeline.compose_four(images)
            result, inter = pipeline.stitch_pair_debug(image_l, image_r, cfg,
                                                       device=device)
            pipeline.dump_intermediates(inter, args.debug_dump, "stitch",
                                        args.flow_alg)
        else:
            result = pipeline.stitch_four(images, cfg, device=device)
    pio.write_image_fast(os.path.join(args.test_dir, "FinalResult.png"),
                         to_numpy(result))
    timer.total()


def cmd_synth(args) -> None:
    _require(args, "test_dir")
    os.makedirs(args.test_dir, exist_ok=True)
    if args.four:
        photos = synthesize_four_input_set(args.height, args.width,
                                           seed=args.seed)
    else:
        photos, top = synthesize_fisheye_set(args.height, args.width,
                                             seed=args.seed)
        pio.write_image_fast(os.path.join(args.test_dir, "top.tif"), top)
    for i, img in enumerate(photos, start=1):
        pio.write_image_fast(os.path.join(args.test_dir, f"{i}.tif"), img)
    log.info("wrote synthetic set to %s", args.test_dir)


def main(argv=None) -> None:
    init_runtime()
    p = argparse.ArgumentParser(prog="panostitch-torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--test_dir", default="",
                        help="path to dir with test files")
        sp.add_argument("--flow_alg", default="",
                        help="pixflow_low, pixflow_search_20 or a _fast one")
        sp.add_argument("--device", default="cuda",
                        help="torch device to stitch on (default cuda)")
        sp.add_argument("--debug_dump", default="",
                        help="directory for intermediate/flow-vis dumps")
        sp.add_argument("--profile_dir", default="",
                        help="write a torch.profiler Chrome trace per "
                             "stage into this dir")

    sp6 = sub.add_parser("stitch6", help="6-input iterative stitch")
    common(sp6)
    sp6.add_argument("--top_img", default="",
                     help="top image filename (relative to test_dir)")
    sp6.add_argument("--resume", action="store_true",
                     help="resume from the newest ProcessResult{i}.png")
    sp6.set_defaults(fn=cmd_stitch6)

    sp4 = sub.add_parser("stitch4", help="4-input single-pass stitch")
    common(sp4)
    sp4.set_defaults(fn=cmd_stitch4)

    sps = sub.add_parser("synth", help="generate a synthetic test set")
    sps.add_argument("--test_dir", default="")
    sps.add_argument("--height", type=int, default=400)
    sps.add_argument("--width", type=int, default=900)
    sps.add_argument("--seed", type=int, default=0)
    sps.add_argument("--four", action="store_true",
                     help="generate the 4-input wide-angle set")
    sps.set_defaults(fn=cmd_synth)

    args = p.parse_args(argv)
    if getattr(args, "profile_dir", ""):
        # StageTimer wraps each stage in torch.profiler when set
        os.environ["PANOSTITCH_TRACE_DIR"] = args.profile_dir
    args.fn(args)


if __name__ == "__main__":
    main()
