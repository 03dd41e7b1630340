"""Command-line entry points of the port, parity with the reference mains.

  stitch6: 6-input iterative stitch (CPU/main.cpp:47-110) -- reads
    1.tif..5.tif plus a top image from --test_dir, writes
    ProcessResult{1..4}.png and FinalResult.png.
  synth: generate a synthetic 6-input test set.

  python -m panorama_opticalflow_tpu_torch.cli stitch6 --test_dir DIR \
      --top_img top.tif --flow_alg pixflow_low_fast [--device cuda]

File I/O is the port's ``utils.io`` (PIL, or the native PNG/TIFF codec
where it builds).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from panorama_opticalflow_tpu_torch import synthesize_fisheye_set, to_numpy
from panorama_opticalflow_tpu_torch.utils import io as pio
from panorama_opticalflow_tpu_torch.utils.config import StitchConfig


def _require(args, name: str) -> None:
    if not getattr(args, name):
        sys.exit(f"missing required command line argument: --{name}")


def _load(test_dir: str, name: str):
    for ext in ("", ".tif", ".tiff", ".png"):
        path = os.path.join(test_dir, name + ext)
        if os.path.exists(path):
            return pio.read_image_rgba_fast(path)
    raise pio.PanoIOError(
        f"failed to load image: {os.path.join(test_dir, name)}")


def cmd_stitch6(args) -> None:
    import torch

    from panorama_opticalflow_tpu_torch.models import pipeline

    _require(args, "test_dir")
    _require(args, "top_img")
    _require(args, "flow_alg")
    cfg = StitchConfig(flow_alg=args.flow_alg)
    device = torch.device(args.device)
    top = _load(args.test_dir, args.top_img)
    images = [_load(args.test_dir, str(i)) for i in range(1, 6)]
    t0 = time.perf_counter()

    def on_part(i, result):
        name = "FinalResult.png" if i == 5 else f"ProcessResult{i}.png"
        pio.write_image_fast(os.path.join(args.test_dir, name),
                             to_numpy(result))
        print(f"Part{i} finished! RUNTIME (sec) = "
              f"{time.perf_counter() - t0:.3f}", flush=True)

    pipeline.stitch_six(images, top, cfg, device=device, on_part=on_part)
    print(f"TotalRunTime (sec) = {time.perf_counter() - t0:.3f}", flush=True)


def cmd_synth(args) -> None:
    _require(args, "test_dir")
    os.makedirs(args.test_dir, exist_ok=True)
    photos, top = synthesize_fisheye_set(args.height, args.width,
                                         seed=args.seed)
    for i, img in enumerate(photos, start=1):
        pio.write_image_fast(os.path.join(args.test_dir, f"{i}.tif"), img)
    pio.write_image_fast(os.path.join(args.test_dir, "top.tif"), top)
    print(f"wrote synthetic set to {args.test_dir}", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="panostitch-torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp6 = sub.add_parser("stitch6", help="6-input iterative stitch")
    sp6.add_argument("--test_dir", default="",
                     help="path to dir with test files")
    sp6.add_argument("--top_img", default="",
                     help="top image filename (relative to test_dir)")
    sp6.add_argument("--flow_alg", default="",
                     help="pixflow_low or pixflow_low_fast")
    sp6.add_argument("--device", default="cuda",
                     help="torch device to stitch on (default cuda)")
    sp6.set_defaults(fn=cmd_stitch6)

    sps = sub.add_parser("synth", help="generate a synthetic test set")
    sps.add_argument("--test_dir", default="")
    sps.add_argument("--height", type=int, default=400)
    sps.add_argument("--width", type=int, default=900)
    sps.add_argument("--seed", type=int, default=0)
    sps.set_defaults(fn=cmd_synth)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
