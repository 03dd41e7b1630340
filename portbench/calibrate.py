#!/usr/bin/env python3
"""The readings the limits of the check are set from, on the card, at a
cell's own sizes, in one process:

    python3 portbench/calibrate.py --workload CELL --seeds 1,2,3 \\
        [--control-seeds 1,2,3]

For every seed: input set 0 of the pool the cell's run makes from that
seed, stitched by the port's timed entry (after one warm-up call a key,
so a program replays, as in the window), and then, with the programs
released, by the reference; the numbers of ``portbench.compare``
between the two are the program's readings.  For every control seed the
reference computed in bfloat16 (the precision below the configuration's
float32) takes the program's place, and its numbers against the float32
reference are the control's readings.  One JSON line a seed and side.
The benchmark's runs do not run this.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from portbench import compare, harness  # noqa: E402


def readings(cell, seeds, control_seeds, device, sync=lambda: None):
    """Yield one dict a seed and side: the numbers, and the seconds of
    the stitch that produced them."""
    import gc
    import importlib

    from panorama_opticalflow_tpu_torch import StitchConfig
    from panorama_opticalflow_tpu_torch.utils import programs

    from portbench.reference.config import StitchConfig as ReferenceConfig

    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")
    traffic = dict(cell.traffic, pool=1)
    cfg = StitchConfig(flow_alg=cell.config["flow_alg"])
    ref32 = ReferenceConfig(flow_alg=cell.config["flow_alg"])
    ref16 = ReferenceConfig(flow_alg=cell.config["flow_alg"],
                            dtype=torch.bfloat16)
    # the program's outputs first; the references run once its programs
    # are released, as in a run
    outputs = {}
    for k, seed in enumerate(seeds):
        item = driver.make_pool(cell.config, traffic, seed, device)[0]
        if k == 0:
            driver.stitch(item, cfg, device)
        t = time.perf_counter()
        out = driver.stitch(item, cfg, device)
        sync()
        outputs[seed] = (out, time.perf_counter() - t)
        del item, out
    programs.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for seed in sorted(set(seeds) | set(control_seeds)):
        item = driver.make_pool(cell.config, traffic, seed, device)[0]
        t = time.perf_counter()
        ref = driver.reference(item, ref32)
        sync()
        ref_s = time.perf_counter() - t
        if seed in outputs:
            out, stitch_s = outputs.pop(seed)
            yield {"seed": seed, "side": "program", "stitch_s": stitch_s,
                   "reference_s": ref_s, **compare.numbers(out, ref)}
            del out
        if seed in control_seeds:
            t = time.perf_counter()
            low = driver.reference(item, ref16)
            sync()
            yield {"seed": seed, "side": "control",
                   "stitch_s": time.perf_counter() - t, "reference_s": ref_s,
                   **compare.numbers(low, ref)}
            del low
        del ref, item


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    for r in readings(cell, seeds, control, torch.device("cuda", 0),
                      torch.cuda.synchronize):
        print(json.dumps({"workload": cell.name, **r}), flush=True)
    print(json.dumps({"workload": cell.name,
                      "process_s": time.perf_counter() - _T0,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
