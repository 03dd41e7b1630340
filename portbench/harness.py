"""The benchmark of the PyTorch and CUDA port, driven by data.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

A cell is an entry of ``workloads`` in ``BENCHMARK.json``; the harness
finds what belongs to it by the names the entry gives: its configuration's
``file`` (the deployment: canvas, rig, preset, the planes of the kernel
rooflines, the limits of the check), ``traffic/<traffic>.json`` (the
driver and the calls the caller makes), ``drivers/<driver>.py`` (the
entry it calls) and ``metrics/<metric>.py`` (one reader a metric).  A new
cell, configuration, traffic mix or metric is new files and entries; no
file here changes.

A run: the input pool from the seed on the card; set-up, which calls the
entry twice (a key's first, eager call and its second, the capture) so
that the window times replays; the window, a closed loop of
``--seconds``; with ``--trace 1`` a profiled segment of a fixed number of
calls after it; then, with the program's state released, the check of
outputs of the window against ``portbench.reference``.  The last line of
standard output is the result; the last lines of standard error are the
numbers compared, each beside its limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time

import numpy as np

from portbench import compare, devtrace, window

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "panorama_opticalflow_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    root: str
    chips: int
    traffic: dict
    config: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    window: window.Window
    setup_s: float
    trace: devtrace.Trace | None
    traffic: dict
    config: dict
    seed: int
    device: object
    # seconds of each part of set-up, by name (see run_cell)
    setup_parts: dict = dataclasses.field(default_factory=dict)


def _load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files and
    the metrics it reports: an end-to-end metric without a ``workloads``
    key is every cell's; a per-layer one without it is every cell's that
    reports the metric it moves."""
    bench = _load_json(root, "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    (config_file,) = [c["file"] for c in bench["configs"]
                      if c["name"] == entry["config"]]
    config = _load_json(root, config_file)
    traffic = _load_json(root, "portbench", "traffic",
                         f"{entry['traffic']}.json")

    def ours(m, default):
        return name in m["workloads"] if "workloads" in m else default(m)

    e2e = [m for m in bench["end_to_end"] if ours(m, lambda m: True)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if ours(m, lambda m: m["moves"] in names)]
    return Cell(name, root, entry["chips"], traffic, config, e2e, layer)


def load_reader(metric: str, root: str = ROOT):
    """``read`` of ``portbench/metrics/<metric>.py`` under ``root``."""
    path = os.path.join(root, "portbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    """The forbidden top-level names among the loaded modules, compared
    whole (the port's name begins with the JAX package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _note(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float) -> tuple[dict, dict]:
    """One run of ``cell`` on ``device``; returns the result line's
    object and the numbers compared with their limits.  ``t0`` is the
    process's start on ``time.perf_counter``."""
    import torch

    from panorama_opticalflow_tpu_torch import StitchConfig
    from panorama_opticalflow_tpu_torch.utils import programs

    from portbench.reference.config import StitchConfig as ReferenceConfig

    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")
    traffic = cell.traffic
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    cfg = StitchConfig(flow_alg=cell.config["flow_alg"])
    marks = [("imports", time.perf_counter() - t0)]
    pool = driver.make_pool(cell.config, traffic, seed, device)
    sync()
    marks.append(("card start and inputs", time.perf_counter() - t0))

    def call(k):
        return driver.stitch(pool[k % len(pool)], cfg, device)

    if on_card:
        # built once a checkout (named after a hash of the sources); a
        # part of set-up, shown apart in the note below
        from panorama_opticalflow_tpu_torch.ops import build

        build.load()
        marks.append(("kernel library", time.perf_counter() - t0))
    # every shape the window uses: a key's first (eager) call, then its
    # second (capture)
    for k, mark in enumerate(("first call", "capture")):
        call(k)
        sync()
        marks.append((mark, time.perf_counter() - t0))
    setup_s = marks[-1][1]
    ends = [t for _, t in marks]
    parts = {name: t - t_prev for (name, t), t_prev in zip(marks,
                                                           [0.0] + ends)}
    _note("set-up: " + ", ".join(f"{name} {v:.3f} s"
                                 for name, v in parts.items()))

    outputs, unequal = {}, set()

    def keep(k, out):
        i = k % len(pool)
        if i not in outputs:
            outputs[i] = out
        elif not torch.equal(out, outputs[i]):
            unequal.add(i)
        return driver.panoramas(pool[i])

    win = window.run(call, keep, seconds, sync)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    traced = None
    if trace:
        n = traffic["traced_calls"]
        done = sum(driver.panoramas(pool[(win.calls + j) % len(pool)])
                   for j in range(n))
        traced = devtrace.profile_calls(lambda j: call(win.calls + j), n,
                                        done, device, sync)
    run = Run(win, setup_s, traced, cell.traffic, cell.config, seed, device,
              parts)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"], cell.root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the reference runs with the program's state released
    programs.clear()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rng = np.random.default_rng([seed & ((1 << 64) - 1), 1])
    called = sorted(outputs)
    checked = sorted(int(i) for i in rng.choice(
        called, size=min(traffic["checked"], len(called)), replace=False))
    limits = cell.config["check"]
    ref_cfg = ReferenceConfig(flow_alg=cell.config["flow_alg"])
    readings, wrong = [], set(unequal)
    for i in checked:
        reading = compare.numbers(outputs[i], driver.reference(pool[i],
                                                               ref_cfg))
        _note(f"input set {i}: {reading}")
        readings.append(reading)
        if not compare.within(reading, limits):
            wrong.add(i)
    values = compare.worst_of(readings)
    failed = sum(driver.panoramas(pool[k % len(pool)])
                 for k in range(win.calls) if k % len(pool) in wrong)
    if unequal:
        _note(f"input sets whose outputs in the window differ: "
              f"{sorted(unequal)}")

    dev = {"platform": "gpu" if on_card else device.type,
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else device.type),
           "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": not wrong and compare.within(values, limits),
              "attempted": win.panoramas, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        _note(f"traced: device busy {traced.busy_s:.6f} s of "
              f"{traced.window_s:.6f} s, of which idle in the profiler's "
              f"own host work {traced.profiler_idle_s:.6f} s")
        result["breakdown"] = {"device_ops": traced.top_ops,
                               "idle_gaps": traced.idle_gaps}
    compared = {k: {"value": values[k], "limit": lim}
                for k, lim in limits.items()}
    result["compared"] = compared
    lat = sorted(win.latencies)
    _note(f"window: {win.calls} calls, {win.panoramas} panoramas in "
          f"{win.seconds:.3f} s; call seconds min {lat[0]:.4f} median "
          f"{lat[len(lat) // 2]:.4f} max {lat[-1]:.4f}; set-up "
          f"{setup_s:.3f} s; checked input sets {checked}")
    return result, compared


def main(argv: list[str], t0: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _note(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.device_count()}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, compared = run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0), t0)
    found = forbidden_modules()
    if found:
        _note(f"modules loaded that the benchmark may not load: {found}")
        return 3
    for name, c in compared.items():
        _note(f"compared {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
