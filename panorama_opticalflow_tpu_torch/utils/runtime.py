"""Runtime initialisation and stage timing of the command-line entry points.

Counterpart of the reference's initOpticalFlow (CPU/util.cpp:48-120): glog
becomes Python logging, the terminate handler and signal handlers with
stack dumps become ``faulthandler`` on the same fatal signals, the wall
timers ``perf_counter``.  ``StageTimer`` ends a stage on a card with
``torch.cuda.synchronize()``, so a stage's time is its work's, and writes
one ``torch.profiler`` Chrome trace a stage when PANOSTITCH_TRACE_DIR is
set (the CLI's ``--profile_dir``).
"""

from __future__ import annotations

import contextlib
import faulthandler
import logging
import os
import signal
import sys
import time

log = logging.getLogger("panostitch")


def init_runtime(verbose: bool = True) -> None:
    """Install logging (to standard output, where the reference prints
    its run times) and fatal-signal stack dumps, and settle the CPU maths
    library.  Safe to call more than once."""
    logging.basicConfig(
        stream=sys.stdout,
        level=logging.INFO if verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    faulthandler.enable()
    # the reference registers SIGABRT/SIGBUS/SIGFPE/SIGILL/SIGINT/SIGQUIT/
    # SIGSEGV/SIGTERM... (CPU/util.cpp:103-119); faulthandler covers the
    # fatal ones, register the rest for a stack dump without exiting.
    for sig in (signal.SIGTERM, signal.SIGQUIT):
        with contextlib.suppress(OSError, ValueError, RuntimeError):
            faulthandler.register(sig, chain=True)
    settle_cpu_math()


def settle_cpu_math() -> None:
    """Take the first multi-threaded sqrt, exp and tanh of the process
    here.  In a fresh process under load PyTorch's CPU vector maths has
    been seen to return that first call at low accuracy on the thread
    pool's worker threads (sqrt off by up to 3831 ulp on half of the
    elements, one process in about a hundred; every later call is right),
    which flips strict-< takes of the flow solver.  With the first call
    taken here, a stitch on the CPU gives the same bits from run to run.
    Nothing on a card goes through that library."""
    import torch

    x = torch.full((1 << 14,), 2.0)
    torch.sqrt(x)
    torch.exp(x)
    torch.tanh(x)


class StageTimer:
    """Per-part and total wall timing (CPU/main.cpp:62,103-108) of work on
    ``device``, plus a profiler trace a stage when PANOSTITCH_TRACE_DIR is
    set: ``<dir>/<stage>.trace.json``, CPU activities and, on a card, CUDA
    ones."""

    def __init__(self, device="cpu"):
        import torch

        self.device = torch.device(device)
        self.t0 = time.perf_counter()
        self.stages: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        import torch

        on_card = self.device.type == "cuda"
        trace_dir = os.environ.get("PANOSTITCH_TRACE_DIR")
        prof = None
        if trace_dir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if on_card:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
        t = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext():
            yield
            if on_card:
                torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t
        if prof is not None:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(trace_dir, f"{name}.trace.json"))
        self.stages.append((name, dt))
        log.info("%s finished! RUNTIME (sec) = %.3f", name, dt)

    def total(self) -> float:
        dt = time.perf_counter() - self.t0
        log.info("TotalRunTime (sec) = %.3f", dt)
        return dt
