#!/usr/bin/env python3
"""Entry of the port's benchmark (see ``portbench/harness.py``):

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout.  It needs the CUDA cards the cell asks
for and exits non-zero without them.  Every build and kernel cache goes
to fixed directories under the checkout's ``build/``.
"""

import time

_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = os.path.join(ROOT, "build", "portbench", _sub)
# the checkout's root, not this directory, heads the import path
sys.path[0] = ROOT

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], _T0))
