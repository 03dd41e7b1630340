"""The benchmark's own tests.  They import no JAX, so they run on the
machine with the card as well:

    python -m pytest portbench/tests -q

On the CPU the tests marked by the ``card`` fixture skip; there they
run at the cells' own sizes."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the machine with the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="session")
def settled_cpu_math():
    """Reproducible CPU stitches: the first multi-threaded sqrt of a
    process is taken before any test runs."""
    from panorama_opticalflow_tpu_torch.utils.runtime import settle_cpu_math

    settle_cpu_math()
