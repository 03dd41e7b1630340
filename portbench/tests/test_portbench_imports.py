"""What a run loads: no JAX and no JAX package, compared by whole
top-level names (the port's name begins with the JAX package's); and a
reference that loads nothing of the port."""

import json
import os
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT


def _python(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "panorama_opticalflow_tpu_torch_x",
                        sys)
    assert "panorama_opticalflow_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_a_run_loads_no_jax_and_no_jax_package():
    """A whole run of a cell on the CPU at a small size, in a fresh
    interpreter: every module the harness, the drivers, the readers, the
    port and the reference load."""
    out = _python(
        "import json, sys, time, torch\n"
        "from portbench import harness\n"
        "cell = harness.load_cell('four_low.repeat')\n"
        "cell.config['canvas'] = [64, 256]\n"
        "res, _ = harness.run_cell(cell, 3, 0.1, True, torch.device('cpu'),"
        " time.perf_counter())\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'correct': res['correct'], 'tops': tops}))\n")
    got = json.loads(out.strip().splitlines()[-1])
    assert got["correct"]
    assert "panorama_opticalflow_tpu_torch" in got["tops"]
    for name in harness.FORBIDDEN:
        assert name not in got["tops"]


def test_the_reference_loads_nothing_of_the_port():
    out = _python(
        "import sys\n"
        "import portbench.reference.pipeline, portbench.reference.stitch\n"
        "import json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = json.loads(out.strip().splitlines()[-1])
    for name in ("panorama_opticalflow_tpu_torch",) + harness.FORBIDDEN:
        assert name not in tops
