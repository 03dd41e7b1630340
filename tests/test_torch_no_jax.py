"""The port runs without JAX and without the JAX package: a small stitch in
a fresh interpreter loads neither.  Its own copies of the JAX package's
configuration, synthetic data and SSIM stay equal to the originals.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from panorama_opticalflow_tpu.utils import config as jcfg
from panorama_opticalflow_tpu.utils import io as jio
from panorama_opticalflow_tpu.utils import metrics as jmetrics
from panorama_opticalflow_tpu_torch.utils import config as tcfg
from panorama_opticalflow_tpu_torch.utils import data as tdata

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import torch
torch.set_num_threads(2)
import panorama_opticalflow_tpu_torch as port
from panorama_opticalflow_tpu_torch.models import pipeline
photos, top = port.synthesize_fisheye_set(48, 160, n=5, seed=1)
out = pipeline.stitch_six(photos, top, port.StitchConfig(
    flow_alg="pixflow_low_fast"), device="cpu")
assert out.shape == (48, 160, 4)
print(sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "panorama_opticalflow_tpu"
             or m.startswith("panorama_opticalflow_tpu.")))
"""


def test_port_stitch_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_chip_smoke_imports_no_jax():
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "jax" not in src
    assert "panorama_opticalflow_tpu." not in src
    assert "panorama_opticalflow_tpu " not in src


@pytest.mark.parametrize("name", [
    "pixflow_low", "pixflow_low_fast", "pixflow_search_20",
    "pixflow_search_20_fast", "pixflow_low_fast+stop48",
    "pixflow_low_fast+cph2"])
def test_config_copy_matches_jax(name):
    """Every field of the port's FlowParams has the JAX package's value in
    every preset; the JAX-only fields are compile-time knobs of XLA and
    Mosaic."""
    port = dataclasses.asdict(tcfg.flow_params_by_name(name))
    ref = dataclasses.asdict(jcfg.flow_params_by_name(name))
    assert port == {k: ref[k] for k in port}
    assert tcfg.flow_params_by_name(name).search_distance == \
        jcfg.flow_params_by_name(name).search_distance
    assert set(ref) - set(port) == {
        "median_blur_size", "pallas_bucket", "scan_coarse_levels",
        "scan_max_pixels", "scan_rung_levels", "scan_min_levels",
        "scan_fine_rung_levels", "pallas_tile"}
    cfg, jc = tcfg.StitchConfig(flow_alg=name), jcfg.StitchConfig(
        flow_alg=name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jc)
    assert cfg.blend_scale_resolved == jc.blend_scale_resolved


def test_with_flow_params_sets_a_schedule_knob():
    """A knob replaces fields of the preset's FlowParams and nothing else,
    as tools/fidelity_36mp.py patches flow_params_by_name."""
    base = tcfg.StitchConfig(flow_alg="pixflow_low")
    cfg = tcfg.with_flow_params(base, relax_phases=2,
                                relax_iters_per_phase=2)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(base)
    assert cfg.flow_params == dataclasses.replace(
        base.flow_params, relax_phases=2, relax_iters_per_phase=2)
    assert base.flow_params == tcfg.flow_params_by_name("pixflow_low")


def test_data_copies_match_jax(rng):
    for args in ((40, 130, 5, 0.35, 0, True), (33, 64, 4, 0.3, 5, False)):
        got, got_top = tdata.synthesize_fisheye_set(*args)
        ref, ref_top = jio.synthesize_fisheye_set(*args)
        for g, r in zip(got + [got_top], ref + [ref_top]):
            np.testing.assert_array_equal(g, r)
    a = rng.integers(0, 256, (30, 40, 3)).astype(np.float64)
    b = np.clip(a + rng.normal(0, 9, a.shape), 0, 255)
    assert tdata.ssim(a, b) == jmetrics.ssim(a, b)
    assert tdata.ssim(a[..., 0], b[..., 0]) == jmetrics.ssim(a[..., 0],
                                                             b[..., 0])
