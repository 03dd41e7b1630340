"""The port runs without JAX and without the JAX package: a small stitch
and the CLI in a fresh interpreter load neither, and no source file of the
port names either.  Its own copies of the JAX package's configuration,
synthetic data, SSIM and image file I/O stay equal to the originals.
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
from panorama_opticalflow_tpu.utils import native_io as jnio
from panorama_opticalflow_tpu_torch.utils import config as tcfg
from panorama_opticalflow_tpu_torch.utils import data as tdata
from panorama_opticalflow_tpu_torch.utils import io as tio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import os
import sys
import tempfile
import torch
torch.set_num_threads(2)
import panorama_opticalflow_tpu_torch as port
from panorama_opticalflow_tpu_torch import cli
from panorama_opticalflow_tpu_torch.models import pipeline
from panorama_opticalflow_tpu_torch.utils import io as pio
photos, top = port.synthesize_fisheye_set(48, 160, n=5, seed=1)
out = pipeline.stitch_six(photos, top, port.StitchConfig(
    flow_alg="pixflow_low_fast"), device="cpu")
assert out.shape == (48, 160, 4)
with tempfile.TemporaryDirectory() as d:
    cli.main(["synth", "--test_dir", d, "--height", "48", "--width", "160",
              "--seed", "1"])
    cli.main(["stitch6", "--test_dir", d, "--top_img", "top.tif",
              "--flow_alg", "pixflow_low_fast", "--device", "cpu"])
    final = pio.read_image_rgba_fast(os.path.join(d, "FinalResult.png"))
assert (final == port.to_numpy(out)).all()
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


def test_port_sources_name_no_jax():
    """No module of the port imports JAX or anything of the JAX package,
    not even one it would only load on some path."""
    pkg = os.path.join(ROOT, "panorama_opticalflow_tpu_torch")
    paths = [os.path.join(d, f) for d, _, files in os.walk(pkg)
             for f in files if f.endswith(".py")]
    assert len(paths) > 15
    for path in paths:
        with open(path) as f:
            src = f.read()
        assert "panorama_opticalflow_tpu." not in src, path
        assert "import jax" not in src and "from jax" not in src, path


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
    for args in ((40, 96, 1), (33, 130, 6)):
        for g, r in zip(tdata.synthesize_four_input_set(*args),
                        jio.synthesize_four_input_set(*args), strict=True):
            np.testing.assert_array_equal(g, r)
    fa = rng.standard_normal((20, 30, 2)).astype(np.float32)
    fb = fa + rng.standard_normal((20, 30, 2)).astype(np.float32) * 0.1
    assert tdata.endpoint_error(fa, fb) == jmetrics.endpoint_error(fa, fb) > 0
    a = rng.integers(0, 256, (30, 40, 3)).astype(np.float64)
    b = np.clip(a + rng.normal(0, 9, a.shape), 0, 255)
    assert tdata.ssim(a, b) == jmetrics.ssim(a, b)
    assert tdata.ssim(a[..., 0], b[..., 0]) == jmetrics.ssim(a[..., 0],
                                                             b[..., 0])


@pytest.mark.parametrize("ext", ["png", "tif"])
def test_io_copy_round_trips_like_jax(rng, tmp_path, ext):
    """A file written by the port reads back, through the port's readers
    and the JAX package's, as the array that was written; so does a file
    written by the JAX package.  RGB input gets an opaque alpha."""
    img = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    ours, theirs = str(tmp_path / f"a.{ext}"), str(tmp_path / f"b.{ext}")
    tio.write_image_fast(ours, img)
    jnio.write_image_fast(theirs, img)
    for path in (ours, theirs):
        for read in (tio.read_image_rgba_fast, tio.read_image_rgba,
                     jnio.read_image_rgba_fast, jio.read_image_rgba):
            np.testing.assert_array_equal(read(path), img)
    rgb = str(tmp_path / f"rgb.{ext}")
    tio.write_image(rgb, img[..., :3])
    got = tio.read_image_rgba_fast(rgb)
    np.testing.assert_array_equal(got, jnio.read_image_rgba_fast(rgb))
    np.testing.assert_array_equal(got[..., :3], img[..., :3])
    assert (got[..., 3] == 255).all()
    with pytest.raises(tio.PanoIOError):
        tio.read_image_rgba_fast(str(tmp_path / f"missing.{ext}"))
