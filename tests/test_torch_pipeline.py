"""The port's 6-photo stitch on the CPU against the JAX package, the pinned
goldens and the reference binary's output, plus the port's CLI.

Gates are those of tests/test_golden.py::_check (alpha footprint exact,
SSIM >= 0.995, < 1 % of values off by more than 8): the JAX package runs
its rung-scanned pyramid and XLA's rounding, whose ulp-level differences
flip strict-< propagation takes at isolated pixels, so bit-equality is not
the contract.  At 96 x 320 every pair window is the whole canvas (the
full wrap-extended flow path); at 64 x 1280 every pair runs on a 768-wide
cropped window.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from panorama_opticalflow_tpu.models import pipeline as jpl
from panorama_opticalflow_tpu.utils import config as jcfg
from panorama_opticalflow_tpu.utils import io as pio
from panorama_opticalflow_tpu_torch import StitchConfig, ssim
from panorama_opticalflow_tpu_torch import synthesize_fisheye_set, to_numpy
from panorama_opticalflow_tpu_torch.models import crop, pipeline

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")


def _check(out, golden):
    assert out.shape == golden.shape
    np.testing.assert_array_equal(out[..., 3], golden[..., 3])
    s = ssim(out, golden)
    assert s >= 0.995, s
    diff = np.abs(out.astype(np.int32) - golden.astype(np.int32))
    assert (diff > 8).mean() < 0.01, (diff > 8).mean()


def _port_six(photos, top, alg):
    return to_numpy(pipeline.stitch_six(photos, top,
                                        StitchConfig(flow_alg=alg),
                                        device="cpu"))


@pytest.mark.parametrize("h,w,seed,alg", [
    (96, 320, 7, "pixflow_low"),
    (96, 320, 7, "pixflow_low_fast"),
    (64, 1280, 0, "pixflow_low_fast"),
    (96, 320, 7, "pixflow_search_20"),
])
def test_stitch_six_matches_jax(h, w, seed, alg):
    photos, top = synthesize_fisheye_set(h, w, n=5, seed=seed)
    widths = {wd for _, wd, _ in crop.plan_chain_windows(
        [torch.from_numpy(p) for p in photos], torch.from_numpy(top),
        StitchConfig(flow_alg=alg))}
    assert widths == ({w} if w == 320 else {768})
    ref = np.asarray(jpl.stitch_six([jnp.asarray(p) for p in photos],
                                    jnp.asarray(top),
                                    jcfg.StitchConfig(flow_alg=alg)))
    _check(_port_six(photos, top, alg), ref)


def test_stitch_pair_auto_matches_jax():
    """One pair with its window derived from the pair's own canvas map
    (a 768-wide crop of the 1280-wide canvas)."""
    photos, top = synthesize_fisheye_set(64, 1280, n=5, seed=4)
    ref = np.asarray(jpl.stitch_pair_auto(
        jnp.asarray(photos[2]), jnp.asarray(top),
        jcfg.StitchConfig(flow_alg="pixflow_low_fast")))
    got = to_numpy(pipeline.stitch_pair_auto(
        photos[2], top, StitchConfig(flow_alg="pixflow_low_fast"),
        device="cpu"))
    _check(got, ref)


def test_uncropped_chain_matches_cropped_at_full_width():
    """At 96 x 320 every planned window is the whole canvas, so the
    windowed pair and the full-canvas stitch_pair compute the same."""
    photos, top = synthesize_fisheye_set(96, 320, n=5, seed=7)
    cfg = StitchConfig(flow_alg="pixflow_low_fast")
    np.testing.assert_array_equal(
        to_numpy(pipeline.stitch_six(photos, top, cfg, device="cpu",
                                     use_crop=False)),
        _port_six(photos, top, "pixflow_low_fast"))


def test_stitch_six_matches_pinned_golden():
    photos, top = synthesize_fisheye_set(96, 320, n=5, seed=7)
    golden = np.load(os.path.join(GOLDEN_DIR, "six_96x320_s7.npz"))["output"]
    _check(_port_six(photos, top, "pixflow_low"), golden)


def test_stitch_six_search20_matches_pinned_golden():
    """The JAX package's search-init golden (test_golden.py's
    six_64x256_s3_search20 case)."""
    photos, top = synthesize_fisheye_set(64, 256, n=5, seed=3)
    golden = np.load(os.path.join(
        GOLDEN_DIR, "six_64x256_s3_search20.npz"))["output"]
    _check(_port_six(photos, top, "pixflow_search_20"), golden)


@pytest.mark.parametrize("alg", ["pixflow_low", "pixflow_low_fast"])
def test_stitch_six_vs_reference_binary(alg):
    """The reference binary's own 900 x 400 output (pixflow_low) at the
    JAX package's gate, SSIM >= 0.98 on RGB; each pair on a cropped
    window (measured when written: 0.9988 for both presets)."""
    golden = pio.read_image_rgba(
        os.path.join(GOLDEN_DIR, "reference_binary_900x400_low.png"))
    photos, top = synthesize_fisheye_set(400, 900, n=5, seed=0)
    out = _port_six(photos, top, alg)
    s = ssim(out[..., :3].astype(np.float32),
             golden[..., :3].astype(np.float32))
    assert s >= 0.98, s


def test_cli_synth_then_stitch6(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    d = str(tmp_path)

    def cli(*args):
        proc = subprocess.run(
            [sys.executable, "-m", "panorama_opticalflow_tpu_torch.cli",
             *args], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return proc.stdout

    cli("synth", "--test_dir", d, "--height", "64", "--width", "256",
        "--seed", "2")
    out = cli("stitch6", "--test_dir", d, "--top_img", "top.tif",
              "--flow_alg", "pixflow_low_fast", "--device", "cpu")
    assert "TotalRunTime" in out
    names = sorted(os.listdir(d))
    assert [f"ProcessResult{i}.png" for i in range(1, 5)] == \
        [n for n in names if n.startswith("ProcessResult")]
    photos, top = synthesize_fisheye_set(64, 256, seed=2)
    result = pio.read_image_rgba(os.path.join(d, "FinalResult.png"))
    np.testing.assert_array_equal(result, _port_six(photos, top,
                                                    "pixflow_low_fast"))
