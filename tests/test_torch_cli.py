"""The rest of the port's command line on the CPU: stitch4 and synth
--four, stitch6 --resume, --debug_dump, --profile_dir, each in a fresh
interpreter; and what they ride on: stitch_pair_debug's intermediates and
the flow visualisers against the JAX package's, the stage timer and the
prefetching loader.

Tolerances of the intermediates: map and overlap images bit-exact; the
blend field <= 1e-4 (its box blurs are running sums in another order
than XLA's, as in tests/test_torch_ops.py); the flows by mean endpoint
error <= 0.05 px (the exact coarsest level is chaotic at the ulp level,
as in tests/test_torch_pixflow.py); the merged view and the output at the
golden gate.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from panorama_opticalflow_tpu.models import pipeline as jpl
from panorama_opticalflow_tpu.utils import config as jcfg
from panorama_opticalflow_tpu.utils import visualize as jvis
from panorama_opticalflow_tpu_torch import (StitchConfig, endpoint_error,
                                            ssim, synthesize_fisheye_set,
                                            synthesize_four_input_set,
                                            to_numpy, to_torch)
from panorama_opticalflow_tpu_torch.models import pipeline
from panorama_opticalflow_tpu_torch.utils import io as pio
from panorama_opticalflow_tpu_torch.utils import runtime, visualize

torch.set_num_threads(2)
runtime.settle_cpu_math()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTERMEDIATES = ("Map", "Blend", "OverlappedL", "OverlappedR",
                 "mergedmiddle", "flowLtoR", "flowRtoL")


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    env.pop("PANOSTITCH_TRACE_DIR", None)
    proc = subprocess.run(
        [sys.executable, "-m", "panorama_opticalflow_tpu_torch.cli", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _read(d, name):
    return pio.read_image_rgba(os.path.join(str(d), name))


def test_cli_synth_four_then_stitch4(tmp_path):
    d = str(tmp_path)
    _cli("synth", "--four", "--test_dir", d, "--height", "64", "--width",
         "256", "--seed", "2")
    assert sorted(os.listdir(d)) == [f"{i}.tif" for i in range(1, 5)]
    photos = synthesize_four_input_set(64, 256, seed=2)
    for i, p in enumerate(photos, start=1):
        np.testing.assert_array_equal(_read(d, f"{i}.tif"), p)
    out = _cli("stitch4", "--test_dir", d, "--flow_alg", "pixflow_low",
               "--device", "cpu")
    assert "Stitch finished! RUNTIME" in out and "TotalRunTime" in out
    np.testing.assert_array_equal(
        _read(d, "FinalResult.png"),
        to_numpy(pipeline.stitch_four(photos, StitchConfig(
            flow_alg="pixflow_low"), device="cpu")))


def test_cli_stitch6_resume_equals_uninterrupted_run(tmp_path):
    d = str(tmp_path)
    _cli("synth", "--test_dir", d, "--height", "48", "--width", "160",
         "--seed", "3")
    stitch = ("stitch6", "--test_dir", d, "--top_img", "top.tif",
              "--flow_alg", "pixflow_low_fast", "--device", "cpu")
    out = _cli(*stitch)
    assert [f"Part{i} finished!" in out for i in range(1, 6)] == [True] * 5
    whole = {n: _read(d, n) for n in ("ProcessResult3.png",
                                      "ProcessResult4.png",
                                      "FinalResult.png")}
    photos, top = synthesize_fisheye_set(48, 160, seed=3)
    np.testing.assert_array_equal(
        whole["FinalResult.png"],
        to_numpy(pipeline.stitch_six(photos, top, StitchConfig(
            flow_alg="pixflow_low_fast"), device="cpu")))

    os.remove(os.path.join(d, "ProcessResult4.png"))
    os.remove(os.path.join(d, "FinalResult.png"))
    out = _cli(*stitch, "--resume")
    assert "resuming from" in out and "ProcessResult3.png" in out
    assert "Part3 finished!" not in out and "Part4 finished!" in out
    for name, img in whole.items():
        np.testing.assert_array_equal(_read(d, name), img)


def test_cli_debug_dump_and_profile_dir(tmp_path):
    d, dump, prof = (str(tmp_path / n) for n in ("in", "dump", "prof"))
    _cli("synth", "--four", "--test_dir", d, "--height", "48", "--width",
         "160", "--seed", "1")
    _cli("stitch4", "--test_dir", d, "--flow_alg", "pixflow_low_fast",
         "--device", "cpu", "--debug_dump", dump, "--profile_dir", prof)
    names = ["Map", "Blend", "OverlappedL", "OverlappedR", "mergedmiddle",
             "flowLtoR_pixflow_low_fast", "flowRtoL_pixflow_low_fast"]
    assert sorted(os.listdir(dump)) == sorted(f"stitch_{n}.png"
                                              for n in names)
    # three 160-wide visualisations side by side
    assert _read(dump, "stitch_flowLtoR_pixflow_low_fast.png").shape == \
        (48, 480, 4)
    # the debug pair runs on the full canvas, as stitch_four does here
    photos = synthesize_four_input_set(48, 160, seed=1)
    np.testing.assert_array_equal(
        _read(d, "FinalResult.png"),
        to_numpy(pipeline.stitch_four(photos, StitchConfig(
            flow_alg="pixflow_low_fast"), device="cpu")))
    np.testing.assert_array_equal(
        _read(dump, "stitch_Map.png")[..., 0],
        to_numpy(pipeline.stitch_pair_debug(
            *pipeline.compose_four([to_torch(p, "cpu") for p in photos]),
            StitchConfig(flow_alg="pixflow_low_fast"),
            device="cpu")[1]["Map"]))
    assert os.listdir(prof) == ["Stitch.trace.json"]
    with open(os.path.join(prof, "Stitch.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    # the port's spans: the stage's own and the debug pair's stages
    names = {e.get("name", "") for e in events}
    assert {"panostitch.stage.Stitch", "panostitch.pair.blend",
            "panostitch.pair.flow_coarsest"} <= names


def test_cli_stitch6_debug_dump_names_every_part(tmp_path):
    d, dump = str(tmp_path / "in"), str(tmp_path / "dump")
    _cli("synth", "--test_dir", d, "--height", "48", "--width", "160",
         "--seed", "1")
    _cli("stitch6", "--test_dir", d, "--top_img", "top.tif", "--flow_alg",
         "pixflow_low_fast", "--device", "cpu", "--debug_dump", dump)
    got = sorted(os.listdir(dump))
    assert len(got) == 5 * 7
    assert {n.split("_")[0] for n in got} == {f"part{i}"
                                              for i in range(1, 6)}
    assert os.path.exists(os.path.join(d, "FinalResult.png"))


def test_cli_requires_its_arguments_and_defaults_to_the_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = lambda *a: subprocess.run(
        [sys.executable, "-m", "panorama_opticalflow_tpu_torch.cli", *a],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    proc = run("stitch4", "--test_dir", str(tmp_path))
    assert proc.returncode != 0
    assert "missing required command line argument: --flow_alg" in proc.stderr
    if not torch.cuda.is_available():
        d = str(tmp_path)
        _cli("synth", "--four", "--test_dir", d, "--height", "24",
             "--width", "64")
        proc = run("stitch4", "--test_dir", d, "--flow_alg", "pixflow_low")
        assert proc.returncode != 0      # no card: raises, no CPU fallback
        assert not os.path.exists(os.path.join(d, "FinalResult.png"))


def test_stitch_pair_debug_intermediates_match_jax():
    photos = synthesize_four_input_set(96, 320, seed=1)
    image_l, image_r = pipeline.compose_four([to_torch(p, "cpu")
                                              for p in photos])
    cfg = StitchConfig(flow_alg="pixflow_low")
    out, inter = pipeline.stitch_pair_debug(image_l, image_r, cfg,
                                            device="cpu")
    ref_out, ref = jpl.stitch_pair_debug(
        jnp.asarray(to_numpy(image_l)), jnp.asarray(to_numpy(image_r)),
        jcfg.StitchConfig(flow_alg="pixflow_low"))
    assert tuple(inter) == tuple(ref) == INTERMEDIATES
    assert torch.equal(out, pipeline.stitch_pair(image_l, image_r, cfg))
    got = {k: to_numpy(v) for k, v in inter.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    for name in ("Map", "OverlappedL", "OverlappedR"):
        np.testing.assert_array_equal(got[name], ref[name])
    np.testing.assert_allclose(got["Blend"], ref["Blend"], atol=1e-4, rtol=0)
    for name in ("flowLtoR", "flowRtoL"):
        assert got[name].shape == (96, 320, 2)
        assert endpoint_error(got[name], ref[name]) <= 0.05
    # the merged view is transparent where a sample falls off a footprint:
    # a flow that differs by a fraction of a pixel moves that edge
    merged_alpha = got["mergedmiddle"][..., 3] == ref["mergedmiddle"][..., 3]
    assert merged_alpha.mean() > 0.999, merged_alpha.mean()
    np.testing.assert_array_equal(to_numpy(out)[..., 3],
                                  np.asarray(ref_out)[..., 3])
    for a, b in ((got["mergedmiddle"], ref["mergedmiddle"]),
                 (to_numpy(out), np.asarray(ref_out))):
        assert ssim(a, b) >= 0.995
        assert (np.abs(a.astype(int) - b.astype(int)) > 8).mean() < 0.01


def test_dump_intermediates_writes_what_jax_writes(tmp_path, rng):
    """The same dictionary through both packages' dump_intermediates: the
    same file names with the same pixels."""
    h, w = 40, 64
    inter = {"Map": rng.choice(np.array([0, 50, 100, 150], np.uint8), (h, w)),
             "Blend": rng.random((h, w)).astype(np.float32)}
    for name in ("OverlappedL", "OverlappedR", "mergedmiddle"):
        inter[name] = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    for name in ("flowLtoR", "flowRtoL"):
        inter[name] = rng.standard_normal((h, w, 2)).astype(np.float32) * 4
    ours, theirs = str(tmp_path / "a"), str(tmp_path / "b")
    pipeline.dump_intermediates({k: to_torch(v, "cpu")
                                 for k, v in inter.items()}, ours, "t", "alg")
    jpl.dump_intermediates(inter, theirs, "t", "alg")
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    assert len(os.listdir(ours)) == 7
    for name in os.listdir(ours):
        np.testing.assert_array_equal(_read(ours, name), _read(theirs, name))


def test_visualisers_match_jax(rng):
    flow = rng.standard_normal((50, 70, 2)).astype(np.float32) * 5
    flow[3, 4] = 0.0                       # zero magnitude: NaN hue path
    image = rng.integers(0, 256, (50, 70, 4), dtype=np.uint8)
    np.testing.assert_array_equal(visualize.flow_as_grey_disparity(flow),
                                  jvis.flow_as_grey_disparity(flow))
    np.testing.assert_array_equal(visualize.flow_color_wheel(flow),
                                  jvis.flow_color_wheel(flow))
    np.testing.assert_array_equal(
        visualize.flow_as_vector_field(flow, image),
        jvis.flow_as_vector_field(flow, image))
    parts = [image[..., :3], image[::-1, :, :3]]
    np.testing.assert_array_equal(visualize.stack_horizontal(parts),
                                  jvis.stack_horizontal(parts))
    flat = np.zeros((8, 8, 2), np.float32)
    assert (visualize.flow_as_grey_disparity(flat) == 0).all()


def test_stage_timer_times_and_traces(tmp_path, monkeypatch):
    monkeypatch.delenv("PANOSTITCH_TRACE_DIR", raising=False)
    timer = runtime.StageTimer("cpu")
    with timer.stage("a"):
        torch.ones(1000).sum()
    assert [n for n, _ in timer.stages] == ["a"] and timer.stages[0][1] > 0
    assert not os.listdir(tmp_path)
    monkeypatch.setenv("PANOSTITCH_TRACE_DIR", str(tmp_path / "tr"))
    with timer.stage("b"):
        torch.ones(1000).sum()
    assert os.listdir(tmp_path / "tr") == ["b.trace.json"]
    assert timer.total() >= sum(dt for _, dt in timer.stages)
    with pytest.raises(ZeroDivisionError):   # a failing stage is not hidden
        with timer.stage("c"):
            1 / 0
    runtime.init_runtime()
    runtime.init_runtime()                   # safe to call twice


def test_prefetch_loader_yields_in_order_and_raises(tmp_path, rng):
    imgs, paths = [], []
    for i in range(5):
        img = rng.integers(0, 256, (9, 11, 4), dtype=np.uint8)
        path = str(tmp_path / f"{i}.{'png' if i % 2 else 'tif'}")
        pio.write_image_fast(path, img)
        imgs.append(img)
        paths.append(path)
    got = list(pio.PrefetchLoader(paths, depth=2))
    assert [p for p, _ in got] == paths
    for (_, g), img in zip(got, imgs):
        np.testing.assert_array_equal(g, img)
    bad = paths[:2] + [str(tmp_path / "missing.png")] + paths[2:]
    seen = []
    with pytest.raises(pio.PanoIOError):
        for p, _ in pio.PrefetchLoader(bad):
            seen.append(p)
    assert seen == paths[:2]
