"""The port's pair flow solver against the JAX package's, on the CPU, on
the same numpy inputs.

(a) pixflow_low at 96 x 320: no level reaches pallas_min_pixels, so both
    packages run the unfused path (the JAX package with its unrolled
    pyramid, scan_coarse_levels=False).
(b) pixflow_low_fast with pallas_min_pixels=0 at 200 x 320: every fast
    level takes the fused branch.  The JAX package runs its Pallas kernels
    in interpret mode (kernels.on_tpu patched to True, as
    test_pallas_interpret.py's fused-level test does); the port runs the
    kernels' plain versions on CPU tensors.
(c) the same with the 36 MP fidelity harness's two schedule knobs,
    sched22 (2 phases x 2 iterations) and unfused (fuse_level_blurs=False):
    every fast level runs the unfused relax kernel and median5 per phase.
(d) the search init of the pixflow_search_* presets, alone and in the
    single-direction solver.

Each JAX run records every pyramid level's inputs and output, and the
port's level runs on the very same inputs.  Tolerances and why:

* a level that refines an incoming flow: <= 1e-4 px on >= 99 % of the
  pixels and <= 0.1 px everywhere.  Same stencils in the same order; XLA
  contracts some multiply-adds into FMAs where PyTorch rounds each op,
  and a 1-ulp difference can flip a strict-< propagation take, which
  moves a few pixels by up to a neighbour's flow difference (measured
  when written: max 2.3e-3 px on 15 of 7680 pixels).
* the coarsest level (zero init, exact path): mean endpoint error <= 0.05
  px.  Its 15-60 Jacobi iterations take finite-difference gradients with
  eps = 1e-3, which scale a 1-ulp difference in the error by 1e3, and its
  strict-< takes cascade; the result is chaotic at the ulp level within
  the JAX package itself (eager vs jax.jit of the same level differ by up
  to 0.95 px on 1586 of 2236 pixels; the port differs from either by a
  mean of 0.011 px).
* the whole pair end to end inherits the coarsest level's spread: mean
  endpoint error <= 0.1 px and 99th percentile <= 0.6 px.  The JAX
  package's own rung-scanned and unrolled pyramids differ by a mean of
  0.025 px (max 0.83 px) on (a); the port differs from the unrolled one
  by 0.041 px (p99 0.29 px) on (a) and 0.030 px (p99 0.34 px) on (b).
  The 1e-3 px end-to-end target is out of reach for the same reason.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from panorama_opticalflow_tpu.models import pixflow as jpf
from panorama_opticalflow_tpu.ops.pallas import kernels as jk
from panorama_opticalflow_tpu.utils import config as jcfg
from panorama_opticalflow_tpu_torch import flow_params_by_name, to_numpy
from panorama_opticalflow_tpu_torch import synthesize_fisheye_set, to_torch
from panorama_opticalflow_tpu_torch.models import pixflow as tpf
from panorama_opticalflow_tpu_torch.ops import kernels as tk

torch.set_num_threads(2)


def _pair(rng, h, w):
    """A textured RGBA image and a shifted, re-gained copy with a partial
    footprint: real flow to find, and low-alpha pixels to diffuse."""
    _, top = synthesize_fisheye_set(h, w, n=2, seed=3)
    img0 = top.copy()
    img0[..., :3] = np.clip(top[..., :3].astype(np.float32)
                            + rng.normal(0, 6, (h, w, 3)), 0, 255)
    img0[..., 3] = 255
    img1 = np.roll(img0, (1, 3), axis=(0, 1))
    img1[..., :3] = np.clip(img1[..., :3] * 1.05, 0, 255).astype(np.uint8)
    img1[:, : w // 10, 3] = 0
    return img0, img1


def _epe(a, b):
    return np.linalg.norm(a - b, axis=-1)


def _jax_flows_recorded(img0, img1, params, monkeypatch):
    """JAX's pair solve; also returns every level call as (imgs, alphas,
    flow or None, params, output) in numpy."""
    levels = []
    inner = jpf.patch_match_level_batched

    def record(imgs, alphas, flow, hints, p, knd=None):
        out = inner(imgs, alphas, flow, hints, p, knd)
        levels.append((np.asarray(imgs), np.asarray(alphas),
                       None if flow is None else np.asarray(flow), p,
                       np.asarray(out)))
        return out

    monkeypatch.setattr(jpf, "patch_match_level_batched", record)
    f01, f10 = jpf.compute_optical_flow_pair(jnp.asarray(img0),
                                             jnp.asarray(img1), params)
    monkeypatch.undo()
    return np.stack([np.asarray(f01), np.asarray(f10)]), levels


def _port_flows(img0, img1, params):
    f01, f10 = tpf.compute_optical_flow_pair(to_torch(img0, "cpu"),
                                             to_torch(img1, "cpu"), params)
    return np.stack([to_numpy(f01), to_numpy(f10)])


def _check_levels(levels, expect_coarsest: int):
    """The port's level on each recorded JAX level's inputs (the JAX
    FlowParams object itself: the port reads its fields by name)."""
    n_refine = n_coarsest = 0
    for imgs, alphas, flow, p, ref in levels:
        if flow is None and tpf._sub_floor_sizes(*imgs.shape[1:], p):
            continue    # the _fast init-floor wrapper: its twin is recorded
        imgs_t, alphas_t = to_torch(imgs, "cpu"), to_torch(alphas, "cpu")
        got = to_numpy(tpf.patch_match_level_batched(
            imgs_t, alphas_t,
            tpf.coarsest_start(imgs_t, alphas_t, ("left", "right"), p)
            if flow is None else to_torch(flow, "cpu"), p, flow is None))
        d = _epe(got, ref)
        if flow is None:
            n_coarsest += 1
            assert d.mean() <= 0.05, (imgs.shape, d.mean())
        else:
            n_refine += 1
            assert (d > 1e-4).mean() <= 0.01, (imgs.shape, (d > 1e-4).mean())
            assert d.max() <= 0.1, (imgs.shape, d.max())
    assert n_coarsest == expect_coarsest and n_refine >= 1


def _check_end_to_end(got, ref):
    assert np.abs(ref).max() > 1.0           # a real flow was solved
    d = _epe(got, ref)
    assert d.mean() <= 0.1, d.mean()
    assert np.percentile(d, 99) <= 0.6, np.percentile(d, 99)


_KNOBS = {"sched22": dict(relax_phases=2, relax_iters_per_phase=2),
          "unfused": dict(fuse_level_blurs=False)}


def test_pyramid_sizes_match_jax():
    for name in ("pixflow_low", "pixflow_low_fast"):
        for hw in ((2000, 1792), (48, 160), (100, 160)):
            assert tpf.pyramid_sizes(*hw, flow_params_by_name(name)) == \
                jpf.pyramid_sizes(*hw, jcfg.flow_params_by_name(name))
            assert tpf._sub_floor_sizes(*hw, flow_params_by_name(name)) == \
                jpf._sub_floor_sizes(*hw, jcfg.flow_params_by_name(name))
    # the headline pair window's finest level (4000 x 3584 / 2)
    fast = tpf.pyramid_sizes(2000, 1792, flow_params_by_name(
        "pixflow_low_fast"))
    assert len(fast) == 15 and fast[-1] == (88, 78)
    assert sum(h * w >= 65536 for h, w in fast) == 9
    assert len(tpf.pyramid_sizes(2000, 1792,
                                 flow_params_by_name("pixflow_low"))) == 41


def test_flow_pair_unfused_matches_jax(rng, monkeypatch):
    img0, img1 = _pair(rng, 96, 320)
    jp = dataclasses.replace(jcfg.flow_params_by_name("pixflow_low"),
                             scan_coarse_levels=False)
    tp = flow_params_by_name("pixflow_low")
    assert all(h * w < tp.pallas_min_pixels
               for h, w in tpf.pyramid_sizes(48, 160, tp))
    tk.reset_launch_counts()
    got = _port_flows(img0, img1, tp)
    ref, levels = _jax_flows_recorded(img0, img1, jp, monkeypatch)
    assert len(levels) == len(tpf.pyramid_sizes(48, 160, tp))
    _check_levels(levels, expect_coarsest=1)
    _check_end_to_end(got, ref)
    assert all(k.launches == 0 for k in tk.KERNELS)


@pytest.fixture
def interp():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def test_flow_pair_fused_matches_jax_pallas_interpret(rng, interp,
                                                      monkeypatch):
    img0, img1 = _pair(rng, 200, 320)
    jp = dataclasses.replace(jcfg.flow_params_by_name("pixflow_low_fast"),
                             pallas_min_pixels=0, scan_coarse_levels=False)
    tp = dataclasses.replace(flow_params_by_name("pixflow_low_fast"),
                             pallas_min_pixels=0)
    got = _port_flows(img0, img1, tp)
    monkeypatch.setattr(jk, "on_tpu", lambda: True)
    ref, levels = _jax_flows_recorded(img0, img1, jp, monkeypatch)
    # levels (100, 160) and (80, 128), the latter behind its init-floor
    # twin solve
    _check_levels(levels, expect_coarsest=1)
    _check_end_to_end(got, ref)


@pytest.mark.parametrize("knob", sorted(_KNOBS))
def test_flow_pair_multiphase_matches_jax_pallas_interpret(rng, interp,
                                                           monkeypatch,
                                                           knob):
    img0, img1 = _pair(rng, 200, 320)
    jp = dataclasses.replace(jcfg.flow_params_by_name("pixflow_low_fast"),
                             pallas_min_pixels=0, scan_coarse_levels=False,
                             **_KNOBS[knob])
    tp = dataclasses.replace(flow_params_by_name("pixflow_low_fast"),
                             pallas_min_pixels=0, **_KNOBS[knob])
    got = _port_flows(img0, img1, tp)
    monkeypatch.setattr(jk, "on_tpu", lambda: True)
    ref, levels = _jax_flows_recorded(img0, img1, jp, monkeypatch)
    _check_levels(levels, expect_coarsest=1)
    _check_end_to_end(got, ref)


def test_search_box_offsets_match_jax():
    for hint in ("left", "right", "up", "down"):
        for dist in (0, 3, 5, 12):
            assert tpf.search_box_offsets(hint, dist) == \
                jpf.search_box_offsets(hint, dist)
    with pytest.raises(ValueError):
        tpf.search_box_offsets("unknown", 5)


@pytest.mark.parametrize("hint", ["left", "right", "up", "down"])
def test_adjust_initial_flow_matches_jax(rng, hint):
    """The coarsest level's inputs of a real pair (29 x 26 planes, a 3 px
    shift, a partial footprint).  The integer flow may differ where two
    offsets tie to within an ulp (the exposure ratio is a sum taken in
    another order), so the gate is >= 99.5 % of the pixels equal."""
    h, w = 29, 26
    i0 = rng.random((h, w)).astype(np.float32)
    i1 = (np.roll(i0, -3, axis=1) * 1.1).astype(np.float32)
    a0 = (rng.random((h, w)) > 0.05).astype(np.float32)
    a1 = np.ones((h, w), np.float32)
    a1[:, :3] = 0
    args = (i0, i1, a0, a1)
    jp = jcfg.flow_params_by_name("pixflow_search_20")
    tp = flow_params_by_name("pixflow_search_20")
    assert tp.search_distance == jp.search_distance == 5
    ref = np.asarray(jpf.adjust_initial_flow(*map(jnp.asarray, args), hint,
                                             jp))
    got = to_numpy(tpf.search_init(
        *(to_torch(a, "cpu")[None] for a in args), (hint, hint), tp)[0])
    assert np.abs(ref).max() >= 3            # the search moved pixels
    assert (got == ref).all(axis=-1).mean() >= 0.995


def test_search20_flow_recovers_shift(rng):
    """test_search20.py's case through the port's single-direction
    solver: the search init recovers a 6 px shift that zero-init descent
    does not reach at the coarsest level; the JAX package's unrolled
    solver agrees within the end-to-end gate."""
    import cv2

    h, w = 64, 96
    base = rng.integers(0, 256, (h, w + 8, 4), np.uint8)
    base[..., 3] = 255
    base[..., :3] = cv2.GaussianBlur(base[..., :3], (7, 7), 2.0)
    i0, i1 = base[:, :w], base[:, 6:6 + w]
    params = flow_params_by_name("pixflow_search_20")
    flow = to_numpy(tpf.compute_optical_flow(
        to_torch(i0, "cpu"), to_torch(i1, "cpu"), params, "left"))
    assert flow.shape == (h, w, 2)
    inner = flow[16:-16, 20:-20]
    assert np.abs(inner[..., 0] - (-6.0)).mean() < 1.5
    ref = np.asarray(jpf.compute_optical_flow(
        jnp.asarray(i0), jnp.asarray(i1),
        dataclasses.replace(jcfg.flow_params_by_name("pixflow_search_20"),
                            scan_coarse_levels=False), "left"))
    _check_end_to_end(flow, ref)
