"""The port's row-tiled stitch (panorama_opticalflow_tpu_torch/parallel)
against its own untiled program and against the JAX package's tiled
stitch, on the CPU; mirrors tests/test_tiled.py on the in-process
communicator at n = 8, the size of the conftest's mesh.

Gates:
  * halo exchange, tiled eight-ray scans: exact;
  * tiled row resize: the untiled resize's bits (the gather form keeps its
    taps and their order), and the JAX package's banded-matmul resize
    within 1e-5;
  * tiled flow against untiled: interior mean endpoint error < 0.05 px;
  * tiled stitch against untiled: SSIM >= 0.995 and more than 97 % of the
    interior bytes equal (the global top and bottom rows see reflect fill,
    a documented deviation of the reference);
  * tiled stitch against the JAX package's tiled stitch (its shard_map
    form with the jnp solver, the form the port mirrors): the golden gate
    of tests/test_torch_pipeline.py;
  * four gloo ranks of torch.distributed against the in-process form: byte
    for byte (every stage gives a plane of a stack the bits it gets
    alone).
"""

import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from panorama_opticalflow_tpu.models import pipeline as jpl
from panorama_opticalflow_tpu.ops import image as jim
from panorama_opticalflow_tpu.parallel import tiled as jt
from panorama_opticalflow_tpu.parallel.mesh import make_mesh
from panorama_opticalflow_tpu.utils import config as jcfg
from panorama_opticalflow_tpu_torch import (StitchConfig, endpoint_error,
                                            flow_params_by_name, ssim,
                                            synthesize_fisheye_set,
                                            synthesize_four_input_set,
                                            to_numpy, to_torch)
from panorama_opticalflow_tpu_torch.models import crop, pipeline, pixflow
from panorama_opticalflow_tpu_torch.ops import image as im
from panorama_opticalflow_tpu_torch.ops.distance import \
    eight_ray_min_distance
from panorama_opticalflow_tpu_torch.parallel import mesh, tiled
from panorama_opticalflow_tpu_torch.utils import runtime

torch.set_num_threads(2)
runtime.settle_cpu_math()

N = 8
AXIS = "y"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMM = mesh.InProcessRows(N)


def _tiles(a, n=N):
    """(n*h, ...) -> (n, h, ...) tiles."""
    a = torch.as_tensor(a)
    return a.reshape((n, -1) + tuple(a.shape[1:]))


def _jax_shard(fn, *arrs, n=N, outs=1):
    m = make_mesh(n)
    spec = P(AXIS) if outs == 1 else (P(AXIS),) * outs
    f = shard_map(fn, mesh=m, in_specs=tuple(P(AXIS) for _ in arrs),
                  out_specs=spec)
    got = jax.jit(f)(*arrs)
    return np.asarray(got) if outs == 1 else [np.asarray(g) for g in got]


def _jax_tc(tc):
    """The JAX package's TileConfig of the form the port mirrors: shard_map
    with the jnp solver, no canaries."""
    return jt.TileConfig(min_tiled_rows=tc.min_tiled_rows,
                         level_halo=tc.level_halo, flow_mode="shardmap",
                         use_pallas_in_shardmap=False, canary_mode="off")


def _check_golden(out, ref):
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out[..., 3], ref[..., 3])
    assert ssim(out, ref) >= 0.995
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert (diff > 8).mean() < 0.01, (diff > 8).mean()


def _check_untiled(out, ref, inner=np.s_[8:-8]):
    assert out.shape == ref.shape
    s = ssim(out[inner], ref[inner])
    assert s >= 0.995, s
    same = (out[inner] == ref[inner]).mean()
    assert same > 0.97, same


@pytest.mark.parametrize("halo,fill", [(3, "reflect"), (3, 255.0),
                                       (10, "reflect"), (10, 255.0)])
def test_exchange_rows_roundtrip(rng, halo, fill):
    """Neighbour rows inside, reflect or constant fill at the global top
    and bottom; halo >= the tile's rows takes the all-gather branch.  Equal
    to the JAX package's exchange."""
    x = rng.random((64, 12)).astype(np.float32)
    got = to_numpy(COMM.exchange_rows(_tiles(x), halo, fill))
    ref = _jax_shard(lambda t: jt._exchange_rows(t, halo, AXIS, fill),
                     x).reshape(got.shape)
    np.testing.assert_array_equal(got, ref)
    for d in range(N):
        np.testing.assert_array_equal(got[d][halo:-halo], x[d * 8:d * 8 + 8])
        if halo < 8 and 0 < d < N - 1:
            np.testing.assert_array_equal(got[d][:halo],
                                          x[d * 8 - halo:d * 8])
    if fill == "reflect" and halo < 8:
        np.testing.assert_array_equal(got[0][:halo], x[1:halo + 1][::-1])
    elif fill != "reflect":
        assert (got[0][:halo] == fill).all() and (got[-1][-halo:] == fill).all()


@pytest.mark.parametrize("h_from,h_to,method", [(64, 32, "cubic"),
                                                (64, 72, "linear"),
                                                (56, 64, "cubic")])
def test_tiled_resize_rows_matches_untiled(rng, h_from, h_to, method):
    x = rng.random((h_from, 20)).astype(np.float32)
    plan = tiled.make_row_resize_plan(h_from, h_to, N, method)
    xp = np.pad(x, ((0, plan.h_a * N - h_from), (0, 0)))
    got = to_numpy(tiled._tiled_resize_rows(_tiles(xp), plan, COMM)
                   ).reshape(-1, 20)[:h_to]
    untiled = to_numpy(im._resize_axis(torch.from_numpy(x), 0, h_to, method))
    np.testing.assert_array_equal(got, untiled)
    jplan = jt.make_row_resize_plan(h_from, h_to, N, method)
    ref = _jax_shard(lambda t: jt._tiled_resize_rows(t, jplan, AXIS),
                     xp)[:h_to]
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jim._resize_axis0(jnp.asarray(x), h_to, method)),
        atol=1e-5, rtol=0)


def _max_diff(got, ref):
    both_inf = np.isinf(got) & np.isinf(ref)
    with np.errstate(invalid="ignore"):
        return np.where(both_inf, 0.0, np.abs(got - ref)).max()


@pytest.mark.parametrize("step", [1, 3])
def test_tiled_eight_ray_matches_untiled(rng, step):
    h, w = 48, 30
    mask = rng.random((h, w)) < 0.05
    ref = to_numpy(eight_ray_min_distance(torch.from_numpy(mask), step, 14.0))
    got = to_numpy(tiled._tiled_eight_ray(_tiles(mask), step, 14.0,
                                          math.sqrt(2.0), COMM)).reshape(h, w)
    assert _max_diff(got, ref) == 0.0


def test_tiled_eight_ray_multi_summary_scan_exact(rng):
    """Two masks, a stride that divides neither the tile's rows nor the
    canvas height, and pad rows: exact against the untiled op."""
    h, w, step = 179, 230, 7
    hp = -(-h // N) * N
    m1 = np.zeros((hp, w), bool)
    m2 = np.zeros((hp, w), bool)
    m1[:h] = rng.random((h, w)) < 0.01
    m2[:h] = rng.random((h, w)) < 0.008
    outs = tiled._tiled_eight_ray_multi([_tiles(m1), _tiles(m2)], step,
                                        w / 2.0, math.sqrt(2.0), COMM)
    for got, mask in zip(outs, (m1, m2)):
        ref = to_numpy(eight_ray_min_distance(torch.from_numpy(mask), step,
                                              w / 2.0))[:h]
        assert _max_diff(to_numpy(got).reshape(hp, w)[:h], ref) == 0.0


def test_tiled_flow_matches_untiled():
    """512 rows: the finest level is tiled (downscaled 256 rows, tiles of
    32 > the halo of 28)."""
    import dataclasses

    h, w = 512, 96
    photos, _ = synthesize_fisheye_set(h, w, n=2, seed=5, with_top=False)
    l, r = (to_torch(p, "cpu") for p in photos)
    params = dataclasses.replace(flow_params_by_name("pixflow_low"),
                                 relax_iters_per_phase=3)
    ref = to_numpy(pixflow.compute_optical_flow(l, r, params, "left"))
    tc = tiled.TileConfig(min_tiled_rows=8, level_halo=28)
    sizes = pixflow.pyramid_sizes(h // 2, w // 2, params)
    assert tiled.tiled_levels(sizes, N, tc)[:2] == [True, False]
    got = to_numpy(tiled.tiled_compute_optical_flow(
        _tiles(l), _tiles(r), params, "left", COMM, h, tc)).reshape(h, w, 2)
    assert got.shape == ref.shape
    epe = endpoint_error(got[8:-8], ref[8:-8])
    assert epe < 0.05, epe


def test_tiled_flow_pair_matches_jax_tiled():
    """The tiled solver (tiled levels, flow exchanged between tiles, tiled
    cubic resizes between levels) against the JAX package's tiled solver
    on the same tiles, both directions: the end-to-end gate of
    tests/test_torch_pixflow.py for port against JAX."""
    import dataclasses

    h, w = 512, 96
    photos, _ = synthesize_fisheye_set(h, w, n=2, seed=5, with_top=False)
    # a real flow to solve: the first photo and a shifted, re-gained copy
    img0 = photos[0].copy()
    img0[..., 3] = 255
    img1 = np.roll(img0, (2, 3), axis=(0, 1))
    img1[..., :3] = np.clip(img1[..., :3] * 1.05, 0, 255).astype(np.uint8)
    photos = (img0, img1)
    params = dataclasses.replace(flow_params_by_name("pixflow_low"),
                                 relax_iters_per_phase=3)
    tc = tiled.TileConfig(min_tiled_rows=8, level_halo=28)
    sizes = pixflow.pyramid_sizes(h // 2, w // 2, params)
    assert tiled.tiled_levels(sizes, N, tc)[:2] == [True, False]
    hints = ("left", "right")
    got = np.stack([to_numpy(f).reshape(h, w, 2)
                    for f in tiled.tiled_compute_optical_flow_pair(
                        *(_tiles(to_torch(p, "cpu")) for p in photos),
                        params, hints, COMM, h, tc)])
    jparams = dataclasses.replace(jcfg.flow_params_by_name("pixflow_low"),
                                  relax_iters_per_phase=3)
    ref = np.stack(_jax_shard(
        lambda a, b: jt.tiled_compute_optical_flow_pair(
            a, b, jparams, hints, AXIS, N, h, _jax_tc(tc)),
        *photos, outs=2))
    assert np.abs(ref).max() > 1.0           # a real flow was solved
    d = np.linalg.norm(got - ref, axis=-1)
    assert d.mean() <= 0.1, d.mean()
    assert np.percentile(d, 99) <= 0.6, np.percentile(d, 99)


@pytest.mark.parametrize("n,tc", [(N, tiled.TileConfig(8, 28)),
                                  (4, tiled.TileConfig(8, 24))],
                         ids=["top whole", "top tiled"])
def test_tiled_fast_flow_pair_matches_jax_tiled(n, tc):
    """pixflow_low_fast: the tiled solver hands its coarsest level, above
    the raised floor, the flow of the level's init-floor twin (the JAX
    package's level solves the twin inside itself); computed whole at
    n = 8 and on halo-extended tiles at n = 4.  Without the twin the
    flows part by ~2 px."""
    import dataclasses

    h, w = 512, 192
    photos, _ = synthesize_fisheye_set(h, w, n=2, seed=5, with_top=False)
    img0 = photos[0].copy()
    img0[..., 3] = 255
    img1 = np.roll(img0, (2, 3), axis=(0, 1))
    img1[..., :3] = np.clip(img1[..., :3] * 1.05, 0, 255).astype(np.uint8)
    photos = (img0, img1)
    params = dataclasses.replace(flow_params_by_name("pixflow_low_fast"),
                                 relax_iters_per_phase=3)
    sizes = pixflow.pyramid_sizes(h // 2, w // 2, params)
    assert len(sizes) == 2 and pixflow._sub_floor_sizes(*sizes[-1], params)
    assert tiled.tiled_levels(sizes, n, tc) == [True, n == 4]
    hints = ("left", "right")
    got = np.stack([to_numpy(f).reshape(h, w, 2)
                    for f in tiled.tiled_compute_optical_flow_pair(
                        *(_tiles(to_torch(p, "cpu"), n) for p in photos),
                        params, hints, mesh.InProcessRows(n), h, tc)])
    jparams = dataclasses.replace(
        jcfg.flow_params_by_name("pixflow_low_fast"),
        relax_iters_per_phase=3)
    ref = np.stack(_jax_shard(
        lambda a, b: jt.tiled_compute_optical_flow_pair(
            a, b, jparams, hints, AXIS, n, h, _jax_tc(tc)),
        *photos, n=n, outs=2))
    assert np.abs(ref).max() > 1.0           # a real flow was solved
    d = np.linalg.norm(got - ref, axis=-1)
    assert d.mean() <= 0.1, d.mean()
    assert np.percentile(d, 99) <= 0.6, np.percentile(d, 99)


def _composed(h, w, seed):
    photos = synthesize_four_input_set(h, w, seed=seed)
    return pipeline.compose_four([to_torch(p, "cpu") for p in photos])


@pytest.mark.parametrize("h,w,n,tc", [
    (128, 160, 8, tiled.TileConfig(min_tiled_rows=8, level_halo=32)),
    (384, 320, 4, tiled.TileConfig(min_tiled_rows=16, level_halo=32))])
def test_tiled_stitch_pair_matches_untiled(h, w, n, tc):
    """test_tiled.py's 128 x 160 case, and a canvas tall enough that the
    finest flow levels run tiled."""
    il, ir = _composed(h, w, 11)
    cfg = StitchConfig()
    sizes = pixflow.pyramid_sizes(h // 2, (w + 2 * (w // 20)) // 2,
                                  cfg.flow_params)
    assert any(tiled.tiled_levels(sizes, n, tc)) == (h > 128)
    ref = to_numpy(pipeline.stitch_pair(il, ir, cfg))
    got = to_numpy(tiled.tiled_stitch_pair(il, ir, cfg, n, tc=tc,
                                           device="cpu"))
    _check_untiled(got, ref)


def _chain_pair():
    photos, top = synthesize_fisheye_set(128, 640, n=5, seed=3,
                                         with_top=True)
    tp = [to_torch(p, "cpu") for p in photos]
    top = to_torch(top, "cpu")
    cfg = StitchConfig()
    wins = crop.plan_chain_windows(tp, top, cfg)
    r0 = pipeline.stitch_pair_auto(tp[0], top, cfg, window=wins[0],
                                   device="cpu")
    return tp[1], r0, wins[1], cfg


def test_tiled_stitch_pair_windowed_matches_untiled_windowed():
    """The planned overlap window of the 6-photo chain's second pair, with
    the windowed hole search."""
    il, ir, win, cfg = _chain_pair()
    assert win[1] < 640 and win[2]
    ref = to_numpy(pipeline.stitch_pair_auto(il, ir, cfg, window=win,
                                             device="cpu"))
    got = to_numpy(tiled.tiled_stitch_pair(
        il, ir, cfg, N, tc=tiled.TileConfig(8, 32), window=win,
        device="cpu"))
    _check_untiled(got, ref)


def test_tiled_stitch_pair_auto_derives_the_window():
    il, ir, win, cfg = _chain_pair()
    tc = tiled.TileConfig(8, 32)
    got = to_numpy(tiled.tiled_stitch_pair_auto(il, ir, cfg, N, tc=tc,
                                                device="cpu"))
    want = to_numpy(tiled.tiled_stitch_pair(
        il, ir, cfg, N, tc=tc, window=crop.pair_window(
            pipeline.stitcher.match_images(il, ir), cfg), device="cpu"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,n,tc", [
    (128, 160, 8, tiled.TileConfig(min_tiled_rows=8, level_halo=32)),
    (384, 320, 4, tiled.TileConfig(min_tiled_rows=16, level_halo=32))])
def test_tiled_stitch_matches_jax_tiled(h, w, n, tc):
    """One tiled stitch against the JAX package's on the same inputs: its
    shard_map form with the jnp solver, the form the port mirrors.  At
    384 x 320 the finest flow levels run tiled, so the tiled solver is held
    too, not only the tiled blend, combine and gather."""
    il, ir = _composed(h, w, 11)
    sizes = pixflow.pyramid_sizes(h // 2, (w + 2 * (w // 20)) // 2,
                                  StitchConfig().flow_params)
    assert any(tiled.tiled_levels(sizes, n, tc)) == (h > 128)
    got = to_numpy(tiled.tiled_stitch_pair(il, ir, StitchConfig(), n, tc=tc,
                                           device="cpu"))
    ref = np.asarray(jt.tiled_stitch_pair(
        jnp.asarray(to_numpy(il)), jnp.asarray(to_numpy(ir)),
        jcfg.StitchConfig(), make_mesh(n), AXIS, _jax_tc(tc)))
    _check_golden(got, ref)


def test_tiled_entry_points_default_to_the_card():
    il, ir = _composed(48, 160, 1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: test_torch_card.py covers it")
    with pytest.raises((RuntimeError, AssertionError)):
        tiled.tiled_stitch_pair(il, ir, StitchConfig(), 4)
    with pytest.raises((RuntimeError, AssertionError)):
        tiled.tiled_stitch_pair_auto(il, ir, StitchConfig(), 4)
    with pytest.raises(ValueError, match="level_halo"):
        tiled.tiled_stitch_pair(il, ir, StitchConfig(), 4,
                                tc=tiled.TileConfig(8, 16), device="cpu")


@pytest.mark.skipif(not os.environ.get("PANOSTITCH_SLOW_TESTS"),
                    reason="~2 min; set PANOSTITCH_SLOW_TESTS=1")
def test_tiled_stitch_pair_medium_canvas_matches_untiled():
    """>= 1 MP, pixflow_low_fast, planned window, tiles of 112 rows."""
    photos, top = synthesize_fisheye_set(896, 1152, n=5, seed=7,
                                         with_top=True)
    il, ir = to_torch(photos[0], "cpu"), to_torch(top, "cpu")
    cfg = StitchConfig(flow_alg="pixflow_low_fast")
    win = crop.pair_window(pipeline.stitcher.match_images(il, ir), cfg)
    assert win[1] < 1152
    ref = to_numpy(pipeline.stitch_pair_auto(il, ir, cfg, window=win,
                                             device="cpu"))
    tc = tiled.TileConfig.for_params(cfg.flow_params, min_tiled_rows=16)
    got = to_numpy(tiled.tiled_stitch_pair(il, ir, cfg, N, tc=tc,
                                           window=win, device="cpu"))
    inner = np.s_[16:-16]
    assert ssim(got[inner], ref[inner]) >= 0.995


# ---------------------------------------------------------------------------
# torch.distributed: four gloo ranks against the in-process form
# ---------------------------------------------------------------------------

_RANK = r"""
import math, os
import numpy as np
import torch
torch.set_num_threads(1)
from panorama_opticalflow_tpu_torch import StitchConfig
from panorama_opticalflow_tpu_torch.parallel import mesh, tiled
from panorama_opticalflow_tpu_torch.utils import runtime
runtime.settle_cpu_math()
comm = mesh.maybe_init_distributed(timeout_s=120)
assert isinstance(comm, mesh.DistributedRows) and comm.n == 4
r = comm.rank
inp = {k: torch.from_numpy(v) for k, v in np.load(os.environ["IN"]).items()}
out = {}
for halo, fill in ((3, "reflect"), (10, 255.0)):
    ext = comm.exchange_rows(inp["x"][r * 8:(r + 1) * 8][None], halo, fill)
    out[f"ex{halo}"] = comm.all_gather_rows(ext).numpy()
d = tiled._tiled_eight_ray(inp["mask"][r * 12:(r + 1) * 12][None], 3, 14.0,
                           math.sqrt(2.0), comm)
out["ray"] = comm.all_gather_rows(d).numpy()
out["stitch"] = tiled.tiled_stitch_pair(
    inp["il"], inp["ir"], StitchConfig(), 4, comm,
    tiled.TileConfig(min_tiled_rows=8, level_halo=24), device="cpu").numpy()
if r == 0:
    np.savez(os.environ["OUT"], **out)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_distributed_rows_match_in_process(tmp_path, rng):
    """Four gloo ranks, one tile each: the halo exchange (neighbour and
    all-gather branches), the eight-ray scan and a 256 x 160 stitch equal
    the in-process form byte for byte.  At 256 rows the finest flow level
    runs tiled (tiles of 32 rows, halo 24), so flow crosses the ranks."""
    il, ir = _composed(256, 160, 11)
    tc = tiled.TileConfig(min_tiled_rows=8, level_halo=24)
    sizes = pixflow.pyramid_sizes(128, (160 + 2 * 8) // 2,
                                  StitchConfig().flow_params)
    assert tiled.tiled_levels(sizes, 4, tc)[0]
    inp = {"x": rng.random((32, 12)).astype(np.float32),
           "mask": rng.random((48, 30)) < 0.05,
           "il": to_numpy(il), "ir": to_numpy(ir)}
    np.savez(tmp_path / "in.npz", **inp)
    out = str(tmp_path / "rank0.npz")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="4", OUT=out,
               IN=str(tmp_path / "in.npz"), PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK],
                              env=dict(env, RANK=str(r)), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            errs.append(err[-2000:])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), errs
    got = np.load(out)

    comm = mesh.InProcessRows(4)
    for halo, fill in ((3, "reflect"), (10, 255.0)):
        want = comm.all_gather_rows(comm.exchange_rows(
            _tiles(inp["x"], 4), halo, fill))
        np.testing.assert_array_equal(got[f"ex{halo}"], to_numpy(want))
    want = comm.all_gather_rows(tiled._tiled_eight_ray(
        _tiles(inp["mask"], 4), 3, 14.0, math.sqrt(2.0), comm))
    np.testing.assert_array_equal(got["ray"], to_numpy(want))
    want = tiled.tiled_stitch_pair(il, ir, StitchConfig(), 4, tc=tc,
                                   device="cpu")
    np.testing.assert_array_equal(got["stitch"], to_numpy(want))
