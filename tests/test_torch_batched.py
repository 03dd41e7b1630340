"""Batched stitching in the port: N pairs through one pyramid descent
(what jax.vmap(pipeline.stitch_pair) gives the JAX package), on the CPU.

On the CPU a batched call gives each pair the bits of its own call: every
op of the flow solver is a gather or an elementwise IEEE op (add,
multiply, divide, sqrt, compare), the tile offsets are means taken within
one pair's tile, the distance fields are per-line scans of minima, the
box blurs per-line running sums, and the samplers and the hole search only
select.  So
the flow and the exact coarsest level are held bit-equal against the
per-pair loop.  The stitch is held against sequential at the gate of
tests/test_batching.py (more than 0.98 of the bytes equal, 99.9th
percentile of the absolute difference <= 8) and bit-equal besides, and
against jax.vmap(stitch_pair) at the gate between the two packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from panorama_opticalflow_tpu.models import pipeline as jpl
from panorama_opticalflow_tpu.utils import config as jcfg
from panorama_opticalflow_tpu_torch import (StitchConfig,
                                            flow_params_by_name, ssim,
                                            synthesize_four_input_set,
                                            to_numpy, to_torch)
from panorama_opticalflow_tpu_torch.models import (novel_view, pipeline,
                                                   pixflow, stitcher)
from panorama_opticalflow_tpu_torch.ops import distance as td
from panorama_opticalflow_tpu_torch.ops import warp as tw
from panorama_opticalflow_tpu_torch.utils.config import with_flow_params
from panorama_opticalflow_tpu_torch.utils import runtime

torch.set_num_threads(2)
runtime.settle_cpu_math()


def T(a):
    return to_torch(a, "cpu")


def _pairs(h, w, seeds):
    ls, rs = [], []
    for seed in seeds:
        photos = synthesize_four_input_set(h, w, seed=seed)
        image_l, image_r = pipeline.compose_four([T(p) for p in photos])
        ls.append(image_l)
        rs.append(image_r)
    return torch.stack(ls), torch.stack(rs)


@pytest.mark.parametrize("alg,kernel_levels", [
    ("pixflow_low", False), ("pixflow_low", True),
    ("pixflow_low_fast", True), ("pixflow_search_20", False)])
def test_flow_pairs_equal_three_pair_calls(alg, kernel_levels):
    """N = 3 through one descent against three compute_optical_flow_pair
    calls, bit for bit.  With ``kernel_levels`` every fast level takes the
    kernels' branch (their plain versions here), tile offsets included."""
    params = flow_params_by_name(alg)
    if kernel_levels:
        params = dataclasses.replace(params, pallas_min_pixels=0)
    ls, rs = _pairs(96, 320, (1, 2, 3))
    f01, f10 = pixflow.compute_optical_flow_pairs(ls, rs, params)
    assert f01.shape == f10.shape == (3, 96, 320, 2)
    for k in range(3):
        a, b = pixflow.compute_optical_flow_pair(ls[k], rs[k], params)
        assert torch.equal(f01[k], a) and torch.equal(f10[k], b), k
    # the pairs differ, so a pair cannot have been given another's partner
    assert not torch.equal(f01[0], f01[1])


def test_flow_pairs_partner_is_the_pairs_other_image():
    """Direction 2n + d reads image d of pair n and its partner 1 - d of
    the same pair: swapping the two stacks swaps the two directions."""
    params = flow_params_by_name("pixflow_low")
    ls, rs = _pairs(48, 160, (4, 5))
    f01, f10 = pixflow.compute_optical_flow_pairs(ls, rs, params, "unknown",
                                                  "unknown")
    g01, g10 = pixflow.compute_optical_flow_pairs(rs, ls, params, "unknown",
                                                  "unknown")
    assert torch.equal(f01, g10) and torch.equal(f10, g01)
    x = torch.arange(6 * 2).view(6, 2)
    assert pixflow._partner(x)[:, 0].tolist() == [2, 0, 6, 4, 10, 8]


def test_exact_level_batched_equals_per_direction_loop(rng):
    """relax_iteration on a leading batch of 6 directions against the loop
    over the directions, bit for bit, over the coarsest level's 15
    iterations (the level is chaotic at the ulp level, so nothing short of
    equal bits would do)."""
    params = flow_params_by_name("pixflow_low")
    nb, h, w = 6, 26, 31
    mk = lambda *s: T(rng.standard_normal(s).astype(np.float32))
    flow, bf = mk(nb, h, w, 2) * 2, mk(nb, h, w, 2)
    i0x, i0y, i1g = mk(nb, h, w), mk(nb, h, w), mk(nb, h, w, 2)
    mask = T(rng.random((nb, h, w)) > 0.2)
    batched = flow
    for _ in range(params.coarsest_relax_iters_per_phase):
        batched = pixflow.relax_iteration(batched, i0x, i0y, i1g, bf, mask,
                                          params)
    for b in range(nb):
        f = flow[b]
        for _ in range(params.coarsest_relax_iters_per_phase):
            f = pixflow.relax_iteration(f, i0x[b], i0y[b], i1g[b], bf[b],
                                        mask[b], params)
        assert torch.equal(batched[b], f), b
    assert not torch.equal(batched, flow)


@pytest.mark.parametrize("alg", ["pixflow_low", "pixflow_low_fast"])
def test_blend_field_on_a_stack_equals_each_alone(rng, alg):
    """The 8-ray distance fields (strides 1, 3 and 4) and the blend field
    of three canvases at once, at full resolution and decimated by 2."""
    masks = T(rng.random((3, 37, 53)) < 0.05)
    for step in (1, 3, 4):
        got = td.eight_ray_min_distance(masks, step, 20.0)
        for k in range(3):
            assert torch.equal(got[k], td.eight_ray_min_distance(
                masks[k], step, 20.0))
    cfg = StitchConfig(flow_alg=alg)
    cmap = stitcher.match_images(*_pairs(130, 420, (1, 2, 3)))
    blend, merged_dis = stitcher.generate_blend(cmap, cfg)
    assert blend.shape == merged_dis.shape == (3, 130, 420)
    for k in range(3):
        one_blend, one_dis = stitcher.generate_blend(cmap[k], cfg)
        assert torch.equal(blend[k], one_blend)
        assert torch.equal(merged_dis[k], one_dis)


def test_samplers_on_a_stack_equal_each_alone(rng):
    n, h, w = 3, 70, 150
    img = T(rng.integers(0, 256, (n, h, w, 4), dtype=np.uint8))
    flow = T(rng.standard_normal((n, h, w, 2)).astype(np.float32) * 6)
    t = T(rng.random((n, h, w)).astype(np.float32))
    for sampler in (tw.sample_nearest_wrap, tw.sample_nearest_wrap_tiled):
        got = sampler(img, flow, t)
        for k in range(n):
            assert torch.equal(got[k], sampler(img[k], flow[k], t[k]))
    assert torch.equal(tw.sample_nearest_wrap_tiled(img, flow, 0.5)[1],
                       tw.sample_nearest_wrap_tiled(img[1], flow[1], 0.5))


def test_prepare_flows_and_combine_on_stacks():
    """The tiled sampler's canvas size (>= 256 x 512), two pairs."""
    cfg = StitchConfig(flow_alg="pixflow_low_fast")
    ls, rs = _pairs(256, 512, (1, 2))
    cmap = stitcher.match_images(ls, rs)
    ol, orr = (stitcher.extract_overlap(x, cmap) for x in (ls, rs))
    flr, frl = novel_view.prepare_flows(ol, orr, cfg)
    blend, merged_dis = stitcher.generate_blend(cmap, cfg)
    merged = novel_view.combine_novel_views(ol, orr, flr, frl, blend)
    for k in range(2):
        a, b = novel_view.prepare_flows(ol[k], orr[k], cfg)
        assert torch.equal(flr[k], a) and torch.equal(frl[k], b)
        one_blend, one_dis = stitcher.generate_blend(cmap[k], cfg)
        assert torch.equal(blend[k], one_blend)
        assert torch.equal(merged_dis[k], one_dis)
        one = novel_view.combine_novel_views(ol[k], orr[k], a, b, blend[k])
        # tanh and exp may round differently in a vector's tail lanes
        same = (merged[k] == one).float().mean().item()
        assert same > 0.999, same
        assert (merged[k].int() - one.int()).abs().max().item() <= 1


def _batching_gate(got, ref):
    """tests/test_batching.py's gate."""
    same = (got == ref).mean()
    assert same > 0.98, same
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert np.percentile(diff, 99.9) <= 8, diff.max()


@pytest.mark.parametrize("alg", ["pixflow_low", "pixflow_low_fast"])
def test_stitch_pairs_matches_sequential(alg):
    """tests/test_batching.py's case (40 x 96, seeds 1-3) and gate, and
    on the CPU equal bits besides."""
    cfg = StitchConfig(flow_alg=alg)
    ls, rs = _pairs(40, 96, (1, 2, 3))
    outs = pipeline.stitch_pairs(ls, rs, cfg, device="cpu")
    assert outs.shape == (3, 40, 96, 4) and outs.dtype == torch.uint8
    for k in range(3):
        seq = pipeline.stitch_pair(ls[k], rs[k], cfg)
        _batching_gate(to_numpy(outs[k]), to_numpy(seq))
        assert torch.equal(outs[k], seq)


def test_stitch_pairs_matches_jax_vmap():
    """Against jax.vmap(pipeline.stitch_pair) on the same stacks, at the
    gate the two packages are held to for one pair (tests/test_golden.py:
    alpha exact, SSIM >= 0.995, < 1 % of values off by more than 8) and at
    a size where one pair meets it, 96 x 320.  test_batching.py's
    equal-bytes gate is for two runs of one package: at its 40 x 96 the
    port's stitch_pair and JAX's already differ in 0.9-5.4 % of the bytes
    of one pair (strict-< takes on a 20 x 48 flow), batched or not."""
    cfg, jc = StitchConfig(), jcfg.StitchConfig()
    ls, rs = _pairs(96, 320, (1, 2, 3))
    outs = to_numpy(pipeline.stitch_pairs(ls, rs, cfg, device="cpu"))
    vm = np.asarray(jax.jit(jax.vmap(
        lambda a, b: jpl.stitch_pair(a, b, jc)))(
            jnp.asarray(to_numpy(ls)), jnp.asarray(to_numpy(rs))))
    for got, ref in zip(outs, vm):
        np.testing.assert_array_equal(got[..., 3], ref[..., 3])
        assert ssim(got, ref) >= 0.995
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert (diff > 8).mean() < 0.01
        assert (got == ref).mean() > 0.97


def test_stitch_pairs_of_one_pair_is_stitch_pair():
    cfg = with_flow_params(StitchConfig(flow_alg="pixflow_low_fast"),
                           pallas_min_pixels=0)
    ls, rs = _pairs(96, 320, (7,))
    out = pipeline.stitch_pairs(to_numpy(ls), to_numpy(rs), cfg,
                                device="cpu")
    assert torch.equal(out[0], pipeline.stitch_pair(ls[0], rs[0], cfg))
