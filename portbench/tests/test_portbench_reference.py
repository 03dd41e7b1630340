"""The reference against the port on the CPU, where the port runs its
kernels' plain versions: the same bytes, at sizes where the solver's
levels take both the plain level path and (``kernel_min_pixels=0``) the
kernels' contracts, for each entry the cells drive."""

import numpy as np
import pytest
import torch

from panorama_opticalflow_tpu_torch import StitchConfig
from panorama_opticalflow_tpu_torch.models import pipeline
from panorama_opticalflow_tpu_torch.utils.config import with_flow_params

from portbench import inputs
from portbench.reference import config as rconfig
from portbench.reference import pipeline as rpipeline

HW = (128, 448)


def _configs(flow_alg: str, kernel_min: int):
    port = with_flow_params(StitchConfig(flow_alg=flow_alg),
                            pallas_min_pixels=kernel_min)
    return port, rconfig.StitchConfig(flow_alg=flow_alg,
                                      kernel_min_pixels=kernel_min)


@pytest.mark.parametrize("flow_alg,kernel_min", [
    ("pixflow_low", 0), ("pixflow_low_fast", 128 * 512),
    ("pixflow_search_20", 0)])
def test_six_chain_equals_the_port(flow_alg, kernel_min):
    port_cfg, ref_cfg = _configs(flow_alg, kernel_min)
    photos, top = inputs.fisheye_set(*HW, inputs.item_rng(2**40 + 9, 0),
                                     "cpu")
    want = pipeline.stitch_six(photos, top, port_cfg, device="cpu")
    assert rpipeline.plan_chain_windows(photos, top, ref_cfg) == \
        pipeline.crop.plan_chain_windows(photos, top, port_cfg)
    torch.testing.assert_close(rpipeline.stitch_six(photos, top, ref_cfg),
                               want, rtol=0, atol=0)


@pytest.mark.parametrize("kernel_min", [0, 128 * 512])
def test_four_and_batched_pairs_equal_the_port(kernel_min):
    port_cfg, ref_cfg = _configs("pixflow_low", kernel_min)
    sets = [inputs.four_input_set(*HW, inputs.item_rng(31, k), "cpu")
            for k in range(3)]
    torch.testing.assert_close(rpipeline.stitch_four(sets[0], ref_cfg),
                               pipeline.stitch_four(sets[0], port_cfg,
                                                    device="cpu"),
                               rtol=0, atol=0)
    ls, rs = zip(*[pipeline.compose_four(s) for s in sets])
    want = pipeline.stitch_pairs(torch.stack(ls), torch.stack(rs), port_cfg,
                                 device="cpu")
    rls, rrs = zip(*[rpipeline.compose_four(s) for s in sets])
    got = rpipeline.stitch_pairs(torch.stack(rls), torch.stack(rrs), ref_cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_bfloat16_reference_runs_and_differs():
    _, ref_cfg = _configs("pixflow_low", 128 * 512)
    low = rconfig.StitchConfig(flow_alg="pixflow_low", dtype=torch.bfloat16)
    photos = inputs.four_input_set(*HW, np.random.default_rng(4), "cpu")
    a = rpipeline.stitch_four(photos, ref_cfg)
    b = rpipeline.stitch_four(photos, low)
    assert a.dtype == b.dtype == torch.uint8
    assert torch.equal(a[..., 3] > 0, b[..., 3] > 0)
    assert not torch.equal(a, b)
