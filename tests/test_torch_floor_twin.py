"""The init-floor twin of the ``_fast`` presets as a stage of its own
(``models/pixflow.py``): ``compute_optical_flow_pairs`` and the row-tiled
``parallel.tiled.tiled_compute_optical_flow_pair`` solve it
(``pixflow._twin_flow_batched``) before the coarsest level, the first
under ``pair.flow_floor_twin``, and hand its flow to that level as its
incoming flow.

On the CPU, at canvases whose flow has a top level above the 64 px floor
(so the twin runs) and whose blend field is computed at half resolution:
the port's ``pixflow_low_fast`` six chain and the flows of N = 2 pairs
equal the benchmark's frozen plain reference (``portbench.reference``,
whose coarsest level solves the twin inside itself) byte for byte.
This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_floor_twin.py -q
"""

import pytest
import torch

from panorama_opticalflow_tpu_torch import StitchConfig
from panorama_opticalflow_tpu_torch.models import pipeline
from panorama_opticalflow_tpu_torch.models import pixflow as pf
from panorama_opticalflow_tpu_torch.utils import runtime
from panorama_opticalflow_tpu_torch.utils.config import with_flow_params

from portbench import inputs
from portbench.reference import config as rconfig
from portbench.reference import pipeline as rpipeline
from portbench.reference import pixflow as rpixflow

torch.set_num_threads(2)
runtime.settle_cpu_math()

ALG = "pixflow_low_fast"
HW = (208, 448)
# the finest level of each flow (104 rows) takes the kernels' plain
# contracts, the levels above it the plain path
KERNEL_MIN = 20000


def _configs():
    return (with_flow_params(StitchConfig(flow_alg=ALG),
                             pallas_min_pixels=KERNEL_MIN),
            rconfig.StitchConfig(flow_alg=ALG, kernel_min_pixels=KERNEL_MIN))


def _assert_twin_runs(flow_hw, params):
    """The flow of ``flow_hw`` has a top level above the raised floor, and
    an init-floor twin below it."""
    sizes = pf.pyramid_sizes(*flow_hw, params)
    assert len(sizes) >= 2 and min(sizes[-1]) > params.pyr_stop_size
    assert pf._sub_floor_sizes(*sizes[-1], params)


def _bits(t):
    return t.view(torch.int32)


def _pairs(n=2):
    sets = [inputs.four_input_set(*HW, inputs.item_rng(2**40 + 17, k),
                                  "cpu") for k in range(n)]
    ls, rs = zip(*(pipeline.compose_four(s) for s in sets))
    return torch.stack(ls), torch.stack(rs)


@pytest.mark.parametrize("entry", ["six chain", "pairs N=2"])
def test_fast_equals_the_frozen_reference(entry):
    port_cfg, ref_cfg = _configs()
    params = port_cfg.flow_params
    assert port_cfg.blend_scale_resolved == 2
    if entry == "six chain":
        photos, top = inputs.fisheye_set(*HW, inputs.item_rng(2**40 + 9, 0),
                                         "cpu")
        windows = pipeline.crop.plan_chain_windows(photos, top, port_cfg)
        assert rpipeline.plan_chain_windows(photos, top, ref_cfg) == windows
        for _, width, _ in windows:
            _assert_twin_runs((HW[0] // 2, width // 2), params)
        want = rpipeline.stitch_six(photos, top, ref_cfg)
        got = pipeline.stitch_six(photos, top, port_cfg, device="cpu")
        assert got.dtype == torch.uint8 and torch.equal(got, want)
        return
    ls, rs = _pairs()
    _assert_twin_runs((HW[0] // 2, ls.shape[2] // 2), params)
    got = pf.compute_optical_flow_pairs(ls, rs, params)
    want = rpixflow.optical_flow_pairs(ls, rs, ref_cfg.flow_params)
    assert got[0].abs().max() > 1.0        # a real flow was solved
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32
        assert torch.equal(_bits(g), _bits(w))

