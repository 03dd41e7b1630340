"""Several 4-input panoramas a call: ``pipeline.compose_four`` of each
set, then ``pipeline.stitch_pairs`` on the (N, H, W, 4) stacks, one
pyramid descent for every flow of the call."""

from __future__ import annotations

import torch

from panorama_opticalflow_tpu_torch.models import pipeline

from portbench import inputs
from portbench.reference import pipeline as reference_pipeline


def make_pool(config: dict, traffic: dict, seed: int, device) -> list:
    h, w = config["canvas"]
    n = traffic["panoramas_per_call"]
    return [[inputs.four_input_set(h, w, inputs.item_rng(seed, k * n + j),
                                   device) for j in range(n)]
            for k in range(traffic["pool"])]


def _stacks(canvases):
    ls, rs = zip(*canvases)
    return torch.stack(ls), torch.stack(rs)


def stitch(item, cfg, device):
    ls, rs = _stacks([pipeline.compose_four(s) for s in item])
    return pipeline.stitch_pairs(ls, rs, cfg, device=device)


def panoramas(item) -> int:
    return len(item)


def reference(item, cfg):
    ls, rs = _stacks([reference_pipeline.compose_four(s) for s in item])
    return reference_pipeline.stitch_pairs(ls, rs, cfg)
