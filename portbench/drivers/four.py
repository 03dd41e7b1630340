"""The 4-input single pass: ``pipeline.stitch_four`` of four wide-angle
photos, composed into two canvases, on the window of their own canvas
map."""

from __future__ import annotations

from panorama_opticalflow_tpu_torch.models import pipeline

from portbench import inputs
from portbench.reference import pipeline as reference_pipeline


def make_pool(config: dict, traffic: dict, seed: int, device) -> list:
    h, w = config["canvas"]
    return [inputs.four_input_set(h, w, inputs.item_rng(seed, k), device)
            for k in range(traffic["pool"])]


def stitch(item, cfg, device):
    return pipeline.stitch_four(item, cfg, device=device)


def panoramas(item) -> int:
    return 1


def reference(item, cfg):
    return reference_pipeline.stitch_four(item, cfg)
