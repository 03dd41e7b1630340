"""The 6-input chain: ``pipeline.stitch_six`` of five photos around and a
top cap, with the crop windows planned (``use_crop``)."""

from __future__ import annotations

from panorama_opticalflow_tpu_torch.models import pipeline

from portbench import inputs
from portbench.reference import pipeline as reference_pipeline


def make_pool(config: dict, traffic: dict, seed: int, device) -> list:
    h, w = config["canvas"]
    return [inputs.fisheye_set(h, w, inputs.item_rng(seed, k), device,
                               n=config["photos"],
                               overlap_frac=config["overlap_frac"])
            for k in range(traffic["pool"])]


def stitch(item, cfg, device):
    photos, top = item
    return pipeline.stitch_six(photos, top, cfg, device=device)


def panoramas(item) -> int:
    return 1


def reference(item, cfg):
    photos, top = item
    return reference_pipeline.stitch_six(photos, top, cfg)
