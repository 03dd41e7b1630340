"""The comparison that decides ``correct``: the port's stitched RGBA
panoramas against the reference's, panorama by panorama.

Numbers, each the worst over the panoramas compared:

* ``footprint_px``: pixels whose alpha footprint (alpha > 0) differs;
  the stitch's footprint is the union of the inputs' on either side, so
  the limit is 0;
* ``mean_abs_diff``: the mean absolute difference over every byte of the
  panorama, RGBA.

The configuration's ``check`` holds the limit of each number compared;
``PERF.md`` gives the readings each limit was set from."""

from __future__ import annotations

import torch


def numbers(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """The numbers of (H, W, 4) or (N, H, W, 4) uint8 panoramas."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise ValueError(f"output {tuple(out.shape)} {out.dtype} against "
                         f"reference {tuple(ref.shape)} {ref.dtype}")
    out = out.reshape((-1,) + out.shape[-3:])
    ref = ref.reshape((-1,) + ref.shape[-3:])
    worst = {"footprint_px": 0, "mean_abs_diff": 0.0}
    for o, r in zip(out, ref):
        diff = (o.to(torch.int16) - r.to(torch.int16)).abs()
        worst["footprint_px"] = max(worst["footprint_px"], int(
            ((o[..., 3] > 0) != (r[..., 3] > 0)).sum()))
        worst["mean_abs_diff"] = max(worst["mean_abs_diff"],
                                     float(diff.double().mean()))
    return worst


def worst_of(readings: list[dict]) -> dict:
    return {k: max(r[k] for r in readings) for k in readings[0]}


def within(values: dict, limits: dict) -> bool:
    return all(values[k] <= limit for k, limit in limits.items())
