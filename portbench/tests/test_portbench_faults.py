"""Whole runs on the CPU at a small size, past the harness's look for a
card, with the timed path sound and then broken underneath: ``correct``
holds for the sound one and comes out false for each fault a cell can
have (a stitch that returns its state unchanged; half of a batch left
out, the other half standing for it; an answer altered where it is
produced).  A cell has no exchange between chips to leave out."""

import time

import pytest
import torch

from panorama_opticalflow_tpu_torch.models import novel_view, pipeline

from portbench import harness

SMALL = [128, 448]
CELLS = ["six_low.repeat", "four_low.repeat", "four_low.batch4"]


def _run(name: str, **traffic):
    cell = harness.load_cell(name)
    cell.config["canvas"] = SMALL
    cell.traffic.update(traffic)
    result, compared = harness.run_cell(cell, 2**40 + 77, 0.01, False,
                                        torch.device("cpu"),
                                        time.perf_counter())
    assert result["attempted"] >= 1
    return result, compared


def _unchanged(monkeypatch):
    """A pair's stitch hands back the panorama so far (its right
    canvas)."""
    for body in ("_stitch_pair_windowed_body", "_stitch_pair_full_body"):
        monkeypatch.setattr(pipeline, body,
                            lambda image_l, image_r, *a, **k: image_r.clone())


def _half_batch(monkeypatch):
    """A batch stitched by its first half; the second half repeats it."""
    real = pipeline._stitch_pair_full_body

    def half(image_l, image_r, cfg):
        n = image_l.shape[0]
        out = real(image_l[: n // 2], image_r[: n // 2], cfg)
        return torch.cat([out, out])[:n]

    monkeypatch.setattr(pipeline, "_stitch_pair_full_body", half)


def _altered(monkeypatch):
    """The merged novel view of the first panorama altered where it is
    made: its colours brightened by 24 levels."""
    real = novel_view.combine_novel_views

    def altered(*args):
        out = real(*args).clone()
        first = out if out.dim() == 3 else out[0]
        first[..., :3] = torch.clamp(first[..., :3].to(torch.int16) + 24,
                                     max=255).to(torch.uint8)
        return out

    monkeypatch.setattr(novel_view, "combine_novel_views", altered)


FAULTS = {"unchanged": _unchanged, "altered": _altered,
          "half_batch": _half_batch}


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result, compared = _run(name)
    assert result["correct"], compared
    assert result["failed"] == 0


@pytest.mark.parametrize("name,fault", [
    (c, f) for c in CELLS for f in FAULTS
    if f != "half_batch" or c == "four_low.batch4"])
def test_a_fault_makes_the_run_incorrect(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    result, compared = _run(name)
    assert not result["correct"], compared
    assert result["failed"] > 0
