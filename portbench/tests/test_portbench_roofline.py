"""The kernels' work counted from their shapes, and the bound it gives.

The expected numbers are the port's kernel table (PERF.md section 6):
at (2, 2000, 1792) the warp's bound is 0.051 ms, by bytes, and the fused
relax phase's 0.111 ms, by operations (0.222 at half the float32 peak)."""

import pytest

from portbench import roofline


def test_operation_counts_per_pixel():
    assert roofline.WARP_OPS == 54
    assert roofline.RELAX_OPS_PER_ITER == 306


def test_warp_work_at_the_headline_level():
    nbytes, ops = roofline.warp_work(2, 2000, 1792)
    px = 2 * 2000 * 1792
    tiles = 32 * 14                       # ceil(2000/64) x ceil(1792/128)
    assert nbytes == 4 * (6 * px + 2 * 2 * tiles)
    assert ops == 54 * px
    assert roofline.bound_seconds(nbytes, ops) == pytest.approx(
        nbytes / 3.35e12)
    assert roofline.bound_seconds(nbytes, ops) * 1e3 == pytest.approx(
        0.051, abs=5e-4)


def test_relax_work_at_the_headline_level():
    nbytes, ops = roofline.relax_work(2, 2000, 1792, 3, 15)
    px = 2 * 2000 * 1792
    assert nbytes == 4 * 11 * px
    assert ops == (3 * 306 + 2 * 2 * 15 * 2) * px
    assert roofline.bound_seconds(nbytes, ops) == pytest.approx(ops / 67e12)
    assert roofline.bound_seconds(nbytes, ops) * 1e3 == pytest.approx(
        0.111, abs=5e-4)


def test_the_four_input_level_scales_with_its_pixels():
    six = roofline.relax_work(2, 2000, 1792, 3, 15)[1]
    four = roofline.relax_work(2, 2000, 4950, 3, 15)[1]
    assert four / six == pytest.approx(4950 / 1792)


def test_no_share_off_the_card():
    import torch

    assert roofline.kernel_share("relax_phase", (2, 64, 64), "pixflow_low",
                                 0, torch.device("cpu")) is None


@pytest.mark.parametrize("kernel", ["relax_phase", "warp_tiled"])
def test_share_on_the_card_is_a_share(card, kernel):
    share = roofline.kernel_share(kernel, (2, 2000, 4950), "pixflow_low",
                                  2**40 + 5, card)
    assert 0 < share < 100
