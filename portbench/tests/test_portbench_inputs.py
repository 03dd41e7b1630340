"""The device-side input rigs against the port's numpy originals, on the
CPU: the same draws in the same order give the same bytes."""

import numpy as np
import pytest

from panorama_opticalflow_tpu_torch.utils.data import (
    synthesize_fisheye_set, synthesize_four_input_set)

from portbench import inputs


@pytest.mark.parametrize("hw,seed", [((96, 320), 0), ((128, 448), 7),
                                     ((150, 333), 2**33 + 1)])
def test_fisheye_set_equals_the_original(hw, seed):
    want_photos, want_top = synthesize_fisheye_set(*hw, seed=seed)
    photos, top = inputs.fisheye_set(*hw, np.random.default_rng(seed), "cpu")
    for want, got in zip(want_photos + [want_top], photos + [top]):
        np.testing.assert_array_equal(got.numpy(), want)


def test_four_input_set_equals_the_original():
    want = synthesize_four_input_set(100, 360, seed=3)
    got = inputs.four_input_set(100, 360, np.random.default_rng(3), "cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


def test_sets_differ_by_seed_and_item_but_share_the_footprint():
    a, _ = inputs.fisheye_set(64, 256, inputs.item_rng(2**40, 0), "cpu")
    b, _ = inputs.fisheye_set(64, 256, inputs.item_rng(2**40, 1), "cpu")
    c, _ = inputs.fisheye_set(64, 256, inputs.item_rng(2**40 + 1, 0), "cpu")
    again, _ = inputs.fisheye_set(64, 256, inputs.item_rng(2**40, 0), "cpu")
    for x, y, z, w in zip(a, b, c, again):
        assert (x[..., 3] == y[..., 3]).all() and (x[..., 3] == z[..., 3]).all()
        assert not (x == y).all() and not (x == z).all()
        assert (x == w).all()
