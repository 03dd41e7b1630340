"""The control of the check: the reference computed in bfloat16, the
precision below the configurations' float32, put in the program's place,
has to come out as not correct under each configuration's limits, while
the program itself comes out correct.  On the CPU at a small size; on
the card at the four-input repeat cell's own size (``portbench/calibrate.py``
gives the readings at every cell's size, on a dozen seeds)."""

import pytest
import torch

from portbench import calibrate, compare, harness

SEEDS = [2**40 + 1, 2**40 + 2, 2**40 + 3]


def _readings(name, device, canvas=None, sync=lambda: None):
    cell = harness.load_cell(name)
    if canvas is not None:
        cell.config["canvas"] = canvas
    rows = list(calibrate.readings(cell, SEEDS, SEEDS, device, sync))
    return cell.config["check"], rows


def _hold(limits, rows):
    program = [r for r in rows if r["side"] == "program"]
    control = [r for r in rows if r["side"] == "control"]
    assert len(program) == len(control) == len(SEEDS)
    for r in program:
        assert compare.within(r, limits), r
    for r in control:
        assert not compare.within(r, limits), r


@pytest.mark.parametrize("name", ["six_low.repeat", "four_low.repeat",
                                  "four_low.batch4"])
def test_control_fails_and_program_holds_on_the_cpu(name):
    _hold(*_readings(name, torch.device("cpu"), canvas=[128, 448]))


def test_control_fails_and_program_holds_on_the_card(card):
    _hold(*_readings("four_low.repeat", card, sync=torch.cuda.synchronize))
