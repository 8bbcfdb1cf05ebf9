"""The check that decides ``correct``, driven through a whole run on the
CPU with the timed path broken underneath: each fault a cell can have
comes out not correct under the cell's own limits, and the control (the
reference computed in TF32 in the program's place) reads above them.

The faults run in float64 at width 0.25, 16 x 16, batch 4, where the sound
program reads rounding alone, so that the same run unbroken comes out
correct; the control runs in float32, the precision it is the control of.
At the cell's own size on the card ``perfbench/control.py`` gives the
readings the limits were set from (``test_control_on_card``)."""

import json

import pytest
import torch

from perfbench import compare, faults
from perfbench.run import run

from .conftest import small_cell

CELLS = ["resnet50-train-bs256", "resnet18-train-bs512", "resnet50-infer-bs512"]


def _result(cell, capsys, program=None, seed=2**31 + 3):
    assert run(cell, seed, 0.2, False, "cpu", program=program) == 0
    return json.loads(capsys.readouterr()[0].strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload, float64, capsys):
    line = _result(small_cell(workload), capsys)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault, float64, capsys):
    line = _result(small_cell(workload), capsys, faults.FAULTS[fault])
    assert not line["correct"], line["checks"]


# the number that the control fails on the card, by cell
CONTROL_FAILS = {"resnet50-train-bs256": "grad_gap", "resnet18-train-bs512": "grad_gap",
                 "resnet50-infer-bs512": "logits_gap"}


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, capsys):
    cell = small_cell(workload, hw=32, bs=16) if "train" in workload else small_cell(workload)
    line = _result(cell, capsys, faults.reference_program("tf32"))
    assert not line["correct"]
    number = line["checks"][CONTROL_FAILS[workload]]
    assert number["value"] > 2 * number["limit"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_card(workload, card):
    """At the cell's own size: the program is correct, the control not."""
    from perfbench import spec
    from perfbench.control import readings

    cell = spec.resolve(workload)
    ok, _ = compare.verdict(readings(cell, 2**31 + 99, "program", card, 64), cell.limits)
    bad, checks = compare.verdict(readings(cell, 2**31 + 99, "control", card, 64), cell.limits)
    assert ok and not bad, checks
    torch.cuda.empty_cache()
