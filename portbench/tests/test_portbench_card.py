"""On the card: the control (the reference in float32 with TF32 on, in the
program's place) comes out not correct in each cell while the program is
correct, on the same seeds; and a short run of each cell is correct. Run
with

    python3 -m pytest portbench/tests -m card

from the root of a checkout on a machine with an H100."""

import time

import pytest
import torch

from portbench import check
from portbench import harness as H
from portbench.tests.conftest import manifest

CELLS = [w["name"] for w in manifest()["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes(name):
    dev = _card()
    cell = H.load_cell(name)
    for seed in (7, 8, 9):
        inputs = H.make_inputs(cell, seed, dev)
        eng, probe = H.set_up(cell, inputs, seed, dev)
        steps = H.program_states(eng, probe, inputs)
        del eng, probe
        prog = check.numbers(steps, H.reference_readings(cell, inputs, steps))
        ctl_steps = H.control_states(cell, inputs)
        ctl = check.numbers(ctl_steps, H.reference_readings(cell, inputs, ctl_steps))
        assert check.judge(prog, cell.limits)["correct"], prog
        assert not check.judge(ctl, cell.limits)["correct"], ctl


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_is_correct(name):
    dev = _card()
    out = H.run_cell(H.load_cell(name), 12345, 2.0, False, time.perf_counter(), device=dev)
    assert out["result"]["correct"], out["result"]["check"]
