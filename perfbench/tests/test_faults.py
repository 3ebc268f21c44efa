"""A run with the timed path broken underneath comes out not correct:
each fault that a cell can have (``perfbench/faults.py``), planted in
the program, at tiny size on the CPU (the look for a card skipped; the
rest of the run as on the card, with the cell's own limits)."""

import pytest
import torch

from perfbench import faults
from perfbench import run as harness
from perfbench.tests.test_reference_agrees import CELLS, fp32_cell

SEED = 2 ** 31 + 99
TRAIN = "sls.train_b14"


def run_cell(name):
    return harness.execute(fp32_cell(name), SEED, 1.0, False, torch.device("cpu"))


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_answer_is_caught(name):
    with faults.answers_altered():
        assert not run_cell(name)["correct"]


@pytest.mark.parametrize("name", [c for c in CELLS if "long" not in c])
def test_half_a_batch_left_out_is_caught(name):
    # the long-clip cell scores one clip a forward: no half to leave out
    with faults.half_batch():
        assert not run_cell(name)["correct"]


def test_a_train_step_that_keeps_its_state_is_caught():
    with faults.state_unchanged():
        res = run_cell(TRAIN)
    assert not res["correct"] and res["numbers"]["change_gap"] == pytest.approx(1.0)
