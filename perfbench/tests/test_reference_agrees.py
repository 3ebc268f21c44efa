"""The plain reference against the program at tiny sizes on seeded
weights, on the CPU: every cell's run, with the program at float32 and
its kernels off (``use_pallas``), agrees with the reference far inside
the cell's limits; the tiny runs go through the harness as a chip run
does."""

import pytest
import torch

from perfbench import run as harness
from perfbench.tests.tiny import tiny_cell

# float32 on both sides: what is left is the order of sums, the
# fast-variance LayerNorm of the program and the classifier's LayerNorm
# epsilon (1e-6 in the program, torch's 1e-5 in the published head)
AGREE = {"logp_gap": 1e-3, "logp_rms": 1e-3, "logp_env": 0.5, "loss_gap": 1e-5,
         "grad1_gap": 1e-4, "change_gap": 1e-3, "loss_env": 0.5}
CELLS = ["topk_sae.score_4s", "sls.train_b14", "topk_sae.long_26-102s", "sls.serve_4s"]


def fp32_cell(name):
    cell = tiny_cell(name)
    cell.config["use_pallas"] = False
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_reference(name):
    res = harness.execute(fp32_cell(name), 1234567891011, 1.0, False, torch.device("cpu"))
    assert res["correct"]
    for key, value in res["numbers"].items():
        if key in AGREE:
            assert value <= AGREE[key], (key, value)
    assert res["attempted"] > 0 and res["failed"] == 0
