"""Each cell's control comes out not correct, on the card at the cell's
own size (a short window), on three seeds: the reference in float8 in
the program's place (each workload's ``control``).  Skips where there
is no card.

    python -m pytest -m cuda perfbench/tests/test_controls.py
"""

import json

import pytest

from perfbench import run as harness

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (3_100_000_001, 3_100_000_002, 3_100_000_003)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    harness.cache_env()
    cell = harness.Cell.load(name)
    for seed in SEEDS:
        res = harness.execute(cell, seed, 3.0, False, torch.device("cuda", 0),
                              control=cell.workload["control"])
        assert not res["correct"], (seed, res["checks"])
        torch.cuda.reset_peak_memory_stats()
