"""Tiny cells for the CPU tests: the benchmark's own cells with every
size cut, and the program's kernels on their plain CPU forms."""

from __future__ import annotations

import copy
import json

from perfbench.run import ROOT, Cell

TINY_ENCODER = {"conv_dim": [32, 32, 32], "conv_kernel": [10, 3, 2], "conv_stride": [5, 2, 2],
                "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
                "num_hidden_layers": 2, "num_conv_pos_embeddings": 16,
                "num_conv_pos_embedding_groups": 4}
TINY_SAMPLES = 1600  # 79 frames
# each traffic's sizes, cut
TINY_PARAMS = {
    "score_offline": {"batch": 4, "pool": 8, "samples": TINY_SAMPLES, "check_rows": 6},
    "train_epochs": {"batch": 4, "pool": 16, "samples": TINY_SAMPLES},
    "long_unwindowed": {"min_s": 0.1, "max_s": 0.5, "pool": 4, "t_targets": [16, 32, 64],
                        "check_clips": 3},
    "serve_poisson": {"rate_per_s": 400, "batch": 4, "pool": 8, "samples": TINY_SAMPLES,
                      "check_requests": 6},
}


def tiny_config(name: str, dtype: str = "float32") -> dict:
    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
    cfg["encoder"].update(TINY_ENCODER)
    cfg["dtype"] = dtype
    cfg["cut_length"] = TINY_SAMPLES
    if "sae" in cfg:
        cfg["sae"].update(activation_dim=64, dict_size=256, k=16)
    return cfg


def tiny_cell(name: str, params: dict = None, limits: dict = None) -> Cell:
    cell = Cell.load(name, listed=False)
    cell.config = tiny_config(cell.workload["config"])
    cell.workload = copy.deepcopy(cell.workload)
    cell.workload["params"].update(params or TINY_PARAMS[cell.workload["traffic"]])
    if limits:
        cell.workload["limits"].update(limits)
    return cell
