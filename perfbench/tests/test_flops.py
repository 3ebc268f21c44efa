"""``perfbench/flops.py`` against ``FlopCounterMode`` over the plain
reference at tiny sizes: every product counted, and nothing more."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops, weights
from perfbench.reference import sls, topk_sae
from perfbench.tests.tiny import TINY_SAMPLES, tiny_config

CASES = [("xlsr300m_topk_sae", topk_sae.log_probs), ("xlsr300m_sls", lambda *a: sls.log_probs(*a)[0])]


@pytest.mark.parametrize("samples", [TINY_SAMPLES, 2 * TINY_SAMPLES + 77])
@pytest.mark.parametrize("name,forward", CASES, ids=[c[0] for c in CASES])
def test_forward_flops_match_the_counter(name, forward, samples):
    cfg = tiny_config(name)
    if cfg["family"] == "sls":
        cfg["cut_length"] = samples  # the SLS head's fc1 is sized by the clip
    state = weights.make_state(cfg, 5, torch.device("cpu"))
    wav = torch.randn(3, samples)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        forward(state, cfg, wav)
    assert counter.get_total_flops() == pytest.approx(3 * flops.forward(cfg, samples), rel=1e-12)


def test_train_counts_three_forwards():
    cfg = tiny_config("xlsr300m_sls")
    assert flops.train_step(cfg, TINY_SAMPLES) == 3 * flops.forward(cfg, TINY_SAMPLES)


def test_published_sizes():
    """The flagship's 4-s utterance: 150.5 GFLOP (transformer 125.4,
    front-end 19.8, pos-conv 3.4, SAE encode 1.7, projection 0.2)."""
    import json

    from perfbench.run import ROOT

    cfg = json.loads((ROOT / "perfbench/configs/xlsr300m_topk_sae.json").read_text())
    parts = flops.encoder(cfg["encoder"], 64600)
    assert parts["T"] == 201
    assert parts["layers"] / 1e9 == pytest.approx(125.4, abs=0.1)
    assert parts["frontend"] / 1e9 == pytest.approx(19.8, abs=0.1)
    assert flops.forward(cfg, 64600) / 1e9 == pytest.approx(150.5, abs=0.05)


def test_kernel_rows():
    ops, _ = flops.sae_encode_topk(36 * 201, 1024, 4096)
    assert ops / 1e9 == pytest.approx(60.7, abs=0.05)
    ops, nbytes = flops.attention_long(5120, 1024)
    assert ops / 1e9 == pytest.approx(107.4, abs=0.05) and nbytes == 8 * 5120 * 1024
