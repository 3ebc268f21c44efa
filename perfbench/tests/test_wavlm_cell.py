"""The cell ``wavlm_sae.long_26-102s`` at tiny size on the CPU: its run
agrees with the plain reference (``reference/wavlm.py``) and fails its
check with the bias dropped or its gate held at 1; ``flops.forward`` of
the WavLM family counts what ``FlopCounterMode`` counts over the
reference; the biased kernel's roofline reader counts the work by hand.

``bias_dropped`` and ``gate_at_one`` plant the two faults in the program,
as ``perfbench/faults.py``'s do; a chip run of the cell reads them at
full size through ``harness.execute``."""

from contextlib import contextmanager
from unittest import mock

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops, weights
from perfbench import run as harness
from perfbench.families import wavlm_topk_sae
from perfbench.layer_metrics import attention_relpos_roofline
from perfbench.reference import wavlm
from perfbench.tests.test_reference_agrees import AGREE, fp32_cell
from perfbench.tests.tiny import TINY_SAMPLES, tiny_config

CELL = "wavlm_sae.long_26-102s"
SEED = 2 ** 31 + 123
AGREE_SEED = 1234567891011
# small buckets at the tiny frame counts (16-64), so that every branch of
# the bucket function runs
SMALL_BUCKETS = {"num_buckets": 32, "max_bucket_distance": 64}


def _gate(value):
    @contextmanager
    def planted():
        from sls_tpu_torch.encoder.xlsr import SelfAttention

        orig = SelfAttention.relpos_gate
        with mock.patch.object(SelfAttention, "relpos_gate",
                               lambda self, x: torch.full_like(orig(self, x), value)):
            yield

    return planted


# every layer's bias left out (a zero gate), and every gate held at 1
bias_dropped = _gate(0.0)
gate_at_one = _gate(1.0)


def tiny_cell(limits=None):
    cell = fp32_cell(CELL)
    cell.config["encoder"].update(SMALL_BUCKETS)
    if limits:
        cell.workload["limits"].update(limits)
    return cell


def test_cell_agrees_with_reference():
    """At ``test_reference_agrees.py``'s seed.  A clip's log-probability
    can jump at a top-k near-tie: at ``SEED`` two frames' supports flip
    between program and reference while their features agree to 8e-7,
    which moves one clip by 0.005 and the gap past ``AGREE``'s 1e-3."""
    res = harness.execute(tiny_cell(), AGREE_SEED, 1.0, False, torch.device("cpu"))
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    for key, value in res["numbers"].items():
        assert value <= AGREE[key], (key, value)


@pytest.mark.parametrize("fault", [bias_dropped, gate_at_one], ids=["bias_dropped", "gate_at_one"])
def test_a_fault_in_the_bias_is_caught(fault):
    """At tiny size the sound run agrees within ``AGREE`` (1e-5 to 1e-4);
    the faults move the log-probabilities by 0.03 to 0.1 there, about the
    cell's own limit, so the check is held at ``AGREE``'s bound (at full
    size, at the cell's own limit: PERF.md)."""
    with fault():
        res = harness.execute(tiny_cell({"logp_rms": AGREE["logp_rms"]}), SEED, 1.0, False,
                              torch.device("cpu"))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("samples", [TINY_SAMPLES, 2 * TINY_SAMPLES + 77])
def test_forward_flops_match_the_counter(samples):
    cfg = tiny_config("wavlm_large_topk_sae")
    cfg["encoder"].update(SMALL_BUCKETS)
    state = wavlm_topk_sae.prepared(weights.make_state(cfg, 5, torch.device("cpu")), cfg)
    wav = torch.randn(3, samples)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        wavlm.log_probs(state, cfg, wav)
    assert counter.get_total_flops() == pytest.approx(3 * flops.forward(cfg, samples), rel=1e-12)


def test_relpos_roofline_work_at_t5120():
    ops, nbytes, exps = attention_relpos_roofline.work(5120, 1024, 16)
    assert ops == 4 * 5120 ** 2 * 1024 + 2 * 5120 ** 2 * 16 == 108_213_043_200
    assert nbytes == 2 * 4 * 5120 * 1024 + 4 * 16 * 5120 + 4 * 16 * 10239 == 42_926_016
    assert exps == 16 * 5120 ** 2 == 419_430_400
    # the products bind: 0.1094 ms at 989 TFLOP/s
    assert attention_relpos_roofline.least_seconds(5120, 1024, 16) == pytest.approx(
        108_213_043_200 / 989e12)
