"""Score production and the batching engine of the port (CPU scorer)."""

import threading

import numpy as np
import pytest
import torch

from sls_tpu_torch.config import (ExperimentConfig, ModelConfig, SAEConfig, TrainConfig,
                                  tiny_xlsr_config)
from sls_tpu_torch.data.audio import pad_or_tile
from sls_tpu_torch.data.pipeline import ArrayLoader, to_wire
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.scores.writer import log_probs_to_scores, read_score_file
from sls_tpu_torch.serve.engine import BatchingEngine
from sls_tpu_torch.serve.scorer import build_scorer_from_params
from sls_tpu_torch.train.loop import produce_scores
from sls_tpu_torch.train.steps import make_eval_step

CUT = 4000
CFG = ExperimentConfig(
    model=ModelConfig(encoder=tiny_xlsr_config(),
                      sae=SAEConfig(activation_dim=64, dict_size=256, k=32, use_pallas=True)),
    train=TrainConfig(cut_length=CUT),
)


@pytest.fixture(scope="module")
def model():
    return Detector(CFG.model, device="cpu", generator=torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def wavs():
    return np.random.default_rng(0).normal(0, 0.1, (7, CUT)).astype(np.float32)


def test_produce_scores_writes_valid_rows_with_the_contract(model, wavs, tmp_path):
    step = make_eval_step(model, device="cpu")
    loader = ArrayLoader(to_wire(wavs, "int16"), None, batch_size=3)  # tail of 1
    path = tmp_path / "scores.txt"
    assert produce_scores(step, loader, path) == 7
    ids, scores = read_score_file(path)
    assert ids == [f"utt_{i}" for i in range(7)]
    expected = []
    for batch in loader.epoch(0):
        logp = step(batch.wav)["log_probs"]
        expected.append(np.exp(np.minimum(logp.numpy(), 0.0).astype(np.float64))[:, 1][batch.valid])
    np.testing.assert_array_equal(scores, np.concatenate(expected))
    assert np.all((scores >= 0) & (scores <= 1))


def _scorer(model, wire="int16", buckets=(2,)):
    return build_scorer_from_params(CFG, model.state_dict(), batch_size=4, wire_dtype=wire,
                                    device="cpu", bucket_sizes=buckets)


def _offline(score_fn, rows, shape, wire):
    """Scores of ``rows`` at batch ``shape``, the tail filled with row 0
    as the engine does."""
    batch = rows + [rows[0]] * (shape - len(rows))
    return log_probs_to_scores(score_fn(to_wire(np.stack(batch), wire)))[: len(rows)]


def test_engine_answers_partial_bucketed_and_multi_batch(model, wavs):
    _, score_fn, cut = _scorer(model)
    assert cut == CFG.train.cut_length
    rows = [w[: 1000 + 400 * i] for i, w in enumerate(wavs)]  # short clips
    full = [pad_or_tile(r, cut) for r in rows]  # as the engine tiles them
    with BatchingEngine(score_fn, 4, cut=cut, wire_dtype="int16", bucket_sizes=(2,),
                        max_wait_ms=2000) as engine:
        # one request: dispatched on the 2-row bucket
        single = engine.submit(rows[0]).result(timeout=60)
        np.testing.assert_allclose(single, _offline(score_fn, full[:1], 2, "int16")[0],
                                   rtol=0, atol=1e-6)
        # six requests: a full batch of 4, then 2 on the bucket
        futs = [engine.submit(r) for r in rows[1:7]]
        got = np.array([f.result(timeout=60) for f in futs])
        stats = engine.stats()
    want = np.concatenate([_offline(score_fn, full[1:5], 4, "int16"),
                           _offline(score_fn, full[5:7], 2, "int16")])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert stats.requests == 7 and stats.batches == 3


def test_resolved_or_cancelled_future_does_not_kill_worker():
    release = threading.Event()
    dispatched = threading.Event()

    def score_fn(wav):
        dispatched.set()
        release.wait(timeout=30)
        return torch.zeros(len(wav), 2)

    with BatchingEngine(score_fn, 2, cut=16, max_wait_ms=0) as engine:
        a = engine.submit(np.ones(16, np.float32))
        assert dispatched.wait(timeout=30)
        b = engine.submit(np.ones(16, np.float32))
        assert a.cancel()              # the caller gave up while a was on the device
        release.set()
        assert b.result(timeout=30) == 1.0
        dispatched.clear()
        release.clear()
        c = engine.submit(np.ones(16, np.float32))
        assert dispatched.wait(timeout=30)
        c.set_result(0.5)              # resolved elsewhere before the flush
        release.set()
        # the worker survived both: it still answers
        assert engine.submit(np.ones(16, np.float32)).result(timeout=30) == 1.0
        assert c.result() == 0.5
