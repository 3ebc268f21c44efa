"""Long-clip evaluation in the port against the JAX package: window
extraction and length buckets, full-utterance, streamed and unwindowed
scoring, the joint scoring + stability pass and the EER, on shared
weights with tiny configs; and the engine's long-clip window API.

The reference's streamed scorer drops the windows of its last, short
batch (``sls_tpu/evaluation/overlap.py:290-292``), so the port's is held
to its own ``score_full_utterance`` clip by clip, and to the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sls_tpu import config as jcfg
from sls_tpu.evaluation import overlap as jov
from sls_tpu.metrics.eer import compute_eer as jax_compute_eer
from sls_tpu.models.detector import Detector as JaxDetector
from sls_tpu_torch import config as tcfg
from sls_tpu_torch.convert import detector_state_from_flax
from sls_tpu_torch.data.pipeline import ArrayLoader
from sls_tpu_torch.evaluation import overlap as tov
from sls_tpu_torch.metrics.eer import compute_det_curve, compute_eer
from sls_tpu_torch.models.detector import Detector

WAV_LEN = 1000  # 49 frames with the tiny conv stack
SCORE_TOL = 1e-4  # P(bonafide) through fp32 encoders summing in other orders


def _configs(variant="per_timestep", **enc):
    sae = dict(activation_dim=64, dict_size=256, k=32, variant=variant, window_size=8)
    return (jcfg.ModelConfig(encoder=jcfg.tiny_xlsr_config(**enc),
                             sae=jcfg.SAEConfig(**sae), classifier_hidden=32),
            tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(**enc),
                             sae=tcfg.SAEConfig(**sae), classifier_hidden=32))


@pytest.fixture(scope="module")
def params():
    """Tiny JAX Detector params, perturbed so that no bias or norm is
    trivial; the tree is the same for every SAE variant and attention
    route."""
    j, _ = _configs()
    p = JaxDetector(j).init(jax.random.PRNGKey(0), jnp.zeros((2, WAV_LEN)))["params"]
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), p)


def _pair(params, variant="per_timestep", **enc):
    j, t = _configs(variant, **enc)
    port = Detector(t, device="cpu")
    port.load_state_dict(detector_state_from_flax(params), strict=True)
    return JaxDetector(j), port


def _clips(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(f"u{i}", rng.normal(0, 0.1, n).astype(np.float32)) for i, n in enumerate(lengths)]


# -- pure parts ---------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 600, 1000, 1001, 2600, 4100, 10000])
@pytest.mark.parametrize("stride", [None, 300, 500])
def test_extract_windows_matches_jax(n, stride):
    wav = np.random.default_rng(n).normal(size=n).astype(np.float32)
    got = tov.extract_windows(wav, window=1000, stride=stride)
    np.testing.assert_array_equal(got, jov.extract_windows(wav, window=1000, stride=stride))


@pytest.mark.parametrize("which", ["tiny", "full"])
def test_length_buckets_match_jax(which):
    if which == "tiny":
        j, t = jcfg.tiny_xlsr_config(), tcfg.tiny_xlsr_config()
    else:
        j, t = jcfg.XLSRConfig(), tcfg.XLSRConfig()
    got = tov.length_buckets(t)
    assert got == jov.length_buckets(j)
    for frames, samples in got.items():
        assert t.num_frames(samples) == frames
    if which == "full":
        assert got == {256: 82016, 512: 163936, 1280: 409696, 2560: 819296, 5120: 1638496}


def test_compute_eer_matches_jax():
    rng = np.random.default_rng(0)
    for n_t, n_n in ((50, 80), (7, 3), (200, 200)):
        tar = rng.normal(1.0, 1.0, n_t)
        non = np.round(rng.normal(0.0, 1.0, n_n), 1)  # ties in the pooled scores
        assert compute_eer(tar, non) == jax_compute_eer(tar, non)
        frr, far, thr = compute_det_curve(tar, non)
        assert len(frr) == len(far) == len(thr) == n_t + n_n + 1


@pytest.mark.parametrize("window,overlap", [(8, True), (8, False), (3, True)])
def test_temporal_stability_matches_jax(window, overlap):
    from sls_tpu.analysis import temporal as jtemp
    from sls_tpu_torch.analysis import temporal as ttemp

    rng = np.random.default_rng(window)
    codes = rng.random((3, 40, 32)) * (rng.random((3, 40, 32)) < 0.2)
    codes[0, 5:9] = 0  # frames with no active code: Jaccard 1 by definition
    np.testing.assert_array_equal(ttemp.jaccard_consecutive(codes),
                                  jtemp.jaccard_consecutive(codes))
    assert ttemp.mean_temporal_jaccard(codes) == jtemp.mean_temporal_jaccard(codes)
    assert (ttemp.boundary_discontinuity(codes, window, overlap=overlap)
            == jtemp.boundary_discontinuity(codes, window, overlap=overlap))


def test_unwindowed_batch_rows_and_buckets():
    buckets = tov.length_buckets(tcfg.tiny_xlsr_config(), t_targets=(64, 128))
    small, big = buckets[64], buckets[128]
    rows, t = tov.unwindowed_batch(np.arange(10, dtype=np.float32), buckets)
    assert rows.shape == (1, small) and t == 64
    np.testing.assert_array_equal(rows[0, 10:20], np.arange(10))  # repeat-tiled
    rows, t = tov.unwindowed_batch(np.ones(small + 1, np.float32), buckets)
    assert rows.shape == (1, big) and t == 128
    rows, t = tov.unwindowed_batch(np.ones(2 * big + 5, np.float32), buckets)
    assert rows.shape == (3, big) and t == 128  # chunked at the largest bucket


# -- scoring against the JAX package ------------------------------------------


def test_score_full_utterance_matches_jax(params):
    jmodel, port = _pair(params)
    wav = np.random.default_rng(1).normal(0, 0.1, 3500).astype(np.float32)
    for aggregate in ("mean", "min", "max"):
        ref = jov.score_full_utterance(jmodel, params, wav, window=WAV_LEN, stride=500,
                                       batch_size=4, aggregate=aggregate)
        got = tov.score_full_utterance(port, wav, window=WAV_LEN, stride=500, batch_size=4,
                                       aggregate=aggregate, device="cpu")
        assert got["n_windows"] == ref["n_windows"] == 6
        np.testing.assert_allclose(got["window_scores"], ref["window_scores"], rtol=0,
                                   atol=SCORE_TOL)
        assert got["score"] == pytest.approx(ref["score"], abs=SCORE_TOL)
    with pytest.raises(ValueError, match="aggregate"):
        tov.score_full_utterance(port, wav, window=WAV_LEN, aggregate="median", device="cpu")


def test_streamed_scores_every_clip_with_a_short_last_batch(params):
    """22 windows in batches of 4: the last batch holds 2.  Every clip
    yields its score, in submission order, equal to the port's own
    full-utterance score and to the JAX one."""
    jmodel, port = _pair(params)
    clips = _clips(0, [600, 1000, 2600, 4100, 1500, 3000])
    n_windows = [len(tov.extract_windows(w, WAV_LEN, 500)) for _, w in clips]
    assert sum(n_windows) % 4 == 2
    got = list(tov.score_utterances_streamed(port, iter(clips), window=WAV_LEN, stride=500,
                                             batch_size=4, device="cpu"))
    assert [u for u, _ in got] == [u for u, _ in clips]
    for (utt, wav), (_, score) in zip(clips, got):
        own = tov.score_full_utterance(port, wav, window=WAV_LEN, stride=500, batch_size=4,
                                       device="cpu")
        # the same rows through the same shapes: only the batch neighbours differ
        assert score == pytest.approx(own["score"], abs=1e-6)
        ref = jov.score_full_utterance(jmodel, params, wav, window=WAV_LEN, stride=500,
                                       batch_size=4)
        assert score == pytest.approx(ref["score"], abs=SCORE_TOL)
        assert 0.0 <= score <= 1.0


def test_score_utterances_unwindowed_matches_jax(params, monkeypatch):
    """Buckets, order and chunking as the reference, with the 256-frame
    bucket through the long-T attention route (flash_long_t 256): in the
    port its plain version, in JAX the Pallas kernel in interpret mode."""
    import sls_tpu_torch.encoder.xlsr as txlsr

    jmodel, port = _pair(params, flash_long_t=256)
    enc_j, enc_t = jmodel.config.encoder, port.config.encoder
    calls = []
    fn = txlsr.flash_attention_long
    monkeypatch.setattr(txlsr, "flash_attention_long",
                        lambda *a, **kw: calls.append(a[0].shape[1]) or fn(*a, **kw))
    buckets = tov.length_buckets(enc_t, t_targets=(64, 256))
    clips = _clips(5, [800, buckets[64] + 1, 2 * buckets[256] + 100])
    targets = (64, 256)
    ref = list(jov.score_utterances_unwindowed(jmodel, params, iter(clips), enc_j,
                                               t_targets=targets))
    got = []
    for utt, score, t in tov.score_utterances_unwindowed(port, iter(clips), enc_t,
                                                         t_targets=targets, device="cpu"):
        got.append((utt, score, t, len(calls)))
    assert [(u, t) for u, _, t, _ in got] == [(u, t) for u, _, t in ref] == [
        ("u0", 64), ("u1", 256), ("u2", 256)]
    for (_, s, _, _), (_, r, _) in zip(got, ref):
        assert s == pytest.approx(r, abs=SCORE_TOL)
    # two layers a forward on the 256-frame bucket, none on the 64-frame one
    assert [n for *_, n in got] == [0, 2, 4]
    assert set(calls) == {256}


def test_unwindowed_exact_bucket_equals_direct_forward(params):
    _, port = _pair(params)
    size = tov.length_buckets(port.config.encoder, t_targets=(64,))[64]
    wav = np.random.default_rng(7).normal(0, 0.1, size).astype(np.float32)
    ((_, score, t),) = tov.score_utterances_unwindowed(
        port, [("u", wav)], port.config.encoder, t_targets=(64,), device="cpu")
    with torch.inference_mode():
        direct = float(port(torch.from_numpy(wav[None]))["score"][0])
    assert t == 64
    assert score == pytest.approx(direct, abs=1e-6)


def test_unwindowed_sequence_parallel_not_ported(params):
    """Sequence-parallel scoring is ported (tests/test_torch_sequence_parallel.py
    holds it to the reference); what still raises is a model built without
    ``sp_model_config``, with the reference's error.  A one-rank mesh
    scores as the unsharded program does."""
    from sls_tpu_torch.models.detector import Detector
    from sls_tpu_torch.parallel.sequence import sp_mesh, sp_model_config

    _, port = _pair(params)
    clips = [("u", np.random.default_rng(9).normal(0, 0.1, 900).astype(np.float32))]
    with pytest.raises(ValueError, match="build the config with sp_model_config"):
        next(tov.score_utterances_unwindowed(port, clips, port.config.encoder,
                                             sp_mesh=sp_mesh(1), device="cpu"))
    sp_port = Detector(sp_model_config(port.config), device="cpu")
    sp_port.load_state_dict(port.state_dict())
    ((_, ref, t_ref),) = tov.score_utterances_unwindowed(
        port, clips, port.config.encoder, t_targets=(64,), device="cpu")
    ((_, got, t_got),) = tov.score_utterances_unwindowed(
        sp_port, clips, port.config.encoder, t_targets=(64,), sp_mesh=sp_mesh(1),
        device="cpu")
    assert (got, t_got) == (ref, t_ref)


@pytest.fixture(scope="module")
def stability_case(params):
    from sls_tpu.data.pipeline import ArrayLoader as JaxArrayLoader

    jmodel, port = _pair(params, variant="window_overlap")
    rng = np.random.default_rng(0)
    wav = rng.normal(0, 0.1, (20, WAV_LEN)).astype(np.float32)
    ids = [f"U{i}" for i in range(20)]
    labels = {u: i % 2 for i, u in enumerate(ids)}
    ref = jov.overlap_stability_eval(jmodel, params, JaxArrayLoader(wav, None, utt_ids=ids,
                                                                    batch_size=8),
                                     window=8, labels=labels)
    return port, wav, ids, labels, ref


def test_overlap_stability_eval_matches_jax(stability_case):
    port, wav, ids, labels, ref = stability_case
    got = tov.overlap_stability_eval(port, ArrayLoader(wav, None, utt_ids=ids, batch_size=8),
                                     window=8, labels=labels, device="cpu")
    assert got["num_samples"] == ref["num_samples"] == 20
    assert list(got["scores"]) == list(ref["scores"]) == ids
    np.testing.assert_allclose([got["scores"][u] for u in ids], [ref["scores"][u] for u in ids],
                               rtol=0, atol=SCORE_TOL)
    # the stability statistics count active codes: a support flip at a
    # near-tie moves them by about 1e-5
    for key in ("mean_jaccard", "interior", "boundary"):
        assert got["temporal_stability"][key] == pytest.approx(
            ref["temporal_stability"][key], abs=1e-3)
    bona = [got["scores"][u] for u in ids if labels[u] == 1]
    spoof = [got["scores"][u] for u in ids if labels[u] == 0]
    assert got["eer_pct"] == 100.0 * jax_compute_eer(np.array(bona), np.array(spoof))[0]
    assert got["eer_pct"] == pytest.approx(ref["eer_pct"], abs=100.0 / 10)  # one rank swap


def test_overlap_stability_eval_never_overruns_max_samples(stability_case):
    port, wav, ids, _, _ = stability_case
    for max_samples in (5, 8, 12):
        got = tov.overlap_stability_eval(
            port, ArrayLoader(wav, None, utt_ids=ids, batch_size=8), window=8,
            max_samples=max_samples, device="cpu")
        assert got["num_samples"] == max_samples
        assert list(got["scores"]) == ids[:max_samples]


def test_scoring_step_returns_score_and_active_mask(params):
    _, port = _pair(params)
    wav = np.random.default_rng(2).normal(0, 0.1, (2, WAV_LEN)).astype(np.float32)
    out = tov.make_scoring_step(port, device="cpu")(wav)
    with torch.inference_mode():
        full = port(torch.from_numpy(wav))
    assert torch.equal(out["score"], full["score"])
    assert out["active"].dtype == torch.bool
    assert torch.equal(out["active"], full["codes"] > 0)


# -- serving long clips --------------------------------------------------------


def test_engine_score_long_equals_score_full_utterance(params):
    from sls_tpu_torch.serve.engine import BatchingEngine
    from sls_tpu_torch.serve.scorer import build_scorer_from_params

    _, port = _pair(params)
    exp = tcfg.ExperimentConfig(model=port.config,
                                train=tcfg.TrainConfig(cut_length=WAV_LEN))
    _, score_fn, _ = build_scorer_from_params(exp, port.state_dict(), batch_size=4,
                                              wire_dtype="float32", device="cpu")
    clips = [w for _, w in _clips(3, [300, 2600, 4100])]
    with BatchingEngine(score_fn, 4, cut=WAV_LEN, max_wait_ms=1000) as engine:
        assert len(engine.submit_windows(clips[1], stride=500)) == len(
            tov.extract_windows(clips[1], WAV_LEN, 500))
        for wav in clips:
            for aggregate in ("mean", "min"):
                got, n = engine.score_long(wav, aggregate=aggregate, timeout=60)
                want = tov.score_full_utterance(port, wav, window=WAV_LEN, batch_size=4,
                                                aggregate=aggregate, device="cpu")
                assert n == want["n_windows"]
                # per-row forwards: the pad rows of a short batch do not move the others
                assert got == pytest.approx(want["score"], abs=1e-6)
        with pytest.raises(ValueError, match="empty"):
            engine.submit_windows(np.zeros(0, np.float32))
