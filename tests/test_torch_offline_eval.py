"""The offline evaluation slice end to end at a tiny size, the port
against the JAX package: a reference detector checkpoint (``.pth``, the
reference's naming, ``module.`` prefixes) resumed by both Trainers, an
eval list and FLAC files (one at 8 kHz, one cut in its header) through
``DatasetIndex`` and ``BatchLoader`` on the int16 wire, ``produce_scores``
into score files, and the DF scorer over an organiser key file.

Scores agree per utterance within 1e-4 (the JAX side runs the Pallas SAE
kernels in interpret mode; the tolerance of
``tests/test_torch_detector.py``), and the EERs within one step of the
DET curve.  ``build_scorer`` over a port run directory and over a JAX run
directory gives the port's ``produce_scores`` bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import sls_tpu.kernels.sae_kernels as jax_sk
from sls_tpu.ckpt.checkpoint import save_checkpoint as jax_save_checkpoint
from sls_tpu.config import ExperimentConfig, ModelConfig, RawBoostConfig, SAEConfig, TrainConfig
from sls_tpu.config import config_to_json as jax_config_to_json
from sls_tpu.config import tiny_xlsr_config
from sls_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from sls_tpu.data.pipeline import DatasetIndex as JaxDatasetIndex
from sls_tpu.encoder.torch_ref import make_detector_state
from sls_tpu.scores.evaluate import score_2021_df as jax_score_2021_df
from sls_tpu.train.loop import Trainer as JaxTrainer
from sls_tpu_torch import config as tcfg
from sls_tpu_torch.ckpt.checkpoint import save_checkpoint
from sls_tpu_torch.config import config_to_json
from sls_tpu_torch.data.pipeline import BatchLoader, DatasetIndex
from sls_tpu_torch.data.protocols import parse_eval_list
from sls_tpu_torch.scores.evaluate import score_2021_df
from sls_tpu_torch.scores.writer import log_probs_to_scores, read_score_file
from sls_tpu_torch.serve.scorer import build_scorer, is_sls_state, load_serving_parts
from sls_tpu_torch.train.loop import Trainer
from tests.flac_encoder import encode_flac

WAV_LEN, BATCH, N_FILES, EPOCH = 1000, 8, 20, 7
D, M, K = 64, 256, 32
SCORE_ATOL = 1e-4  # tests/test_torch_detector.py


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers do not oversubscribe the
    cores (no result here depends on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def interpret_kernels():
    """Route the JAX package's SAE kernels through Pallas interpret mode."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("sae_encode_topk_fused", "sae_decode_fused"):
            fn = getattr(jax_sk, name)
            mp.setattr(jax_sk, name,
                       lambda *a, _fn=fn, **kw: _fn(*a, **{**kw, "interpret": True}))
        yield


def _jax_cfg():
    return ExperimentConfig(
        model=ModelConfig(encoder=tiny_xlsr_config(), classifier_dropout=0.0,
                          sae=SAEConfig(activation_dim=D, dict_size=M, k=K, use_pallas=True)),
        train=TrainConfig(batch_size=BATCH, cut_length=WAV_LEN, rawboost=RawBoostConfig(algo=0)))


def _port_cfg():
    return tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(), classifier_dropout=0.0,
                               sae=tcfg.SAEConfig(activation_dim=D, dict_size=M, k=K,
                                                  use_pallas=True)),
        train=tcfg.TrainConfig(batch_size=BATCH, cut_length=WAV_LEN,
                               rawboost=tcfg.RawBoostConfig(algo=0)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(work dir, eval list path, utterance ids, labels): FLAC files of
    300-2500 samples under ``<db>/ASVspoof2021_DF_eval/flac``, one at
    8 kHz and one cut in its header; a reference checkpoint
    ``epoch_7.pth``; the DF key file."""
    work = tmp_path_factory.mktemp("offline")
    flac = work / "db" / "ASVspoof2021_DF_eval" / "flac"
    flac.mkdir(parents=True)
    rng = np.random.default_rng(0)
    ids, labels = [], []
    for i in range(N_FILES):
        u = f"DF_E_{i:07d}"
        n = int(rng.integers(300, 2500))
        label = int(rng.integers(0, 2))
        t = np.arange(n) / 16000.0
        x = rng.normal(0, 0.05, n) + label * 0.3 * np.sin(2 * np.pi * 440 * t)
        rate = 8000 if i == 4 else 16000
        blob = encode_flac([np.round(np.clip(x, -1, 1) * 32767).astype(np.int64)],
                           sample_rate=rate)
        (flac / f"{u}.flac").write_bytes(blob[:20] if i == 9 else blob)
        ids.append(u)
        labels.append(label)
    (work / "ASVspoof2021.DF.cm.eval.trl.txt").write_text("".join(u + "\n" for u in ids))
    os.makedirs(work / "keys" / "CM")
    (work / "keys" / "CM" / "trial_metadata.txt").write_text("".join(
        f"LA_0{i % 9} {u} c d e {'bonafide' if lab else 'spoof'} f eval\n"
        for i, (u, lab) in enumerate(zip(ids, labels))))
    state = make_detector_state(_jax_cfg().model.encoder, dict_size=M, k=K, seed=3,
                                weight_scale=0.1)
    torch.save({"model": {"module." + k: torch.from_numpy(np.asarray(v))
                          for k, v in state.items()}, "epoch": EPOCH},
               work / f"epoch_{EPOCH}.pth")
    return work, ids, np.asarray(labels)


@pytest.fixture(scope="module")
def scored(corpus, interpret_kernels):
    """Both Trainers resumed from the ``.pth`` and their score files."""
    work, ids, _ = corpus
    listed = parse_eval_list(work / "ASVspoof2021.DF.cm.eval.trl.txt")
    assert listed == ids
    db = work / "db" / "ASVspoof2021_DF_eval"
    jt = JaxTrainer(_jax_cfg(), work / "jax_run", tensorboard=False)
    jt.init_state(np.zeros((2, WAV_LEN), np.float32))
    assert jt.resume(str(work / f"epoch_{EPOCH}.pth"))
    jt.produce_scores(JaxBatchLoader(JaxDatasetIndex.for_eval(listed, db), BATCH, cut=WAV_LEN,
                                     wire_dtype="int16"), work / "jax_scores.txt")
    pt = Trainer(_port_cfg(), work / "port_run", tensorboard=False, device="cpu")
    pt.init_state()
    assert pt.resume(work / f"epoch_{EPOCH}.pth")
    loader = BatchLoader(DatasetIndex.for_eval(listed, db), BATCH, cut=WAV_LEN,
                         wire_dtype="int16")
    assert pt.produce_scores(loader, work / "port_scores.txt") == N_FILES
    return jt, pt, loader


def test_both_resume_at_the_next_epoch(scored):
    jt, pt, _ = scored
    assert pt.start_epoch == jt.start_epoch == EPOCH + 1


def test_scores_match_jax(corpus, scored):
    work, ids, _ = corpus
    p_ids, p_scores = read_score_file(work / "port_scores.txt")
    j_ids, j_scores = read_score_file(work / "jax_scores.txt")
    assert p_ids == j_ids == ids
    np.testing.assert_allclose(p_scores, j_scores, atol=SCORE_ATOL, rtol=0)
    assert np.ptp(p_scores) > 1e-3  # the utterances are told apart


def test_df_eer_within_one_det_step(corpus, scored):
    work, _, labels = corpus
    keys = str(work / "keys")
    got = score_2021_df(str(work / "port_scores.txt"), keys)
    want = jax_score_2021_df(str(work / "jax_scores.txt"), keys)
    step = 1.0 / min(int((labels == 1).sum()), int((labels == 0).sum()))
    assert abs(got.eer - want.eer) <= step
    # on one score file both scorers agree exactly
    assert got.eer == jax_score_2021_df(str(work / "port_scores.txt"), keys).eer


def test_header_cut_file_scores_as_silence(corpus, scored):
    work, ids, _ = corpus
    _, pt, loader = scored
    batch = next(b for b in loader.epoch(0) if ids[9] in b.utt_ids)
    row = batch.utt_ids.index(ids[9])
    assert batch.valid[row] and not batch.wav[row].any()
    scores = dict(zip(*read_score_file(work / "port_scores.txt")))
    zeros = np.zeros((BATCH, WAV_LEN), np.int16)
    want = log_probs_to_scores(pt.eval_step(zeros)["log_probs"])[0]
    assert scores[ids[9]] == pytest.approx(want, abs=1e-6)


def _served(score_fn, loader):
    out = {}
    for b in loader.epoch(0):
        s = log_probs_to_scores(score_fn(b.wav))
        out.update({u: v for u, v, ok in zip(b.utt_ids, s, b.valid) if ok})
    return out


@pytest.fixture(scope="module")
def run_dirs(corpus, scored):
    """A port run directory and a JAX run directory holding the resumed
    weights with their configs."""
    work, _, _ = corpus
    jt, pt, _ = scored
    port_dir, jax_dir = work / "serve_port", work / "serve_jax"
    save_checkpoint(port_dir / "last.ckpt", {"model": pt.model.state_dict()}, epoch=EPOCH,
                    config_json=config_to_json(pt.cfg))
    jax_save_checkpoint(jax_dir / "best.ckpt", jt._state_tree(), epoch=EPOCH,
                        config_json=jax_config_to_json(jt.cfg))
    return port_dir, jax_dir


@pytest.mark.parametrize("which", ["port", "jax"])
def test_build_scorer_equals_produce_scores(corpus, scored, run_dirs, which):
    work, _, _ = corpus
    _, _, loader = scored
    run_dir = run_dirs[0] if which == "port" else run_dirs[1]
    cfg, score_fn, cut = build_scorer(run_dir, wire_dtype="int16", batch_size=BATCH,
                                      device="cpu")
    assert cut == WAV_LEN and cfg.model.sae.use_pallas
    want = dict(zip(*read_score_file(work / "port_scores.txt")))
    got = _served(score_fn, loader)
    assert got.keys() == want.keys()
    assert all(got[u] == want[u] for u in want), max(abs(got[u] - want[u]) for u in want)


def test_load_serving_parts_int8_and_sls(run_dirs, tmp_path):
    port_dir, jax_dir = run_dirs
    cfg, params = load_serving_parts(jax_dir)
    assert not cfg.model.encoder.int8_serving
    cfg8, params8 = load_serving_parts(port_dir, int8=True)
    assert cfg8.model.encoder.int8_serving
    assert params.keys() == params8.keys()
    assert all(torch.equal(params[k], params8[k]) for k in params)
    with pytest.raises(FileNotFoundError):
        load_serving_parts(tmp_path)
    # an SLS run directory: the family is told by its sls_head entries,
    # and the JAX package's batch_stats become the running statistics
    kernel = np.arange(4, dtype=np.float32).reshape(2, 2)
    jax_save_checkpoint(tmp_path / "last.ckpt",
                        {"params": {"sls_head": {"fc0": {"kernel": kernel}}},
                         "batch_stats": {"sls_head": {"first_bn": {
                             "mean": np.array([0.5], np.float32),
                             "var": np.array([2.0], np.float32)}}}},
                        epoch=0, config_json=jax_config_to_json(_jax_cfg()))
    _, sls = load_serving_parts(tmp_path)
    assert is_sls_state(sls) and not is_sls_state(params)
    assert torch.equal(sls["sls_head.fc0.weight"], torch.from_numpy(kernel.T))
    assert float(sls["sls_head.first_bn.running_var"]) == 2.0


def test_trainer_resume_reads_the_epoch_from_the_file_name(corpus, tmp_path):
    work, _, _ = corpus
    raw = torch.load(work / f"epoch_{EPOCH}.pth", weights_only=True)["model"]
    torch.save(raw, tmp_path / "checkpoint_epoch_11.pth")  # weights alone, no epoch
    pt = Trainer(_port_cfg(), tmp_path / "run", tensorboard=False, device="cpu")
    with pytest.raises(RuntimeError, match="init_state"):
        pt.resume(tmp_path / "checkpoint_epoch_11.pth")
    pt.init_state()
    assert pt.resume(str(tmp_path / "checkpoint_epoch_11.pth")) and pt.start_epoch == 12
