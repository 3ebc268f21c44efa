"""The port's Trainer (``sls_tpu_torch/train/loop.py``) against the JAX
package's, and its resume.

Parity: both Trainers fit two epochs from the same weights
(``detector_state_from_flax``) on the same shuffled batches: a tiny
config, RawBoost off, every dropout 0, ``use_pallas`` (the JAX side in
Pallas interpret mode, as ``tests/test_torch_train_step.py`` runs it),
batch 8, 20 train utterances (a masked tail of 4) and 12 val utterances
(a masked tail of 4), lr 1e-3, from the JAX Trainer's own initial
weights.  Each CSV loss and accuracy field agrees within ``CSV_TOL``,
each EER within one step of its DET curve, and each parameter's change
over the run within ``CHANGE_REL_L2`` (relative L2), except the key
projections' biases: softmax does not see them, so their exact gradient
is zero, and from their zero initial value exact Adam leaves them there;
each package moves them by its rounding alone, at most lr a step.  With
the JAX run's final weights the port validates to the JAX run's own
validation figures.

(From weights moved off the initialiser's zeros by 0.02 N(0, 1) noise
the two runs drift further: Adam's first update, lr g / (|g| + eps),
turns the rounding of near-zero gradients into weight differences of up
to 1e-5, at which one row's top-k support flips at a near-tie; measured
2.5e-4 on ``val_sae_loss`` at epoch 1 and 1.8e-3 on ``sae.W_dec``'s
change, while the port's loss at the JAX run's weights is the JAX run's
to 1e-7.)

Resume: with RawBoost 3, dropout 0.1 and shuffling on, a run fitted to
epoch 1 and resumed by a fresh Trainer to epoch 2 equals an
uninterrupted two-epoch run bit for bit: parameters, moments, step,
calls and CSV rows (all but ``epoch_seconds``, a wall time).
"""

import csv
import dataclasses

import jax
import numpy as np
import pytest
import torch

import sls_tpu.kernels.sae_kernels as jax_sk
from sls_tpu.config import ExperimentConfig, ModelConfig, RawBoostConfig, SAEConfig, TrainConfig
from sls_tpu.config import tiny_xlsr_config
from sls_tpu.data.pipeline import ArrayLoader as JaxArrayLoader
from sls_tpu.train.loop import Trainer as JaxTrainer
from sls_tpu_torch import config as tcfg
from sls_tpu_torch.convert import detector_state_from_flax
from sls_tpu_torch.data.pipeline import ArrayLoader, to_wire
from sls_tpu_torch.scores.writer import log_probs_to_scores, read_score_file
from sls_tpu_torch.train.loop import CSV_FIELDS, CSVLogger, Trainer

WAV_LEN = 1000  # 49 frames through the tiny conv stack
BATCH, N_TRAIN, N_VAL, EPOCHS, LR = 8, 20, 12, 2, 1e-3
CSV_TOL = 1e-4
# each parameter's change over the run (relative L2), the measure of
# tests/test_torch_train_step.py (measured here: 1.1e-4 at most)
CHANGE_REL_L2 = 1e-3
VAL_AT_SAME_WEIGHTS_TOL = 1e-5
ZERO_GRADIENT = "self_attn.k_proj.bias"  # exact gradient zero (docstring)
LOSS_FIELDS = ("train_loss", "train_cls_loss", "train_sae_loss", "train_cpc_loss",
               "train_acc", "val_loss", "val_acc", "val_sae_loss")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers do not oversubscribe the
    cores (no result here depends on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed, n):
    """int16-wire utterances of a separable task (a tone in bonafide)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, size=n)
    wavs = rng.normal(0, 0.05, size=(n, WAV_LEN)).astype(np.float32)
    wavs[labels == 1] += 0.3 * np.sin(2 * np.pi * 440 * np.arange(WAV_LEN) / 16000.0
                                      ).astype(np.float32)
    return to_wire(wavs, "int16"), labels


TRAIN, VAL = _data(0, N_TRAIN), _data(1, N_VAL)


def _loaders(cls):
    return (cls(*TRAIN, batch_size=BATCH, shuffle=True), cls(*VAL, batch_size=BATCH))


def _port_cfg(algo=0, **enc):
    return tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(
            encoder=tcfg.tiny_xlsr_config(**enc), classifier_hidden=32, classifier_dropout=0.0,
            sae=tcfg.SAEConfig(activation_dim=64, dict_size=256, k=32, use_pallas=True)),
        train=tcfg.TrainConfig(batch_size=BATCH, lr=LR, num_epochs=EPOCHS, cut_length=WAV_LEN,
                               rawboost=tcfg.RawBoostConfig(algo=algo)))


def _rows(run_dir):
    with open(run_dir / "training_log.csv") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def interpret_kernels():
    """Route the JAX package's SAE kernels through Pallas interpret mode."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("sae_encode_topk_fused", "sae_decode_fused"):
            fn = getattr(jax_sk, name)
            mp.setattr(jax_sk, name,
                       lambda *a, _fn=fn, **kw: _fn(*a, **{**kw, "interpret": True}))
        yield


@pytest.fixture(scope="module")
def fits(tmp_path_factory, interpret_kernels):
    """(JAX run dir, port run dir, weights at the start, JAX's at the end,
    the port Trainer)."""
    jcfg = ExperimentConfig(
        model=ModelConfig(encoder=tiny_xlsr_config(), classifier_hidden=32,
                          classifier_dropout=0.0,
                          sae=SAEConfig(activation_dim=64, dict_size=256, k=32, use_pallas=True)),
        train=TrainConfig(batch_size=BATCH, lr=LR, num_epochs=EPOCHS, cut_length=WAV_LEN,
                          rawboost=RawBoostConfig(algo=0)))
    jdir, pdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jt = JaxTrainer(jcfg, jdir, tensorboard=False)
    jt.init_state(np.zeros((2, WAV_LEN), np.float32))
    start = detector_state_from_flax(jax.device_get(jt.state.params))
    pt = Trainer(_port_cfg(), pdir, tensorboard=False, device="cpu")
    pt.model.load_state_dict(start, strict=True)
    pt.init_state()
    jt.fit(*_loaders(JaxArrayLoader))
    pt.fit(*_loaders(ArrayLoader))
    end = detector_state_from_flax(jax.device_get(jt.state.params))
    return jdir, pdir, start, end, pt


def test_validation_at_the_jax_weights_matches_jax(fits, tmp_path):
    """The port validates the JAX run's final weights to the JAX run's
    last CSV row: the loss, SAE loss, accuracy and EER bookkeeping agree
    where the weights do."""
    jdir, _, _, end, _ = fits
    pt = Trainer(_port_cfg(), tmp_path, tensorboard=False, device="cpu")
    pt.model.load_state_dict(end, strict=True)
    pt.init_state()
    va = pt.validate(_loaders(ArrayLoader)[1])
    row = _rows(jdir)[-1]
    for field, value in (("val_loss", va.loss), ("val_sae_loss", va.sae_loss),
                         ("val_acc", va.acc), ("val_eer", va.eer)):
        printed = 0.5 * 10.0 ** -len(row[field].split(".")[1])  # the CSV's rounding
        assert value == pytest.approx(float(row[field]), abs=VAL_AT_SAME_WEIGHTS_TOL + printed), \
            field


@pytest.mark.parametrize("field", LOSS_FIELDS)
def test_csv_field_matches_jax(fits, field):
    jrows, prows = _rows(fits[0]), _rows(fits[1])
    assert [r["epoch"] for r in prows] == [r["epoch"] for r in jrows] == ["0", "1"]
    for j, p in zip(jrows, prows):
        assert float(p[field]) == pytest.approx(float(j[field]), abs=CSV_TOL), (field, j, p)


@pytest.mark.parametrize("field,labels", [("train_eer", TRAIN[1]), ("val_eer", VAL[1])])
def test_eer_within_one_det_step(fits, field, labels):
    # one step of the DET curve moves the miss or false-accept rate by
    # one utterance of its class
    step = 100.0 / min(int((labels == 1).sum()), int((labels == 0).sum()))
    for j, p in zip(_rows(fits[0]), _rows(fits[1])):
        assert abs(float(p[field]) - float(j[field])) <= step, (field, j[field], p[field])


def test_parameter_changes_match_jax(fits):
    *_, start, end, pt = fits
    errs, steps = {}, EPOCHS * 3
    for n, p in pt.model.named_parameters():
        change, want = (p.detach() - start[n]).double(), (end[n] - start[n]).double()
        if n.endswith(ZERO_GRADIENT):
            assert torch.all(start[n] == 0), n
            assert float(change.abs().max()) <= LR * steps, n
            assert float(want.abs().max()) <= LR * steps, n
            continue
        errs[n] = float((change - want).norm() / want.norm())
    assert len(errs) == len(start) - pt.cfg.model.encoder.encoder_layers
    worst = max(errs, key=errs.get)
    assert errs[worst] <= CHANGE_REL_L2, (worst, errs[worst])
    assert int(pt.state.step) == EPOCHS * 3 and pt.state.calls == EPOCHS * 3


def test_fit_writes_last_and_best(fits):
    pdir = fits[1]
    assert (pdir / "last.ckpt").exists() and (pdir / "best.ckpt").exists()
    assert not list(pdir.glob("*.tmp"))
    assert CSVLogger(pdir / "training_log.csv").last_epoch() == EPOCHS - 1
    assert list(_rows(pdir)[0]) == CSV_FIELDS


def test_produce_scores_equals_the_eval_step(fits, tmp_path):
    pt = fits[-1]
    wav, _ = VAL
    loader = ArrayLoader(wav, None, utt_ids=[f"E_{i:04d}" for i in range(N_VAL)],
                         batch_size=BATCH)
    assert pt.produce_scores(loader, tmp_path / "scores.txt") == N_VAL
    ids, scores = read_score_file(tmp_path / "scores.txt")
    assert ids == [f"E_{i:04d}" for i in range(N_VAL)]
    want = log_probs_to_scores(pt.eval_step(wav)["log_probs"])
    np.testing.assert_allclose(scores, want, atol=1e-6, rtol=0)


def test_validate_masks_the_padded_tail(fits):
    """A padded tail batch counts exactly: the SAE loss and EER of 12
    utterances in batches of 6 + 6 and of 8 + 4 (padded) agree."""
    pt = fits[-1]
    full = pt.validate(ArrayLoader(*VAL, batch_size=6))
    ragged = pt.validate(ArrayLoader(*VAL, batch_size=8))
    assert ragged.sae_loss == pytest.approx(full.sae_loss, rel=1e-5)
    assert ragged.eer == full.eer and ragged.acc == full.acc


# -- resume --------------------------------------------------------------------------------


def _resume_cfg():
    return _port_cfg(algo=3, dropout=0.1, attention_dropout=0.1, activation_dropout=0.1)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """(uninterrupted Trainer and run dir, resumed Trainer and run dir)."""
    cfg = _resume_cfg()
    whole_dir, split_dir = tmp_path_factory.mktemp("whole"), tmp_path_factory.mktemp("split")
    whole = Trainer(cfg, whole_dir, tensorboard=False, device="cpu")
    whole.init_state()
    whole.fit(*_loaders(ArrayLoader))
    first = Trainer(cfg, split_dir, tensorboard=False, device="cpu")
    first.init_state()
    first.fit(*_loaders(ArrayLoader), num_epochs=1)
    # a fresh Trainer, with other weights until it resumes
    second = Trainer(cfg, split_dir, tensorboard=False, device="cpu")
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in second.model.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    second.init_state()
    assert not torch.equal(second.model.sae.W_enc, first.model.sae.W_enc)
    assert second.resume() and second.start_epoch == 1
    assert second.state.calls == first.state.calls == 3
    second.fit(*_loaders(ArrayLoader))
    return whole, whole_dir, second, split_dir


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


@pytest.mark.parametrize("what", ["parameters", "moments", "step_and_calls", "csv_rows"])
def test_resumed_run_equals_uninterrupted(resumed, what):
    whole, whole_dir, second, split_dir = resumed
    if what == "parameters":
        theirs = dict(second.model.named_parameters())
        for n, p in whole.model.named_parameters():
            assert torch.equal(_bits(p), _bits(theirs[n])), n
    elif what == "moments":
        assert torch.equal(_bits(whole.state.exp_avg), _bits(second.state.exp_avg))
        assert torch.equal(_bits(whole.state.exp_avg_sq), _bits(second.state.exp_avg_sq))
    elif what == "step_and_calls":
        assert int(whole.state.step) == int(second.state.step) == 6
        assert whole.state.calls == second.state.calls == 6
    else:
        rows_whole, rows_split = _rows(whole_dir), _rows(split_dir)
        assert len(rows_whole) == len(rows_split) == EPOCHS
        for a, b in zip(rows_whole, rows_split):
            a.pop("epoch_seconds"), b.pop("epoch_seconds")
            assert a == b


def test_rawboost_and_dropout_change_the_run(resumed, fits):
    """The resumed run's randomness is live: its epoch-0 loss differs from
    a run without RawBoost and dropout on the same data."""
    whole_dir = resumed[1]
    assert _rows(whole_dir)[0]["train_loss"] != _rows(fits[1])[0]["train_loss"]


# -- guards --------------------------------------------------------------------------------


def test_non_finite_batch_is_reported_and_left_out(tmp_path, capsys):
    cfg = _port_cfg()
    trainer = Trainer(cfg, tmp_path, tensorboard=False, device="cpu")
    trainer.init_state()
    wav, labels = TRAIN[0][:16].astype(np.float32) / 32768, TRAIN[1][:16]
    clean = trainer.train_epoch(ArrayLoader(wav[8:], labels[8:], batch_size=8), 0)
    trainer2 = Trainer(cfg, tmp_path / "b", tensorboard=False, device="cpu")
    trainer2.init_state()
    bad = wav.copy()
    bad[2, 100] = np.nan
    m = trainer2.train_epoch(ArrayLoader(bad, labels, batch_size=8), 0)
    assert "non-finite loss at batch 0" in capsys.readouterr().out
    assert trainer2._nonfinite_batches == 1 and int(trainer2.state.step) == 1
    assert np.isfinite(m.loss) and m.loss == pytest.approx(clean.loss, rel=1e-6)
    assert m.acc == clean.acc and m.eer == clean.eer


def test_trainer_runs_on_the_card_unless_asked(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(_port_cfg(), tmp_path)


def test_tensor_and_data_parallel_training_raise(tmp_path, monkeypatch):
    """What tensor-parallel training still refuses, as the reference: a
    process that is not a job of ranks that model_parallel divides, and a
    job across hosts.  (Data- and tensor-parallel training across ranks:
    tests/test_torch_dp_trainer.py, tests/test_torch_tensor_parallel.py.)"""
    from sls_tpu_torch.parallel import tensor

    cfg = _port_cfg()
    tp = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, model_parallel=2))
    with pytest.raises(ValueError, match="must divide the job's 1 rank"):
        Trainer(tp, tmp_path, tensorboard=False, device="cpu")
    monkeypatch.setattr(tensor, "process_count", lambda: 2)
    monkeypatch.setattr(tensor, "host_count", lambda: 2)
    with pytest.raises(ValueError, match="single-host BY DESIGN"):
        Trainer(tp, tmp_path, tensorboard=False, device="cpu")


def test_profile_steps_write_a_trace(tmp_path):
    trainer = Trainer(_port_cfg(), tmp_path, tensorboard=False, profile_steps=1, device="cpu")
    trainer.init_state()
    trainer.train_epoch(ArrayLoader(*TRAIN, batch_size=BATCH), 0)
    assert (tmp_path / "profile" / "trace.json").stat().st_size > 0
    assert trainer._profiled
