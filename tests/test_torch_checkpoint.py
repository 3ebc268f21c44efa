"""The port's checkpoints (``sls_tpu_torch/ckpt/checkpoint.py``) and the
Trainer's resume chain, each held to the reference's semantics
(``sls_tpu/ckpt/checkpoint.py``, ``tests/test_checkpoint.py``); the
shuffled ``ArrayLoader`` and ``roc_eer`` against the JAX package's.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from sls_tpu.data.pipeline import ArrayLoader as JaxArrayLoader
from sls_tpu.metrics.eer import roc_eer as jax_roc_eer
from sls_tpu_torch import config as tcfg
from sls_tpu_torch.ckpt import checkpoint as ck
from sls_tpu_torch.ckpt.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from sls_tpu_torch.data.pipeline import ArrayLoader
from sls_tpu_torch.metrics.eer import roc_eer
from sls_tpu_torch.train.loop import Trainer


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(value=1.0):
    return {"model": {"w": torch.full((3, 2), value), "b": torch.zeros(2)},
            "names": ["w", "b"], "exp_avg": torch.full((8,), value),
            "exp_avg_sq": torch.ones(8), "step": torch.tensor(5), "calls": 7}


# -- files --------------------------------------------------------------------------------


def test_atomic_write_round_trips_and_leaves_no_tmp(tmp_path):
    path = tmp_path / "sub" / "x.ckpt"
    size = save_checkpoint(path, _state(2.0), epoch=3, metrics={"val_eer": np.float32(1.5)},
                           config_json='{"a": 1}')
    assert size == path.stat().st_size > 0
    assert not list(path.parent.glob("*.tmp"))
    ckpt = load_checkpoint(path)
    assert ckpt["meta"] == {"epoch": 3, "metrics": {"val_eer": 1.5}, "config_json": '{"a": 1}'}
    state = ckpt["state"]
    assert torch.equal(state["model"]["w"], torch.full((3, 2), 2.0))
    assert state["names"] == ["w", "b"] and state["calls"] == 7 and int(state["step"]) == 5
    assert ck.read_meta(path)["epoch"] == 3


def test_a_failed_write_keeps_the_old_file(tmp_path, monkeypatch):
    path = tmp_path / "x.ckpt"
    save_checkpoint(path, _state(1.0), epoch=0)

    def broken(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(ck.torch, "save", broken)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(path, _state(2.0), epoch=1)
    monkeypatch.undo()
    assert load_checkpoint(path)["meta"]["epoch"] == 0


def test_host_copy_is_taken_before_save_epoch_returns(tmp_path):
    """The train step updates parameters in place: an async save must
    hold the values of the moment it was called."""
    mgr = CheckpointManager(tmp_path)
    state = _state(1.0)
    mgr.save_epoch(state, 0, {"val_eer": 10.0}, block=False)
    state["model"]["w"].fill_(9.0)
    state["exp_avg"].fill_(9.0)
    mgr.wait()
    saved = load_checkpoint(mgr.last_path)["state"]
    assert torch.equal(saved["model"]["w"], torch.full((3, 2), 1.0))
    assert torch.equal(saved["exp_avg"], torch.full((8,), 1.0))
    assert mgr.last_save["bytes"] == mgr.last_path.stat().st_size
    assert mgr.last_save["files"] == 2  # last and the first best


# -- last / best -----------------------------------------------------------------------


@pytest.mark.parametrize("block", [True, False])
def test_last_every_epoch_best_only_on_improvement(tmp_path, block):
    mgr = CheckpointManager(tmp_path, config_json="{}")
    improved = []
    for epoch, eer in enumerate([20.0, 15.0, 18.0, 12.0, 12.0]):
        improved.append(mgr.save_epoch(_state(float(epoch)), epoch, {"val_eer": eer},
                                       block=block))
        mgr.wait()
        assert ck.read_meta(mgr.last_path)["epoch"] == epoch
    assert improved == [True, True, False, True, False]
    best = load_checkpoint(mgr.best_path)
    assert best["meta"]["epoch"] == 3 and best["meta"]["metrics"]["val_eer"] == 12.0
    assert torch.equal(best["state"]["exp_avg"], torch.full((8,), 3.0))
    # a new manager over the run directory knows the best so far
    again = CheckpointManager(tmp_path)
    assert again.best_metric == 12.0
    assert not again.save_epoch(_state(), 5, {"val_eer": 13.0})


def test_failed_async_write_is_raised_by_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path)

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "save_checkpoint", broken)
    mgr.save_epoch(_state(), 0, {"val_eer": 1.0}, block=False)
    with pytest.raises(RuntimeError, match="async checkpoint write failed") as info:
        mgr.wait()
    assert isinstance(info.value.__cause__, OSError)
    mgr.wait()  # reported once


# -- the resume chain -----------------------------------------------------------------


def test_resume_order_explicit_then_last_then_best(tmp_path):
    mgr = CheckpointManager(tmp_path)
    assert mgr.resolve_resume() is None
    mgr.save_epoch(_state(), 0, {"val_eer": 5.0})  # last and best
    assert mgr.resolve_resume() == mgr.last_path
    mgr.last_path.unlink()
    assert mgr.resolve_resume() == mgr.best_path
    other = tmp_path / "elsewhere.ckpt"
    save_checkpoint(other, _state(), epoch=9)
    mgr.save_epoch(_state(), 1, {"val_eer": 6.0})
    assert mgr.resolve_resume(other) == other


def test_missing_explicit_path_lists_what_is_there(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save_epoch(_state(), 4, {"val_eer": 7.25, "val_acc": 90.0})
    (tmp_path / "junk.ckpt").write_bytes(b"not a checkpoint")
    with pytest.raises(FileNotFoundError) as info:
        mgr.resolve_resume(tmp_path / "nope.ckpt")
    text = str(info.value)
    assert "nope.ckpt" in text and "last.ckpt: epoch 4" in text and "val_eer=7.25" in text
    assert "junk.ckpt: unreadable" in text
    assert "no checkpoints found" in CheckpointManager(tmp_path / "empty").describe_available()


# -- the Trainer's resume ------------------------------------------------------------------


def _cfg(freeze=False):
    return tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(
            encoder=tcfg.tiny_xlsr_config(), classifier_hidden=32, freeze_encoder=freeze,
            sae=tcfg.SAEConfig(activation_dim=64, dict_size=256, k=32, use_pallas=True)),
        train=tcfg.TrainConfig(batch_size=4, lr=1e-3, num_epochs=1, cut_length=1000,
                               rawboost=tcfg.RawBoostConfig(algo=0)))


def _loader():
    rng = np.random.default_rng(0)
    return ArrayLoader(rng.normal(0, 0.1, (6, 1000)).astype(np.float32),
                       rng.integers(0, 2, 6), batch_size=4)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("run")
    trainer = Trainer(_cfg(), run_dir, tensorboard=False, device="cpu")
    trainer.init_state()
    trainer.fit(_loader(), _loader())
    return trainer, run_dir


def test_resume_restores_every_tensor_and_the_counts(trained, tmp_path):
    trainer, run_dir = trained
    fresh = Trainer(_cfg(), tmp_path, tensorboard=False, device="cpu")
    fresh.init_state()
    assert not fresh.resume()  # nothing in its own directory
    assert fresh.resume(run_dir / "last.ckpt") and fresh.start_epoch == 1
    assert fresh.state.calls == trainer.state.calls == 2
    assert int(fresh.state.step) == int(trainer.state.step) == 2
    for (n, a), b in zip(trainer.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert torch.equal(fresh.state.exp_avg, trainer.state.exp_avg)
    assert torch.equal(fresh.state.exp_avg_sq, trainer.state.exp_avg_sq)
    assert not Trainer(_cfg(), run_dir, tensorboard=False, device="cpu").resume(fresh_start=True)


def test_resume_before_init_state_raises(trained):
    with pytest.raises(RuntimeError, match="init_state"):
        Trainer(_cfg(), trained[1], tensorboard=False, device="cpu").resume()


def test_trainable_name_mismatch_raises(trained, tmp_path):
    frozen = Trainer(_cfg(freeze=True), tmp_path, tensorboard=False, device="cpu")
    frozen.init_state()
    with pytest.raises(ValueError, match="only in the checkpoint"):
        frozen.resume(trained[1] / "last.ckpt")


@pytest.mark.parametrize("name", ["model.pth", "epoch_3.pt"])
def test_reference_torch_checkpoint_is_not_ported_yet(trained, name):
    # reference .pth / .pt files are read now (tests/test_torch_offline_eval.py):
    # a missing one is a missing file, not a refusal
    trainer = trained[0]
    with pytest.raises(FileNotFoundError):
        trainer.resume(name)


# -- the loader's shuffle and roc_eer against the JAX package ------------------------------


@pytest.mark.parametrize("n,batch,seed", [(20, 8, 1234), (7, 3, 5), (16, 16, 0)])
def test_shuffled_order_matches_jax(n, batch, seed):
    wavs = np.arange(n, dtype=np.float32)[:, None] * np.ones((1, 4), np.float32)
    labels = np.arange(n) % 2
    ours = ArrayLoader(wavs, labels, batch_size=batch, shuffle=True, seed=seed)
    ref = JaxArrayLoader(wavs, labels, batch_size=batch, shuffle=True, seed=seed)
    orders = []
    for epoch in range(3):
        for a, b in zip(ours.epoch(epoch), ref.epoch(epoch), strict=True):
            np.testing.assert_array_equal(a.wav, b.wav)
            np.testing.assert_array_equal(a.labels, b.labels)
            np.testing.assert_array_equal(a.valid, b.valid)
            assert a.utt_ids == b.utt_ids
        orders.append([u for bt in ours.epoch(epoch) for u in bt.utt_ids][:n])
    assert orders[0] != orders[1]  # a new order each epoch
    shard = ours.host_shard(1, 2)
    assert (shard.shuffle, shard.seed) == (True, seed)
    assert not ArrayLoader(wavs, labels, batch_size=batch).shuffle


EER_CASES = {
    "separable": (np.array([0.9, 0.8, 0.7, 0.2, 0.1]), np.array([1, 1, 1, 0, 0])),
    "overlapping": (np.random.default_rng(0).normal(size=200),
                    np.random.default_rng(1).integers(0, 2, 200)),
    "ties": (np.array([0.5, 0.5, 0.2, 0.5, 0.9, 0.1]), np.array([1, 0, 0, 1, 1, 0])),
    "one_class": (np.array([0.1, 0.2, 0.3]), np.array([1, 1, 1])),
    "all_equal": (np.full(6, 0.4), np.array([1, 0, 1, 0, 1, 0])),
    "empty": (np.zeros(0), np.zeros(0, np.int64)),
    "nan_scores": (np.array([np.nan, 0.9, 0.1, np.inf, 0.8, 0.3]), np.array([1, 1, 0, 0, 1, 0])),
    "all_nan": (np.full(4, np.nan), np.array([1, 0, 1, 0])),
}


@pytest.mark.parametrize("case", EER_CASES)
def test_roc_eer_matches_jax(case):
    scores, labels = EER_CASES[case]
    assert roc_eer(scores, labels) == jax_roc_eer(scores, labels)
    if case in ("one_class", "all_equal", "empty", "all_nan"):
        assert roc_eer(scores, labels) == 50.0


def test_config_is_kept_in_the_checkpoint(trained):
    meta = ck.read_meta(trained[1] / "last.ckpt")
    rebuilt = tcfg.config_from_dict(tcfg.ExperimentConfig, json.loads(meta["config_json"]))
    assert rebuilt == _cfg()
    assert dataclasses.asdict(rebuilt.train) == dataclasses.asdict(_cfg().train)
