"""The port's msgpack reader (``sls_tpu_torch/ckpt/msgpack.py``) against
``flax.serialization.msgpack_restore``, and the port's resume from a JAX
run directory.

The reader must give flax's tree on the files the JAX package's
``save_checkpoint`` writes (a tiny JAX Trainer's state after one step,
with and without a frozen encoder), on trees made by hand (bf16, int64,
numpy scalars, complex, empty dicts, strings, bytes, lists) and on
chunked arrays (flax's ``MAX_CHUNK_SIZE`` made small).  The port's
``load_checkpoint`` gives the JAX package's meta.  A port Trainer resumed
from the JAX run directory holds the JAX params bit for bit, the Adam
moments through the key mapping bit for bit, ``step``, ``calls`` (=
``step``) and ``start_epoch``; one train step after the resume (every
dropout 0) matches the JAX Trainer's step after its own resume at the
tolerances of ``tests/test_torch_train_step.py``.
"""

import dataclasses

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sls_tpu.ckpt.checkpoint import load_checkpoint as jax_load_checkpoint
from sls_tpu.ckpt.checkpoint import save_checkpoint as jax_save_checkpoint
from sls_tpu.config import ExperimentConfig, ModelConfig, RawBoostConfig, SAEConfig, TrainConfig
from sls_tpu.config import tiny_xlsr_config
from sls_tpu.data.pipeline import ArrayLoader as JaxArrayLoader
from sls_tpu.train.loop import Trainer as JaxTrainer
from sls_tpu_torch import config as tcfg
from sls_tpu_torch.ckpt import msgpack
from sls_tpu_torch.ckpt.checkpoint import CheckpointManager, load_checkpoint
from sls_tpu_torch.convert import detector_state_from_flax
from sls_tpu_torch.train.loop import Trainer

WAV_LEN, BATCH, LR, WD = 1000, 8, 1e-3, 1e-4  # BATCH: the JAX mesh has 8 CPU devices
# tests/test_torch_train_step.py: the loss of the same weights, and each
# parameter's change over the step (relative L2)
LOSS_REL = 1e-5
CHANGE_REL_L2 = 1e-3
# as in tests/test_torch_trainer.py: softmax does not see the key
# projections' biases, so their exact gradient is zero, and from the JAX
# initialiser's zeros each package moves them by its own rounding alone
ZERO_GRADIENT = "self_attn.k_proj.bias"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers do not oversubscribe the
    cores (no result here depends on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_tree_equal(got, want, path="tree"):
    """The port's restored tree equals flax's: keys, types, dtypes and
    every bit (bf16 leaves are torch tensors on the port's side)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype.name == "bfloat16":
        assert torch.is_tensor(got) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        bits = np.asarray(want).view(np.uint16)
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), bits), path
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert got.shape == want.shape and np.array_equal(got, want), path
    else:
        assert type(got) is type(want) and (got == want or (got != got and want != want)), \
            (path, got, want)


def _hand_tree():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "i64": rng.integers(-2**40, 2**40, size=(7,), dtype=np.int64),
        "u8": rng.integers(0, 255, size=(2, 2), dtype=np.uint8),
        "bf16": np.asarray(jnp.asarray(rng.normal(size=(4, 3)), jnp.bfloat16)),
        "bf16_scalar": np.asarray(jnp.asarray(1.5, jnp.bfloat16)),
        "scalar_f32": np.float32(2.25),
        "scalar_i64": np.int64(-5),
        "scalar_bool": np.bool_(True),
        "empty": {},
        "empty_array": np.zeros((0, 4), np.float32),
        "nested": {"a": {"b": {}}, "s": "text", "n": None, "t": True, "f": False},
        "numbers": {"small": 3, "neg": -33, "big": 2**40, "huge": 2**63 + 5, "float": 0.1},
        "complex": 1.5 - 2.0j,
        "bytes": b"\x00\xff" * 40,
        "list": [1, "two", 3.0, [4]],
        "long_text": "x" * 300,
        "wide": {f"k{i}": i for i in range(20)},
    }


def test_hand_made_tree_matches_flax():
    blob = fser.msgpack_serialize(_hand_tree())
    assert_tree_equal(msgpack.restore(blob), fser.msgpack_restore(blob))


def test_chunked_arrays_match_flax(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"big": rng.normal(size=(9, 11)).astype(np.float32),
            "deep": {"big_i64": rng.integers(0, 9, size=(50,), dtype=np.int64)},
            "small": np.arange(3, dtype=np.float32)}
    blob = fser.msgpack_serialize(dict(tree))
    assert b"__msgpack_chunked_array__" in blob
    got = msgpack.restore(blob)
    assert_tree_equal(got, fser.msgpack_restore(blob))
    assert np.array_equal(got["big"], tree["big"])


@pytest.mark.parametrize("blob,what", [
    (b"\xc1", "unknown type"),
    (b"\x92\x01", "truncated"),
    (b"\x01\x02", "trailing"),
    (b"\x81\x01\x02", "map key"),
    (b"\xd4\x09\x00", "extension type 9"),
])
def test_malformed_input_raises(blob, what):
    with pytest.raises(ValueError, match=what.split()[0]):
        msgpack.restore(blob)


def _jax_cfg(freeze):
    return ExperimentConfig(
        model=ModelConfig(encoder=tiny_xlsr_config(), classifier_hidden=32,
                          classifier_dropout=0.0, freeze_encoder=freeze,
                          sae=SAEConfig(activation_dim=64, dict_size=256, k=32)),
        train=TrainConfig(batch_size=BATCH, lr=LR, weight_decay=WD, num_epochs=1,
                          cut_length=WAV_LEN, rawboost=RawBoostConfig(algo=0)))


def _port_cfg(freeze):
    return tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(), classifier_hidden=32,
                               classifier_dropout=0.0, freeze_encoder=freeze,
                               sae=tcfg.SAEConfig(activation_dim=64, dict_size=256, k=32)),
        train=tcfg.TrainConfig(batch_size=BATCH, lr=LR, weight_decay=WD, num_epochs=1,
                               cut_length=WAV_LEN, rawboost=tcfg.RawBoostConfig(algo=0)))


def _batch(seed):
    rng = np.random.default_rng(seed)
    wav = np.round(rng.normal(0, 0.1, (BATCH, WAV_LEN)) * 32768).astype(np.int16)
    return wav, rng.permutation(np.arange(BATCH) % 2).astype(np.int32)


@pytest.fixture(scope="module", params=[False, True], ids=["unfrozen", "frozen"])
def jax_run(request, tmp_path_factory):
    """A JAX run directory after one epoch of one step: (freeze, dir)."""
    freeze = request.param
    run_dir = tmp_path_factory.mktemp("jax_run")
    jt = JaxTrainer(_jax_cfg(freeze), run_dir, tensorboard=False)
    jt.init_state(np.zeros((2, WAV_LEN), np.float32))
    wav, labels = _batch(0)
    loader = JaxArrayLoader(wav, labels, batch_size=BATCH)
    jt.fit(loader, loader)
    return freeze, run_dir


def test_trainer_checkpoint_matches_flax(jax_run):
    _, run_dir = jax_run
    for name in ("last.ckpt", "best.ckpt"):
        blob = (run_dir / name).read_bytes()
        assert_tree_equal(msgpack.restore(blob), fser.msgpack_restore(blob))


def test_meta_matches_jax(jax_run):
    _, run_dir = jax_run
    _, want = jax_load_checkpoint(run_dir / "last.ckpt")
    assert load_checkpoint(run_dir / "last.ckpt")["meta"] == want
    assert want["epoch"] == 0 and "val_eer" in want["metrics"] and want["config_json"]
    mgr = CheckpointManager(run_dir)
    assert mgr.best_metric == want["metrics"]["val_eer"]
    assert "last.ckpt: epoch 0" in mgr.describe_available()


def test_save_checkpoint_tree_matches_flax(tmp_path):
    tree = {"params": {"w": np.ones((2, 3), np.float32)}, "step": np.asarray(7, np.int32),
            "opt_state": {"0": {"count": np.asarray(7, np.int32), "mu": {}, "nu": {}},
                          "1": {}}}
    jax_save_checkpoint(tmp_path / "x.ckpt", tree, epoch=3, metrics={"val_eer": 1.5},
                        config_json='{"a": 1}')
    blob = (tmp_path / "x.ckpt").read_bytes()
    assert_tree_equal(msgpack.restore(blob), fser.msgpack_restore(blob))
    assert load_checkpoint(tmp_path / "x.ckpt")["meta"] == {
        "epoch": 3, "metrics": {"val_eer": 1.5}, "config_json": '{"a": 1}'}


@pytest.fixture(scope="module")
def resumed(jax_run, tmp_path_factory):
    """(freeze, the JAX Trainer and the port Trainer, each resumed from
    the JAX run directory)."""
    freeze, run_dir = jax_run
    jt = JaxTrainer(_jax_cfg(freeze), run_dir, tensorboard=False)
    jt.init_state(np.zeros((2, WAV_LEN), np.float32))
    assert jt.resume()
    pt = Trainer(_port_cfg(freeze), tmp_path_factory.mktemp("port"), tensorboard=False,
                 device="cpu")
    pt.init_state()
    assert pt.resume(run_dir / "last.ckpt")
    return freeze, jt, pt


def test_resume_restores_the_jax_state(resumed):
    freeze, jt, pt = resumed
    params = detector_state_from_flax(jax.device_get(jt.state.params))
    for n, p in pt.model.state_dict().items():
        assert torch.equal(p, params[n]), n
    (_, adam), = [(k, v) for k, v in _adam_states(jax.device_get(jt.state.opt_state))]
    mu, nu = detector_state_from_flax(adam.mu), detector_state_from_flax(adam.nu)
    for n in pt.state.names:
        m, v = pt.state.moments(n)
        assert torch.equal(m, mu[n]) and torch.equal(v, nu[n]), n
    assert bool(pt.state.exp_avg.abs().sum() > 0)
    assert all(n not in pt.state.names for n in params if freeze and n.startswith("encoder."))
    assert int(pt.state.step) == int(jt.state.step) == 1 == pt.state.calls
    assert pt.start_epoch == jt.start_epoch == 1


def _adam_states(opt_state):
    """(path, ScaleByAdamState) pairs inside an optax state."""
    import optax

    leaves = jax.tree_util.tree_leaves_with_path(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    return [(p, x) for p, x in leaves if isinstance(x, optax.ScaleByAdamState)]


def test_train_step_after_resume_matches_jax(resumed):
    freeze, jt, pt = resumed
    start = {n: p.detach().clone() for n, p in pt.model.named_parameters()}
    wav, labels = _batch(1)
    valid = np.ones(BATCH, np.float32)
    jstate, jm = jt.train_step(jt.state, jnp.asarray(wav), jnp.asarray(labels),
                               jnp.asarray(valid), jt.rng)
    state, pm = pt.train_step(pt.state, wav, labels, valid, pt.cfg.train.seed)
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_REL)
    assert int(state.step) == int(jstate.step) == 2
    ref = detector_state_from_flax(jax.device_get(jstate.params))
    errs = {}
    for n, p in pt.model.named_parameters():
        if freeze and n.startswith("encoder."):
            assert torch.equal(p.detach(), start[n]), n
            continue
        if n.endswith(ZERO_GRADIENT):
            continue
        change, want = (p.detach() - start[n]).double(), (ref[n] - start[n]).double()
        errs[n] = float((change - want).norm() / want.norm())
    worst = max(errs, key=errs.get)
    assert errs[worst] <= CHANGE_REL_L2, (worst, errs[worst])


def test_resume_into_another_freeze_raises(jax_run, tmp_path):
    freeze, run_dir = jax_run
    pt = Trainer(dataclasses.replace(_port_cfg(not freeze)), tmp_path, tensorboard=False,
                 device="cpu")
    pt.init_state()
    with pytest.raises(ValueError, match="moments"):
        pt.resume(run_dir / "last.ckpt")
