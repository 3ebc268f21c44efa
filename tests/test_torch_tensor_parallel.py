"""The port's tensor parallelism (``parallel/tensor.py``) against the JAX
package's (``sls_tpu/parallel/tensor.py``), on shared weights.

- ``spec_for_path`` / ``state_shardings`` / ``count_sharded`` cut the same
  tensors as the reference's rules on the same tiny config, along the
  same dimension (the port's Linear weights are the reference's kernels
  transposed).
- One job of two gloo ranks on the CPU (spawned once for the file) runs
  a ``model_parallel`` 2 train step (a ('data', 'model') mesh of 1 x 2)
  and a ``Trainer`` fit of one epoch with ``model_parallel`` 2.  The step
  is held to the JAX TP step built as ``tests/test_tensor_parallel.py``
  builds it (a 1 x 2 mesh of the conftest's virtual CPU devices), and to
  the port's one-process step; the Trainer's checkpoint, written whole,
  loads into a one-process Trainer.
- TP across hosts and TP outside a job of M ranks are refused.

The reference forces ``grouped_conv_einsum`` under TP (a fault of its
compiler, ``tests/test_tensor_parallel.py``); the port keeps the
configured route, here cuDNN's grouped conv against the reference's
einsum: the same function (``tests/test_tensor_parallel.py``'s
``test_pos_conv_einsum_matches_grouped_conv``).  Dropout is 0 (the random
streams differ).  Limits: the reference's own for TP against unsharded,
loss rtol 2e-5 / atol 2e-6, gradients rtol 1e-4 / atol 1e-5.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sls_tpu_torch import config as tcfg
from sls_tpu_torch.convert import detector_state_from_flax
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.parallel import tensor as ttp
from sls_tpu_torch.parallel import workers
from sls_tpu_torch.parallel.launch import launch
from sls_tpu_torch.parallel.mesh import Mesh
from sls_tpu_torch.train import steps as tsteps
from sls_tpu_torch.train.loop import Trainer

RANKS = 2
WAV_LEN = 1000
LR = 1e-3
LOSS_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
VAL_LOSS_REL = 1e-5  # the JAX test's resume check (tests/test_tensor_parallel.py)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from sls_tpu.config import ExperimentConfig, TrainConfig
    from sls_tpu.models.detector import Detector as JaxDetector
    from sls_tpu.parallel import tensor as jtp
    from sls_tpu.parallel.mesh import make_mesh
    from sls_tpu.train import steps as jsteps
    from tests.test_detector_train import tiny_model_config

    return SimpleNamespace(jax=jax, jnp=jnp, ExperimentConfig=ExperimentConfig,
                           TrainConfig=TrainConfig, Detector=JaxDetector, tp=jtp,
                           make_mesh=make_mesh, steps=jsteps, tiny=tiny_model_config)


def _jax_cfg(J):
    model = J.tiny(classifier_dropout=0.0)
    model = dataclasses.replace(
        model, encoder=dataclasses.replace(model.encoder, grouped_conv_einsum=True))
    return J.ExperimentConfig(model=model, train=J.TrainConfig(
        batch_size=4, lr=LR, cut_length=WAV_LEN, model_parallel=RANKS))


def _port_cfg(model_parallel=RANKS):
    model = tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(),
                             sae=tcfg.SAEConfig(activation_dim=64, dict_size=256, k=32),
                             classifier_hidden=32, classifier_dropout=0.0)
    return tcfg.ExperimentConfig(model=model, train=tcfg.TrainConfig(
        batch_size=4, lr=LR, cut_length=WAV_LEN, model_parallel=model_parallel,
        rawboost=tcfg.RawBoostConfig(algo=0)))


def _shape_mesh():
    """A 1 x 2 ('data', 'model') mesh for the layout alone (no groups)."""
    return Mesh(("data", "model"), {"data": 1, "model": RANKS}, (0, 1), None, {})


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return (rng.normal(0, 0.1, (4, WAV_LEN)).astype(np.float32),
            rng.integers(0, 2, 4).astype(np.int32), np.ones(4, np.float32))


@pytest.fixture(scope="module")
def params(J, batch):
    p = J.Detector(_jax_cfg(J).model).init(J.jax.random.PRNGKey(0),
                                           J.jnp.asarray(batch[0][:2]))["params"]
    rng = np.random.default_rng(1)
    return J.jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), p)


# -- layout -------------------------------------------------------------------------------


def test_specs_cut_the_reference_leaves(J):
    cfg = _jax_cfg(J)
    model = J.Detector(cfg.model)
    shape = J.jax.eval_shape(
        lambda key, w: J.steps.create_train_state(model, cfg, key, w),
        J.jax.random.PRNGKey(0), J.jax.ShapeDtypeStruct((2, WAV_LEN), J.jnp.float32))
    jmesh = J.make_mesh(J.jax.devices()[:RANKS], shape=(1, RANKS),
                        axis_names=("data", "model"))
    jsh = J.tp.state_shardings(shape, jmesh)
    port = Detector(_port_cfg().model, device="meta")
    psh = ttp.state_shardings(port, _shape_mesh())
    assert ttp.count_sharded(psh) == J.tp.count_sharded(jsh) > 0
    # which parameters, and along which dimension: each JAX leaf filled
    # with its cut dimension's index, then laid out as the port's tensors
    def mark(path, sharding, leaf):
        dim = next((d for d, ax in enumerate(sharding.spec) if ax is not None), None)
        idx = np.zeros(leaf.shape, np.float32)
        if dim is not None:
            view = [1] * len(leaf.shape)
            view[dim] = leaf.shape[dim]
            idx = idx + np.arange(1, leaf.shape[dim] + 1, dtype=np.float32).reshape(view)
        return idx

    marked = J.jax.tree_util.tree_map_with_path(mark, jsh.params, shape.params)
    as_port = detector_state_from_flax(marked)
    for name, spec in psh["params"].items():
        dim = ttp.cut_dim(spec)
        t = as_port[name].numpy()
        if dim is None:
            assert not t.any(), name  # whole in both
        else:  # the cut dimension carries the JAX cut index
            other = tuple(d for d in range(t.ndim) if d != dim)
            assert np.all(t.max(axis=other) == np.arange(1, t.shape[dim] + 1)), name


def test_spec_stays_whole_when_not_divisible():
    assert ttp.spec_for_path("encoder.layers.0.fc1.weight", torch.empty(7, 16), "model",
                             2) == ()
    assert ttp.spec_for_path(("sae", "W_enc"), torch.empty(16, 8), "model",
                             2) == (None, "model")
    assert ttp.spec_for_path("classifier.norm.weight", torch.empty(8), "model", 2) == ()


# -- the two-rank job ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(params, batch, tmp_path_factory):
    state = {k: v.numpy().copy() for k, v in detector_state_from_flax(params).items()}
    run_dir = str(tmp_path_factory.mktemp("tp_run"))
    rng = np.random.default_rng(3)
    train = (rng.normal(0, 0.1, (8, WAV_LEN)).astype(np.float32),
             rng.integers(0, 2, 8).astype(np.int32))
    val = (rng.normal(0, 0.1, (6, WAV_LEN)).astype(np.float32),
           rng.integers(0, 2, 6).astype(np.int32))
    jobs = [("train_steps_rank", (_port_cfg(), "detector", state, [batch]), {}),
            ("trainer_rank", (_port_cfg(), "detector", run_dir, train, val, 4, 1), {})]
    res = launch(workers.jobs_rank, RANKS, (jobs,), device_type="cpu")
    return SimpleNamespace(step=[r[0] for r in res], trainer=[r[1] for r in res],
                           state=state, run_dir=run_dir, val=val)


def _jax_tp_step(J, params, batch):
    """Loss and gradients of the JAX TP step, as
    ``tests/test_tensor_parallel.py::test_tp_train_step_matches_unsharded``
    builds them, on a 1 x 2 mesh."""
    jax, jnp = J.jax, J.jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sls_tpu.models.detector import total_loss
    from sls_tpu.train.loss import weighted_nll

    cfg = _jax_cfg(J)
    model = J.Detector(cfg.model)
    wav, labels, valid = (jnp.asarray(x) for x in batch)
    key = jax.random.PRNGKey(0)
    mesh = J.make_mesh(jax.devices()[:RANKS], shape=(1, RANKS), axis_names=("data", "model"))
    shape = jax.eval_shape(lambda k, w: J.steps.create_train_state(model, cfg, k, w), key,
                           jax.ShapeDtypeStruct(wav[:2].shape, wav.dtype))
    sh = J.tp.state_shardings(shape, mesh)
    state = J.steps.create_train_state(model, cfg, key, wav[:2])
    state = state.replace(params=jax.tree.map(jnp.asarray, params))
    _, metrics = J.steps.make_train_step(model, cfg, mesh, "inherit")(
        J.tp.place_state(state, sh), wav, labels, valid, key)

    def loss_fn(p, w, y):
        out = model.apply({"params": p}, w, train=False)
        cls = weighted_nll(out["log_probs"], y, cfg.train.loss_weights)
        return total_loss(cls, out["sae_loss"], cfg.train.sae_weight, out["cpc_loss"], 0.0)

    data = NamedSharding(mesh, P("data"))
    grads = jax.jit(jax.grad(loss_fn), in_shardings=(None, data, data))(
        J.tp.place_state(jax.tree.map(jnp.asarray, params), sh.params), wav, labels)
    return float(metrics["loss"]), jax.device_get(grads)


def test_tp_step_matches_jax_tp_step_and_one_process(J, params, batch, ranks):
    loss, grads = _jax_tp_step(J, params, batch)
    pexp = _port_cfg(model_parallel=1)
    names = tsteps.trainable_names(Detector(pexp.model, device="meta"), pexp.model)
    g_tree = detector_state_from_flax(grads)
    want = np.concatenate([g_tree[n].numpy().reshape(-1) for n in names])
    model = Detector(pexp.model, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in ranks.state.items()})
    state = tsteps.create_train_state(model, pexp)
    one = []
    update = tsteps.AdamL2.update
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsteps.AdamL2, "update",
                   lambda self, st, g, f: (one.append(g.clone().numpy()), update(self, st, g, f)))
        _, m = tsteps.make_train_step(model, pexp, device="cpu")(state, *batch, 0)
    for r in ranks.step:
        got = r["steps"][0]
        assert got["finite"]
        np.testing.assert_allclose(got["terms"][0], loss, **LOSS_TOL)
        np.testing.assert_allclose(got["terms"][0], float(m["loss"]), **LOSS_TOL)
        np.testing.assert_allclose(got["grad"], want, **GRAD_TOL)
        np.testing.assert_allclose(got["grad"], one[0], **GRAD_TOL)
        # the plain SAE route: no SAE kernel was called on either rank
        assert all(n == 0 for n in r["launches"].values())
    # the whole weights after the step, gathered from both ranks' blocks
    w = ranks.step[0]["weights"]
    assert set(w) == set(model.state_dict())
    assert all(w[k].shape == tuple(v.shape) for k, v in model.state_dict().items())


def test_tp_trainer_checkpoint_loads_in_one_process(ranks, tmp_path):
    a, b = ranks.trainer
    assert [m for m in a["metrics"]] == [m for m in b["metrics"]]  # the same figures
    assert a["step"] == b["step"] == 2  # 8 rows in batches of 4
    val_tp = a["metrics"][-1][2]
    # the files hold whole tensors: a one-process Trainer resumes from them
    trainer = Trainer(_port_cfg(model_parallel=1), ranks.run_dir, tensorboard=False,
                      device="cpu")
    trainer.init_state()
    assert trainer.resume()
    assert trainer.start_epoch == 1 and int(trainer.state.step) == 2
    from sls_tpu_torch.data.pipeline import ArrayLoader

    va = trainer.validate(ArrayLoader(*ranks.val, batch_size=4))
    assert va.loss == pytest.approx(val_tp["loss"], rel=VAL_LOSS_REL)


def test_tensor_parallel_refusals(monkeypatch, tmp_path):
    cfg = _port_cfg()
    with pytest.raises(ValueError, match="must divide the job's 1 rank"):
        Trainer(cfg, tmp_path, tensorboard=False, device="cpu")
    monkeypatch.setattr(ttp, "host_count", lambda: 2)
    with pytest.raises(ValueError, match="single-host BY DESIGN"):
        ttp.tp_mesh_and_config(cfg, ranks=RANKS)
