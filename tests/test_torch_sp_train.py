"""The port's sequence-parallel train step (``train/steps.py`` on a
('data', 'seq') mesh) and ``Trainer(mesh=...)``, against the port's own
one-process and data-parallel steps and against the JAX package's step.

One job of four gloo ranks on the CPU (``parallel/launch.py``, spawned
once for the file) runs every multi-rank case, at ``tiny_xlsr_config``
width on 1000-sample clips: 49 frames, which no sp2 or sp4 cut divides
(the last rank's chunk is short, as every cut of the flagship's 201
training frames is):

- dp1 x sp2 on ranks 0 and 1, held to the one-process step on the same
  rows, with dropout (every rate, the head's too) and layerdrop on: the
  sharded step draws the masks of the unsharded one;
- dp2 x sp2 on all four, held to the data-parallel step of ranks 0 and 1
  on the same global batch, dropout and layerdrop on (the seq ranks of a
  data coordinate share its generator);
- both for the flagship (per-timestep SAE) and the window-hard variant
  with CPC, whose features and codes are gathered over 'seq';
- dp2 x sp2 with every dropout rate 0, held to the JAX package's step on
  the same numpy weights and batch: its sequence-parallel step on
  ``sp_mesh(4, n_data=2)`` of the virtual CPU devices
  (``tests/test_sequence_parallel.py``), or where the process has fewer
  than eight its unsharded step, which that test holds equal;
- ``Trainer(mesh=sp_mesh(4))`` over one epoch, held to the one-process
  Trainer's CSV row.

Limits: against the port's steps, each loss term within 1e-6 and every
parameter's gradient within relative L2 1e-5 (the same sums, cut over
frames and added); ``self_attn.k_proj.bias``, whose gradient is zero in
exact arithmetic (softmax is blind to a shift shared by every key), is
held to 1e-5 of the whole gradient's norm instead.  Against JAX, the
reference test's limits: the loss within rtol 2e-5 / atol 2e-6, the
scores within rtol 2e-4 / atol 2e-5; each updated parameter's change
within relative L2 1e-3 of the JAX step's (Adam divides each gradient by
its own root mean square, ``tests/test_torch_data_parallel.py``).
"""

import csv
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sls_tpu_torch import config as tcfg
from sls_tpu_torch.convert import detector_state_from_flax
from sls_tpu_torch.data.pipeline import ArrayLoader
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.parallel import workers
from sls_tpu_torch.parallel.launch import launch
from sls_tpu_torch.train import steps as tsteps
from sls_tpu_torch.train.loop import Trainer

RANKS = 4
D, M, K = 64, 256, 32
LR, WD = 1e-3, 1e-4
WAV_LEN, ROWS = 1000, 4
RATES = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1, layerdrop=0.3)
LOSS_ABS, GRAD_REL_L2 = 1e-6, 1e-5
JAX_LOSS, JAX_SCORES = dict(rtol=2e-5, atol=2e-6), dict(rtol=2e-4, atol=2e-5)
CHANGE_REL_L2 = 1e-3
ZERO_GRADIENT = "self_attn.k_proj.bias"
TRAINER_ROWS, TRAINER_BATCH, TRAINER_SEQ = (8, 4), 4, 4
CSV_ABS, CSV_REL = 1.5e-6, 1e-5  # six decimals, and fp32 sums in another order


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(m, kind: str, rates: bool):
    enc = m.tiny_xlsr_config(**(RATES if rates else {}))
    sae = dict(activation_dim=D, dict_size=M, k=K)
    extra = {}
    if kind == "cpc":
        sae.update(variant="window_hard", window_size=4)
        extra = dict(use_cpc=True, cpc=m.CPCConfig(hidden_dim=32, prediction_steps=(1, 2)))
    return m.ModelConfig(encoder=enc, sae=m.SAEConfig(**sae), classifier_hidden=32,
                         classifier_dropout=0.3 if rates else 0.0, **extra)


def _exp(m, kind: str, rates: bool = True, **train):
    return m.ExperimentConfig(model=_model(m, kind, rates), train=m.TrainConfig(
        lr=LR, weight_decay=WD, cpc_weight=0.5, cut_length=WAV_LEN, **train))


def _batch(seed: int):
    """A global batch of ROWS rows; the last row of each data
    coordinate's half is invalid."""
    rng = np.random.default_rng(seed)
    valid = np.ones(ROWS, np.float32)
    valid[ROWS // 2 - 1] = valid[-1] = 0.0
    return (rng.normal(0, 0.1, (ROWS, WAV_LEN)).astype(np.float32),
            rng.integers(0, 2, ROWS).astype(np.int32), valid)


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from sls_tpu import config as jcfg
    from sls_tpu.models.detector import Detector as JaxDetector
    from sls_tpu.parallel import mesh as jmesh
    from sls_tpu.parallel.sequence import sp_mesh, sp_model_config
    from sls_tpu.train import steps as jsteps

    return SimpleNamespace(jax=jax, jnp=jnp, cfg=jcfg, Detector=JaxDetector, mesh=jmesh,
                           sp_mesh=sp_mesh, sp_model_config=sp_model_config, steps=jsteps)


@pytest.fixture(scope="module")
def setups(J):
    """Per kind: the JAX package's params (perturbed from its init), the
    port's state dict of them, and the batch."""
    out = {}
    for kind, seed in (("flagship", 0), ("cpc", 1)):
        batch = _batch(seed)
        jexp = _exp(J.cfg, kind, rates=False)
        params = J.Detector(jexp.model).init(J.jax.random.PRNGKey(seed), J.jnp.asarray(
            batch[0][:1]), compute_cpc=kind == "cpc")["params"]
        rng = np.random.default_rng(seed + 10)
        params = J.jax.tree.map(
            lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32),
            params)
        state = {k: v.numpy().copy() for k, v in detector_state_from_flax(params).items()}
        out[kind] = SimpleNamespace(params=params, state=state, batch=batch, jexp=jexp)
    return out


@pytest.fixture(scope="module")
def trainer_data():
    rng = np.random.default_rng(7)

    def arrays(n):
        return (rng.normal(0, 0.1, (n, WAV_LEN)).astype(np.float32),
                rng.integers(0, 2, n).astype(np.int32))

    return tuple(arrays(n) for n in TRAINER_ROWS)


def _trainer_exp():
    return _exp(tcfg, "flagship", batch_size=TRAINER_BATCH,
                rawboost=tcfg.RawBoostConfig(algo=0))


@pytest.fixture(scope="module")
def ranks(setups, trainer_data, tmp_path_factory):
    """The four ranks' results of every job, spawned once."""
    run_dir = str(tmp_path_factory.mktemp("sp_trainer"))
    jobs = []
    for kind in ("flagship", "cpc"):
        s = setups[kind]
        args = (_exp(tcfg, kind), "detector", s.state, [s.batch])
        jobs += [("train_steps_rank", args, dict(sp=sp)) for sp in ((1, 2), (2, 1), (2, 2))]
    s = setups["flagship"]
    jobs.append(("train_steps_rank", (_exp(tcfg, "flagship", rates=False), "detector",
                                      s.state, [s.batch]), dict(sp=(2, 2))))
    jobs.append(("trainer_rank", (_trainer_exp(), "detector", run_dir, *trainer_data,
                                  TRAINER_BATCH, 1), dict(n_seq=TRAINER_SEQ)))
    res = launch(workers.jobs_rank, RANKS, (jobs,), device_type="cpu")
    names = [f"{kind}_{name}" for kind in ("flagship", "cpc")
             for name in ("dp1_sp2", "dp2", "dp2_sp2")] + ["flagship_jax", "trainer"]
    out = {name: [r[i] for r in res] for i, name in enumerate(names)}
    out["trainer_dir"] = run_dir
    return out


def _one_process(kind, state, batch):
    """The port's one-process step on ``batch``: its loss terms, scores
    and the flat gradient the optimizer got."""
    pexp = _exp(tcfg, kind)
    model = Detector(pexp.model, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    state_ = tsteps.create_train_state(model, pexp)
    step = tsteps.make_train_step(model, pexp, device="cpu")
    grads = []
    update = tsteps.AdamL2.update

    def capture(self, st, g, finite):
        grads.append(g.clone().numpy())
        return update(self, st, g, finite)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsteps.AdamL2, "update", capture)
        _, m = step(state_, *batch, 0)
    return {"terms": [float(m[k]) for k in ("loss", "cls_loss", "sae_loss", "cpc_loss")],
            "scores": m["scores"].numpy(), "grad": grads[0]}


def _assert_grads_match(got: np.ndarray, want: np.ndarray, kind: str):
    """Every parameter's gradient within GRAD_REL_L2 (module docstring)."""
    model = Detector(_exp(tcfg, kind).model, device="meta")
    names = tsteps.trainable_names(model, model.config)
    sizes = dict((n, p.numel()) for n, p in model.named_parameters())
    whole = np.linalg.norm(want)
    start, errs = 0, {}
    for n in names:
        a, b = got[start:start + sizes[n]], want[start:start + sizes[n]]
        start += sizes[n]
        if n.endswith(ZERO_GRADIENT) or not b.any():  # or a layer layerdrop dropped
            assert np.linalg.norm(a - b) <= GRAD_REL_L2 * whole, n
        else:
            errs[n] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    assert start == got.size == want.size
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL_L2, (worst, errs[worst])


def _in_mesh(results):
    return [r for r in results if r is not None]


@pytest.mark.parametrize("kind", ["flagship", "cpc"])
def test_dp1_sp2_matches_one_process_step(setups, ranks, kind):
    s = setups[kind]
    want = _one_process(kind, s.state, s.batch)
    got = _in_mesh(ranks[f"{kind}_dp1_sp2"])
    assert len(got) == 2
    for r in got:
        step = r["steps"][0]
        assert step["finite"]
        np.testing.assert_allclose(step["terms"], want["terms"], rtol=0, atol=LOSS_ABS)
        np.testing.assert_allclose(step["scores"], want["scores"], rtol=0, atol=LOSS_ABS)
        _assert_grads_match(step["grad"], want["grad"], kind)
    assert got[0]["checksum"] == got[1]["checksum"]
    if kind == "cpc":
        assert want["terms"][3] > 0  # the InfoNCE term is there


@pytest.mark.parametrize("kind", ["flagship", "cpc"])
def test_dp2_sp2_matches_data_parallel_step(ranks, kind):
    dp = _in_mesh(ranks[f"{kind}_dp2"])
    sp = ranks[f"{kind}_dp2_sp2"]
    assert len(dp) == 2 and len(sp) == RANKS
    # sp_mesh(2, n_data=2): ranks 0, 1 hold data coordinate 0, ranks 2, 3 coordinate 1
    for rank, r in enumerate(sp):
        ref = dp[rank // 2]["steps"][0]
        step = r["steps"][0]
        np.testing.assert_allclose(step["terms"], ref["terms"], rtol=0, atol=LOSS_ABS)
        np.testing.assert_allclose(step["scores"], ref["scores"], rtol=0, atol=LOSS_ABS)
        _assert_grads_match(step["grad"], ref["grad"], kind)
    assert len({tuple(r["checksum"]) for r in sp}) == 1  # every rank holds the same weights


def _jax_step(J, s):
    """The JAX package's step on the whole batch: its loss, scores and
    updated parameters (as the port's state dict)."""
    jax, jnp = J.jax, J.jnp
    jexp = s.jexp
    wav, labels, valid = (jnp.asarray(x) for x in s.batch)
    valid = valid.astype(bool)
    key = jax.random.PRNGKey(0)
    mask = J.steps.trainable_decay_mask(jexp)
    tx = J.steps.make_optimizer(LR, WD, mask, trainable_mask=mask)
    params = jax.tree.map(jnp.asarray, s.params)
    if len(jax.devices()) >= 8:
        sp_exp = dataclasses.replace(jexp, model=J.sp_model_config(jexp.model))
        model = J.Detector(sp_exp.model)
        mesh = J.sp_mesh(4, n_data=2)
        with jax.sharding.set_mesh(mesh):
            state = J.mesh.replicate(J.steps.TrainState.create(
                apply_fn=model.apply, params=params, tx=tx), mesh)
            step = J.steps.make_train_step(model, sp_exp, mesh)
            new, m = step(state, *J.mesh.shard_batch((wav, labels, valid), mesh), key)
            out = (float(m["loss"]), np.asarray(m["scores"]), jax.device_get(new.params))
    else:
        model = J.Detector(jexp.model)
        state = J.steps.TrainState.create(apply_fn=model.apply, params=params, tx=tx)
        new, m = J.steps.make_train_step(model, jexp, mesh=None)(state, wav, labels, valid,
                                                                  key)
        out = (float(m["loss"]), np.asarray(m["scores"]), jax.device_get(new.params))
    loss, scores, new_params = out
    return loss, scores, {k: v.numpy() for k, v in detector_state_from_flax(new_params).items()}


def test_dp2_sp2_matches_jax_step(J, setups, ranks):
    s = setups["flagship"]
    loss, scores, new = _jax_step(J, s)
    sp = ranks["flagship_jax"]
    for r in sp:
        assert r["steps"][0]["terms"][0] == pytest.approx(loss, rel=JAX_LOSS["rtol"],
                                                          abs=JAX_LOSS["atol"])
    # ranks 0 and 2 hold the two data coordinates' rows
    got = np.concatenate([sp[0]["steps"][0]["scores"], sp[2]["steps"][0]["scores"]])
    np.testing.assert_allclose(got, scores, **JAX_SCORES)
    weights, errs = sp[0]["weights"], {}
    for k, before in s.state.items():
        want, change = new[k] - before, weights[k].astype(np.float64) - before
        if k.endswith(ZERO_GRADIENT):  # noise alone: Adam moves it by lr at most
            assert np.abs(change).max() <= LR * 1.01, k
        elif np.linalg.norm(want) > 0:
            errs[k] = float(np.linalg.norm(change - want) / np.linalg.norm(want))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= CHANGE_REL_L2, (worst, errs[worst])


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_trainer_on_sp_mesh_matches_one_process(ranks, trainer_data, tmp_path):
    train, val = trainer_data
    trainer = Trainer(_trainer_exp(), tmp_path, tensorboard=False, device="cpu")
    trainer.init_state()
    trainer.fit(ArrayLoader(*train, batch_size=TRAINER_BATCH),
                ArrayLoader(*val, batch_size=TRAINER_BATCH), 1)
    (want,) = _csv(tmp_path / "training_log.csv")
    (got,) = _csv(f"{ranks['trainer_dir']}/training_log.csv")
    for key, value in want.items():
        if key != "epoch_seconds":
            assert float(got[key]) == pytest.approx(float(value), rel=CSV_REL, abs=CSV_ABS), key
    res = ranks["trainer"]
    assert all(r["metrics"] == res[0]["metrics"] for r in res)
    assert len({tuple(r["checksum"]) for r in res}) == 1
    assert all(r["step"] == TRAINER_ROWS[0] // TRAINER_BATCH for r in res)


def test_trainer_refuses_a_mesh_of_some_ranks(tmp_path):
    from sls_tpu_torch.parallel.mesh import Mesh

    part = Mesh(("data", "seq"), {"data": 1, "seq": 2}, (0, 1), {"data": 0, "seq": 0},
                {"data": None, "seq": None})
    with pytest.raises(ValueError, match="every rank"):
        Trainer(_trainer_exp(), tmp_path, tensorboard=False, device="cpu", mesh=part)


def test_cli_refuses_seq_parallel_training(capsys):
    """``cli.main`` trains no sequence-parallel run, as the reference's
    does not: the same rc 2 and message."""
    from sls_tpu.cli import main as jax_cli
    from sls_tpu_torch.cli import main as cli

    argv = ["--seq_parallel", "2", "--tiny"]
    assert cli.main(argv) == 2
    port = capsys.readouterr().out
    assert jax_cli.main(argv) == 2
    assert port == capsys.readouterr().out
    assert "--seq_parallel requires --is_eval" in port
