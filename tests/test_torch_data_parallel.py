"""The port's data-parallel train steps against the JAX package's data-mesh
step and against the port's own one-process step, on shared weights.

One job of two gloo ranks on the CPU (``parallel/launch.py``, spawned once
for the whole file) runs every multi-rank case: the flagship step (plain
SAE route, as the JAX side runs; and the kernel wrappers' route, whose
CPU form is the plain version inside the autograd Functions), the
window-hard + CPC step, the SLS step, the non-finite guard, the layerdrop
and dropout draws, and the global-batch helpers.  Each rank steps its
half of each global batch; the JAX side steps the whole batch on a
2-device data mesh of ``tests/conftest.py``'s virtual CPU devices.  The
JAX SLS step is computed as ``tests/test_torch_sls.py::jax_sls_step``
computes it (its jitted form gets the head's gradients wrong on
XLA:CPU, ROADMAP §3).  Every dropout rate is 0 where the packages are
compared (their random streams differ).

Limits: against JAX, the loss within rtol 1e-5 and the summed gradient
within rtol 1e-4 / atol 1e-5, the reference's own limits for sharded
against unsharded (``tests/test_tensor_parallel.py``); against the
port's one-process step on the same rows, the loss within 1e-6 and the
gradient within 1e-5 (the same sums, cut in two and added).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sls_tpu_torch import config as tcfg
from sls_tpu_torch.convert import detector_state_from_flax, sls_detector_state_from_flax
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.models.sls import SLSDetector, make_sls_train_step
from sls_tpu_torch.parallel import distributed as dist
from sls_tpu_torch.parallel import workers
from sls_tpu_torch.parallel.launch import launch
from sls_tpu_torch.train import steps as tsteps

RANKS = 2
D, M, K = 64, 256, 32
LR, WD = 1e-3, 1e-4
WAV_LEN = 1000
JAX_LOSS_RTOL, JAX_GRAD = 1e-5, dict(rtol=1e-4, atol=1e-5)
PORT_LOSS_RTOL, PORT_GRAD = 1e-6, dict(rtol=1e-5, atol=1e-5)
BN_TOL = 1e-5  # running statistics: fp32 sums over the same elements in another order
CHANGE_REL_L2 = 1e-3  # tests/test_torch_train_step.py
ZERO_GRADIENT = "self_attn.k_proj.bias"  # zero in exact arithmetic (tests/test_torch_sls.py)


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

    from sls_tpu import config as jcfg
    from sls_tpu.heads.sls import SLSHead
    from sls_tpu.models import sls as jsls
    from sls_tpu.models.detector import Detector as JaxDetector
    from sls_tpu.models.detector import total_loss
    from sls_tpu.parallel import distributed as jdist
    from sls_tpu.parallel.mesh import make_mesh
    from sls_tpu.train import steps as jsteps
    from sls_tpu.train.loss import weighted_nll

    return SimpleNamespace(jax=jax, jnp=jnp, cfg=jcfg, sls=jsls, Detector=JaxDetector,
                           total_loss=total_loss, dist=jdist, make_mesh=make_mesh,
                           steps=jsteps, weighted_nll=weighted_nll, SLSHead=SLSHead)


def _configs(J, kind):
    """(JAX, port) ExperimentConfigs of ``kind``: "flagship" (per-timestep
    SAE), "cpc" (window-hard SAE + CPC) or "sls" (no SAE)."""
    def build(m):
        if kind == "sls":
            model = m.ModelConfig(encoder=m.tiny_xlsr_config(), use_sae=False)
        else:
            sae = dict(activation_dim=D, dict_size=M, k=K)
            extra = {}
            if kind == "cpc":
                sae.update(variant="window_hard", window_size=4)
                extra = dict(use_cpc=True, cpc=m.CPCConfig(hidden_dim=32,
                                                           prediction_steps=(1, 2)))
            model = m.ModelConfig(encoder=m.tiny_xlsr_config(), sae=m.SAEConfig(**sae),
                                  classifier_hidden=32, classifier_dropout=0.0, **extra)
        return m.ExperimentConfig(model=model, train=m.TrainConfig(
            lr=LR, weight_decay=WD, cpc_weight=0.5, cut_length=WAV_LEN))

    return build(J.cfg), build(tcfg)


def _batches(seed, n, rows=4):
    """``n`` global batches of ``rows`` (2 a rank) float32 rows; the last
    row of each rank's half is invalid in the first batch."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        valid = np.ones(rows, np.float32)
        if i == 0:
            valid[rows // 2 - 1] = valid[-1] = 0.0
        out.append((rng.normal(0, 0.1, (rows, WAV_LEN)).astype(np.float32),
                    rng.integers(0, 2, rows).astype(np.int32), valid))
    return out


def _perturb(J, tree, seed):
    rng = np.random.default_rng(seed)
    return J.jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def setups(J):
    """Per kind: configs, JAX params (and batch stats), the port's state
    dict, and the batches."""
    out = {}
    for kind, seed in (("flagship", 0), ("cpc", 1), ("sls", 2)):
        jexp, pexp = _configs(J, kind)
        batches = _batches(seed, 3)
        wav = J.jnp.asarray(batches[0][0])
        if kind == "sls":
            v = J.sls.SLSDetector(jexp.model).init(J.jax.random.PRNGKey(0), wav, train=False)
            params, stats = _perturb(J, v["params"], seed + 10), v["batch_stats"]
            stats = J.jax.tree.map(np.asarray, stats)
            state = sls_detector_state_from_flax(params, stats)
        else:
            params = _perturb(J, J.Detector(jexp.model).init(
                J.jax.random.PRNGKey(0), wav, compute_cpc=kind == "cpc")["params"], seed + 10)
            stats, state = None, detector_state_from_flax(params)
        out[kind] = SimpleNamespace(jexp=jexp, pexp=pexp, params=params, stats=stats,
                                    state={k: v.numpy().copy() for k, v in state.items()},
                                    batches=batches)
    return out


def _pallas(pexp):
    import dataclasses

    return dataclasses.replace(pexp, model=dataclasses.replace(
        pexp.model, sae=dataclasses.replace(pexp.model.sae, use_pallas=True)))


def _with_rates(pexp, **enc):
    import dataclasses

    return dataclasses.replace(pexp, model=dataclasses.replace(
        pexp.model, encoder=dataclasses.replace(pexp.model.encoder, **enc)))


@pytest.fixture(scope="module")
def ranks(setups):
    """The two ranks' results of every job, spawned once."""
    f, c, s = setups["flagship"], setups["cpc"], setups["sls"]
    draws_wav = np.random.default_rng(9).normal(0, 0.1, (2, WAV_LEN)).astype(np.float32)
    jobs = [
        # the guard: a NaN in rank 1's half of the second batch
        ("train_steps_rank", (f.pexp, "detector", f.state, f.batches), dict(nan_step=1)),
        ("train_steps_rank", (_pallas(f.pexp), "detector", f.state, f.batches[:1]), {}),
        ("train_steps_rank", (c.pexp, "detector", c.state, c.batches[:1]), {}),
        ("train_steps_rank", (s.pexp, "sls", s.state, s.batches[:2]), dict(nan_step=1)),
        ("draws_rank", (_with_rates(f.pexp, layerdrop=0.5), draws_wav, 3), {}),
        ("draws_rank", (_with_rates(f.pexp, dropout=0.1), draws_wav, 3), {}),
        ("global_batch_rank", (3,), {}),
    ]
    res = launch(workers.jobs_rank, RANKS, (jobs,), device_type="cpu")
    names = ("flagship", "flagship_kernels", "cpc", "sls", "layerdrop", "dropout", "helpers")
    return {name: [r[i] for r in res] for i, name in enumerate(names)}


def _one_process(pexp, family, state_dict, batches, skip=()):
    """The port's one-process step over the whole batches: per step the
    loss terms and the gradient the optimizer got; then the weights."""
    cut = batches[0][0].shape[1]
    if family == "sls":
        model = SLSDetector(pexp.model, device="cpu", cut_length=cut)
        step = make_sls_train_step(model, pexp, device="cpu")
    else:
        model = Detector(pexp.model, device="cpu")
        step = tsteps.make_train_step(model, pexp, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    state = tsteps.create_train_state(model, pexp)
    grads, terms = [], []
    update = tsteps.AdamL2.update

    def capture(self, st, g, finite):
        grads.append(g.clone().numpy())
        return update(self, st, g, finite)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsteps.AdamL2, "update", capture)
        for i, (wav, labels, valid) in enumerate(batches):
            if i in skip:
                state.calls += 1  # the rejected call still counts
                continue
            _, m = step(state, wav, labels, valid, 0)
            terms.append([float(m[k]) for k in ("loss", "cls_loss", "sae_loss", "cpc_loss")])
    return terms, grads, model, state


def _jax_flat(J, grads, names, stats=None):
    tree = (sls_detector_state_from_flax(grads, stats) if stats is not None
            else detector_state_from_flax(grads))
    return np.concatenate([tree[n].numpy().reshape(-1) for n in names])


def _jax_detector_step(J, setup):
    """The JAX step on a 2-device data mesh over the whole first batch:
    its loss, and its gradient laid out as the port's flat buffer."""
    jax, jnp = J.jax, J.jnp
    jexp = setup.jexp
    wav, labels, valid = (jnp.asarray(x) for x in setup.batches[0])
    jmodel = J.Detector(jexp.model)
    mesh = J.make_mesh(jax.devices()[:RANKS])
    mask = J.steps.trainable_decay_mask(jexp)
    jstate = J.steps.TrainState.create(
        apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, setup.params),
        tx=J.steps.make_optimizer(LR, WD, mask, trainable_mask=mask))
    _, m = J.steps.make_train_step(jmodel, jexp, mesh)(jstate, wav, labels, valid,
                                                       jax.random.PRNGKey(0))
    cpc = jexp.model.use_cpc

    def loss_fn(p, w, y, v):
        out = jmodel.apply({"params": p}, w, train=True, compute_cpc=cpc,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        cls = J.weighted_nll(out["log_probs"], y, jexp.train.loss_weights, v)
        return J.total_loss(cls, out["sae_loss"], jexp.train.sae_weight, out["cpc_loss"],
                            jexp.train.cpc_weight if cpc else 0.0)

    data = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
    grads = jax.jit(jax.grad(loss_fn), in_shardings=(None, data, data, data))(
        jax.tree.map(jnp.asarray, setup.params), wav, labels, valid)
    return float(m["loss"]), jax.device_get(grads)


def _names(pexp, family):
    model = (SLSDetector(pexp.model, device="meta", cut_length=WAV_LEN) if family == "sls"
             else Detector(pexp.model, device="meta"))
    return tsteps.trainable_names(model, pexp.model)


@pytest.mark.parametrize("kind", ["flagship", "cpc"])
def test_step_matches_jax_data_mesh(J, setups, ranks, kind):
    setup = setups[kind]
    loss, grads = _jax_detector_step(J, setup)
    want = _jax_flat(J, grads, _names(setup.pexp, "detector"))
    for r in ranks[kind]:
        got = r["steps"][0]
        assert got["finite"]
        assert got["terms"][0] == pytest.approx(loss, rel=JAX_LOSS_RTOL)
        np.testing.assert_allclose(got["grad"], want, **JAX_GRAD)
    if kind == "cpc":
        assert ranks[kind][0]["steps"][0]["terms"][3] > 0  # the InfoNCE term is there


@pytest.mark.parametrize("kind", ["flagship", "flagship_kernels", "cpc"])
def test_step_matches_one_process_step(setups, ranks, kind):
    setup = setups["cpc" if kind == "cpc" else "flagship"]
    pexp = _pallas(setup.pexp) if kind == "flagship_kernels" else setup.pexp
    n = len(ranks[kind][0]["steps"])
    # the flagship job's second batch was rejected on both ranks
    terms, grads, model, _ = _one_process(pexp, "detector", setup.state, setup.batches[:n],
                                          skip=(1,) if kind == "flagship" else ())
    done = [i for i in range(n) if not (kind == "flagship" and i == 1)]
    for r in ranks[kind]:
        for j, i in enumerate(done):
            got = r["steps"][i]
            np.testing.assert_allclose(got["terms"], terms[j], rtol=PORT_LOSS_RTOL, atol=1e-7)
            np.testing.assert_allclose(got["grad"], grads[j], **PORT_GRAD)
    # after the steps the ranks hold the same weights, bit for bit
    a, b = ranks[kind]
    assert a["checksum"] == b["checksum"] and a["step"] == b["step"] == len(done)
    # each parameter's change against the one-process step's (relative L2):
    # Adam divides each gradient by its own root mean square, so rounding
    # noise in a near-zero gradient moves its update by up to lr
    # (tests/test_torch_train_step.py's CHANGE_REL_L2)
    errs = {}
    for k, p in model.named_parameters():
        want = p.detach().double().numpy() - setup.state[k]
        change = a["weights"][k].astype(np.float64) - setup.state[k]
        if k.endswith(ZERO_GRADIENT):  # noise alone: Adam moves it by lr at most
            assert np.abs(change).max() <= LR * len(done) * 1.01, k
        elif np.linalg.norm(want) > 0:
            errs[k] = float(np.linalg.norm(change - want) / np.linalg.norm(want))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= CHANGE_REL_L2, (worst, errs[worst])


def test_nonfinite_batch_on_one_rank_rejects_on_both(ranks):
    for kind in ("flagship", "sls"):
        for r in ranks[kind]:
            bad = r["steps"][1]
            assert not bad["finite"] and bad["bits_kept"], kind
            assert not np.isfinite(bad["terms"][0])
        assert ranks[kind][0]["checksum"] == ranks[kind][1]["checksum"]


def test_sls_step_matches_jax_and_one_process(J, setups, ranks):
    """The reference's SLS step on the whole batch, computed as
    ``tests/test_torch_sls.py::jax_sls_step`` computes it (the encoder's
    forward and backward jitted, the head eager): its loss, gradient and
    BatchNorm update; and the port's one-process step."""
    from sls_tpu.encoder.xlsr import XLSREncoder

    setup = setups["sls"]
    jax, jnp = J.jax, J.jnp
    mcfg = setup.jexp.model
    enc, head = XLSREncoder(mcfg.encoder), J.SLSHead(dtype=mcfg.encoder.dtype)
    wav, labels, valid = (jnp.asarray(x) for x in setup.batches[0])
    p = jax.tree.map(jnp.asarray, setup.params)
    encode = jax.jit(lambda pe, w: enc.apply({"params": pe}, w, train=True,
                                             return_hidden_states=True,
                                             rngs={"dropout": jax.random.PRNGKey(0)}))
    (final, hiddens), vjp = jax.vjp(encode, p["encoder"], wav)

    def head_loss(ph, hs):
        log_probs, upd = head.apply({"params": ph, "batch_stats": setup.stats["sls_head"]}, hs,
                                    train=True, mutable=["batch_stats"])
        return J.weighted_nll(log_probs, labels, setup.jexp.train.loss_weights, valid), upd

    with jax.disable_jit():
        (loss, upd), (g_head, g_hs) = jax.value_and_grad(
            head_loss, argnums=(0, 1), has_aux=True)(p["sls_head"], hiddens)
    g_enc = vjp((jnp.zeros_like(final), g_hs))[0]
    want = _jax_flat(J, jax.device_get({"encoder": g_enc, "sls_head": g_head}),
                     _names(setup.pexp, "sls"), stats=setup.stats)
    terms, grads, model, _ = _one_process(setup.pexp, "sls", setup.state, setup.batches[:1])
    for r in ranks["sls"]:
        got = r["steps"][0]
        assert got["finite"]
        assert got["terms"][0] == pytest.approx(float(loss), rel=JAX_LOSS_RTOL)
        assert got["terms"][0] == pytest.approx(terms[0][0], rel=PORT_LOSS_RTOL)
        np.testing.assert_allclose(got["grad"], want, **JAX_GRAD)
        np.testing.assert_allclose(got["grad"], grads[0], **PORT_GRAD)
    # the running statistics: bit-equal on both ranks (the checksums cover
    # the buffers), 0.9 old + 0.1 the global batch's as the reference's
    a, b = ranks["sls"]
    assert a["checksum"] == b["checksum"]
    bn = jax.device_get(upd)["batch_stats"]["first_bn"]
    w, first_bn = a["weights"], model.sls_head.first_bn
    for name, jax_value, port_value in (("mean", bn["mean"], first_bn.running_mean),
                                        ("var", bn["var"], first_bn.running_var)):
        got = w[f"sls_head.first_bn.running_{name}"]
        np.testing.assert_allclose(got, np.asarray(jax_value), rtol=BN_TOL, atol=1e-7)
        np.testing.assert_allclose(got, port_value.numpy(), rtol=BN_TOL, atol=1e-7)


def test_layerdrop_alike_and_dropout_by_rank(ranks, setups):
    a, b = ranks["layerdrop"]
    assert np.array_equal(a["features"], b["features"])  # the same layers dropped
    a, b = ranks["dropout"]
    assert not np.allclose(a["features"], b["features"])  # masks differ by rank


def test_one_rank_draws_as_before():
    """Without a data axis the step draws dropout and layerdrop from the
    one generator of (base seed, call), as before the data-parallel step."""
    gen, ld_gen = tsteps.step_generators(7, 3, "cpu", None)
    assert ld_gen is None
    want = tsteps.dropout_generator(7, 3, "cpu")
    assert torch.equal(torch.rand(8, generator=gen), torch.rand(8, generator=want))
    ranked = tsteps.dropout_generator(7, 3, "cpu", rank=1)
    assert not torch.equal(torch.rand(8, generator=ranked),
                           torch.rand(8, generator=tsteps.dropout_generator(7, 3, "cpu")))


def test_global_batch_helpers_match_jax(J, ranks):
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    # one process: the identity, as the reference's
    (t,), rows = dist.global_batch((x,), None, device=torch.device("cpu"))
    assert rows == 4 and np.array_equal(dist.local_rows(t), x)
    np.testing.assert_array_equal(dist.fetch_global(t), np.asarray(J.dist.fetch_global(x)))
    np.testing.assert_array_equal(dist.local_rows(x), np.asarray(J.dist.local_rows(x)))
    # two ranks: every rank's rows in rank order
    want = np.concatenate([np.arange(9, dtype=np.float32).reshape(3, 3) + 100 * r
                           for r in range(RANKS)])
    for rank, r in enumerate(ranks["helpers"]):
        assert r["rows"] == 3 * RANKS
        np.testing.assert_array_equal(r["local"], want[3 * rank:3 * rank + 3])
        np.testing.assert_array_equal(r["fetched"], want)
        np.testing.assert_array_equal(r["fetched_host"], want)
