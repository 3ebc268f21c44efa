"""The port's train step against the JAX package's: three Adam steps of
``make_train_step`` from the same weights on the same batches, with and
without ``freeze_encoder``; the optimizer alone against
``torch.optim.Adam`` and the JAX package's optax chain; the on-device
non-finite guard; parameters without a gradient; layerdrop.

The JAX side reaches the Pallas SAE kernels (``use_pallas``, the
flagship routing) through their custom VJPs in interpret mode, as
``tests/test_kernels.py`` runs them.  Every dropout rate is 0 where the
two packages are compared (their random streams differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sls_tpu.kernels.sae_kernels as jax_sk
from sls_tpu.config import ExperimentConfig, ModelConfig, SAEConfig, TrainConfig, tiny_xlsr_config
from sls_tpu.models.detector import Detector as JaxDetector
from sls_tpu.train.steps import TrainState as JaxTrainState
from sls_tpu.train.steps import make_optimizer as jax_make_optimizer
from sls_tpu.train.steps import make_train_step as jax_make_train_step
from sls_tpu.train.steps import trainable_decay_mask
from sls_tpu_torch import config as tcfg
from sls_tpu_torch.convert import detector_state_from_flax
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.train.steps import (
    AdamL2,
    create_train_state,
    make_optimizer,
    make_train_step,
    trainable_names,
)

D, M, K = 64, 256, 32
LR, WD, STEPS = 1e-3, 1e-4, 3
# each parameter's change over the steps (relative L2): Adam divides each
# gradient by its own root mean square, so rounding noise in a small
# gradient moves its update by up to lr.  Measured 3.5e-4 on the key
# projection's bias (its gradient is wd * p plus noise: zero in exact
# arithmetic) and 6.3e-5 at most elsewhere.
CHANGE_REL_L2 = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these tiny CPU models: the suite's parallel
    workers then do not oversubscribe the cores (no result depends on
    the thread count within a test)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _exp_configs(freeze, **enc):
    sae = dict(activation_dim=D, dict_size=M, k=K, use_pallas=True)
    train = dict(lr=LR, weight_decay=WD)
    jexp = ExperimentConfig(
        model=ModelConfig(encoder=tiny_xlsr_config(**enc), sae=SAEConfig(**sae),
                          freeze_encoder=freeze, classifier_dropout=0.0),
        train=TrainConfig(**train))
    pexp = tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(**enc), sae=tcfg.SAEConfig(**sae),
                               freeze_encoder=freeze, classifier_dropout=0.0),
        train=tcfg.TrainConfig(**train))
    return jexp, pexp


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
def batches():
    """STEPS batches of int16 wire audio, labels and valid masks."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        wav = np.round(rng.normal(0, 0.1, (3, 4000)) * 32768).astype(np.int16)
        out.append((wav, rng.integers(0, 2, 3).astype(np.int32),
                    np.array([1.0, 1.0, 0.0], np.float32)))
    return out


@pytest.fixture(scope="module")
def params(batches, interpret_kernels):
    jexp, _ = _exp_configs(False)
    p = JaxDetector(jexp.model).init(
        jax.random.PRNGKey(0), jnp.asarray(batches[0][0], jnp.float32) / 32768)["params"]
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), p)


def _port_model(pexp, params):
    model = Detector(pexp.model, device="cpu")
    model.load_state_dict(detector_state_from_flax(params), strict=True)
    return model


def _snapshot(model, state):
    return ({n: p.detach().clone() for n, p in model.named_parameters()},
            state.exp_avg.clone(), state.exp_avg_sq.clone(), state.step.clone())


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32)) if a.is_floating_point() \
        else torch.equal(a, b)


@pytest.fixture(scope="module", params=[False, True], ids=["unfrozen", "frozen"])
def runs(request, params, batches, interpret_kernels):
    """(freeze, port model, its state, JAX params after STEPS steps, the
    per-step losses of both)."""
    freeze = request.param
    jexp, pexp = _exp_configs(freeze)
    jmodel = JaxDetector(jexp.model)
    mask = trainable_decay_mask(jexp)
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, params),
        tx=jax_make_optimizer(LR, WD, mask, trainable_mask=mask))
    jstep = jax_make_train_step(jmodel, jexp)
    model = _port_model(pexp, params)
    state = create_train_state(model, pexp)
    step = make_train_step(model, pexp, device="cpu")
    j_losses, p_losses = [], []
    for wav, labels, valid in batches:
        jstate, jm = jstep(jstate, jnp.asarray(wav), jnp.asarray(labels), jnp.asarray(valid),
                           jax.random.PRNGKey(0))
        state, pm = step(state, wav, labels, valid, 0)
        j_losses.append(float(jm["loss"]))
        p_losses.append(float(pm["loss"]))
        assert bool(pm["finite"]) and int(pm["correct"]) == int(jm["correct"])
    return freeze, model, state, jax.tree.map(np.asarray, jstate.params), j_losses, p_losses


def test_three_adam_steps_match_jax(runs, params):
    freeze, model, state, j_params, j_losses, p_losses = runs
    # the first loss is of the same weights; later ones of weights whose
    # changes agree within CHANGE_REL_L2 (1.3e-5 apart at most, measured)
    assert p_losses[0] == pytest.approx(j_losses[0], rel=1e-5)
    np.testing.assert_allclose(p_losses[1:], j_losses[1:], rtol=1e-4)
    assert int(state.step) == STEPS
    start = detector_state_from_flax(params)
    ref = detector_state_from_flax(j_params)
    errs = {}
    for n, p in model.named_parameters():
        if freeze and n.startswith("encoder."):
            assert torch.equal(p.detach(), start[n]), n
            continue
        change, want = (p.detach() - start[n]).double(), (ref[n] - start[n]).double()
        errs[n] = float((change - want).norm() / want.norm())
    worst = max(errs, key=errs.get)
    assert errs[worst] <= CHANGE_REL_L2, (worst, errs[worst])


def test_frozen_encoder_has_no_moments(runs):
    freeze, model, state, *_ = runs
    names = [n for n, _ in model.named_parameters()]
    want = [n for n in names if not (freeze and n.startswith("encoder."))]
    assert state.names == want == trainable_names(model, model.config)
    numel = dict((n, p.numel()) for n, p in model.named_parameters())
    assert state.exp_avg.numel() == state.exp_avg_sq.numel() == sum(numel[n] for n in want)
    if freeze:
        with pytest.raises(KeyError):
            state.moments("encoder.post_extract_proj.weight")
    m, v = state.moments("sae.W_enc")
    assert m.shape == model.sae.W_enc.shape and float(v.abs().sum()) > 0


def _grad_fn(param: np.ndarray, step: int) -> np.ndarray:
    """Deterministic parameter-dependent pseudo-gradients
    (tests/test_optimizer_parity.py)."""
    return np.sin(param * (1.0 + 0.1 * step)) + 0.01 * param ** 2


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4, 1e-2])
def test_adam_matches_torch_and_optax(weight_decay):
    rng = np.random.default_rng(0)
    p0 = {"w": rng.normal(0, 1, (7, 5)).astype(np.float32),
          "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    ours = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    state = create_train_state_for(ours)
    theirs = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    t_opt = torch.optim.Adam(theirs.values(), lr=1e-3, weight_decay=weight_decay,
                             betas=(0.9, 0.999), eps=1e-8)
    tx = jax_make_optimizer(1e-3, weight_decay)
    j_params = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(j_params)
    opt = make_optimizer(1e-3, weight_decay)
    for step in range(5):
        grads = {k: _grad_fn(np.asarray(j_params[k]), step) for k in p0}
        for k in p0:  # every side sees the same gradient at the same point
            ours[k].data = torch.from_numpy(np.asarray(j_params[k]).copy())
            theirs[k].data = ours[k].data.clone()
            ours[k].grad = torch.from_numpy(grads[k].copy())
            theirs[k].grad = torch.from_numpy(grads[k].copy())
        state.params = list(ours.values())
        opt.apply(state, torch.tensor(True))
        t_opt.step()
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                       opt_state, j_params)
        j_params = {k: j_params[k] + updates[k] for k in p0}
        for k in p0:
            np.testing.assert_allclose(ours[k].detach().numpy(), theirs[k].detach().numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=f"torch, step {step} {k}")
            np.testing.assert_allclose(ours[k].detach().numpy(), np.asarray(j_params[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"optax, step {step} {k}")
    assert int(state.step) == 5


def create_train_state_for(named):
    """A TrainState over the parameters of ``named`` (no model)."""
    module = torch.nn.Module()
    for k, p in named.items():
        module.register_parameter(k, p)
    return create_train_state(module, tcfg.ExperimentConfig())


def test_missing_gradient_is_a_zero_gradient():
    rng = np.random.default_rng(0)
    start = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in (("a", (4, 3)), ("b", (3,)))}
    results = []
    for zero in (False, True):
        named = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in start.items()}
        state = create_train_state_for(named)
        opt = AdamL2(1e-2, 1e-2)
        for _ in range(2):
            named["a"].grad = torch.ones(4, 3)
            named["b"].grad = torch.zeros(3) if zero else None
            opt.apply(state, torch.tensor(True))
        results.append((named["b"].detach().clone(), state.moments("b")))
    (b0, (m0, v0)), (b1, (m1, v1)) = results
    assert torch.equal(b0, b1) and torch.equal(m0, m1) and torch.equal(v0, v1)
    assert not torch.equal(b0, torch.from_numpy(start["b"]))  # the decay moved it
    assert float(v0.abs().min()) > 0


def _guard_run(params, batches, bad_at=None):
    """The port's step over ``batches`` (float32 wire), with a NaN batch
    inserted before index ``bad_at``; returns the model, the state, and
    the snapshots taken around the NaN batch."""
    _, pexp = _exp_configs(False)
    model = _port_model(pexp, params)
    state = create_train_state(model, pexp)
    step = make_train_step(model, pexp, device="cpu")
    around = None
    for i, (wav, labels, valid) in enumerate(batches):
        wav = wav.astype(np.float32) / 32768
        if i == bad_at:
            bad = wav.copy()
            bad[1, 100] = np.nan
            before = _snapshot(model, state)
            state, metrics = step(state, bad, labels, valid, 0)
            around = (before, _snapshot(model, state), metrics)
        state, metrics = step(state, wav, labels, valid, 0)
        assert bool(metrics["finite"])
    return model, state, around


def test_non_finite_guard_keeps_the_state(params, batches):
    model, state, (before, after, metrics) = _guard_run(params, batches, bad_at=1)
    assert not bool(metrics["finite"]) and not np.isfinite(float(metrics["loss"]))
    params0, m0, v0, step0 = before
    params1, m1, v1, step1 = after
    assert all(_bit_equal(params0[n], params1[n]) for n in params0)
    assert _bit_equal(m0, m1) and _bit_equal(v0, v1) and torch.equal(step0, step1)
    assert int(step1) == 1 and int(state.step) == STEPS
    # the next finite step is the step of a run that never saw the bad batch
    clean_model, clean_state, _ = _guard_run(params, batches)
    for (n, p), q in zip(model.named_parameters(), clean_model.parameters()):
        assert _bit_equal(p.detach(), q.detach()), n
    assert _bit_equal(state.exp_avg, clean_state.exp_avg)
    assert _bit_equal(state.exp_avg_sq, clean_state.exp_avg_sq)


def test_dropped_layers_still_decay(params, batches):
    """layerdrop 1 drops every layer in every step: their parameters get a
    zero gradient (compute-and-select), so Adam moves them by the L2 term
    alone: on the first step by -lr * wd p / (|wd p| + eps) (bias
    corrections cancel)."""
    _, pexp = _exp_configs(False, layerdrop=1.0)
    model = _port_model(pexp, params)
    state = create_train_state(model, pexp)
    step = make_train_step(model, pexp, device="cpu")
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    wav, labels, valid = batches[0]
    step(state, wav, labels, valid, 0)
    layer = [n for n in start if n.startswith("encoder.layers.")]
    assert layer
    for n in layer:
        p0 = start[n].double()
        g = WD * p0
        want = p0 - LR * g / (g.abs() + 1e-8)
        np.testing.assert_allclose(model.get_parameter(n).detach().double().numpy(),
                                   want.numpy(), rtol=1e-6, atol=1e-9, err_msg=n)
        m, v = state.moments(n)
        assert torch.equal(m.double() == 0, p0 == 0)
    # and the layers' outputs were dropped: the encoder is its front-end
    with torch.no_grad():
        x = torch.from_numpy(wav.astype(np.float32) / 32768)
        enc = model.encoder
        h = enc.post_extract_proj(enc.post_extract_norm(enc.feature_extractor(x)))
        h = enc.encoder_layer_norm(h + enc.pos_conv(h))
        feats = enc(x, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(feats, h)
