"""The port's SLS family (``heads/sls.py``, ``models/sls.py``) against the
JAX package's on the same weights and inputs: the head in both input
forms (fp32, and bf16 within the JAX package's own bf16 envelope), the
BatchNorm's training statistics where biased and unbiased variance
differ visibly, the detector's log-probs, two train steps (loss,
parameters and running statistics), the non-finite guard, a frozen
encoder, the layer-gate profile, and the int16 wire against float32.

The JAX SLS steps feed the wire to the encoder undecoded (ROADMAP §3), so
the two packages are compared on the float32 wire; the port's int16 wire
is held to its own float32 wire.  Every dropout rate is 0 where the
packages are compared (their random streams differ).

The JAX package's jitted SLS train step gets its gradients wrong on
XLA:CPU (ROADMAP §3): the head's max-pool (crop, reshape, ``jnp.max``)
takes its gradient by comparing the input with the maximum, and in the
fused program the input is recomputed with other rounding, so the
comparison fails (first_bn.bias's gradient -7.40 jitted against -3.32
eager and -3.32 by central differences; NaN where no entry of a window
compares equal).  ``jax_sls_step`` is that step's computation in two
programs: the encoder's forward and backward jitted (``jax.vjp``), the
head eagerly, then the reference's optimizer, guard and BatchNorm update.
Its gradients are the eager step's, which central differences confirm.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sls_tpu_torch import config as tcfg
from sls_tpu_torch.convert import detector_state_from_flax, sls_detector_state_from_flax
from sls_tpu_torch.data.pipeline import to_wire
from sls_tpu_torch.heads.sls import SLSHead
from sls_tpu_torch.models.sls import (
    SLSDetector,
    create_sls_train_state,
    layer_gate_profile,
    make_sls_eval_step,
    make_sls_train_step,
)

WAV_LEN, BATCH = 4000, 3
LR, WD, STEPS = 1e-4, 1e-4, 2
HEAD_TOL = 1e-5       # fp32: the same products summed in other orders
DETECTOR_TOL = 1e-4   # the tiny fp32 encoder, sums in other orders (as test_torch_detector)
BN_TOL = 1e-5         # running statistics: fp32 means over the same elements
# each parameter's change over the steps (relative L2), as
# tests/test_torch_train_step.py holds it; the key projections' biases
# move by rounding alone (their exact gradient is wd * p; see there)
CHANGE_REL_L2 = 1e-3
ZERO_GRADIENT = "self_attn.k_proj.bias"
# the bf16 head against the JAX bf16 head: within 1.5x of the JAX bf16
# head's own distance from the fp32 head, and within 2x of it from the
# JAX bf16 head (chip_smoke.py's ROUTE_ENVELOPE form)
BF16_ENVELOPE = (1.5, 2.0)


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
    from sls_tpu.heads.sls import SLSHead as JaxSLSHead
    from sls_tpu.models import sls as jsls
    from sls_tpu.train import steps as jsteps

    return SimpleNamespace(jax=jax, jnp=jnp, cfg=jcfg, SLSHead=JaxSLSHead, sls=jsls,
                           steps=jsteps)


def _perturb(J, tree, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return J.jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.normal(size=a.shape).astype(np.float32), tree)


# -- the head -------------------------------------------------------------------------

L, HB, HT, HC = 3, 2, 20, 12  # layers, rows, frames, channels of the head tests


def _head_vars(J, dtype):
    hs = np.random.default_rng(0).normal(size=(L, HB, HT, HC)).astype(np.float32)
    variables = J.SLSHead(hidden_dim=16, dtype=dtype).init(
        J.jax.random.PRNGKey(0), [J.jnp.asarray(h) for h in hs])
    params = _perturb(J, variables["params"], 1, scale=0.1)
    stats = {"first_bn": {"mean": np.array([0.1], np.float32),
                          "var": np.array([1.3], np.float32)}}
    return hs, params, stats


def _port_head(params, stats, dtype):
    head = SLSHead(HC, HT, hidden_dim=16, dtype=dtype, device="cpu")
    head.load_state_dict(sls_detector_state_from_flax(params, stats), strict=True)
    return head


@pytest.mark.parametrize("form", ["list", "stacked"])
def test_head_matches_jax_fp32(J, form):
    hs, params, stats = _head_vars(J, J.jnp.float32)
    jin = [J.jnp.asarray(h) for h in hs] if form == "list" else J.jnp.asarray(hs)
    want = np.asarray(J.SLSHead(hidden_dim=16).apply(
        {"params": params, "batch_stats": stats}, jin))
    head = _port_head(params, stats, torch.float32)
    tin = [torch.from_numpy(h) for h in hs] if form == "list" else torch.from_numpy(hs)
    got, bn = head(tin)
    assert bn is None
    np.testing.assert_allclose(got.detach().numpy(), want, atol=HEAD_TOL, rtol=0)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_head_bf16_within_the_jax_envelope(J):
    """64 rows, fc1 of 96 -> 64 in bf16: relative L2 over the log-probs.
    (The port's bf16 ``Dense`` rounds x @ W + b once, the reference's
    x @ W and then the bias add: one bf16 ulp apart at times, so a
    handful of outputs is too few for the envelope.)"""
    B, T, C, H = 64, 20, 48, 64
    hs = np.random.default_rng(5).normal(size=(L, B, T, C)).astype(np.float32)
    hs_bf = [J.jnp.asarray(h, J.jnp.bfloat16) for h in hs]
    variables = J.SLSHead(hidden_dim=H).init(J.jax.random.PRNGKey(0), hs_bf)
    v = {"params": _perturb(J, variables["params"], 6, scale=0.1),
         "batch_stats": {"first_bn": {"mean": np.array([0.1], np.float32),
                                      "var": np.array([1.3], np.float32)}}}
    truth = np.asarray(J.SLSHead(hidden_dim=H).apply(
        v, [h.astype(J.jnp.float32) for h in hs_bf]))
    j_bf = np.asarray(J.SLSHead(hidden_dim=H, dtype=J.jnp.bfloat16).apply(v, hs_bf))
    head = SLSHead(C, T, hidden_dim=H, dtype=torch.bfloat16, device="cpu")
    head.load_state_dict(sls_detector_state_from_flax(v["params"], v["batch_stats"]),
                         strict=True)
    got, _ = head([torch.from_numpy(np.array(h.astype(J.jnp.float32))).bfloat16()
                   for h in hs_bf])
    got = got.detach().float().numpy()
    envelope = _rel_l2(j_bf, truth)
    assert envelope > 0  # the bf16 fc1 rounds
    assert _rel_l2(got, truth) <= BF16_ENVELOPE[0] * envelope
    assert _rel_l2(got, j_bf) <= BF16_ENVELOPE[1] * envelope


def test_batchnorm_train_statistics_match_flax(J):
    """At 2 x 5 x 6 = 60 elements the unbiased variance is 60/59 of the
    biased one: torch's BatchNorm2d running update would differ visibly."""
    hs = np.random.default_rng(3).normal(1.0, 2.0, size=(2, 2, 5, 6)).astype(np.float32)
    jhead = J.SLSHead(hidden_dim=8)
    variables = jhead.init(J.jax.random.PRNGKey(0), [J.jnp.asarray(h) for h in hs])
    params = _perturb(J, variables["params"], 4, scale=0.1)
    stats = {"first_bn": {"mean": np.array([0.2], np.float32),
                          "var": np.array([0.7], np.float32)}}
    want, updates = jhead.apply({"params": params, "batch_stats": stats},
                                [J.jnp.asarray(h) for h in hs], train=True,
                                mutable=["batch_stats"])
    head = SLSHead(6, 5, hidden_dim=8, device="cpu")
    head.load_state_dict(sls_detector_state_from_flax(params, stats), strict=True)
    got, bn_stats = head([torch.from_numpy(h) for h in hs], train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=HEAD_TOL, rtol=0)
    assert torch.equal(head.first_bn.running_var, torch.tensor([0.7]))  # forward wrote nothing
    head.first_bn.commit(bn_stats, torch.tensor(True))
    new = updates["batch_stats"]["first_bn"]
    np.testing.assert_allclose(head.first_bn.running_mean.numpy(), np.asarray(new["mean"]),
                               rtol=BN_TOL)
    np.testing.assert_allclose(head.first_bn.running_var.numpy(), np.asarray(new["var"]),
                               rtol=BN_TOL)
    # torch's own module updates with the unbiased variance
    fused = torch.einsum("lbtc,lb->btc", torch.from_numpy(hs),
                         head.gates([torch.from_numpy(h) for h in hs]).detach())
    rm, rv = torch.tensor([0.2]), torch.tensor([0.7])
    torch.nn.functional.batch_norm(fused[:, None], rm, rv, training=True, momentum=0.1)
    assert abs(float(rv) - float(new["var"][0])) > 100 * BN_TOL * float(new["var"][0])
    # a rejected step commits nothing
    before = head.first_bn.running_var.clone()
    head.first_bn.commit(bn_stats, torch.tensor(False))
    assert torch.equal(head.first_bn.running_var, before)


# -- the detector and its steps ----------------------------------------------------------


def _configs(J, freeze=False):
    train = dict(lr=LR, weight_decay=WD, cut_length=WAV_LEN)
    jexp = J.cfg.ExperimentConfig(
        model=J.cfg.ModelConfig(encoder=J.cfg.tiny_xlsr_config(), use_sae=False,
                                freeze_encoder=freeze),
        train=J.cfg.TrainConfig(**train))
    pexp = tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(), use_sae=False,
                               freeze_encoder=freeze),
        train=tcfg.TrainConfig(**train))
    return jexp, pexp


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [(rng.normal(0, 0.1, (BATCH, WAV_LEN)).astype(np.float32),
             rng.integers(0, 2, BATCH).astype(np.int32), np.array([1.0, 1.0, 0.0], np.float32))
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def variables(J, batches):
    """The JAX SLSDetector's params (moved off the initialiser) and
    non-trivial running statistics."""
    jexp, _ = _configs(J)
    v = J.sls.SLSDetector(jexp.model).init(J.jax.random.PRNGKey(0),
                                           J.jnp.asarray(batches[0][0]))
    stats = {"sls_head": {"first_bn": {"mean": np.array([0.05], np.float32),
                                       "var": np.array([0.8], np.float32)}}}
    return _perturb(J, v["params"], 1), stats


def _port(pexp, variables):
    model = SLSDetector(pexp.model, device="cpu", cut_length=pexp.train.cut_length)
    model.load_state_dict(sls_detector_state_from_flax(*variables), strict=True)
    return model


def test_detector_eval_matches_jax(J, variables, batches):
    jexp, pexp = _configs(J)
    wav = batches[0][0]
    params, stats = variables
    want = J.sls.make_sls_eval_step(J.sls.SLSDetector(jexp.model))(params, stats,
                                                                    J.jnp.asarray(wav))
    model = _port(pexp, variables)
    assert model.sls_head.fc1.weight.shape[1] == (199 // 3) * (64 // 3)
    got = make_sls_eval_step(model, device="cpu")(wav)
    np.testing.assert_allclose(got["log_probs"].numpy(), np.asarray(want["log_probs"]),
                               atol=DETECTOR_TOL, rtol=0)
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]),
                               atol=DETECTOR_TOL, rtol=0)
    with torch.inference_mode():
        assert torch.equal(model.score(torch.from_numpy(wav)), got["log_probs"])


def jax_sls_step(J, jexp):
    """step(state, wav, labels, valid) -> (state, metrics): the JAX
    package's ``make_sls_train_step`` computed without the fused program
    that XLA:CPU gets wrong (module docstring).  Dropout is off."""
    from sls_tpu.encoder.xlsr import XLSREncoder
    from sls_tpu.train.loss import weighted_nll

    jax, jnp = J.jax, J.jnp
    mcfg, tcfg_ = jexp.model, jexp.train
    enc = XLSREncoder(mcfg.encoder)
    head = J.SLSHead(dtype=mcfg.encoder.dtype)

    @jax.jit
    def encode(p_enc, wav):
        return enc.apply({"params": p_enc}, wav, train=True, return_hidden_states=True,
                         rngs={"dropout": jax.random.PRNGKey(0)})

    def step(state, wav, labels, valid):
        p = state.params
        (final, hiddens), vjp = jax.vjp(encode, p["encoder"], wav)

        def head_loss(p_head, hs):
            log_probs, upd = head.apply(
                {"params": p_head, "batch_stats": state.batch_stats["sls_head"]}, hs,
                train=True, mutable=["batch_stats"])
            return weighted_nll(log_probs, labels, tcfg_.loss_weights, valid), (log_probs, upd)

        with jax.disable_jit():
            (loss, (log_probs, upd)), (g_head, g_hs) = jax.value_and_grad(
                head_loss, argnums=(0, 1), has_aux=True)(p["sls_head"], hiddens)
        g_enc = vjp((jnp.zeros_like(final), g_hs))[0]
        if mcfg.freeze_encoder:  # the reference's stop_gradient
            g_enc = jax.tree.map(jnp.zeros_like, g_enc)
        new = state.apply_gradients(grads={"encoder": g_enc, "sls_head": g_head},
                                    batch_stats={"sls_head": upd["batch_stats"]})
        finite = jnp.isfinite(loss)
        new = jax.tree.map(lambda a, b: jnp.where(finite, a, b), new, state)
        correct = ((jnp.argmax(log_probs, -1) == labels) * valid).sum()
        return new, {"loss": loss, "scores": jnp.exp(log_probs[:, 1]), "correct": correct,
                     "finite": finite}

    return step


def _jax_state(J, jexp, jmodel, variables):
    mask = J.steps.trainable_decay_mask(jexp)
    return J.sls.SLSTrainState.create(
        apply_fn=jmodel.apply, params=J.jax.tree.map(J.jnp.array, variables[0]),
        batch_stats=J.jax.tree.map(J.jnp.array, variables[1]),
        tx=J.steps.make_optimizer(LR, WD, mask, trainable_mask=mask))


@pytest.fixture(scope="module", params=[False, True], ids=["unfrozen", "frozen"])
def runs(request, J, variables, batches):
    freeze = request.param
    jexp, pexp = _configs(J, freeze)
    jmodel = J.sls.SLSDetector(jexp.model)
    jstate = _jax_state(J, jexp, jmodel, variables)
    jstep = jax_sls_step(J, jexp)
    model = _port(pexp, variables)
    state = create_sls_train_state(model, pexp)
    step = make_sls_train_step(model, pexp, device="cpu")
    losses = []
    for wav, labels, valid in batches:
        jstate, jm = jstep(jstate, J.jnp.asarray(wav), J.jnp.asarray(labels),
                           J.jnp.asarray(valid))
        state, pm = step(state, wav, labels, valid, 0)
        losses.append((float(jm["loss"]), float(pm["loss"])))
        assert bool(pm["finite"]) and int(pm["correct"]) == int(jm["correct"])
        assert all(float(pm[k]) == 0.0 for k in ("cls_loss", "sae_loss", "cpc_loss"))
    return freeze, model, state, J.jax.device_get(jstate), losses


def test_two_train_steps_match_jax(runs, variables):
    freeze, model, state, jstate, losses = runs
    j_losses, p_losses = zip(*losses)
    assert p_losses[0] == pytest.approx(j_losses[0], rel=1e-5)
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-4)
    assert int(state.step) == int(jstate.step) == STEPS
    start = detector_state_from_flax(variables[0])
    ref = detector_state_from_flax(jstate.params)
    errs = {}
    for n, p in model.named_parameters():
        change, want = (p.detach() - start[n]).double(), (ref[n] - start[n]).double()
        if freeze and n.startswith("encoder."):
            assert torch.equal(p.detach(), start[n]) and float(want.abs().max()) == 0, n
        elif n.endswith(ZERO_GRADIENT):
            assert float(change.abs().max()) <= STEPS * LR * 1.01, n
        else:
            errs[n] = float((change - want).norm() / want.norm())
    worst = max(errs, key=errs.get)
    assert errs[worst] <= CHANGE_REL_L2, (worst, errs[worst])
    bn = jstate.batch_stats["sls_head"]["first_bn"]
    np.testing.assert_allclose(model.sls_head.first_bn.running_mean.numpy(),
                               np.asarray(bn["mean"]), rtol=BN_TOL, atol=1e-7)
    np.testing.assert_allclose(model.sls_head.first_bn.running_var.numpy(),
                               np.asarray(bn["var"]), rtol=BN_TOL)
    assert float(model.sls_head.first_bn.running_var) != 0.8  # moved


def test_frozen_encoder_has_no_moments(runs):
    freeze, model, state, *_ = runs
    names = [n for n, _ in model.named_parameters()]
    want = [n for n in names if not (freeze and n.startswith("encoder."))]
    assert state.names == want
    assert state.exp_avg.numel() == sum(p.numel() for n, p in model.named_parameters()
                                        if n in want)


def test_nan_batch_changes_nothing(J, variables, batches):
    _, pexp = _configs(J)
    model = _port(pexp, variables)
    state = create_sls_train_state(model, pexp)
    step = make_sls_train_step(model, pexp, device="cpu")
    wav, labels, valid = batches[0]
    step(state, wav, labels, valid, 0)
    before = ({k: v.clone() for k, v in model.state_dict().items()},
              state.exp_avg.clone(), state.exp_avg_sq.clone(), state.step.clone())
    bad = wav.copy()
    bad[1, 100] = np.nan
    _, m = step(state, bad, labels, valid, 0)
    assert not bool(m["finite"])
    after = model.state_dict()
    assert all(torch.equal(after[k].view(torch.int32) if after[k].is_floating_point()
                           else after[k], before[0][k].view(torch.int32)
                           if before[0][k].is_floating_point() else before[0][k])
               for k in after)
    assert "sls_head.first_bn.running_var" in after
    assert torch.equal(state.exp_avg, before[1]) and torch.equal(state.exp_avg_sq, before[2])
    assert torch.equal(state.step, before[3]) and state.calls == 2


def test_layer_gate_profile_matches_jax(J, variables, batches):
    jexp, pexp = _configs(J)
    wav = batches[1][0]
    params, stats = variables
    want = J.sls.layer_gate_profile(J.sls.SLSDetector(jexp.model), params, stats,
                                    J.jnp.asarray(wav), return_gates=True)
    got = layer_gate_profile(_port(pexp, variables), wav, return_gates=True)
    assert got["gates"].shape == want["gates"].shape == (2, BATCH)
    np.testing.assert_allclose(got["gates"], want["gates"], atol=HEAD_TOL, rtol=0)
    for key in ("mean_gate_per_layer", "std_gate_per_layer"):
        np.testing.assert_allclose(got[key], want[key], atol=HEAD_TOL, rtol=0)
    assert got["most_sensitive_layers"] == want["most_sensitive_layers"]


def test_int16_wire_equals_float32_wire(J, variables, batches):
    """The port dequantises the wire in its SLS steps (the reference feeds
    it raw): int16 samples and their float32 values score alike, bit for
    bit, and train alike."""
    _, pexp = _configs(J)
    model = _port(pexp, variables)
    w16 = to_wire(batches[0][0], "int16")
    w32 = w16.astype(np.float32) / 32768.0
    step = make_sls_eval_step(model, device="cpu")
    assert torch.equal(step(w16)["log_probs"], step(w32)["log_probs"])
    losses = []
    for wire in (w16, w32):
        m = _port(pexp, variables)
        _, metrics = make_sls_train_step(m, pexp, device="cpu")(
            create_sls_train_state(m, pexp), wire, *batches[0][1:], 0)
        losses.append(metrics["loss"])
    assert torch.equal(losses[0], losses[1])
