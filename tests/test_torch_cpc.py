"""The CPC variant of the port (``sae/cpc.py``, ``aggregate_windows_mean``,
``Detector(use_cpc)`` and the train step's ``cpc_weight`` term) against
the JAX package on the same weights and inputs.

The JAX side is imported inside fixtures, so that the CUDA case runs on
a machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_cpc.py``.
The JAX Detector's ``use_pallas`` route reaches the Pallas encode
(``sae_encode_fused``) and decode kernels, run here in interpret mode as
``tests/test_kernels.py`` runs them.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sls_tpu_torch import config as tcfg
from sls_tpu_torch.convert import detector_state_from_flax
from sls_tpu_torch.kernels import sae_kernels as tk
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.sae.cpc import CPCHead
from sls_tpu_torch.sae.sparsify import aggregate_windows_mean
from sls_tpu_torch.train.steps import create_train_state, make_train_step, train_loss
from sls_tpu_torch.train.steps import dropout_generator

D, M, K, WINDOW, HIDDEN = 64, 256, 32, 4, 32
LR, WD, STEPS, CPC_WEIGHT = 1e-3, 1e-4, 2, 0.5
HEAD_TOL = 1e-5  # fp32, the same products summed in other orders
# the tiny Detector: fp32 encoder and SAE (the Pallas encode is fp32
# too), sums in other orders; measured ~1e-6 on the CPC loss
DETECTOR_TOL = 1e-4
# each parameter's change over the steps (relative L2), as
# tests/test_torch_train_step.py holds it
CHANGE_REL_L2 = 1e-3
# softmax does not see the key projections' biases: their exact gradient
# is wd * p alone, and rounding noise divided by its own root mean square
# moves them by up to lr a step (tests/test_torch_trainer.py)
ZERO_GRADIENT = "self_attn.k_proj.bias"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules, with its SAE kernels in interpret mode."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import sls_tpu.kernels.sae_kernels as jax_sk
    from sls_tpu import config as jcfg
    from sls_tpu.models.detector import Detector as JaxDetector
    from sls_tpu.sae.cpc import CPCHead as JaxCPCHead
    from sls_tpu.sae.sparsify import aggregate_windows_mean as jax_aggregate
    from sls_tpu.train import steps as jsteps

    with pytest.MonkeyPatch.context() as mp:
        for name in ("sae_encode_fused", "sae_decode_fused"):
            fn = getattr(jax_sk, name)
            mp.setattr(jax_sk, name,
                       lambda *a, _fn=fn, **kw: _fn(*a, **{**kw, "interpret": True}))
        yield SimpleNamespace(jax=jax, jnp=jnp, cfg=jcfg, Detector=JaxDetector,
                              CPCHead=JaxCPCHead, aggregate=jax_aggregate, steps=jsteps)


@pytest.mark.parametrize("T", [13, 16, 3])
def test_aggregate_windows_mean_matches_jax(J, T):
    x = np.random.default_rng(T).normal(size=(2, T, 5)).astype(np.float32)
    want = np.asarray(J.aggregate(J.jnp.asarray(x), WINDOW))
    got = aggregate_windows_mean(torch.from_numpy(x), WINDOW).numpy()
    assert got.shape == want.shape == (2, -(-T // WINDOW), 5)
    # the zero-padded tail window is divided by the window, not by its frames
    np.testing.assert_allclose(got[:, -1], x[:, (T - 1) // WINDOW * WINDOW:].sum(1) / WINDOW,
                               rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _head_pair(J, steps):
    cfg = J.cfg.CPCConfig(hidden_dim=16, prediction_steps=steps)
    x = np.random.default_rng(0).normal(size=(3, 6, 24)).astype(np.float32)
    params = J.CPCHead(cfg).init(J.jax.random.PRNGKey(0), J.jnp.asarray(x))["params"]
    head = CPCHead(tcfg.CPCConfig(hidden_dim=16, prediction_steps=steps), 24, device="cpu")
    head.load_state_dict(detector_state_from_flax(params), strict=True)
    return J.CPCHead(cfg), params, head


@pytest.mark.parametrize("n", [6, 3, 2], ids=["all_deltas", "delta_4_skipped",
                                                  "deltas_2_4_skipped"])
def test_cpc_head_loss_and_gradient_match_jax(J, n):
    jhead, params, head = _head_pair(J, (1, 2, 4))
    x = np.random.default_rng(n).normal(size=(3, n, 24)).astype(np.float32)

    def loss_fn(p, xx):
        return jhead.apply({"params": p}, xx)

    want, (g_p, g_x) = J.jax.value_and_grad(loss_fn, argnums=(0, 1))(params, J.jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = head(xt)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=HEAD_TOL)
    _close(xt.grad.numpy(), np.asarray(g_x), "window_features")
    ref = detector_state_from_flax(g_p)
    for name, p in head.named_parameters():
        _close(p.grad.numpy(), ref[name].numpy(), name)


def _close(got, want, what):
    """Within HEAD_TOL of the tensor's largest entry (fp32 rounding after
    three layers moves the smallest entries by more than HEAD_TOL of
    themselves: 2.4e-7 measured on entries of 0.2)."""
    err = float(np.abs(got - want).max())
    assert err <= HEAD_TOL * float(np.abs(want).max()), (what, err)


def test_cpc_head_with_every_delta_skipped_is_zero(J):
    jhead, params, head = _head_pair(J, (1, 2, 4))
    x = np.random.default_rng(1).normal(size=(3, 1, 24)).astype(np.float32)
    want = jhead.apply({"params": params}, J.jnp.asarray(x))
    got = head(torch.from_numpy(x))
    assert float(got) == float(want) == 0.0 and got.dtype == torch.float32


def _configs(J, use_pallas=True, freeze=False):
    sae = dict(activation_dim=D, dict_size=M, k=K, variant="window_hard", window_size=WINDOW,
               use_pallas=use_pallas)
    cpc = dict(hidden_dim=HIDDEN, prediction_steps=(1, 2, 4))
    model = dict(use_cpc=True, freeze_encoder=freeze, classifier_dropout=0.0)
    train = dict(lr=LR, weight_decay=WD, cpc_weight=CPC_WEIGHT)
    jexp = J.cfg.ExperimentConfig(
        model=J.cfg.ModelConfig(encoder=J.cfg.tiny_xlsr_config(), sae=J.cfg.SAEConfig(**sae),
                                cpc=J.cfg.CPCConfig(**cpc), **model),
        train=J.cfg.TrainConfig(**train))
    pexp = tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(), sae=tcfg.SAEConfig(**sae),
                               cpc=tcfg.CPCConfig(**cpc), **model),
        train=tcfg.TrainConfig(**train))
    return jexp, pexp


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [(rng.normal(0, 0.1, (3, 4000)).astype(np.float32),
             rng.integers(0, 2, 3).astype(np.int32), np.array([1.0, 1.0, 0.0], np.float32))
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def params(J, batches):
    """The JAX CPC Detector's params (the CPC head materialises under
    ``compute_cpc``), moved off the initialiser by 0.02 N(0, 1)."""
    jexp, _ = _configs(J)
    p = J.Detector(jexp.model).init(J.jax.random.PRNGKey(0), J.jnp.asarray(batches[0][0]),
                                    compute_cpc=True)["params"]
    rng = np.random.default_rng(1)
    return J.jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), p)


def _port(pexp, params):
    model = Detector(pexp.model, device="cpu")
    model.load_state_dict(detector_state_from_flax(params), strict=True)
    return model


def test_cpc_detector_matches_jax(J, params, batches):
    jexp, pexp = _configs(J)
    wav = batches[0][0]
    ref = J.Detector(jexp.model).apply({"params": params}, J.jnp.asarray(wav), compute_cpc=True)
    model = _port(pexp, params)
    assert {n.split(".")[1] for n in model.state_dict() if n.startswith("cpc.")} == {
        "proj_fc1", "proj_fc2", "pred_fc1", "pred_fc2"}
    assert model.cpc.proj_fc1.weight.shape == (HIDDEN, M)  # reads the codes, not hidden_dim
    with torch.no_grad():
        out = model(torch.from_numpy(wav), compute_cpc=True)
        plain = model(torch.from_numpy(wav))
    T = out["codes"].shape[1]
    assert out["window_features"].shape == (3, -(-T // WINDOW), M)
    np.testing.assert_allclose(out["window_features"].numpy(),
                               np.asarray(ref["window_features"]), atol=DETECTOR_TOL, rtol=0)
    assert float(out["cpc_loss"]) > 0
    assert float(out["cpc_loss"]) == pytest.approx(float(ref["cpc_loss"]), rel=DETECTOR_TOL)
    np.testing.assert_allclose(out["log_probs"].numpy(), np.asarray(ref["log_probs"]),
                               atol=DETECTOR_TOL, rtol=0)
    # without compute_cpc (the eval step, score) nothing of the head runs
    assert float(plain["cpc_loss"]) == 0.0 and "window_features" not in plain
    assert torch.equal(plain["log_probs"], out["log_probs"])


def test_two_cpc_train_steps_match_jax(J, params, batches):
    jexp, pexp = _configs(J)
    jmodel = J.Detector(jexp.model)
    jstate = J.steps.TrainState.create(
        apply_fn=jmodel.apply, params=J.jax.tree.map(J.jnp.asarray, params),
        tx=J.steps.make_optimizer(LR, WD, None, trainable_mask=None))
    jstep = J.steps.make_train_step(jmodel, jexp)
    model = _port(pexp, params)
    state = create_train_state(model, pexp)
    assert any(n.startswith("cpc.") for n in state.names)  # the head has moments
    step = make_train_step(model, pexp, device="cpu")
    j_losses, p_losses = [], []
    for wav, labels, valid in batches:
        jstate, jm = jstep(jstate, J.jnp.asarray(wav), J.jnp.asarray(labels),
                           J.jnp.asarray(valid), J.jax.random.PRNGKey(0))
        state, pm = step(state, wav, labels, valid, 0)
        j_losses.append(float(jm["loss"]))
        p_losses.append(float(pm["loss"]))
        assert float(pm["cpc_loss"]) > 0
        assert float(pm["cpc_loss"]) == pytest.approx(float(jm["cpc_loss"]), rel=1e-4)
        want = float(pm["cls_loss"]) + 0.1 * float(pm["sae_loss"]) \
            + CPC_WEIGHT * float(pm["cpc_loss"])
        assert float(pm["loss"]) == pytest.approx(want, rel=1e-6)
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-4)
    assert int(state.step) == STEPS
    start = detector_state_from_flax(params)
    ref = detector_state_from_flax(J.jax.tree.map(np.asarray, jstate.params))
    errs = {}
    for n, p in model.named_parameters():
        change, want = (p.detach() - start[n]).double(), (ref[n] - start[n]).double()
        if n.endswith(ZERO_GRADIENT):
            # each package moves it by its rounding alone, Adam's lr a step at most
            assert float(change.abs().max()) <= STEPS * LR * 1.01, n
            assert float(want.abs().max()) <= STEPS * LR * 1.01, n
            continue
        errs[n] = float((change - want).norm() / want.norm())
    worst = max(errs, key=errs.get)
    assert errs[worst] <= CHANGE_REL_L2, (worst, errs[worst])


# -- on the card --------------------------------------------------------------------

CARD_B = 4
CARD_LOSS_REL = 1e-4   # the fp32 encode (3xTF32) against fp32 matmuls
CARD_GRAD_REL = 1e-3   # relative L2 per tensor, the window supports equal


@pytest.mark.cuda
def test_cpc_step_through_kernels_matches_plain_on_card():
    """The CPC train step's loss and gradients through rows 3 and 2 (their
    autograd Functions) against the same step with the plain versions
    swapped in, at a narrow width; each kernel launches once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = tcfg.ModelConfig(
        encoder=tcfg.tiny_xlsr_config(embed_dim=128, ffn_dim=256),
        sae=tcfg.SAEConfig(activation_dim=128, dict_size=512, k=32, variant="window_hard",
                           window_size=8, use_pallas=True),
        use_cpc=True, cpc=tcfg.CPCConfig(hidden_dim=64), classifier_dropout=0.0)
    model = Detector(cfg, device=dev)
    exp = tcfg.ExperimentConfig(model=cfg)
    rng = np.random.default_rng(0)
    wav = torch.from_numpy(rng.normal(0, 0.1, (CARD_B, 16000)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 2, CARD_B)).to(dev)
    valid = torch.ones(CARD_B, device=dev)

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _, out = train_loss(model, exp.train, wav, labels, valid,
                                  dropout_generator(0, 0, dev))
        loss.backward()
        return float(loss.detach()), out["codes"].detach(), {
            n: p.grad.clone() for n, p in model.named_parameters()}

    before = (tk.sae_encode_fused.launches, tk.sae_decode_fused.launches)
    loss_k, codes_k, g_k = grads()
    assert (tk.sae_encode_fused.launches, tk.sae_decode_fused.launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("sae_encode_fused", "sae_decode_fused"):
            mp.setattr(tk, name, getattr(tk, name + "_plain"))
        loss_p, codes_p, g_p = grads()
    assert torch.equal(codes_k > 0, codes_p > 0)
    assert loss_k == pytest.approx(loss_p, rel=CARD_LOSS_REL)
    for n in g_p:
        if n.endswith(ZERO_GRADIENT):  # rounding noise alone on both sides
            continue
        err = float((g_k[n].double() - g_p[n].double()).norm()
                    / g_p[n].double().norm().clamp_min(1e-30))
        assert err <= CARD_GRAD_REL, (n, err)
    # a train step through the kernels commits
    state = create_train_state(model, exp)
    _, m = make_train_step(model, exp, device=dev)(state, wav, labels, valid, 0)
    assert bool(m["finite"]) and float(m["cpc_loss"]) > 0
