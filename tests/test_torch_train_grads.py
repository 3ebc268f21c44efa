"""The port's training loss and gradients against the JAX package's: the
tiny detector's loss and every parameter's gradient against ``jax.grad``
of the JAX train loss, on the same weights (``detector_state_from_flax``)
and the same batch, for the per-timestep and window-overlap SAE with and
without ``use_pallas``.

The JAX side reaches the Pallas SAE kernels through their custom VJPs;
they run in interpret mode here, as ``tests/test_kernels.py`` runs them.
Every dropout rate is 0 on both sides (the two random streams differ), so
the training forward is deterministic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sls_tpu.kernels.sae_kernels as jax_sk
from sls_tpu.config import ModelConfig, SAEConfig, tiny_xlsr_config
from sls_tpu.models.detector import Detector as JaxDetector
from sls_tpu.models.detector import total_loss as jax_total_loss
from sls_tpu.train.loss import weighted_nll as jax_weighted_nll
from sls_tpu_torch import config as tcfg
from sls_tpu_torch.convert import detector_state_from_flax
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.train.steps import dropout_generator, train_loss

D, M, K = 64, 256, 32
WEIGHTS, SAE_WEIGHT = (0.1, 0.9), 0.1
# per tensor: fp32 sums in other orders through a 2-layer encoder and
# the SAE (measured at 5e-6 at worst)
GRAD_REL_L2 = 1e-4
# The key projection's bias has no gradient in exact arithmetic (a shift
# of every key's score by q . b leaves each query's softmax as it is);
# both sides give rounding noise, ~1e-9 against ~0.05 for its weight's
# gradient, so each is held below this fraction of its weight's.
NULL_GRAD_FRACTION = 1e-6
CASES = [(v, p) for v in ("per_timestep", "window_overlap") for p in (False, True)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these tiny CPU models: the suite's parallel
    workers then do not oversubscribe the cores (no result depends on
    the thread count within a test)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(variant, use_pallas):
    sae = dict(activation_dim=D, dict_size=M, k=K, variant=variant, use_pallas=use_pallas)
    jcfg = ModelConfig(encoder=tiny_xlsr_config(), sae=SAEConfig(**sae), classifier_dropout=0.0)
    pcfg = tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(), sae=tcfg.SAEConfig(**sae),
                            classifier_dropout=0.0)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def interpret_kernels():
    """Route the JAX package's SAE kernels through Pallas interpret mode."""
    names = ("sae_encode_fused", "window_vote_fused", "sae_encode_topk_fused",
             "sae_decode_fused")
    with pytest.MonkeyPatch.context() as mp:
        for name in names:
            fn = getattr(jax_sk, name)
            mp.setattr(jax_sk, name,
                       lambda *a, _fn=fn, **kw: _fn(*a, **{**kw, "interpret": True}))
        yield


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    wav = rng.normal(0, 0.1, (3, 4000)).astype(np.float32)
    return wav, np.array([0, 1, 1], np.int32), np.array([1.0, 1.0, 0.0], np.float32)


@pytest.fixture(scope="module")
def params(batch):
    """JAX Detector params, perturbed so that no bias or norm is trivial
    (one tree for every variant)."""
    jcfg, _ = _configs("per_timestep", False)
    p = JaxDetector(jcfg).init(jax.random.PRNGKey(0), jnp.asarray(batch[0]))["params"]
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), p)


def jax_loss_and_grads(jcfg, params, batch):
    model = JaxDetector(jcfg)
    wav, labels, valid = (jnp.asarray(a) for a in batch)

    def loss_fn(p):
        out = model.apply({"params": p}, wav, train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        cls = jax_weighted_nll(out["log_probs"], labels, WEIGHTS, valid)
        return jax_total_loss(cls, out["sae_loss"], SAE_WEIGHT), out["codes"]

    (loss, codes), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return float(loss), np.asarray(codes), jax.tree.map(np.asarray, grads)


def port_loss_and_grads(pcfg, params, batch):
    model = Detector(pcfg, device="cpu")
    model.load_state_dict(detector_state_from_flax(params), strict=True)
    wav, labels, valid = (torch.from_numpy(a) for a in batch)
    loss, _, out = train_loss(model, tcfg.TrainConfig(), wav, labels, valid,
                              dropout_generator(0, 0, "cpu"))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return float(loss.detach()), out["codes"].detach().numpy(), grads


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module", params=CASES, ids=[f"{v}-{'pallas' if p else 'jnp'}"
                                                   for v, p in CASES])
def both(request, params, batch, interpret_kernels):
    jcfg, pcfg = _configs(*request.param)
    return jax_loss_and_grads(jcfg, params, batch), port_loss_and_grads(pcfg, params, batch)


def test_train_loss_matches_jax(both):
    (j_loss, j_codes, _), (p_loss, p_codes, _) = both
    # the premise of the gradient comparison: the same SAE supports
    np.testing.assert_array_equal(p_codes > 0, j_codes > 0)
    assert p_loss == pytest.approx(j_loss, rel=1e-5)


def test_every_gradient_matches_jax(both):
    (_, _, j_grads), (_, _, p_grads) = both
    ref = detector_state_from_flax(j_grads)
    assert set(ref) == set(p_grads)
    assert all(p_grads[n] is not None for n in ref)
    null = {n for n in ref if n.endswith("self_attn.k_proj.bias")}
    for n in null:
        scale = NULL_GRAD_FRACTION * np.linalg.norm(ref[n.replace(".bias", ".weight")].numpy())
        assert np.linalg.norm(ref[n].numpy()) <= scale, n
        assert np.linalg.norm(p_grads[n].numpy()) <= scale, n
    errs = {n: rel_l2(p_grads[n].numpy(), ref[n].numpy()) for n in ref if n not in null}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL_L2, (worst, errs[worst])
