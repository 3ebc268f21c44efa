"""The slice as a whole: the port's tiny Detector and eval step against the
JAX package's on the same weights and wavs.

The JAX Detector with ``use_pallas=True`` reaches the Pallas SAE kernels;
they run in interpret mode here, as ``tests/test_kernels.py`` runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sls_tpu.kernels.sae_kernels as jax_sk
from sls_tpu.config import ExperimentConfig, ModelConfig, SAEConfig, tiny_xlsr_config
from sls_tpu.data.pipeline import to_wire as jax_to_wire
from sls_tpu.models.detector import Detector as JaxDetector
from sls_tpu.train.steps import dequantize_wire as jax_dequantize_wire
from sls_tpu.train.steps import make_eval_step as jax_make_eval_step
from sls_tpu_torch import config as tcfg
from sls_tpu_torch.convert import detector_state_from_flax
from sls_tpu_torch.data.pipeline import to_wire
from sls_tpu_torch.kernels.sae_kernels import sae_encode_acts_plain
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.train.steps import dequantize_wire, make_eval_step

D, M, K = 64, 256, 32


def _configs(use_pallas):
    jcfg = ModelConfig(encoder=tiny_xlsr_config(),
                       sae=SAEConfig(activation_dim=D, dict_size=M, k=K,
                                     use_pallas=use_pallas))
    pcfg = tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(),
                            sae=tcfg.SAEConfig(activation_dim=D, dict_size=M, k=K,
                                               use_pallas=use_pallas))
    return jcfg, pcfg


@pytest.fixture(scope="module")
def interpret_kernels():
    """Route the JAX SAE kernels through Pallas interpret mode."""
    enc, dec = jax_sk.sae_encode_topk_fused, jax_sk.sae_decode_fused
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sk, "sae_encode_topk_fused",
                   lambda *a, **kw: enc(*a, **{**kw, "interpret": True}))
        mp.setattr(jax_sk, "sae_decode_fused",
                   lambda *a, **kw: dec(*a, **{**kw, "interpret": True}))
        yield


@pytest.fixture(scope="module")
def wavs():
    return np.random.default_rng(0).normal(0, 0.1, (3, 4000)).astype(np.float32)


@pytest.fixture(scope="module")
def params(wavs):
    """JAX Detector params, perturbed so that no bias or norm is trivial
    (the tree is the same with and without use_pallas)."""
    jcfg, _ = _configs(False)
    p = JaxDetector(jcfg).init(jax.random.PRNGKey(0), jnp.asarray(wavs))["params"]
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), p)


def _make_pair(use_pallas, params):
    jcfg, pcfg = _configs(use_pallas)
    port = Detector(pcfg, device="cpu")
    port.load_state_dict(detector_state_from_flax(params), strict=True)
    return use_pallas, JaxDetector(jcfg), jcfg, port


@pytest.fixture(scope="module", params=[True, False], ids=["pallas", "jnp"])
def pair(request, params, interpret_kernels):
    return _make_pair(request.param, params)


@pytest.fixture(scope="module")
def pallas_pair(params, interpret_kernels):
    """The flagship routing (use_pallas=True)."""
    return _make_pair(True, params)


def _clear_frames(port, features, use_pallas, tol):
    """Frames whose dense k-th and (k+1)-th activations differ by more
    than ``tol`` (relative): only there must the supports agree."""
    x = torch.from_numpy(np.array(features)).reshape(-1, D)
    sae = port.sae
    with torch.inference_mode():
        if use_pallas:
            acts = sae_encode_acts_plain(x, sae.W_enc, sae.b_enc, sae.b_dec)
        else:
            acts = sae.pre_activations(x)
    vals = -np.sort(-acts.numpy(), axis=-1)
    gap = (vals[:, K - 1] - vals[:, K]) / np.maximum(vals[:, K - 1], 1e-30)
    return gap > tol


def test_detector_matches_jax(pair, params, wavs):
    use_pallas, jmodel, _, port = pair
    ref = jmodel.apply({"params": params}, jnp.asarray(wavs))
    with torch.inference_mode():
        out = port(torch.from_numpy(wavs))
    assert set(out) == set(ref)
    # fp32 encoder, sums in other orders (~3e-6 measured)
    np.testing.assert_allclose(out["features"].numpy(), np.asarray(ref["features"]),
                               atol=1e-4, rtol=0)
    # the Pallas encode rounds its input to bf16: a 1e-6 feature
    # difference can move one value across a bf16 rounding boundary
    # (one bf16 ulp, 2^-8 relative), so the fused path's codes get
    # 1e-3 where the fp32 jnp path gets 1e-4
    code_tol = 1e-3 if use_pallas else 1e-4
    clear = _clear_frames(port, ref["features"], use_pallas, code_tol)
    assert clear.mean() > 0.9
    a = out["codes"].numpy().reshape(-1, M)[clear]
    b = np.asarray(ref["codes"]).reshape(-1, M)[clear]
    np.testing.assert_array_equal(a > 0, b > 0)
    np.testing.assert_allclose(a, b, atol=code_tol, rtol=0)
    # a frame's reconstruction moves by at most |code error| @ |W_dec|,
    # plus fp32 summation noise
    bound = np.abs(a - b) @ np.abs(params["sae"]["W_dec"]) + 1e-5
    diff = np.abs(out["recon"].numpy().reshape(-1, D)[clear]
                  - np.asarray(ref["recon"]).reshape(-1, D)[clear])
    assert np.all(diff <= bound)
    # mean-pooled head over ~200 frames: code noise averages out
    np.testing.assert_allclose(out["log_probs"].numpy(), np.asarray(ref["log_probs"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(out["score"].numpy(), np.asarray(ref["score"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(out["sae_loss"]), float(ref["sae_loss"]), rtol=1e-4)
    assert float(out["cpc_loss"]) == 0.0


def test_score_path_equals_forward(pair, wavs):
    _, _, _, port = pair
    with torch.inference_mode():
        wav = torch.from_numpy(wavs)
        assert torch.equal(port.score(wav), port(wav)["log_probs"])


@pytest.mark.parametrize("wire", ["float32", "int16", "mulaw"])
def test_dequantize_wire_matches_jax(wire, wavs):
    w = to_wire(wavs, wire)
    np.testing.assert_array_equal(w, jax_to_wire(wavs, wire))
    ref = np.asarray(jax_dequantize_wire(jnp.asarray(w)))
    out = dequantize_wire(torch.from_numpy(w)).numpy()
    assert out.dtype == np.float32
    # int16 is exact; mu-law's expm1 may differ by an ulp between libraries
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("wire", ["float32", "int16", "mulaw"])
def test_eval_step_matches_jax(wire, pallas_pair, params, wavs):
    _, jmodel, jcfg, port = pallas_pair
    w = to_wire(wavs, wire)
    ref = jax_make_eval_step(jmodel, ExperimentConfig(model=jcfg))(params, jnp.asarray(w))
    out = make_eval_step(port, device="cpu")(w)
    assert set(out) == set(ref)
    for key in ("score", "log_probs"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4, rtol=0)
    for key in ("sae_loss", "sae_loss_per_example"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=1e-4)
