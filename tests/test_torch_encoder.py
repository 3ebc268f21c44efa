"""The port's XLS-R encoder against ``sls_tpu``'s on shared weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sls_tpu.config import tiny_xlsr_config
from sls_tpu.encoder.xlsr import XLSREncoder
from sls_tpu_torch.config import tiny_xlsr_config as torch_tiny_config
from sls_tpu_torch.convert import detector_state_from_flax
from sls_tpu_torch.encoder.xlsr import XLSREncoder as TorchXLSREncoder

# (extractor_mode, layer_norm_first): the XLS-R topology, and the
# group-norm front-end with post-LN blocks
TOPOLOGIES = [("layer_norm", True), ("default", False)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def wav():
    return np.random.default_rng(0).normal(0, 0.1, (2, 4000)).astype(np.float32)


@pytest.fixture(scope="module", params=TOPOLOGIES, ids=["xlsr", "default_postln"])
def shared(request, wav):
    """JAX params (perturbed so that no bias or norm is trivial), the
    JAX outputs at fp32 and bf16, and the converted state dict."""
    mode, lnf = request.param
    cfg = tiny_xlsr_config(extractor_mode=mode, layer_norm_first=lnf)
    params = XLSREncoder(cfg).init(jax.random.PRNGKey(0), jnp.asarray(wav))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    out32, hidden = XLSREncoder(cfg).apply(
        {"params": params}, jnp.asarray(wav), return_hidden_states=True)
    cfg16 = tiny_xlsr_config(extractor_mode=mode, layer_norm_first=lnf, dtype=jnp.bfloat16)
    out16 = XLSREncoder(cfg16).apply({"params": params}, jnp.asarray(wav))
    state = {k.removeprefix("encoder."): v
             for k, v in detector_state_from_flax({"encoder": params}).items()}
    return {
        "topology": request.param,
        "params": params,
        "state": state,
        "ref32": np.asarray(out32),
        "hidden32": [np.asarray(h) for h in hidden],
        "ref16": np.asarray(out16).astype(np.float32),
    }


def _port(shared, dtype):
    mode, lnf = shared["topology"]
    enc = TorchXLSREncoder(
        torch_tiny_config(extractor_mode=mode, layer_norm_first=lnf, dtype=dtype),
        device="cpu")
    enc.load_state_dict(shared["state"], strict=True)
    return enc


def test_encoder_fp32_matches_jax(shared, wav):
    with torch.inference_mode():
        out = _port(shared, torch.float32)(torch.from_numpy(wav)).numpy()
    # same fp32 math; convs and matmuls sum in other orders (measured ~3e-6)
    np.testing.assert_allclose(out, shared["ref32"], atol=1e-4, rtol=0)


def test_encoder_hidden_states_fp32_match_jax(shared, wav):
    with torch.inference_mode():
        out, hidden = _port(shared, torch.float32)(
            torch.from_numpy(wav), return_hidden_states=True)
    np.testing.assert_allclose(out.numpy(), shared["ref32"], atol=1e-4, rtol=0)
    assert len(hidden) == len(shared["hidden32"])
    for h, ref in zip(hidden, shared["hidden32"]):
        np.testing.assert_allclose(h.numpy(), ref, atol=1e-4, rtol=0)


def test_encoder_bf16_within_reference_envelope(shared, wav):
    """The envelope is the JAX package's own bf16 error: the relative L2
    error of its bf16 path against its fp32 path on these inputs (about
    1e-2 here).  The port's bf16 path must be no further from the fp32
    truth than 1.5x that, and no further from the JAX bf16 output than
    2x that (two independent roundings of the same size)."""
    with torch.inference_mode():
        out16 = _port(shared, torch.bfloat16)(torch.from_numpy(wav)).float().numpy()
    ref32, ref16 = shared["ref32"], shared["ref16"]
    envelope = _rel(ref16, ref32)
    assert 0 < envelope < 0.05
    assert _rel(out16, ref32) <= 1.5 * envelope
    assert _rel(out16, ref16) <= 2.0 * envelope


def test_grouped_conv_einsum_matches_conv_path_and_jax(shared, wav):
    """The pos-conv as per-tap block-diagonal einsums on the conv's own
    weight: the same state dict loads, and the output agrees with the
    port's conv path and with the JAX encoder's einsum path."""
    mode, lnf = shared["topology"]
    kw = dict(extractor_mode=mode, layer_norm_first=lnf)
    enc = TorchXLSREncoder(torch_tiny_config(grouped_conv_einsum=True, **kw), device="cpu")
    enc.load_state_dict(shared["state"], strict=True)
    conv_path = _port(shared, torch.float32)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 37, 64)).astype(np.float32))
    with torch.inference_mode():
        out = enc(torch.from_numpy(wav)).numpy()
        # the pos-conv alone: 16 taps of fp32 sums in another order
        np.testing.assert_allclose(enc.pos_conv(x).numpy(), conv_path.pos_conv(x).numpy(),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(out, conv_path(torch.from_numpy(wav)).numpy(),
                                   atol=1e-4, rtol=0)
    ref = XLSREncoder(tiny_xlsr_config(grouped_conv_einsum=True, **kw)).apply(
        {"params": shared["params"]}, jnp.asarray(wav))
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4, rtol=0)
