"""The port's int8 serving route against the JAX package: ``int8_dot``
against the reference's (the same int8 operands, int32 sums and output),
the tiny encoder with ``int8_serving`` on both scopes against the JAX
encoder in eval mode on shared weights, ``Dense`` without the flag
unchanged, and (on a card) ``torch._int_mm``'s shape rules and the card's
``int8_dot`` against the CPU's.

The JAX side is imported inside fixtures and tests, so that on a machine
with a card and no JAX the CUDA tests still run:
``python -m pytest --noconftest -m cuda tests/test_torch_int8.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sls_tpu_torch import config as tcfg
from sls_tpu_torch.encoder.xlsr import Dense, XLSREncoder
from sls_tpu_torch.quant.int8 import int8_dot, quantize

SHAPES = [(64, 256, 128), (40, 64, 24), (3, 17, 32, 16)]  # [..., M, K], N


@pytest.fixture(scope="module")
def jq():
    return pytest.importorskip("sls_tpu.quant.int8")


@pytest.fixture(scope="module")
def jnp():
    return pytest.importorskip("jax.numpy")


def _xw(shape, seed):
    *lead, k, n = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (*lead, k)).astype(np.float32),
            rng.normal(0, 0.05, (k, n)).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_dot_matches_jax(shape, jq, jnp):
    """The reference's recipe step by step: the same int8 operands, the
    same int32 sums, and (the same fp32 rescale in the same order) the
    same fp32 output to the bit; bf16 outputs also to the bit."""
    import jax

    x, w = _xw(shape, seed=len(shape) + shape[-1])
    xf = x.reshape(-1, x.shape[-1])
    # the reference's operands (sls_tpu/quant/int8.py, int8_dot)
    s_x = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-9) / 127.0
    xq_ref = np.asarray(jnp.round(xf / s_x).astype(jnp.int8))
    s_w = jnp.maximum(jnp.max(jnp.abs(w), axis=0, keepdims=True), 1e-12) / 127.0
    wq_ref = np.asarray(jnp.round(w / s_w).astype(jnp.int8))
    acc_ref = np.asarray(jax.lax.dot(jnp.asarray(xq_ref), jnp.asarray(wq_ref),
                                     preferred_element_type=jnp.int32))
    xq, sx = quantize(torch.from_numpy(xf), -1, 1e-9)
    wq, sw = quantize(torch.from_numpy(w), 0, 1e-12)
    assert np.array_equal(xq.numpy(), xq_ref) and np.array_equal(wq.numpy(), wq_ref)
    assert np.array_equal(sx.numpy(), np.asarray(s_x)) and np.array_equal(sw.numpy(),
                                                                          np.asarray(s_w))
    assert np.array_equal(torch._int_mm(xq, wq).numpy(), acc_ref)
    for dt in ("float32", "bfloat16"):
        ref = jq.int8_dot(jnp.asarray(x, getattr(jnp, dt)), jnp.asarray(w),
                          out_dtype=getattr(jnp, dt))
        out = int8_dot(torch.from_numpy(x).to(getattr(torch, dt)), torch.from_numpy(w),
                       getattr(torch, dt))
        assert out.shape == ref.shape and out.dtype == getattr(torch, dt)
        np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_int8_dot_takes_a_transposed_weight():
    """Dense passes its [N, K] weight's transposed view."""
    x, w = _xw((40, 64, 24), seed=2)
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).t()
    assert not wt.is_contiguous()
    assert torch.equal(int8_dot(torch.from_numpy(x), wt, torch.float32),
                       int8_dot(torch.from_numpy(x), torch.from_numpy(w), torch.float32))


def test_dense_without_the_flag_is_unchanged():
    """int8=False is exactly flax nn.Dense's computation (the state dict
    is the same either way)."""
    torch.manual_seed(0)
    x = torch.randn(5, 24).bfloat16()
    plain, flagged = Dense(24, 16, torch.bfloat16), Dense(24, 16, torch.bfloat16, int8=True)
    with torch.no_grad():
        plain.weight.normal_()
        plain.bias.normal_()
    flagged.load_state_dict(plain.state_dict(), strict=True)
    dt = torch.bfloat16
    assert torch.equal(plain(x), F.linear(x, plain.weight.to(dt), plain.bias.to(dt)))
    assert torch.equal(flagged(x), int8_dot(x, plain.weight.t(), dt) + plain.bias.to(dt))


@pytest.fixture(scope="module")
def encoder_case():
    """The JAX tiny encoder's params (perturbed), the port's state dict, a
    waveform, and the JAX encoder's eval outputs: fp, int8 ffn, int8 all."""
    import jax
    import jax.numpy as jnp

    from sls_tpu.config import tiny_xlsr_config
    from sls_tpu.encoder.xlsr import XLSREncoder as JXLSREncoder
    from sls_tpu_torch.convert import detector_state_from_flax

    wav = np.random.default_rng(3).normal(0, 0.1, (2, 3200)).astype(np.float32)
    params = JXLSREncoder(tiny_xlsr_config()).init(jax.random.PRNGKey(0),
                                                   jnp.asarray(wav))["params"]
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    outs = {}
    for name, kw in (("fp", {}), ("ffn", dict(int8_serving=True, int8_scope="ffn")),
                     ("all", dict(int8_serving=True, int8_scope="all"))):
        outs[name] = np.asarray(JXLSREncoder(tiny_xlsr_config(**kw)).apply(
            {"params": params}, jnp.asarray(wav), train=False))
    state = {k.removeprefix("encoder."): v
             for k, v in detector_state_from_flax({"encoder": params}).items()}
    return wav, state, outs


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cosine_min(a, b):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    cos = np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)
    return float(cos.min())


@pytest.mark.parametrize("scope", ["ffn", "all"])
def test_int8_encoder_matches_jax(scope, encoder_case, monkeypatch):
    """The tiny fp32 encoder with int8_serving against the JAX encoder in
    eval mode.  Rounding to int8 is a step function: inputs that differ
    in their last fp32 bits (conv and matmul sums in other orders) can
    round a value to the neighbouring integer, and the flip travels on
    through the layers, so no fixed elementwise bound holds.  The
    envelope is the JAX int8 route's own distance from the JAX fp encoder
    (relative L2 about 1e-2 here): the port lies within half of it from
    the JAX int8 route (measured 1e-4 for "ffn", 2.5e-3 for "all") and
    within 1.5x of it from the fp encoder.  Also the reference's own
    acceptance against the fp encoder (per-frame cosine > 0.99,
    tests/test_int8.py)."""
    import sls_tpu_torch.encoder.xlsr as txlsr

    wav, state, outs = encoder_case
    calls = []
    real = txlsr.int8_dot
    monkeypatch.setattr(txlsr, "int8_dot", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = tcfg.tiny_xlsr_config(int8_serving=True, int8_scope=scope)
    enc = XLSREncoder(cfg, device="cpu")
    enc.load_state_dict(state, strict=True)
    with torch.inference_mode():
        out = enc(torch.from_numpy(wav)).numpy()
    per_layer = 2 if scope == "ffn" else 6  # fc1, fc2 (+ q, k, v, out)
    assert len(calls) == cfg.encoder_layers * per_layer
    envelope = _rel(outs[scope], outs["fp"])
    assert 0 < envelope < 0.05
    assert _rel(out, outs[scope]) <= 0.5 * envelope
    assert _rel(out, outs["fp"]) <= 1.5 * envelope
    assert _cosine_min(out, outs["fp"]) > 0.99


def test_int8_encoder_keeps_the_state_dict():
    plain = XLSREncoder(tcfg.tiny_xlsr_config(), device="cpu")
    for scope in ("ffn", "all"):
        q = XLSREncoder(tcfg.tiny_xlsr_config(int8_serving=True, int8_scope=scope),
                        device="cpu")
        assert {k: v.shape for k, v in q.state_dict().items()} == {
            k: v.shape for k, v in plain.state_dict().items()}


# -- on a card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7236, 1024, 4096), (201, 4096, 1024), (17, 64, 24)],
                         ids=["flagship_fc1", "one_utterance_fc2", "small"])
def test_int8_dot_on_card_matches_cpu(cuda, shape):
    """Exact int32 sums and the same fp32 rescale: the card's output is
    the CPU's to the bit."""
    x, w = _xw(shape, seed=5)
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    want = int8_dot(torch.from_numpy(x), wt.t(), torch.float32)
    got = int8_dot(torch.from_numpy(x).to(cuda), wt.to(cuda).t(), torch.float32)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 64, 24), (32, 60, 24), (32, 64, 20)],
                         ids=["m16", "k60", "n20"])
def test_int8_dot_on_card_rejects_other_shapes(cuda, shape):
    x, w = _xw(shape, seed=6)
    with pytest.raises(ValueError, match="M > 16"):
        int8_dot(torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda))
