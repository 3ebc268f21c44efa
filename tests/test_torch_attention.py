"""The port's attention kernel wrappers against the JAX package: the plain
versions of ``flash_attention_long``, ``fused_attention`` and
``fused_attention_heads`` against the Pallas kernels (interpret mode on
the CPU), the long form's CPU emulation against them and against fp64,
the helpers, the tiny encoder on both kernel routes against the JAX
encoder, and (on a card) the CUDA kernel's two bf16 forms behind all the
wrappers against their plain versions and the emulation.

The JAX side is imported inside fixtures, so that on a machine with a
card and no JAX the CUDA tests still run:
``python -m pytest --noconftest -m cuda tests/test_torch_attention.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sls_tpu_torch import config as tcfg
from sls_tpu_torch.kernels import attention as ta

B, H, DH = 2, 4, 64
C = H * DH
DTYPES = ["float32", "bfloat16"]
F32_TOL = 2e-5      # the reference's own test tolerance: fp32 sums in another order
BF16_REL_TOL = 1e-2  # of max|ref|: p rounded to bf16 on either side of a near-tie


@pytest.fixture(scope="module")
def jfa():
    return pytest.importorskip("sls_tpu.kernels.flash_attention")


@pytest.fixture(scope="module")
def jat():
    return pytest.importorskip("sls_tpu.kernels.attention")


@pytest.fixture(scope="module")
def jnp():
    return pytest.importorskip("jax.numpy")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.5, s).astype(np.float32) for s in shapes]


def _pair(xs, dtype, jnp):
    """The same inputs for JAX and for the port, rounded to ``dtype``."""
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    return [jnp.asarray(x, jd) for x in xs], [torch.from_numpy(x).to(td) for x in xs]


def _assert_close(out, ref, dtype):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=F32_TOL)
    else:
        assert np.abs(out - ref).max() <= BF16_REL_TOL * np.abs(ref).max()


def _np(t):
    return t.float().numpy()


# -- plain versions against the Pallas kernels ------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,block_q", [(256, 128), (512, 256)])
def test_flash_attention_long_plain_matches_jax_kernel(T, block_q, dtype, jfa, jnp):
    (jq, jk, jv), (q, k, v) = _pair(_inputs(T, *[(B, T, C)] * 3), dtype, jnp)
    ref = jfa.flash_attention_long(jq, jk, jv, num_heads=H, block_q=block_q, interpret=True)
    out = ta.flash_attention_long(q, k, v, H, block_q=block_q)
    assert out.dtype == q.dtype
    _assert_close(_np(out), np.asarray(ref.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_long_cross_length_matches_jax_kernel(dtype, jfa, jnp):
    """Tq != Tkv: the sequence-parallel shape, a local q strip against the
    gathered K/V."""
    xs = _inputs(5, (B, 128, C), (B, 512, C), (B, 512, C))
    (jq, jk, jv), (q, k, v) = _pair(xs, dtype, jnp)
    ref = jfa.flash_attention_long(jq, jk, jv, num_heads=H, block_q=128, interpret=True)
    out = ta.flash_attention_long(q, k, v, H, block_q=128)
    _assert_close(_np(out), np.asarray(ref.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [201, 256], ids=["ragged", "T256"])
def test_fused_attention_plain_matches_jax_kernel(T, dtype, jat, jnp):
    (jq, jk, jv), (q, k, v) = _pair(_inputs(T + 1, *[(B, T, H, DH)] * 3), dtype, jnp)
    ref = jat.fused_attention(jq, jk, jv, interpret=True)
    out = ta.fused_attention(q, k, v)
    assert out.shape == (B, T, H, DH) and out.dtype == q.dtype
    _assert_close(_np(out), np.asarray(ref.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h_blk", [2, 4])
@pytest.mark.parametrize("T", [201, 256], ids=["ragged", "T256"])
def test_fused_attention_heads_plain_matches_jax_kernel(T, h_blk, dtype, jat, jnp):
    (jq, jk, jv), (q, k, v) = _pair(_inputs(T + 2, *[(B, T, C)] * 3), dtype, jnp)
    ref = jat.fused_attention_heads(jq, jk, jv, num_heads=H, h_blk=h_blk, interpret=True)
    out = ta.fused_attention_heads(q, k, v, H, h_blk=h_blk)
    _assert_close(_np(out), np.asarray(ref.astype(jnp.float32)), dtype)


# -- the long form's numerics, emulated on the CPU ----------------------------

EMULATION_CASES = [(256, 256), (201, 201), (512, 512), (1024, 1024), (128, 1024)]
EMULATION_IDS = ["T256", "T201", "T512", "T1024", "cross"]


def _emulation_inputs(tq, tkv, seed):
    return _inputs(seed, (B, tq, C), (B, tkv, C), (B, tkv, C))


@pytest.mark.parametrize("tq,tkv", EMULATION_CASES, ids=EMULATION_IDS)
def test_online_emulation_matches_jax_kernel(tq, tkv, jfa, jnp):
    """The one-pass form's roundings, at bf16, against the reference's
    whole-strip Pallas kernel (interpret mode) on the same inputs."""
    (jq, jk, jv), (q, k, v) = _pair(_emulation_inputs(tq, tkv, tq + tkv), "bfloat16", jnp)
    block_q = 128 if tq % 128 == 0 else tq
    ref = jfa.flash_attention_long(jq, jk, jv, num_heads=H, block_q=block_q, interpret=True)
    out = ta.attention_online_emulated(q, k, v, H)
    assert out.dtype == torch.bfloat16
    _assert_close(_np(out), np.asarray(ref.astype(jnp.float32)), "bfloat16")


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("tq,tkv", EMULATION_CASES, ids=EMULATION_IDS)
def test_online_emulation_within_plain_envelope_of_fp64(tq, tkv):
    """Rounding p~ rather than p costs no accuracy: the emulation's distance
    from an fp64 reference on the same bf16 inputs stays within 1.5x of the
    plain version's (the ROUTE_ENVELOPE form of chip_smoke.py)."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _emulation_inputs(tq, tkv, tq * tkv))
    qh, kh, vh = (x.double().reshape(B, -1, H, DH).transpose(1, 2) for x in (q, k, v))
    truth = (torch.softmax(qh @ kh.transpose(-1, -2), dim=-1) @ vh).transpose(1, 2)
    truth = truth.reshape(B, tq, C).numpy()
    plain = _rel_l2(_np(ta.flash_attention_long_plain(q, k, v, H)), truth)
    emulated = _rel_l2(_np(ta.attention_online_emulated(q, k, v, H)), truth)
    assert emulated <= 1.5 * plain


@pytest.mark.parametrize("t", [201, 256])
def test_online_emulation_is_plain_at_short_kv(t):
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _emulation_inputs(t, t, 3))
    assert ta.attention_form(t) == "short"
    assert torch.equal(ta.attention_online_emulated(q, k, v, H),
                       ta.flash_attention_long_plain(q, k, v, H))


@pytest.mark.parametrize("tq,tkv", [(512, 512), (128, 1024)], ids=["T512", "cross"])
def test_online_emulation_at_fp32_is_the_same_function(tq, tkv):
    """Without the bf16 rounding the one-pass form is the softmax itself."""
    q, k, v = map(torch.from_numpy, _emulation_inputs(tq, tkv, 9))
    assert ta.attention_form(tkv) == "long"
    np.testing.assert_allclose(ta.attention_online_emulated(q, k, v, H).numpy(),
                               ta.flash_attention_long_plain(q, k, v, H).numpy(),
                               rtol=0, atol=F32_TOL)


def test_attention_reference_matches_jax(jfa, jnp):
    q, k, v = _inputs(7, *[(B, 128, C)] * 3)
    ref = np.asarray(jfa.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             num_heads=H))
    got = ta.attention_reference(*map(torch.from_numpy, (q, k, v)), H)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_TOL)
    plain = ta.flash_attention_long_plain(*map(torch.from_numpy, (q, k, v)), H)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=0, atol=F32_TOL)


def test_sp_block_q_matches_jax(jfa):
    for t in (64, 128, 200, 256, 384, 640, 1024, 1280, 2560):
        assert ta.sp_block_q(t) == jfa.sp_block_q(t)
        assert ta.sp_block_q(t, preferred=128) == jfa.sp_block_q(t, preferred=128)
    assert (ta.sp_block_q(1024), ta.sp_block_q(640), ta.sp_block_q(200)) == (256, 128, None)


# -- the wrappers' checks -----------------------------------------------------


def test_rejects_ragged_t():
    q = torch.zeros(1, 200, 128)
    with pytest.raises(ValueError, match="not a multiple"):
        ta.flash_attention_long(q, q, q, 2, block_q=128)


def test_fused_attention_heads_checks_h_blk():
    q = torch.zeros(1, 16, C)
    with pytest.raises(ValueError, match="not a multiple of h_blk"):
        ta.fused_attention_heads(q, q, q, H, h_blk=3)


def test_wrappers_take_plain_path_on_cpu():
    q, k, v = map(torch.from_numpy, _inputs(8, *[(B, 256, C)] * 3))
    names = ("flash_attention_long", "fused_attention", "fused_attention_heads")
    before = [getattr(ta, n).launches for n in names]
    plain = ta.flash_attention_long_plain(q, k, v, H)
    assert torch.equal(ta.flash_attention_long(q, k, v, H), plain)
    four = [x.reshape(B, 256, H, DH) for x in (q, k, v)]
    assert torch.equal(ta.fused_attention(*four), plain.reshape(B, 256, H, DH))
    assert torch.equal(ta.fused_attention_heads(q, k, v, H), plain)
    assert [getattr(ta, n).launches for n in names] == before


def test_wrappers_never_fall_back_off_the_cpu():
    q = torch.empty(1, 256, C, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ta.flash_attention_long(q, q, q, H)
    with pytest.raises(ValueError, match="no kernel"):
        ta.fused_attention_heads(q, q, q, H)
    q4 = torch.empty(1, 256, H, DH, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ta.fused_attention(q4, q4, q4)


# -- the encoder's kernel routes --------------------------------------------


def test_encoder_configs_that_no_longer_raise():
    from sls_tpu_torch.encoder.xlsr import XLSREncoder

    XLSREncoder(tcfg.tiny_xlsr_config(fused_attention=True), device="cpu")
    XLSREncoder(tcfg.tiny_xlsr_config(flash_long_t=2048), device="cpu")
    XLSREncoder(tcfg.tiny_xlsr_config(fused_frontend=True), device="cpu")
    XLSREncoder(tcfg.tiny_xlsr_config(int8_serving=True, int8_scope="all"), device="cpu")
    for name, value in (("seq_axis", "seq"), ("grouped_conv_einsum", True)):
        XLSREncoder(tcfg.tiny_xlsr_config(**{name: value}), device="cpu")


def _length(t_frames):
    """Samples giving ``t_frames`` frames with the tiny conv stack."""
    from sls_tpu_torch.evaluation.overlap import length_buckets

    return length_buckets(tcfg.tiny_xlsr_config(), t_targets=(t_frames,))[t_frames]


@pytest.fixture(scope="module")
def encoder_case():
    """JAX tiny-encoder params (perturbed), their state dict for the port,
    and a waveform of exactly 256 frames."""
    import jax

    from sls_tpu.config import tiny_xlsr_config
    from sls_tpu.encoder.xlsr import XLSREncoder
    from sls_tpu_torch.convert import detector_state_from_flax

    wav = np.random.default_rng(0).normal(0, 0.1, (1, _length(256))).astype(np.float32)
    params = XLSREncoder(tiny_xlsr_config(flash_long_t=0)).init(
        jax.random.PRNGKey(0), jax.numpy.asarray(wav[:, :1000]))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    state = {k.removeprefix("encoder."): v
             for k, v in detector_state_from_flax({"encoder": params}).items()}
    return wav, params, state


ROUTES = {"flash_long": dict(flash_long_t=256), "fused": dict(fused_attention=True)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_encoder_kernel_route_matches_jax(route, encoder_case, monkeypatch):
    """The tiny encoder at T 256 on one kernel route, against the JAX
    encoder on the same route (its Pallas kernel in interpret mode, which
    the JAX encoder picks itself off the TPU)."""
    import jax.numpy as jnp

    import sls_tpu_torch.encoder.xlsr as txlsr
    from sls_tpu.config import tiny_xlsr_config
    from sls_tpu.encoder.xlsr import XLSREncoder

    wav, params, state = encoder_case
    calls = {"flash_attention_long": 0, "fused_attention": 0}
    for name in calls:
        fn = getattr(txlsr, name)

        def counted(*a, _fn=fn, _n=name, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(txlsr, name, counted)
    kw = dict(ROUTES[route], **({} if route == "flash_long" else {"flash_long_t": 0}))
    ref = np.asarray(XLSREncoder(tiny_xlsr_config(**kw)).apply(
        {"params": params}, jnp.asarray(wav), train=False))
    enc = txlsr.XLSREncoder(tcfg.tiny_xlsr_config(**kw), device="cpu")
    enc.load_state_dict(state, strict=True)
    with torch.inference_mode():
        out = enc(torch.from_numpy(wav)).numpy()
    assert out.shape == (1, 256, 64)
    # fp32 throughout; the JAX test of the same routes holds 3e-5
    np.testing.assert_allclose(out, ref, rtol=0, atol=3e-5)
    want = {"flash_attention_long": 2 * (route == "flash_long"),
            "fused_attention": 2 * (route == "fused")}
    assert calls == want  # once per layer, and never the other route


def test_encoder_long_route_needs_a_256_multiple(encoder_case, monkeypatch):
    """T below flash_long_t, or not a multiple of 256, takes the einsum path."""
    import sls_tpu_torch.encoder.xlsr as txlsr

    _, _, state = encoder_case
    calls = []
    monkeypatch.setattr(txlsr, "flash_attention_long", lambda *a, **kw: calls.append(1))
    enc = txlsr.XLSREncoder(tcfg.tiny_xlsr_config(flash_long_t=128), device="cpu")
    enc.load_state_dict(state, strict=True)
    wav = torch.from_numpy(np.random.default_rng(3).normal(0, 0.1, (1, _length(200)))
                           .astype(np.float32))
    with torch.inference_mode():
        assert enc(wav).shape == (1, 200, 64)
    assert calls == []


# -- on a card: the kernel against its plain versions -------------------------


def _cuda_inputs(cuda, dtype, *shapes, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [(torch.randn(s, device=cuda, generator=g) * 0.5).to(dtype) for s in shapes]


def _assert_kernel_close(out, ref):
    if out.dtype == torch.float32:
        assert torch.allclose(out, ref, atol=F32_TOL, rtol=0)
    else:
        err = (out.float() - ref.float()).abs().max()
        assert err <= BF16_REL_TOL * ref.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=DTYPES)
@pytest.mark.parametrize("shape", [(2, 256, 256, 4), (2, 128, 512, 4), (1, 2560, 2560, 16),
                                   (1, 5120, 5120, 16), (1, 1280, 5120, 16)],
                         ids=["small", "cross", "T2560", "T5120", "cross5120"])
def test_flash_attention_long_kernel_matches_plain(cuda, dtype, shape):
    b, tq, tkv, h = shape
    if dtype == torch.float32 and tkv > 512:
        pytest.skip("the fp32 kernel serves the reference's small fp32 tests only")
    q, k, v = _cuda_inputs(cuda, dtype, (b, tq, h * DH), (b, tkv, h * DH), (b, tkv, h * DH))
    before = ta.flash_attention_long.launches
    out = ta.flash_attention_long(q, k, v, h, block_q=128)
    torch.cuda.synchronize()
    assert ta.flash_attention_long.launches == before + 1
    assert out.dtype == dtype
    _assert_kernel_close(out, ta.flash_attention_long_plain(q, k, v, h))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=DTYPES)
@pytest.mark.parametrize("shape", [(2, 201, 4), (2, 1, 4), (36, 201, 16)],
                         ids=["ragged", "one_frame", "flagship"])
def test_fused_attention_kernels_match_plain(cuda, dtype, shape):
    b, t, h = shape
    q, k, v = _cuda_inputs(cuda, dtype, *[(b, t, h, DH)] * 3, seed=1)
    before = (ta.fused_attention.launches, ta.fused_attention_heads.launches)
    out = ta.fused_attention(q, k, v)
    flat = [x.reshape(b, t, h * DH) for x in (q, k, v)]
    out_heads = ta.fused_attention_heads(*flat, h)
    torch.cuda.synchronize()
    assert (ta.fused_attention.launches, ta.fused_attention_heads.launches) == (
        before[0] + 1, before[1] + 1)
    ref = ta.fused_attention_plain(q, k, v)
    _assert_kernel_close(out, ref)
    _assert_kernel_close(out_heads, ref.reshape(b, t, h * DH))


def _ulps_beyond_one(out, ref):
    """Elements of ``out`` further than one bf16 ulp of ``ref`` from it."""
    _, exp = torch.frexp(ref.float())
    ulp = torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exp - 8)
    return int(((out.float() - ref.float()).abs() > ulp).sum())


# the edges of the two bf16 forms: (B, Tq, Tkv, H)
FORM_EDGES = {
    "short_T256": (2, 256, 256, 4), "long_T257": (2, 257, 257, 4),
    "long_T384": (2, 384, 384, 4), "short_T201": (2, 201, 201, 4),
    "short_T1": (2, 1, 1, 4), "long_kv_not_128_multiple": (1, 2624, 2624, 16),
    "strip640_of_2560": (1, 640, 2560, 16), "strip1280_of_5120": (1, 1280, 5120, 16),
    "short_batch_boundary_in_box": (36, 201, 201, 16),
    "long_batch_boundary_in_box": (3, 300, 300, 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(FORM_EDGES.values()), ids=list(FORM_EDGES))
def test_bf16_forms_match_plain_and_emulation(cuda, shape):
    b, tq, tkv, h = shape
    q, k, v = _cuda_inputs(cuda, torch.bfloat16, (b, tq, h * DH), (b, tkv, h * DH),
                           (b, tkv, h * DH), seed=tq + tkv)
    out = ta._attention_cuda(q, k, v, h)
    torch.cuda.synchronize()
    plain = ta.flash_attention_long_plain(q, k, v, h)
    emulated = ta.attention_online_emulated(q, k, v, h)
    print(f"{shape} form {ta.attention_form(tkv)}: beyond one bf16 ulp of the plain version "
          f"{_ulps_beyond_one(out, plain)}, of the emulation {_ulps_beyond_one(out, emulated)} "
          f"of {out.numel()}")
    _assert_kernel_close(out, plain)
    _assert_kernel_close(out, emulated)
    assert bool(torch.isfinite(out.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("t,n_seq", [(2560, 4), (5120, 4), (5120, 2)])
def test_strips_bit_equal_to_the_whole_sequence(cuda, t, n_seq):
    """A row's result depends on its q row, K and V alone: the strips of a
    sequence-parallel mesh give exactly the whole-sequence rows."""
    q, k, v = _cuda_inputs(cuda, torch.bfloat16, *[(1, t, 16 * DH)] * 3, seed=t + n_seq)
    whole = ta.flash_attention_long(q, k, v, 16, block_q=128)
    strips = torch.cat([ta.sp_flash_attention_long(piece.contiguous(), k, v, 16)
                        for piece in q.chunk(n_seq, dim=1)], dim=1)
    torch.cuda.synchronize()
    assert torch.equal(strips, whole)


@pytest.mark.cuda
def test_kernel_rejects_other_head_dims(cuda):
    q = torch.zeros(1, 256, 4 * 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 64"):
        ta.flash_attention_long(q, q, q, 4)
    q16 = torch.zeros(1, 256, C, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ta.flash_attention_long(q16, q16, q16, H)


@pytest.mark.cuda
def test_encoder_long_route_on_card_matches_einsum_route(cuda):
    """The tiny bf16 encoder at T 256 through the kernel, against the same
    weights on the plain einsum route (flash_long_t=0)."""
    from sls_tpu_torch.encoder.xlsr import XLSREncoder, init_weights_

    cfg = tcfg.tiny_xlsr_config(dtype=torch.bfloat16, embed_dim=256, num_heads=4,
                                flash_long_t=256)
    enc = XLSREncoder(cfg, device=cuda)
    init_weights_(enc, torch.Generator(device=cuda).manual_seed(0))
    plain = XLSREncoder(dataclasses.replace(cfg, flash_long_t=0), device=cuda)
    plain.load_state_dict(enc.state_dict())
    wav = torch.randn(1, _length(256), device=cuda) * 0.1
    before = ta.flash_attention_long.launches
    with torch.inference_mode():
        out, ref = enc(wav).float(), plain(wav).float()
    assert ta.flash_attention_long.launches == before + cfg.encoder_layers
    assert float(torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref)) < 1e-2
