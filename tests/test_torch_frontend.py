"""The port's fused conv front-end against the JAX package: the tiling
helpers, the plain version of ``frontend_tail_fused`` against the Pallas
kernel (interpret mode on the CPU, as ``tests/test_frontend_kernel.py``
runs it), the wrapper's checks, the fused ``ConvFeatureExtractor`` and
``XLSREncoder`` against the JAX modules on shared weights (the same
route taken on both sides), the route rule and its counter, and (on a
card) the CUDA kernel against its plain version and the default
encoder's route.

The JAX side is imported inside fixtures and tests, so that on a machine
with a card and no JAX the CUDA tests still run:
``python -m pytest --noconftest -m cuda tests/test_torch_frontend.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sls_tpu_torch import config as tcfg
from sls_tpu_torch.evaluation.overlap import length_buckets
from sls_tpu_torch.kernels import frontend as tf

F32_TOL = 2e-5  # the reference's own bound (tests/test_frontend_kernel.py): fp32 sums in another order
# bf16: the same fp32 sums in another order flip a bf16 rounding near a tie
# now and then, and a flipped level feeds the next; outputs are O(1) after
# LayerNorm and GELU, so two bf16 ulps of 1.0 bound the difference, and
# at most 2 % of the outputs may be more than one ulp of their own off
BF16_TOL = 2.0 ** -6
BF16_FLIP_SHARE = 0.02
# The CUDA kernel's tensor cores round their fp32 sums otherwise than
# cuDNN's fp32 convs, so at 512 channels more levels flip (about a fifth
# of the outputs differ by an ulp after six levels).  Its bound is the
# plain version's own distance from the plain version with fp64 sums:
# the kernel lies within 2x of it (relative L2), and no output is further
# off than 1e-2 of max|plain| (one or two ulps at the largest outputs).
KERNEL_ENVELOPE = 2.0
KERNEL_REL_TOL = 1e-2

XLSR_LAYERS = tcfg.XLSRConfig().conv_layers
XLSR_SPECS = tuple((k, s) for _, k, s in XLSR_LAYERS[1:])
# the reference test's 4-layer tiny topology: 6405 samples -> n0 1280, T 159
FUSED_TINY = ((32, 10, 5), (32, 3, 2), (32, 3, 2), (32, 2, 2))
FULL_TINY = tuple((32, k, s) for _, k, s in XLSR_LAYERS)  # 64600 samples -> T 201


@pytest.fixture(scope="module")
def jf():
    return pytest.importorskip("sls_tpu.kernels.frontend")


@pytest.fixture(scope="module")
def jnp():
    return pytest.importorskip("jax.numpy")


def _n0(layers, samples):
    _, k0, s0 = layers[0]
    return (samples - k0) // s0 + 1


def _tail_inputs(layers, samples, batch, seed):
    """h0 [B, N0, C], WIO weights, biases and LayerNorm affine (numpy)."""
    specs = tuple((k, s) for _, k, s in layers[1:])
    c = layers[0][0]
    rng = np.random.default_rng(seed)
    h0 = rng.normal(0, 1, (batch, _n0(layers, samples), c)).astype(np.float32)
    ws = [rng.normal(0, (k * c) ** -0.5, (k, c, c)).astype(np.float32) for k, _ in specs]
    bias = rng.normal(0, 0.1, (len(specs), c)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(len(specs) + 1, c))).astype(np.float32)
    shift = (0.1 * rng.normal(size=(len(specs) + 1, c))).astype(np.float32)
    return specs, h0, ws, bias, scale, shift


def _torch_args(h0, ws, bias, scale, shift, dtype, device="cpu"):
    def t(a):
        return torch.from_numpy(a).to(device)
    return t(h0).to(dtype), tuple(t(w) for w in ws), t(bias), t(scale), t(shift)


def _assert_bf16_close(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = np.abs(out - ref)
    _, exp = np.frexp(ref)
    share = (err > np.ldexp(1.0, exp - 8)).mean()
    assert err.max() <= BF16_TOL and share <= BF16_FLIP_SHARE, (
        f"max_abs_err {err.max()}, max|ref| {np.abs(ref).max()}, beyond one ulp {share}")


# -- (a) the tiling helpers ---------------------------------------------------


def _helper_cases():
    cases = {"flagship": (12919, XLSR_SPECS, 512),
             "fused_tiny": (_n0(FUSED_TINY, 6405), tuple((k, s) for _, k, s in FUSED_TINY[1:]),
                            32),
             "infeasible_tiny": (_n0(tcfg.tiny_xlsr_config().conv_layers, 3200),
                                 ((3, 2), (2, 2)), 32)}
    for t, samples in length_buckets(tcfg.XLSRConfig()).items():
        cases[f"bucket_T{t}"] = (_n0(XLSR_LAYERS, samples), XLSR_SPECS, 512)
    return cases


HELPER_CASES = _helper_cases()


@pytest.mark.parametrize("case", list(HELPER_CASES))
def test_tiling_helpers_match_jax(case, jf):
    n0, specs, c = HELPER_CASES[case]
    lengths = tf.tail_lengths(n0, specs)
    assert lengths == jf.tail_lengths(n0, specs)
    t_out = lengths[-1]
    for f in (1, 2, 3, t_out):
        assert tf.required_input(f, specs) == jf.required_input(f, specs)
    for itemsize in (2, 4):
        assert tf.choose_tile(t_out, n0, specs, c, itemsize) == jf.choose_tile(
            t_out, n0, specs, c, itemsize)
    f = tf.choose_tile(t_out, n0, specs, c)
    if case == "flagship":
        assert (t_out, f) == (201, 67)
    elif case == "infeasible_tiny":
        assert f is None
    else:  # the buckets take the fused route too (T a multiple of 256: f = 64)
        assert f is not None


@pytest.mark.parametrize("case", [c for c in HELPER_CASES if HELPER_CASES[c][2] == 512])
def test_level_pitches_cover_what_each_layer_reads(case):
    """The bf16 kernel stores each level with a pitch that is a multiple of
    the next conv's stride and reads it as rows of s frames: every frame a
    stored output reads lies inside the level, and inside its rows."""
    n0, specs, _ = HELPER_CASES[case]
    lengths = tf.tail_lengths(n0, specs)
    pitches = tf.level_pitches(n0, specs)
    assert len(pitches) == len(lengths) and pitches[-1] == lengths[-1]
    for (k, s), n_in, n_out, pitch in zip(specs, lengths, lengths[1:], pitches):
        assert n_in <= pitch < n_in + s and pitch % s == 0
        # output frame n_out - 1 reads frames s (n_out - 1) .. s (n_out - 1) + k - 1,
        # rows n_out - 1 .. n_out - 1 + (k - 1) // s of the grouped view
        assert s * (n_out - 1) + k <= n_in
        assert n_out - 1 + (k - 1) // s < pitch // s
    assert tf.required_input(lengths[-1], specs) <= n0


# -- (b, c) the plain version against the Pallas kernel -----------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers,samples", [(FUSED_TINY, 6405), (FULL_TINY, 64600)],
                         ids=["fused_tiny", "xlsr_topology_c32"])
def test_plain_matches_jax_kernel(layers, samples, dtype, jf, jnp):
    specs, h0, ws, bias, scale, shift = _tail_inputs(layers, samples, 2, seed=samples)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    approx = dtype == "bfloat16"  # the encoder's rule: tanh GELU iff bf16
    ref = jf.frontend_tail_fused(
        jnp.asarray(h0, jd), tuple(jnp.asarray(w) for w in ws), jnp.asarray(bias),
        jnp.asarray(scale), jnp.asarray(shift), specs=specs, approx_gelu=approx,
        out_dtype=jd, interpret=True)
    before = tf.frontend_tail_fused.launches
    out = tf.frontend_tail_fused(*_torch_args(h0, ws, bias, scale, shift, td), specs=specs,
                                 approx_gelu=approx, out_dtype=td)
    assert tf.frontend_tail_fused.launches == before  # the CPU takes the plain version
    assert out.dtype == td and out.shape == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=F32_TOL)
    else:
        _assert_bf16_close(out.float().numpy(), ref)


def test_plain_reads_a_strided_h0():
    """The encoder passes conv 0's channels-first output as a [B, N0, C]
    view; the result is that of a contiguous copy (the reductions run in
    another order over the other layout, so not to the bit)."""
    specs, h0, ws, bias, scale, shift = _tail_inputs(FUSED_TINY, 6405, 2, seed=3)
    args = _torch_args(h0, ws, bias, scale, shift, torch.float32)
    view = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous()
    kw = dict(specs=specs, approx_gelu=False, out_dtype=torch.float32)
    torch.testing.assert_close(tf.frontend_tail_fused(view, *args[1:], **kw),
                               tf.frontend_tail_fused(*args, **kw), rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_plain_with_fp64_sums_is_the_same_function(dtype):
    """fp64 sums rounded to fp32 only change how the sums round: within
    the reference's fp32 bound at fp32, and the bf16 flips at bf16."""
    specs, h0, ws, bias, scale, shift = _tail_inputs(FULL_TINY, 64600, 2, seed=9)
    args = _torch_args(h0, ws, bias, scale, shift, dtype)
    kw = dict(specs=specs, approx_gelu=dtype == torch.bfloat16, out_dtype=dtype)
    out = tf.frontend_tail_fused_plain(*args, **kw, sum_dtype=torch.float64)
    ref = tf.frontend_tail_fused_plain(*args, **kw)
    assert out.dtype == ref.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=F32_TOL)
    else:
        _assert_bf16_close(out.float().numpy(), ref.float().numpy())


# -- (d) the wrapper's checks ---------------------------------------------------


@pytest.mark.parametrize("frames_per_tile", [7, 3], ids=["not_a_divisor", "read_overruns"])
def test_rejects_bad_tile_override(frames_per_tile, jf, jnp):
    """As the reference: specs ((3, 2), (2, 2)) on 639 frames give T 159;
    7 does not divide it, and tiles of 3 would read 640 frames."""
    specs = ((3, 2), (2, 2))
    args = [np.zeros((1, 639, 32), np.float32),
            (np.zeros((3, 32, 32), np.float32), np.zeros((2, 32, 32), np.float32)),
            np.zeros((2, 32), np.float32), np.zeros((3, 32), np.float32),
            np.zeros((3, 32), np.float32)]
    kw = dict(specs=specs, approx_gelu=False, frames_per_tile=frames_per_tile)
    with pytest.raises(ValueError):
        tf.frontend_tail_fused(torch.from_numpy(args[0]), tuple(map(torch.from_numpy, args[1])),
                               *map(torch.from_numpy, args[2:]), **kw)
    with pytest.raises(ValueError):
        jf.frontend_tail_fused(jnp.asarray(args[0]), tuple(map(jnp.asarray, args[1])),
                               *map(jnp.asarray, args[2:]), interpret=True, **kw)


def test_rejects_infeasible_tiling_without_override():
    specs = ((3, 2), (2, 2))
    with pytest.raises(ValueError, match="infeasible tiling"):
        tf.frontend_tail_fused(torch.zeros(1, 639, 32), (torch.zeros(3, 32, 32),
                               torch.zeros(2, 32, 32)), torch.zeros(2, 32),
                               torch.zeros(3, 32), torch.zeros(3, 32), specs=specs,
                               approx_gelu=False)


def test_never_falls_back_off_the_cpu():
    h0 = torch.empty(1, 12919, 512, device="meta")
    ws = tuple(torch.empty(k, 512, 512, device="meta") for k, _ in XLSR_SPECS)
    with pytest.raises(ValueError, match="no kernel"):
        tf.frontend_tail_fused(h0, ws, torch.empty(6, 512, device="meta"),
                               torch.empty(7, 512, device="meta"),
                               torch.empty(7, 512, device="meta"), specs=XLSR_SPECS,
                               approx_gelu=True)


# -- (e) the fused route through the port's modules -----------------------------


def _perturbed(params, seed):
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


ROUTE_CASES = {"fused": (FUSED_TINY, 6405, True), "infeasible": (None, 3200, False)}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_feature_extractor_takes_the_reference_route(case, monkeypatch):
    """The fused-frontend extractor at fp32 against the JAX module on
    shared weights: the same route (the kernel called on both sides, or
    on neither) and the same output within the reference's bound."""
    import jax
    import jax.numpy as jnp

    import sls_tpu.encoder.xlsr as jx
    import sls_tpu_torch.encoder.xlsr as tx
    from sls_tpu.config import tiny_xlsr_config
    from sls_tpu_torch.convert import detector_state_from_flax

    layers, samples, fused = ROUTE_CASES[case]
    kw = {} if layers is None else {"conv_layers": layers}
    wav = np.random.default_rng(4).normal(0, 0.1, (2, samples)).astype(np.float32)
    jcfg = tiny_xlsr_config(fused_frontend=True, **kw)
    jmod = jx.ConvFeatureExtractor(jcfg)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(wav))["params"], 5)
    assert jmod._fused_ok(False, samples) == fused
    j_calls = _count_calls(monkeypatch, jx, "frontend_tail_fused")
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(wav)))

    mod = tx.ConvFeatureExtractor(tcfg.tiny_xlsr_config(fused_frontend=True, **kw), device="cpu")
    mod.load_state_dict(detector_state_from_flax(params), strict=True)
    assert mod._fused_ok(samples) == fused
    t_calls = _count_calls(monkeypatch, tx, "frontend_tail_fused")
    with torch.inference_mode():
        out = mod(torch.from_numpy(wav)).numpy()
    assert len(j_calls) == len(t_calls) == int(fused)
    np.testing.assert_allclose(out, ref, rtol=0, atol=F32_TOL)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def encoder_case():
    """JAX tiny-encoder params on the fused tiny topology (perturbed), the
    port's state dict, a waveform, and the JAX fused encoder's outputs at
    fp32 and bf16."""
    import jax
    import jax.numpy as jnp

    from sls_tpu.config import tiny_xlsr_config
    from sls_tpu.encoder.xlsr import XLSREncoder
    from sls_tpu_torch.convert import detector_state_from_flax

    wav = np.random.default_rng(6).normal(0, 0.1, (2, 6405)).astype(np.float32)
    cfg = tiny_xlsr_config(conv_layers=FUSED_TINY, fused_frontend=True)
    params = _perturbed(XLSREncoder(cfg).init(jax.random.PRNGKey(0), jnp.asarray(wav))["params"],
                        7)
    out = {dt: np.asarray(XLSREncoder(dataclasses.replace(cfg, dtype=getattr(jnp, dt))).apply(
        {"params": params}, jnp.asarray(wav)).astype(jnp.float32))
        for dt in ("float32", "bfloat16")}
    state = {k.removeprefix("encoder."): v
             for k, v in detector_state_from_flax({"encoder": params}).items()}
    return wav, state, out


def _port_encoder(state, dtype):
    from sls_tpu_torch.encoder.xlsr import XLSREncoder

    enc = XLSREncoder(tcfg.tiny_xlsr_config(conv_layers=FUSED_TINY, fused_frontend=True,
                                            dtype=dtype), device="cpu")
    enc.load_state_dict(state, strict=True)
    return enc


def test_fused_encoder_fp32_matches_jax(encoder_case):
    wav, state, ref = encoder_case
    with torch.inference_mode():
        out = _port_encoder(state, torch.float32)(torch.from_numpy(wav)).numpy()
    assert out.shape == (2, 159, 64)
    # as tests/test_torch_encoder.py: fp32 sums in other orders through the layers
    np.testing.assert_allclose(out, ref["float32"], atol=1e-4, rtol=0)


def test_fused_encoder_bf16_within_reference_envelope(encoder_case):
    """The rule of tests/test_torch_encoder.py: the JAX fused encoder's own
    bf16 error against its fp32 output is the envelope; the port's bf16
    output lies within 1.5x of it from fp32 and 2x of it from JAX's bf16."""
    wav, state, ref = encoder_case
    with torch.inference_mode():
        out = _port_encoder(state, torch.bfloat16)(torch.from_numpy(wav)).float().numpy()
    envelope = _rel(ref["bfloat16"], ref["float32"])
    assert 0 < envelope < 0.05
    assert _rel(out, ref["float32"]) <= 1.5 * envelope
    assert _rel(out, ref["bfloat16"]) <= 2.0 * envelope


# -- (e) the route rule: the kernel at eval on a card by default ------------------

RULE_SAMPLES = {"feasible": 64600, "infeasible": 2000}  # XLS-R topology: T 201, T 6
RULE_CONFIGS = {  # (width, dtype): the kernel takes the first alone
    "xlsr": (512, torch.bfloat16), "narrow": (32, torch.bfloat16),
    "float16": (512, torch.float16)}


@pytest.mark.parametrize("length", list(RULE_SAMPLES))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "card"])
@pytest.mark.parametrize("flag", [False, True], ids=["default", "fused_frontend"])
@pytest.mark.parametrize("kind", list(RULE_CONFIGS))
def test_route_rule(kind, flag, on_card, train, length):
    """Eval with a feasible shape on a card takes the kernel whatever the
    flag (where the kernel takes the width and dtype); off the card only
    with the flag; never under train or at an infeasible shape."""
    from sls_tpu_torch.encoder.xlsr import ConvFeatureExtractor

    width, dtype = RULE_CONFIGS[kind]
    cfg = tcfg.XLSRConfig(conv_layers=tuple((width, k, s) for _, k, s in XLSR_LAYERS),
                          dtype=dtype, fused_frontend=flag)
    fe = ConvFeatureExtractor(cfg, device="meta")
    want = (not train and length == "feasible"
            and (flag or (on_card and kind == "xlsr")))
    assert fe._fused_ok(RULE_SAMPLES[length], train, on_card=on_card) == want
    if not on_card:
        assert fe._fused_ok(RULE_SAMPLES[length], train) == want  # the keyword's default


@pytest.mark.parametrize("flag", [False, True], ids=["default", "fused_frontend"])
def test_forward_counts_its_route(flag):
    """One CPU forward of the encoder under recording counts its front-end
    route once: unfused at the default config, the kernel route (its plain
    version here) with the flag.  Its LayerNorms count their own (plain)
    route: post-extract, two a layer and the final norm, and the unfused
    front-end's conv norms."""
    from sls_tpu_torch.encoder.xlsr import XLSREncoder
    from sls_tpu_torch.train import profiling

    cfg = tcfg.tiny_xlsr_config(conv_layers=FUSED_TINY, fused_frontend=flag)
    enc = XLSREncoder(cfg, device="cpu")
    wav = torch.randn(2, 6405, generator=torch.Generator().manual_seed(9))
    with torch.inference_mode(), profiling.recording() as rec:
        enc(wav)
    route = "sls.frontend.kernel" if flag else "sls.frontend.unfused"
    assert {k: v for k, v in rec.counts.items() if k.startswith("sls.frontend")} == {route: 1}
    assert [s.name for s in rec.spans] == ["sls.frontend", "sls.layers"]
    norms = 2 * cfg.encoder_layers + 2 + (0 if flag else len(cfg.conv_layers))
    with torch.inference_mode():
        enc(wav)  # recording off: nothing is held
    assert rec.counts == {route: 1, "sls.layernorm.plain": norms}


# -- (f) on a card: the kernel against its plain version -------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the plain version's fp32 convs
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["contiguous", "channels_first_view"])
@pytest.mark.parametrize("samples", [16160, 64600], ids=["T50", "T201"])
def test_kernel_matches_plain(cuda, dtype, layout, samples):
    layers = tuple((512, k, s) for _, k, s in XLSR_LAYERS)
    specs, h0, ws, bias, scale, shift = _tail_inputs(layers, samples, 3, seed=8)
    args = _torch_args(h0, ws, bias, scale, shift, dtype, device=cuda)
    h = args[0]
    if layout == "channels_first_view":
        h = h.transpose(1, 2).contiguous().transpose(1, 2)
    approx = dtype == torch.bfloat16
    kw = dict(specs=specs, approx_gelu=approx, out_dtype=dtype)
    before = tf.frontend_tail_fused.launches
    out = tf.frontend_tail_fused(h, *args[1:], **kw)
    torch.cuda.synchronize()
    assert tf.frontend_tail_fused.launches == before + 1
    ref = tf.frontend_tail_fused_plain(*args, **kw)
    assert out.shape == ref.shape == (3, tf.tail_lengths(h0.shape[1], specs)[-1], 512)
    if dtype == torch.float32:
        # fp32 FMAs over k*512 terms in another order than cuDNN's
        assert float((out - ref).abs().max()) <= 1e-4
    else:
        out, ref = out.float(), ref.float()
        ref64 = tf.frontend_tail_fused_plain(*args, **kw, sum_dtype=torch.float64).float()
        envelope = float(torch.linalg.vector_norm(ref64 - ref) / torch.linalg.vector_norm(ref))
        assert 0 < envelope < 1e-2
        assert float(torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref)) <= (
            KERNEL_ENVELOPE * envelope)
        assert float((out - ref).abs().max()) <= KERNEL_REL_TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rows", "channels_first_view"])
@pytest.mark.parametrize("batch,n0", [(36, 12919), (2, 12000), (1, 327698)],
                         ids=["B36_T201", "B2_T187", "B1_T5120"])
def test_kernel_matches_plain_at_path_shapes(cuda, batch, n0, layout):
    """bf16 at the fused front-end path's batch, a length whose levels all
    end in partial 64-frame tiles, and one T 5120 utterance (the fused
    route's long forward), on h0 as the encoder's conv 0 leaves it (each
    frame's channels contiguous: the LN0 pass on rows) and on a
    channels-first view (the tiled LN0 pass); the first utterances held as
    test_kernel_matches_plain holds them."""
    g = torch.Generator(device=cuda).manual_seed(n0)
    h0 = torch.randn(batch, 512, n0, device=cuda, generator=g).to(torch.bfloat16).transpose(1, 2)
    if layout == "rows":
        h0 = h0.contiguous()
    ws = tuple(torch.randn(k, 512, 512, device=cuda, generator=g) * (k * 512) ** -0.5
               for k, _ in XLSR_SPECS)
    bias = torch.randn(len(XLSR_SPECS), 512, device=cuda, generator=g) * 0.1
    scale = 1 + 0.1 * torch.randn(len(XLSR_SPECS) + 1, 512, device=cuda, generator=g)
    shift = 0.1 * torch.randn(len(XLSR_SPECS) + 1, 512, device=cuda, generator=g)
    kw = dict(specs=XLSR_SPECS, approx_gelu=True)
    out = tf.frontend_tail_fused(h0, ws, bias, scale, shift, **kw)
    torch.cuda.synchronize()
    assert out.shape == (batch, tf.tail_lengths(n0, XLSR_SPECS)[-1], 512)
    assert bool(torch.isfinite(out.float()).all())
    few = min(batch, 2)
    out = out[:few].float()
    ref = tf.frontend_tail_fused_plain(h0[:few], ws, bias, scale, shift, **kw).float()
    ref64 = tf.frontend_tail_fused_plain(h0[:few], ws, bias, scale, shift, **kw,
                                         sum_dtype=torch.float64).float()
    envelope = float(torch.linalg.vector_norm(ref64 - ref) / torch.linalg.vector_norm(ref))
    assert 0 < envelope < 1e-2
    assert float(torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref)) <= (
        KERNEL_ENVELOPE * envelope)
    assert float((out - ref).abs().max()) <= KERNEL_REL_TOL * float(ref.abs().max())


@pytest.mark.cuda
def test_encoder_level0_takes_the_rows_pass(cuda):
    """Conv 0 as the encoder runs it leaves each frame's 512 channels
    contiguous, the layout the LN0 pass reads with 16-byte rows."""
    from sls_tpu_torch.encoder.xlsr import ConvFeatureExtractor

    fe = ConvFeatureExtractor(tcfg.XLSRConfig(dtype=torch.bfloat16), cuda)
    with torch.inference_mode():
        h0 = fe.level0(torch.randn(3, 16160, device=cuda))
    assert h0.shape[2] == 512 and h0.stride(2) == 1 and h0.stride(1) == 512


@pytest.mark.cuda
def test_kernel_rejects_other_widths(cuda):
    h0 = torch.zeros(1, 1280, 32, device=cuda, dtype=torch.bfloat16)
    specs = ((3, 2), (3, 2), (2, 2))
    ws = tuple(torch.zeros(k, 32, 32, device=cuda) for k, _ in specs)
    z = torch.zeros(4, 32, device=cuda)
    with pytest.raises(ValueError, match="512 channels"):
        tf.frontend_tail_fused(h0, ws, z[:3], z, z, specs=specs, approx_gelu=True)


def _unfused_frontend(enc):
    """``enc`` with its front-end on the unfused route (``tail``), which
    an eval forward on a card otherwise leaves for the kernel."""
    fe = enc.feature_extractor
    fe.forward = lambda wav, train=False: fe.tail(fe.level0(wav))
    return enc


def _assert_within_envelope(out, ref, f32):
    """Two different bf16 functions: ``out`` within 1.5x of the unfused
    route's own bf16 error against fp32 from fp32, and within 2x of it from
    the unfused route ``ref``."""
    envelope = float(torch.linalg.vector_norm(ref - f32) / torch.linalg.vector_norm(f32))
    assert float(torch.linalg.vector_norm(out - f32) / torch.linalg.vector_norm(f32)) <= (
        1.5 * envelope)
    assert float(torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(f32)) <= (
        2.0 * envelope)


@pytest.mark.cuda
def test_fused_encoder_on_card_matches_unfused_route(cuda):
    """A bf16 encoder with XLS-R's 512-wide front-end through the kernel,
    against the same weights on the unfused route: two different bf16
    functions, so the bound is the unfused route's own bf16 error against
    fp32 (the same envelope rule as above)."""
    from sls_tpu_torch.encoder.xlsr import XLSREncoder, init_weights_

    cfg = tcfg.tiny_xlsr_config(conv_layers=XLSR_LAYERS, dtype=torch.bfloat16,
                                fused_frontend=True)
    enc = XLSREncoder(cfg, device=cuda)
    init_weights_(enc, torch.Generator(device=cuda).manual_seed(0))

    def sharing(**kw):
        m = XLSREncoder(dataclasses.replace(cfg, **kw), device=cuda)
        m.load_state_dict(enc.state_dict())
        return _unfused_frontend(m)

    unfused = sharing(fused_frontend=False)
    truth = sharing(fused_frontend=False, dtype=torch.float32, approx_gelu=True)
    wav = torch.randn(2, 64600, device=cuda) * 0.1
    before = tf.frontend_tail_fused.launches
    with torch.inference_mode():
        out, ref, f32 = (m(wav).float() for m in (enc, unfused, truth))
    assert tf.frontend_tail_fused.launches == before + 1
    _assert_within_envelope(out, ref, f32)


@pytest.mark.cuda
def test_default_encoder_on_card_takes_the_kernel(cuda):
    """The default encoder config (``fused_frontend`` off) at eval on a
    card: row 8 launched once a forward at the scoring cut (4 rows) and at
    the T 2560 bucket's length, none under ``train``, and its front-end
    within the envelope above of the unfused route (``tail``)."""
    from sls_tpu_torch.encoder.xlsr import ConvFeatureExtractor, XLSREncoder, init_weights_

    cfg = tcfg.XLSRConfig()
    enc = XLSREncoder(cfg, device=cuda)
    init_weights_(enc, torch.Generator(device=cuda).manual_seed(0))
    fe = enc.feature_extractor
    fe32 = ConvFeatureExtractor(dataclasses.replace(cfg, dtype=torch.float32, approx_gelu=True),
                                cuda)
    fe32.load_state_dict(fe.state_dict())
    g = torch.Generator(device=cuda).manual_seed(1)
    for rows, samples in ((4, 64600), (1, length_buckets(cfg, t_targets=(2560,))[2560])):
        wav = torch.randn(rows, samples, device=cuda, generator=g) * 0.1
        before = tf.frontend_tail_fused.launches
        with torch.inference_mode():
            enc(wav)
        torch.cuda.synchronize()
        assert tf.frontend_tail_fused.launches == before + 1, samples
        with torch.inference_mode():
            out = fe(wav).float()
            ref = fe.tail(fe.level0(wav)).float()
            f32 = fe32.tail(fe32.level0(wav))
        assert out.shape == ref.shape == (rows, cfg.num_frames(samples), 512)
        _assert_within_envelope(out, ref, f32)
    wav = torch.randn(4, 64600, device=cuda, generator=g) * 0.1
    before = tf.frontend_tail_fused.launches
    with torch.no_grad():
        enc(wav, train=True, generator=torch.Generator(device=cuda).manual_seed(2))
    assert tf.frontend_tail_fused.launches == before
