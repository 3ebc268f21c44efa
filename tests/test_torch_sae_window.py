"""The window-overlap SAE path of the port against the JAX package: the
plain versions of ``sae_encode_fused``, ``window_vote_fused`` and
``topk_sparsify`` against the Pallas kernels (interpret mode on the
CPU), the fp32 window rules, ``TopKSAE.encode`` for both window
variants, the tiny window-overlap Detector, serving, and (on a card)
each new CUDA kernel against its plain version.

The JAX side is imported inside fixtures, so that on a machine with a
card and no JAX the CUDA tests still run:
``python -m pytest --noconftest -m cuda tests/test_torch_sae_window.py``.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from sls_tpu_torch import config as tcfg
from sls_tpu_torch.kernels import sae_kernels as tk
from sls_tpu_torch.sae import sparsify as tsp

D, M, K = 64, 256, 32
VOTE_CASES = [(16, 8), (17, 8), (201, 8), (12, 4)]


@pytest.fixture(scope="module")
def jax_sk():
    return pytest.importorskip("sls_tpu.kernels.sae_kernels")


@pytest.fixture(scope="module")
def jnp():
    return pytest.importorskip("jax.numpy")


@pytest.fixture(scope="module")
def interpret_kernels(jax_sk):
    """Route the JAX package's SAE kernels through Pallas interpret mode."""
    names = ("sae_encode_fused", "window_vote_fused", "sae_encode_topk_fused",
             "sae_decode_fused")
    with pytest.MonkeyPatch.context() as mp:
        for name in names:
            fn = getattr(jax_sk, name)
            mp.setattr(jax_sk, name,
                       lambda *a, _fn=fn, **kw: _fn(*a, **{**kw, "interpret": True}))
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _vote_input(T, w):
    """The inputs of tests/test_kernels.py::test_window_vote_fused_matches_jnp:
    one generator drawn through its cases in order."""
    rng = np.random.default_rng(10)
    for case in VOTE_CASES:
        x = rng.uniform(0.05, 1.0, (2, case[0], 128)).astype(np.float32)
        if case == (T, w):
            return x
    raise KeyError((T, w))


def _relu_acts(seed, shape):
    return np.maximum(np.random.default_rng(seed).normal(size=shape), 0).astype(np.float32)


# -- plain versions against the Pallas kernels ------------------------------


def test_encode_fused_plain_matches_jax_kernel(jax_sk, jnp):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 128)).astype(np.float32)  # N not tile-aligned
    w_enc = rng.normal(size=(128, 512)).astype(np.float32) * 0.05
    b_enc = rng.normal(size=(512,)).astype(np.float32) * 0.1
    b_dec = rng.normal(size=(128,)).astype(np.float32) * 0.1
    ref = np.asarray(jax_sk.sae_encode_fused(*map(jnp.asarray, (x, w_enc, b_enc, b_dec)),
                                             interpret=True))
    out = tk.sae_encode_fused_plain(*map(torch.from_numpy, (x, w_enc, b_enc, b_dec))).numpy()
    # fp32 products summed over D = 128 in another order
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("T,w", VOTE_CASES)
def test_window_vote_plain_matches_jax_kernel(T, w, jax_sk, jnp):
    x = _vote_input(T, w)
    ref = np.asarray(jax_sk.window_vote_fused(jnp.asarray(x), k=16, window=w, interpret=True))
    out = tk.window_vote_fused_plain(torch.from_numpy(x), 16, w).numpy()
    # the same bf16 steps; the fp32 chunk sums of bf16 values are exact
    # here, so no near-tie allowance is needed: supports and values equal
    np.testing.assert_array_equal(out > 0, ref > 0)
    np.testing.assert_array_equal(out, ref)


def test_window_vote_zeroes_the_uncovered_tail():
    x = torch.from_numpy(_vote_input(201, 8))
    out = tk.window_vote_fused_plain(x, 16, 8)
    assert torch.all(out[:, 200] == 0)  # frame 200: no window covers it
    assert torch.all((out[:, :200] > 0).sum(-1) >= 16)


def test_window_vote_rejects_odd_windows():
    with pytest.raises(ValueError, match="even window"):
        tk.window_vote_fused(torch.ones(1, 9, 128), 4, 5)


def test_topk_sparsify_plain_matches_jax_kernel(jax_sk, jnp):
    x = _relu_acts(9, (3, 40, 256))
    ref = np.asarray(jax_sk.topk_sparsify_pallas(jnp.asarray(x), 32, tile_n=64, interpret=True))
    out = tk.topk_sparsify(torch.from_numpy(x), 32)
    assert out.shape == x.shape
    np.testing.assert_array_equal(out.numpy(), ref)


# -- the fp32 window rules --------------------------------------------------


@pytest.mark.parametrize("T,w", [(5, 8), (16, 8), (17, 8), (201, 8), (12, 4), (15, 5)],
                         ids=["short", "T16w8", "T17w8", "T201w8", "T12w4", "odd"])
@pytest.mark.parametrize("rule", ["window_topk_overlap", "window_topk_hard"])
def test_window_rules_match_jax(rule, T, w):
    jnp = pytest.importorskip("jax.numpy")
    jsp = pytest.importorskip("sls_tpu.sae.sparsify")
    x = _relu_acts(T * 10 + w, (2, T, 128))
    ref = np.asarray(getattr(jsp, rule)(jnp.asarray(x), 16, w))
    out = getattr(tsp, rule)(torch.from_numpy(x), 16, w).numpy()
    assert out.shape == ref.shape == x.shape
    np.testing.assert_array_equal(out, ref)


def test_overlap_geometry_matches_jax():
    jsp = pytest.importorskip("sls_tpu.sae.sparsify")
    for T in (1, 4, 5, 7, 8, 9, 16, 17, 200, 201, 2000):
        for w in (2, 4, 5, 8, 16):
            assert tsp._overlap_geometry(T, w) == jsp._overlap_geometry(T, w)
            args = tsp._overlap_geometry(T, w)
            cov = tsp._coverage_matrix(args[3], w, args[0], args[1]).numpy()
            np.testing.assert_array_equal(cov, jsp._coverage_matrix(args[3], w, args[0], args[1]))


def test_overlap_rule_tail_and_short_sequences():
    x = torch.from_numpy(_relu_acts(3, (2, 201, 128))) + 0.01
    out = tsp.window_topk_overlap(x, 16, 8)
    assert torch.all(out[:, 200] == 0)  # uncovered trailing frame zeroed
    short = tsp.window_topk_overlap(x[:, :5], 16, 8)  # padded to one window
    assert short.shape == (2, 5, 128)
    assert torch.all((short > 0).sum(-1) == 16)


# -- TopKSAE.encode for the window variants ---------------------------------


@pytest.fixture(scope="module")
def sae_params():
    rng = np.random.default_rng(4)
    return {
        "W_enc": rng.normal(size=(D, M)).astype(np.float32) * D ** -0.5,
        "W_dec": rng.normal(size=(M, D)).astype(np.float32) * D ** -0.5,
        "b_enc": rng.normal(size=(M,)).astype(np.float32) * 0.1,
        "b_dec": rng.normal(size=(D,)).astype(np.float32) * 0.1,
    }


def _sae_pair(variant, window, use_pallas, params):
    from sls_tpu.config import SAEConfig
    from sls_tpu.sae.topk import TopKSAE as JaxSAE
    from sls_tpu_torch.sae.topk import TopKSAE

    kw = dict(activation_dim=D, dict_size=M, k=K, variant=variant, window_size=window,
              use_pallas=use_pallas)
    port = TopKSAE(tcfg.SAEConfig(**kw), device="cpu")
    port.load_state_dict({n: torch.from_numpy(v) for n, v in params.items()}, strict=True)
    return JaxSAE(SAEConfig(**kw)), port


@pytest.mark.parametrize("variant,window", [("window_overlap", 8), ("window_overlap", 5),
                                            ("window_hard", 8)])
@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "jnp"])
def test_sae_encode_window_variants_match_jax(variant, window, use_pallas, sae_params,
                                              interpret_kernels, jnp):
    jsae, port = _sae_pair(variant, window, use_pallas, sae_params)
    x = np.random.default_rng(5).normal(size=(2, 41, D)).astype(np.float32)
    variables = {"params": {n: jnp.asarray(v) for n, v in sae_params.items()}}
    ref = np.asarray(jsae.apply(variables, jnp.asarray(x), method=jsae.encode))
    acts_ref = np.asarray(jsae.apply(variables, jnp.asarray(x), method=jsae.pre_activations))
    with torch.inference_mode():
        out = port.encode(torch.from_numpy(x)).numpy()
        acts = port.pre_activations(torch.from_numpy(x)).numpy()
    # fp32 encode, sums over D = 64 in another order
    np.testing.assert_allclose(acts, acts_ref, rtol=0, atol=1e-5)
    # the window rules select on sums of those activations: the supports
    # agree exactly where no selection is a near-tie, which these seeded
    # inputs never are; values agree to the encode's noise, and under
    # use_pallas with an even window both round the kept values to bf16
    np.testing.assert_array_equal(out > 0, ref > 0)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_window_variants_need_three_dims(sae_params):
    from sls_tpu_torch.sae.topk import TopKSAE

    for variant in ("window_overlap", "window_hard"):
        sae = TopKSAE(tcfg.SAEConfig(activation_dim=D, dict_size=M, k=K, variant=variant,
                                     use_pallas=True), device="cpu")
        with pytest.raises(ValueError, match=r"needs \[B,T,M\]"):
            sae.encode(torch.zeros(10, D))
    with pytest.raises(ValueError, match="unknown SAE variant"):
        TopKSAE(tcfg.SAEConfig(variant="bogus"), device="cpu")


def test_window_overlap_routing_through_the_wrappers(sae_params, monkeypatch):
    """Under use_pallas an even window goes through sae_encode_fused then
    window_vote_fused, and never through the per-timestep fused kernel.
    The wrappers are called from the autograd Functions beside them, so
    they are watched in ``sae_kernels``."""
    calls = []
    for name in ("sae_encode_fused", "window_vote_fused", "sae_encode_topk_fused"):
        fn = getattr(tk, name)
        monkeypatch.setattr(tk, name,
                            lambda *a, _fn=fn, _n=name, **kw: calls.append(_n) or _fn(*a, **kw))
    _, port = _sae_pair("window_overlap", 8, True, sae_params)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 17, D)).astype(np.float32))
    with torch.inference_mode():
        port.encode(x)
    assert calls == ["sae_encode_fused", "window_vote_fused"]


# -- the wrappers ------------------------------------------------------------


def test_new_wrappers_take_plain_path_on_cpu():
    x, w_enc = torch.randn(40, D), torch.randn(D, M)
    b_enc, b_dec = torch.randn(M), torch.randn(D)
    acts = torch.from_numpy(_relu_acts(8, (2, 17, M)))
    before = (tk.sae_encode_fused.launches, tk.topk_sparsify.launches,
              tk.window_vote_fused.launches)
    assert torch.equal(tk.sae_encode_fused(x, w_enc, b_enc, b_dec),
                       tk.sae_encode_fused_plain(x, w_enc, b_enc, b_dec))
    assert torch.equal(tk.topk_sparsify(acts, K),
                       tk.topk_threshold_mask_plain(acts.reshape(-1, M), K).reshape(acts.shape))
    assert torch.equal(tk.window_vote_fused(acts, K, 8), tk.window_vote_fused_plain(acts, K, 8))
    assert (tk.sae_encode_fused.launches, tk.topk_sparsify.launches,
            tk.window_vote_fused.launches) == before


def test_new_wrappers_never_fall_back_off_the_cpu():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tk.sae_encode_fused(torch.empty(8, D, **meta), torch.empty(D, M, **meta),
                            torch.empty(M, **meta), torch.empty(D, **meta))
    with pytest.raises(ValueError, match="no kernel"):
        tk.topk_sparsify(torch.empty(8, M, **meta), K)
    with pytest.raises(ValueError, match="no kernel"):
        tk.window_vote_fused(torch.empty(2, 16, M, **meta), K, 8)


# -- the window-overlap Detector, end to end ---------------------------------


def _window_cfgs(use_pallas):
    from sls_tpu.config import ModelConfig, SAEConfig, tiny_xlsr_config

    sae = dict(activation_dim=D, dict_size=M, k=K, variant="window_overlap", window_size=8,
               use_pallas=use_pallas)
    return (ModelConfig(encoder=tiny_xlsr_config(), sae=SAEConfig(**sae)),
            tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(), sae=tcfg.SAEConfig(**sae)))


@pytest.fixture(scope="module")
def wavs():
    return np.random.default_rng(0).normal(0, 0.1, (3, 4000)).astype(np.float32)


@pytest.fixture(scope="module")
def det_params(wavs):
    """Window-overlap JAX Detector params, perturbed so that no bias or
    norm is trivial."""
    import jax

    from sls_tpu.models.detector import Detector as JaxDetector

    jcfg, _ = _window_cfgs(False)
    p = JaxDetector(jcfg).init(jax.random.PRNGKey(0), jax.numpy.asarray(wavs))["params"]
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), p)


def test_sae_param_tree_is_the_same_for_every_variant(wavs):
    import jax

    from sls_tpu.models.detector import Detector as JaxDetector
    from sls_tpu_torch.convert import detector_state_from_flax
    from sls_tpu_torch.models.detector import Detector

    trees = {}
    for variant in ("per_timestep", "window_overlap", "window_hard"):
        jcfg, pcfg = _window_cfgs(False)
        jcfg = replace(jcfg, sae=replace(jcfg.sae, variant=variant))
        pcfg = replace(pcfg, sae=replace(pcfg.sae, variant=variant))
        shapes = jax.eval_shape(JaxDetector(jcfg).init, jax.random.PRNGKey(0),
                                jax.numpy.asarray(wavs))["params"]
        trees[variant] = jax.tree.map(lambda s: tuple(s.shape), shapes)
        state = detector_state_from_flax(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), shapes))
        Detector(pcfg, device="cpu").load_state_dict(state, strict=True)
    assert trees["window_overlap"] == trees["per_timestep"] == trees["window_hard"]


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "jnp"])
def test_window_detector_matches_jax(use_pallas, det_params, wavs, interpret_kernels, jnp):
    from sls_tpu.config import ExperimentConfig
    from sls_tpu.models.detector import Detector as JaxDetector
    from sls_tpu.train.steps import make_eval_step as jax_make_eval_step
    from sls_tpu_torch.convert import detector_state_from_flax
    from sls_tpu_torch.data.pipeline import to_wire
    from sls_tpu_torch.models.detector import Detector
    from sls_tpu_torch.train.steps import make_eval_step

    jcfg, pcfg = _window_cfgs(use_pallas)
    port = Detector(pcfg, device="cpu")
    port.load_state_dict(detector_state_from_flax(det_params), strict=True)
    jmodel = JaxDetector(jcfg)
    ref = jmodel.apply({"params": det_params}, jnp.asarray(wavs))
    with torch.inference_mode():
        out = port(torch.from_numpy(wavs))
    for key in ("log_probs", "score"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(out["sae_loss"]), float(ref["sae_loss"]), rtol=1e-4)
    # most frames' supports agree exactly; a flip needs a window sum or a
    # vote within the encoder's ~1e-6 noise of a selection threshold
    a, b = out["codes"].numpy() > 0, np.asarray(ref["codes"]) > 0
    assert (a == b).all(-1).mean() > 0.95
    with torch.inference_mode():
        assert torch.equal(port.score(torch.from_numpy(wavs)), out["log_probs"])

    w = to_wire(wavs, "int16")
    ref_step = jax_make_eval_step(jmodel, ExperimentConfig(model=jcfg))(det_params, jnp.asarray(w))
    got = make_eval_step(port, device="cpu")(w)
    for key in ("score", "log_probs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref_step[key]), atol=1e-4, rtol=0)
    for key in ("sae_loss", "sae_loss_per_example"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref_step[key]), rtol=1e-4)


def test_window_detector_served_equals_offline():
    from sls_tpu_torch.data.audio import pad_or_tile
    from sls_tpu_torch.data.pipeline import to_wire
    from sls_tpu_torch.models.detector import Detector
    from sls_tpu_torch.scores.writer import log_probs_to_scores
    from sls_tpu_torch.serve.engine import BatchingEngine
    from sls_tpu_torch.serve.scorer import build_scorer_from_params
    from sls_tpu_torch.train.steps import dequantize_wire

    cut = 4000
    _, pcfg = _window_cfgs(True)
    exp = tcfg.ExperimentConfig(model=pcfg, train=tcfg.TrainConfig(cut_length=cut))
    model = Detector(pcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    _, score_fn, _ = build_scorer_from_params(exp, model.state_dict(), batch_size=4,
                                              wire_dtype="int16", device="cpu",
                                              bucket_sizes=(2,))
    rng = np.random.default_rng(2)
    clips = [rng.normal(0, 0.1, 1000 + 400 * i).astype(np.float32) for i in range(5)]
    full = [pad_or_tile(c, cut) for c in clips]

    def offline(rows, shape):
        batch = rows + [rows[0]] * (shape - len(rows))
        with torch.inference_mode():
            lp = model.score(dequantize_wire(torch.from_numpy(to_wire(np.stack(batch),
                                                                      "int16"))))
        return log_probs_to_scores(lp)[: len(rows)]

    with BatchingEngine(score_fn, 4, cut=cut, wire_dtype="int16", bucket_sizes=(2,),
                        max_wait_ms=2000) as engine:
        single = engine.submit(clips[0]).result(timeout=60)  # the 2-row bucket
        got = np.array([f.result(timeout=60) for f in [engine.submit(c) for c in clips[1:]]])
    np.testing.assert_allclose(single, offline(full[:1], 2)[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, offline(full[1:], 4), rtol=0, atol=1e-6)
    # the vote is per utterance: pad rows do not move the real rows
    np.testing.assert_allclose(offline(full[1:2], 4), offline(full[1:2], 2), rtol=0, atol=1e-6)


# -- on a card: each new kernel against its plain version --------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 128, 512), (36 * 201, 1024, 4096)],
                         ids=["small", "flagship"])
def test_encode_fused_kernel_matches_plain(cuda, shape):
    n, d, m = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(n, d, device=cuda, generator=g)
    w_enc = torch.randn(d, m, device=cuda, generator=g) * d ** -0.5
    b_enc = torch.randn(m, device=cuda, generator=g) * 0.1
    b_dec = torch.randn(d, device=cuda, generator=g) * 0.1
    before = tk.sae_encode_fused.launches
    out = tk.sae_encode_fused(x, w_enc, b_enc, b_dec)
    torch.cuda.synchronize()
    assert tk.sae_encode_fused.launches == before + 1
    ref = tk.sae_encode_fused_plain(x, w_enc, b_enc, b_dec)
    # fp32 sums over d terms of size ~1 in another order
    assert torch.allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 512, 16), (36 * 201, 4096, 128)],
                         ids=["small", "flagship"])
def test_topk_sparsify_kernel_matches_plain(cuda, shape):
    n, m, k = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.relu(torch.randn(n, m, device=cuda, generator=g))
    before = tk.topk_sparsify.launches
    out = tk.topk_sparsify(x, k)
    torch.cuda.synchronize()
    assert tk.topk_sparsify.launches == before + 1
    assert torch.equal(out, tk.topk_threshold_mask_plain(x, k))


def _vote_acts_on(device, kind, shape, seed):
    """ReLU activations for the vote kernel's cases, drawn on ``device``."""
    b, t, m = shape
    g = torch.Generator(device=device).manual_seed(seed)
    acts = torch.relu(torch.randn(b, t, m, device=device, generator=g))
    if kind == "zero_utterance":
        acts[0] = 0.0
    elif kind == "ties":  # a few values, so the k-th of every row is tied
        pool = torch.tensor([0.0, 0.5, 1.0, 2.0], device=device)
        acts = pool[torch.randint(0, 4, (b, t, m), device=device, generator=g)]
    elif kind == "few_positive":  # windows with fewer than k positive sums
        acts[..., 3:] = 0.0
    elif kind == "with_inf":  # +inf votes NaN where no window covers it
        acts[:, ::7, ::53] = float("inf")
    return acts.contiguous()


# (B, T, M, k, window, kind): the first three cases, then T below the
# window, stripes splitting utterances (T 512), window 16, k = 1 and k = M,
# an all-zero utterance, ties at the k-th value, windows keeping fewer than
# k positive sums, +inf values (the kernel's dense walk of a chunk), and
# the streamed form (M above 4096 at window 2, M % 8 != 0, window 32 at M
# 4096, +inf values, short windows and ties at M 8192, 6000 and 6144,
# chunks covered on more columns than a list holds (k 3000 and k = M), the
# widest row whose chunk sums it carries (M 25664), and M 32768 and the
# widest row the wrapper takes, M 58112)
VOTE_KERNEL_CASES = {
    "small": (2, 17, 512, 16, 8, "relu"),
    "window4": (2, 12, 256, 16, 4, "relu"),
    "flagship": (36, 201, 4096, 128, 8, "relu"),
    "t_below_window": (2, 5, 512, 16, 8, "relu"),
    "t512": (3, 512, 4096, 128, 8, "relu"),
    "window16": (4, 201, 1024, 32, 16, "relu"),
    "k1": (3, 201, 512, 1, 8, "relu"),
    "k_m": (3, 33, 256, 256, 8, "relu"),
    "zero_utterance": (3, 201, 1024, 64, 8, "zero_utterance"),
    "ties": (3, 201, 512, 64, 8, "ties"),
    "few_positive": (3, 57, 512, 16, 8, "few_positive"),
    "with_inf": (3, 201, 1024, 64, 8, "with_inf"),
    "streamed_window2": (2, 33, 6144, 64, 2, "relu"),
    "streamed_m100": (3, 41, 100, 8, 8, "relu"),
    "streamed_window32": (2, 201, 4096, 128, 32, "relu"),
    "streamed_with_inf": (2, 201, 8192, 128, 8, "with_inf"),
    "streamed_few_positive": (3, 57, 6000, 16, 8, "few_positive"),
    "streamed_ties": (3, 201, 6144, 64, 8, "ties"),
    "streamed_long_lists": (2, 41, 8192, 3000, 8, "relu"),
    "streamed_k_m": (2, 17, 6144, 6144, 8, "relu"),
    "streamed_m25664": (1, 33, 25664, 128, 8, "relu"),
    "streamed_m32768": (1, 17, 32768, 128, 8, "relu"),
    "streamed_m_max": (1, 9, 58112, 64, 8, "relu"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(VOTE_KERNEL_CASES.values()), ids=list(VOTE_KERNEL_CASES))
def test_window_vote_kernel_matches_plain(cuda, shape):
    b, t, m, k, w, kind = shape
    acts = _vote_acts_on(cuda, kind, (b, t, m), 2)
    before = tk.window_vote_fused.launches
    out = tk.window_vote_fused(acts, k, w)
    torch.cuda.synchronize()
    assert tk.window_vote_fused.launches == before + 1
    ref = tk.window_vote_fused_plain(acts, k, w)
    # both sum the chunks in frame order and round as the TPU kernel does
    assert torch.equal(out > 0, ref > 0)
    assert torch.equal(out, ref)
