"""The port's direct weight loaders (``sls_tpu_torch/convert.py``) against
the JAX package's converters mapped through ``detector_state_from_flax``:
fairseq (three pos-conv forms, both extractor modes), HuggingFace, the
reference detector with ``module.`` prefixes, ``infer_sae_config_from_state``,
the export back to the reference naming, ``load_pretrained_encoder`` on
every file form, and the port encoder on loaded weights against the
torch reference forward.  Every loaded tensor equals the JAX route's bit
for bit (same key set, ``np.array_equal``); the pos-conv round trip
through weight norm is held to relative L2 1e-6.
"""

import argparse
import dataclasses
import pickle
from collections import OrderedDict

import numpy as np
import pytest
import torch

from sls_tpu.cli.main import load_pretrained_encoder as jax_load_pretrained_encoder
from sls_tpu.config import ModelConfig, SAEConfig, tiny_xlsr_config
from sls_tpu.encoder import convert as jconv
from sls_tpu.encoder.torch_ref import (
    make_detector_state,
    make_fairseq_state,
    torch_reference_forward,
)
from sls_tpu_torch import config as tcfg
from sls_tpu_torch import convert as pconv
from sls_tpu_torch.encoder.xlsr import XLSREncoder
from sls_tpu_torch.models.detector import Detector

D, M, K = 64, 256, 32
POS_CONV = "encoder.pos_conv.conv.weight"
POS_CONV_REL_L2 = 1e-6  # g * v / ||v|| with g = ||w||: fp32 rounding of the fold
FORWARD_ATOL = 1e-4  # fp32, as tests/test_torch_encoder.py holds the encoder


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers do not oversubscribe the
    cores (no result here depends on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(mode="layer_norm"):
    return tiny_xlsr_config(extractor_mode=mode), tcfg.tiny_xlsr_config(extractor_mode=mode)


def _fairseq_state(mode="layer_norm", pos_conv="weight_norm", seed=0):
    """A fairseq-named encoder state; in default mode conv 0 has a
    GroupNorm (``.2``); the pos-conv weight-normed (``weight_g`` /
    ``weight_v``), parametrized (``original0`` / ``original1``) or plain."""
    jcfg, _ = _cfgs(mode)
    s = make_fairseq_state(jcfg, seed=seed)
    if mode == "default":
        rng = np.random.default_rng(seed + 7)
        c0 = jcfg.conv_layers[0][0]
        s["feature_extractor.conv_layers.0.2.weight"] = (
            1 + 0.05 * rng.normal(size=c0)).astype(np.float32)
        s["feature_extractor.conv_layers.0.2.bias"] = (0.05 * rng.normal(size=c0)).astype(
            np.float32)
    base = "encoder.pos_conv.0"
    g, v = s.pop(f"{base}.weight_g"), s.pop(f"{base}.weight_v")
    if pos_conv == "weight_norm":
        s[f"{base}.weight_g"], s[f"{base}.weight_v"] = g, v
    elif pos_conv == "parametrizations":
        s[f"{base}.parametrizations.weight.original0"] = g
        s[f"{base}.parametrizations.weight.original1"] = v
    else:
        s[f"{base}.weight"] = jconv.fold_weight_norm(g, v)
    return s


_HF_CONV = {"0.weight": "conv.weight", "0.bias": "conv.bias",
            "2.1.weight": "layer_norm.weight", "2.1.bias": "layer_norm.bias",
            "2.weight": "layer_norm.weight", "2.bias": "layer_norm.bias"}


def _to_hf(s):
    """The HF ``Wav2Vec2Model`` naming of a fairseq state, ``wav2vec2.``
    prefixed."""
    out = {}
    for k, v in s.items():
        if k.startswith("feature_extractor.conv_layers."):
            i, tail = k[len("feature_extractor.conv_layers."):].split(".", 1)
            k = f"feature_extractor.conv_layers.{i}.{_HF_CONV[tail]}"
        elif k.startswith("layer_norm."):
            k = "feature_projection." + k
        elif k.startswith("post_extract_proj."):
            k = k.replace("post_extract_proj.", "feature_projection.projection.")
        elif k.startswith("encoder.pos_conv.0."):
            k = k.replace("encoder.pos_conv.0.", "encoder.pos_conv_embed.conv.")
        elif k.startswith("encoder.layers."):
            k = (k.replace(".self_attn_layer_norm.", ".layer_norm.")
                 .replace(".self_attn.", ".attention.")
                 .replace(".fc1.", ".feed_forward.intermediate_dense.")
                 .replace(".fc2.", ".feed_forward.output_dense."))
        out["wav2vec2." + k] = v
    return out


def _assert_same(port, ref):
    assert set(port) == set(ref), sorted(set(port) ^ set(ref))
    for k in ref:
        assert np.array_equal(port[k].numpy(), ref[k].numpy()), k
        assert port[k].dtype == ref[k].dtype, k


@pytest.mark.parametrize("pos_conv", ["weight_norm", "parametrizations", "plain"])
@pytest.mark.parametrize("mode", ["layer_norm", "default"])
def test_fairseq_encoder_matches_jax(mode, pos_conv):
    s = _fairseq_state(mode, pos_conv)
    jcfg, pcfg = _cfgs(mode)
    want = pconv.detector_state_from_flax(jconv.fairseq_encoder_to_flax(s, jcfg))
    _assert_same(pconv.fairseq_encoder_to_torch(s, pcfg), want)
    XLSREncoder(pcfg, device="cpu").load_state_dict(want, strict=True)


@pytest.mark.parametrize("pos_conv", ["weight_norm", "parametrizations", "plain"])
@pytest.mark.parametrize("mode", ["layer_norm", "default"])
def test_hf_encoder_matches_jax(mode, pos_conv):
    s = _to_hf(_fairseq_state(mode, pos_conv))
    assert any(k.startswith("wav2vec2.feature_projection.") for k in s)
    jcfg, pcfg = _cfgs(mode)
    want = pconv.detector_state_from_flax(jconv.hf_encoder_to_flax(s, jcfg))
    _assert_same(pconv.hf_encoder_to_torch(s, pcfg), want)
    # the same weights under either naming
    _assert_same(pconv.hf_encoder_to_torch(s, pcfg),
                 pconv.fairseq_encoder_to_torch(_fairseq_state(mode, pos_conv), pcfg))


def _detector_cfgs(use_sae=True):
    jm = ModelConfig(encoder=tiny_xlsr_config(), use_sae=use_sae,
                     sae=SAEConfig(activation_dim=D, dict_size=M, k=K))
    pm = tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(), use_sae=use_sae,
                          sae=tcfg.SAEConfig(activation_dim=D, dict_size=M, k=K))
    return jm, pm


def _detector_state(use_sae=True, seed=0):
    jm, _ = _detector_cfgs(use_sae)
    s = make_detector_state(jm.encoder, dict_size=M, k=K, seed=seed,
                            use_sparse_features=use_sae)
    if not use_sae:
        s = {k: v for k, v in s.items() if not k.startswith("sae.")}
    return s


@pytest.mark.parametrize("prefix", ["", "module.", "module.module."])
@pytest.mark.parametrize("use_sae", [True, False])
def test_detector_from_reference_matches_jax(prefix, use_sae):
    s = _detector_state(use_sae)
    jm, pm = _detector_cfgs(use_sae)
    want = pconv.detector_state_from_flax(jconv.detector_state_to_flax(s, jm))
    got = pconv.detector_state_from_reference({prefix + k: v for k, v in s.items()}, pm)
    _assert_same(got, want)
    Detector(pm, device="cpu").load_state_dict(got, strict=True)


def test_detector_from_torch_tensors_matches_numpy():
    s = _detector_state()
    _, pm = _detector_cfgs()
    want = pconv.detector_state_from_reference(s, pm)
    got = pconv.detector_state_from_reference({k: torch.from_numpy(v) for k, v in s.items()},
                                              pm)
    _assert_same(got, want)


def test_cpc_raises():
    """With use_cpc a checkpoint without the CPC head raises; with one, the
    head maps by the reference's names (as the JAX package maps it) and
    exports back."""
    jm, pm = _detector_cfgs()
    jm, pm = dataclasses.replace(jm, use_cpc=True), dataclasses.replace(pm, use_cpc=True)
    with pytest.raises(ValueError, match="no CPC head"):
        pconv.detector_state_from_reference(_detector_state(), pm)
    rng = np.random.default_rng(7)
    H, M = pm.cpc.hidden_dim, pm.sae.dict_size
    cpc = {f"cpc_{name}.{i}.{p}": rng.normal(size=shape).astype(np.float32)
           for name in ("proj", "pred") for i in (0, 2)
           for p, shape in (("weight", (H, M if (name, i) == ("proj", 0) else H)),
                            ("bias", (H,)))}
    s = {**_detector_state(), **cpc}
    got = pconv.detector_state_from_reference({"module." + k: v for k, v in s.items()}, pm)
    model = Detector(pm, device="meta")
    model.load_state_dict(got, strict=True, assign=True)
    want = pconv.detector_state_from_flax(jconv.detector_state_to_flax(s, jm))
    _assert_same({k: v for k, v in got.items() if k.startswith("cpc.")},
                 {k: v for k, v in want.items() if k.startswith("cpc.")})
    back = pconv.detector_state_to_reference(got, pm)
    assert all(np.array_equal(back[k].numpy(), v) for k, v in cpc.items())


@pytest.mark.parametrize("with_k", [True, False])
def test_infer_sae_config_matches_jax(with_k):
    s = {"module." + k: v for k, v in _detector_state().items()}
    if not with_k:
        s.pop("module.sae.k")
    want = jconv.infer_sae_config_from_state(s)
    got = pconv.infer_sae_config_from_state(s)
    assert (got.activation_dim, got.dict_size, got.k) == (
        want.activation_dim, want.dict_size, want.k) == (D, M, K if with_k else 128)


@pytest.mark.parametrize("mode", ["layer_norm", "default"])
def test_export_then_load_is_the_identity(mode):
    pm = tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(extractor_mode=mode),
                          sae=tcfg.SAEConfig(activation_dim=D, dict_size=M, k=K))
    gen = torch.Generator().manual_seed(3)
    state = Detector(pm, device="cpu", generator=gen).state_dict()
    ref = pconv.detector_state_to_reference(state, pm)
    assert "ssl_model.model.encoder.pos_conv.0.weight_g" in ref
    assert int(ref["sae.k"]) == K
    back = pconv.detector_state_from_reference({"module." + k: v for k, v in ref.items()}, pm)
    assert set(back) == set(state)
    for k, v in state.items():
        if k == POS_CONV:
            rel = float((back[k].double() - v.double()).norm() / v.double().norm())
            assert rel <= POS_CONV_REL_L2, rel
        else:
            assert torch.equal(back[k], v), k
    # the JAX package reads the export too, to the same weights
    jm = ModelConfig(encoder=tiny_xlsr_config(extractor_mode=mode),
                     sae=SAEConfig(activation_dim=D, dict_size=M, k=K))
    _assert_same(back, pconv.detector_state_from_flax(jconv.detector_state_to_flax(
        {k: v.numpy() for k, v in ref.items()}, jm)))


def _fairseq_checkpoint(state):
    """A dict shaped like a real fairseq wav2vec2 save: an
    ``argparse.Namespace`` in it, which ``weights_only=True`` refuses,
    and pretraining-only entries the loader skips."""
    model = OrderedDict((k, torch.from_numpy(np.asarray(v))) for k, v in state.items())
    model["quantizer.vars"] = torch.randn(1, 8, 4)
    model["mask_emb"] = torch.randn(D)
    args = argparse.Namespace(arch="wav2vec2", extractor_mode="layer_norm", encoder_layers=2)
    return {"args": args, "cfg": {"model": vars(args)}, "model": model,
            "optimizer_history": [{"num_updates": 1}]}


def _load_both(path, jcfg, pcfg):
    want = pconv.detector_state_from_flax(jax_load_pretrained_encoder(str(path), jcfg))
    return pconv.load_pretrained_encoder(path, pcfg), want


@pytest.fixture(scope="module")
def encoder_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("encoders")
    s = _fairseq_state()
    np.savez(d / "enc.npz", **s)
    ckpt = _fairseq_checkpoint(s)
    torch.save(ckpt, d / "xlsr.pt")
    asr = dict(ckpt, model=OrderedDict(("w2v_encoder.w2v_model." + k, v)
                                       for k, v in ckpt["model"].items()))
    torch.save(asr, d / "asr.pt")
    torch.save({k: torch.from_numpy(v) for k, v in _to_hf(s).items()}, d / "hf.pth")
    blob = (d / "xlsr.pt").read_bytes()
    (d / "truncated.pt").write_bytes(blob[: len(blob) // 2])
    return d, s


@pytest.mark.parametrize("name", ["enc.npz", "xlsr.pt", "asr.pt", "hf.pth"])
def test_load_pretrained_encoder_matches_jax(encoder_files, name):
    d, s = encoder_files
    jcfg, pcfg = _cfgs()
    got, want = _load_both(d / name, jcfg, pcfg)
    _assert_same(got, want)
    _assert_same(got, pconv.fairseq_encoder_to_torch(s, pcfg))


def test_namespace_payload_needs_the_full_unpickler(encoder_files):
    d, _ = encoder_files
    with pytest.raises(pickle.UnpicklingError):
        torch.load(d / "xlsr.pt", weights_only=True)


def test_truncated_file_keeps_its_own_error(encoder_files):
    d, _ = encoder_files
    jcfg, pcfg = _cfgs()
    with pytest.raises(Exception) as direct:
        torch.load(d / "truncated.pt", weights_only=True)
    assert not isinstance(direct.value, pickle.UnpicklingError)
    with pytest.raises(type(direct.value)):
        pconv.load_pretrained_encoder(d / "truncated.pt", pcfg)
    with pytest.raises(type(direct.value)):
        jax_load_pretrained_encoder(str(d / "truncated.pt"), jcfg)


@pytest.mark.parametrize("pos_conv", ["weight_norm", "plain"])
def test_encoder_on_loaded_weights_matches_reference_forward(encoder_files, pos_conv):
    d, _ = encoder_files
    s = _fairseq_state(pos_conv=pos_conv)
    jcfg, pcfg = _cfgs()
    enc = XLSREncoder(pcfg, device="cpu")
    enc.load_state_dict(pconv.fairseq_encoder_to_torch(s, pcfg), strict=True)
    wav = np.random.default_rng(5).normal(0, 0.1, size=(2, 1200)).astype(np.float32)
    with torch.no_grad():
        out = enc(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(out, torch_reference_forward(s, jcfg, wav),
                               atol=FORWARD_ATOL, rtol=0)
