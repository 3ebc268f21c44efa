"""Weights bridges into and out of this package's state dicts.

From the JAX package: ``detector_state_from_flax(params)`` takes the
flax param tree as a nested dict of arrays (numpy, or anything
``np.asarray`` accepts) and returns a state dict that
``Detector.load_state_dict(strict=True)`` takes.  The naming follows the
flax scopes:

- ``layer_{i}`` -> ``layers.{i}``, ``conv_{i}`` -> ``conv.{i}``,
  ``norm_{i}`` -> ``norm.{i}``; the ``LayerNorm_0`` / ``GroupNorm_0``
  scope of ``Fp32LayerNorm`` and of the extractor's norms is dropped;
- ``scale`` -> ``weight``; a 2-D Dense ``kernel`` [in, out] -> ``weight``
  [out, in]; a 3-D conv ``kernel`` [K, in, out] -> ``weight``
  [out, in, K] (the grouped pos-conv's [K, C/G, C] -> [C, C/G, K]);
- the SAE's ``W_enc``, ``W_dec``, ``b_enc``, ``b_dec`` keep their names
  and layouts.

From PyTorch checkpoints, directly (no flax tree in between), with the
naming of ``sls_tpu/encoder/convert.py``:

- ``fairseq_encoder_to_torch``: a fairseq wav2vec2 state dict (either
  ``extractor_mode``; the pos-conv weight-normed as ``weight_g`` /
  ``weight_v`` or ``parametrizations.weight.original0/1``, folded in
  float64, or plain);
- ``hf_encoder_to_torch``: a HuggingFace ``Wav2Vec2Model`` state dict;
- ``detector_state_from_reference``: a reference detector checkpoint's
  ``model`` entry (``ssl_model.model.*``, ``sae.*``,
  ``classifier.{0,1,4}.*``, with ``use_cpc`` ``cpc_proj.{0,2}.*`` and
  ``cpc_pred.{0,2}.*``; optional ``module.`` prefixes);
- ``sls_detector_state_from_reference``: an upstream XLS-R + SLS
  checkpoint (``ssl_model.model.*`` and the head's ``fc0``,
  ``first_bn``, ``fc1``, ``fc3``; ``first_bn.num_batches_tracked``,
  which nothing here counts, is the one key dropped);
- ``load_pretrained_encoder``: a pretrained encoder file (``.npz``,
  fairseq or HF ``.pt`` / ``.pth``).

A ``WavLMConfig`` encoder also takes unilm's gated relative-position
tensors (fairseq naming): each layer's ``grep_linear`` and ``grep_a``
(stored ``[1, H, 1, 1]``), and layer 0's ``relative_attention_bias``.
Conv layers without a bias (WavLM-Large's ``conv_bias`` false) have none
in either naming.

Torch and fairseq layouts agree ([out, in] linears, [out, in/g, K]
convs), so every loaded tensor equals its source bit for bit, except the
folded pos-conv.  ``detector_state_to_reference`` and
``sls_detector_state_to_reference`` write the reference namings back (the
pos-conv as ``weight_g`` / ``weight_v``).  From the JAX package's SLS
model, ``sls_detector_state_from_flax(params, batch_stats)`` adds the
BatchNorm's running statistics (``batch_stats_from_flax``: ``mean`` /
``var`` -> ``running_mean`` / ``running_var``).

Tensors come back as views of the given arrays where those are
writable; ``load_state_dict`` copies them.
"""

from __future__ import annotations

import pickle
import re
from pathlib import Path
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from sls_tpu_torch.config import ModelConfig, SAEConfig, WavLMConfig, XLSRConfig

_INDEXED = re.compile(r"^(layer|conv|norm)_(\d+)$")
_NORM_SCOPES = ("LayerNorm_0", "GroupNorm_0")


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def torch_entry(path: Tuple[str, ...], ndim: int) -> Tuple[str, Tuple[int, ...]]:
    """(state-dict key, axis permutation) for one flax param path."""
    parts = []
    for p in path[:-1]:
        if p in _NORM_SCOPES:
            continue
        m = _INDEXED.match(p)
        if m:
            name, idx = m.groups()
            parts += ["layers" if name == "layer" else name, idx]
        else:
            parts.append(p)
    leaf = path[-1]
    perm = tuple(range(ndim))
    if leaf == "scale":
        leaf = "weight"
    elif leaf == "kernel":
        leaf = "weight"
        perm = tuple(reversed(range(ndim)))  # [in,out]->[out,in]; [K,in,out]->[out,in,K]
    return ".".join(parts + [leaf]), perm


def detector_state_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for ``sls_tpu_torch.models.detector.Detector`` from the
    JAX ``Detector``'s ``params`` (the tree under ``variables['params']``)."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        arr = np.asarray(value)
        if not arr.flags.writeable:  # torch tensors cannot share read-only memory
            arr = arr.copy()
        key, perm = torch_entry(path, arr.ndim)
        state[key] = torch.from_numpy(arr).permute(perm)
    return state


_RUNNING = {"mean": "running_mean", "var": "running_var"}


def batch_stats_from_flax(batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The running statistics of a flax ``batch_stats`` collection as
    state-dict buffers: ``.../first_bn/mean`` -> ``...first_bn.running_mean``
    (``var`` likewise)."""
    return {".".join(path[:-1] + (_RUNNING[path[-1]],)): _tensor(value)
            for path, value in _leaves(batch_stats)}


def sls_detector_state_from_flax(params: Mapping[str, Any],
                                 batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for ``models/sls.py::SLSDetector`` from the JAX
    ``SLSDetector``'s variables: ``params`` (BatchNorm ``scale`` / ``bias``
    -> ``weight`` / ``bias``) and ``batch_stats``."""
    return {**detector_state_from_flax(params), **batch_stats_from_flax(batch_stats)}


# -- PyTorch checkpoints ------------------------------------------------------------


def _tensor(value: Any) -> torch.Tensor:
    """A CPU tensor of a state-dict value (tensor or array)."""
    if torch.is_tensor(value):
        return value.detach().cpu()
    arr = np.asarray(value)
    if not arr.flags.writeable:  # torch tensors cannot share read-only memory
        arr = arr.copy()
    return torch.from_numpy(arr)


def _numpy(value: Any) -> np.ndarray:
    return value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)


def strip_prefixes(state: Mapping[str, Any], prefixes=("module.",)) -> Dict[str, Any]:
    """``state`` with wrapper prefixes removed from its keys, in the
    order given (each as often as it repeats); values as they are."""
    out = {}
    for key, value in state.items():
        for p in prefixes:
            while key.startswith(p):
                key = key[len(p):]
        out[key] = value
    return out


def fold_weight_norm(g: Any, v: Any, dim: int = 2) -> np.ndarray:
    """Fold torch weight-norm (the norm over every dim but ``dim``) into a
    plain weight: g * v / ||v||, the norm in float64, in ``v``'s dtype."""
    g, v = _numpy(g), _numpy(v)
    axes = tuple(i for i in range(v.ndim) if i != dim)
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
    return (g * v / norm).astype(v.dtype)


def _copy_linear(out: Dict, s: Mapping, src: str, dst: str) -> None:
    out[f"{dst}.weight"] = _tensor(s[f"{src}.weight"])
    if f"{src}.bias" in s:
        out[f"{dst}.bias"] = _tensor(s[f"{src}.bias"])


def _copy_norm(out: Dict, s: Mapping, src: str, dst: str) -> None:
    out[f"{dst}.weight"] = _tensor(s[f"{src}.weight"])
    out[f"{dst}.bias"] = _tensor(s[f"{src}.bias"])


def _pos_conv_weight(s: Mapping, base: str) -> torch.Tensor:
    """The pos-conv weight of ``base``: weight-normed (either form) and
    folded, or plain."""
    if f"{base}.weight_g" in s:
        return _tensor(fold_weight_norm(s[f"{base}.weight_g"], s[f"{base}.weight_v"]))
    if f"{base}.parametrizations.weight.original0" in s:
        return _tensor(fold_weight_norm(s[f"{base}.parametrizations.weight.original0"],
                                        s[f"{base}.parametrizations.weight.original1"]))
    return _tensor(s[f"{base}.weight"])


def _encoder_to_torch(s: Mapping, cfg: XLSRConfig, names: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """The encoder's state dict from fairseq- or HF-named ``s``; ``names``
    gives the source naming of each part."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(len(cfg.conv_layers)):
        base = f"feature_extractor.conv_layers.{i}"
        _copy_linear(out, s, f"{base}.{names['conv']}", f"feature_extractor.conv.{i}")
        if cfg.extractor_mode == "layer_norm" or i == 0:
            norm = names["conv_ln"] if cfg.extractor_mode == "layer_norm" else names["conv_gn"]
            _copy_norm(out, s, f"{base}.{norm}", f"feature_extractor.norm.{i}")
    _copy_norm(out, s, names["post_extract_norm"], "post_extract_norm")
    _copy_linear(out, s, names["post_extract_proj"], "post_extract_proj")
    out["pos_conv.conv.weight"] = _pos_conv_weight(s, names["pos_conv"])
    out["pos_conv.conv.bias"] = _tensor(s[f"{names['pos_conv']}.bias"])
    for i in range(cfg.encoder_layers):
        src, dst = f"encoder.layers.{i}", f"layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _copy_linear(out, s, f"{src}.{names['attn']}.{proj}", f"{dst}.self_attn.{proj}")
        _copy_norm(out, s, f"{src}.{names['attn_ln']}", f"{dst}.self_attn_layer_norm")
        _copy_linear(out, s, f"{src}.{names['fc1']}", f"{dst}.fc1")
        _copy_linear(out, s, f"{src}.{names['fc2']}", f"{dst}.fc2")
        _copy_norm(out, s, f"{src}.final_layer_norm", f"{dst}.final_layer_norm")
        if isinstance(cfg, WavLMConfig):
            attn = f"{src}.{names['attn']}"
            _copy_linear(out, s, f"{attn}.grep_linear", f"{dst}.self_attn.grep_linear")
            out[f"{dst}.self_attn.grep_a"] = _tensor(s[f"{attn}.grep_a"]).reshape(-1)
            if i == 0:
                out[f"{dst}.self_attn.relative_attention_bias.weight"] = _tensor(
                    s[f"{attn}.relative_attention_bias.weight"])
    _copy_norm(out, s, "encoder.layer_norm", "encoder_layer_norm")
    return out


_FAIRSEQ_NAMES = {"conv": "0", "conv_ln": "2.1", "conv_gn": "2",
                  "post_extract_norm": "layer_norm", "post_extract_proj": "post_extract_proj",
                  "pos_conv": "encoder.pos_conv.0", "attn": "self_attn",
                  "attn_ln": "self_attn_layer_norm", "fc1": "fc1", "fc2": "fc2"}
_HF_NAMES = {"conv": "conv", "conv_ln": "layer_norm", "conv_gn": "layer_norm",
             "post_extract_norm": "feature_projection.layer_norm",
             "post_extract_proj": "feature_projection.projection",
             "pos_conv": "encoder.pos_conv_embed.conv", "attn": "attention",
             "attn_ln": "layer_norm", "fc1": "feed_forward.intermediate_dense",
             "fc2": "feed_forward.output_dense"}


def fairseq_encoder_to_torch(state: Mapping[str, Any], cfg: XLSRConfig
                             ) -> Dict[str, torch.Tensor]:
    """The encoder's state dict from a fairseq ``Wav2Vec2Model`` state dict
    (``module.`` prefixes stripped; others first by the caller).
    Pretraining-only entries (quantizer, project_q, ...) are ignored."""
    return _encoder_to_torch(strip_prefixes(state), cfg, _FAIRSEQ_NAMES)


def hf_encoder_to_torch(state: Mapping[str, Any], cfg: XLSRConfig) -> Dict[str, torch.Tensor]:
    """The encoder's state dict from a HuggingFace ``Wav2Vec2Model`` state
    dict (the XLS-R layout: stable layer norm, layer-normed extractor;
    ``wav2vec2.`` prefixes stripped)."""
    return _encoder_to_torch(strip_prefixes(state, ("wav2vec2.",)), cfg, _HF_NAMES)


def sae_state_to_torch(state: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """The SAE's state dict from a reference ``AutoEncoderTopK`` state dict:
    encoder.weight [M, D], encoder.bias, decoder.weight [D, M], b_dec."""
    s = strip_prefixes(state)
    return {"W_enc": _tensor(s[f"{prefix}encoder.weight"]).T,
            "b_enc": _tensor(s[f"{prefix}encoder.bias"]),
            "W_dec": _tensor(s[f"{prefix}decoder.weight"]).T,
            "b_dec": _tensor(s[f"{prefix}b_dec"])}


def classifier_state_to_torch(state: Mapping[str, Any], prefix: str = "classifier."
                              ) -> Dict[str, torch.Tensor]:
    """The head's state dict from the reference classifier ``Sequential``:
    0 LayerNorm, 1 Linear(d, 256), 4 Linear(256, 2)."""
    s = strip_prefixes(state)
    out: Dict[str, torch.Tensor] = {}
    _copy_norm(out, s, f"{prefix}0", "norm")
    _copy_linear(out, s, f"{prefix}1", "fc1")
    _copy_linear(out, s, f"{prefix}4", "fc2")
    return out


def _prefixed(prefix: str, state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}{k}": v for k, v in state.items()}


def detector_state_from_reference(state: Mapping[str, Any], cfg: ModelConfig
                                  ) -> Dict[str, torch.Tensor]:
    """The ``Detector``'s state dict from a reference detector checkpoint's
    ``model`` entry: ``ssl_model.model.*`` (fairseq encoder), ``sae.*``
    and ``classifier.{0,1,4}.*``, with optional ``module.`` prefixes.
    With ``use_cpc`` the reference's CPC head (``cpc_proj.{0,2}``,
    ``cpc_pred.{0,2}``), which a checkpoint without one lacks: that
    raises ``ValueError``."""
    s = strip_prefixes(state)
    out = _prefixed("encoder.", _encoder_from_reference(s, cfg.encoder))
    if cfg.use_sae:
        out.update(_prefixed("sae.", sae_state_to_torch(s, prefix="sae.")))
    out.update(_prefixed("classifier.", classifier_state_to_torch(s)))
    if cfg.use_cpc:
        if "cpc_proj.0.weight" not in s:
            raise ValueError("use_cpc: the checkpoint has no CPC head (cpc_proj.*, cpc_pred.*)")
        for src, dst in _CPC_NAMES:
            _copy_linear(out, s, src, f"cpc.{dst}")
    return out


_CPC_NAMES = (("cpc_proj.0", "proj_fc1"), ("cpc_proj.2", "proj_fc2"),
              ("cpc_pred.0", "pred_fc1"), ("cpc_pred.2", "pred_fc2"))


def _encoder_from_reference(s: Mapping[str, Any], cfg: XLSRConfig) -> Dict[str, torch.Tensor]:
    """The encoder's state dict from the ``ssl_model.model.*`` entries of an
    unprefixed reference checkpoint."""
    enc = {k[len("ssl_model.model."):]: v for k, v in s.items()
           if k.startswith("ssl_model.model.")}
    return fairseq_encoder_to_torch(enc, cfg)


def detector_state_to_reference(state: Mapping[str, torch.Tensor], cfg: ModelConfig
                                ) -> Dict[str, torch.Tensor]:
    """The reference naming of a ``Detector`` state dict (the inverse of
    ``detector_state_from_reference``), which the reference's PyTorch
    model takes: the pos-conv weight w as ``weight_g`` = ||w|| over dims
    0 and 1 (float64, cast back) and ``weight_v`` = w, and ``sae.k``."""
    s = {k: _tensor(v) for k, v in state.items()}
    out = _encoder_to_reference(s, cfg.encoder)
    if cfg.use_sae:
        out["sae.encoder.weight"] = s["sae.W_enc"].T
        out["sae.encoder.bias"] = s["sae.b_enc"]
        out["sae.decoder.weight"] = s["sae.W_dec"].T
        out["sae.b_dec"] = s["sae.b_dec"]
        out["sae.k"] = torch.tensor(cfg.sae.k, dtype=torch.int64)
    _copy_norm(out, s, "classifier.norm", "classifier.0")
    _copy_linear(out, s, "classifier.fc1", "classifier.1")
    _copy_linear(out, s, "classifier.fc2", "classifier.4")
    if cfg.use_cpc:
        for dst, src in _CPC_NAMES:
            _copy_linear(out, s, f"cpc.{src}", dst)
    return out


def _encoder_to_reference(s: Mapping[str, torch.Tensor], enc_cfg: XLSRConfig
                          ) -> Dict[str, torch.Tensor]:
    """The ``ssl_model.model.*`` entries of the encoder's ``encoder.*``
    state (the inverse of ``_encoder_from_reference``)."""
    out: Dict[str, torch.Tensor] = {}
    fs = "ssl_model.model."
    for i in range(len(enc_cfg.conv_layers)):
        base = f"{fs}feature_extractor.conv_layers.{i}"
        _copy_linear(out, s, f"encoder.feature_extractor.conv.{i}", f"{base}.0")
        if enc_cfg.extractor_mode == "layer_norm" or i == 0:
            norm = "2.1" if enc_cfg.extractor_mode == "layer_norm" else "2"
            _copy_norm(out, s, f"encoder.feature_extractor.norm.{i}", f"{base}.{norm}")
    _copy_norm(out, s, "encoder.post_extract_norm", f"{fs}layer_norm")
    _copy_linear(out, s, "encoder.post_extract_proj", f"{fs}post_extract_proj")
    w = s["encoder.pos_conv.conv.weight"]
    w64 = w.double()
    out[f"{fs}encoder.pos_conv.0.weight_g"] = torch.sqrt(
        (w64 * w64).sum(dim=(0, 1), keepdim=True)).to(w.dtype)
    out[f"{fs}encoder.pos_conv.0.weight_v"] = w
    out[f"{fs}encoder.pos_conv.0.bias"] = s["encoder.pos_conv.conv.bias"]
    for i in range(enc_cfg.encoder_layers):
        src, dst = f"encoder.layers.{i}", f"{fs}encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _copy_linear(out, s, f"{src}.self_attn.{proj}", f"{dst}.self_attn.{proj}")
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            _copy_norm(out, s, f"{src}.{name}", f"{dst}.{name}")
        for name in ("fc1", "fc2"):
            _copy_linear(out, s, f"{src}.{name}", f"{dst}.{name}")
        if isinstance(enc_cfg, WavLMConfig):
            _copy_linear(out, s, f"{src}.self_attn.grep_linear", f"{dst}.self_attn.grep_linear")
            out[f"{dst}.self_attn.grep_a"] = s[f"{src}.self_attn.grep_a"].reshape(1, -1, 1, 1)
            if i == 0:
                name = "self_attn.relative_attention_bias.weight"
                out[f"{dst}.{name}"] = s[f"{src}.{name}"]
    _copy_norm(out, s, "encoder.encoder_layer_norm", f"{fs}encoder.layer_norm")
    return out


_SLS_LINEARS = ("fc0", "fc1", "fc3")
_SLS_BN = ("weight", "bias", "running_mean", "running_var")
_SLS_IGNORED = ("first_bn.num_batches_tracked",)


def sls_head_state_from_reference(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The SLS head's state dict from the upstream head's entries (``fc0``,
    ``first_bn``, ``fc1``, ``fc3``; ``module.`` prefixes stripped).  Any
    other entry raises ``ValueError``, except
    ``first_bn.num_batches_tracked``, which is dropped."""
    s = strip_prefixes(state)
    out: Dict[str, torch.Tensor] = {}
    for name in _SLS_LINEARS:
        _copy_linear(out, s, name, name)
    for name in _SLS_BN:
        out[f"first_bn.{name}"] = _tensor(s[f"first_bn.{name}"])
    extra = sorted(set(s) - set(out) - set(_SLS_IGNORED))
    if extra:
        raise ValueError(f"unknown entries in the SLS head's state: {extra[:4]}")
    return out


def sls_detector_state_from_reference(state: Mapping[str, Any], cfg: ModelConfig
                                      ) -> Dict[str, torch.Tensor]:
    """The ``SLSDetector``'s state dict from an upstream XLS-R + SLS
    checkpoint (``model`` entry or bare state dict): the fairseq encoder
    under ``ssl_model.model.*`` and the head (``sls_head_state_from_reference``),
    with optional ``module.`` prefixes.  Other ``ssl_model.*`` entries
    (fairseq's pretraining parts) are ignored, as the encoder loader
    ignores them."""
    s = strip_prefixes(state)
    head = {k: v for k, v in s.items() if not k.startswith("ssl_model.")}
    return {**_prefixed("encoder.", _encoder_from_reference(s, cfg.encoder)),
            **_prefixed("sls_head.", sls_head_state_from_reference(head))}


def sls_detector_state_to_reference(state: Mapping[str, torch.Tensor], cfg: ModelConfig,
                                    num_batches_tracked: int = 0) -> Dict[str, torch.Tensor]:
    """The upstream naming of an ``SLSDetector`` state dict (the inverse of
    ``sls_detector_state_from_reference``), with
    ``first_bn.num_batches_tracked`` set to ``num_batches_tracked``."""
    s = {k: _tensor(v) for k, v in state.items()}
    out = _encoder_to_reference(s, cfg.encoder)
    for name in _SLS_LINEARS:
        _copy_linear(out, s, f"sls_head.{name}", name)
    for name in _SLS_BN:
        out[f"first_bn.{name}"] = s[f"sls_head.first_bn.{name}"]
    out["first_bn.num_batches_tracked"] = torch.tensor(num_batches_tracked, dtype=torch.int64)
    return out


def infer_sae_config_from_state(state: Mapping[str, Any], prefix: str = "sae.") -> SAEConfig:
    """dict_size, activation_dim and k from a reference checkpoint's
    weight shapes (k 128 when it holds none)."""
    s = strip_prefixes(state)
    dict_size, activation_dim = tuple(s[f"{prefix}encoder.weight"].shape)
    k = int(np.asarray(_numpy(s[f"{prefix}k"])) if f"{prefix}k" in s else 128)
    return SAEConfig(activation_dim=activation_dim, dict_size=dict_size, k=k)


def load_pretrained_encoder(cp_path, encoder_cfg: XLSRConfig) -> Dict[str, torch.Tensor]:
    """The encoder's state dict from a pretrained XLS-R file: an ``.npz``
    archive, or a ``torch.save`` of a fairseq checkpoint (``{"model":
    state, ...}``) or of a bare fairseq or HF state dict.  HF is told by
    its ``feature_projection.`` names; ``module.``, ``w2v_encoder.``,
    ``w2v_model.`` and ``wav2vec2.`` prefixes are stripped.

    Files load with ``weights_only=True``.  Real fairseq checkpoints
    (``xlsr2_300m.pt``) carry an argparse / omegaconf payload that this
    unpickler refuses, and only that refusal (``UnpicklingError``) falls
    back to the full unpickler; a truncated or corrupt file keeps its own
    error and never reaches it."""
    path = Path(cp_path)
    if path.suffix == ".npz":
        with np.load(path, allow_pickle=False) as z:
            state: Dict[str, Any] = {k: z[k] for k in z.files}
    else:
        try:
            raw = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError:
            raw = torch.load(path, map_location="cpu", weights_only=False)
        state = raw.get("model", raw) if isinstance(raw, dict) else raw
        state = {k: v for k, v in state.items() if torch.is_tensor(v)}
    state = strip_prefixes(state, ("module.", "w2v_encoder.", "w2v_model.", "wav2vec2."))
    if any("feature_projection." in k for k in state):
        return hf_encoder_to_torch(state, encoder_cfg)
    return fairseq_encoder_to_torch(state, encoder_cfg)
