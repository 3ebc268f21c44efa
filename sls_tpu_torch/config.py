"""Typed configuration tree, mirroring ``sls_tpu/config.py``.

Same dataclasses, field names and defaults; ``dtype`` is a
``torch.dtype``.  ``config_to_json`` / ``config_from_dict`` read and
write the JSON that the JAX package's ``config_to_json`` writes (dtype
names ``"bfloat16"``, ``"float32"``), so one run directory's config
loads into both packages.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class XLSRConfig:
    """wav2vec2 / XLS-R encoder hyperparameters (XLS-R-300M defaults)."""

    # conv feature extractor: (channels, kernel, stride) per layer;
    # total stride 320 -> 64600 samples => 201 frames
    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 2, 2),
        (512, 2, 2),
    )
    extractor_mode: str = "layer_norm"  # "default" (group-norm 1st) | "layer_norm"
    conv_bias: bool = True

    encoder_layers: int = 24
    embed_dim: int = 1024
    ffn_dim: int = 4096
    num_heads: int = 16
    activation: str = "gelu"
    layer_norm_first: bool = True

    conv_pos: int = 128  # positional conv kernel
    conv_pos_groups: int = 16

    dropout: float = 0.0
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    layerdrop: float = 0.0

    # compute dtype for matmul-heavy ops; norms/softmax stay fp32
    dtype: Any = torch.bfloat16
    remat: bool = False
    # fused_attention and flash_long_t (0: off) pick the attention
    # kernel routes, fused_frontend the fused conv front-end off the card
    # too (on a card the eval front-end takes its kernel whatever it
    # says), and int8_serving / int8_scope the int8 serving matmuls
    # (encoder/xlsr.py, all eval-only); grouped_conv_einsum the pos-conv
    # as per-tap einsums, and seq_axis the mesh axis that shards the
    # layer stack's frames (parallel/sequence.py; the encoder then needs
    # the mesh)
    fused_attention: bool = False
    int8_serving: bool = False
    int8_scope: str = "ffn"
    flash_long_t: int = 2048
    grouped_conv_einsum: bool = False
    fused_frontend: bool = False
    # None = resolve by dtype: tanh-approximate iff dtype is bfloat16
    approx_gelu: Optional[bool] = None
    seq_axis: Optional[str] = None

    def __post_init__(self):
        if self.int8_scope not in ("ffn", "all"):
            raise ValueError(
                f"int8_scope must be 'ffn' or 'all', got {self.int8_scope!r}"
            )

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def use_approx_gelu(self) -> bool:
        if self.approx_gelu is None:
            return self.dtype == torch.bfloat16
        return self.approx_gelu

    def num_frames(self, num_samples: int) -> int:
        """Output frame count of the conv front-end for a waveform length."""
        t = num_samples
        for _, k, s in self.conv_layers:
            t = (t - k) // s + 1
        return t


@dataclass(frozen=True)
class WavLMConfig(XLSRConfig):
    """WavLM encoder hyperparameters (WavLM-Large: microsoft/wavlm-large,
    Chen et al., arXiv:2110.13900): XLS-R's layout plus a gated
    relative-position bias in every layer's attention, over
    ``num_buckets`` distance buckets (half a side; exact below a quarter
    of them, logarithmic up to ``max_distance``).  A subclass, so that
    ``XLSRConfig``'s fields stay the JAX package's.  The attention routes
    without a bias input refuse it: sequence parallelism (``seq_axis``,
    kernel row 7) and ``fused_attention`` (row 9)."""

    num_buckets: int = 320
    max_distance: int = 800

    def __post_init__(self):
        super().__post_init__()
        if self.fused_attention:
            raise ValueError("WavLM: the fused_attention route (kernel row 9) has no "
                             "relative-position bias; leave fused_attention off")
        if self.seq_axis:
            raise ValueError("WavLM: the sequence-parallel route (seq_axis, kernel row 7) has "
                             "no relative-position bias; leave seq_axis unset")


def tiny_xlsr_config(**overrides) -> XLSRConfig:
    """Small config for tests / CPU dry-runs (same topology, tiny dims)."""
    base = dict(
        conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)),
        extractor_mode="layer_norm",
        conv_bias=True,
        encoder_layers=2,
        embed_dim=64,
        ffn_dim=128,
        num_heads=4,
        conv_pos=16,
        conv_pos_groups=4,
        dtype=torch.float32,
    )
    base.update(overrides)
    return XLSRConfig(**base)


@dataclass(frozen=True)
class SAEConfig:
    """TopK sparse autoencoder configuration (variants as in sls_tpu)."""

    activation_dim: int = 1024
    dict_size: int = 4096
    k: int = 128
    variant: str = "per_timestep"
    window_size: int = 8
    use_pallas: bool = False  # hand-written kernels on a CUDA tensor
    bf16: bool = False  # bf16 enc/dec matmuls on the plain path


@dataclass(frozen=True)
class CPCConfig:
    hidden_dim: int = 256
    prediction_steps: Tuple[int, ...] = (1, 2, 4)
    temperature: float = 0.07


@dataclass(frozen=True)
class ModelConfig:
    """Full detector: encoder + (optional) SAE + classifier head."""

    encoder: XLSRConfig = field(default_factory=XLSRConfig)
    freeze_encoder: bool = False
    use_sae: bool = True
    use_sparse_features: bool = True  # classify on dict_size codes vs recon
    sae: SAEConfig = field(default_factory=SAEConfig)
    use_cpc: bool = False
    cpc: CPCConfig = field(default_factory=CPCConfig)
    classifier_hidden: int = 256
    classifier_dropout: float = 0.3
    num_classes: int = 2

    @property
    def classifier_input_dim(self) -> int:
        if self.use_sae and self.use_sparse_features:
            return self.sae.dict_size
        return self.encoder.embed_dim


@dataclass(frozen=True)
class RawBoostConfig:
    algo: int = 3
    nBands: int = 5
    minF: int = 20
    maxF: int = 8000
    minBW: int = 100
    maxBW: int = 1000
    minCoeff: int = 10
    maxCoeff: int = 100
    minG: int = 0
    maxG: int = 0
    minBiasLinNonLin: int = 5
    maxBiasLinNonLin: int = 20
    N_f: int = 5
    P: int = 10
    g_sd: int = 2
    SNRmin: int = 10
    SNRmax: int = 40


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 14
    num_epochs: int = 100
    lr: float = 1e-6
    weight_decay: float = 1e-4
    loss_weights: Tuple[float, float] = (0.1, 0.9)
    sae_weight: float = 0.1
    cpc_weight: float = 0.5
    seed: int = 1234
    cut_length: int = 64600
    model_parallel: int = 1
    rawboost: RawBoostConfig = field(default_factory=RawBoostConfig)


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    track: str = "LA"  # LA | DF | In-the-Wild
    comment: Optional[str] = None

    def model_tag(self) -> str:
        """Run-directory name encoding the experiment, the JAX package's
        string (the reference's tag scheme), so that a run of either
        package with the same flags lands in the same directory."""
        if not self.model.use_sae:
            tag = (f"sls_{self.track}_e{self.train.num_epochs}"
                   f"_bs{self.train.batch_size}_lr{self.train.lr}")
            if self.comment:
                tag += f"_{self.comment}"
            return tag
        variant = {"per_timestep": "pt", "window_overlap": "win",
                   "window_hard": "hardwin"}[self.model.sae.variant]
        tag = (f"topk_sae_{variant}_{self.track}_e{self.train.num_epochs}"
               f"_bs{self.train.batch_size}_lr{self.train.lr}"
               f"_saeW{self.train.sae_weight}_dict{self.model.sae.dict_size}"
               f"_k{self.model.sae.k}")
        if self.model.sae.variant != "per_timestep":
            tag += f"_w{self.model.sae.window_size}"
        if self.model.use_cpc:
            tag += f"_cpc{self.train.cpc_weight}"
        if self.comment:
            tag += f"_{self.comment}"
        return tag


_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
                torch.float16: "float16"}
_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}

_SUBCONFIGS = {
    "encoder": XLSRConfig,
    "sae": SAEConfig,
    "cpc": CPCConfig,
    "model": ModelConfig,
    "train": TrainConfig,
    "rawboost": RawBoostConfig,
}


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, torch.dtype):
        return _DTYPE_NAMES[obj]
    return obj


def config_to_json(cfg: Any) -> str:
    """Serialize any config dataclass to JSON."""
    return json.dumps(_to_jsonable(cfg), indent=2, default=str)


def config_from_dict(cls, d: Dict[str, Any]):
    """Rebuild a config dataclass from a JSON dict (inverse of
    config_to_json, and of the JAX package's).  An encoder dict with
    ``num_buckets`` is a ``WavLMConfig``."""
    if cls is XLSRConfig and "num_buckets" in d:
        cls = WavLMConfig
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name == "dtype":
            kwargs[f.name] = _DTYPES.get(v, torch.float32)
        elif f.name == "conv_layers":
            kwargs[f.name] = tuple(tuple(layer) for layer in v)
        elif f.name in ("prediction_steps", "loss_weights"):
            kwargs[f.name] = tuple(v)
        elif f.name in _SUBCONFIGS:
            kwargs[f.name] = config_from_dict(_SUBCONFIGS[f.name], v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)
