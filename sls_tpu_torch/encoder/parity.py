"""Checkpoint parity CLI, counterpart of ``sls_tpu/encoder/parity.py``:
holds the port's encoder on converted weights to an independent forward.

    python -m sls_tpu_torch.encoder.parity --checkpoint xlsr2_300m.pt
    python -m sls_tpu_torch.encoder.parity --checkpoint hf_state.pt --format hf

Loads an XLS-R checkpoint, converts it (``convert.py``), runs the port's
``XLSREncoder`` in fp32 and a reference forward on the same audio, and
reports the final output's max-abs divergence (the "golden activation
test", runnable as soon as real weights are on disk).  The references:
for fairseq-named files ``reference_forward`` below, a functional
fairseq-semantics forward written for this check alone (its own copy of
the reference's, ``sls_tpu/encoder/torch_ref.py``); for HF-named ones
HuggingFace's ``Wav2Vec2Model`` (``transformers``, imported only there:
``--format hf`` without it exits 1 saying so, with no other reference in
its place).

fp32 means fp32: TF32 is off in both matmul and cuDNN for the check (the
counterpart of the reference's ``jax_default_matmul_precision =
"highest"``), and restored after.  The rule is the reference's: ``PARITY
OK`` when max|Δ| < tolerance · max(mean|ref|, 1), else ``PARITY FAIL``
(exit 1).  Runs on the card, or on the CPU with ``SLS_TPU_PLATFORM=cpu``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sls_tpu_torch.config import XLSRConfig
from sls_tpu_torch.convert import (
    fairseq_encoder_to_torch,
    fold_weight_norm,
    hf_encoder_to_torch,
    strip_prefixes,
)
from sls_tpu_torch.encoder.xlsr import XLSREncoder


def reference_forward(s: Dict[str, np.ndarray], cfg: XLSRConfig, wav: np.ndarray,
                      device: torch.device = torch.device("cpu"), return_stages: bool = False):
    """The fairseq wav2vec2 inference forward (pre-LN, XLS-R mode) written
    out in torch functional ops on fairseq-named weights, in fp32 on
    ``device``; with ``return_stages`` also each stage's activations
    (numpy), to localise a divergence."""
    def T_(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    stages: Dict[str, np.ndarray] = {}
    with torch.no_grad():
        x = T_(wav)[:, None, :]
        for i, (dim, k, stride) in enumerate(cfg.conv_layers):
            base = f"feature_extractor.conv_layers.{i}"
            bias = T_(s[f"{base}.0.bias"]) if cfg.conv_bias else None
            x = F.conv1d(x, T_(s[f"{base}.0.weight"]), bias, stride=stride)
            if cfg.extractor_mode == "layer_norm":
                x = F.layer_norm(x.transpose(1, 2), (dim,), T_(s[f"{base}.2.1.weight"]),
                                 T_(s[f"{base}.2.1.bias"])).transpose(1, 2)
            x = F.gelu(x)
        x = x.transpose(1, 2)
        stages["conv_features"] = x.cpu().numpy()

        last = cfg.conv_layers[-1][0]
        x = F.layer_norm(x, (last,), T_(s["layer_norm.weight"]), T_(s["layer_norm.bias"]))
        x = F.linear(x, T_(s["post_extract_proj.weight"]), T_(s["post_extract_proj.bias"]))
        stages["projected"] = x.cpu().numpy()

        if "encoder.pos_conv.0.weight_g" in s:
            pw = fold_weight_norm(s["encoder.pos_conv.0.weight_g"],
                                  s["encoder.pos_conv.0.weight_v"])
        else:
            pw = s["encoder.pos_conv.0.weight"]
        pc = F.conv1d(x.transpose(1, 2), T_(pw), T_(s["encoder.pos_conv.0.bias"]),
                      padding=cfg.conv_pos // 2, groups=cfg.conv_pos_groups)
        if cfg.conv_pos % 2 == 0:
            pc = pc[:, :, :-1]
        x = x + F.gelu(pc).transpose(1, 2)
        stages["pos_embedded"] = x.cpu().numpy()

        C, H = cfg.embed_dim, cfg.num_heads
        Dh = C // H
        B, T, _ = x.shape
        for i in range(cfg.encoder_layers):
            p = f"encoder.layers.{i}."
            residual = x
            h = F.layer_norm(x, (C,), T_(s[p + "self_attn_layer_norm.weight"]),
                             T_(s[p + "self_attn_layer_norm.bias"]))
            q = F.linear(h, T_(s[p + "self_attn.q_proj.weight"]),
                         T_(s[p + "self_attn.q_proj.bias"])) * Dh ** -0.5
            k = F.linear(h, T_(s[p + "self_attn.k_proj.weight"]),
                         T_(s[p + "self_attn.k_proj.bias"]))
            v = F.linear(h, T_(s[p + "self_attn.v_proj.weight"]),
                         T_(s[p + "self_attn.v_proj.bias"]))
            q, k, v = (t.view(B, T, H, Dh) for t in (q, k, v))
            attn = torch.einsum("bthd,bshd->bhts", q, k).softmax(-1)
            ctx = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, T, C)
            x = residual + F.linear(ctx, T_(s[p + "self_attn.out_proj.weight"]),
                                    T_(s[p + "self_attn.out_proj.bias"]))
            residual = x
            h = F.layer_norm(x, (C,), T_(s[p + "final_layer_norm.weight"]),
                             T_(s[p + "final_layer_norm.bias"]))
            h = F.gelu(F.linear(h, T_(s[p + "fc1.weight"]), T_(s[p + "fc1.bias"])))
            x = residual + F.linear(h, T_(s[p + "fc2.weight"]), T_(s[p + "fc2.bias"]))
            stages[f"layer_{i}"] = x.cpu().numpy()

        x = F.layer_norm(x, (C,), T_(s["encoder.layer_norm.weight"]),
                         T_(s["encoder.layer_norm.bias"]))
        stages["final"] = x.cpu().numpy()
    if return_stages:
        return stages["final"], stages
    return stages["final"]


def _hf_forward(state: Dict[str, np.ndarray], cfg: XLSRConfig, wav: np.ndarray,
                device: torch.device) -> Optional[np.ndarray]:
    """HuggingFace ``Wav2Vec2Model`` with the reference's config on the
    HF-named ``state``; None when ``transformers`` does not import."""
    try:
        from transformers import Wav2Vec2Config, Wav2Vec2Model
    except ImportError as exc:
        print(f"--format hf holds the encoder to transformers' Wav2Vec2Model, and "
              f"transformers does not import here: {exc}", file=sys.stderr)
        return None
    hf_cfg = Wav2Vec2Config(
        hidden_size=cfg.embed_dim,
        num_hidden_layers=cfg.encoder_layers,
        num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.ffn_dim,
        conv_dim=[c for c, _, _ in cfg.conv_layers],
        conv_kernel=[k for _, k, _ in cfg.conv_layers],
        conv_stride=[s for _, _, s in cfg.conv_layers],
        conv_bias=cfg.conv_bias,
        num_conv_pos_embeddings=cfg.conv_pos,
        num_conv_pos_embedding_groups=cfg.conv_pos_groups,
        do_stable_layer_norm=True,
        feat_extract_norm="layer",
        apply_spec_augment=False,
    )
    hf_model = Wav2Vec2Model(hf_cfg).eval()
    hf_model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=False)
    hf_model.to(device)
    with torch.no_grad():
        return hf_model(torch.from_numpy(wav).to(device)).last_hidden_state.cpu().numpy()


def run_parity(checkpoint: str, fmt: str = "auto", wav_path: Optional[str] = None,
               tolerance: float = 1e-3, cfg: Optional[XLSRConfig] = None,
               device: Optional[torch.device] = None) -> bool:
    """Print the check's lines and return whether it holds (module
    docstring).  ``cfg`` defaults to the XLS-R 300M topology in fp32;
    ``device`` to the entry points' (``cli/main.py::platform_device``)."""
    if device is None:
        from sls_tpu_torch.cli.main import platform_device

        device = platform_device()
    raw = torch.load(checkpoint, map_location="cpu", weights_only=True)
    state = raw.get("model", raw) if isinstance(raw, dict) else raw
    state = {k: np.asarray(v) for k, v in state.items()}
    state = strip_prefixes(state, ("module.", "w2v_encoder.", "w2v_model.", "wav2vec2."))
    if fmt == "auto":
        fmt = "hf" if any("feature_projection." in k for k in state) else "fairseq"

    if cfg is None:
        cfg = XLSRConfig(dtype=torch.float32)  # fp32 for tight tolerances
    wav_len = 64600 if cfg.encoder_layers >= 24 else 1000
    if wav_path:
        from sls_tpu_torch.data.audio import load_audio, pad_or_tile

        wav = pad_or_tile(load_audio(wav_path))[None, :].astype(np.float32)
    else:
        wav = (np.random.default_rng(0).normal(size=(1, wav_len)) * 0.1).astype(np.float32)

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        if fmt == "hf":
            ref = _hf_forward(state, cfg, wav, device)
            if ref is None:
                return False
            stages = {"final": ref}
            weights = hf_encoder_to_torch(state, cfg)
        else:
            ref, stages = reference_forward(state, cfg, wav, device, return_stages=True)
            weights = fairseq_encoder_to_torch(state, cfg)
        encoder = XLSREncoder(cfg, device="meta")
        encoder.load_state_dict({k: v.to(device).contiguous() for k, v in weights.items()},
                                strict=True, assign=True)
        with torch.inference_mode():
            out = encoder(torch.from_numpy(wav).to(device)).float().cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    print(f"checkpoint: {checkpoint} (format: {fmt})")
    print(f"output shape: {out.shape}")
    final_diff = np.abs(out - ref).max()
    scale = np.abs(ref).mean()
    print(f"final max|Δ|: {final_diff:.3e} (ref mean |x|: {scale:.3e})")
    # the tolerance is relative to the reference's scale, with no other slack
    ok = final_diff < tolerance * max(scale, 1.0)
    for name, act in stages.items():
        if name == "final":
            continue
        print(f"  stage {name}: ref mean |x| = {np.abs(act).mean():.3e}")
    print("PARITY OK" if ok else "PARITY FAIL")
    return bool(ok)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="encoder weight parity check")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--format", default="auto", choices=["auto", "fairseq", "hf"])
    parser.add_argument("--wav", default=None, help="real audio file to use")
    parser.add_argument("--tolerance", type=float, default=1e-3)
    args = parser.parse_args(argv)
    return 0 if run_parity(args.checkpoint, args.format, args.wav, args.tolerance) else 1


if __name__ == "__main__":
    raise SystemExit(main())
