"""Seeded weights in the reference checkpoints' naming, made on the device.

One ``torch.Generator`` on the device, seeded from the run's seed, draws
every entry in one normal draw, which is then cut into the named tensors
and scaled: weights at 1/sqrt(fan-in), biases at 0.02, LayerNorm scales
at 1 + 0.1 z, the SLS BatchNorm's running statistics at ``BN_STATS``
times 1 + 0.1 z.  The positional conv comes as its weight-norm pair, its
``weight_g`` the norm of ``weight_v`` times 1 + 0.1 z, so the fold is no
identity.  The SAE is tied as the published init ties it: unit-norm
decoder columns, the encoder their transpose.  All tensors are float32,
as the checkpoints hold them.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, List, Mapping, Tuple

import torch

from perfbench.reference.xlsr import FAIRSEQ

# (name, shape, kind): how ``make_state`` draws the tensor; each family
# lists its head's (``perfbench/families/<family>.py::head_specs``)
Spec = Tuple[str, Tuple[int, ...], str]

# the SLS head's BatchNorm holds running statistics near those of its
# input (the gated sum of the layers) on the synthetic audio at these
# weights, as a trained model's do: mean 2.0 and variance 285, measured
# once at full size; torch's fresh (0, 1) would saturate the head
BN_STATS = (2.0, 285.0)


def _encoder_specs(enc: Mapping) -> List[Spec]:
    s: List[Spec] = []
    cin = 1
    for i, (c, k) in enumerate(zip(enc["conv_dim"], enc["conv_kernel"])):
        base = f"{FAIRSEQ}feature_extractor.conv_layers.{i}"
        s += [(f"{base}.0.weight", (c, cin, k), "w"), (f"{base}.0.bias", (c,), "b"),
              (f"{base}.2.1.weight", (c,), "ln"), (f"{base}.2.1.bias", (c,), "b")]
        cin = c
    C, F = enc["hidden_size"], enc["intermediate_size"]
    K, G = enc["num_conv_pos_embeddings"], enc["num_conv_pos_embedding_groups"]
    s += [(f"{FAIRSEQ}layer_norm.weight", (cin,), "ln"), (f"{FAIRSEQ}layer_norm.bias", (cin,), "b"),
          (f"{FAIRSEQ}post_extract_proj.weight", (C, cin), "w"),
          (f"{FAIRSEQ}post_extract_proj.bias", (C,), "b"),
          (f"{FAIRSEQ}encoder.pos_conv.0.weight_v", (C, C // G, K), "w"),
          (f"{FAIRSEQ}encoder.pos_conv.0.weight_g", (1, 1, K), "g"),
          (f"{FAIRSEQ}encoder.pos_conv.0.bias", (C,), "b")]
    for i in range(enc["num_hidden_layers"]):
        base = f"{FAIRSEQ}encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s += [(f"{base}.self_attn.{proj}.weight", (C, C), "w"),
                  (f"{base}.self_attn.{proj}.bias", (C,), "b")]
        s += [(f"{base}.self_attn_layer_norm.weight", (C,), "ln"),
              (f"{base}.self_attn_layer_norm.bias", (C,), "b"),
              (f"{base}.fc1.weight", (F, C), "w"), (f"{base}.fc1.bias", (F,), "b"),
              (f"{base}.fc2.weight", (C, F), "w"), (f"{base}.fc2.bias", (C,), "b"),
              (f"{base}.final_layer_norm.weight", (C,), "ln"),
              (f"{base}.final_layer_norm.bias", (C,), "b")]
    s += [(f"{FAIRSEQ}encoder.layer_norm.weight", (C,), "ln"),
          (f"{FAIRSEQ}encoder.layer_norm.bias", (C,), "b")]
    return s


@torch.no_grad()
def make_state(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """The reference checkpoint's state dict of ``cfg``, drawn from
    ``seed`` on ``device``."""
    family = importlib.import_module(f"perfbench.families.{cfg['family']}")
    specs = _encoder_specs(cfg["encoder"]) + family.head_specs(cfg)
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    state: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind in specs:
        z = flat[at:at + math.prod(shape)].view(shape)
        at += z.numel()
        if kind == "w":
            z.mul_(math.prod(shape[1:]) ** -0.5)
        elif kind == "b":
            z.mul_(0.02)
        elif kind == "ln":
            z.mul_(0.1).add_(1.0)
        elif kind == "g":
            v = state[name.replace("weight_g", "weight_v")]
            z.mul_(0.1).add_(1.0).mul_(torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True))
        elif kind == "bn_mean":
            z.mul_(0.1).add_(1.0).mul_(BN_STATS[0])
        elif kind == "bn_var":
            z.mul_(0.1).add_(1.0).mul_(BN_STATS[1])
        elif kind == "unit_col":
            z.div_(torch.linalg.vector_norm(z, dim=0, keepdim=True))
        state[name] = z
    if "sae.decoder.weight" in state:
        state["sae.encoder.weight"] = state["sae.decoder.weight"].t().contiguous()
    return state
