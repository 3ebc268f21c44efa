"""XLS-R (wav2vec 2.0) encoder, plain: the published equations over a
fairseq-named state dict, in float32.

The equations are fairseq's ``Wav2Vec2Model.extract_features`` with the
settings of facebook/wav2vec2-xls-r-300m (``feat_extract_norm:
"layer"``, ``do_stable_layer_norm: true``): each conv of the front-end
followed by a LayerNorm over channels and an exact GELU; LayerNorm,
``post_extract_proj``; the grouped positional conv, weight-normed over
dims 0 and 1 (``weight_g`` / ``weight_v``, folded here in float64), its
last frame dropped for an even kernel, an exact GELU, added; pre-LN
transformer layers; the final LayerNorm.  Every layer's output before
the final LayerNorm is the ``layer_results`` entry that the SLS head
reads.  No dropout: the configurations train with all rates at 0.

``enc`` is the configuration file's ``encoder`` group (the published
``config.json`` keys).  This file imports nothing of the program under
test.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.numerics import Ops

FAIRSEQ = "ssl_model.model."


def conv_specs(enc: Mapping) -> List[Tuple[int, int, int]]:
    """(channels, kernel, stride) of each front-end conv."""
    return list(zip(enc["conv_dim"], enc["conv_kernel"], enc["conv_stride"]))


def num_frames(enc: Mapping, samples: int) -> int:
    for _, k, s in conv_specs(enc):
        samples = (samples - k) // s + 1
    return samples


def fold_pos_conv(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """torch weight norm with ``dim=2``: g * v / ||v||, the norm over dims 0
    and 1 taken in float64."""
    v64 = v.double()
    norm = torch.sqrt((v64 * v64).sum(dim=(0, 1), keepdim=True))
    return (g.double() * v64 / norm).float()


def encoder_params(state: Mapping[str, torch.Tensor], prefix: str = FAIRSEQ
                   ) -> Dict[str, torch.Tensor]:
    """The encoder's float32 tensors under ``prefix``, the prefix dropped,
    with the positional conv's weight folded from its weight-norm pair
    (``encoder.pos_conv.0.weight``)."""
    p = {k[len(prefix):]: v.float() for k, v in state.items() if k.startswith(prefix)}
    base = "encoder.pos_conv.0."
    if base + "weight_g" in p:
        p[base + "weight"] = fold_pos_conv(p.pop(base + "weight_g"), p.pop(base + "weight_v"))
    return p


def _ln(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], eps)


def encoder_forward(p: Mapping[str, torch.Tensor], enc: Mapping, wav: torch.Tensor,
                    ops: Ops = Ops()) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(final output [B, T, C], each layer's output [B, T, C]) of float
    audio ``wav`` [B, samples]."""
    eps = enc["layer_norm_eps"]
    x = wav.float()[:, None, :]
    for i, (_, _, stride) in enumerate(conv_specs(enc)):
        base = f"feature_extractor.conv_layers.{i}"
        x = ops.conv1d(x, p[f"{base}.0.weight"], p.get(f"{base}.0.bias"), stride=stride)
        x = _ln(x.transpose(1, 2), p, f"{base}.2.1", eps).transpose(1, 2)
        x = F.gelu(x)
    x = _ln(x.transpose(1, 2), p, "layer_norm", eps)
    x = ops.linear(x, p["post_extract_proj.weight"], p["post_extract_proj.bias"])
    k = enc["num_conv_pos_embeddings"]
    pos = ops.conv1d(x.transpose(1, 2), p["encoder.pos_conv.0.weight"],
                     p["encoder.pos_conv.0.bias"], padding=k // 2,
                     groups=enc["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos).transpose(1, 2)
    heads = enc["num_attention_heads"]
    hidden = []
    for i in range(enc["num_hidden_layers"]):
        base = f"encoder.layers.{i}"
        x = x + _attention(p, f"{base}.self_attn", _ln(x, p, f"{base}.self_attn_layer_norm", eps),
                           heads, ops)
        h = _ln(x, p, f"{base}.final_layer_norm", eps)
        h = F.gelu(ops.linear(h, p[f"{base}.fc1.weight"], p[f"{base}.fc1.bias"]))
        x = x + ops.linear(h, p[f"{base}.fc2.weight"], p[f"{base}.fc2.bias"])
        hidden.append(x)
    return _ln(x, p, "encoder.layer_norm", eps), hidden


def _attention(p, base, x, heads, ops):
    B, T, C = x.shape
    d = C // heads

    def proj(name):
        return ops.linear(x, p[f"{base}.{name}.weight"], p[f"{base}.{name}.bias"])

    q = (proj("q_proj") * d ** -0.5).reshape(B, T, heads, d).transpose(1, 2)
    k = proj("k_proj").reshape(B, T, heads, d).transpose(1, 2)
    v = proj("v_proj").reshape(B, T, heads, d).transpose(1, 2)
    probs = torch.softmax(ops.matmul(q, k.transpose(-1, -2)), dim=-1)
    ctx = ops.matmul(probs, v).transpose(1, 2).reshape(B, T, C)
    return ops.linear(ctx, p[f"{base}.out_proj.weight"], p[f"{base}.out_proj.bias"])
