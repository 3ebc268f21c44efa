"""The WavLM + per-timestep TopK SAE detector, plain, over the reference
checkpoint's naming (``ssl_model.model.*`` in unilm's WavLM naming,
``sae.*``, ``classifier.{0,1,4}.*``), in float32.

The encoder is unilm's ``wavlm/WavLM.py`` and ``wavlm/modules.py`` at eval
with microsoft/wavlm-large's settings (Chen et al., arXiv:2110.13900):
XLS-R's front-end, projection, positional conv and pre-LN layers
(``reference/xlsr.py``'s helpers), with a gated relative-position bias in
every layer's attention.  For layer l, batch row b, head h and frames i,
j, with x the attention's input (after its LayerNorm) cut into heads:

- ``bucket(j - i)``: ``MultiheadAttention._relative_positions_bucket``,
  bidirectional, written out below;
- ``pos[h, i, j] = E[bucket(j - i), h]`` with E layer 0's
  ``relative_attention_bias``, shared by every layer;
- ``(a, b) = sigmoid(grep_linear_l(x[b, h, i]) summed in two groups of
  4)``, ``g = a (b grep_a_l[h] - 1) + 2``;
- ``scores = q k^T / sqrt(64) + g[b, h, i] pos[h, i, j]``, then softmax
  and V.

Conv layers take no bias where the configuration's ``conv_bias`` is false
(WavLM-Large's), whatever the state holds.  The head is
``reference/topk_sae.py``'s.  No departure from the published equations.
This file imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import List, Mapping, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import xlsr
from perfbench.reference.numerics import Ops
from perfbench.reference.topk_sae import CLASSIFIER_LN_EPS, sae_encode


def relative_positions_bucket(relative_positions: torch.Tensor, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """unilm's ``_relative_positions_bucket(..., bidirectional=True)``."""
    num_buckets = num_buckets // 2
    relative_buckets = (relative_positions > 0).to(torch.long) * num_buckets
    relative_positions = torch.abs(relative_positions)
    max_exact = num_buckets // 2
    is_small = relative_positions < max_exact
    relative_position_if_large = max_exact + (
        torch.log(relative_positions.float() / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.long)
    relative_position_if_large = torch.min(
        relative_position_if_large, torch.full_like(relative_position_if_large, num_buckets - 1))
    return relative_buckets + torch.where(is_small, relative_positions, relative_position_if_large)


def position_bias(p: Mapping[str, torch.Tensor], enc: Mapping, t: int) -> torch.Tensor:
    """unilm's ``compute_bias``: [H, t, t] from layer 0's table."""
    context = torch.arange(t, dtype=torch.long)[:, None]
    memory = torch.arange(t, dtype=torch.long)[None, :]
    bucket = relative_positions_bucket(memory - context, enc["num_buckets"],
                                       enc["max_bucket_distance"])
    table = p["encoder.layers.0.self_attn.relative_attention_bias.weight"]
    return F.embedding(bucket.to(table.device), table).permute(2, 0, 1)


def encoder_forward(p: Mapping[str, torch.Tensor], enc: Mapping, wav: torch.Tensor,
                    ops: Ops = Ops()) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(final output [B, T, C], each layer's output [B, T, C]) of float
    audio ``wav`` [B, samples]."""
    eps = enc["layer_norm_eps"]
    x = wav.float()[:, None, :]
    for i, (_, _, stride) in enumerate(xlsr.conv_specs(enc)):
        base = f"feature_extractor.conv_layers.{i}"
        bias = p.get(f"{base}.0.bias") if enc["conv_bias"] else None
        x = ops.conv1d(x, p[f"{base}.0.weight"], bias, stride=stride)
        x = F.gelu(xlsr._ln(x.transpose(1, 2), p, f"{base}.2.1", eps).transpose(1, 2))
    x = xlsr._ln(x.transpose(1, 2), p, "layer_norm", eps)
    x = ops.linear(x, p["post_extract_proj.weight"], p["post_extract_proj.bias"])
    k = enc["num_conv_pos_embeddings"]
    pos = ops.conv1d(x.transpose(1, 2), p["encoder.pos_conv.0.weight"],
                     p["encoder.pos_conv.0.bias"], padding=k // 2,
                     groups=enc["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos).transpose(1, 2)
    bias = position_bias(p, enc, x.shape[1])
    hidden = []
    for i in range(enc["num_hidden_layers"]):
        base = f"encoder.layers.{i}"
        h = xlsr._ln(x, p, f"{base}.self_attn_layer_norm", eps)
        x = x + _attention(p, f"{base}.self_attn", h, enc["num_attention_heads"], bias, ops)
        h = xlsr._ln(x, p, f"{base}.final_layer_norm", eps)
        h = F.gelu(ops.linear(h, p[f"{base}.fc1.weight"], p[f"{base}.fc1.bias"]))
        x = x + ops.linear(h, p[f"{base}.fc2.weight"], p[f"{base}.fc2.bias"])
        hidden.append(x)
    return xlsr._ln(x, p, "encoder.layer_norm", eps), hidden


def _attention(p, base, x, heads, position, ops):
    B, T, C = x.shape
    d = C // heads

    def proj(name):
        return ops.linear(x, p[f"{base}.{name}.weight"], p[f"{base}.{name}.bias"])

    q = (proj("q_proj") * d ** -0.5).reshape(B, T, heads, d).transpose(1, 2)
    k = proj("k_proj").reshape(B, T, heads, d).transpose(1, 2)
    v = proj("v_proj").reshape(B, T, heads, d).transpose(1, 2)
    # the gate, from the attention's input cut into heads [B, H, T, d]
    query = x.reshape(B, T, heads, d).transpose(1, 2)
    gates = ops.linear(query, p[f"{base}.grep_linear.weight"], p[f"{base}.grep_linear.bias"])
    gate_a, gate_b = torch.sigmoid(gates.view(B, heads, T, 2, 4).sum(-1)).chunk(2, dim=-1)
    gate = gate_a * (gate_b * p[f"{base}.grep_a"] - 1.0) + 2.0  # [B, H, T, 1]
    scores = ops.matmul(q, k.transpose(-1, -2)) + gate * position
    probs = torch.softmax(scores, dim=-1)
    ctx = ops.matmul(probs, v).transpose(1, 2).reshape(B, T, C)
    return ops.linear(ctx, p[f"{base}.out_proj.weight"], p[f"{base}.out_proj.bias"])


def log_probs(state: Mapping[str, torch.Tensor], cfg: Mapping, wav: torch.Tensor,
              ops: Ops = Ops()) -> torch.Tensor:
    """[B, 2] log-probabilities (class 1 bonafide) of float audio [B, samples]."""
    p = {k: v.float() for k, v in state.items() if not k.startswith(xlsr.FAIRSEQ)}
    feats, _ = encoder_forward(xlsr.encoder_params(state), cfg["encoder"], wav, ops)
    codes = sae_encode(p, feats, cfg["sae"]["k"], ops)
    pooled = codes.mean(dim=1)
    h = F.layer_norm(pooled, (pooled.shape[-1],), p["classifier.0.weight"],
                     p["classifier.0.bias"], CLASSIFIER_LN_EPS)
    h = torch.relu(ops.linear(h, p["classifier.1.weight"], p["classifier.1.bias"]))
    return torch.log_softmax(ops.linear(h, p["classifier.4.weight"], p["classifier.4.bias"]), -1)
