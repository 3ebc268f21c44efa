"""The XLS-R + per-timestep TopK SAE detector, plain, over the reference
checkpoint's naming (``ssl_model.model.*``, ``sae.*``,
``classifier.{0,1,4}.*``), in float32: Nicholas42-hub/SLSforASVspoof-2021-DF
``model.py``'s per-timestep ``Model`` at eval.

encoder -> ``AutoEncoderTopK.encode`` on every frame (ReLU of
``encoder(x - b_dec)``, the k largest kept by ``topk`` and scattered, the
rest zero) -> mean over frames -> LayerNorm (torch's default eps 1e-5) ->
Linear -> ReLU -> Linear -> log_softmax.  Scoring needs no decode, so
none is computed.  This file imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from perfbench.reference import xlsr
from perfbench.reference.numerics import Ops

CLASSIFIER_LN_EPS = 1e-5


def sae_encode(p: Mapping[str, torch.Tensor], x: torch.Tensor, k: int, ops: Ops) -> torch.Tensor:
    acts = torch.relu(ops.linear(x - p["sae.b_dec"], p["sae.encoder.weight"], p["sae.encoder.bias"]))
    top = acts.topk(k, dim=-1, sorted=False)
    return torch.zeros_like(acts).scatter_(-1, top.indices, top.values)


def log_probs(state: Mapping[str, torch.Tensor], cfg: Mapping, wav: torch.Tensor,
              ops: Ops = Ops()) -> torch.Tensor:
    """[B, 2] log-probabilities (class 1 bonafide) of float audio [B, samples]."""
    p = {k: v.float() for k, v in state.items() if not k.startswith(xlsr.FAIRSEQ)}
    feats, _ = xlsr.encoder_forward(xlsr.encoder_params(state), cfg["encoder"], wav, ops)
    codes = sae_encode(p, feats, cfg["sae"]["k"], ops)
    pooled = codes.mean(dim=1)
    h = F.layer_norm(pooled, (pooled.shape[-1],), p["classifier.0.weight"],
                     p["classifier.0.bias"], CLASSIFIER_LN_EPS)
    h = torch.relu(ops.linear(h, p["classifier.1.weight"], p["classifier.1.bias"]))
    return torch.log_softmax(ops.linear(h, p["classifier.4.weight"], p["classifier.4.bias"]), -1)
