"""The XLS-R + SLS detector, plain, over the upstream checkpoint's naming
(``ssl_model.model.*``, ``fc0``, ``first_bn``, ``fc1``, ``fc3``), in
float32: QiShanZhang/SLSforASVspoof-2021-DF ``model.py``.

Each layer's output (fairseq's ``layer_results``) is mean-pooled over
time, ``fc0`` and a sigmoid give its gate; the gated layers are summed;
``BatchNorm2d(1)`` (the batch's statistics in training, with the biased
variance; the running ones at eval), SELU, a 3 x 3 max-pool, flatten,
``fc1``, SELU, ``fc3``, SELU, log_softmax.  This file imports nothing of
the program under test.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import xlsr
from perfbench.reference.numerics import Ops

BN_EPS = 1e-5


def log_probs(state: Mapping[str, torch.Tensor], cfg: Mapping, wav: torch.Tensor,
              ops: Ops = Ops(), train: bool = False, params: Optional[Mapping] = None
              ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """([B, 2] log-probabilities, the BatchNorm's (mean, biased variance)
    under ``train``, else None).  ``params``: the encoder's prepared
    tensors (``xlsr.encoder_params``), where the caller differentiates
    them."""
    enc = params if params is not None else xlsr.encoder_params(state)
    _, hidden = xlsr.encoder_forward(enc, cfg["encoder"], wav, ops)
    layers = torch.stack(hidden, dim=1)  # [B, L, T, C]
    pooled = layers.mean(dim=2)  # [B, L, C]
    gate = torch.sigmoid(ops.linear(pooled, state["fc0.weight"], state["fc0.bias"]))  # [B, L, 1]
    fused = (layers * gate[..., None]).sum(dim=1)[:, None]  # [B, 1, T, C]
    if train:
        mean, var = fused.mean(), fused.var(correction=0)
        stats = (mean.detach(), var.detach())
    else:
        mean, var, stats = state["first_bn.running_mean"], state["first_bn.running_var"], None
    x = (fused - mean) / torch.sqrt(var + BN_EPS) * state["first_bn.weight"] + state["first_bn.bias"]
    x = F.max_pool2d(F.selu(x), (3, 3)).flatten(1)
    x = F.selu(ops.linear(x, state["fc1.weight"], state["fc1.bias"]))
    x = F.selu(ops.linear(x, state["fc3.weight"], state["fc3.bias"]))
    return torch.log_softmax(x, dim=-1), stats
