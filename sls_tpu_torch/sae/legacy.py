"""Legacy tied-weight sparse autoencoder, counterpart of
``sls_tpu/sae/legacy.py`` (the reference's first SAE, kept for its
checkpoints and ablations; ``sae/topk.py`` is the live family).

Tied weights (one ``W`` [input_dim, hidden_dim]: encode x @ W, decode
codes @ W^T), pre-activations clamped to +-``clamp_value``, ReLU, TopK,
an L1 penalty on the codes.  ``W`` is a plain parameter in the same
layout as the reference's (no transpose between the packages).
Dead-neuron telemetry is a function over collected codes.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from sls_tpu_torch.analysis.sparsity import feature_activation_freq
from sls_tpu_torch.sae.sparsify import topk_per_row


class TiedSparseAutoencoder(nn.Module):
    def __init__(self, input_dim: int = 1024, hidden_dim: int = 2048, k: int = 256,
                 sparsity_coef: float = 1e-3, clamp_value: float = 10.0,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k, self.sparsity_coef, self.clamp_value, self.dtype = (
            k, sparsity_coef, clamp_value, dtype)
        # He-uniform over fan_in = input_dim, as flax's kaiming_uniform
        bound = math.sqrt(6.0 / input_dim)
        w = torch.empty(input_dim, hidden_dim, device=device)
        if w.device.type != "meta":
            w.uniform_(-bound, bound, generator=generator)
        self.W = nn.Parameter(w)
        self.b_enc = nn.Parameter(torch.zeros(hidden_dim, device=device))
        self.b_dec = nn.Parameter(torch.zeros(input_dim, device=device))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [..., input_dim] -> recon, codes, l1_loss, recon_loss, loss."""
        dt = self.dtype
        pre = (x - self.b_dec).to(dt) @ self.W.to(dt)
        pre = torch.clamp(pre.float() + self.b_enc, -self.clamp_value, self.clamp_value)
        codes = topk_per_row(torch.relu(pre), self.k)
        recon = (codes.to(dt) @ self.W.to(dt).t()).float() + self.b_dec
        l1 = torch.abs(codes).mean() * self.sparsity_coef
        recon_loss = torch.mean(torch.square(recon - x.float()))
        return {"recon": recon, "codes": codes, "l1_loss": l1, "recon_loss": recon_loss,
                "loss": recon_loss + l1}


def dead_neuron_stats(codes) -> Dict[str, float]:
    """Dead-neuron telemetry over collected codes [N..., hidden]: the
    share of features never active, the mean activation rate and the
    rows seen (the activity rule is ``analysis/sparsity.py``'s)."""
    freq = feature_activation_freq(codes)
    size = codes.numel() if torch.is_tensor(codes) else np.asarray(codes).size
    return {
        "dead_ratio": float((freq == 0).mean()),
        "mean_activation_rate": float(freq.mean()),
        "total_samples": int(size // freq.shape[-1]),
    }
