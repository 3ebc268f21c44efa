"""Contrastive-predictive-coding head over window-aggregated SAE codes,
counterpart of ``sls_tpu/sae/cpc.py``.

Two MLPs, ``proj_fc1 -> ReLU -> proj_fc2`` (from the codes' width to
``hidden_dim``) and ``pred_fc1 -> ReLU -> pred_fc2``, in fp32.  The
projected windows are L2-normalised (``+ 1e-12``); for each ``delta`` of
``prediction_steps`` the one predictor maps window i to a query for
window i + delta, and the InfoNCE loss is the cross entropy of
``q @ k.T / temperature`` over every (row, window) pair of the batch,
positives on the diagonal: the other rows of the batch are negatives.
A ``delta`` the sequence is too short for is skipped, and the loss is
the mean over the deltas that remain (0 when none does).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sls_tpu_torch.config import CPCConfig
from sls_tpu_torch.encoder.xlsr import Dense


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


class CPCHead(nn.Module):
    def __init__(self, config: CPCConfig, in_dim: int, device=None):
        super().__init__()
        self.config = config
        H = config.hidden_dim
        self.proj_fc1 = Dense(in_dim, H, torch.float32, device)
        self.proj_fc2 = Dense(H, H, torch.float32, device)
        self.pred_fc1 = Dense(H, H, torch.float32, device)
        self.pred_fc2 = Dense(H, H, torch.float32, device)

    def forward(self, window_features: torch.Tensor) -> torch.Tensor:
        """window_features [B, N, in_dim] -> the InfoNCE loss, a scalar."""
        cfg = self.config
        s = _unit(self.proj_fc2(torch.relu(self.proj_fc1(window_features))).float())
        N, H = s.shape[1], s.shape[2]
        losses = []
        for delta in cfg.prediction_steps:
            if N <= delta:
                continue
            q = _unit(self.pred_fc2(torch.relu(self.pred_fc1(s[:, :-delta]))).float())
            q, k = q.reshape(-1, H), s[:, delta:].reshape(-1, H)
            logits = (q @ k.t()) / cfg.temperature  # [M, M], M = B * (N - delta)
            losses.append(F.cross_entropy(logits, torch.arange(logits.shape[0],
                                                               device=logits.device)))
        if not losses:
            return torch.zeros((), dtype=torch.float32, device=s.device)
        return torch.stack(losses).sum() / len(losses)
