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

In a data-parallel step (``group``, the mesh's 'data' group, whose ranks
hold equal batches) the negatives span the global batch, as the
reference's single [M, M] over the concatenated rows does: the keys are
gathered over the group (``gather_over``, differentiable), each rank
forms its own anchors' rows of the logits with the targets offset by
its first global row, and its cross-entropy sum is divided by the
global M.  The ranks' results are shares that sum to the global loss.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from sls_tpu_torch.config import CPCConfig
from sls_tpu_torch.encoder.xlsr import Dense
from sls_tpu_torch.parallel.distributed import gather_over, group_size


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

    def forward(self, window_features: torch.Tensor, group=None) -> torch.Tensor:
        """window_features [B, N, in_dim] -> the InfoNCE loss, a scalar
        (with ``group``, this rank's share of the global one)."""
        cfg = self.config
        ranks = group_size(group) if group is not None else 1
        s = _unit(self.proj_fc2(torch.relu(self.proj_fc1(window_features))).float())
        N, H = s.shape[1], s.shape[2]
        losses = []
        for delta in cfg.prediction_steps:
            if N <= delta:
                continue
            q = _unit(self.pred_fc2(torch.relu(self.pred_fc1(s[:, :-delta]))).float())
            q, k = q.reshape(-1, H), s[:, delta:].reshape(-1, H)
            if ranks == 1:
                logits = (q @ k.t()) / cfg.temperature  # [M, M], M = B * (N - delta)
                losses.append(F.cross_entropy(logits, torch.arange(logits.shape[0],
                                                                   device=logits.device)))
                continue
            m_loc = q.shape[0]
            logits = (q @ gather_over(k, group).t()) / cfg.temperature  # [M_loc, M]
            first = dist.get_rank(group) * m_loc
            target = torch.arange(first, first + m_loc, device=logits.device)
            losses.append(F.cross_entropy(logits, target, reduction="sum") / (m_loc * ranks))
        if not losses:
            return torch.zeros((), dtype=torch.float32, device=s.device)
        return torch.stack(losses).sum() / len(losses)
