"""Loss functions, counterpart of ``sls_tpu/train/loss.py``.

``weighted_nll`` is ``torch.nn.NLLLoss(weight=w)`` on log-softmax
inputs with mean reduction, sum(w[y] * nll) / sum(w[y]), with an
optional ``valid`` mask in both sums.  The training default weights
(0.1, 0.9) put 0.9 on class 1 = bonafide, the minority class of the
2019 LA training set (the "WCE" of the README).

Under a data-parallel step (``group``, the mesh's 'data' group) each rank
returns its share of the global batch's loss: its own numerator over the
weight normaliser summed over every rank's valid rows (an all-reduce
that no gradient goes through, since the weights hold no parameter).
The shares sum to the reference's loss of the concatenated batch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from sls_tpu_torch.parallel.distributed import group_size


def _picked(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log_probs[i, labels[i]] in fp32."""
    return log_probs.float().gather(-1, labels.long()[:, None])[:, 0]


def weighted_nll(log_probs: torch.Tensor, labels: torch.Tensor,
                 class_weights: Sequence[float] = (0.1, 0.9),
                 valid: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """Weighted negative log-likelihood of log-probabilities [B, C] at
    integer labels [B]; ``valid`` [B] masks padding rows out of the
    numerator and the weight normaliser.  With ``group``, this rank's
    share of the group's global loss (module docstring)."""
    w = torch.as_tensor(class_weights, dtype=torch.float32, device=log_probs.device)
    sample_w = w[labels.long()]
    if valid is not None:
        sample_w = sample_w * valid.float()
    norm = sample_w.sum()
    if group is not None and group_size(group) > 1:
        norm = norm.detach().clone()
        dist.all_reduce(norm, group=group)
    return -(sample_w * _picked(log_probs, labels)).sum() / norm


def nll(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Unweighted mean negative log-likelihood."""
    return -_picked(log_probs, labels).mean()
