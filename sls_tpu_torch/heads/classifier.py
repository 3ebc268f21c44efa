"""Classification head, counterpart of ``sls_tpu/heads/classifier.py``.

``MeanPoolClassifier``: time-mean pooling, then LayerNorm (eps 1e-6, the
flax default; fast-variance form) -> Linear(d, 256) -> ReLU ->
Linear(256, 2), log-softmax outputs, all in fp32.  Class 1 = bonafide.
Dropout (rate ``dropout``, 0.3 by default) after the ReLU under
``train``, its mask from the caller's generator.  Under sequence
parallelism the features are this rank's frames, and the mean-pool is a
local sum, one all-reduce over the sequence axis and a division by the
global frame count.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sls_tpu_torch.encoder.xlsr import Dense, Fp32LayerNorm, dropout
from sls_tpu_torch.parallel.mesh import SeqShard


class MeanPoolClassifier(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int = 256, num_classes: int = 2,
                 dropout: float = 0.3, device=None):
        super().__init__()
        self.dropout = dropout
        self.norm = Fp32LayerNorm(in_dim, eps=1e-6, device=device)
        self.fc1 = Dense(in_dim, hidden_dim, torch.float32, device)
        self.fc2 = Dense(hidden_dim, num_classes, torch.float32, device)

    def forward(self, features: torch.Tensor, shard: Optional[SeqShard] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """features: [B, T, D] -> log-probabilities [B, num_classes].  With
        ``shard``, features are this rank's frames of ``shard.frames``.
        With ``generator`` (training) the dropout is applied."""
        if shard is None:
            pooled = features.float().mean(dim=1)
        else:
            pooled = shard.sum_frames(features.float().sum(dim=1)) / shard.frames
        h = dropout(torch.relu(self.fc1(self.norm(pooled))), self.dropout, generator)
        return torch.log_softmax(self.fc2(h), dim=-1)
