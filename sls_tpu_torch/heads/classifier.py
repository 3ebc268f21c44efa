"""Classification head, counterpart of ``sls_tpu/heads/classifier.py``.

``MeanPoolClassifier``: time-mean pooling, then LayerNorm (eps 1e-6, the
flax default; fast-variance form) -> Linear(d, 256) -> ReLU ->
Linear(256, 2), log-softmax outputs, all in fp32.  Class 1 = bonafide.
Dropout (rate ``dropout``, 0.3 by default) after the ReLU under
``train``, its mask from the caller's generator.  Under sequence
parallelism the features are this rank's frames, and the mean-pool is a
local sum, one all-reduce over the sequence axis (under grad mode one
whose backward sums the seq ranks' gradients, ``SeqShard.sum_frames``)
and a division by the global frame count.  Under tensor parallelism (``tp`` set,
``parallel/tensor.py``) ``fc1`` is cut by output and ``fc2`` by input
over the mesh's 'model' axis, the dropout mask drawn at the whole width
and cut.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sls_tpu_torch.encoder.xlsr import Dense, Fp32LayerNorm, dropout
from sls_tpu_torch.parallel.mesh import SeqShard
from sls_tpu_torch.parallel.tensor import column_linear, cut_dropout, row_linear


class MeanPoolClassifier(nn.Module):
    tp = None  # a parallel/tensor.py ModelShard when fc1 / fc2 are cut

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
        if self.tp is not None:
            h = torch.relu(column_linear(self.fc1, self.norm(pooled), self.tp))
            h = cut_dropout(h, self.dropout, generator, self.tp)
            return torch.log_softmax(row_linear(self.fc2, h, self.tp), dim=-1)
        h = dropout(torch.relu(self.fc1(self.norm(pooled))), self.dropout, generator)
        return torch.log_softmax(self.fc2(h), dim=-1)
