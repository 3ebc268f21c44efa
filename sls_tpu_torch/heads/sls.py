"""SLS (Sensitive Layer Selection) head, counterpart of
``sls_tpu/heads/sls.py``:

    per-layer time means (fp32) -> fc0 -> sigmoid: one gate a layer and row;
    gate-weighted sum over the layers -> [B, T, C] (fp32 sums) ->
    BatchNorm over every (B, T, C) element (one channel) -> SELU ->
    3x3 max-pool -> flatten -> fc1 (encoder dtype, ``rounded_dense``) ->
    SELU -> fc3 -> SELU -> log_softmax

Parameter names (``fc0``, ``first_bn``, ``fc1``, ``fc3``) are the
upstream checkpoint's, so its head loads by name (``convert.py``).

The gated sum rounds each gate to the layers' dtype and sums the products
in fp32, as the reference's einsum with an fp32 result does; it runs in
``GatedLayerSum``, which saves no fp32 copy of the layers for the
backward.  ``first_bn`` normalises with statistics it computes in fp32:
the batch's mean and biased variance under ``train`` (every row of the
batch, padded tail rows too), the running ones otherwise.  Its running
statistics are buffers that ``forward`` never writes: under ``train``
it returns the batch's statistics, and the train step commits the
running update (flax's momentum 0.9, biased variance) only when the step
is finite (``models/sls.py``).  In a data-parallel step (``group``, the
mesh's 'data' group) the statistics are the global batch's: the sums of
x and x^2 and the element count are all-reduced over the group
(``parallel/distributed.py::sum_over``, differentiable), so every rank
normalises with the same mean and variance in flax's numerics and
commits the same running statistics.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from sls_tpu_torch.encoder.xlsr import Dense
from sls_tpu_torch.parallel.distributed import group_size, sum_over

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's convention: running = 0.9 * running + 0.1 * batch


class GatedLayerSum(torch.autograd.Function):
    """sum_l h_l * g_l over L layers [B, T, C] with gates g [L, B] in the
    layers' dtype: exact products, an fp32 sum, an fp32 result.  The
    backward gives each layer (g_l * grad) in its dtype and each gate
    sum_{t,c} grad * h_l, rounded to the gates' dtype as the reference's
    einsum transposes do."""

    @staticmethod
    def forward(ctx, gate, *hiddens):
        ctx.save_for_backward(gate, *hiddens)
        acc = hiddens[0].float() * gate[0].float()[:, None, None]
        for h, g in zip(hiddens[1:], gate[1:]):
            acc.addcmul_(h.float(), g.float()[:, None, None])
        return acc

    @staticmethod
    def backward(ctx, grad):
        gate, *hiddens = ctx.saved_tensors
        B = grad.shape[0]
        d_gate = None
        if ctx.needs_input_grad[0]:
            flat = grad.reshape(B, -1)
            d_gate = torch.stack([(flat * h.reshape(B, -1).float()).sum(-1)
                                  for h in hiddens]).to(gate.dtype)
        d_h = [(grad * g.float()[:, None, None]).to(h.dtype) if need else None
               for h, g, need in zip(hiddens, gate, ctx.needs_input_grad[1:])]
        return (d_gate, *d_h)


class FirstBatchNorm(nn.Module):
    """``BatchNorm2d(1)`` in flax's numerics: fp32 statistics over every
    element, the fast variance E[x^2] - E[x]^2 clipped at 0, y = (x -
    mean) * (rsqrt(var + eps) * weight) + bias.  ``running_mean`` and
    ``running_var`` are buffers of shape [1]."""

    def __init__(self, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(1, device=device))
        self.bias = nn.Parameter(torch.zeros(1, device=device))
        self.register_buffer("running_mean", torch.zeros(1, device=device))
        self.register_buffer("running_var", torch.ones(1, device=device))

    def forward(self, x: torch.Tensor, train: bool = False, group=None
                ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
        """(normalised x, (batch mean, batch biased variance) under
        ``train``, else None).  x is fp32.  With ``group`` the batch is the
        group's global batch (module docstring)."""
        if train and group is not None and group_size(group) > 1:
            sums = sum_over(torch.stack([x.sum(), (x * x).sum()]), group)
            n = float(x.numel() * group_size(group))  # the ranks hold equal batches
            mean = sums[0] / n
            var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
            stats = (mean.detach().reshape(1), var.detach().reshape(1))
        elif train:
            mean = x.mean()
            var = torch.clamp((x * x).mean() - mean * mean, min=0.0)
            stats = (mean.detach().reshape(1), var.detach().reshape(1))
        else:
            mean, var, stats = self.running_mean, self.running_var, None
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean) * mul + self.bias, stats

    @torch.no_grad()
    def commit(self, stats: Tuple[torch.Tensor, torch.Tensor], finite: torch.Tensor) -> None:
        """The running update from one step's batch statistics, where the
        0-d bool ``finite`` holds (else the buffers keep their bits)."""
        mean, var = stats
        new_mean = BN_MOMENTUM * self.running_mean + (1.0 - BN_MOMENTUM) * mean
        new_var = BN_MOMENTUM * self.running_var + (1.0 - BN_MOMENTUM) * var
        torch.where(finite, new_mean, self.running_mean, out=self.running_mean)
        torch.where(finite, new_var, self.running_var, out=self.running_var)


def rounded_dense(dense: Dense, x: torch.Tensor) -> torch.Tensor:
    """flax ``Dense(dtype=...)``'s numerics exactly: the operands rounded
    to ``dense.dtype``, their exact products summed in fp32, the sum
    rounded to ``dtype``, then the bias added in ``dtype``.  cuBLAS's own
    bf16 GEMM may sum split-K partials in bf16 (PyTorch allows it by
    default), and over fc1's 22,847 inputs that put the head's bf16
    log-probs 1.8x further from fp32 than the reference's rounding
    (``chip_smoke.py`` phase 16 (a)).  The fp32 GEMM costs ~0.03 ms."""
    dt = dense.dtype
    if dt == torch.float32:
        return dense(x)
    y = F.linear(x.to(dt).float(), dense.weight.to(dt).float())
    return y.to(dt) + dense.bias.to(dt)


class SLSHead(nn.Module):
    """The head for ``frames`` encoder frames of ``embed_dim``: fc1 takes
    (frames // 3) * (embed_dim // 3) inputs (22,847 at T 201, C 1024) and
    runs in ``dtype`` on fp32 parameters; fc0, fc3 and the rest run in
    fp32."""

    def __init__(self, embed_dim: int = 1024, frames: int = 201, hidden_dim: int = 1024,
                 num_classes: int = 2, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.fc0 = Dense(embed_dim, 1, torch.float32, device)
        self.first_bn = FirstBatchNorm(device)
        self.fc1 = Dense((frames // 3) * (embed_dim // 3), hidden_dim, dtype, device)
        self.fc3 = Dense(hidden_dim, num_classes, torch.float32, device)

    def gates(self, hidden_states: Union[torch.Tensor, Sequence[torch.Tensor]]) -> torch.Tensor:
        """The sigmoid layer gates [L, B], fp32, from each layer's time mean
        in fp32."""
        pooled = torch.stack([torch.mean(h, dim=1, dtype=torch.float32)
                              for h in hidden_states])  # [L, B, C]
        return torch.sigmoid(self.fc0(pooled))[..., 0]

    def pooled(self, hidden_states: Union[torch.Tensor, Sequence[torch.Tensor]],
               train: bool = False, group=None
               ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
        """(fc1's input: the gated sum, normalised, SELU, max-pooled and
        flattened [B, F] fp32; the BatchNorm's batch statistics under
        ``train``, else None)."""
        layers = list(hidden_states.unbind(0)) if torch.is_tensor(hidden_states) \
            else list(hidden_states)
        gate = self.gates(layers)
        fused = GatedLayerSum.apply(gate.to(layers[0].dtype), *layers)  # [B, T, C] fp32
        x, stats = self.first_bn(fused, train, group)
        x = F.selu(x)
        B, T, C = x.shape
        tp, cp = (T // 3) * 3, (C // 3) * 3
        x = x[:, :tp, :cp].reshape(B, T // 3, 3, C // 3, 3).amax(dim=(2, 4))
        return x.reshape(B, -1), stats

    def classify(self, x: torch.Tensor) -> torch.Tensor:
        """fc1 (in ``dtype``) -> SELU -> fc3 -> SELU -> log_softmax."""
        x = F.selu(rounded_dense(self.fc1, x).float())
        return torch.log_softmax(F.selu(self.fc3(x)), dim=-1)

    def forward(self, hidden_states: Union[torch.Tensor, List[torch.Tensor]],
                train: bool = False, group=None
                ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
        """hidden_states: the encoder's per-layer outputs, a list of L
        [B, T, C] or stacked [L, B, T, C] -> (log-probabilities [B,
        num_classes], the BatchNorm's batch statistics under ``train``,
        else None).  ``group``: a data-parallel step's 'data' group."""
        x, stats = self.pooled(hidden_states, train, group)
        return self.classify(x), stats
