"""TopK sparse autoencoder, counterpart of ``sls_tpu/sae/topk.py``.

One module for the SAE family through ``SAEConfig.variant``
(``per_timestep``, ``window_overlap``, ``window_hard``): tied
initialisation (unit-norm decoder atoms, encoder = decoder transpose,
zero biases), ``encode`` = ReLU(enc(x - b_dec)) + the variant's TopK
rule, ``decode`` = codes @ W_dec + b_dec.  Parameters live in fp32.
``use_pallas`` routes the work through the hand-written kernels
(``kernels/sae_kernels.py``) with their numerics, as the JAX package
routes it through its Pallas kernels: the fused bf16 encode + top-k for
``per_timestep``, the fp32 encode then the bf16 vote merge for
``window_overlap`` with an even window, the fp32 encode then the plain
rule otherwise, and the fp32 decode.  Every such call goes through the
kernel's ``torch.autograd.Function`` (forward: the kernel; backward: the
reference's fp32 matmuls), serving and training alike; under
``inference_mode`` a Function is only its forward.  Without
``use_pallas`` the plain matmuls run in ``dtype``, as the JAX package's
XLA path does, and autograd differentiates the plain rules with their
masks held constant.

Under sequence parallelism (``parallel/sequence.py``) the per-timestep
variant works on any rank's frames as they are (``row_parallel``); the
window variants reduce over frames and need them whole.  Under tensor
parallelism (``tp`` set, ``parallel/tensor.py``; ``use_pallas`` off)
``W_enc`` / ``b_enc`` hold this rank's dictionary columns and ``W_dec``
its rows: the encode runs on them, the pre-activations are gathered
whole over the mesh's 'model' axis for the TopK rule, and the decode
runs on this rank's columns of the codes, its partial sums all-reduced.

JumpReLU-style inference: ``encode_threshold`` keeps the activations
above a threshold instead of the top k; ``calibrate_threshold`` picks a
scalar or per-feature threshold that keeps k of M on average (the
(1 - k/M)-quantile, linear interpolation, as ``jnp.quantile``, by
``kthvalue``: ``torch.quantile`` refuses more than 2^24 elements, less
than one full-width batch); ``threshold_from_state`` reads a reference
checkpoint's calibrated ``threshold`` buffer.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sls_tpu_torch.config import SAEConfig
from sls_tpu_torch.kernels import sae_kernels as sk
from sls_tpu_torch.parallel.tensor import copy_to_model, cut_to_model, gather_from_model, \
    reduce_from_model
from sls_tpu_torch.sae.sparsify import topk_per_row, window_topk_hard, window_topk_overlap

VARIANTS = ("per_timestep", "window_overlap", "window_hard")


class TopKSAE(nn.Module):
    tp = None  # a parallel/tensor.py ModelShard when the dictionary is cut

    def __init__(self, config: SAEConfig, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        if config.variant not in VARIANTS:
            raise ValueError(f"unknown SAE variant: {config.variant!r}")
        self.config = config
        self.dtype = dtype
        D, M = config.activation_dim, config.dict_size
        # [dict_size, activation_dim]; row = unit-norm dictionary atom
        self.W_dec = nn.Parameter(torch.empty(M, D, device=device))
        self.W_enc = nn.Parameter(torch.empty(D, M, device=device))
        self.b_enc = nn.Parameter(torch.zeros(M, device=device))
        self.b_dec = nn.Parameter(torch.zeros(D, device=device))

    @property
    def row_parallel(self) -> bool:
        """Each frame's codes depend on that frame alone."""
        return self.config.variant == "per_timestep"

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Tied init: uniform atoms normalised to unit L2, W_enc = W_dec.T."""
        w = torch.empty_like(self.W_dec).uniform_(-1.0, 1.0, generator=generator)
        w = w / torch.linalg.vector_norm(w, dim=1, keepdim=True)
        self.W_dec.copy_(w)
        self.W_enc.copy_(w.t())
        self.b_enc.zero_()
        self.b_dec.zero_()

    def pre_activations(self, x: torch.Tensor) -> torch.Tensor:
        """ReLU encoder activations before sparsification.  x: [..., D]."""
        if self.tp is not None:
            h = copy_to_model(x - self.b_dec, self.tp).to(self.dtype) @ self.W_enc.to(self.dtype)
            return gather_from_model(torch.relu(h.float() + self.b_enc), self.tp)
        if self.config.use_pallas:
            flat = x.reshape(-1, x.shape[-1])
            out = sk.sae_encode_relu(flat, self.W_enc, self.b_enc, self.b_dec)
            return out.reshape(*x.shape[:-1], self.config.dict_size)
        h = (x - self.b_dec).to(self.dtype) @ self.W_enc.to(self.dtype)
        return torch.relu(h.float() + self.b_enc)

    def sparsify(self, acts: torch.Tensor) -> torch.Tensor:
        """Apply the configured TopK rule.  Window variants need [B, T, M]."""
        cfg = self.config
        if cfg.variant == "per_timestep":
            return topk_per_row(acts, cfg.k)
        if acts.dim() != 3:
            raise ValueError(
                f"variant {cfg.variant!r} needs [B,T,M] activations, "
                f"got shape {tuple(acts.shape)}"
            )
        if cfg.variant == "window_overlap":
            return window_topk_overlap(acts, cfg.k, cfg.window_size)
        return window_topk_hard(acts, cfg.k, cfg.window_size)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Sparse codes for x ([B, T, D] or [N, D]; window variants need
        the 3-D form) -> [..., M]."""
        cfg = self.config
        if self.tp is not None:  # the kernels need the whole dictionary
            return self.sparsify(self.pre_activations(x))
        if cfg.use_pallas and cfg.variant == "per_timestep":
            flat = x.reshape(-1, x.shape[-1])
            out = sk.sae_encode_topk(flat, self.W_enc, self.b_enc, self.b_dec, cfg.k)
            return out.reshape(*x.shape[:-1], cfg.dict_size)
        if (cfg.use_pallas and cfg.variant == "window_overlap"
                and x.dim() == 3 and cfg.window_size % 2 == 0):
            return sk.window_topk_overlap(self.pre_activations(x), cfg.k, cfg.window_size)
        return self.sparsify(self.pre_activations(x))

    def encode_threshold(self, x: torch.Tensor, threshold) -> torch.Tensor:
        """The activations above ``threshold`` (a scalar, or one per
        feature), the rest zero: the number kept varies by frame."""
        acts = self.pre_activations(x)
        return acts * (acts > threshold).to(acts.dtype)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            dt = self.dtype
            part = cut_to_model(codes, self.tp).to(dt).float() @ self.W_dec.to(dt).float()
            return reduce_from_model(part, self.tp).to(dt).float() + self.b_dec
        if self.config.use_pallas:
            flat = codes.reshape(-1, codes.shape[-1])
            out = sk.sae_decode(flat, self.W_dec, self.b_dec)
            return out.reshape(*codes.shape[:-1], self.config.activation_dim)
        y = codes.to(self.dtype) @ self.W_dec.to(self.dtype)
        return y.float() + self.b_dec

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (reconstruction, sparse_codes)."""
        codes = self.encode(x)
        return self.decode(codes), codes


def reconstruction_loss(recon: torch.Tensor, target: torch.Tensor,
                        group_ranks: int = 1) -> torch.Tensor:
    """Mean-squared reconstruction error.  With ``group_ranks`` > 1 (a
    data-parallel step whose ranks hold equal batches) this rank's share
    of the global mean: its sum of squares over the global element
    count; the shares sum to the mean over the concatenated batch."""
    sq = torch.square(recon.float() - target.float())
    if group_ranks == 1:
        return torch.mean(sq)
    return sq.sum() / (sq.numel() * group_ranks)


def _quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q, axis=0)`` with linear interpolation, in its
    fp32 arithmetic: position q * (n - 1) in fp32, the order statistics
    at its floor and ceiling by ``kthvalue``, weights 1 - f and f.  NaN
    where a column holds one."""
    n = x.shape[0]
    q32 = torch.tensor(q, dtype=torch.float32)
    pos = q32 * (torch.tensor(float(n), dtype=torch.float32) - 1.0)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    lo_i = int(min(max(float(lo), 0.0), n - 1))
    hi_i = int(min(max(float(hi), 0.0), n - 1))
    v_lo = torch.kthvalue(x, lo_i + 1, dim=0).values
    v_hi = v_lo if hi_i == lo_i else torch.kthvalue(x, hi_i + 1, dim=0).values
    out = v_lo * (1.0 - w_hi).to(x.device) + v_hi * w_hi.to(x.device)
    return torch.where(torch.isnan(x).any(0), float("nan"), out)


def calibrate_threshold(acts: torch.Tensor, k: int, per_feature: bool = False) -> torch.Tensor:
    """A JumpReLU threshold that keeps k activations a frame on average.

    ``acts``: post-ReLU encoder activations [..., M] (from
    ``TopKSAE.pre_activations`` on held-out data).  Returns the
    (1 - k/M)-quantile of all of them (a scalar, the reference's
    ``threshold`` buffer) or, ``per_feature``, of each feature's column
    ([M]: k/M of each feature's values above it, k a frame in all)."""
    acts = acts.float()
    m = acts.shape[-1]
    flat = acts.reshape(-1, m)
    q = 1.0 - k / m
    if per_feature:
        return _quantile_linear(flat, q)
    return _quantile_linear(flat.reshape(-1), q)


def threshold_from_state(state: Mapping[str, Any], prefix: str = "sae.") -> Optional[float]:
    """The calibrated scalar ``threshold`` buffer of a reference checkpoint's
    state dict (``module.`` prefixes allowed); None when it is missing or
    negative (-1, never calibrated)."""
    key = f"{prefix}threshold"
    cleaned = {k.removeprefix("module."): v for k, v in state.items()}
    if key not in cleaned:
        return None
    value = cleaned[key]
    value = float(value.detach().cpu() if torch.is_tensor(value) else np.asarray(value))
    return value if value >= 0.0 else None
