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
window variants reduce over frames and need them whole.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sls_tpu_torch.config import SAEConfig
from sls_tpu_torch.kernels import sae_kernels as sk
from sls_tpu_torch.sae.sparsify import topk_per_row, window_topk_hard, window_topk_overlap

VARIANTS = ("per_timestep", "window_overlap", "window_hard")


class TopKSAE(nn.Module):
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
        if cfg.use_pallas and cfg.variant == "per_timestep":
            flat = x.reshape(-1, x.shape[-1])
            out = sk.sae_encode_topk(flat, self.W_enc, self.b_enc, self.b_dec, cfg.k)
            return out.reshape(*x.shape[:-1], cfg.dict_size)
        if (cfg.use_pallas and cfg.variant == "window_overlap"
                and x.dim() == 3 and cfg.window_size % 2 == 0):
            return sk.window_topk_overlap(self.pre_activations(x), cfg.k, cfg.window_size)
        return self.sparsify(self.pre_activations(x))

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
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


def reconstruction_loss(recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean-squared reconstruction error."""
    return torch.mean(torch.square(recon.float() - target.float()))
