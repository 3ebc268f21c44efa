"""TopK sparse autoencoder, counterpart of ``sls_tpu/sae/topk.py``.

Per-timestep variant only: tied initialisation (unit-norm decoder atoms,
encoder = decoder transpose, zero biases), ``encode`` =
ReLU(enc(x - b_dec)) + per-row TopK, ``decode`` = codes @ W_dec + b_dec.
Parameters live in fp32.  ``use_pallas`` routes encode and decode
through the hand-written kernels (``kernels/sae_kernels.py``) with their
numerics (bf16 encode operands, fp32 decode); otherwise the plain
matmuls run in ``dtype``, as the JAX package's XLA path does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sls_tpu_torch.config import SAEConfig
from sls_tpu_torch.kernels.sae_kernels import sae_decode_fused, sae_encode_topk_fused
from sls_tpu_torch.sae.sparsify import topk_per_row


class TopKSAE(nn.Module):
    def __init__(self, config: SAEConfig, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        if config.variant != "per_timestep":
            raise NotImplementedError(
                f"SAE variant {config.variant!r} is not ported yet "
                "(ROADMAP §1, the rest of the SAE family)"
            )
        self.config = config
        self.dtype = dtype
        D, M = config.activation_dim, config.dict_size
        # [dict_size, activation_dim]; row = unit-norm dictionary atom
        self.W_dec = nn.Parameter(torch.empty(M, D, device=device))
        self.W_enc = nn.Parameter(torch.empty(D, M, device=device))
        self.b_enc = nn.Parameter(torch.zeros(M, device=device))
        self.b_dec = nn.Parameter(torch.zeros(D, device=device))

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
            raise NotImplementedError(
                "use_pallas pre_activations needs the sae_encode_fused kernel, "
                "not ported yet (ROADMAP §2)"
            )
        h = (x - self.b_dec).to(self.dtype) @ self.W_enc.to(self.dtype)
        return torch.relu(h.float() + self.b_enc)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Sparse codes for x ([B, T, D] or [N, D]) -> [..., M]."""
        cfg = self.config
        if cfg.use_pallas:
            flat = x.reshape(-1, x.shape[-1])
            out = sae_encode_topk_fused(flat, self.W_enc, self.b_enc, self.b_dec, cfg.k)
            return out.reshape(*x.shape[:-1], cfg.dict_size)
        return topk_per_row(self.pre_activations(x), cfg.k)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        if self.config.use_pallas:
            flat = codes.reshape(-1, codes.shape[-1])
            out = sae_decode_fused(flat, self.W_dec, self.b_dec)
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
