"""The anti-spoofing detector, counterpart of ``sls_tpu/models/detector.py``.

    wav [B, 64600]
      -> XLS-R encoder          [B, T, 1024]
      -> TopK SAE encode        [B, T, dict_size]
      -> decode                 [B, T, 1024]        (MSE recon loss)
      -> classify sparse codes (use_sparse_features) or reconstruction
      -> mean-pool + MLP head   [B, 2] log-probs    (class 1 = bonafide)

``forward`` returns the reference's dict.  ``score`` computes only the
log-probs and skips the decode, which the JAX serving step gets from
XLA's dead-code elimination.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from sls_tpu_torch.config import ModelConfig
from sls_tpu_torch.device import DeviceLike, resolve_device
from sls_tpu_torch.encoder.xlsr import XLSREncoder, init_weights_
from sls_tpu_torch.heads.classifier import MeanPoolClassifier
from sls_tpu_torch.sae.topk import TopKSAE, reconstruction_loss


class Detector(nn.Module):
    """Inference-mode detector.  Parameters are fp32 on ``device`` and
    drawn from ``generator`` (default: seed 0 on that device); on the
    ``meta`` device they are left uninitialised."""

    def __init__(self, config: ModelConfig, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.use_cpc:
            raise NotImplementedError("the CPC head is not ported yet (ROADMAP §1)")
        dev = resolve_device(device)
        self.config = config
        self.encoder = XLSREncoder(config.encoder, device=dev)
        if config.use_sae:
            sae_dtype = torch.bfloat16 if config.sae.bf16 else torch.float32
            self.sae = TopKSAE(config.sae, dtype=sae_dtype, device=dev)
        self.classifier = MeanPoolClassifier(
            config.classifier_input_dim, config.classifier_hidden,
            config.num_classes, device=dev)
        if dev.type != "meta":
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            init_weights_(self.encoder, generator)
            if config.use_sae:
                self.sae.reset_parameters(generator)
            init_weights_(self.classifier, generator)
        self.eval()

    def forward(self, wav: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Returns a dict with:

        log_probs  [B, 2]      log-softmax outputs (class 1 = bonafide)
        score      [B]         P(bonafide) = exp(log_probs[:, 1])
        sae_loss   []          MSE reconstruction loss (0 when no SAE)
        cpc_loss   []          always 0 (no CPC head)
        features   [B, T, D]   encoder output, fp32
        codes      [B, T, M]   sparse SAE codes (when use_sae)
        recon      [B, T, D]   SAE reconstruction (when use_sae)
        """
        cfg = self.config
        feats32 = self.encoder(wav).float()
        zero = torch.zeros((), dtype=torch.float32, device=feats32.device)
        out: Dict[str, torch.Tensor] = {"features": feats32}
        sae_loss = zero
        if cfg.use_sae:
            codes = self.sae.encode(feats32)
            recon = self.sae.decode(codes)
            sae_loss = reconstruction_loss(recon, feats32)
            out["codes"] = codes
            out["recon"] = recon
            cls_in = codes if cfg.use_sparse_features else recon
        else:
            cls_in = feats32
        log_probs = self.classifier(cls_in)
        out["log_probs"] = log_probs
        out["score"] = torch.exp(log_probs[:, 1])
        out["sae_loss"] = sae_loss
        out["cpc_loss"] = zero
        return out

    def score(self, wav: torch.Tensor) -> torch.Tensor:
        """log_probs [B, 2] only, with no decode when the head reads the
        sparse codes (the serving path)."""
        cfg = self.config
        feats32 = self.encoder(wav).float()
        if not cfg.use_sae:
            return self.classifier(feats32)
        codes = self.sae.encode(feats32)
        cls_in = codes if cfg.use_sparse_features else self.sae.decode(codes)
        return self.classifier(cls_in)


def total_loss(cls_loss, sae_loss, sae_weight: float, cpc_loss=None,
               cpc_weight: float = 0.0):
    """L = L_cls + w_sae * L_recon [+ w_cpc * L_cpc]."""
    total = cls_loss
    if sae_loss is not None:
        total = total + sae_weight * sae_loss
    if cpc_loss is not None and cpc_weight:
        total = total + cpc_weight * cpc_loss
    return total
