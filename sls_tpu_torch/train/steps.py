"""Eval step and wire decoding, counterpart of ``sls_tpu/train/steps.py``
(``dequantize_wire``, ``make_eval_step``).  Training steps are not
ported yet (ROADMAP)."""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from sls_tpu_torch.device import DeviceLike, resolve_device
from sls_tpu_torch.models.detector import Detector

_LN256 = 5.545177444479562  # log(256), mu=255 companding


def dequantize_wire(wav: torch.Tensor) -> torch.Tensor:
    """Wire format -> float32 audio (data/pipeline.to_wire).

    int16: x / 32768, exact for 16-bit sources.  uint8: mu-law decode,
    as data/mulaw.mulaw_decode.  float32 passes through."""
    if wav.dtype == torch.int16:
        return wav.float() * (1.0 / 32768.0)
    if wav.dtype == torch.uint8:
        y = wav.float() * (1.0 / 127.5) - 1.0
        return torch.sign(y) * (torch.expm1(torch.abs(y) * _LN256) * (1.0 / 255.0))
    if wav.dtype != torch.float32:
        raise TypeError(f"unknown wire dtype {wav.dtype}")
    return wav


def make_eval_step(model: Detector, device: DeviceLike = "cuda") -> Callable:
    """(wav [B, S] on the wire, numpy or tensor) -> dict of tensors on
    ``device``: score [B], log_probs [B, 2], sae_loss [], and
    sae_loss_per_example [B] when the model has an SAE.  Runs under
    ``torch.inference_mode``; results are left on the device, so the
    caller decides when to wait for them."""
    dev = resolve_device(device)

    def step(wav) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            w = wav if torch.is_tensor(wav) else torch.from_numpy(np.ascontiguousarray(wav))
            out = model(dequantize_wire(w.to(dev)))
            res = {
                "score": out["score"],
                "log_probs": out["log_probs"],
                "sae_loss": out["sae_loss"],
            }
            if "recon" in out:
                # per-example MSE, so padded tail rows can be masked exactly
                diff = out["recon"] - out["features"]
                res["sae_loss_per_example"] = torch.mean(torch.square(diff), dim=(1, 2))
        return res

    return step
