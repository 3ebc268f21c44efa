"""Build an online scorer for ``BatchingEngine``, counterpart of
``sls_tpu/serve/scorer.py``.  Loading a run directory waits for the
checkpoint port; ``build_scorer_from_params`` takes the config and a
state dict (for example from ``convert.detector_state_from_flax``)."""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from sls_tpu_torch.config import ExperimentConfig
from sls_tpu_torch.device import DeviceLike, resolve_device
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.train.steps import dequantize_wire

_WIRE_NUMPY = {"float32": np.float32, "int16": np.int16, "mulaw": np.uint8}


def build_scorer_from_params(
    cfg: ExperimentConfig,
    state_dict: Mapping[str, torch.Tensor],
    batch_size: int = 36,
    wire_dtype: str = "float32",
    device: DeviceLike = "cuda",
    *,
    bucket_sizes: Optional[tuple] = None,
) -> Tuple[ExperimentConfig, Callable, int]:
    """(cfg, score_fn, cut) ready for BatchingEngine.

    ``score_fn(wav [B, cut] on the wire) -> log_probs [B, 2]`` on the
    device, through ``Detector.score`` (no decode).  One throwaway batch
    per shape runs first, so the first request does not pay for one-time
    setup (kernel build, library handles)."""
    if wire_dtype not in _WIRE_NUMPY:
        raise ValueError(f"unknown wire_dtype: {wire_dtype!r}")
    dev = resolve_device(device)
    model = Detector(cfg.model, device=dev)
    model.load_state_dict(dict(state_dict), strict=True)

    def score_fn(wav) -> torch.Tensor:
        with torch.inference_mode():
            w = torch.from_numpy(np.ascontiguousarray(wav)).to(dev)
            return model.score(dequantize_wire(w))

    cut = cfg.train.cut_length
    for s in tuple(sorted(set(bucket_sizes or ()))) + (batch_size,):
        score_fn(np.zeros((s, cut), _WIRE_NUMPY[wire_dtype])).cpu()
    return cfg, score_fn, cut
