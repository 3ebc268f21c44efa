"""Build an online scorer for ``BatchingEngine``, counterpart of
``sls_tpu/serve/scorer.py``.

``build_scorer(run_dir)`` serves a run directory of either package: the
checkpoint is found by ``CheckpointManager.resolve_resume`` (explicit >
last > best), the config read from its ``config_json`` (this package's
or the JAX package's JSON) and the weights from its state (this
package's ``model`` state dict, or the JAX package's ``params``).
``int8`` overrides the checkpoint's ``int8_serving`` where given: serving
is what the int8 route is for.  ``build_scorer_from_params`` takes a
config and a state dict instead.  Either family is served: a state with
``sls_head.`` entries is an ``SLSDetector``, any other a ``Detector``.

Not ported yet: data-parallel serving over several cards (the
reference's ``mesh`` argument; ROADMAP M8).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from sls_tpu_torch.ckpt.checkpoint import CheckpointManager, is_reference_state, load_checkpoint
from sls_tpu_torch.config import ExperimentConfig, config_from_dict
from sls_tpu_torch.device import DeviceLike, resolve_device
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.models.sls import SLSDetector
from sls_tpu_torch.train.steps import dequantize_wire

_WIRE_NUMPY = {"float32": np.float32, "int16": np.int16, "mulaw": np.uint8}


def load_serving_parts(run_dir, checkpoint=None, int8: Optional[bool] = None
                       ) -> Tuple[ExperimentConfig, Dict[str, torch.Tensor]]:
    """(cfg, state dict) of a run directory's checkpoint (module
    docstring), on the host.  ``int8=None`` keeps the checkpoint's
    ``int8_serving``; True / False force it."""
    path = CheckpointManager(run_dir).resolve_resume(checkpoint)
    if path is None:
        raise FileNotFoundError(f"no checkpoint in {run_dir}")
    ckpt = load_checkpoint(path)
    cfg = config_from_dict(ExperimentConfig, json.loads(ckpt["meta"]["config_json"]))
    if int8 is not None and bool(cfg.model.encoder.int8_serving) != int8:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, encoder=dataclasses.replace(cfg.model.encoder, int8_serving=int8)))
    state = ckpt["state"]
    params = state["params"] if is_reference_state(state) else state["model"]
    return cfg, dict(params)


def load_serving_model(run_dir, checkpoint=None, int8: Optional[bool] = None,
                       device: DeviceLike = "cuda") -> Tuple[ExperimentConfig, Callable]:
    """(cfg, forward) of a run directory: ``forward(wav [B, cut] on the
    wire, numpy) -> log_probs [B, 2]`` on the device."""
    cfg, params = load_serving_parts(run_dir, checkpoint, int8=int8)
    return cfg, _forward(cfg, params, resolve_device(device))


def is_sls_state(state_dict: Mapping[str, torch.Tensor]) -> bool:
    """Whether a state dict is of the SLS family."""
    return any(k.startswith("sls_head.") for k in state_dict)


def _forward(cfg: ExperimentConfig, state_dict: Mapping[str, torch.Tensor],
             dev: torch.device) -> Callable:
    if is_sls_state(state_dict):
        model = SLSDetector(cfg.model, device=dev, cut_length=cfg.train.cut_length)
    else:
        model = Detector(cfg.model, device=dev)
    model.load_state_dict(dict(state_dict), strict=True)

    def score_fn(wav) -> torch.Tensor:
        with torch.inference_mode():
            w = torch.from_numpy(np.ascontiguousarray(wav)).to(dev)
            return model.score(dequantize_wire(w))

    return score_fn


def build_scorer(run_dir, checkpoint=None, *, int8: Optional[bool] = None,
                 wire_dtype: str = "float32", batch_size: int = 36, warmup: bool = True,
                 bucket_sizes: Optional[tuple] = None, device: DeviceLike = "cuda"
                 ) -> Tuple[ExperimentConfig, Callable, int]:
    """(cfg, score_fn, cut) of a run directory, ready for BatchingEngine
    (``build_scorer_from_params`` on its config and weights)."""
    cfg, params = load_serving_parts(run_dir, checkpoint, int8=int8)
    return build_scorer_from_params(cfg, params, batch_size, wire_dtype, device,
                                    bucket_sizes=bucket_sizes, warmup=warmup)


def build_scorer_from_params(
    cfg: ExperimentConfig,
    state_dict: Mapping[str, torch.Tensor],
    batch_size: int = 36,
    wire_dtype: str = "float32",
    device: DeviceLike = "cuda",
    *,
    bucket_sizes: Optional[tuple] = None,
    warmup: bool = True,
) -> Tuple[ExperimentConfig, Callable, int]:
    """(cfg, score_fn, cut) ready for BatchingEngine.

    ``score_fn(wav [B, cut] on the wire) -> log_probs [B, 2]`` on the
    device, through ``Detector.score`` (no decode) or
    ``SLSDetector.score``.  ``warmup`` runs one throwaway batch per shape
    (``bucket_sizes`` and ``batch_size``), so the first request does not
    pay for one-time setup (kernel build, library handles)."""
    if wire_dtype not in _WIRE_NUMPY:
        raise ValueError(f"unknown wire_dtype: {wire_dtype!r}")
    score_fn = _forward(cfg, state_dict, resolve_device(device))
    cut = cfg.train.cut_length
    if warmup:
        for s in tuple(sorted(set(bucket_sizes or ()))) + (batch_size,):
            score_fn(np.zeros((s, cut), _WIRE_NUMPY[wire_dtype])).cpu()
    return cfg, score_fn, cut
