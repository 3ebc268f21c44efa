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

Data-parallel serving (``devices``, the counterpart of the reference's
``mesh``): one replica of the model on each device; every engine batch
is cut into equal row blocks, one a replica (a shape the devices do not
divide raises ``ValueError``, as the reference's), each block enqueued
from a host thread of its own, since one batch's host enqueue (~31-33
ms at the flagship on an H100) would otherwise serialise the replicas,
and the log-probs concatenated in row order on the first replica's
device.  ``cli/serve.py --dp N`` serves on ``cuda:0 .. N-1``.
"""

from __future__ import annotations

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from sls_tpu_torch.ckpt.checkpoint import CheckpointManager, is_reference_state, load_checkpoint
from sls_tpu_torch.config import ExperimentConfig, config_from_dict
from sls_tpu_torch.device import DeviceLike, resolve_device
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.models.sls import SLSDetector
from sls_tpu_torch.train.steps import dequantize_wire

WIRE_NUMPY = {"float32": np.float32, "int16": np.int16, "mulaw": np.uint8}


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


def serving_model(cfg: ExperimentConfig, state_dict: Mapping[str, torch.Tensor],
                  device: DeviceLike = "cuda") -> torch.nn.Module:
    """The family's model (module docstring) holding ``state_dict``."""
    dev = resolve_device(device)
    if is_sls_state(state_dict):
        model = SLSDetector(cfg.model, device=dev, cut_length=cfg.train.cut_length)
    else:
        model = Detector(cfg.model, device=dev)
    model.load_state_dict(dict(state_dict), strict=True)
    return model


def _forward(cfg: ExperimentConfig, state_dict: Mapping[str, torch.Tensor],
             dev: torch.device) -> Callable:
    model = serving_model(cfg, state_dict, dev)

    def score_fn(wav) -> torch.Tensor:
        with torch.inference_mode():
            w = torch.from_numpy(np.ascontiguousarray(wav)).to(dev)
            return model.score(dequantize_wire(w))

    return score_fn


def _replicated_forward(cfg: ExperimentConfig, state_dict: Mapping[str, torch.Tensor],
                        devs: Sequence[torch.device]) -> Callable:
    """``_forward`` over one replica a device (module docstring)."""
    if len(devs) == 1:
        return _forward(cfg, state_dict, devs[0])
    # a card named without its index is the current one (set_device needs it)
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    replicas = [_forward(cfg, state_dict, d) for d in devs]
    pool = ThreadPoolExecutor(len(devs), thread_name_prefix="replica")

    def run(i: int, block) -> torch.Tensor:
        if devs[i].type == "cuda":
            torch.cuda.set_device(devs[i])  # the kernels launch on the current card
        return replicas[i](block)

    def score_fn(wav) -> torch.Tensor:
        wav = np.asarray(wav)
        if wav.shape[0] % len(devs):
            raise ValueError(f"batch shape {wav.shape[0]} must be divisible by the "
                             f"{len(devs)} serving devices for dp serving")
        blocks = np.split(wav, len(devs))
        outs = [f.result() for f in [pool.submit(run, i, b) for i, b in enumerate(blocks)]]
        return torch.cat([o.to(devs[0]) for o in outs])

    return score_fn


def build_scorer(run_dir, checkpoint=None, *, int8: Optional[bool] = None,
                 wire_dtype: str = "float32", batch_size: int = 36, warmup: bool = True,
                 bucket_sizes: Optional[tuple] = None, device: DeviceLike = "cuda",
                 devices: Optional[Sequence[DeviceLike]] = None
                 ) -> Tuple[ExperimentConfig, Callable, int]:
    """(cfg, score_fn, cut) of a run directory, ready for BatchingEngine
    (``build_scorer_from_params`` on its config and weights).
    ``devices``: data-parallel serving, one replica each (module
    docstring); else one replica on ``device``."""
    _check_shapes(batch_size, bucket_sizes, devices)
    cfg, params = load_serving_parts(run_dir, checkpoint, int8=int8)
    return build_scorer_from_params(cfg, params, batch_size, wire_dtype, device,
                                    bucket_sizes=bucket_sizes, warmup=warmup, devices=devices)


def _check_shapes(batch_size: int, bucket_sizes, devices) -> None:
    """The reference's refusal: every batch shape must divide over the
    serving devices."""
    if devices is None:
        return
    for s in tuple(sorted(set(bucket_sizes or ()))) + (batch_size,):
        if s % len(devices):
            raise ValueError(f"batch shape {s} must be divisible by the {len(devices)} "
                             "serving devices for dp serving")


def build_scorer_from_params(
    cfg: ExperimentConfig,
    state_dict: Mapping[str, torch.Tensor],
    batch_size: int = 36,
    wire_dtype: str = "float32",
    device: DeviceLike = "cuda",
    *,
    bucket_sizes: Optional[tuple] = None,
    warmup: bool = True,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Tuple[ExperimentConfig, Callable, int]:
    """(cfg, score_fn, cut) ready for BatchingEngine.

    ``score_fn(wav [B, cut] on the wire) -> log_probs [B, 2]`` on the
    device, through ``Detector.score`` (no decode) or
    ``SLSDetector.score``.  ``warmup`` runs one throwaway batch per shape
    (``bucket_sizes`` and ``batch_size``), so the first request does not
    pay for one-time setup (kernel build, library handles).  ``devices``:
    one replica on each, every batch cut over them (module docstring)."""
    if wire_dtype not in WIRE_NUMPY:
        raise ValueError(f"unknown wire_dtype: {wire_dtype!r}")
    _check_shapes(batch_size, bucket_sizes, devices)
    devs = [resolve_device(d) for d in (devices if devices is not None else [device])]
    score_fn = _replicated_forward(cfg, state_dict, devs)
    cut = cfg.train.cut_length
    if warmup:
        for s in tuple(sorted(set(bucket_sizes or ()))) + (batch_size,):
            score_fn(np.zeros((s, cut), WIRE_NUMPY[wire_dtype])).cpu()
    return cfg, score_fn, cut
