"""Deployment artifacts: the serving forward as a ``torch.export`` program.

Counterpart of ``sls_tpu/serve/export.py``, whose artifact is serialized
StableHLO plus a msgpack of the parameters.  Here the program is
``torch.export``'s: ``(wav_wire [batch, cut]) -> log_probs [batch, 2]``,
with the wire's dequantization inside it and the weights in the
program's state.  A deployment host needs ``torch`` and this package's
kernel library (``kernels/``: the custom ops the program calls and the
CUDA sources they build), not the model code, the config system or the
checkpoint loader.

Artifact = a directory:

    manifest.json   shapes, wire dtype, family, device, versions, config,
                    and the ``sls_tpu_torch::*`` ops in the program
    forward.pt2     ``torch.export.save`` of the program and its weights

Design choices, as in the reference:

- a static batch: the engine dispatches a fixed batch anyway, and the
  kernels' launches take fixed shapes;
- the int8 and wire choices are made at export time and recorded in the
  manifest; the loader rejects another shape or dtype instead of
  retracing (an exported program cannot);
- the hand-written kernels a fixed-shape forward reaches (rows 1, 2, 3,
  5, 8 and 9) are ``torch.library`` custom ops (``kernels/ops.py``), so
  the program holds calls of them, not their plain bodies, and runs them
  on the card as the live scorer does.

The reference exports for several platforms at once; a ``torch.export``
program holds its weights on the device it was exported on, so an
artifact is for that device (``manifest["device"]``: ``cuda`` or
``cpu``), and a CPU artifact serves the CPU tests.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from sls_tpu_torch.config import config_to_json
from sls_tpu_torch.device import DeviceLike, resolve_device
from sls_tpu_torch.kernels import ops
from sls_tpu_torch.serve.scorer import WIRE_NUMPY, is_sls_state, load_serving_parts, serving_model
from sls_tpu_torch.train.steps import dequantize_wire

MANIFEST_NAME = "manifest.json"
PROGRAM_NAME = "forward.pt2"
FORMAT_VERSION = 1


class ServingForward(torch.nn.Module):
    """The exported function, the reference's serving step: the wire's
    dequantization, then the family's eval forward's ``log_probs``.  For
    the detector that forward includes the SAE decode, which the log-probs
    do not read when the head takes the sparse codes (``score`` leaves it
    out; the reference's program holds it, and so does this one)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.model(dequantize_wire(wav))["log_probs"]


def program_ops(program) -> list:
    """The ``sls_tpu_torch::*`` custom ops an exported program calls."""
    names = set()
    for node in program.graph.nodes:
        target = str(node.target)
        if node.op == "call_function" and target.startswith(f"{ops.NAMESPACE}."):
            names.add(f"{ops.NAMESPACE}::{target.split('.')[1]}")
    return sorted(names)


def export_serving(
    run_dir,
    out_dir,
    *,
    batch_size: int = 36,
    wire_dtype: str = "float32",
    int8: Optional[bool] = None,
    checkpoint=None,
    device: DeviceLike = "cuda",
) -> dict:
    """Export ``run_dir``'s serving forward into ``out_dir`` on ``device``;
    returns the manifest dict."""
    if wire_dtype not in WIRE_NUMPY:
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}; one of {sorted(WIRE_NUMPY)}")
    dev = resolve_device(device)
    cfg, params = load_serving_parts(run_dir, checkpoint, int8=int8)
    cut = int(cfg.train.cut_length)
    model = serving_model(cfg, params, dev)
    model.requires_grad_(False)
    wav = torch.from_numpy(np.zeros((batch_size, cut), WIRE_NUMPY[wire_dtype])).to(dev)
    with torch.no_grad():
        program = torch.export.export(ServingForward(model), (wav,))
    manifest = {
        "format_version": FORMAT_VERSION,
        "family": "sls" if is_sls_state(params) else "detector",
        "n_args": 1,  # the wav alone: the weights are the program's state
        "batch_size": batch_size,
        "cut": cut,
        "wire_dtype": wire_dtype,
        "int8_serving": bool(cfg.model.encoder.int8_serving),
        "device": dev.type,
        "export_schema_version": list(torch._export.serde.schema.SCHEMA_VERSION),
        "torch_version": torch.__version__,
        "ops": program_ops(program),
        "config": json.loads(config_to_json(cfg)),
    }
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(out / PROGRAM_NAME))
    (out / MANIFEST_NAME).write_text(json.dumps(manifest, indent=1))
    return manifest


def load_exported(out_dir):
    """(manifest, forward) from an ``export_serving`` directory.

    ``forward(wav_wire [batch, cut]) -> log_probs [batch, 2]`` on the
    artifact's device (numpy in, a tensor that may still be in flight
    out); the wire's shape and dtype are fixed at export time and
    checked on every call.  The port's op registrations are imported
    before the program is loaded: the artifact needs ``torch`` and the
    kernel library, not the model code or the checkpoint loader."""
    out = Path(out_dir)
    manifest = json.loads((out / MANIFEST_NAME).read_text())
    if manifest.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported artifact format_version {manifest.get('format_version')!r} "
            f"(loader speaks {FORMAT_VERSION})")
    ops.register_all()
    program = torch.export.load(str(out / PROGRAM_NAME))
    module = program.module()
    dev = resolve_device(manifest["device"])
    batch, cut = int(manifest["batch_size"]), int(manifest["cut"])
    wire = np.dtype(WIRE_NUMPY[manifest["wire_dtype"]])

    def forward(wav):
        w = wav if torch.is_tensor(wav) else torch.from_numpy(np.ascontiguousarray(wav))
        dtype = str(w.dtype).removeprefix("torch.")
        if tuple(w.shape) != (batch, cut) or dtype != wire.name:
            raise ValueError(
                f"exported program is fixed at wav[{batch}, {cut}] "
                f"{wire.name} (wire={manifest['wire_dtype']}); got "
                f"{list(w.shape)} {dtype}. Re-export for other "
                f"shapes, or route through data/pipeline.to_wire.")
        with torch.inference_mode():
            return module(w.to(dev))

    return manifest, forward


def build_scorer_from_export(out_dir, *, warmup: bool = True) -> Tuple[dict, object, int]:
    """(manifest, score_fn, cut) ready for BatchingEngine, the artifact's
    counterpart of ``scorer.build_scorer``.  The engine must be built with
    the manifest's ``batch_size`` and ``wire_dtype``."""
    manifest, forward = load_exported(out_dir)
    if warmup:
        wav = np.zeros((manifest["batch_size"], manifest["cut"]),
                       WIRE_NUMPY[manifest["wire_dtype"]])
        forward(wav).cpu()
    return manifest, forward, int(manifest["cut"])
