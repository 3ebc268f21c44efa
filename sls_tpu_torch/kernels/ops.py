"""The serving kernels as ``torch.library`` custom ops.

Rows 1, 2, 3, 5, 8, 9 and 11 of the kernel table (every kernel a
fixed-shape serving forward can reach) are registered under the
``sls_tpu_torch`` namespace, so that ``torch.export`` keeps each one in a
serving program as a call of its own (``serve/export.py``) instead of
tracing into it:

- the ``cuda`` implementation is the kernel's launch: its operand
  checks, the ``ctypes`` call and its wrapper's ``launches`` count;
- the ``cpu`` implementation is its plain version;
- the fake implementation gives the output's shape and dtype alone.

Each wrapper (``kernels/sae_kernels.py``, ``frontend.py``,
``attention.py``, ``layer_norm.py``) keeps its name and signature and
calls its op; the registrations run when those modules are imported, and
``register_all`` imports them.  Rows 4 and 10 (tests only) and 6 and 7
(long clips, never in a fixed-cut program) are not ops.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

NAMESPACE = "sls_tpu_torch"
# the ops, called by sae_kernels.sae_encode_topk_fused, sae_encode_fused,
# window_vote_fused, sae_decode_fused, frontend.frontend_tail_fused,
# attention.fused_attention and layer_norm.layer_norm_fp32
OPS = ("sae_encode_topk", "sae_encode", "window_vote", "sae_decode", "frontend_tail",
       "fused_attention", "layer_norm")


def define(name: str, schema: str, *, cuda: Callable, cpu: Callable, fake: Callable):
    """Register ``sls_tpu_torch::<name>`` with ``schema`` (no mutation, one
    new tensor out): ``cuda`` and ``cpu`` implementations and the fake."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cuda, mutates_args=(),
                                 device_types="cuda", schema=schema)
    op.register_kernel("cpu", cpu)
    op.register_fake(fake)
    return op


def register_all() -> Tuple[str, ...]:
    """Import the kernel modules, which register every op; returns the
    ops' qualified names."""
    from sls_tpu_torch.kernels import attention, frontend, layer_norm, sae_kernels  # noqa: F401

    return tuple(f"{NAMESPACE}::{name}" for name in OPS)
