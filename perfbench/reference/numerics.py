"""The reference's products: every matmul and convolution goes through
``Ops``, so the same equations run in the precision a check asks for.

- ``fp32``: plain float32, TF32 off (set by the caller with ``no_tf32``).
- ``bf16``: each operand rounded to bfloat16, the product in float32:
  the rounding of the precision the configurations state, whose effect
  on the outputs is the yardstick of the checks that normalise by it.
- ``fp8``: each operand rounded to float8 e4m3 with one scale a tensor
  (its largest magnitude to 448, e4m3's largest finite value), then the
  product in float32: a step below the bfloat16 that the configurations
  state.  The rounding passes the gradient straight through, so a train
  step runs in it too.  It is the control of checks whose program has
  no lower-precision path of its own.

This file imports nothing of the program under test.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextmanager
def no_tf32():
    """float32 products in float32, on the card too, for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 at one scale, as float32; the gradient passes."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


class Ops:
    """Linear, conv1d and matmul in ``precision`` ("fp32", "bf16" or "fp8")."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return round_fp8(x)
        if self.precision == "bf16":
            return x + (x.detach().to(torch.bfloat16).float() - x.detach())
        return x

    def linear(self, x, w, b=None):
        return F.linear(self._q(x), self._q(w), b)

    def conv1d(self, x, w, b=None, stride=1, padding=0, groups=1):
        return F.conv1d(self._q(x), self._q(w), b, stride, padding, 1, groups)

    def matmul(self, a, b):
        return torch.matmul(self._q(a), self._q(b))
