"""int8 dynamic-quantized matmul for the serving path, counterpart of
``sls_tpu/quant/int8.py``.

The reference's recipe, eval only: per-row (per-token) symmetric int8
activations with scales max(|x|, 1e-9) / 127 computed on the fly,
per-output-channel symmetric int8 weights with scales
max(|w|, 1e-12) / 127 quantized from the fp32 parameters each call
(so the state dict is the same as the bf16 model's), round half to
even, an exact int32 product, and an fp32 rescale
``acc * (s_x * s_w)``.  The reference leaves the int8 product to XLA;
the port leaves it to ``torch._int_mm`` (a library GEMM: no Pallas
kernel is being ported here).  On a card ``_int_mm`` takes M > 16 rows
and K, N multiples of 8; other shapes raise rather than take another
path.
"""

from __future__ import annotations

import torch


def quantize(t: torch.Tensor, dim: int, floor: float):
    """Symmetric int8 along ``dim`` of fp32 ``t``: (int8 values, fp32
    scales max(|t|, floor) / 127 with ``dim`` kept)."""
    amax = torch.clamp(t.abs().amax(dim, keepdim=True), min=floor)
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, one ulp off the reference's true division
    scale = amax / torch.full((), 127.0, device=t.device)
    return torch.round(t / scale).to(torch.int8), scale


def int8_dot(x: torch.Tensor, kernel: torch.Tensor,
             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dynamic-quantized matmul: x [..., K] @ kernel [K, N] -> [..., N]
    in ``out_dtype``.  ``kernel`` comes in the parameter dtype (fp32) and
    is quantized here; a [N, K] weight's transposed view serves as is."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1]).float()
    (m, k), n = xf.shape, kernel.shape[1]
    if xf.device.type == "cuda" and (m <= 16 or k % 8 or n % 8):
        raise ValueError(f"int8_dot on a card needs M > 16 and K, N multiples of 8; "
                         f"got M={m} K={k} N={n}")
    xq, s_x = quantize(xf, -1, 1e-9)  # per row
    wq, s_w = quantize(kernel.float(), 0, 1e-12)  # per output channel
    acc = torch._int_mm(xq, wq)
    y = acc.float() * (s_x * s_w)
    return y.to(out_dtype).reshape(*lead, n)
