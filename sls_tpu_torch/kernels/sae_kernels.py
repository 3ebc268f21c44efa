"""SAE hot-path kernels: wrappers over the CUDA sources, with plain versions.

Counterpart of ``sls_tpu/kernels/sae_kernels.py``.  Two kernels are
ported (forward only):

- ``sae_encode_topk_fused``: ``relu((x - b_dec) @ W_enc + b_enc)`` with
  bf16 operands and fp32 accumulation, then the exact row top-k mask
  (every entry >= the row's k-th value), ``csrc/sae_encode_topk.cu``;
- ``sae_decode_fused``: ``codes @ W_dec + b_dec`` in fp32,
  ``csrc/sae_decode.cu``.

Each wrapper takes its plain PyTorch version (``*_plain``, beside it)
for a tensor on the CPU, and launches its kernel for a CUDA tensor or
raises; there is no fallback.  ``<wrapper>.launches`` counts kernel
launches, so a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes

import torch

from sls_tpu_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib(name: str, entry: str, argtypes):
    fn = getattr(build.load(name), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_operand(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


# -- plain versions ---------------------------------------------------------


def topk_threshold_mask_plain(acts: torch.Tensor, k: int) -> torch.Tensor:
    """Row-wise exact top-k ``>=``-threshold mask of non-negative fp32
    rows: the TPU kernel's 31-step binary search on the int32 bit
    pattern (``_topk_threshold_mask``), which the CUDA select repeats."""
    acts = acts.contiguous()
    bits = acts.view(torch.int32)
    lo = torch.zeros(acts.shape[:-1] + (1,), dtype=torch.int32, device=acts.device)
    hi = torch.full_like(lo, 0x7F800000)  # +inf bits
    for _ in range(31):
        mid = lo + ((hi - lo) >> 1)
        keep = (bits >= mid).sum(-1, keepdim=True) >= k
        lo = torch.where(keep, mid, lo)
        hi = torch.where(keep, hi, mid)
    return torch.where(bits >= lo, acts, 0.0)


def sae_encode_acts_plain(x, w_enc, b_enc, b_dec) -> torch.Tensor:
    """Dense activations with the kernel's casts: x rounded to bf16,
    centred in fp32 and rounded to bf16 again, W_enc rounded to bf16,
    exact products summed in fp32 (TF32 must be off, PyTorch's default
    for matmul), bias and ReLU in fp32."""
    bf16 = torch.bfloat16
    xc = (x.to(bf16).float() - b_dec.float()).to(bf16)
    acc = xc.float() @ w_enc.to(bf16).float()
    return torch.relu(acc + b_enc.float())


def sae_encode_topk_fused_plain(x, w_enc, b_enc, b_dec, k: int) -> torch.Tensor:
    """Plain version of ``sae_encode_topk_fused``: x [N, D] -> [N, M]."""
    return topk_threshold_mask_plain(sae_encode_acts_plain(x, w_enc, b_enc, b_dec), k)


def sae_decode_fused_plain(codes, w_dec, b_dec) -> torch.Tensor:
    """Plain version of ``sae_decode_fused``: fp32 ``codes @ w_dec + b_dec``."""
    return codes.float() @ w_dec.float() + b_dec.float()


# -- wrappers ---------------------------------------------------------------


def sae_encode_topk_fused(x, w_enc, b_enc, b_dec, k: int) -> torch.Tensor:
    """Sparse codes = topk_mask(relu((x - b_dec) @ w_enc + b_enc), k);
    x [N, D] -> [N, M] fp32.  CUDA: D % 32 == 0, M % 128 == 0, fp32
    contiguous operands."""
    if x.device.type == "cpu":
        return sae_encode_topk_fused_plain(x, w_enc, b_enc, b_dec, k)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n, d = x.shape
    m = w_enc.shape[1]
    for t, name, shape in ((x, "x", (n, d)), (w_enc, "w_enc", (d, m)),
                           (b_enc, "b_enc", (m,)), (b_dec, "b_dec", (d,))):
        _check_operand(t, name, shape, x.device)
    if d % 32 or m % 128:
        raise ValueError(f"need D % 32 == 0 and M % 128 == 0, got D={d}, M={m}")
    if not 1 <= k <= m:
        raise ValueError(f"k must be in [1, {m}], got {k}")
    if m * 4 > 227 * 1024:
        raise ValueError(f"M={m} rows exceed a block's shared memory")
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    fn = _lib("sae_encode_topk", "sae_encode_topk_launch", [_P] * 5 + [_I] * 4 + [_P])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w_enc.data_ptr(), b_enc.data_ptr(), b_dec.data_ptr(),
                 out.data_ptr(), n, d, m, k, stream)
    build.check(err, "sae_encode_topk")
    sae_encode_topk_fused.launches += 1
    return out


sae_encode_topk_fused.launches = 0


def sae_decode_fused(codes, w_dec, b_dec) -> torch.Tensor:
    """codes @ w_dec + b_dec for codes [N, M] -> [N, D], fp32.  CUDA:
    D % 4 == 0, fp32 contiguous operands; zero codes are skipped."""
    if codes.device.type == "cpu":
        return sae_decode_fused_plain(codes, w_dec, b_dec)
    if codes.device.type != "cuda":
        raise ValueError(f"no kernel for device {codes.device}")
    n, m = codes.shape
    d = w_dec.shape[1]
    for t, name, shape in ((codes, "codes", (n, m)), (w_dec, "w_dec", (m, d)),
                           (b_dec, "b_dec", (d,))):
        _check_operand(t, name, shape, codes.device)
    if d % 4:
        raise ValueError(f"need D % 4 == 0, got D={d}")
    if m * 8 > 227 * 1024:
        raise ValueError(f"M={m} codes exceed a block's shared memory")
    out = torch.empty((n, d), dtype=torch.float32, device=codes.device)
    if n == 0:
        return out
    fn = _lib("sae_decode", "sae_decode_launch", [_P] * 4 + [_I] * 3 + [_P])
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(codes.data_ptr(), w_dec.data_ptr(), b_dec.data_ptr(), out.data_ptr(),
                 n, m, d, stream)
    build.check(err, "sae_decode")
    sae_decode_fused.launches += 1
    return out


sae_decode_fused.launches = 0
