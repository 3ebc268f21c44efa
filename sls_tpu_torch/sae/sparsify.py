"""Per-row TopK sparsification, counterpart of ``sls_tpu/sae/sparsify.py``.

Threshold form: the k-th largest value of each row comes from a
sort-free 32-step binary search on the order-preserving bit pattern, and
every entry >= it is kept, so ties at the k-th value are all kept (not
``torch.topk`` plus scatter).  The window rules (``window_topk_overlap``,
``window_topk_hard``, ``aggregate_windows_mean``) are not ported yet.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF
_SIGN = 0x80000000


def _monotone_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> order-preserving unsigned 32-bit key, held in int64
    (PyTorch has no full uint32 arithmetic)."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64) & _U32
    return torch.where((u >> 31) == 1, ~u & _U32, u | _SIGN)


def kth_value_threshold(acts: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest value along the last axis without sorting;
    shape acts.shape[:-1] + (1,)."""
    bits = _monotone_bits(acts)
    lo = torch.zeros(acts.shape[:-1] + (1,), dtype=torch.int64, device=acts.device)
    hi = torch.full_like(lo, _U32)
    for _ in range(32):
        mid = lo + ((hi - lo) >> 1)
        keep = (bits >= mid).sum(-1, keepdim=True) >= k
        lo = torch.where(keep, mid, lo)
        hi = torch.where(keep, hi, mid)
    # invert the monotone mapping, then reinterpret as float32
    raw = torch.where((lo & _SIGN) == 0, ~lo & _U32, lo & 0x7FFFFFFF)
    raw = torch.where(raw >= 2 ** 31, raw - 2 ** 32, raw)
    return raw.to(torch.int32).view(torch.float32)


def topk_mask(acts: torch.Tensor, k: int) -> torch.Tensor:
    """{0,1} mask keeping every entry >= the row's k-th largest value
    (float32 by the bit search; other dtypes by ``torch.topk``)."""
    if acts.dtype == torch.float32:
        kth = kth_value_threshold(acts, k)
    else:
        kth = torch.topk(acts, k, dim=-1).values[..., -1:]
    return (acts >= kth).to(acts.dtype)


def topk_per_row(acts: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row TopK sparsification: keep the k largest, zero the rest."""
    return acts * topk_mask(acts, k)


def topk_per_row_exact(acts: torch.Tensor, k: int) -> torch.Tensor:
    """Scatter form: exactly k survivors per row (ties broken by
    ``torch.topk``, whose order among equal values is unspecified)."""
    vals, idx = torch.topk(acts, k, dim=-1)
    return torch.zeros_like(acts).scatter(-1, idx, vals)
