"""TopK sparsification rules, counterpart of ``sls_tpu/sae/sparsify.py``.

- ``topk_per_row``: per-frame TopK;
- ``window_topk_overlap``: 50%-overlap windows with vote merging;
- ``window_topk_hard``: non-overlapping windows;
- ``aggregate_windows_mean``: mean-pooled windows (the CPC head's input).

Threshold form: the k-th largest value of each row comes from a
sort-free 32-step binary search on the order-preserving bit pattern, and
every entry >= it is kept, so ties at the k-th value are all kept (not
``torch.topk`` plus scatter).  All rules run in fp32.  As in the JAX
package, trailing frames that no overlap window covers are zeroed, and
a sequence shorter than one window is padded to one window.
"""

from __future__ import annotations

from typing import Tuple

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


def _overlap_geometry(T: int, window: int) -> Tuple[int, int, int, int]:
    """(stride, num_windows, pad, T_padded) of the 50%-overlap scheme.

    A sequence shorter than one window is padded to one full window, so
    it always has one window (the reference's arithmetic would give it
    none)."""
    stride = max(1, window // 2)
    if T < window:
        return stride, 1, window - T, window
    num_windows = (T - window) // stride + 1
    required = (num_windows - 1) * stride + window
    pad = max(0, required - T)
    return stride, num_windows, pad, T + pad


def _coverage_matrix(T_padded: int, window: int, stride: int, num_windows: int,
                     device=None) -> torch.Tensor:
    """Binary C[i, t] = window i covers frame t, fp32."""
    cov = torch.zeros(num_windows, T_padded, device=device)
    for i in range(num_windows):
        cov[i, i * stride: i * stride + window] = 1.0
    return cov


def window_topk_overlap(acts: torch.Tensor, k: int, window: int) -> torch.Tensor:
    """Overlap-window TopK with vote merging; acts [B, T, D] post-ReLU.

    Each window of ``window`` frames at 50% overlap keeps the k features
    with the largest summed activation; a frame's vote for a feature is
    its activation times the number of covering windows that kept it,
    and the frame keeps its top-k features by vote.  Frames with no
    positive vote (the uncovered tail) come out zero."""
    B, T, D = acts.shape
    stride, num_windows, pad, T_padded = _overlap_geometry(T, window)
    x = acts.float()
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    # window sums, frame by frame in window order
    frames = x.unfold(1, window, stride)  # [B, nw, D, window]
    window_sums = frames[..., 0]
    for j in range(1, window):
        window_sums = window_sums + frames[..., j]
    win_mask = topk_mask(window_sums, k)  # [B, nw, D]
    cov = _coverage_matrix(T_padded, window, stride, num_windows, x.device)
    cover_count = torch.einsum("it,bid->btd", cov, win_mask)  # small integers: exact
    votes = x * cover_count
    kth = kth_value_threshold(votes, k)
    out = x * ((votes >= kth) & (votes > 0)).to(x.dtype)
    return out[:, :T] if pad else out


def window_topk_hard(acts: torch.Tensor, k: int, window: int) -> torch.Tensor:
    """Non-overlapping window TopK: one feature set per window, applied
    to every frame of the window; acts [B, T, D]."""
    B, T, D = acts.shape
    pad = (window - T % window) % window
    x = acts.float()
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    x_win = x.reshape(B, (T + pad) // window, window, D)
    win_mask = topk_mask(x_win.sum(dim=2), k)  # [B, nw, D]
    out = (x_win * win_mask[:, :, None, :]).reshape(B, T + pad, D)
    return out[:, :T] if pad else out


def aggregate_windows_mean(x: torch.Tensor, window: int) -> torch.Tensor:
    """Mean-pool frames into non-overlapping windows: [B, T, D] -> [B, N, D].
    The tail window is zero-padded and still divided by ``window``, as the
    reference does."""
    B, T, D = x.shape
    pad = (window - T % window) % window
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    return x.reshape(B, (T + pad) // window, window, D).mean(dim=2)
