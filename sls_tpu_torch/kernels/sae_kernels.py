"""SAE hot-path kernels: wrappers over the CUDA sources, with plain versions.

Counterpart of ``sls_tpu/kernels/sae_kernels.py``; every kernel there
is ported:

- ``sae_encode_topk_fused``: ``relu((x - b_dec) @ W_enc + b_enc)`` with
  bf16 operands and fp32 accumulation, then the exact row top-k mask
  (every entry >= the row's k-th value), ``csrc/sae_encode_topk.cu`` (a
  cast pass, a bf16 ``wgmma`` GEMM and a radix select, which
  ``topk_threshold_radix_emulated`` repeats on the CPU for the tests);
- ``sae_encode_fused``: the same encode with fp32 operands and no top-k,
  ``csrc/sae_encode.cu`` (fp32-accurate "3xTF32" on the tensor cores;
  ``sae_encode_fused_split_emulated`` repeats its operand split on the
  CPU for the tests);
- ``topk_sparsify``: the exact row top-k mask alone, a second entry of
  ``csrc/sae_encode_topk.cu``;
- ``window_vote_fused``: the overlap-window vote merge in bf16,
  ``csrc/window_vote.cu`` (one launch over stripes of chunks, each frame
  read once, a two-pass radix select over the bf16 patterns;
  ``kth_bits_bf16_radix_emulated`` and ``window_vote_stripes_emulated``
  repeat its select and its walk on the CPU for the tests);
- ``sae_decode_fused``: ``codes @ W_dec + b_dec`` in fp32,
  ``csrc/sae_decode.cu`` (W_dec streamed once per row tile;
  ``sae_decode_streamed_emulated`` walks its tiles and windows on the
  CPU for the tests).

Each wrapper takes its plain PyTorch version (``*_plain``, beside it)
for a tensor on the CPU, and launches its kernel for a CUDA tensor or
raises; there is no fallback.  ``<wrapper>.launches`` counts kernel
launches, so a run can show that its main path went through them.  All
but ``topk_sparsify`` (no path calls it) go through a ``torch.library``
custom op (``sls_tpu_torch::sae_encode_topk``, ``sae_encode``,
``window_vote``, ``sae_decode``; ``kernels/ops.py``) whose ``cuda``
implementation is the launch and whose ``cpu`` one the plain version, so
that ``torch.export`` keeps the kernels in a serving program.

Training goes through four ``torch.autograd.Function``s, the
counterparts of the reference's custom VJPs: ``sae_encode_topk``,
``sae_encode_relu``, ``sae_decode`` and ``window_topk_overlap``.  Each
forward is the wrapper above (the kernel launches once, in the forward);
each backward is the reference's exact formula in fp32 ``torch.matmul``
(``encode_backward``, ``decode_backward``, the vote's mask), as the
reference's backward passes are XLA, not Pallas.  The masks come from
the forward's output (``out > 0``): an entry kept at zero gets no
gradient.  The fp32 GEMMs run without TF32, PyTorch's default for
matmul, which the package never changes.
"""

from __future__ import annotations

import ctypes

import torch

from sls_tpu_torch.kernels import build
from sls_tpu_torch.kernels.ops import define
from sls_tpu_torch.sae.sparsify import _overlap_geometry

_P = ctypes.c_void_p
_I = ctypes.c_int

# the radix select's digits, high to low, over the 31 bits of a positive
# fp32 pattern: (shift, width) of each pass (csrc/sae_encode_topk.cu)
RADIX_PASSES = ((23, 8), (15, 8), (7, 8), (0, 7))
# the vote kernel's radix select over the 15 bits of a positive bf16
# pattern: (shift, width) of its two passes; and the blocks its persistent
# grid has on an H100 (one an SM), which set its stripes
# (csrc/window_vote.cu)
VOTE_RADIX_PASSES = ((7, 8), (0, 7))
VOTE_BLOCKS = 132
# the decode kernel's tiling (csrc/sae_decode.cu): rows and columns of out
# a block, atoms a window, and row tiles a cluster sharing W_dec's windows
DECODE_TILE_ROWS, DECODE_TILE_COLS, DECODE_WINDOW, DECODE_CLUSTER = 128, 256, 32, 2


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
    pattern (``_topk_threshold_mask``).  The CUDA select finds the same
    threshold by a radix search (``topk_threshold_radix_emulated``)."""
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


def topk_threshold_radix_emulated(acts: torch.Tensor, k: int) -> torch.Tensor:
    """The CUDA select's radix search on the CPU (tests only): the same
    mask as ``topk_threshold_mask_plain``, found as the kernel finds it.
    Only positive patterns are candidates; a row with fewer than k of
    them ends at lo = 0.  Each pass histograms the candidates' next digit
    (``RADIX_PASSES``), takes the bin holding the remaining rank counted
    from the top, and keeps the candidates in it; after the last pass
    the prefix is b_k, the k-th largest positive pattern, and lo =
    min(b_k, 0x7F7FFFFF), where the binary search over [0, 0x7F800000)
    stops."""
    acts = acts.contiguous()
    bits = acts.view(torch.int32)
    flat = bits.reshape(-1, bits.shape[-1]).long()
    cand = flat > 0
    short = cand.sum(-1) < k
    prefix = torch.zeros(flat.shape[0], dtype=torch.long, device=flat.device)
    rank = torch.full_like(prefix, k)
    for shift, width in RADIX_PASSES:
        digit = (flat >> shift) & ((1 << width) - 1)
        hist = torch.zeros(flat.shape[0], 256, dtype=torch.long, device=flat.device)
        hist.scatter_add_(1, torch.where(cand, digit, 0), cand.long())
        at_or_above = hist.flip(-1).cumsum(-1).flip(-1)  # candidates in bins >= d
        above = at_or_above - hist
        pick = ((above < rank[:, None]) & (at_or_above >= rank[:, None])).long().argmax(-1)
        rank = rank - above.gather(1, pick[:, None])[:, 0]
        prefix = prefix | (pick << shift)
        cand = cand & (digit == pick[:, None])
    lo = torch.where(short, 0, torch.clamp(prefix, max=0x7F7FFFFF)).to(torch.int32)
    lo = lo.reshape(bits.shape[:-1] + (1,))
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


def sae_decode_streamed_emulated(codes, w_dec, b_dec, tile_rows: int = DECODE_TILE_ROWS,
                                 tile_cols: int = DECODE_TILE_COLS,
                                 window: int = DECODE_WINDOW) -> torch.Tensor:
    """The CUDA decode's walk on the CPU (tests only): row tiles of
    ``tile_rows`` x ``tile_cols``, padded with zeros past N, D and M as
    the kernel's TMA boxes read them, and W_dec in windows of ``window``
    atoms; in each window every row adds its nonzero codes in ascending
    atom order, one fp32 fused multiply-add a term (the product exact in
    fp64, the sum rounded once to fp32), then b_dec."""
    codes, w_dec, b_dec = codes.float(), w_dec.float(), b_dec.float()
    n, m = codes.shape
    d = w_dec.shape[1]
    m_pad = -(-m // window) * window
    c = torch.nn.functional.pad(codes, (0, m_pad - m, 0, -n % tile_rows))
    w = torch.nn.functional.pad(w_dec, (0, -d % tile_cols, 0, m_pad - m))
    out = torch.empty(c.shape[0], w.shape[1], device=c.device)
    for r0 in range(0, c.shape[0], tile_rows):
        for c0 in range(0, w.shape[1], tile_cols):
            acc = torch.zeros(tile_rows, tile_cols, device=c.device)
            for a0 in range(0, m_pad, window):
                tile_c = c[r0:r0 + tile_rows, a0:a0 + window]
                tile_w = w[a0:a0 + window, c0:c0 + tile_cols]
                for a in range(window):
                    code = tile_c[:, a:a + 1]
                    fma = (code.double() * tile_w[a].double() + acc.double()).float()
                    acc = torch.where(code != 0, fma, acc)
            out[r0:r0 + tile_rows, c0:c0 + tile_cols] = acc
    return out[:n, :d] + b_dec


def sae_encode_fused_plain(x, w_enc, b_enc, b_dec) -> torch.Tensor:
    """Plain version of ``sae_encode_fused``: fp32 operands and sums (TF32
    must be off, PyTorch's default for matmul), bias and ReLU in fp32."""
    acc = (x.float() - b_dec.float()) @ w_enc.float()
    return torch.relu(acc + b_enc.float())


def tf32_round_rna(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10 stored mantissa bits, to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32``: add half a TF32 ulp
    to the magnitude bits and clear the 13 low bits (a carry runs into the
    exponent; subnormals round the same way).  NaN stays NaN."""
    bits = t.float().contiguous().view(torch.int32)
    out = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(t), t.float(), out)


def sae_encode_fused_split_emulated(x, w_enc, b_enc, b_dec) -> torch.Tensor:
    """The CUDA kernel's operand split on the CPU (tests only): the fp32
    centred x and W_enc each as hi + lo TF32 values, and the three
    products lo.hi + hi.lo + hi.hi taken in fp64 and rounded once to fp32
    (the kernel sums them in fp32, in its own order); bias and ReLU in
    fp32."""
    def split(a):
        hi = tf32_round_rna(a)
        return hi, tf32_round_rna(a - hi)

    x_hi, x_lo = split(x.float() - b_dec.float())
    w_hi, w_lo = split(w_enc.float())
    d = torch.float64
    acc = x_lo.to(d) @ w_hi.to(d) + x_hi.to(d) @ w_lo.to(d) + x_hi.to(d) @ w_hi.to(d)
    return torch.relu(acc.float() + b_enc.float())


def _window_geometry(T: int, window: int):
    """(stride, num_windows, n_chunks) of the vote kernel; even windows
    only (two stride-chunks a window)."""
    stride, num_windows, _, t_padded = _overlap_geometry(T, window)
    if window != 2 * stride:
        raise ValueError(f"window_vote_fused needs an even window, got {window}")
    return stride, num_windows, -(-t_padded // stride)


def _kth_bits_bf16(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Each row's k-th value's int16 bit pattern (as int32), by the TPU
    kernel's 15 halvings of [0, 0x7F80)."""
    lo = torch.zeros(bits.shape[:-1] + (1,), dtype=torch.int32, device=bits.device)
    hi = torch.full_like(lo, 0x7F80)  # bf16 +inf bits
    for _ in range(15):
        mid = lo + ((hi - lo) >> 1)
        keep = (bits >= mid).sum(-1, keepdim=True) >= k
        lo = torch.where(keep, mid, lo)
        hi = torch.where(keep, hi, mid)
    return lo


def kth_bits_bf16_radix_emulated(bits: torch.Tensor, k: int) -> torch.Tensor:
    """The vote kernel's radix select on the CPU (tests only): the same lo
    as ``_kth_bits_bf16``'s 15 halvings, for rows of sign-extended int16
    patterns (as int32) [..., M].  Candidates are the patterns >= 1; two
    digit passes (``VOTE_RADIX_PASSES``: bits 14-7 in 256 bins, then bits
    6-0 in 128) each histogram the candidates' digit, take the bin holding
    the remaining rank counted from the top and keep its candidates.  lo =
    min(b_k, 0x7F7F), b_k the k-th largest candidate, or 0 for a row with
    fewer than k candidates."""
    flat = bits.reshape(-1, bits.shape[-1]).long()
    cand = flat >= 1
    short = cand.sum(-1) < k
    prefix = torch.zeros(flat.shape[0], dtype=torch.long, device=flat.device)
    rank = torch.full_like(prefix, k)
    for shift, width in VOTE_RADIX_PASSES:
        digit = (flat >> shift) & ((1 << width) - 1)
        hist = torch.zeros(flat.shape[0], 1 << width, dtype=torch.long, device=flat.device)
        hist.scatter_add_(1, torch.where(cand, digit, 0), cand.long())
        at_or_above = hist.flip(-1).cumsum(-1).flip(-1)
        above = at_or_above - hist
        pick = ((above < rank[:, None]) & (at_or_above >= rank[:, None])).long().argmax(-1)
        rank = rank - above.gather(1, pick[:, None])[:, 0]
        prefix = prefix | (pick << shift)
        cand = cand & (digit == pick[:, None])
    lo = torch.where(short, 0, torch.clamp(prefix, max=0x7F7F)).to(torch.int32)
    return lo.reshape(bits.shape[:-1] + (1,))


def vote_stripes(B: int, n_chunks: int, blocks: int = VOTE_BLOCKS):
    """The vote kernel's work split: block b of ``blocks`` takes the
    (utterance, chunk) pairs [B n_chunks b / blocks, B n_chunks (b + 1) /
    blocks) in utterance-major order; yields each block's stripes as
    (block, utterance, c0, c1)."""
    total = B * n_chunks
    grid = min(blocks, total)
    for b in range(grid):
        r, r1 = total * b // grid, total * (b + 1) // grid
        while r < r1:
            u, c0 = divmod(r, n_chunks)
            c1 = min(n_chunks, c0 + r1 - r)
            yield b, u, c0, c1
            r += c1 - c0


def window_vote_stripes_emulated(acts: torch.Tensor, k: int, window: int,
                                 blocks: int = VOTE_BLOCKS) -> torch.Tensor:
    """The vote kernel's walk on the CPU (tests only): each stripe [c0, c1)
    of ``vote_stripes`` on its own, with chunk c0 - 1 and chunk c1 read
    for their sums alone where a window needs them; chunk sums in fp32
    from 0.f in frame order, frames >= T never read; window and frame
    thresholds by ``kth_bits_bf16_radix_emulated``; frames after the last
    window's written as zeros.  Equals ``window_vote_fused_plain`` bit for
    bit on inputs without -0.0 (the plain version's chunk sum starts from
    the first frame, not from 0.f)."""
    B, T, M = acts.shape
    stride, nw, n_chunks = _window_geometry(T, window)
    a = acts.to(torch.bfloat16)
    out = torch.full((B, T, M), float("nan"))

    def frames(u, c):  # chunk c's frames below T, bf16
        return a[u, c * stride:min((c + 1) * stride, T)]

    for _, u, c0, c1 in vote_stripes(B, n_chunks, blocks):
        if c0 <= nw:
            j0, j1 = max(c0 - 1, 0), min(c1 + 1, nw + 1)
            sums = {}
            for j in range(j0, j1):
                acc = torch.zeros(M)
                for f in frames(u, j).float():
                    acc = acc + f
                sums[j] = acc
            masks = {}
            for i in range(j0, j1 - 1):
                wbits = (sums[i] + sums[i + 1]).to(torch.bfloat16).view(torch.int16).int()
                masks[i] = wbits >= kth_bits_bf16_radix_emulated(wbits[None], k)[0]
            zero = torch.zeros(M, dtype=torch.bool)
            for c in range(c0, min(c1, nw + 1)):
                cover = (masks.get(c - 1, zero).to(torch.bfloat16)
                         + masks.get(c, zero).to(torch.bfloat16))
                a_c = frames(u, c)
                vbits = (a_c * cover).view(torch.int16).int()
                lo = kth_bits_bf16_radix_emulated(vbits, k)
                keep = (vbits >= lo) & (vbits > 0)
                out[u, c * stride:c * stride + a_c.shape[0]] = torch.where(keep, a_c, 0).float()
        for t in range(max(c0, nw + 1) * stride, min(c1 * stride, T)):
            out[u, t] = 0.0
    return out


def window_vote_fused_plain(acts: torch.Tensor, k: int, window: int) -> torch.Tensor:
    """Plain version of ``window_vote_fused``, in the TPU kernel's bf16
    arithmetic: acts [B, T, M] post-ReLU -> [B, T, M] fp32 holding bf16
    values."""
    B, T, M = acts.shape
    stride, num_windows, n_chunks = _window_geometry(T, window)
    a = acts.to(torch.bfloat16)
    # bf16 window sums of fp32 chunk sums (frame order), each window's
    # k-th value, and its mask
    chunks = torch.nn.functional.pad(a, (0, 0, 0, n_chunks * stride - T))
    chunks = chunks.reshape(B, n_chunks, stride, M).float()
    chunk_sums = chunks[:, :, 0]
    for r in range(1, stride):
        chunk_sums = chunk_sums + chunks[:, :, r]
    window_sums = (chunk_sums[:, :num_windows] + chunk_sums[:, 1:num_windows + 1]
                   ).to(torch.bfloat16)
    bits = window_sums.view(torch.int16).int()
    mask_w = (bits >= _kth_bits_bf16(bits, k)).to(torch.bfloat16)
    # cover[j] = mask_w[j - 1] + mask_w[j], over valid windows
    pad = n_chunks - num_windows
    cover = (torch.nn.functional.pad(mask_w, (0, 0, 0, pad))
             + torch.nn.functional.pad(mask_w, (0, 0, 1, pad - 1)))  # [B, n_chunks, M]
    votes = a * cover.repeat_interleave(stride, dim=1)[:, :T]  # exact: cover is 0, 1 or 2
    bits = votes.view(torch.int16).int()
    keep = (bits >= _kth_bits_bf16(bits, k)) & (bits > 0)
    return torch.where(keep, a, 0).float()


# -- kernel launches ----------------------------------------------------------
#
# Each ``_<op>_cuda`` checks its operands, launches its kernel on the
# current stream and adds one to its wrapper's ``launches``; it is the
# ``cuda`` implementation of the custom op below it.


def _encode_topk_cuda(x, w_enc, b_enc, b_dec, k: int) -> torch.Tensor:
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
    # the cast pass's bf16 operands: centred x [N, D] and W_enc^T [M, D]
    scratch = torch.empty((n + m) * d, dtype=torch.bfloat16, device=x.device)
    fn = _lib("sae_encode_topk", "sae_encode_topk_launch", [_P] * 6 + [_I] * 4 + [_P])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w_enc.data_ptr(), b_enc.data_ptr(), b_dec.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), n, d, m, k, stream)
    build.check(err, "sae_encode_topk")
    build.count_launch(sae_encode_topk_fused)
    return out


def _encode_cuda(x, w_enc, b_enc, b_dec) -> torch.Tensor:
    n, d = x.shape
    m = w_enc.shape[1]
    for t, name, shape in ((x, "x", (n, d)), (w_enc, "w_enc", (d, m)),
                           (b_enc, "b_enc", (m,)), (b_dec, "b_dec", (d,))):
        _check_operand(t, name, shape, x.device)
    if d % 32 or m % 128:
        raise ValueError(f"need D % 32 == 0 and M % 128 == 0, got D={d}, M={m}")
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    scratch = torch.empty(2 * (n + m) * d, dtype=torch.float32, device=x.device)
    fn = _lib("sae_encode", "sae_encode_launch", [_P] * 6 + [_I] * 3 + [_P])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w_enc.data_ptr(), b_enc.data_ptr(), b_dec.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), n, d, m, stream)
    build.check(err, "sae_encode")
    build.count_launch(sae_encode_fused)
    return out


def _window_vote_cuda(acts, k: int, window: int) -> torch.Tensor:
    B, T, M = acts.shape
    stride, num_windows, n_chunks = _window_geometry(T, window)
    _check_operand(acts, "acts", (B, T, M), acts.device)
    if not 1 <= k <= M:
        raise ValueError(f"k must be in [1, {M}], got {k}")
    if M * 4 > 227 * 1024:
        raise ValueError(f"M={M} rows exceed a block's shared memory")
    out = torch.empty_like(acts)
    if B == 0:
        return out
    fn = _lib("window_vote", "window_vote_launch", [_P] * 2 + [_I] * 7 + [_P])
    with torch.cuda.device(acts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(acts.data_ptr(), out.data_ptr(), B, T, M, k, stride, num_windows, n_chunks,
                 stream)
    build.check(err, "window_vote")
    build.count_launch(window_vote_fused)
    return out


def _decode_cuda(codes, w_dec, b_dec) -> torch.Tensor:
    n, m = codes.shape
    d = w_dec.shape[1]
    for t, name, shape in ((codes, "codes", (n, m)), (w_dec, "w_dec", (m, d)),
                           (b_dec, "b_dec", (d,))):
        _check_operand(t, name, shape, codes.device)
    if m % 4 or d % 4:
        raise ValueError(f"need M % 4 == 0 and D % 4 == 0, got M={m}, D={d}")
    out = torch.empty((n, d), dtype=torch.float32, device=codes.device)
    if n == 0:
        return out
    fn = _lib("sae_decode", "sae_decode_launch", [_P] * 4 + [_I] * 3 + [_P])
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(codes.data_ptr(), w_dec.data_ptr(), b_dec.data_ptr(), out.data_ptr(),
                 n, m, d, stream)
    build.check(err, "sae_decode")
    build.count_launch(sae_decode_fused)
    return out


# -- custom ops ---------------------------------------------------------------
#
# Rows 1, 2, 3 and 5 as ``sls_tpu_torch::*`` custom ops (``kernels/ops.py``):
# the launches above on a CUDA tensor, the plain versions on a CPU one.

_SAE_ARGS = "Tensor x, Tensor w_enc, Tensor b_enc, Tensor b_dec"

_encode_topk_op = define(
    "sae_encode_topk", f"({_SAE_ARGS}, int k) -> Tensor", cuda=_encode_topk_cuda,
    cpu=lambda x, w_enc, b_enc, b_dec, k: sae_encode_topk_fused_plain(x, w_enc, b_enc, b_dec, k),
    fake=lambda x, w_enc, b_enc, b_dec, k: x.new_empty((x.shape[0], w_enc.shape[1]),
                                                       dtype=torch.float32))
_encode_op = define(
    "sae_encode", f"({_SAE_ARGS}) -> Tensor", cuda=_encode_cuda,
    cpu=lambda x, w_enc, b_enc, b_dec: sae_encode_fused_plain(x, w_enc, b_enc, b_dec),
    fake=lambda x, w_enc, b_enc, b_dec: x.new_empty((x.shape[0], w_enc.shape[1]),
                                                    dtype=torch.float32))
_window_vote_op = define(
    "window_vote", "(Tensor acts, int k, int window) -> Tensor", cuda=_window_vote_cuda,
    cpu=lambda acts, k, window: window_vote_fused_plain(acts, k, window),
    fake=lambda acts, k, window: torch.empty_like(acts))
_decode_op = define(
    "sae_decode", "(Tensor codes, Tensor w_dec, Tensor b_dec) -> Tensor", cuda=_decode_cuda,
    cpu=lambda codes, w_dec, b_dec: sae_decode_fused_plain(codes, w_dec, b_dec),
    fake=lambda codes, w_dec, b_dec: codes.new_empty((codes.shape[0], w_dec.shape[1]),
                                                     dtype=torch.float32))


def _kernel_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {t.device}")


# -- wrappers ---------------------------------------------------------------


def sae_encode_topk_fused(x, w_enc, b_enc, b_dec, k: int) -> torch.Tensor:
    """Sparse codes = topk_mask(relu((x - b_dec) @ w_enc + b_enc), k);
    x [N, D] -> [N, M] fp32, through ``sls_tpu_torch::sae_encode_topk``.
    CUDA: D % 32 == 0, M % 128 == 0, fp32 contiguous operands; the cast
    pass takes (N + M) D bf16 of scratch a call."""
    _kernel_device(x)
    return _encode_topk_op(x, w_enc, b_enc, b_dec, int(k))


sae_encode_topk_fused.launches = 0


def sae_encode_fused(x, w_enc, b_enc, b_dec) -> torch.Tensor:
    """relu((x - b_dec) @ w_enc + b_enc) in fp32, x [N, D] -> [N, M],
    through ``sls_tpu_torch::sae_encode``.  CUDA: D % 32 == 0,
    M % 128 == 0, fp32 contiguous operands; the kernel's split operands
    take 2 (N + M) D fp32 of scratch a call."""
    _kernel_device(x)
    return _encode_op(x, w_enc, b_enc, b_dec)


sae_encode_fused.launches = 0


def topk_sparsify(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep each row's k largest entries, zero the rest: the exact
    threshold form on non-negative fp32 rows, x [..., M].  CUDA: fp32
    contiguous.  Not a custom op: no serving path calls it."""
    if x.device.type == "cpu":
        return topk_threshold_mask_plain(x.reshape(-1, x.shape[-1]), k).reshape(x.shape)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    m = x.shape[-1]
    _check_operand(x, "x", x.shape, x.device)
    if not 1 <= k <= m:
        raise ValueError(f"k must be in [1, {m}], got {k}")
    if m * 4 > 227 * 1024:
        raise ValueError(f"M={m} rows exceed a block's shared memory")
    out = torch.empty_like(x)
    n = x.numel() // m
    if n == 0:
        return out
    fn = _lib("sae_encode_topk", "topk_sparsify_launch", [_P] * 2 + [_I] * 3 + [_P])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), n, m, k, stream)
    build.check(err, "topk_sparsify")
    build.count_launch(topk_sparsify)
    return out


topk_sparsify.launches = 0


def window_vote_fused(acts: torch.Tensor, k: int, window: int) -> torch.Tensor:
    """Overlap-window vote merge of post-ReLU acts [B, T, M] fp32 in the
    TPU kernel's bf16 arithmetic -> [B, T, M] fp32; even ``window``
    only; through ``sls_tpu_torch::window_vote``.  CUDA: fp32 contiguous
    acts."""
    _kernel_device(acts)
    return _window_vote_op(acts, int(k), int(window))


window_vote_fused.launches = 0


def sae_decode_fused(codes, w_dec, b_dec) -> torch.Tensor:
    """codes @ w_dec + b_dec for codes [N, M] -> [N, D], fp32, through
    ``sls_tpu_torch::sae_decode``.  CUDA: M % 4 == 0 and D % 4 == 0, fp32
    contiguous operands; zero codes are skipped."""
    _kernel_device(codes)
    return _decode_op(codes, w_dec, b_dec)


sae_decode_fused.launches = 0


# -- autograd Functions -------------------------------------------------------


def encode_backward(x, w_enc, b_dec, out, g):
    """The reference's VJP of both fused encodes (``_encode_bwd``):
    (d_x, d_W_enc, d_b_enc, d_b_dec) for codes ``out`` [N, M] of x [N, D]
    and the cotangent g [N, M], in fp32."""
    g_pre = torch.where(out > 0, g.float(), 0.0)
    d_x = g_pre @ w_enc.float().t()
    d_w = (x.float() - b_dec.float()).t() @ g_pre
    return d_x, d_w, g_pre.sum(0), -d_x.sum(0)


def decode_backward(codes, w_dec, g):
    """The reference's VJP of the decode (``_sae_decode_bwd``): (d_codes,
    d_W_dec, d_b_dec) for the cotangent g [N, D], in fp32."""
    g = g.float()
    return g @ w_dec.float().t(), codes.float().t() @ g, g.sum(0)


class _EncodeTopK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_enc, b_enc, b_dec, k):
        out = sae_encode_topk_fused(x, w_enc, b_enc, b_dec, k)
        ctx.save_for_backward(x, w_enc, b_dec, out)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*encode_backward(*ctx.saved_tensors, g), None)


class _EncodeRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_enc, b_enc, b_dec):
        out = sae_encode_fused(x, w_enc, b_enc, b_dec)
        ctx.save_for_backward(x, w_enc, b_dec, out)
        return out

    @staticmethod
    def backward(ctx, g):
        return encode_backward(*ctx.saved_tensors, g)


class _Decode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, codes, w_dec, b_dec):
        ctx.save_for_backward(codes, w_dec)
        return sae_decode_fused(codes, w_dec, b_dec)

    @staticmethod
    def backward(ctx, g):
        return decode_backward(*ctx.saved_tensors, g)


class _WindowVote(torch.autograd.Function):
    @staticmethod
    def forward(ctx, acts, k, window):
        out = window_vote_fused(acts, k, window)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return torch.where(out > 0, g, 0.0), None, None


def sae_encode_topk(x, w_enc, b_enc, b_dec, k: int) -> torch.Tensor:
    """Differentiable ``sae_encode_topk_fused`` (the reference's
    ``sae_encode_topk``): the top-k mask is a constant of the backward,
    which sees the kept entries' encode as fp32 and unrounded."""
    return _EncodeTopK.apply(x, w_enc, b_enc, b_dec, k)


def sae_encode_relu(x, w_enc, b_enc, b_dec) -> torch.Tensor:
    """Differentiable ``sae_encode_fused``, the ReLU mask taken from its
    output (the reference's ``sae_encode_relu``)."""
    return _EncodeRelu.apply(x, w_enc, b_enc, b_dec)


def sae_decode(codes, w_dec, b_dec) -> torch.Tensor:
    """Differentiable ``sae_decode_fused`` (the reference's ``sae_decode``)."""
    return _Decode.apply(codes, w_dec, b_dec)


def window_topk_overlap(acts, k: int, window: int) -> torch.Tensor:
    """Differentiable ``window_vote_fused`` (the reference's
    ``window_topk_overlap_pallas``): d_acts = g where the output is
    positive, else 0."""
    return _WindowVote.apply(acts, k, window)
