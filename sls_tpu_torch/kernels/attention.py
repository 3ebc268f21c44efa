"""Attention kernels: wrappers over ``csrc/attention.cu``, with plain versions.

Counterpart of ``sls_tpu/kernels/flash_attention.py`` and
``sls_tpu/kernels/attention.py``.  Their Pallas kernels compute one
function, softmax(q kᵀ) v per head with an fp32 softmax, the
probabilities rounded to v's dtype and fp32 sums, and differ only in
layout and grid.  So one CUDA kernel, which reads q, k and v in place as
``[B, T, H*64]``, serves four wrappers with the reference's names and
contracts:

- ``flash_attention_long(q, k, v, num_heads, block_q=256)`` on
  ``[B, Tq, C]`` / ``[B, Tkv, C]``, the long-T eval route;
- ``sp_flash_attention_long(q, k, v, num_heads, group, block_q=256)`` on
  each rank's ``[B, T / n, C]`` shards, the sequence-parallel long-T
  route: k and v are all-gathered over the sequence axis's process group
  (a library collective, as the reference's ``all_gather`` lies outside
  its Pallas body), then the kernel runs on the local q strip;
- ``fused_attention(q, k, v)`` on ``[B, T, H, Dh]``, the
  ``XLSRConfig.fused_attention`` route;
- ``fused_attention_heads(q, k, v, num_heads, h_blk=2)`` on
  ``[B, T, C]``, which no path calls (the reference's tests do);
- ``flash_attention_long_relpos(q, k, v, gate, table, num_heads)``, the
  long form with WavLM's gated relative-position bias
  ``g[b, h, i] * table[h, j - i + T - 1]`` added to the fp32 scores
  (``attention_long_relpos_kernel``, a symbol of its own); it has no TPU
  counterpart, as the JAX package runs no WavLM.

q comes pre-scaled by Dh^-0.5.  The CUDA kernel takes bf16 or fp32 at
Dh 64 and its own q tiles (64 rows a warpgroup), so ``block_q`` and
``h_blk`` only keep the reference's checks.  In bf16 it has two forms,
chosen by Tkv (``attention_form``): at Tkv <= ``SHORT_KV`` the whole
score strip of a q tile sits in registers and p is rounded to bf16 where
the reference rounds it; above, one pass over ``BLOCK_KV``-key tiles with
an online softmax rounds the unnormalised p~ instead, which
``attention_online_emulated`` repeats in plain PyTorch (no path calls
it; the tests and ``chip_smoke.py`` hold the kernel to it).  Each
wrapper takes its plain PyTorch version (``*_plain``, beside it) for a
tensor on the CPU, and launches the kernel for a CUDA tensor or raises;
there is no fallback.  ``<wrapper>.launches`` counts kernel launches.
``fused_attention``, the one a fixed-shape serving forward reaches, goes
through the custom op ``sls_tpu_torch::fused_attention``
(``kernels/ops.py``), so that ``torch.export`` keeps the kernel in a
serving program.  ``attention_reference`` and ``sp_block_q`` are own
copies of the reference's helpers.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sls_tpu_torch.kernels import build
from sls_tpu_torch.kernels.ops import define
from sls_tpu_torch.parallel.distributed import all_gather_cat

_P = ctypes.c_void_p
_I = ctypes.c_int
HEAD_DIM = 64  # the head dim the CUDA kernel takes (XLS-R's)
SHORT_KV = 256  # bf16 keys at or below: the kernel's whole-strip form
BLOCK_KV = 128  # the long form's keys a tile


def attention_form(t_kv: int) -> str:
    """The form the bf16 kernel takes for ``t_kv`` keys."""
    return "short" if t_kv <= SHORT_KV else "long"


# -- plain versions ---------------------------------------------------------


def relpos_dense(table: torch.Tensor, t: int) -> torch.Tensor:
    """A bias-by-distance table [H, 2t - 1] as [H, t, t]: entry (h, i, j)
    is ``table[h, j - i + t - 1]``."""
    pos = torch.arange(t, device=table.device)
    return table[:, pos[None, :] - pos[:, None] + t - 1]


def _attention_plain(q, k, v, num_heads: int, bias=None) -> torch.Tensor:
    """softmax(q kᵀ + bias) v per head, in explicit fp32: exact products
    of the operands summed in fp32 (TF32 must be off, PyTorch's default
    for matmul), an fp32 softmax, the probabilities rounded to v's dtype,
    fp32 sums again, and the result cast to q's dtype.  q [B, Tq, C],
    k and v [B, Tkv, C]; ``bias`` fp32, broadcast to [B, H, Tq, Tkv]."""
    B, Tq, C = q.shape
    Tkv = k.shape[1]
    dh = C // num_heads

    def heads(x, t):
        return x.float().reshape(B, t, num_heads, dh).transpose(1, 2)

    scores = heads(q, Tq) @ heads(k, Tkv).transpose(-1, -2)
    probs = torch.softmax(scores if bias is None else scores + bias, dim=-1)
    ctx = probs.to(v.dtype).float() @ heads(v, Tkv)
    return ctx.transpose(1, 2).reshape(B, Tq, C).to(q.dtype)


def flash_attention_long_plain(q, k, v, num_heads: int) -> torch.Tensor:
    """Plain version of ``flash_attention_long``."""
    return _attention_plain(q, k, v, num_heads)


def flash_attention_long_relpos_plain(q, k, v, gate, table, num_heads: int) -> torch.Tensor:
    """Plain version of ``flash_attention_long_relpos``: the bias
    materialized as [B, H, T, T]."""
    return _attention_plain(q, k, v, num_heads,
                            gate[..., None] * relpos_dense(table, q.shape[1]))


def _gather_kv(k, v, group):
    """Every frame's k and v from the group's ``[B, T_loc, C]`` shards, in
    one collective: contiguous ``[B, T, C]`` each (the two halves of one
    ``[2, B, T, C]`` buffer)."""
    return all_gather_cat(torch.stack([k, v]), group, dim=2).unbind(0)


def sp_flash_attention_long_plain(q, k, v, num_heads: int, group=None) -> torch.Tensor:
    """Plain version of ``sp_flash_attention_long``: gather, then the
    plain attention of the local q strip."""
    if group is not None:
        k, v = _gather_kv(k, v, group)
    return _attention_plain(q, k, v, num_heads)


def fused_attention_plain(q, k, v) -> torch.Tensor:
    """Plain version of ``fused_attention``: [B, T, H, Dh] in and out."""
    B, T, H, Dh = q.shape
    return _attention_plain(q.reshape(B, T, H * Dh), k.reshape(B, T, H * Dh),
                            v.reshape(B, T, H * Dh), H).reshape(B, T, H, Dh)


def fused_attention_heads_plain(q, k, v, num_heads: int) -> torch.Tensor:
    """Plain version of ``fused_attention_heads``."""
    return _attention_plain(q, k, v, num_heads)


def attention_online_emulated(q, k, v, num_heads: int, block_kv: int = BLOCK_KV,
                              short_kv: int = SHORT_KV, gate=None, table=None) -> torch.Tensor:
    """The bf16 kernel's numerics in plain PyTorch, rounding where it
    rounds.  At Tkv <= ``short_kv`` that is the plain version.  Above, it
    is one pass over ``block_kv``-key tiles in order: per row a running max
    m and sum l in fp32, p~ = exp(s - m) rounded to v's dtype for the
    product with v, the fp32 sum o rescaled by exp(m_old - m_new) as the
    max moves, and o / l at the end, cast to q's dtype.  With ``gate`` and
    ``table`` it is the biased form, which takes the long form at every
    Tkv: each tile's scores get the bias before the max."""
    B, Tq, C = q.shape
    Tkv = k.shape[1]
    bias = None if gate is None else gate[..., None] * relpos_dense(table, Tq)
    if Tkv <= short_kv and bias is None:
        return _attention_plain(q, k, v, num_heads)
    dh = C // num_heads

    def heads(x, t):
        return x.float().reshape(B, t, num_heads, dh).transpose(1, 2)

    qh, kh, vh = heads(q, Tq), heads(k, Tkv), heads(v, Tkv)
    m = torch.full((B, num_heads, Tq, 1), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros(B, num_heads, Tq, dh, device=q.device)
    for j in range(0, Tkv, block_kv):
        s = qh @ kh[:, :, j:j + block_kv].transpose(-1, -2)
        if bias is not None:
            s = s + bias[..., j:j + block_kv]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(v.dtype).float() @ vh[:, :, j:j + block_kv]
        m = m_new
    return (o / l).transpose(1, 2).reshape(B, Tq, C).to(q.dtype)


def attention_reference(q, k, v, num_heads: int) -> torch.Tensor:
    """The reference's einsum attention with the [B, T, C] contract: the
    scores in the operands' dtype, then an fp32 softmax."""
    B, T, C = q.shape
    dh = C // num_heads
    qh, kh, vh = (x.reshape(B, T, num_heads, dh) for x in (q, k, v))
    scores = torch.einsum("bthd,bshd->bhts", qh, kh).float()
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhts,bshd->bthd", probs.to(vh.dtype), vh)
    return ctx.reshape(B, T, C)


def sp_block_q(t_local: int, preferred: int = 256, minimum: int = 128) -> Optional[int]:
    """Largest q-block <= ``preferred`` dividing the local shard length,
    or None when the shard is too ragged (the sequence-parallel route's
    gate)."""
    b = preferred
    while b >= minimum:
        if t_local % b == 0:
            return b
        b //= 2
    return None


# -- the kernel --------------------------------------------------------------


def _attention_cuda(q, k, v, num_heads: int, gate=None, table=None,
                    flat: Optional[int] = None) -> torch.Tensor:
    """Launch ``csrc/attention.cu`` on q [B, Tq, C], k and v [B, Tkv, C],
    or on the same memory as [B, T, H, Dh] (``fused_attention`` passes it
    without views); the output takes q's shape.  With ``gate`` [B, H, T]
    and ``table`` [H, 2T - 1] (fp32, contiguous; Tq = Tkv = T) the biased
    form: ``flat``, where given, is a distance from which the table holds
    one value a side (the kernel then skips its reads on tiles wholly
    beyond it).  The checks read each attribute once: at the T 201 shape
    the host's share of a call is of the kernel's order."""
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    qs, ks = q.shape, k.shape
    if len(qs) not in (3, 4) or len(ks) != len(qs) or v.dim() != len(qs):
        raise ValueError("q, k and v must be [B, T, C]")
    B, Tq, Tkv = qs[0], qs[1], ks[1]
    if ks[0] != B or ks[2:] != qs[2:] or v.shape != ks:
        raise ValueError(f"k {tuple(ks)} and v {tuple(v.shape)} do not match "
                         f"q {tuple(qs)}")
    C = qs[2] * qs[3] if len(qs) == 4 else qs[2]
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM}; got C={C} over "
                         f"{num_heads} heads")
    dtype, device = q.dtype, q.device
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bfloat16 or float32, got {dtype}")
    ptrs = []
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        ptrs.append(t.data_ptr())
        if ptrs[-1] % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if gate is not None:
        if Tq != Tkv:
            raise ValueError(f"the relative-position bias needs Tq == Tkv; got {Tq}, {Tkv}")
        for t, name, shape in ((gate, "gate", (B, num_heads, Tq)),
                               (table, "table", (num_heads, 2 * Tq - 1))):
            if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous float32 {shape}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}, expected {device}")
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0 or Tq == 0:
        return out
    if Tkv == 0:
        raise ValueError("attention over no keys")
    stream = torch.cuda.current_stream(device).cuda_stream
    is_bf16 = int(dtype == torch.bfloat16)
    if gate is None:
        launch = _launcher("attention_launch")
        args = (*ptrs, out.data_ptr(), B, Tq, Tkv, num_heads, is_bf16, stream)
    else:
        launch = _launcher("attention_relpos_launch")
        args = (*ptrs, gate.data_ptr(), table.data_ptr(), out.data_ptr(), B, Tq, num_heads,
                flat if flat is not None else NO_FLAT, is_bf16, stream)
    if device.index == torch.cuda.current_device():
        err = launch(*args)
    else:  # the kernel launches on the current device
        with torch.cuda.device(device):
            err = launch(*args)
    build.check(err, "attention")
    return out


NO_FLAT = 1 << 30  # a ``flat`` distance no tile reaches


# the entries of the built library and their arguments
_ARGTYPES = {"attention_launch": [_P] * 4 + [_I] * 5 + [_P],
             "attention_relpos_launch": [_P] * 6 + [_I] * 5 + [_P]}


def _launcher(name: str):
    """Entry ``name`` of the built library, typed once a process (the
    short form's kernel takes about 0.05 ms, so the host's share of a
    call matters)."""
    fn = _launcher.fns.get(name)
    if fn is None:
        fn = getattr(build.load("attention"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _launcher.fns[name] = fn
    return fn


_launcher.fns = {}


# -- wrappers ---------------------------------------------------------------


def flash_attention_long(q, k, v, num_heads: int, block_q: int = 256) -> torch.Tensor:
    """softmax(q kᵀ) v per head; q [B, Tq, C] pre-scaled, k and v
    [B, Tkv, C] (Tq may differ from Tkv), C = num_heads * Dh.  Returns
    [B, Tq, C] in q's dtype.  Tq must be a multiple of ``block_q``, as in
    the reference (the long-T path pads clips to length buckets)."""
    Tq = q.shape[1]
    if Tq % block_q:
        raise ValueError(f"Tq={Tq} not a multiple of block_q={block_q}")
    if q.device.type == "cpu":
        return flash_attention_long_plain(q, k, v, num_heads)
    out = _attention_cuda(q, k, v, num_heads)
    build.count_launch(flash_attention_long)
    return out


flash_attention_long.launches = 0


def flash_attention_long_relpos(q, k, v, gate, table, num_heads: int,
                                flat: Optional[int] = None, block_q: int = 256) -> torch.Tensor:
    """softmax(q kᵀ + g_i · table[h, j − i + T − 1]) v per head: WavLM's
    gated relative-position bias in the long form.  q [B, T, C]
    pre-scaled, k and v [B, T, C]; ``gate`` [B, H, T] and ``table``
    [H, 2T - 1] fp32.  ``flat``: a distance from which the table holds
    one value a side (the caller's promise; the kernel reads no table
    entry for a tile wholly beyond it).  Returns [B, T, C] in q's dtype;
    T must be a multiple of ``block_q``, as for ``flash_attention_long``."""
    if q.shape[1] % block_q:
        raise ValueError(f"T={q.shape[1]} not a multiple of block_q={block_q}")
    if flat is not None and flat < 1:
        raise ValueError(f"flat={flat}: a distance of at least 1")
    if q.device.type == "cpu":
        return flash_attention_long_relpos_plain(q, k, v, gate, table, num_heads)
    out = _attention_cuda(q, k, v, num_heads, gate, table, flat)
    build.count_launch(flash_attention_long_relpos)
    return out


flash_attention_long_relpos.launches = 0


def sp_flash_attention_long(q, k, v, num_heads: int, group=None,
                            block_q: int = 256) -> torch.Tensor:
    """Sequence-parallel long-T attention: q stays local, k and v are
    all-gathered.

    q, k, v: this rank's ``[B, T_loc, C]`` frame shards (q pre-scaled),
    the same shape on every rank of ``group``, the sequence axis's
    process group.  Each rank gathers k and v along frames, stacked so
    that one collective moves both, into contiguous ``[B, T, C]`` and runs
    the kernel on its q strip, so the ``[B, H, T_loc, T]`` scores never
    reach device memory.  The ranks' pieces of a row arrive apart, so the
    gather ends in one copy of the stacked pair (``all_gather_cat``).
    ``group=None`` is a group of one: k and v already hold every frame.
    Returns this rank's ``[B, T_loc, C]`` of the output.

    The q strip must have a block of at least 128 rows dividing it
    (``sp_block_q``); the encoder gates on that and takes the einsum
    route for ragged strips, and a direct caller gets the reference's
    error, raised before the collective so that every rank raises."""
    t_local = q.shape[1]
    if sp_block_q(t_local, preferred=block_q) is None:
        raise ValueError(
            f"local shard length {t_local} has no q-block >=128 dividing it — pad T to "
            "a multiple of 128*n_seq_shards or use the einsum attention for this shape")
    if q.device.type == "cpu":
        return sp_flash_attention_long_plain(q, k, v, num_heads, group)
    if group is not None:
        k, v = _gather_kv(k, v, group)
    out = _attention_cuda(q, k, v, num_heads)
    build.count_launch(sp_flash_attention_long)
    return out


sp_flash_attention_long.launches = 0


def fused_attention(q, k, v) -> torch.Tensor:
    """softmax(q kᵀ) v per (batch, head) on [B, T, H, Dh] (q pre-scaled);
    returns [B, T, H, Dh] in q's dtype."""
    if q.dim() != 4:
        raise ValueError(f"fused_attention takes [B, T, H, Dh], got {tuple(q.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")
    return _fused_attention_op(q, k, v)


fused_attention.launches = 0


def _fused_attention_cuda(q, k, v) -> torch.Tensor:
    shape = q.shape
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [B, T, H, Dh] like q")
    out = _attention_cuda(q, k, v, shape[2])  # [B, T, H, Dh] is [B, T, H*Dh] in memory
    build.count_launch(fused_attention)
    return out


# ``sls_tpu_torch::fused_attention`` (``kernels/ops.py``): the short form on
# a CUDA tensor, the plain version on a CPU one
_fused_attention_op = define(
    "fused_attention", "(Tensor q, Tensor k, Tensor v) -> Tensor",
    cuda=_fused_attention_cuda, cpu=lambda q, k, v: fused_attention_plain(q, k, v),
    fake=lambda q, k, v: torch.empty_like(q, memory_format=torch.contiguous_format))


def fused_attention_heads(q, k, v, num_heads: int, h_blk: int = 2) -> torch.Tensor:
    """softmax(q_h k_hᵀ) v_h per head on [B, T, C] (q pre-scaled); the
    reference groups ``h_blk`` heads a grid cell, and this wrapper keeps
    its check that they divide ``num_heads``."""
    if num_heads % h_blk:
        raise ValueError(f"num_heads={num_heads} not a multiple of h_blk={h_blk}")
    if q.device.type == "cpu":
        return fused_attention_heads_plain(q, k, v, num_heads)
    out = _attention_cuda(q, k, v, num_heads)
    build.count_launch(fused_attention_heads)
    return out


fused_attention_heads.launches = 0
