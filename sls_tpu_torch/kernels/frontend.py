"""The fused conv front-end tail: a wrapper over ``csrc/frontend_tail.cu``,
with its plain version.

Counterpart of ``sls_tpu/kernels/frontend.py``.  ``frontend_tail_fused``
computes, from the raw conv-0 output ``h0`` [B, N0, C] (bias applied, no
norm yet), LN0 + GELU0 and then conv layers 1..L-1, each a VALID
strided conv whose compute-dtype products are summed in fp32, plus the
fp32 bias, an fp32 LayerNorm of the fp32 sum and an fp32 GELU, rounded
to the compute dtype (``h0``'s) at every level.  At bf16 this is not the
unfused encoder route, which rounds each conv output to bf16 before its
bias and norm.

The CUDA kernel takes C = 512 (XLS-R's width) in bf16 or fp32 and tiles
time on its own terms; ``frames_per_tile`` only keeps the reference's
check; ``level_pitches`` gives the bf16 route's padded levels.  The
wrapper calls the custom op ``sls_tpu_torch::frontend_tail``
(``kernels/ops.py``), which takes the plain version for a tensor on the
CPU and launches the kernel for a CUDA tensor or raises; there is no
fallback.  ``frontend_tail_fused.launches`` counts calls that launched.
``tail_lengths``, ``required_input``, ``choose_tile`` and
``fp32_layer_norm`` are own copies of the reference's helpers
(``kernels/layer_norm.py``'s plain version, the encoder's LayerNorm, is
``fp32_layer_norm``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from sls_tpu_torch.kernels import build
from sls_tpu_torch.kernels.ops import define

Spec = Tuple[int, int]  # (kernel, stride) of one tail conv layer

CHANNELS = 512  # the width the CUDA kernel takes (XLS-R's)
DTYPES = (torch.bfloat16, torch.float32)  # the compute dtypes it takes

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


# -- the reference's helpers --------------------------------------------------


def tail_lengths(n0: int, specs: Sequence[Spec]) -> List[int]:
    """Frame count at every level given n0 input frames (VALID convs)."""
    ns = [n0]
    for k, s in specs:
        ns.append((ns[-1] - k) // s + 1)
    return ns


def required_input(frames: int, specs: Sequence[Spec]) -> int:
    """Input frames needed at level 0 to produce ``frames`` final frames."""
    m = frames
    for k, s in reversed(list(specs)):
        m = (m - 1) * s + k
    return m


@functools.lru_cache(maxsize=256)
def choose_tile(
    t_out: int,
    n0: int,
    specs: Sequence[Spec],
    channels: int,
    itemsize: int = 2,
    target_bytes: int = 4 << 20,
    cap_bytes: int = 8 << 20,
) -> Optional[int]:
    """Frames-per-tile F (a divisor of t_out) of the reference's TPU
    tiling, or None when that tiling cannot work.  The port keeps it as
    the fused route's gate, so that both packages take the same route:
    feasible iff the conv-0 output covers the last tile's 8-row-aligned
    halo read, with the scratch closest to ``target_bytes``.  Cached
    (``specs`` a tuple of pairs): the encoder's route rule asks it on
    every eval forward, and its search walks every frame count up to
    t_out (~0.5 ms of host at T 5120)."""
    total_stride = 1
    for _, s in specs:
        total_stride *= s
    best: Optional[Tuple[int, int]] = None
    for f in range(1, t_out + 1):
        if t_out % f:
            continue
        if t_out != f and (f * total_stride) % 8:
            continue
        n_copy = -(-required_input(f, specs) // 8) * 8
        if (t_out - f) * total_stride + n_copy > n0:
            continue
        scratch = n_copy * channels * itemsize
        if scratch > cap_bytes:
            continue
        score = abs(scratch - target_bytes)
        if best is None or score < best[0]:
            best = (score, f)
    return None if best is None else best[1]


def level_pitches(n0: int, specs: Sequence[Spec]) -> List[int]:
    """Frames stored per utterance at every level on the bf16 route.  A
    level that feeds a conv of stride s is padded to a multiple of s, so
    that the kernel reads it as rows of s frames; the last is not padded.
    The pad frames are never written; they are read only for output rows
    past the level's end, which are not stored."""
    ns = tail_lengths(n0, specs)
    return [-(-n // s) * s for n, (_, s) in zip(ns, specs)] + [ns[-1]]


def fp32_layer_norm(xf: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """flax ``nn.LayerNorm`` fast-variance math over the trailing axis
    (E[x^2] - E[x]^2 clamped at 0), on fp32 input."""
    mean = xf.mean(-1, keepdim=True)
    mean2 = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return (xf - mean) * torch.rsqrt(var + eps) * scale + bias


# -- plain version ------------------------------------------------------------


def frontend_tail_fused_plain(h0, weights, bias_stack, ln_scale, ln_bias, *,
                              specs: Sequence[Spec], approx_gelu: bool,
                              out_dtype=torch.bfloat16, eps: float = 1e-5,
                              sum_dtype=torch.float32) -> torch.Tensor:
    """What the TPU kernel computes: [B, N0, C] -> [B, T_out, C].  The
    convs run in fp32 on the compute-dtype-rounded operands (exact
    products, fp32 sums; cuDNN's TF32 must be off on a card).
    ``sum_dtype=torch.float64`` sums in fp64 and rounds the sums to fp32:
    the same function under another rounding of the sums, whose distance
    from the fp32 version is the noise a kernel is held to at bf16."""
    cdt = h0.dtype
    gelu = "tanh" if approx_gelu else "none"
    scale, shift = ln_scale.float(), ln_bias.float()
    h = F.gelu(fp32_layer_norm(h0.float(), scale[0], shift[0], eps), approximate=gelu).to(cdt)
    for i, (k, s) in enumerate(specs):
        w = weights[i].to(cdt).to(sum_dtype).permute(2, 1, 0)  # WIO -> [out, in, k]
        acc = F.conv1d(h.to(sum_dtype).transpose(1, 2), w, stride=s).transpose(1, 2).float()
        acc = acc + bias_stack[i].float()
        h = F.gelu(fp32_layer_norm(acc, scale[i + 1], shift[i + 1], eps),
                   approximate=gelu).to(cdt)
    return h.to(out_dtype)


# -- the kernel ---------------------------------------------------------------


def _entry(name: str, argtypes):
    fn = getattr(build.load("frontend_tail"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _frontend_cuda(h0, weights, bias_stack, ln_scale, ln_bias, specs, approx_gelu, eps):
    """One LN0 + GELU0 launch that reads ``h0`` through its strides, then
    one launch per tail layer; at bf16 the levels between are stored with
    ``level_pitches`` frames an utterance."""
    dev, cdt = h0.device, h0.dtype
    B, n0, c = h0.shape
    if c != CHANNELS:
        raise ValueError(f"the kernel takes {CHANNELS} channels, got {c}")
    if cdt not in DTYPES:
        raise TypeError(f"the kernel takes bfloat16 or float32, got {cdt}")
    n_layers = len(specs) + 1
    for t, name, shape in ((bias_stack, "bias_stack", (n_layers - 1, c)),
                           (ln_scale, "ln_scale", (n_layers, c)),
                           (ln_bias, "ln_bias", (n_layers, c))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    bias = bias_stack.float().contiguous()
    scale, shift = ln_scale.float().contiguous(), ln_bias.float().contiguous()
    ws = []
    for w, (k, _) in zip(weights, specs):
        if w.device != dev or tuple(w.shape) != (k, c, c):
            raise ValueError(f"a tail weight is {tuple(w.shape)} on {w.device}, "
                             f"expected {(k, c, c)} on {dev}")
        # bf16: W^T [C, k*C] (columns: tap, in channel), K-major for wgmma;
        # fp32: WIO [k*C, C]
        w = w.to(cdt).permute(2, 0, 1) if cdt == torch.bfloat16 else w.to(cdt)
        w = w.contiguous()
        if w.data_ptr() % 16:
            raise ValueError("a tail weight must be 16-byte aligned")
        ws.append(w)

    ln0 = _entry("frontend_ln0_launch",
                 [_P, _P, _I, _I, _I, _L, _L, _L, _P, _P, _F, _I, _I, _P])
    conv = _entry("frontend_conv_launch", [_P] * 6 + [_I] * 7 + [_F, _I, _I, _P])
    is_bf16 = int(cdt == torch.bfloat16)
    lengths = tail_lengths(n0, specs)
    pitches = level_pitches(n0, specs) if is_bf16 else lengths
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        h = torch.empty(B, pitches[0], c, device=dev, dtype=cdt)
        sb, sn, sc = h0.stride()
        build.check(ln0(h0.data_ptr(), h.data_ptr(), B, n0, pitches[0], sb, sn, sc,
                        scale.data_ptr(), shift.data_ptr(), eps, int(approx_gelu), is_bf16,
                        stream), "frontend_ln0")
        for i, ((k, s), w) in enumerate(zip(specs, ws)):
            out = torch.empty(B, pitches[i + 1], c, device=dev, dtype=cdt)
            build.check(conv(h.data_ptr(), w.data_ptr(), bias[i].data_ptr(),
                             scale[i + 1].data_ptr(), shift[i + 1].data_ptr(), out.data_ptr(),
                             B, lengths[i], pitches[i], lengths[i + 1], pitches[i + 1], k, s,
                             eps, int(approx_gelu), is_bf16, stream),
                        f"frontend_conv layer {i + 1}")
            h = out
    return h


# -- wrapper ------------------------------------------------------------------


def frontend_tail_fused(h0, weights, bias_stack, ln_scale, ln_bias, *,
                        specs: Sequence[Spec], approx_gelu: bool,
                        out_dtype=torch.bfloat16, eps: float = 1e-5,
                        frames_per_tile: Optional[int] = None) -> torch.Tensor:
    """Run LN0 + GELU0 and conv layers 1..L-1 fused over ``h0``.

    Args:
      h0: [B, N0, C] raw conv-0 output (bias applied, no norm yet), in the
        compute dtype; any strides (the encoder passes a [B, C, N0]
        channels-first tensor's transposed view, read in place).
      weights: per tail layer i a [k_i, C, C] conv kernel (WIO layout).
      bias_stack: [L-1, C] conv biases of the tail layers (fp32).
      ln_scale / ln_bias: [L, C] LayerNorm affine of layers 0..L-1 (fp32).
      specs: ((k_i, s_i), ...) of the tail layers.
      frames_per_tile: the reference's tile override, validated as there
        (must divide T_out and keep the aligned read in bounds).

    Returns [B, T_out, C] in ``out_dtype``.  On a CUDA tensor one call
    makes 1 + len(specs) launches (LN0 + GELU0, then one per layer) and
    counts once in ``frontend_tail_fused.launches``.
    """
    specs = tuple(tuple(sp) for sp in specs)
    B, n0, c = h0.shape
    t_out = tail_lengths(n0, specs)[-1]
    f = frames_per_tile
    if f is None:
        f = choose_tile(t_out, n0, specs, c, itemsize=h0.dtype.itemsize)
    if f is None or t_out % f:
        raise ValueError(f"infeasible tiling: t_out={t_out} n0={n0} specs={specs} f={f}")
    total_stride = 1
    for _, s in specs:
        total_stride *= s
    n_copy = -(-required_input(f, specs) // 8) * 8
    if (t_out - f) * total_stride + n_copy > n0:
        raise ValueError(f"aligned tile read out of bounds: f={f} n0={n0} specs={specs}")
    if h0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {h0.device}")
    flat = [int(v) for sp in specs for v in sp]
    out = _frontend_op(h0, list(weights), bias_stack, ln_scale, ln_bias, flat,
                       bool(approx_gelu), float(eps))
    return out.to(out_dtype)


frontend_tail_fused.launches = 0


# -- custom op ----------------------------------------------------------------
#
# ``sls_tpu_torch::frontend_tail`` (``kernels/ops.py``): the kernel on a CUDA
# tensor, the plain version on a CPU one, in h0's dtype and contiguous, as
# the fake says; ``specs`` flat as (k_1, s_1, k_2, s_2, ...).


def _pairs(flat: Sequence[int]) -> Tuple[Spec, ...]:
    return tuple((flat[i], flat[i + 1]) for i in range(0, len(flat), 2))


def _frontend_op_cuda(h0, weights, bias_stack, ln_scale, ln_bias, specs, approx_gelu, eps):
    out = _frontend_cuda(h0, weights, bias_stack, ln_scale, ln_bias, _pairs(specs),
                         approx_gelu, eps)
    build.count_launch(frontend_tail_fused)
    return out


def _frontend_op_fake(h0, weights, bias_stack, ln_scale, ln_bias, specs, approx_gelu, eps):
    B, n0, c = h0.shape
    return h0.new_empty((B, tail_lengths(n0, _pairs(specs))[-1], c))


_frontend_op = define(
    "frontend_tail",
    "(Tensor h0, Tensor[] weights, Tensor bias_stack, Tensor ln_scale, Tensor ln_bias, "
    "int[] specs, bool approx_gelu, float eps) -> Tensor",
    cuda=_frontend_op_cuda,
    cpu=lambda h0, weights, bias_stack, ln_scale, ln_bias, specs, approx_gelu, eps:
    frontend_tail_fused_plain(h0, weights, bias_stack, ln_scale, ln_bias, specs=_pairs(specs),
                              approx_gelu=approx_gelu, out_dtype=h0.dtype, eps=eps).contiguous(),
    fake=_frontend_op_fake)
