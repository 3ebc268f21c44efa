"""The encoder's fp32 LayerNorm as one kernel: a wrapper over
``csrc/layer_norm.cu``, its plain version and its route rule.

``layer_norm_fp32(x, weight, bias, eps)`` is
``fp32_layer_norm(x.float(), weight, bias, eps).to(x.dtype)`` (flax's
fast-variance LayerNorm over the last axis, in fp32, rounded once to the
input's dtype) computed by one launch that reads each row once and
writes it once, where the plain version makes 14.  No TPU kernel is
replaced: the JAX package leaves this to XLA, which fuses it.

The kernel takes rows of ``WIDTHS`` values in a dtype of ``DTYPES``,
whose last axis is contiguous and whose leading axes collapse to one row
stride, 16-byte aligned (``kernel_row_stride``).  The wrapper calls the
custom op ``sls_tpu_torch::layer_norm`` (``kernels/ops.py``), which takes
the plain version for a tensor on the CPU and launches the kernel for a
CUDA tensor or raises; there is no fallback.
``layer_norm_fp32.launches`` counts calls that launched.

``takes_kernel`` is the route rule of ``encoder/xlsr.py::Fp32LayerNorm``:
the kernel on a card wherever autograd records nothing through the call
and the kernel takes the rows, else the plain version.  It depends on
the width and dtype alone, so every caller (XLS-R and WavLM, every eval
path, a frozen encoder's forward inside a train step) takes it alike.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch

from sls_tpu_torch.kernels import build
from sls_tpu_torch.kernels.frontend import fp32_layer_norm
from sls_tpu_torch.kernels.ops import define

WIDTHS = (512, 1024, 4096)  # the conv features', the encoder's and the head's widths
DTYPES = (torch.bfloat16, torch.float32)
ALIGN = 16  # bytes: the kernel moves rows as 16-byte vectors

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


# -- the route rule -----------------------------------------------------------


def kernel_row_stride(x: torch.Tensor) -> Optional[int]:
    """The one row stride (elements) of ``x`` seen as rows of its last
    axis, when the kernel can read them: the last axis contiguous, the
    leading axes collapsing to a single stride of at least the width, the
    rows 16-byte aligned.  None otherwise."""
    if x.dim() == 0:
        return None
    width = x.shape[-1]
    if x.is_contiguous():  # the common case, checked in C
        row = width
    elif x.stride(-1) != 1:
        return None
    else:
        row, span = None, 1
        for n, s in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
            if n == 1:
                continue
            if row is None:
                row = s
            elif s != row * span:
                return None
            span *= n
        row = width if row is None else row
    size = x.element_size()
    if row < width or (row * size) % ALIGN or (x.storage_offset() * size) % ALIGN:
        return None
    return row


def records_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on ``tensors``: grad mode on (not
    under ``no_grad`` or ``inference_mode``) and one of them needs a
    gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def takes_kernel(on_card: bool, records_grad: bool, dtype: torch.dtype, width: int,
                 row_stride: Optional[int]) -> bool:
    """Whether a LayerNorm call takes the kernel: on a card, with nothing
    for autograd to record, in a dtype and width the kernel takes, on rows
    it can read (``row_stride`` from ``kernel_row_stride``)."""
    return (on_card and not records_grad and dtype in DTYPES and width in WIDTHS
            and row_stride is not None)


# -- the kernel ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry, built and bound at first use."""
    fn = build.load("layer_norm").layernorm_rows_launch
    fn.argtypes = [_P, _P, _P, _P, _L, _I, _L, _F, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _layer_norm_cuda(x, weight, bias, eps):
    width = x.shape[-1]
    if x.dtype not in DTYPES:
        raise TypeError(f"the kernel takes bfloat16 or float32, got {x.dtype}")
    if width not in WIDTHS:
        raise ValueError(f"the kernel takes widths {WIDTHS}, got {width}")
    row_stride = kernel_row_stride(x)
    if row_stride is None:
        raise ValueError(f"the kernel cannot read rows of shape {tuple(x.shape)}, strides "
                         f"{x.stride()}, offset {x.storage_offset()}: it needs a contiguous "
                         f"last axis, one row stride and {ALIGN}-byte aligned rows")
    params = []
    for t, name in ((weight, "weight"), (bias, "bias")):
        if t.device != x.device or tuple(t.shape) != (width,):
            raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, expected "
                             f"({width},) on {x.device}")
        params.append(t if t.dtype == torch.float32 and t.is_contiguous()
                      else t.float().contiguous())
    scale, shift = params
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    n_rows = out.numel() // width
    if n_rows:
        args = (x.data_ptr(), out.data_ptr(), scale.data_ptr(), shift.data_ptr(), n_rows,
                width, row_stride, eps, int(x.dtype == torch.bfloat16))
        # The host binds a forward at batch 1 (~50 calls a forward), so the
        # launch takes the current stream's raw handle (torch.cuda's
        # current_stream() builds a Stream object: ~8 us on the card's
        # host) and switches the current device only when it differs.
        dev = x.device.index
        same = dev == torch.cuda.current_device()
        with contextlib.nullcontext() if same else torch.cuda.device(dev):
            err = _entry()(*args, torch._C._cuda_getCurrentRawStream(dev))
        build.check(err, "layernorm_rows")
        build.count_launch(layer_norm_fp32)
    return out


# -- plain version and wrapper ------------------------------------------------


def layer_norm_fp32_plain(x, weight, bias, eps: float) -> torch.Tensor:
    """What the kernel computes, in the encoder's own passes."""
    return fp32_layer_norm(x.float(), weight, bias, eps).to(x.dtype)


def layer_norm_fp32(x, weight, bias, eps: float) -> torch.Tensor:
    """LayerNorm of ``x`` [..., C] over its last axis in fp32, rounded to
    ``x``'s dtype: ``weight`` and ``bias`` [C] (fp32).  On a CUDA tensor
    one launch, counted in ``layer_norm_fp32.launches``; on a CPU one the
    plain version."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return _layer_norm_op(x, weight, bias, float(eps))


layer_norm_fp32.launches = 0


# -- custom op ----------------------------------------------------------------
#
# ``sls_tpu_torch::layer_norm`` (``kernels/ops.py``): the kernel on a CUDA
# tensor, the plain version on a CPU one, in x's dtype and shape, contiguous.

_layer_norm_op = define(
    "layer_norm",
    "(Tensor x, Tensor weight, Tensor bias, float eps) -> Tensor",
    cuda=_layer_norm_cuda,
    cpu=lambda x, weight, bias, eps: layer_norm_fp32_plain(x, weight, bias, eps).contiguous(),
    fake=lambda x, weight, bias, eps: x.new_empty(x.shape))
