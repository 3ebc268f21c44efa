"""The encoder's LayerNorm kernel (``sls_tpu_torch/kernels/layer_norm.py``,
``csrc/layer_norm.cu``) and its route rule in ``Fp32LayerNorm``.

On the CPU: the route rule over device, autograd, dtype, width and the
rows' layout; the custom op's registration, its plain CPU version bit for
bit and its fake; an eval ``Detector.score`` counting the plain route once
for each ``Fp32LayerNorm`` call it makes (the JAX-parity tests then cover
the CPU route, which is unchanged).  On a card (marked ``cuda``): the
kernel against its plain version at the scoring and long-clip shapes, and
its launches in a scoring forward and in train steps.  This file imports
no JAX, so the card's tests run there with

    python -m pytest --noconftest -m cuda tests/test_torch_layer_norm.py
"""

import dataclasses

import pytest
import torch

from sls_tpu_torch import config as C
from sls_tpu_torch.encoder import xlsr
from sls_tpu_torch.kernels import layer_norm as ln
from sls_tpu_torch.kernels import ops
from sls_tpu_torch.kernels.frontend import fp32_layer_norm
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.train import profiling

# fp32 output: the kernel's fp32 sums of a row (and its rsqrtf) round
# otherwise than PyTorch's reductions; relative to the largest output,
# the bound the repository holds fp32 sums in another order to
# (tests/test_torch_frontend.py's F32_TOL)
F32_TOL = 2e-5
# the route rule's facts where the kernel is taken; each case below
# changes some of them
TAKEN = {"on_card": True, "grad": "inference_mode", "dtype": torch.bfloat16, "width": 1024,
         "layout": "contiguous"}


# -- the route rule -------------------------------------------------------------

def _rows(width, dtype, layout):
    """A [2, 3, width] tensor (or a view) in ``layout``: ``contiguous``;
    ``wider_rows`` (the first ``width`` of wider rows: one row stride);
    ``frames_slice`` (frames 1.. of each utterance: two strides);
    ``transposed`` (the last axis not contiguous); ``offset`` (rows
    starting 2 values past a 16-byte boundary); ``one_row``."""
    base = {"contiguous": (2, 3, width), "wider_rows": (2, 3, width + 64),
            "frames_slice": (2, 4, width), "transposed": (2, width, 3),
            "offset": (2 * 3 * width + 2,), "one_row": (1, 1, width)}[layout]
    x = torch.zeros(base, dtype=dtype)
    if layout == "wider_rows":
        return x[..., :width]
    if layout == "frames_slice":
        return x[:, 1:]
    if layout == "transposed":
        return x.transpose(1, 2)
    if layout == "offset":
        return x[2:].view(2, 3, width)
    return x


def _facts(grad, x, weight):
    """``records_grad`` for ``x`` and the module's ``weight`` in ``grad``:
    ``enabled`` (grad mode on, nothing needs a gradient), ``no_grad``,
    ``inference_mode``, ``leaf`` (x a leaf needing one), ``weight`` (the
    scale needing one: a train step), ``weight_no_grad`` (that scale
    under ``no_grad``: a frozen encoder's forward)."""
    if grad == "leaf":
        x = x.detach().requires_grad_(True)
    if grad.startswith("weight"):
        weight = weight.detach().requires_grad_(True)
    ctx = {"no_grad": torch.no_grad, "weight_no_grad": torch.no_grad,
           "inference_mode": torch.inference_mode}.get(grad, torch.enable_grad)
    with ctx():
        return ln.records_grad(x, weight, torch.zeros_like(weight))


RULE_CASES = {
    "taken": ({}, True),
    "cpu": ({"on_card": False}, False),
    "no_grad": ({"grad": "no_grad"}, True),
    "grad_mode_nothing_needs_grad": ({"grad": "enabled"}, True),
    "leaf_needs_grad": ({"grad": "leaf"}, False),
    "weight_needs_grad": ({"grad": "weight"}, False),
    "weight_needs_grad_under_no_grad": ({"grad": "weight_no_grad"}, True),
    "fp32": ({"dtype": torch.float32}, True),
    "fp16": ({"dtype": torch.float16}, False),
    "width_512": ({"width": 512}, True),
    "width_4096_fp32": ({"width": 4096, "dtype": torch.float32}, True),
    "width_768": ({"width": 768}, False),
    "width_64": ({"width": 64}, False),
    "wider_rows": ({"layout": "wider_rows"}, True),
    "frames_slice": ({"layout": "frames_slice"}, False),
    "transposed": ({"layout": "transposed"}, False),
    "offset_unaligned": ({"layout": "offset"}, False),
    "one_row": ({"layout": "one_row"}, True),
    "cpu_leaf_fp16_transposed": ({"on_card": False, "grad": "leaf", "dtype": torch.float16,
                                  "layout": "transposed"}, False),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_route_rule(case):
    """The kernel on a card when autograd records nothing, in bf16 or fp32,
    at widths 512, 1024 and 4096, on rows of one row stride, 16-byte
    aligned; the plain passes otherwise."""
    change, want = RULE_CASES[case]
    f = {**TAKEN, **change}
    x = _rows(f["width"], f["dtype"], f["layout"])
    assert x.shape[-1] == f["width"]
    records = _facts(f["grad"], x, torch.ones(f["width"]))
    assert records == (f["grad"] in ("leaf", "weight"))
    rows = ln.kernel_row_stride(x)
    if f["layout"] in ("contiguous", "one_row"):
        assert rows == f["width"]
    if f["layout"] == "wider_rows":
        assert rows == f["width"] + 64
    assert ln.takes_kernel(f["on_card"], records, f["dtype"], f["width"], rows) == want


# -- the op ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("width", [512, 1024])
def test_op_is_registered_and_its_cpu_version_is_the_plain_one(dtype, width):
    assert "layer_norm" in ops.OPS
    assert "sls_tpu_torch::layer_norm" in ops.register_all()
    g = torch.Generator().manual_seed(width)
    x = (torch.randn(3, 7, width, generator=g) * 3 + 0.5).to(dtype)
    w = torch.randn(width, generator=g) * 0.1 + 1
    b = torch.randn(width, generator=g) * 0.1
    want = fp32_layer_norm(x.float(), w, b, 1e-5).to(dtype)
    got = torch.ops.sls_tpu_torch.layer_norm(x, w, b, 1e-5)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(ln.layer_norm_fp32(x[:, 2:], w, b, 1e-5), want[:, 2:])
    assert torch.equal(ln.layer_norm_fp32_plain(x, w, b, 1e-5), want)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = torch.ops.sls_tpu_torch.layer_norm(mode.from_tensor(x), mode.from_tensor(w),
                                                  mode.from_tensor(b), 1e-5)
    assert fake.shape == x.shape and fake.dtype == dtype


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="no kernel for device"):
        ln.layer_norm_fp32(torch.empty(2, 512, device="meta"), torch.ones(512),
                           torch.zeros(512), 1e-5)


# -- the route's counter in a CPU forward ----------------------------------------

def _tiny_detector():
    cfg = C.ModelConfig(encoder=C.tiny_xlsr_config(),
                        sae=C.SAEConfig(activation_dim=64, dict_size=256, k=32, use_pallas=True),
                        classifier_hidden=32)
    return Detector(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def _routes(model, monkeypatch):
    """Two lists that fill as ``model`` runs: the names of the
    ``Fp32LayerNorm`` modules called, and of those that took the kernel."""
    names = {mod: name for name, mod in model.named_modules()
             if isinstance(mod, xlsr.Fp32LayerNorm)}
    called, kernel = [], []
    for mod in names:
        mod.register_forward_pre_hook(lambda m, args: called.append(names[m]))
    real = xlsr.layer_norm_fp32

    def spy(*args):
        kernel.append(called[-1])
        return real(*args)

    monkeypatch.setattr(xlsr, "layer_norm_fp32", spy)
    return called, kernel


def test_cpu_score_counts_the_plain_route_once_a_norm(monkeypatch):
    model = _tiny_detector()
    called, kernel = _routes(model, monkeypatch)
    wav = torch.randn(2, 1000, generator=torch.Generator().manual_seed(1)) * 0.1
    with torch.inference_mode(), profiling.recording() as rec:
        model.score(wav)
    layers = model.config.encoder.encoder_layers
    # the unfused front-end's conv norms, post-extract, two a layer, the
    # final norm, the head's: each module once
    assert sorted(called) == sorted(n for n, m in model.named_modules()
                                    if isinstance(m, xlsr.Fp32LayerNorm))
    assert len(called) == len(model.config.encoder.conv_layers) + 2 * layers + 3
    assert kernel == []
    assert {k: v for k, v in rec.counts.items() if k.startswith("sls.layernorm")} == {
        "sls.layernorm.plain": len(called)}


# -- on a card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _beyond_one_ulp(out, ref, bias):
    """Elements of ``out`` further from ``ref`` than one bf16 ulp of
    ``ref``, beyond the fp32 rounding of the two terms ``ref`` is the sum
    of: (x - mean) rstd scale and the bias, each at most |ref| + |bias|.
    Where they nearly cancel, ``ref`` is far below them and its own ulp
    below their rounding (a ~1e-6 output of two ~0.1 terms)."""
    _, exp = torch.frexp(ref.float())
    ulp = torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exp - 8)
    terms = F32_TOL * (ref.float().abs() + 2 * bias.float().abs())
    return int(((out.float() - ref.float()).abs() > ulp + terms).sum())


def _operands(rows, width, dtype, device, seed):
    """Rows with an offset mean and a wide spread (a residual stream's
    kind), the affine near its initialisation."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(rows, width, device=device, generator=g) * 3 + 0.5).to(dtype)
    w = torch.randn(width, device=device, generator=g) * 0.1 + 1
    b = torch.randn(width, device=device, generator=g) * 0.1
    return x, w, b


def _assert_matches_plain(out, ref, bias):
    assert out.shape == ref.shape and out.dtype == ref.dtype and out.is_contiguous()
    if ref.dtype == torch.bfloat16:
        # the same fp32 function, its sums taken in another order: a bf16
        # rounding near a tie may fall the other way, by one ulp, no more
        assert _beyond_one_ulp(out, ref, bias) == 0
    else:
        err = float((out - ref).abs().max())
        assert err <= F32_TOL * float(ref.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width,dtype", [
    (7236, 1024, torch.bfloat16),  # the score batch: 36 x 201 frames
    (5120, 1024, torch.bfloat16),  # a long clip at T 5120
    (7236, 512, torch.bfloat16),   # post_extract_norm
    (7236, 1024, torch.float32),
    (36, 4096, torch.float32),     # the head's norm on pooled codes
    (1, 1024, torch.bfloat16),
    (1, 4096, torch.float32),
    (4093, 1024, torch.bfloat16),  # a ragged last block
    (4093, 512, torch.float32),
], ids=lambda v: str(v).replace("torch.", ""))
def test_kernel_matches_plain(cuda, rows, width, dtype):
    x, w, b = _operands(rows, width, dtype, cuda, rows + width)
    before = ln.layer_norm_fp32.launches
    out = ln.layer_norm_fp32(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert ln.layer_norm_fp32.launches == before + 1
    _assert_matches_plain(out, ln.layer_norm_fp32_plain(x, w, b, 1e-5), b)


@pytest.mark.cuda
def test_kernel_reads_strided_rows_and_batches(cuda):
    """Rows of a wider tensor (one row stride) and a [B, T, C] batch."""
    x, w, b = _operands(300, 1024 + 64, torch.bfloat16, cuda, 5)
    view = x[:, :1024]
    assert ln.kernel_row_stride(view) == 1024 + 64
    _assert_matches_plain(ln.layer_norm_fp32(view, w[:1024], b[:1024], 1e-5),
                          ln.layer_norm_fp32_plain(view, w[:1024], b[:1024], 1e-5), b[:1024])
    x3 = x[:, :1024].reshape(3, 100, 1024)
    _assert_matches_plain(ln.layer_norm_fp32(x3, w[:1024], b[:1024], 1e-6),
                          ln.layer_norm_fp32_plain(x3, w[:1024], b[:1024], 1e-6), b[:1024])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_constant_rows_give_the_bias(cuda, dtype):
    """A constant row's variance is 0 up to rounding (E[x^2] - E[x]^2 may
    come out negative and is clamped): x - mean is exactly 0, so both
    versions give the bias, rounded to the dtype."""
    _, w, b = _operands(1, 1024, dtype, cuda, 9)
    levels = torch.tensor([0.0, 3.0, -0.5, 300.0, 1e-3, -7.25], device=cuda)
    x = levels.repeat_interleave(5)[:, None].expand(-1, 1024).to(dtype).contiguous()
    out = ln.layer_norm_fp32(x, w, b, 1e-5)
    ref = ln.layer_norm_fp32_plain(x, w, b, 1e-5)
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, ref)
    assert torch.equal(out, b.to(dtype).expand_as(out))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x, w, b = _operands(8, 768, torch.bfloat16, cuda, 1)
    with pytest.raises(ValueError, match="widths"):
        ln.layer_norm_fp32(x, w, b, 1e-5)
    x, w, b = _operands(8, 1024, torch.bfloat16, cuda, 1)
    with pytest.raises(ValueError, match="cannot read rows"):
        ln.layer_norm_fp32(x.t().contiguous().t(), w, b, 1e-5)  # the last axis strided
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ln.layer_norm_fp32(x.half(), w, b, 1e-5)


def _flagship(device, **model):
    cfg = C.ModelConfig(encoder=C.XLSRConfig(dtype=torch.bfloat16),
                        sae=C.SAEConfig(activation_dim=1024, dict_size=4096, k=128,
                                        use_pallas=True), **model)
    return Detector(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))


def _layer_norms(layers):
    return {f"encoder.layers.{i}.{n}" for i in range(layers)
            for n in ("self_attn_layer_norm", "final_layer_norm")} | {"encoder.encoder_layer_norm"}


@pytest.mark.cuda
def test_scoring_forward_launches_once_a_norm(cuda, monkeypatch):
    """An eval score at the scoring batch [36, 64600] launches the kernel
    for both norms of each of the 24 layers, the post-extract and final
    norms and the head's (2 * 24 + 3) and takes no plain route (the
    front-end's conv norms are inside row 8 there).  Its encoder output
    lies within the envelope the repository holds a bf16 route to: within
    1.5x of the plain route's distance from fp32, and 2x of it from the
    plain route (tests/test_torch_encoder.py)."""
    model = _flagship(cuda)
    layers = model.config.encoder.encoder_layers
    wav = torch.randn(36, 64600, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    wav = wav * 0.1
    with torch.inference_mode():
        model.score(wav)
        called, kernel = _routes(model, monkeypatch)
        before = ln.layer_norm_fp32.launches
        with profiling.recording() as rec:
            model.score(wav)
        torch.cuda.synchronize()
    assert ln.layer_norm_fp32.launches - before == 2 * layers + 3
    assert kernel == called
    assert set(kernel) == _layer_norms(layers) | {"encoder.post_extract_norm", "classifier.norm"}
    assert {k: v for k, v in rec.counts.items() if k.startswith("sls.layernorm")} == {
        "sls.layernorm.kernel": 2 * layers + 3}

    fp32 = Detector(dataclasses.replace(model.config, encoder=dataclasses.replace(
        model.config.encoder, dtype=torch.float32, approx_gelu=True)), device="meta")
    fp32.load_state_dict(model.state_dict(), strict=True, assign=True)
    few = wav[:4]
    with torch.inference_mode():
        out = model.encoder(few).float()
        monkeypatch.setattr(xlsr, "takes_kernel", lambda *facts: False)
        plain = model.encoder(few).float()
        truth = fp32.encoder(few)
    envelope = float((plain - truth).norm() / truth.norm())
    assert float((out - truth).norm() / truth.norm()) <= 1.5 * envelope
    assert float((out - plain).norm() / plain.norm()) <= 2.0 * envelope


@pytest.mark.cuda
@pytest.mark.parametrize("freeze", [False, True], ids=["grads", "freeze_encoder"])
def test_train_step_launches_only_under_no_grad(cuda, freeze, monkeypatch):
    """A train step with gradients through the encoder launches the kernel
    0 times.  With ``freeze_encoder`` the encoder runs under ``no_grad``:
    its layers' norms and the final norm take the kernel (the front-end's
    norms too where the unfused route leaves their rows contiguous), and
    the head's norm, which trains, takes the plain route."""
    from sls_tpu_torch.train.steps import create_train_state, make_train_step

    model = _flagship(cuda, freeze_encoder=freeze)
    exp = C.ExperimentConfig(model=model.config, train=C.TrainConfig(cut_length=64600))
    state = create_train_state(model, exp)
    step = make_train_step(model, exp, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    wav = torch.randn(2, 64600, device=cuda, generator=g) * 0.1
    labels = torch.tensor([0, 1], device=cuda)
    valid = torch.ones(2, device=cuda)
    called, kernel = _routes(model, monkeypatch)
    before = ln.layer_norm_fp32.launches
    with profiling.recording() as rec:
        _, metrics = step(state, wav, labels, valid, 0)
    torch.cuda.synchronize()
    assert bool(metrics["finite"])
    launched = ln.layer_norm_fp32.launches - before
    assert launched == len(kernel) == rec.counts.get("sls.layernorm.kernel", 0)
    assert rec.counts["sls.layernorm.plain"] == len(called) - len(kernel)
    assert "classifier.norm" in called
    if freeze:
        assert _layer_norms(model.config.encoder.encoder_layers) <= set(kernel)
        assert "classifier.norm" not in kernel
    else:
        assert launched == 0
