"""Row 3's arithmetic: the fp32 SAE encode as the CUDA kernel computes it.

``csrc/sae_encode.cu`` takes the fp32 product on the tensor cores as
"3xTF32": each operand split into two TF32 values with round-to-nearest,
ties away (``cvt.rna.tf32.f32``), and three products summed in fp32.  On
the CPU, ``tf32_round_rna`` and ``sae_encode_fused_split_emulated``
repeat the split; they are held here to hand-picked bit patterns, to the
JAX kernel (interpret mode) and to an fp64 product.  On a card the
kernel is held to its plain version, to the emulation and to the fp64
envelope (``python -m pytest --noconftest -m cuda
tests/test_torch_sae_encode.py``).
"""

import numpy as np
import pytest
import torch

from sls_tpu_torch.kernels import sae_kernels as tk

# relative L2 error against fp64: the kernel may be at most this many
# times further off than the plain fp32 product on the same inputs
F64_ENVELOPE = 1.5


@pytest.fixture(scope="module")
def jax_sk():
    return pytest.importorskip("sls_tpu.kernels.sae_kernels")


@pytest.fixture(scope="module")
def jnp():
    return pytest.importorskip("jax.numpy")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(values):
    return torch.tensor(np.array(values, dtype=np.uint32).view(np.int32)).view(torch.float32)


def _as_bits(t):
    return [int(b) & 0xFFFFFFFF for b in t.view(torch.int32).tolist()]


# (input bits, rounded bits): TF32 keeps the sign, the exponent and the 10
# high mantissa bits; half a TF32 ulp is 0x1000 in the low 13 bits
RNA_CASES = {
    "exact": (0x3F802000, 0x3F802000),
    "below_half": (0x3F800FFF, 0x3F800000),
    "above_half": (0x3F801001, 0x3F802000),
    "tie_away_from_zero": (0x3F801000, 0x3F802000),
    "tie_away_odd": (0x3F803000, 0x3F804000),
    "negative_tie": (0xBF801000, 0xBF802000),
    "negative_below_half": (0xBF800FFF, 0xBF800000),
    "carry_into_exponent": (0x3FFFF000, 0x40000000),
    "negative_carry": (0xBFFFFFFF, 0xC0000000),
    "plus_zero": (0x00000000, 0x00000000),
    "minus_zero": (0x80000000, 0x80000000),
    "subnormal_tie": (0x00001000, 0x00002000),
    "subnormal_below_half": (0x00000FFF, 0x00000000),
    "negative_subnormal": (0x80003000, 0x80004000),
    "subnormal_to_normal": (0x007FF000, 0x00800000),
    "infinity": (0x7F800000, 0x7F800000),
}


@pytest.mark.parametrize("case", list(RNA_CASES))
def test_tf32_round_rna_bit_patterns(case):
    given, want = RNA_CASES[case]
    assert _as_bits(tk.tf32_round_rna(_bits([given]))) == [want]


def test_tf32_round_rna_keeps_nan():
    out = tk.tf32_round_rna(torch.tensor([float("nan"), 1.0]))
    assert torch.isnan(out[0]) and out[1] == 1.0


def test_tf32_split_reconstructs_fp32():
    """hi and lo are TF32 values (13 low bits clear), |lo| <= half an ulp
    of hi, and hi + lo is within 2^-21 of x relative (about 22 bits)."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi = tk.tf32_round_rna(x)
    lo = tk.tf32_round_rna(x - hi)
    for t in (hi, lo):
        assert not bool((t.view(torch.int32) & 0x1FFF).any())
    assert bool(((x - hi).abs() <= hi.abs() * 2.0 ** -11).all())
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -21


def _encode_inputs(n, d, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            (rng.normal(size=(d, m)) * d ** -0.5).astype(np.float32),
            (rng.normal(size=(m,)) * 0.1).astype(np.float32),
            (rng.normal(size=(d,)) * 0.1).astype(np.float32))


def test_split_emulated_matches_jax_kernel(jax_sk, jnp):
    """The inputs and bound of test_encode_fused_plain_matches_jax_kernel
    (tests/test_torch_sae_window.py): N not tile-aligned, D 128."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 128)).astype(np.float32)
    w_enc = rng.normal(size=(128, 512)).astype(np.float32) * 0.05
    b_enc = rng.normal(size=(512,)).astype(np.float32) * 0.1
    b_dec = rng.normal(size=(128,)).astype(np.float32) * 0.1
    ref = np.asarray(jax_sk.sae_encode_fused(*map(jnp.asarray, (x, w_enc, b_enc, b_dec)),
                                             interpret=True))
    out = tk.sae_encode_fused_split_emulated(
        *map(torch.from_numpy, (x, w_enc, b_enc, b_dec))).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def _rel_l2(a, b):
    return float(torch.linalg.vector_norm(a.double() - b) / torch.linalg.vector_norm(b))


def _fp64_encode(x, w_enc, b_enc, b_dec):
    return torch.relu((x.double() - b_dec.double()) @ w_enc.double() + b_enc.double())


@pytest.mark.parametrize("shape", [(67, 1024, 256), (300, 128, 512)], ids=["D1024", "D128"])
def test_split_emulated_within_fp64_envelope(shape):
    """The split alone (products exact, one rounding) lies within 1.5x of
    the plain fp32 product's own error against fp64."""
    args = tuple(map(torch.from_numpy, _encode_inputs(*shape, seed=shape[0])))
    truth = _fp64_encode(*args)
    plain = _rel_l2(tk.sae_encode_fused_plain(*args), truth)
    emulated = _rel_l2(tk.sae_encode_fused_split_emulated(*args), truth)
    assert 0 < plain < 1e-5
    assert emulated <= F64_ENVELOPE * plain


def test_wrapper_takes_the_plain_version_on_cpu():
    args = tuple(map(torch.from_numpy, _encode_inputs(9, 64, 256, seed=1)))
    before = tk.sae_encode_fused.launches
    torch.testing.assert_close(tk.sae_encode_fused(*args), tk.sae_encode_fused_plain(*args),
                               rtol=0, atol=0)
    assert tk.sae_encode_fused.launches == before


# -- on a card ----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 68, 127, 7236])
def test_kernel_within_plain_and_fp64_envelope(cuda, n):
    """At the window-overlap path's D and M (N = 7236 the whole batch;
    1, 68 and 127 rows a ragged 128-row tile): within 1e-4 of the plain
    version and of the CPU emulation, and within 1.5x of the plain
    version's error against fp64."""
    args = tuple(torch.from_numpy(a).to(cuda) for a in _encode_inputs(n, 1024, 4096, seed=n))
    before = tk.sae_encode_fused.launches
    out = tk.sae_encode_fused(*args)
    torch.cuda.synchronize()
    assert tk.sae_encode_fused.launches == before + 1
    plain = tk.sae_encode_fused_plain(*args)
    emulated = tk.sae_encode_fused_split_emulated(*(a.cpu() for a in args)).to(cuda)
    truth = _fp64_encode(*args)
    assert float((out - plain).abs().max()) <= 1e-4
    assert float((out - emulated).abs().max()) <= 1e-4
    assert _rel_l2(out, truth) <= F64_ENVELOPE * _rel_l2(plain, truth)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 68, 127])
def test_kernel_within_fp64_envelope_over_draws(cuda, n):
    """Where cuBLAS's fp32 product is at its most accurate (one row, and
    ragged 128-row tiles), the envelope holds for every one of 16 draws."""
    for seed in range(16):
        args = tuple(torch.from_numpy(a).to(cuda)
                     for a in _encode_inputs(n, 1024, 4096, seed=100 * n + seed))
        truth = _fp64_encode(*args)
        plain = _rel_l2(tk.sae_encode_fused_plain(*args), truth)
        assert _rel_l2(tk.sae_encode_fused(*args), truth) <= F64_ENVELOPE * plain, seed


@pytest.mark.cuda
def test_kernel_rejects_shapes_it_does_not_tile(cuda):
    args = [torch.zeros(4, 1000, device=cuda), torch.zeros(1000, 384, device=cuda),
            torch.zeros(384, device=cuda), torch.zeros(1000, device=cuda)]
    with pytest.raises(ValueError, match="D % 32"):
        tk.sae_encode_fused(*args)
