"""The algorithms of the Hopper SAE kernels, on the CPU: the radix select
of ``csrc/sae_encode_topk.cu`` (``topk_threshold_radix_emulated``) held
bit-equal to the plain 31-step search, and the streamed decode of
``csrc/sae_decode.cu`` (``sae_decode_streamed_emulated``) held to the
plain product; both also against the JAX Pallas kernels in interpret
mode.  The kernels themselves are held to the plain versions on a card
by ``tests/test_torch_sae_kernels.py``."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from sls_tpu_torch.kernels import sae_kernels as tk

# fp32 values that exercise every branch of the select: ties, zeros of both
# signs, negatives, subnormals, FLT_MAX, +inf and NaN of both signs
SPECIALS = np.array([0.0, -0.0, 1.0, 1.0, 2.0, -1.0, 1e-45, 1e-40, 1.1754942e-38,
                     3.4028235e38, np.inf, -np.inf, np.nan, -np.nan], np.float32)


def _assert_bit_equal(acts: np.ndarray, k: int) -> None:
    t = torch.from_numpy(np.ascontiguousarray(acts, np.float32))
    plain = tk.topk_threshold_mask_plain(t, k).view(torch.int32)
    radix = tk.topk_threshold_radix_emulated(t, k).view(torch.int32)
    assert torch.equal(radix, plain)


@st.composite
def rows_and_k(draw):
    """A few rows of M values drawn from a small pool (so ties are
    common), from SPECIALS, or from a wide normal range; k anywhere in
    [1, M], with k = 1 and k = M drawn often."""
    m = draw(st.integers(1, 64))
    n = draw(st.integers(1, 4))
    kind = draw(st.sampled_from(["pool", "specials", "normal", "relu"]))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    if kind == "pool":
        acts = rng.integers(-2, 4, size=(n, m)).astype(np.float32)
    elif kind == "specials":
        acts = rng.choice(SPECIALS, size=(n, m))
    elif kind == "normal":
        acts = (rng.normal(size=(n, m)) * 10.0 ** rng.integers(-40, 38)).astype(np.float32)
    else:
        acts = np.maximum(rng.normal(size=(n, m)), 0).astype(np.float32)
    k = draw(st.one_of(st.just(1), st.just(m), st.integers(1, m)))
    return acts, k


@settings(max_examples=300, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(rows_and_k())
def test_radix_select_bit_equal_to_plain(case):
    acts, k = case
    _assert_bit_equal(acts, k)


@pytest.mark.parametrize("case", ["ties_at_kth", "fewer_than_k_positives", "all_zeros",
                                  "negatives_and_negative_zero", "subnormals",
                                  "flt_max_inf_nan", "k_one", "k_all"])
def test_radix_select_edge_rows(case):
    """Each edge case of the select, as one fixed set of rows."""
    m = 64
    rng = np.random.default_rng(3)
    base = np.maximum(rng.normal(size=(3, m)), 0).astype(np.float32)
    k = 8
    if case == "ties_at_kth":
        # eight 5s, then the k-th (10th) value is one of 32 tied 3s
        acts = np.tile(np.float32([5, 3, 3, 3, 3, 1, 0, 2]), (3, 8))
        k = 10
    elif case == "fewer_than_k_positives":
        acts = np.zeros((3, m), np.float32)
        acts[:, :5] = [1, 2, 3, 0.5, 7]
    elif case == "all_zeros":
        acts = np.zeros((3, m), np.float32)
    elif case == "negatives_and_negative_zero":
        acts = base - 0.5
        acts[:, ::7] = -0.0
    elif case == "subnormals":
        acts = (base * 1e-40).astype(np.float32)
        acts[:, ::5] = np.float32(1e-45)
    elif case == "flt_max_inf_nan":
        acts = base.copy()
        acts[0, :10] = np.float32(3.4028235e38)
        acts[1, :3] = np.inf
        acts[1, 3:5] = np.nan
        acts[2, :12] = np.nan
    elif case == "k_one":
        acts, k = base, 1
    else:
        acts, k = base, m
    _assert_bit_equal(acts, k)


def _decode_inputs(n, m, d, kind, seed=0):
    rng = np.random.default_rng(seed)
    codes = np.maximum(rng.normal(size=(n, m)), 0).astype(np.float32)
    if kind == "sparse":
        codes = tk.topk_threshold_mask_plain(torch.from_numpy(codes), max(m // 32, 1)).numpy()
    elif kind == "zero_rows":
        codes[::3] = 0.0
    w_dec = (rng.normal(size=(m, d)) * 0.05).astype(np.float32)
    b_dec = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    return [torch.from_numpy(a) for a in (codes, w_dec, b_dec)]


@pytest.mark.parametrize("n, m, d, kind", [
    (64, 256, 64, "dense"),          # every code nonzero: all of M a row
    (40, 128, 32, "zero_rows"),      # every third row all zeros
    (77, 128, 32, "sparse"),         # N not a multiple of the row tile
    (64, 100, 32, "sparse"),         # M not a multiple of the window
    (33, 96, 40, "dense"),           # D not a multiple of the column tile
], ids=["dense", "zero_rows", "ragged_n", "ragged_m", "ragged_d"])
def test_streamed_decode_matches_plain(n, m, d, kind):
    codes, w_dec, b_dec = _decode_inputs(n, m, d, kind)
    # small tiles and windows, so every case crosses several of each
    out = tk.sae_decode_streamed_emulated(codes, w_dec, b_dec, tile_rows=32, tile_cols=16,
                                          window=32)
    ref = tk.sae_decode_fused_plain(codes, w_dec, b_dec)
    # fp32 sums of up to m terms of size ~0.05 in two orders
    assert float((out - ref).abs().max()) <= 1e-5
    if kind == "zero_rows":
        assert torch.equal(out[::3], b_dec.expand(out[::3].shape))


def test_streamed_decode_kernel_tiling_matches_plain():
    """At the kernel's own tile, column slice and window sizes."""
    codes, w_dec, b_dec = _decode_inputs(130, 96, 260, "sparse", seed=4)
    out = tk.sae_decode_streamed_emulated(codes, w_dec, b_dec)
    assert float((out - tk.sae_decode_fused_plain(codes, w_dec, b_dec)).abs().max()) <= 1e-5


@pytest.fixture(scope="module")
def jax_kernels():
    return pytest.importorskip("sls_tpu.kernels.sae_kernels")


def test_radix_select_matches_jax_kernels(jax_kernels):
    """The radix select on the JAX fused kernel's own dense activations
    (k = M keeps them all) gives its codes at k, bit for bit; and on
    ragged rows it gives topk_sparsify_pallas's output."""
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.default_rng(5)
    n, d, m, k = 70, 64, 256, 16
    x = rng.normal(size=(n, d)).astype(np.float32)
    w_enc = (rng.normal(size=(d, m)) * 0.1).astype(np.float32)
    b_enc = (rng.normal(size=(m,)) * 0.1).astype(np.float32)
    b_dec = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, w_enc, b_enc, b_dec)]
    dense = np.asarray(jax_kernels.sae_encode_topk_fused(*args, k=m, tile_n=128,
                                                         interpret=True))
    codes = np.asarray(jax_kernels.sae_encode_topk_fused(*args, k=k, tile_n=128,
                                                         interpret=True))
    out = tk.topk_threshold_radix_emulated(torch.from_numpy(dense.copy()), k).numpy()
    np.testing.assert_array_equal(out.view(np.int32), codes.view(np.int32))

    acts = np.maximum(rng.normal(size=(37, m)), 0).astype(np.float32)
    acts[3] = 0.0
    acts[4, :5] = 1.0  # fewer than k positives
    acts[5] = np.round(acts[5] * 2) / 2  # ties
    ref = np.asarray(jax_kernels.topk_sparsify_pallas(jnp.asarray(acts), k, tile_n=64,
                                                      interpret=True))
    out = tk.topk_threshold_radix_emulated(torch.from_numpy(acts), k).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


def test_streamed_decode_matches_jax_kernel(jax_kernels):
    jnp = pytest.importorskip("jax.numpy")
    codes, w_dec, b_dec = _decode_inputs(150, 256, 64, "sparse", seed=6)
    ref = np.asarray(jax_kernels.sae_decode_fused(
        jnp.asarray(codes.numpy()), jnp.asarray(w_dec.numpy()), jnp.asarray(b_dec.numpy()),
        tile_n=128, tile_k=128, interpret=True))
    out = tk.sae_decode_streamed_emulated(codes, w_dec, b_dec, tile_rows=64, tile_cols=32)
    # fp32 sums of ~8 terms of size ~0.05 in two orders
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
