"""The port's SAE kernels: plain versions against the JAX Pallas kernels
(interpret mode on the CPU), exact properties of the threshold top-k,
the CPU routing of the wrappers, and (on a card) each CUDA kernel
against its plain version.

The JAX side is imported inside fixtures, so that on a machine with a
card and no JAX the CUDA tests still run:
``python -m pytest --noconftest -m cuda tests/test_torch_sae_kernels.py``.
"""

import numpy as np
import pytest
import torch

from sls_tpu_torch.kernels import sae_kernels as tk

D, M, N, K = 128, 512, 300, 16


@pytest.fixture(scope="module")
def w():
    rng = np.random.default_rng(0)
    return {
        "x": rng.normal(size=(N, D)).astype(np.float32),  # N not tile-aligned
        "w_enc": rng.normal(size=(D, M)).astype(np.float32) * 0.05,
        "b_enc": rng.normal(size=(M,)).astype(np.float32) * 0.1,
        "w_dec": rng.normal(size=(M, D)).astype(np.float32) * 0.05,
        "b_dec": rng.normal(size=(D,)).astype(np.float32) * 0.1,
    }


@pytest.fixture(scope="module")
def jax_kernels():
    return pytest.importorskip("sls_tpu.kernels.sae_kernels")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(w, *names, device="cpu"):
    return [torch.from_numpy(w[n]).to(device) for n in names]


def _encode_args(w, device="cpu"):
    return _t(w, "x", "w_enc", "b_enc", "b_dec", device=device)


def _near_tie_rows(acts: np.ndarray, k: int, rel: float) -> np.ndarray:
    """Rows whose k-th and (k+1)-th largest values differ by at most
    ``rel`` relative: there the support may legitimately flip."""
    top = -np.sort(-acts, axis=-1)[:, : k + 1]
    kth, nxt = top[:, k - 1], top[:, k]
    return (kth - nxt) <= rel * np.maximum(kth, 1e-30)


def test_encode_topk_plain_matches_jax_kernel(w, jax_kernels):
    jnp = pytest.importorskip("jax.numpy")
    args_j = [jnp.asarray(w[n]) for n in ("x", "w_enc", "b_enc", "b_dec")]
    # k = M keeps every entry: the JAX kernel's dense activations
    dense_ref = np.asarray(jax_kernels.sae_encode_topk_fused(*args_j, k=M, interpret=True))
    codes_ref = np.asarray(jax_kernels.sae_encode_topk_fused(*args_j, k=K, interpret=True))
    acts = tk.sae_encode_acts_plain(*_encode_args(w)).numpy()
    codes = tk.sae_encode_topk_fused_plain(*_encode_args(w), K).numpy()

    # both sum the same exact bf16 products in fp32, in another order:
    # rtol 1e-5, atol 1e-6 for sums that cancel near zero
    np.testing.assert_allclose(acts, dense_ref, rtol=1e-5, atol=1e-6)
    # the support agrees exactly except where the k-th and (k+1)-th
    # values are within that summation noise of each other
    clear = ~_near_tie_rows(acts, K, 1e-5)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(codes[clear] > 0, codes_ref[clear] > 0)
    np.testing.assert_allclose(codes[clear], codes_ref[clear], rtol=1e-5, atol=1e-6)


def test_threshold_topk_exact_properties(w):
    acts = tk.sae_encode_acts_plain(*_encode_args(w))
    codes = tk.topk_threshold_mask_plain(acts, K)
    kept = codes > 0
    positives = (acts > 0).sum(-1)
    assert torch.all(kept.sum(-1) >= torch.clamp(positives, max=K))
    # every kept entry is >= every dropped one, and kept values are untouched
    min_kept = torch.where(kept, acts, torch.inf).amin(-1)
    max_dropped = torch.where(kept, -torch.inf, acts).amax(-1)
    assert torch.all(min_kept >= max_dropped)
    assert torch.equal(codes[kept], acts[kept])


def test_threshold_topk_keeps_ties_and_short_rows():
    acts = torch.tensor([[5.0, 1.0, 5.0, 5.0, 0.0, 5.0, 2.0, 0.0],
                         [0.0, 3.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0]])
    out = tk.topk_threshold_mask_plain(acts, 2)
    # all four tied 5s survive k = 2; a row with fewer than k positives
    # ends at lo = 0 and keeps every entry
    assert torch.equal(out[0], torch.tensor([5.0, 0, 5.0, 5.0, 0, 5.0, 0, 0]))
    out3 = tk.topk_threshold_mask_plain(acts, 3)
    assert torch.equal(out3[1], acts[1])


def test_decode_plain_matches_jax_kernel(w, jax_kernels):
    jnp = pytest.importorskip("jax.numpy")
    codes = np.maximum(np.random.default_rng(1).normal(size=(N, M)), 0).astype(np.float32)
    ref = np.asarray(jax_kernels.sae_decode_fused(
        jnp.asarray(codes), jnp.asarray(w["w_dec"]), jnp.asarray(w["b_dec"]),
        tile_n=128, tile_k=256, interpret=True))
    out = tk.sae_decode_fused_plain(torch.from_numpy(codes), *_t(w, "w_dec", "b_dec")).numpy()
    # fp32 sums of 512 terms of size ~0.05 in two orders
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparsify_matches_jax(dtype):
    """The jnp path's sort-free threshold (signed values: the monotone
    bit mapping), the per-row TopK and the scatter form, exactly."""
    jnp = pytest.importorskip("jax.numpy")
    jsp = pytest.importorskip("sls_tpu.sae.sparsify")
    from sls_tpu_torch.sae import sparsify as tsp

    acts = np.random.default_rng(2).normal(size=(3, 40, 256)).astype(np.float32)
    j, t = jnp.asarray(acts, dtype), torch.from_numpy(acts).to(getattr(torch, dtype))
    if dtype == "float32":
        np.testing.assert_array_equal(tsp.kth_value_threshold(t, K).numpy(),
                                      np.asarray(jsp.kth_value_threshold(j, K)))
        np.testing.assert_array_equal(tsp.topk_per_row_exact(t, K).numpy(),
                                      np.asarray(jsp.topk_per_row_exact(j, K)))
    np.testing.assert_array_equal(tsp.topk_per_row(t, K).float().numpy(),
                                  np.asarray(jsp.topk_per_row(j, K)).astype(np.float32))


def test_wrappers_take_plain_path_on_cpu(w):
    enc0, dec0 = tk.sae_encode_topk_fused.launches, tk.sae_decode_fused.launches
    codes = tk.sae_encode_topk_fused(*_encode_args(w), K)
    assert torch.equal(codes, tk.sae_encode_topk_fused_plain(*_encode_args(w), K))
    recon = tk.sae_decode_fused(codes, *_t(w, "w_dec", "b_dec"))
    assert torch.equal(recon, tk.sae_decode_fused_plain(codes, *_t(w, "w_dec", "b_dec")))
    assert tk.sae_encode_topk_fused.launches == enc0
    assert tk.sae_decode_fused.launches == dec0


def test_wrappers_never_fall_back_off_the_cpu(w):
    x, w_enc, b_enc, b_dec = (t.to("meta") for t in _encode_args(w))
    with pytest.raises(ValueError, match="no kernel"):
        tk.sae_encode_topk_fused(x, w_enc, b_enc, b_dec, K)
    with pytest.raises(ValueError, match="no kernel"):
        tk.sae_decode_fused(torch.empty(N, M, device="meta"), w_enc.t(), b_dec)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(N, D, M, K), (36 * 201, 1024, 4096, 128)],
                         ids=["small", "flagship"])
def test_encode_topk_kernel_matches_plain(cuda, shape):
    n, d, m, k = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(n, d, device=cuda, generator=g)
    w_enc = torch.randn(d, m, device=cuda, generator=g) * d ** -0.5
    b_enc = torch.randn(m, device=cuda, generator=g) * 0.1
    b_dec = torch.randn(d, device=cuda, generator=g) * 0.1
    before = tk.sae_encode_topk_fused.launches
    out = tk.sae_encode_topk_fused(x, w_enc, b_enc, b_dec, k)
    torch.cuda.synchronize()
    assert tk.sae_encode_topk_fused.launches == before + 1
    acts = tk.sae_encode_acts_plain(x, w_enc, b_enc, b_dec)
    ref = tk.topk_threshold_mask_plain(acts, k)
    # same bf16 operands; fp32 sums over d terms in another order: 1e-3
    # absolute is far above that noise at these magnitudes (|acts| ~ 1)
    tol = 1e-3
    kept, kept_ref = out > 0, ref > 0
    both = kept & kept_ref
    assert torch.allclose(out[both], ref[both], atol=tol, rtol=0)
    # a support difference is allowed only within tol of the row's threshold
    kth = torch.where(kept_ref, acts, torch.inf).amin(-1, keepdim=True)
    flipped = kept ^ kept_ref
    assert torch.all((acts - kth).abs()[flipped] <= tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(N, M, D, K), (36 * 201, 4096, 1024, 128)],
                         ids=["small", "flagship"])
def test_decode_kernel_matches_plain(cuda, shape):
    n, m, d, k = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    acts = torch.rand(n, m, device=cuda, generator=g)
    codes = tk.topk_threshold_mask_plain(acts, k)
    w_dec = torch.randn(m, d, device=cuda, generator=g) * 0.05
    b_dec = torch.randn(d, device=cuda, generator=g) * 0.1
    before = tk.sae_decode_fused.launches
    out = tk.sae_decode_fused(codes, w_dec, b_dec)
    torch.cuda.synchronize()
    assert tk.sae_decode_fused.launches == before + 1
    ref = tk.sae_decode_fused_plain(codes, w_dec, b_dec)
    # fp32 sums of ~k terms in another order
    assert torch.allclose(out, ref, atol=1e-4, rtol=1e-5)


def _encode_inputs(cuda, n, d, m, seed=0, shift=0.0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, d, device=cuda, generator=g)
    w_enc = torch.randn(d, m, device=cuda, generator=g) * d ** -0.5
    b_enc = torch.randn(m, device=cuda, generator=g) * 0.1 + shift
    b_dec = torch.randn(d, device=cuda, generator=g) * 0.1
    return x, w_enc, b_enc, b_dec


def _assert_encode_matches(x, w_enc, b_enc, b_dec, k):
    out = tk.sae_encode_topk_fused(x, w_enc, b_enc, b_dec, k)
    torch.cuda.synchronize()
    acts = tk.sae_encode_acts_plain(x, w_enc, b_enc, b_dec)
    ref = tk.topk_threshold_mask_plain(acts, k)
    tol = 1e-3  # as test_encode_topk_kernel_matches_plain
    kept, kept_ref = out > 0, ref > 0
    both = kept & kept_ref
    assert torch.allclose(out[both], ref[both], atol=tol, rtol=0)
    kth = torch.where(kept_ref, acts, torch.inf).amin(-1, keepdim=True)
    assert torch.all((acts - kth).abs()[kept ^ kept_ref] <= tol)
    return out, acts


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 129, 7237])
def test_encode_topk_kernel_ragged_rows(cuda, n):
    """Row counts around the 128-row tile and the two-tile cluster."""
    _assert_encode_matches(*_encode_inputs(cuda, n, 1024, 4096, seed=n), 128)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 512], ids=["k_one", "k_all"])
def test_encode_topk_kernel_k_extremes(cuda, k):
    out, acts = _assert_encode_matches(*_encode_inputs(cuda, 300, 128, 512, seed=k), k)
    if k == 512:  # every entry is kept: the dense activations
        assert torch.allclose(out, acts, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_encode_topk_kernel_fewer_than_k_positives(cuda):
    """A bias far below zero leaves most rows with fewer than k positive
    entries: those rows keep every positive entry."""
    x, w_enc, b_enc, b_dec = _encode_inputs(cuda, 300, 128, 512, seed=7, shift=-3.5)
    out, acts = _assert_encode_matches(x, w_enc, b_enc, b_dec, 64)
    short = (acts > 0).sum(-1) < 64
    assert bool(short.any())
    assert torch.equal(out[short] > 0, acts[short] > 0)


@pytest.mark.cuda
def test_encode_topk_kernel_forced_ties(cuda):
    """x = 0 and b_dec = 0 make every row the same relu(b_enc), whose
    values repeat in blocks of eight: the k-th value is tied many times,
    and every copy of it is kept."""
    d, m, k = 128, 512, 20
    x = torch.zeros(300, d, device=cuda)
    w_enc = torch.randn(d, m, device=cuda)
    b_enc = torch.arange(m // 8, device=cuda, dtype=torch.float32).repeat_interleave(8) / 8
    out = tk.sae_encode_topk_fused(x, w_enc, b_enc, torch.zeros(d, device=cuda), k)
    torch.cuda.synchronize()
    ref = tk.topk_threshold_mask_plain(torch.relu(b_enc).expand(300, m).contiguous(), k)
    assert torch.equal(out, ref)
    assert int((out[0] > 0).sum()) == 24


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties", "fewer_than_k", "specials", "k_one", "k_all"])
def test_topk_sparsify_kernel_edge_rows(cuda, case):
    """The radix select (topk_sparsify's entry) bit-equal to the plain
    31-step search on the select's edge rows."""
    rng = np.random.default_rng(9)
    m, k = 4096, 128
    acts = np.maximum(rng.normal(size=(129, m)), 0).astype(np.float32)
    if case == "ties":
        acts = np.round(acts * 4) / 4
    elif case == "fewer_than_k":
        acts[:, 100:] = 0.0
        acts[::2] = -acts[::2]
    elif case == "specials":
        acts[0, :200] = np.float32(3.4028235e38)
        acts[1, :50] = np.inf
        acts[1, 50:60] = np.nan
        acts[2] = np.float32(1e-41) * (acts[2] > 0)
        acts[3, ::3] = -0.0
    elif case == "k_one":
        k = 1
    else:
        k = m
    x = torch.from_numpy(acts).to(cuda)
    out = tk.topk_sparsify(x, k)
    torch.cuda.synchronize()
    ref = tk.topk_threshold_mask_plain(x, k)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "zero_rows", "ragged"])
def test_decode_kernel_edge_codes(cuda, case):
    """Dense codes (all of M a row), all-zero rows, and N, M and D off
    the kernel's tile, window and column slice."""
    n, m, d = {"dense": (300, 512, 128), "zero_rows": (300, 512, 128),
               "ragged": (7237, 4092, 1020)}[case]
    g = torch.Generator(device=cuda).manual_seed(3)
    codes = torch.rand(n, m, device=cuda, generator=g)
    if case == "zero_rows":
        codes[::3] = 0.0
    elif case == "ragged":
        codes = tk.topk_threshold_mask_plain(codes, 128)
    w_dec = torch.randn(m, d, device=cuda, generator=g) * 0.05
    b_dec = torch.randn(d, device=cuda, generator=g) * 0.1
    out = tk.sae_decode_fused(codes, w_dec, b_dec)
    torch.cuda.synchronize()
    ref = tk.sae_decode_fused_plain(codes, w_dec, b_dec)
    # fp32 sums in another order: ~k terms, or all m (dense) of size ~0.05
    assert torch.allclose(out, ref, atol=1e-4, rtol=1e-5)
    if case == "zero_rows":
        assert torch.equal(out[::3], b_dec.expand(out[::3].shape))
