"""The algorithm of the Hopper window vote kernel (``csrc/window_vote.cu``),
on the CPU: its two-pass radix select over the bf16 patterns
(``kth_bits_bf16_radix_emulated``) held bit-equal to the TPU kernel's 15
halvings, and its walk over stripes of chunks with halo chunks
(``window_vote_stripes_emulated``) held bit-equal to the plain version;
the plain version also against the JAX Pallas kernel in interpret mode
on a shape whose stripes split utterances.  On a card, the kernel against
the stripe walk:
``python -m pytest --noconftest -m cuda tests/test_torch_window_vote_redesign.py``.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from sls_tpu_torch.kernels import sae_kernels as tk

# int16 patterns that exercise every branch of the select: negatives
# (bf16 -0.0 and a negative NaN among them), 0, 1, the largest finite
# value, +inf and positive NaNs
SPECIALS = np.array([-32768, -32767, -1, -0x4000, 0, 1, 2, 0x3F80, 0x3F81, 0x4000,
                     0x7F7F, 0x7F80, 0x7FC0, 0x7FFF], np.int32)


def _assert_select_equal(bits: np.ndarray, k: int) -> None:
    t = torch.from_numpy(np.ascontiguousarray(bits, np.int32))
    assert torch.equal(tk.kth_bits_bf16_radix_emulated(t, k), tk._kth_bits_bf16(t, k))


@st.composite
def pattern_rows(draw):
    """A few rows of M int16 patterns drawn from a small pool (so ties are
    common), from SPECIALS, over all of int16, or as bf16 patterns of ReLU
    values; k anywhere in [1, M], with k = 1 and k = M drawn often."""
    m = draw(st.integers(1, 96))
    n = draw(st.integers(1, 4))
    kind = draw(st.sampled_from(["pool", "specials", "int16", "relu"]))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    if kind == "pool":
        bits = rng.choice(np.array([-1, 0, 1, 0x3F80, 0x4000], np.int32), size=(n, m))
    elif kind == "specials":
        bits = rng.choice(SPECIALS, size=(n, m))
    elif kind == "int16":
        bits = rng.integers(-32768, 32768, size=(n, m)).astype(np.int32)
    else:
        v = torch.from_numpy(np.maximum(rng.normal(size=(n, m)), 0).astype(np.float32))
        bits = v.to(torch.bfloat16).view(torch.int16).int().numpy()
    k = draw(st.one_of(st.just(1), st.just(m), st.integers(1, m)))
    return bits, k


@settings(max_examples=300, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(pattern_rows())
def test_radix_select_bit_equal_to_halvings(case):
    bits, k = case
    _assert_select_equal(bits, k)


@pytest.mark.parametrize("case", ["ties_at_kth", "fewer_than_k_positive", "all_zero",
                                  "negatives_only", "inf_and_nans", "k_one", "k_all"])
def test_radix_select_edge_rows(case):
    """Each edge of the select, as one fixed set of rows."""
    m, k = 64, 8
    rng = np.random.default_rng(4)
    bits = rng.integers(1, 0x7F7F, size=(3, m)).astype(np.int32)
    if case == "ties_at_kth":
        # five 0x4000s, then the k-th (10th) value is one of many tied 0x3F80s
        bits = np.tile(np.int32([0x4000, 0x3F80, 0x3F80, 0x3F80, 0x3F80, 1, 0, -1]), (3, 8))
        k = 10
    elif case == "fewer_than_k_positive":
        bits = np.zeros((3, m), np.int32)
        bits[:, :5] = [1, 0x3F80, 0x7F7F, -1, 0x4000]
    elif case == "all_zero":
        bits = np.zeros((3, m), np.int32)
    elif case == "negatives_only":
        bits = -rng.integers(1, 32769, size=(3, m)).astype(np.int32)
        bits[:, ::5] = -32768  # bf16 -0.0
    elif case == "inf_and_nans":
        bits[:, :4] = [0x7F80, 0x7FC0, 0x7FFF, 0x7F7F]
        bits[1, :12] = 0x7FC0  # more than k NaNs: lo clamps to 0x7F7F
        k = 4
    elif case == "k_one":
        k = 1
    elif case == "k_all":
        k = m
    _assert_select_equal(bits, k)


def _acts(seed, shape, kind="relu"):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=shape), 0).astype(np.float32)
    if kind == "zero_utterance":
        x[0] = 0.0
    elif kind == "ties":
        x = rng.choice(np.float32([0, 0.5, 1, 2]), size=shape)
    elif kind == "few_positive":  # windows with fewer than k positive sums
        x = np.zeros(shape, np.float32)
        x[..., :3] = rng.uniform(0.1, 1.0, size=shape[:-1] + (3,))
    elif kind == "with_inf":  # +inf votes NaN where no window covers it
        x[:, ::7, ::5] = np.inf
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


# (B, T, M, k, window, blocks): T below the window, several stripes an
# utterance, stripes crossing utterances, k = 1 and k = M
STRIPE_CASES = [
    (1, 5, 64, 8, 8, 4), (3, 5, 32, 32, 8, 2), (3, 17, 64, 8, 8, 5),
    (1, 201, 64, 16, 8, 7), (3, 201, 48, 1, 8, 132), (1, 512, 32, 8, 4, 11),
    (3, 512, 32, 32, 16, 9), (2, 17, 64, 64, 16, 3), (3, 40, 24, 1, 4, 132),
]


@pytest.mark.parametrize("case", STRIPE_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("kind", ["relu", "zero_utterance"])
def test_stripe_walk_equals_plain(case, kind):
    b, t, m, k, w, blocks = case
    x = _acts(sum(case), (b, t, m), kind)
    emulated = tk.window_vote_stripes_emulated(x, k, w, blocks)
    assert torch.equal(emulated.view(torch.int32), tk.window_vote_fused_plain(x, k, w).view(torch.int32))


@pytest.mark.parametrize("kind", ["ties", "few_positive", "with_inf"])
def test_stripe_walk_equals_plain_on_ties_and_short_windows(kind):
    x = _acts(7, (3, 33, 32), kind)
    emulated = tk.window_vote_stripes_emulated(x, 16, 8, 10)
    assert torch.equal(emulated.view(torch.int32), tk.window_vote_fused_plain(x, 16, 8).view(torch.int32))


def test_stripes_cover_every_chunk_once():
    b, n_chunks = 36, 51
    seen = [(u, c) for _, u, c0, c1 in tk.vote_stripes(b, n_chunks) for c in range(c0, c1)]
    assert sorted(seen) == [(u, c) for u in range(b) for c in range(n_chunks)]
    sizes = {}
    for blk, _, c0, c1 in tk.vote_stripes(b, n_chunks):
        sizes[blk] = sizes.get(blk, 0) + c1 - c0
    assert len(sizes) == tk.VOTE_BLOCKS and set(sizes.values()) == {13, 14}


def test_plain_matches_jax_kernel_across_stripes():
    """A shape whose stripes (at 7 blocks) split utterances: the plain
    version, which the kernel and the stripe walk are held to, against
    the Pallas kernel in interpret mode."""
    jax_sk = pytest.importorskip("sls_tpu.kernels.sae_kernels")
    jnp = pytest.importorskip("jax.numpy")
    x = _acts(11, (3, 40, 128))
    b, t, _ = x.shape
    _, _, n_chunks = tk._window_geometry(t, 8)
    assert any(c0 > 0 for _, _, c0, _ in tk.vote_stripes(b, n_chunks, 7))
    ref = np.asarray(jax_sk.window_vote_fused(jnp.asarray(x.numpy()), k=16, window=8,
                                              interpret=True))
    out = tk.window_vote_fused_plain(x, 16, 8)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(tk.window_vote_stripes_emulated(x, 16, 8, 7).numpy(), ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(3, 201, 512, 16, 8), (2, 512, 256, 8, 16), (1, 5, 256, 4, 8)],
                         ids=["t201", "t512-window16", "t5"])
def test_kernel_equals_stripe_walk(cuda, case):
    b, t, m, k, w = case
    x = _acts(3, (b, t, m))
    out = tk.window_vote_fused(x.to(cuda), k, w)
    torch.cuda.synchronize()
    ref = tk.window_vote_stripes_emulated(x, k, w)
    assert torch.equal(out.cpu().view(torch.int32), ref.view(torch.int32))
