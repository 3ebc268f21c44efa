"""The four SAE ``torch.autograd.Function``s of the port (forward: the
kernel wrapper; backward: the reference's fp32 matmuls) against the JAX
package's custom VJPs (``jax.vjp``, Pallas in interpret mode) and
against autograd through a plain version of the same function, at 1e-5
relative; and (on a card) each Function's backward at the flagship's
SAE shape against the plain version's autograd.

A gradient comparison is meaningful only where both sides keep the same
entries, so the inputs keep each row's k-th and (k+1)-th values apart
(``_near_tie_rows``) and the tests assert equal supports first.  Where
the plain version rounds to bf16 (the vote), its autograd rounds the
cotangent too, so the cotangents are values bf16 holds exactly.

The JAX side is imported inside fixtures, so that on a machine with a
card and no JAX the CUDA tests still run:
``python -m pytest --noconftest -m cuda tests/test_torch_train_functions.py``.
"""

import numpy as np
import pytest
import torch

from sls_tpu_torch.kernels import sae_kernels as tk
from sls_tpu_torch.sae import sparsify as tsp
from test_torch_sae_kernels import _near_tie_rows

D, M, N, K = 128, 512, 200, 16
VB, VT, VM, VK, VW = 3, 40, 256, 16, 8  # the vote's [B, T, M], k and window
GRAD_REL = 1e-5  # fp32 sums of the same products in other orders
GAP = 1e-2       # each row's k-th and (k+1)-th values at least this far apart (relative)


@pytest.fixture(scope="module")
def jax_sk():
    return pytest.importorskip("sls_tpu.kernels.sae_kernels")


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def interpret(jax_sk):
    """Route the JAX package's SAE kernels through Pallas interpret mode."""
    names = ("sae_encode_fused", "window_vote_fused", "sae_encode_topk_fused",
             "sae_decode_fused")
    with pytest.MonkeyPatch.context() as mp:
        for name in names:
            fn = getattr(jax_sk, name)
            mp.setattr(jax_sk, name,
                       lambda *a, _fn=fn, **kw: _fn(*a, **{**kw, "interpret": True}))
        yield jax_sk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def enc():
    """Encode inputs whose rows all have a clear gap at k (rows drawn, and
    those near a tie in fp64 left out), and a cotangent."""
    rng = np.random.default_rng(0)
    w_enc = rng.normal(size=(D, M)) * 0.05
    b_enc = rng.normal(size=(M,)) * 0.1
    b_dec = rng.normal(size=(D,)) * 0.1
    x = rng.normal(size=(4 * N, D))
    acts = np.maximum((x - b_dec) @ w_enc + b_enc, 0.0)
    x = x[~_near_tie_rows(acts, K, GAP)][:N]
    assert len(x) == N
    f32 = np.float32
    return {"x": x.astype(f32), "w_enc": w_enc.astype(f32), "b_enc": b_enc.astype(f32),
            "b_dec": b_dec.astype(f32), "g": rng.normal(size=(N, M)).astype(f32),
            "w_dec": (rng.normal(size=(M, D)) * 0.05).astype(f32),
            "g_dec": rng.normal(size=(N, D)).astype(f32)}


def _leaves(w, *names):
    return [torch.tensor(w[n], requires_grad=True) for n in names]


def _port_grads(fn, inputs, g):
    out = fn(*inputs)
    out.backward(g)
    return out.detach(), [t.grad for t in inputs]


def _jax_grads(jax, fn, arrays, g):
    out, vjp = jax.vjp(fn, *[jax.numpy.asarray(a) for a in arrays])
    return np.asarray(out), [np.asarray(d) for d in vjp(jax.numpy.asarray(g))]


def _check(grads, refs, what):
    for i, (a, b) in enumerate(zip(grads, refs)):
        assert rel(a, b) <= GRAD_REL, f"{what}: input {i}, relative L2 {rel(a, b):.2e}"


ENC_NAMES = ("x", "w_enc", "b_enc", "b_dec")


def test_encode_topk_backward(enc, interpret, jax):
    inputs = _leaves(enc, *ENC_NAMES)
    out, grads = _port_grads(lambda *a: tk.sae_encode_topk(*a, K), inputs,
                             torch.from_numpy(enc["g"]))
    j_out, j_grads = _jax_grads(jax, lambda *a: interpret.sae_encode_topk(*a, K),
                                [enc[n] for n in ENC_NAMES], enc["g"])
    np.testing.assert_array_equal(out.numpy() > 0, j_out > 0)
    _check(grads, j_grads, "against jax.vjp")
    # autograd through the fp32 encode and the plain top-k rule: the same
    # function but for the bf16 rounding of the forward, with the same support
    plain = _leaves(enc, *ENC_NAMES)
    p_out, p_grads = _port_grads(
        lambda x, w, be, bd: tsp.topk_per_row(tk.sae_encode_fused_plain(x, w, be, bd), K),
        plain, torch.from_numpy(enc["g"]))
    assert torch.equal(out > 0, p_out > 0)
    _check(grads, p_grads, "against autograd through the plain version")


def test_encode_relu_backward(enc, interpret, jax):
    inputs = _leaves(enc, *ENC_NAMES)
    g = torch.from_numpy(enc["g"])
    out, grads = _port_grads(tk.sae_encode_relu, inputs, g)
    j_out, j_grads = _jax_grads(jax, interpret.sae_encode_relu, [enc[n] for n in ENC_NAMES],
                                enc["g"])
    np.testing.assert_array_equal(out.numpy() > 0, j_out > 0)
    _check(grads, j_grads, "against jax.vjp")
    p_out, p_grads = _port_grads(tk.sae_encode_fused_plain, _leaves(enc, *ENC_NAMES), g)
    assert torch.equal(out > 0, p_out > 0)
    _check(grads, p_grads, "against autograd through the plain version")


def test_decode_backward(enc, interpret, jax):
    codes = tk.sae_encode_topk_fused_plain(*[torch.from_numpy(enc[n]) for n in ENC_NAMES], K)
    arrays = {"codes": codes.numpy(), "w_dec": enc["w_dec"], "b_dec": enc["b_dec"]}
    names = ("codes", "w_dec", "b_dec")
    g = torch.from_numpy(enc["g_dec"])
    _, grads = _port_grads(tk.sae_decode, _leaves(arrays, *names), g)
    _, j_grads = _jax_grads(jax, interpret.sae_decode, [arrays[n] for n in names], enc["g_dec"])
    _check(grads, j_grads, "against jax.vjp")
    _, p_grads = _port_grads(tk.sae_decode_fused_plain, _leaves(arrays, *names), g)
    _check(grads, p_grads, "against autograd through the plain version")


def vote_inputs(rng, batch, frames, m, window):
    """Post-ReLU activations whose window sums and frame votes keep their
    k-th and (k+1)-th values apart: each utterance's features take the
    levels of a 1.03-ratio ladder in a permutation of their own (so no
    sum of frames, and no vote doubled by two covering windows, meets
    another's), each frame with 0.1 % noise; and a cotangent bf16 holds."""
    levels = 1.03 ** np.arange(m)
    perm = np.stack([rng.permutation(m) for _ in range(batch)])
    acts = levels[perm][:, None, :] * (1 + 1e-3 * rng.uniform(size=(batch, frames, m)))
    g = torch.from_numpy(rng.normal(size=acts.shape).astype(np.float32))
    return acts.astype(np.float32), g.bfloat16().float()


def vote_ties(acts, k, window):
    """Window rows and frame-vote rows near a tie at k (fp64)."""
    x = torch.from_numpy(acts).double()
    stride, nw, _, _ = tsp._overlap_geometry(x.shape[1], window)
    sums = x.unfold(1, window, stride).sum(-1)  # [B, nw, M]
    top = torch.topk(sums, k, dim=-1).values[..., -1:]
    cover = tsp._coverage_matrix(x.shape[1], window, stride, nw).double()
    votes = x * torch.einsum("it,bid->btd", cover, (sums >= top).double())
    m = x.shape[-1]
    return (_near_tie_rows(sums.reshape(-1, m).numpy(), k, GAP),
            _near_tie_rows(votes.reshape(-1, m).numpy(), k, GAP))


def test_window_vote_backward(interpret, jax):
    acts, g = vote_inputs(np.random.default_rng(1), VB, VT, VM, VW)
    wins, frames = vote_ties(acts, VK, VW)
    assert not wins.any() and not frames.any()
    (a,) = _leaves({"a": acts}, "a")
    out, (grad,) = _port_grads(lambda t: tk.window_topk_overlap(t, VK, VW), [a], g)
    j_out, (j_grad,) = _jax_grads(
        jax, lambda t: interpret.window_topk_overlap_pallas(t, VK, VW), [acts], g.numpy())
    np.testing.assert_array_equal(out.numpy() > 0, j_out > 0)
    assert torch.equal(grad, torch.tensor(j_grad))
    (b,) = _leaves({"a": acts}, "a")
    p_out, (p_grad,) = _port_grads(lambda t: tk.window_vote_fused_plain(t, VK, VW), [b], g)
    assert torch.equal(out > 0, p_out > 0)
    assert torch.equal(grad, p_grad)
    # the fp32 rule keeps the same entries on these inputs, so its
    # autograd is the same mask
    (c,) = _leaves({"a": acts}, "a")
    r_out, (r_grad,) = _port_grads(lambda t: tsp.window_topk_overlap(t, VK, VW), [c], g)
    assert torch.equal(out > 0, r_out > 0) and torch.equal(grad, r_grad)


@pytest.mark.parametrize("rule", ["topk_per_row", "window_topk_overlap", "window_topk_hard"])
def test_plain_rules_differentiate_with_constant_masks(rule, jax):
    """The plain (non-``use_pallas``) rules of ``sae/sparsify.py`` as they
    stand: autograd gives the cotangent on the kept entries and zero
    elsewhere, the mask a constant, as ``jax.vjp`` of the JAX rules."""
    jsp = pytest.importorskip("sls_tpu.sae.sparsify")
    acts, g = vote_inputs(np.random.default_rng(3), VB, VT, VM, VW)
    args = () if rule == "topk_per_row" else (VW,)
    (a,) = _leaves({"a": acts}, "a")
    out, (grad,) = _port_grads(lambda t: getattr(tsp, rule)(t, VK, *args), [a], g)
    assert torch.equal(grad, torch.where(out > 0, g, 0.0))
    j_out, (j_grad,) = _jax_grads(jax, lambda t: getattr(jsp, rule)(t, VK, *args), [acts],
                                  g.numpy())
    np.testing.assert_array_equal(out.numpy() > 0, j_out > 0)
    assert torch.equal(grad, torch.tensor(j_grad))


def test_functions_launch_once_and_save_the_codes(monkeypatch):
    """A Function's forward calls its wrapper once and its backward never;
    the encode keeps its output itself as the backward's mask, the tensor
    the decode saves too."""
    calls = []
    for name in ("sae_encode_topk_fused", "sae_decode_fused"):
        real = getattr(tk, name)
        monkeypatch.setattr(tk, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(8, D)).astype(np.float32), requires_grad=True)
    w_enc = torch.tensor((rng.normal(size=(D, M)) * 0.05).astype(np.float32), requires_grad=True)
    b_enc, b_dec = torch.zeros(M, requires_grad=True), torch.zeros(D, requires_grad=True)
    w_dec = torch.tensor((rng.normal(size=(M, D)) * 0.05).astype(np.float32), requires_grad=True)
    codes = tk.sae_encode_topk(x, w_enc, b_enc, b_dec, K)
    recon = tk.sae_decode(codes, w_dec, b_dec)
    assert codes.grad_fn.saved_tensors[3] is codes or \
        codes.grad_fn.saved_tensors[3].data_ptr() == codes.data_ptr()
    assert recon.grad_fn.saved_tensors[0].data_ptr() == codes.data_ptr()
    recon.square().mean().backward()
    assert calls == ["sae_encode_topk_fused", "sae_decode_fused"]
    assert x.grad is not None and w_enc.grad is not None and w_dec.grad is not None


# -- on the card, at the flagship's SAE shape ---------------------------------


def _card_inputs(cuda, n=14 * 201, d=1024, m=4096):
    g = torch.Generator(device=cuda).manual_seed(0)
    w_dec = torch.rand(m, d, device=cuda, generator=g) * 2 - 1
    w_dec = w_dec / torch.linalg.vector_norm(w_dec, dim=1, keepdim=True)
    return {"x": torch.randn(n, d, device=cuda, generator=g), "w_enc": w_dec.t().contiguous(),
            "b_enc": torch.randn(m, device=cuda, generator=g) * 0.1,
            "b_dec": torch.randn(d, device=cuda, generator=g) * 0.1, "w_dec": w_dec,
            "g": torch.randn(n, m, device=cuda, generator=g),
            "g_dec": torch.randn(n, d, device=cuda, generator=g)}


def _card_grads(fn, inputs, g):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    out.backward(g)
    torch.cuda.synchronize()
    return out.detach(), [t.grad for t in leaves]


def _card_check(grads, refs, what):
    for i, (a, b) in enumerate(zip(grads, refs)):
        err = float((a.double() - b.double()).norm() / b.double().norm())
        assert err <= GRAD_REL, f"{what}: input {i}, relative L2 {err:.2e}"


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True], ids=["topk", "relu"])
def test_encode_backward_on_card(cuda, relu):
    """The kernel's support held constant on the fp32 affine map: its
    autograd is the backward the Function must compute."""
    w = _card_inputs(cuda)
    args = [w[n] for n in ENC_NAMES]
    before = (tk.sae_encode_fused if relu else tk.sae_encode_topk_fused).launches
    fn = tk.sae_encode_relu if relu else (lambda *a: tk.sae_encode_topk(*a, 128))
    out, grads = _card_grads(fn, args, w["g"])
    assert (tk.sae_encode_fused if relu else tk.sae_encode_topk_fused).launches == before + 1
    keep = (out > 0).float()
    _, refs = _card_grads(lambda x, we, be, bd: ((x - bd) @ we + be) * keep, args, w["g"])
    _card_check(grads, refs, "encode")


@pytest.mark.cuda
def test_decode_backward_on_card(cuda):
    w = _card_inputs(cuda)
    codes = tk.sae_encode_topk_fused(*[w[n] for n in ENC_NAMES], 128)
    args = [codes, w["w_dec"], w["b_dec"]]
    _, grads = _card_grads(tk.sae_decode, args, w["g_dec"])
    _, refs = _card_grads(tk.sae_decode_fused_plain, args, w["g_dec"])
    _card_check(grads, refs, "decode")


@pytest.mark.cuda
def test_window_vote_backward_on_card(cuda):
    """The kernel is bit-equal to its plain version, so with a cotangent
    bf16 holds the plain version's autograd is the same mask exactly."""
    w = _card_inputs(cuda, n=14 * 201)
    acts = tk.sae_encode_fused(*[w[n] for n in ENC_NAMES]).reshape(14, 201, -1)
    g = w["g"].reshape(14, 201, -1).bfloat16().float()
    out, (grad,) = _card_grads(lambda t: tk.window_topk_overlap(t, 128, 8), [acts], g)
    p_out, (p_grad,) = _card_grads(lambda t: tk.window_vote_fused_plain(t, 128, 8), [acts], g)
    assert torch.equal(out, p_out)
    assert torch.equal(grad, p_grad)
