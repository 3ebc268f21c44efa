"""The port's training mode on its own (no JAX): dropout statistics and
determinism, eval unchanged by dropout rates, remat against no remat with
dropout on, ``freeze_encoder`` under ``torch.no_grad()``, every eval-only
kernel route bypassed under ``train``, and the refusals."""

import dataclasses

import numpy as np
import pytest
import torch

from sls_tpu_torch import config as tcfg
from sls_tpu_torch.encoder import xlsr
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.train.steps import dropout_generator, train_loss

D, M, K = 64, 256, 32
RATES = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these tiny CPU models: the suite's parallel
    workers then do not oversubscribe the cores (no result depends on
    the thread count within a test)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(sae=None, **enc):
    return tcfg.ModelConfig(
        encoder=tcfg.tiny_xlsr_config(**enc),
        sae=tcfg.SAEConfig(activation_dim=D, dict_size=M, k=K, use_pallas=True,
                           **(sae or {})))


def _wav(n=3, samples=4000, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(0, 0.1, (n, samples)).astype(np.float32))


def _pair(cfg_a, cfg_b):
    """Two detectors with the same weights (seed 0)."""
    a = Detector(cfg_a, device="cpu")
    b = Detector(cfg_b, device="cpu")
    b.load_state_dict(a.state_dict())
    return a, b


def _loss_and_grads(model, wav, seed=0):
    model.zero_grad(set_to_none=True)
    labels, valid = torch.tensor([0, 1, 1]), torch.ones(3)
    loss, _, out = train_loss(model, tcfg.TrainConfig(), wav, labels, valid,
                              dropout_generator(seed, 0, "cpu"))
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}, out


@pytest.mark.parametrize("p", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_statistics(p, dtype):
    n = 200_000
    x = torch.full((n,), 3.0, dtype=dtype)
    y = xlsr.dropout(x, p, torch.Generator().manual_seed(0))
    zero = float((y == 0).double().mean())
    assert abs(zero - p) <= 4 * (p * (1 - p) / n) ** 0.5
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1.0) * (x[0] / (1.0 - p)))
    assert y.dtype == dtype
    # the same seed draws the same mask, another seed another
    assert torch.equal(y, xlsr.dropout(x, p, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, xlsr.dropout(x, p, torch.Generator().manual_seed(1)))
    # no generator (eval) or a zero rate: the identity
    assert xlsr.dropout(x, p, None) is x
    assert xlsr.dropout(x, 0.0, torch.Generator()) is x


def test_dropout_only_in_train():
    cfg = _cfg(**RATES, layerdrop=0.2)
    model, plain = _pair(cfg, _cfg())
    wav = _wav()
    with torch.no_grad():
        # eval: the rates change nothing, and a generator is not read
        ev = model(wav)["log_probs"]
        assert torch.equal(ev, plain(wav)["log_probs"])
        assert torch.equal(ev, model(wav, generator=torch.Generator().manual_seed(1))["log_probs"])
        tr = [model(wav, train=True, generator=dropout_generator(s, c, "cpu"))
              for s, c in ((7, 0), (7, 0), (7, 1))]
    assert torch.equal(tr[0]["features"], tr[1]["features"])
    assert torch.equal(tr[0]["log_probs"], tr[1]["log_probs"])
    assert not torch.equal(tr[0]["features"], tr[2]["features"])
    assert not torch.equal(tr[0]["log_probs"], ev)


def test_classifier_dropout():
    """The head's dropout (0.3) after the ReLU, in train mode only: with
    every encoder rate 0 the features of train and eval agree and the
    log-probs do not."""
    model = Detector(_cfg(), device="cpu")
    assert model.classifier.dropout == 0.3
    wav = _wav()
    with torch.no_grad():
        ev = model(wav)
        tr = model(wav, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(ev["features"], tr["features"])
    assert not torch.allclose(ev["log_probs"], tr["log_probs"])


@pytest.mark.parametrize("layerdrop", [0.0, 0.5])
def test_remat_matches_no_remat(layerdrop, monkeypatch):
    """A checkpointed layer replays its forward in the backward: it must
    draw the same dropout masks there (the same loss and gradients)."""
    calls = []
    real = xlsr.checkpoint
    monkeypatch.setattr(xlsr, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    a, b = _pair(_cfg(**RATES, layerdrop=layerdrop, remat=True),
                 _cfg(**RATES, layerdrop=layerdrop, remat=False))
    wav = _wav()
    loss_a, grads_a, _ = _loss_and_grads(a, wav)
    assert len(calls) == a.config.encoder.encoder_layers
    loss_b, grads_b, _ = _loss_and_grads(b, wav)
    assert len(calls) == a.config.encoder.encoder_layers
    assert float(loss_a) == pytest.approx(float(loss_b), rel=1e-6)
    for n, g in grads_b.items():
        err = float((grads_a[n] - g).norm() / max(float(g.norm()), 1e-30))
        assert err <= 1e-6, (n, err)


def test_frozen_encoder_runs_without_grad():
    model = Detector(dataclasses.replace(_cfg(**RATES), freeze_encoder=True), device="cpu")
    wav = _wav()
    _, grads, out = _loss_and_grads(model, wav)
    assert not out["features"].requires_grad
    assert all(g is None for n, g in grads.items() if n.startswith("encoder."))
    assert all(g is not None for n, g in grads.items() if not n.startswith("encoder."))
    with torch.no_grad():  # still in train mode: the encoder's dropout is on
        ev = model(wav)["features"]
    assert not torch.equal(out["features"], ev)


# (samples, encoder overrides) where each eval-only route's gate holds:
# the fused front-end at 4005 samples, fused attention and int8 at every
# T, and the long-T kernel at T 256
ROUTES = {
    "fused_frontend_attention_int8": (4005, dict(fused_frontend=True, fused_attention=True,
                                                 int8_serving=True, int8_scope="all")),
    "flash_long_t": (5130, dict(flash_long_t=256)),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_train_bypasses_the_eval_routes(route, monkeypatch):
    samples, enc = ROUTES[route]
    model, plain = _pair(_cfg(**enc), _cfg())
    wav = _wav(samples=samples)
    assert model.config.encoder.num_frames(samples) in (199, 256)
    if "fused_frontend" in enc:
        assert model.encoder.feature_extractor._fused_ok(samples)
    if "flash_long_t" in enc:
        assert model.config.encoder.num_frames(samples) == enc["flash_long_t"]

    def refuse(*a, **kw):
        raise RuntimeError("an eval-only kernel route ran")

    for name in ("frontend_tail_fused", "fused_attention", "flash_attention_long", "int8_dot"):
        monkeypatch.setattr(xlsr, name, refuse)
    with torch.no_grad(), pytest.raises(RuntimeError, match="eval-only"):
        model(wav)  # eval takes the route
    loss, grads, _ = _loss_and_grads(model, wav)
    want_loss, want_grads, _ = _loss_and_grads(plain, wav)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(grads[n], want_grads[n]) for n in want_grads)


def test_train_refusals():
    model = Detector(_cfg(), device="cpu")
    with pytest.raises(ValueError, match="generator"):
        model(_wav(), train=True)
    # sequence parallelism trains (tests/test_torch_sp_train.py), on its mesh alone
    sp = Detector(_cfg(seq_axis="seq"), device="cpu")
    with pytest.raises(ValueError, match="seq_axis"):
        sp.encoder(_wav(), train=True, generator=torch.Generator())
    with pytest.raises(ValueError, match="needs the mesh"):
        sp(_wav(), train=True, generator=torch.Generator())
