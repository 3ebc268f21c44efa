"""The port's training losses against the JAX package's
(``sls_tpu/train/loss.py``): ``weighted_nll`` with and without the
``valid`` mask, at the default and other class weights, and ``nll``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sls_tpu.train import loss as jax_loss
from sls_tpu_torch.train import loss as port_loss


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 2)).astype(np.float32)
    log_probs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = rng.integers(0, 2, 16).astype(np.int32)
    valid = (rng.uniform(size=16) > 0.3).astype(np.float32)
    return log_probs.astype(np.float32), labels, valid


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "valid"])
@pytest.mark.parametrize("weights", [(0.1, 0.9), (1.0, 1.0), (0.7, 0.2)])
def test_weighted_nll_matches_jax(batch, masked, weights):
    log_probs, labels, valid = batch
    v = valid if masked else None
    want = jax_loss.weighted_nll(jnp.asarray(log_probs), jnp.asarray(labels), weights,
                                 None if v is None else jnp.asarray(v))
    got = port_loss.weighted_nll(torch.from_numpy(log_probs), torch.from_numpy(labels), weights,
                                 None if v is None else torch.from_numpy(v))
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_weighted_nll_is_torch_nll_loss(batch):
    """torch's ``NLLLoss(weight=w)`` semantics; the mask drops rows from
    both sums."""
    log_probs, labels, valid = batch
    lp, y = torch.from_numpy(log_probs), torch.from_numpy(labels).long()
    w = torch.tensor([0.1, 0.9])
    assert float(port_loss.weighted_nll(lp, y)) == pytest.approx(
        float(torch.nn.NLLLoss(weight=w)(lp, y)), rel=1e-6)
    keep = torch.from_numpy(valid) > 0
    assert float(port_loss.weighted_nll(lp, y, valid=torch.from_numpy(valid))) == pytest.approx(
        float(torch.nn.NLLLoss(weight=w)(lp[keep], y[keep])), rel=1e-6)


def test_nll_matches_jax(batch):
    log_probs, labels, _ = batch
    want = jax_loss.nll(jnp.asarray(log_probs), jnp.asarray(labels))
    got = port_loss.nll(torch.from_numpy(log_probs), torch.from_numpy(labels))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
