"""The rest of the SAE family against the JAX package: the JumpReLU
threshold functions of ``sae/topk.py`` (``jnp.quantile`` is linear, as
the port's ``kthvalue`` form; one input above 2^24 elements, where
``torch.quantile`` refuses), the legacy tied SAE and its dead-neuron
telemetry, ``analysis/sparsity.py`` and ``geometric_median``.
"""

import numpy as np
import pytest
import torch

from sls_tpu_torch import config as tcfg
from sls_tpu_torch.analysis import sparsity as psp
from sls_tpu_torch.sae.geometry import geometric_median
from sls_tpu_torch.sae.legacy import TiedSparseAutoencoder, dead_neuron_stats
from sls_tpu_torch.sae.topk import TopKSAE, calibrate_threshold, threshold_from_state

TOL = 1e-5  # fp32, the same operations (sums in other orders)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jnp():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    return jnp


def _acts(shape, seed=0):
    """Post-ReLU activations: about half zero, ties at zero."""
    return np.maximum(np.random.default_rng(seed).normal(size=shape), 0).astype(np.float32)


@pytest.mark.parametrize("per_feature", [False, True], ids=["scalar", "per_feature"])
@pytest.mark.parametrize("shape,k", [((3, 50, 64), 8), ((300, 16), 3), ((7, 5), 5)])
def test_calibrate_threshold_matches_jax(jnp, shape, k, per_feature):
    from sls_tpu.sae.topk import calibrate_threshold as jax_calibrate

    acts = _acts(shape)
    want = np.asarray(jax_calibrate(jnp.asarray(acts), k, per_feature=per_feature))
    got = calibrate_threshold(torch.from_numpy(acts), k, per_feature=per_feature).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if k < shape[-1]:  # on average about k activations a frame lie above it
        kept = (acts.reshape(-1, shape[-1]) > got).sum(-1).mean()
        assert abs(kept - k) <= 0.5


def test_calibrate_threshold_above_2_pow_24_elements(jnp):
    from sls_tpu.sae.topk import calibrate_threshold as jax_calibrate

    acts = _acts((4100, 4096), seed=1)  # 16,793,600 > 2^24 = 16,777,216
    x = torch.from_numpy(acts)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(x.reshape(-1), 0.5)
    got = float(calibrate_threshold(x, 128))
    want = float(jax_calibrate(jnp.asarray(acts), 128))
    assert got == pytest.approx(want, rel=1e-6)


def test_calibrate_threshold_nan_column(jnp):
    from sls_tpu.sae.topk import calibrate_threshold as jax_calibrate

    acts = _acts((40, 6), seed=2)
    acts[3, 2] = np.nan
    want = np.asarray(jax_calibrate(jnp.asarray(acts), 2, per_feature=True))
    got = calibrate_threshold(torch.from_numpy(acts), 2, per_feature=True).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)], rtol=1e-6)
    assert np.isnan(float(calibrate_threshold(torch.from_numpy(acts), 2)))


@pytest.mark.parametrize("per_feature", [False, True], ids=["scalar", "per_feature"])
def test_encode_threshold_matches_jax(jnp, per_feature):
    import jax

    from sls_tpu.config import SAEConfig
    from sls_tpu.sae.topk import TopKSAE as JaxTopKSAE
    from sls_tpu_torch.convert import detector_state_from_flax

    D, M = 16, 48
    x = np.random.default_rng(3).normal(size=(2, 9, D)).astype(np.float32)
    jsae = JaxTopKSAE(SAEConfig(activation_dim=D, dict_size=M, k=4))
    params = jsae.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * np.random.default_rng(4).normal(
        size=a.shape).astype(np.float32), params)
    sae = TopKSAE(tcfg.SAEConfig(activation_dim=D, dict_size=M, k=4))
    sae.load_state_dict(detector_state_from_flax(params), strict=True)
    acts = sae.pre_activations(torch.from_numpy(x)).detach()
    thr = calibrate_threshold(acts, 4, per_feature=per_feature)
    want = np.asarray(jsae.apply({"params": params}, jnp.asarray(x), jnp.asarray(thr.numpy()),
                                 method="encode_threshold"))
    got = sae.encode_threshold(torch.from_numpy(x), thr).detach().numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("state,want", [
    ({"module.sae.threshold": torch.tensor(0.25)}, 0.25),
    ({"sae.threshold": np.float32(-1.0)}, None),
    ({"sae.other": torch.tensor(1.0)}, None),
])
def test_threshold_from_state_matches_jax(state, want):
    from sls_tpu.sae.topk import threshold_from_state as jax_threshold_from_state

    got = threshold_from_state(state)
    assert got == want
    assert jax_threshold_from_state({k: np.asarray(v) for k, v in state.items()}) == got


# -- the legacy SAE ------------------------------------------------------------------


def test_tied_sae_matches_jax(jnp):
    import jax

    from sls_tpu.sae.legacy import TiedSparseAutoencoder as JaxTied
    from sls_tpu.sae.legacy import dead_neuron_stats as jax_dead_neuron_stats

    D, H, K = 24, 64, 8
    x = (3.0 * np.random.default_rng(5).normal(size=(3, 11, D))).astype(np.float32)
    jsae = JaxTied(input_dim=D, hidden_dim=H, k=K, clamp_value=2.0)
    params = jsae.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(6)
    params = {k: np.asarray(v) + 0.1 * rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()}
    want = jsae.apply({"params": params}, jnp.asarray(x))
    sae = TiedSparseAutoencoder(D, H, K, clamp_value=2.0, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    assert sae.W.shape == (D, H) and float(sae.W.detach().abs().max()) <= (6.0 / D) ** 0.5
    sae.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()}, strict=True)
    got = sae(torch.from_numpy(x))
    assert set(got) == set(want)
    clamped = float((np.asarray(want["codes"]) == 2.0).mean())
    assert clamped > 0  # the clamp is live
    np.testing.assert_array_equal(got["codes"].detach().numpy() > 0,
                                  np.asarray(want["codes"]) > 0)
    for key in ("codes", "recon"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                   atol=TOL, rtol=0, err_msg=key)
    for key in ("l1_loss", "recon_loss", "loss"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=TOL), key
    codes = np.array(want["codes"])
    codes[..., :5] = 0.0  # five dead features
    assert dead_neuron_stats(torch.from_numpy(codes)) == jax_dead_neuron_stats(codes)
    assert dead_neuron_stats(codes)["dead_ratio"] >= 5 / H


# -- analysis/sparsity ------------------------------------------------------------------


def test_sparsity_analysis_matches_jax():
    from sls_tpu.analysis import sparsity as jsp

    codes = _acts((2, 30, 40), seed=7)
    codes[..., :3] = 0.0
    codes[0, 4] = 0.0  # an inactive frame
    w_dec = np.random.default_rng(8).normal(size=(40, 12)).astype(np.float32)
    t_codes = torch.from_numpy(codes)
    assert psp.sparsity_stats(t_codes) == jsp.sparsity_stats(codes)
    np.testing.assert_array_equal(psp.feature_activation_freq(t_codes),
                                  jsp.feature_activation_freq(codes))
    assert psp.dead_neuron_ratio(t_codes) == jsp.dead_neuron_ratio(codes) == 3 / 40
    got, want = psp.weight_diagnostics(torch.from_numpy(w_dec)), jsp.weight_diagnostics(w_dec)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=TOL), key


# -- geometry -------------------------------------------------------------------------------


@pytest.mark.parametrize("max_iter,tol", [(100, 1e-5), (3, 1e-5), (100, 0.0)],
                         ids=["converges", "max_iter", "runs_to_max"])
def test_geometric_median_matches_jax(jnp, max_iter, tol):
    from sls_tpu.sae.geometry import geometric_median as jax_geometric_median

    rng = np.random.default_rng(9)
    pts = np.concatenate([rng.normal(size=(60, 5)), 20 + rng.normal(size=(6, 5))]
                         ).astype(np.float32)  # outliers pull the mean, not the median
    want = np.asarray(jax_geometric_median(jnp.asarray(pts), max_iter=max_iter, tol=tol))
    got = geometric_median(torch.from_numpy(pts), max_iter=max_iter, tol=tol).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert np.linalg.norm(got) < np.linalg.norm(pts.mean(0))
