"""The port's analysis modules (``sls_tpu_torch/analysis/``) against the
JAX package's (``sls_tpu/analysis/``) on the same seeded inputs.

- The numpy modules (``temporal``, ``dsp``, ``importance``,
  ``score_explainer``, ``probes``, ``failure_modes`` and the cue helpers
  of ``attribution``) are copies: indices, counts, masks and feature
  lists must be equal, floats within ``RTOL``.
- ``failure_modes``' own logistic regression and stratified folds
  against scikit-learn 1.9's (imported by this test only): the folds
  equal ``StratifiedKFold``'s, the accuracies of ``cross_val_score``
  equal, the coefficients and intercepts within ``LR_REL_L2`` of
  ``LogisticRegression()``'s and within ``LR_EXACT_REL_L2`` of a
  scikit-learn fit run to tol 1e-14 (the minimiser itself: the port
  fits to it).  scikit-learn's default stop (lbfgs, largest gradient
  entry 1e-4) lands up to ~2e-3 from the minimiser on separable data of
  this size; the seeds below are ones where it lands within LR_REL_L2.
- ``Detector.encode_sae`` / ``classify_codes`` and the gradient and
  ablation attributions on a port Detector holding the JAX one's
  weights (``convert.py``), fp32 on the CPU: within ``ATTR_REL_L2``.
- ``cli/analyze.py``'s ``inspect`` on both packages' models, with the
  classifier reading the codes and reading the reconstruction (the
  port's ``fc1.weight`` is [out, in], the reference's kernel [in, out]).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.linear_model import LogisticRegression as SkLogisticRegression
from sklearn.model_selection import StratifiedKFold
from sklearn.model_selection import cross_val_score as sk_cross_val_score

import sls_tpu.analysis.attribution as j_attr
import sls_tpu.analysis.dsp as j_dsp
import sls_tpu.analysis.failure_modes as j_fm
import sls_tpu.analysis.importance as j_imp
import sls_tpu.analysis.probes as j_probes
import sls_tpu.analysis.score_explainer as j_expl
import sls_tpu.analysis.temporal as j_temporal
from sls_tpu.cli import analyze as j_analyze
from sls_tpu.config import ExperimentConfig, ModelConfig, SAEConfig, TrainConfig, tiny_xlsr_config
from sls_tpu.models.detector import Detector as JaxDetector
from sls_tpu_torch import config as tcfg
from sls_tpu_torch.analysis import attribution as p_attr
from sls_tpu_torch.analysis import dsp as p_dsp
from sls_tpu_torch.analysis import failure_modes as p_fm
from sls_tpu_torch.analysis import importance as p_imp
from sls_tpu_torch.analysis import probes as p_probes
from sls_tpu_torch.analysis import score_explainer as p_expl
from sls_tpu_torch.analysis import temporal as p_temporal
from sls_tpu_torch.cli import analyze as p_analyze
from sls_tpu_torch.convert import detector_state_from_flax
from sls_tpu_torch.models.detector import Detector

RTOL = 1e-6            # the numpy copies: the same operations on the same inputs
ATTR_REL_L2 = 1e-5     # fp32 gradients / probabilities through the two frameworks
LR_REL_L2 = 1e-3       # against scikit-learn's default stop
LR_EXACT_REL_L2 = 1e-5  # against scikit-learn run to tol 1e-14
D, M, K, WAV_LEN = 64, 256, 32, 4000


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers do not oversubscribe the
    cores (no result here depends on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def same(got, want, rtol=RTOL, where="out"):
    """Equal structure; integer / bool / string arrays and values equal,
    floats within ``rtol``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            same(got[k], want[k], rtol, f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, rtol, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, (where, g.dtype, w.dtype)
        if w.dtype.kind in "fc":
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=where)
        else:
            assert np.array_equal(g, w), where
    elif isinstance(want, float):
        assert isinstance(got, float) and got == pytest.approx(want, rel=rtol, abs=0), where
    else:
        assert type(got) is type(want) and got == want, where


def sparse_codes(seed, B=6, T=40, D_=48, p_on=0.08, p_stay=0.8, boost=None):
    """Codes with runs: each feature switches on with ``p_on`` and stays
    on with ``p_stay``; ``boost`` (labels) makes features 0-5 of label-1
    rows switch on five times as often."""
    rng = np.random.default_rng(seed)
    p = np.full((B, D_), p_on)
    if boost is not None:
        p[np.asarray(boost) == 1, :6] *= 5
    a = np.zeros((B, T, D_), bool)
    a[:, 0] = rng.random((B, D_)) < p
    for t in range(1, T):
        a[:, t] = np.where(a[:, t - 1], rng.random((B, D_)) < p_stay, rng.random((B, D_)) < p)
    return (a * rng.uniform(0.1, 2.0, (B, T, D_))).astype(np.float32)


CODES = sparse_codes(0)
EMPTY = np.zeros((2, 20, 8), np.float32)


# -- temporal ------------------------------------------------------------------------

TEMPORAL_CASES = {
    "jaccard_consecutive": ("jaccard_consecutive", (CODES,)),
    "mean_temporal_jaccard": ("mean_temporal_jaccard", (CODES,)),
    "feature_lifetimes": ("feature_lifetimes", (CODES,)),
    "feature_lifetimes_empty": ("feature_lifetimes", (EMPTY,)),
    "flip_counts": ("flip_counts", (CODES,)),
    "boundary_discontinuity": ("boundary_discontinuity", (CODES, 8)),
    "boundary_discontinuity_overlap": ("boundary_discontinuity", (CODES, 8, True)),
    "multi_scale_structure": ("multi_scale_structure", (CODES,)),
    "multi_scale_structure_windows": ("multi_scale_structure", (CODES, (3, 5, 7))),
    "transient_persistent_split": ("transient_persistent_split", (CODES, 3.0)),
    "feature_identity_stability": ("feature_identity_stability", (CODES, 8)),
    "feature_identity_stability_one_window": ("feature_identity_stability", (CODES, 30)),
    "semantic_drift": ("semantic_drift", (CODES, 8)),
    "semantic_drift_top5": ("semantic_drift", (CODES, 4, 5)),
    "semantic_drift_no_window": ("semantic_drift", (CODES, 50)),
    "semantic_drift_empty": ("semantic_drift", (EMPTY, 4)),
    "temporal_summary": ("temporal_summary", (CODES,)),
    "temporal_summary_w4": ("temporal_summary", (CODES, 4)),
}


@pytest.mark.parametrize("case", sorted(TEMPORAL_CASES))
def test_temporal_matches_jax(case):
    name, args = TEMPORAL_CASES[case]
    same(getattr(p_temporal, name)(*args), getattr(j_temporal, name)(*args))


def test_temporal_is_whole():
    public = {n for n in dir(j_temporal) if not n.startswith("_") and callable(
        getattr(j_temporal, n)) and getattr(j_temporal, n).__module__ == j_temporal.__name__}
    assert public <= set(dir(p_temporal))
    assert "partial" not in p_temporal.__doc__


# -- dsp, importance, score_explainer ------------------------------------------------

def _wav(seed, n=12480):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 180 * t) * (rng.random() + 0.5)
            + 0.05 * rng.normal(size=n)).astype(np.float32)


WAV = _wav(1)
DSP_CASES = {
    "frame_signal": ("frame_signal", (WAV, 512, 320)),
    "frame_signal_short": ("frame_signal", (WAV[:100], 512, 320)),
    "stft_mag": ("stft_mag", (WAV,)),
    "hz_to_mel": ("hz_to_mel", (np.linspace(0, 8000, 37),)),
    "mel_to_hz": ("mel_to_hz", (np.linspace(0, 40, 37),)),
    "mel_filterbank": ("mel_filterbank", ()),
    "mel_filterbank_args": ("mel_filterbank", (8000, 256, 20, 50.0, 3000.0)),
    "mel_spectrogram": ("mel_spectrogram", (WAV,)),
    "mfcc": ("mfcc", (WAV,)),
    "acoustic_features": ("acoustic_features", (WAV,)),
}


@pytest.mark.parametrize("case", sorted(DSP_CASES))
def test_dsp_matches_jax(case):
    name, args = DSP_CASES[case]
    same(getattr(p_dsp, name)(*args), getattr(j_dsp, name)(*args))
    assert p_dsp.ENCODER_HOP == j_dsp.ENCODER_HOP


LABELS = np.array([0, 1, 1, 0, 1, 0])
IMPORTANCE_CASES = {
    "interpretability_info": ("interpretability_info", (CODES,)),
    "class_feature_importance": ("class_feature_importance", (CODES.mean(1), LABELS)),
    "class_feature_importance_top5": ("class_feature_importance", (CODES.mean(1), LABELS, 5)),
    "class_feature_importance_one_class": ("class_feature_importance",
                                           (CODES.mean(1), np.ones(6, int))),
    "per_feature_class_stats": ("per_feature_class_stats", (CODES, LABELS)),
    "per_feature_class_stats_one_class": ("per_feature_class_stats", (CODES, np.zeros(6, int))),
}


@pytest.mark.parametrize("case", sorted(IMPORTANCE_CASES))
def test_importance_matches_jax(case):
    name, args = IMPORTANCE_CASES[case]
    same(getattr(p_imp, name)(*args), getattr(j_imp, name)(*args))


@pytest.mark.parametrize("kwargs", [{}, {"seed": 3, "T": 21, "D": 64, "k": 8}],
                         ids=["default", "small"])
def test_score_explainer_matches_jax(kwargs):
    same(p_expl.simulate_score_pipeline(**kwargs), j_expl.simulate_score_pipeline(**kwargs))


def test_score_explainer_main_prints_the_same(capsys):
    assert j_expl.main() == 0
    want = capsys.readouterr().out
    assert p_expl.main() == 0
    assert capsys.readouterr().out == want


# -- probes --------------------------------------------------------------------------

WAVS = np.stack([_wav(s) for s in range(6)])
PHN = [(0, 1500, "h#"), (1500, 4000, "aa"), (4000, 4100, "b"), (4100, 9000, "iy"),
       (9000, 12480, "h#")]


def test_parse_phn_and_frame_labels_match_jax(tmp_path):
    path = tmp_path / "utt.PHN"
    path.write_text("".join(f"{a} {b} {p}\n" for a, b, p in PHN) + "bad line\n")
    segs = p_probes.parse_phn_file(path)
    assert segs == j_probes.parse_phn_file(path) == PHN
    for n_frames, hop in ((40, 320), (30, 320), (80, 160)):
        assert (p_probes.phoneme_frame_labels(segs, n_frames, hop)
                == j_probes.phoneme_frame_labels(segs, n_frames, hop))


def _frame_labels():
    lab = j_probes.phoneme_frame_labels(PHN, 40)
    return [lab, lab[:25], [None] * 40, lab[::-1], lab, lab]


PROBE_CASES = {
    "acoustic_probe": ("acoustic_probe", (CODES, WAVS), {}),
    "acoustic_probe_top3": ("acoustic_probe", (CODES, WAVS), {"top_k": 3}),
    "acoustic_probe_short_utterance": ("acoustic_probe", (CODES[:2], np.stack(
        [WAVS[0, :6000], WAVS[1, :6000]])), {}),
    "acoustic_probe_by_group": ("acoustic_probe_by_group",
                                (CODES, WAVS, ["A01", "A02", "A01", "bona", "A02", "A01"]),
                                {"top_k": 4}),
    "phoneme_probe": ("phoneme_probe", (CODES, _frame_labels()), {}),
    "phoneme_probe_no_labels": ("phoneme_probe", (CODES, [[None] * 40] * 6), {}),
    "handcrafted_stability_comparison": ("handcrafted_stability_comparison", (CODES, WAVS), {}),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probes_match_jax(case):
    name, args, kwargs = PROBE_CASES[case]
    same(getattr(p_probes, name)(*args, **kwargs), getattr(j_probes, name)(*args, **kwargs))


# -- failure modes -------------------------------------------------------------------

CORRECT = np.array([True, False, True, True, False, True])
FAILURE_CASES = {
    "boundary_error_correlation": ("boundary_error_correlation", (CODES, CORRECT, 8)),
    "boundary_error_correlation_overlap": ("boundary_error_correlation",
                                           (CODES, CORRECT, 8, True)),
    "boundary_error_correlation_one_error": ("boundary_error_correlation",
                                             (CODES, np.arange(6) > 0, 4)),
    "transient_spike_stats": ("transient_spike_stats", (CODES,)),
    "transient_spike_stats_empty": ("transient_spike_stats", (EMPTY,)),
    "global_cue_consistency": ("global_cue_consistency", (CODES,)),
    "global_cue_consistency_top5": ("global_cue_consistency", (CODES, 5)),
    "cohens_d": ("_cohens_d", (CODES[:, :, 0].mean(1), CODES[:, :, 1].mean(1))),
    "cohens_d_short": ("_cohens_d", (np.ones(1), np.ones(4))),
}


@pytest.mark.parametrize("case", sorted(FAILURE_CASES))
def test_failure_modes_match_jax(case):
    name, args = FAILURE_CASES[case]
    same(getattr(p_fm, name)(*args), getattr(j_fm, name)(*args))


# the probe's data: features 0-5 of label-1 rows switch on five times as
# often, so the pooled codes have a margin and the fits' predictions do
# not sit on the decision boundary
PROBE_LABELS = {
    "labels_01": np.tile([0, 1], 12),
    "labels_12": np.tile([1, 2], 12),
    "unbalanced": np.array([0] * 17 + [1] * 7),
    "three_classes": np.tile([0, 1, 2], 8),
    "one_class": np.zeros(24, int),
    "float_labels": np.tile([0.0, 1.0], 12),
}


@pytest.mark.parametrize("name", sorted(PROBE_LABELS))
def test_discriminative_transients_probe_matches_jax(name):
    labels = PROBE_LABELS[name]
    codes = sparse_codes(5, B=24, T=40, boost=labels == labels.max())
    got = p_fm.discriminative_transients_probe(codes, labels)
    same(got, j_fm.discriminative_transients_probe(codes, labels))
    if name != "one_class":
        assert got["acc_all"] > 0.5  # the boost is found: not a test of chance agreement


# -- the own logistic regression and folds against scikit-learn ------------------------

def _lr_data(kind, seed):
    rng = np.random.default_rng(seed)
    n, d = (60, 4) if kind != "three_classes" else (90, 6)
    classes = {"separable": (0, 1), "overlapping": (0, 1), "labels_12": (1, 2),
               "unbalanced": (0, 1), "three_classes": (0, 1, 2)}[kind]
    p = [0.8, 0.2] if kind == "unbalanced" else None
    y = rng.choice(classes, n, p=p)
    shift = 2.5 if kind == "separable" else 0.7
    x = rng.normal(size=(n, d)) + shift * np.searchsorted(classes, y)[:, None]
    return x, y


LR_CASES = {"separable": 4, "overlapping": 0, "labels_12": 0, "unbalanced": 0,
            "three_classes": 0}  # kind: seed


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


@pytest.mark.parametrize("kind", sorted(LR_CASES))
def test_logistic_regression_matches_sklearn(kind):
    x, y = _lr_data(kind, LR_CASES[kind])
    got = p_fm.LogisticRegression(max_iter=1000, random_state=0).fit(x, y)
    want = SkLogisticRegression(max_iter=1000, random_state=0).fit(x, y)
    exact = SkLogisticRegression(max_iter=100000, tol=1e-14).fit(x, y)
    assert np.array_equal(got.classes_, want.classes_)
    assert got.coef_.shape == want.coef_.shape and got.intercept_.shape == want.intercept_.shape
    assert rel_l2(got.coef_, want.coef_) <= LR_REL_L2
    assert rel_l2(got.intercept_, want.intercept_) <= LR_REL_L2
    assert rel_l2(got.coef_, exact.coef_) <= LR_EXACT_REL_L2
    assert rel_l2(got.intercept_, exact.intercept_) <= LR_EXACT_REL_L2
    assert np.array_equal(got.predict(x), want.predict(x))
    if kind == "separable":
        assert np.array_equal(got.predict(x), y)
    scores = p_fm.cross_val_score(p_fm.LogisticRegression(random_state=0), x, y, cv=3)
    np.testing.assert_array_equal(scores, sk_cross_val_score(
        SkLogisticRegression(max_iter=1000, random_state=0), x, y, cv=3))


FOLD_LABELS = {
    "labels_01": np.random.default_rng(0).integers(0, 2, 31),
    "labels_12": np.random.default_rng(1).integers(1, 3, 25),
    "unbalanced": np.array([1] * 4 + [0] * 19 + [1] * 3),
    "three_classes": np.random.default_rng(2).integers(0, 3, 40),
    "first_appearance": np.array([2, 2, 0, 1, 0, 2, 1, 1, 0, 2, 2, 0]),
}


@pytest.mark.parametrize("name", sorted(FOLD_LABELS))
@pytest.mark.parametrize("n_splits", [2, 3])
def test_stratified_folds_match_sklearn(name, n_splits):
    y = FOLD_LABELS[name]
    want = np.empty(len(y), int)
    for i, (_, test) in enumerate(StratifiedKFold(n_splits).split(np.zeros(len(y)), y)):
        want[test] = i
    np.testing.assert_array_equal(p_fm.stratified_test_folds(y, n_splits), want)


def test_logistic_regression_refuses_one_class():
    with pytest.raises(ValueError, match="two classes"):
        p_fm.LogisticRegression().fit(np.ones((4, 2)), np.zeros(4))


# -- attribution ---------------------------------------------------------------------

CUES_A = np.argsort(-CODES.sum(1), axis=-1)[:, :7]
CUES_B = np.argsort(-CODES.max(1), axis=-1)[:, :7]
CUE_CASES = {
    "top_k_cues": ("top_k_cues", (CODES.sum(1),)),
    "top_k_cues_k3": ("top_k_cues", (CODES.sum(1), 3)),
    "cue_jaccard_stability": ("cue_jaccard_stability", (CUES_A, CUES_B)),
    "within_class_cue_consistency": ("within_class_cue_consistency", (CUES_A, LABELS)),
    "within_class_cue_consistency_one_class": ("within_class_cue_consistency",
                                               (CUES_A, np.ones(6, int))),
}


@pytest.mark.parametrize("case", sorted(CUE_CASES))
def test_cue_helpers_match_jax(case):
    name, args = CUE_CASES[case]
    same(getattr(p_attr, name)(*args), getattr(j_attr, name)(*args))


def _model_configs(use_sparse_features=True):
    sae = dict(activation_dim=D, dict_size=M, k=K)
    return (ModelConfig(encoder=tiny_xlsr_config(), sae=SAEConfig(**sae),
                        use_sparse_features=use_sparse_features, classifier_hidden=32),
            tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(), sae=tcfg.SAEConfig(**sae),
                             use_sparse_features=use_sparse_features, classifier_hidden=32))


def _pair(use_sparse_features=True):
    """(JAX Detector, its params perturbed, port Detector holding them)."""
    jcfg, pcfg = _model_configs(use_sparse_features)
    jmodel = JaxDetector(jcfg)
    wav = jnp.zeros((2, WAV_LEN), jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(0), wav)["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), params)
    port = Detector(pcfg, device="cpu")
    port.load_state_dict(detector_state_from_flax(params), strict=True)
    return jmodel, params, port


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def wavs8():
    return np.random.default_rng(2).normal(0, 0.1, (8, WAV_LEN)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_codes(pair, wavs8):
    jmodel, params, _ = pair
    out = jmodel.apply({"params": params}, jnp.asarray(wavs8), method="encode_sae")
    return {k: np.array(v) for k, v in out.items()}


def test_encode_sae_matches_jax_and_forward(pair, wavs8, jax_codes):
    _, _, port = pair
    with torch.inference_mode():
        got = port.encode_sae(torch.from_numpy(wavs8))
        full = port(torch.from_numpy(wavs8))
    assert set(got) == {"features", "codes"}
    assert rel_l2(got["features"].numpy(), jax_codes["features"]) <= ATTR_REL_L2
    assert np.array_equal(got["codes"].numpy() > 0, jax_codes["codes"] > 0)
    assert rel_l2(got["codes"].numpy(), jax_codes["codes"]) <= ATTR_REL_L2
    assert torch.equal(got["codes"], full["codes"])  # the forward's codes, bit for bit
    assert torch.equal(got["features"], full["features"])


def test_classify_codes_matches_jax(pair, jax_codes):
    jmodel, params, port = pair
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(jax_codes["codes"]),
                                   method="classify_codes"))
    with torch.inference_mode():
        got = port.classify_codes(torch.from_numpy(jax_codes["codes"])).numpy()
    assert rel_l2(got, want) <= ATTR_REL_L2


def test_gradient_attribution_matches_jax(pair, jax_codes):
    jmodel, params, port = pair
    codes = jax_codes["codes"]
    want = j_attr.gradient_attribution(jmodel, params, jnp.asarray(codes))
    with torch.inference_mode():  # as the CLI collects them: inference tensors
        codes_t = torch.from_numpy(codes).clone()
    got = p_attr.gradient_attribution(port, codes_t)
    assert got.shape == want.shape and rel_l2(got, want) <= ATTR_REL_L2
    got_s = p_attr.attribution_scores(port, codes)
    want_s = j_attr.attribution_scores(jmodel, params, jnp.asarray(codes))
    assert rel_l2(got_s, want_s) <= ATTR_REL_L2
    np.testing.assert_array_equal(p_attr.top_k_cues(got_s, 5), j_attr.top_k_cues(want_s, 5))


@pytest.mark.parametrize("batch_features", [4, 256])
def test_ablation_attribution_matches_jax(pair, jax_codes, batch_features):
    jmodel, params, port = pair
    codes = jax_codes["codes"]
    ids = np.argsort(-(codes > 0).sum((0, 1)))[:10]
    want = j_attr.ablation_attribution(jmodel, params, jnp.asarray(codes), ids,
                                       batch_features=batch_features)
    got = p_attr.ablation_attribution(port, codes, ids, batch_features=batch_features)
    assert got.shape == want.shape == (8, 10)
    assert rel_l2(got, want) <= ATTR_REL_L2


@pytest.mark.parametrize("use_sparse_features", [True, False], ids=["codes", "recon"])
def test_inspect_matches_jax(use_sparse_features):
    jmodel, params, port = _pair(use_sparse_features)
    jcfg, pcfg = _model_configs(use_sparse_features)
    args = argparse.Namespace(seed=3)
    want = j_analyze.cmd_inspect(args, ExperimentConfig(
        model=jcfg, train=TrainConfig(cut_length=WAV_LEN)), jmodel, params, None)
    got = p_analyze.cmd_inspect(args, tcfg.ExperimentConfig(
        model=pcfg, train=tcfg.TrainConfig(cut_length=WAV_LEN)), port, None)
    assert got["inferred"]["uses_sparse_features"] is use_sparse_features
    assert got["inferred"]["classifier_input_dim"] == (M if use_sparse_features else D)
    assert got["config_weight_consistency"] is True
    same(got, want, rtol=0.0)
