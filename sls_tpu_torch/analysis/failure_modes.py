"""Temporal failure-mode analyses, own copy of
``sls_tpu/analysis/failure_modes.py``:

- boundary-error correlation (reference: analyze_boundary_semantics.py,
  analyze_boundary_error_correlation.py): do window-boundary Jaccard
  discontinuities correlate with prediction errors?  Welch t-test +
  Cohen's d between correct/incorrect groups.
- transient spikes + activation variance (reference:
  analyze_temporal_failure_modes, model_window_topk.py:661-766)
- discriminative-transients probe (reference:
  analyze_discriminative_transients, model_window_topk.py:939-1167 and
  improved_transient_analysis.py): logistic probes on transient-only vs
  persistent-only feature activations.
- global cue consistency (reference: analyze_global_cue_consistency.py):
  utterance-global top-k cue overlap, not just adjacent frames.

The reference fits its probes with scikit-learn, which the port does not
depend on.  ``LogisticRegression`` and ``cross_val_score`` here are the
two pieces it uses, with scikit-learn's defaults and fold rule:

- ``LogisticRegression(max_iter=1000)``: L2 penalty (C = 1), a fitted
  intercept that is not penalised, one coefficient row for two classes
  (the sigmoid form) and one a class for more (the multinomial form);
  the objective is scikit-learn's, mean(loss) + ||W||^2 / (2 C n), which
  is strictly convex in W with one minimiser.  It is fitted in float64
  by ``torch.optim.LBFGS`` with a strong Wolfe line search until the
  largest gradient entry is below ``GRAD_TOL``, well inside the 1e-4 at
  which scikit-learn's lbfgs stops, so the fit is the minimiser itself;
  the multinomial intercepts are centred (the softmax ignores a shift
  of all of them, and scikit-learn's iterates keep their sum at 0).
- ``cross_val_score(clf, x, y, cv=k)``: ``StratifiedKFold(k,
  shuffle=False)``'s folds (``stratified_test_folds``) scored by
  accuracy.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from sls_tpu_torch.analysis.temporal import (
    boundary_discontinuity,
    jaccard_consecutive,
    transient_persistent_split,
)


GRAD_TOL = 1e-10  # LogisticRegression's stop: the largest entry of the objective's gradient
L2_C = 1.0        # scikit-learn's default inverse penalty, the reference's probes' C


class LogisticRegression:
    """scikit-learn's ``LogisticRegression`` at its defaults (module
    docstring): ``fit`` sets ``classes_`` (sorted), ``coef_`` [1 or K, d]
    and ``intercept_`` [1 or K]; ``predict`` gives labels of
    ``classes_``.  ``random_state`` is taken for the reference's call and
    unused: the fit draws nothing."""

    def __init__(self, max_iter: int = 1000, random_state=None):
        self.max_iter, self.random_state = max_iter, random_state

    def fit(self, x, y) -> "LogisticRegression":
        import torch

        x = torch.as_tensor(np.asarray(x, np.float64))
        self.classes_, y_idx = np.unique(np.asarray(y), return_inverse=True)
        n, d = x.shape
        n_classes = len(self.classes_)
        if n_classes < 2:
            raise ValueError(f"a logistic regression needs two classes, got {self.classes_}")
        rows = 1 if n_classes == 2 else n_classes
        target = torch.as_tensor(y_idx.reshape(-1))
        w = torch.zeros(rows, d + 1, dtype=torch.float64, requires_grad=True)
        l2 = 1.0 / (L2_C * n)

        def objective():
            z = x @ w[:, :d].T + w[:, d]
            if rows == 1:  # log(1 + e^z) - y z
                loss = torch.nn.functional.softplus(z[:, 0]) - target * z[:, 0]
            else:  # logsumexp(z) - z_y
                loss = torch.logsumexp(z, dim=1) - z.gather(1, target[:, None])[:, 0]
            return loss.mean() + 0.5 * l2 * torch.square(w[:, :d]).sum()

        opt = torch.optim.LBFGS([w], lr=1.0, max_iter=self.max_iter, tolerance_grad=GRAD_TOL,
                                tolerance_change=64 * np.finfo(np.float64).eps,
                                history_size=10, line_search_fn="strong_wolfe")

        def closure():
            opt.zero_grad()
            loss = objective()
            loss.backward()
            return loss

        opt.step(closure)
        w = w.detach().numpy()
        self.coef_, self.intercept_ = w[:, :d].copy(), w[:, d].copy()
        if rows > 1:
            self.intercept_ -= self.intercept_.mean()
        return self

    def predict(self, x) -> np.ndarray:
        z = np.asarray(x, np.float64) @ self.coef_.T + self.intercept_
        idx = (z[:, 0] > 0).astype(np.int64) if z.shape[1] == 1 else z.argmax(axis=1)
        return self.classes_[idx]


def stratified_test_folds(y, n_splits: int) -> np.ndarray:
    """The test fold of each sample under ``StratifiedKFold(n_splits,
    shuffle=False)``: classes numbered in order of first appearance, each
    fold's share of a class by a round robin over the sorted labels, and
    each class's samples given to the folds in blocks, in data order."""
    y = np.asarray(y).reshape(-1)
    _, first, inverse = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(first, return_inverse=True)
    y_encoded = class_perm[inverse]
    n_classes = len(first)
    counts = np.bincount(y_encoded)
    if np.all(n_splits > counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of "
                         f"members in each class")
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    folds = np.empty(len(y), dtype=np.int64)
    for k in range(n_classes):
        folds[y_encoded == k] = np.arange(n_splits).repeat(allocation[:, k])
    return folds


def cross_val_score(clf: LogisticRegression, x, y, cv: int) -> np.ndarray:
    """Accuracy on each of ``cv`` stratified test folds of a fresh fit of
    ``clf``'s settings on the other folds: [cv]."""
    x, y = np.asarray(x), np.asarray(y)
    folds = stratified_test_folds(y, cv)
    scores = []
    for i in range(cv):
        test = folds == i
        fit = LogisticRegression(clf.max_iter, clf.random_state).fit(x[~test], y[~test])
        scores.append(float(np.mean(fit.predict(x[test]) == y[test])))
    return np.asarray(scores)


def _cohens_d(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = len(a), len(b)
    if na < 2 or nb < 2:
        return 0.0
    pooled = np.sqrt(
        ((na - 1) * a.var(ddof=1) + (nb - 1) * b.var(ddof=1)) / (na + nb - 2)
    )
    return float((a.mean() - b.mean()) / max(pooled, 1e-12))


def boundary_error_correlation(
    codes: np.ndarray,
    correct: np.ndarray,
    window: int,
    overlap: bool = False,
) -> Dict[str, float]:
    """Per-utterance boundary discontinuity vs prediction correctness.

    codes: [B, T, D]; correct: [B] bool (prediction == label).  Returns
    group means, Welch t-test p-value, and Cohen's d.
    """
    from scipy import stats

    B = codes.shape[0]
    disc = np.array([
        boundary_discontinuity(codes[b : b + 1], window, overlap)["discontinuity"]
        for b in range(B)
    ])
    correct = np.asarray(correct, bool)
    disc_ok, disc_err = disc[correct], disc[~correct]
    if len(disc_ok) < 2 or len(disc_err) < 2:
        return {
            "mean_disc_correct": float(disc_ok.mean()) if len(disc_ok) else 0.0,
            "mean_disc_incorrect": float(disc_err.mean()) if len(disc_err) else 0.0,
            "t_statistic": 0.0,
            "p_value": 1.0,
            "cohens_d": 0.0,
        }
    t_stat, p_val = stats.ttest_ind(disc_err, disc_ok, equal_var=False)
    return {
        "mean_disc_correct": float(disc_ok.mean()),
        "mean_disc_incorrect": float(disc_err.mean()),
        "t_statistic": float(t_stat),
        "p_value": float(p_val),
        "cohens_d": _cohens_d(disc_err, disc_ok),
    }


def transient_spike_stats(codes: np.ndarray) -> Dict[str, float]:
    """Transient-spike + variance failure-mode statistics
    (reference: analyze_temporal_failure_modes).

    A 'spike' is a feature active for exactly one frame with inactive
    neighbors.
    """
    a = np.asarray(codes) > 0
    prev = np.concatenate([np.zeros_like(a[:, :1]), a[:, :-1]], axis=1)
    nxt = np.concatenate([a[:, 1:], np.zeros_like(a[:, :1])], axis=1)
    spikes = a & ~prev & ~nxt
    active = a.sum()
    acts = np.asarray(codes)
    return {
        "spike_fraction": float(spikes.sum() / max(active, 1)),
        "spikes_per_frame": float(spikes.sum(-1).mean()),
        "activation_variance": float(acts[acts > 0].var()) if active else 0.0,
        "mean_jaccard": float(jaccard_consecutive(codes).mean()),
    }


def discriminative_transients_probe(
    codes: np.ndarray,
    labels: np.ndarray,
    lifetime_threshold: Optional[float] = None,
    seed: int = 0,
) -> Dict[str, float]:
    """Are the discriminative features transient or persistent?

    Trains logistic probes on time-pooled activations restricted to
    (a) transient features, (b) persistent features, (c) all features, and
    compares cross-validated accuracy.
    """
    codes = np.asarray(codes)
    # labels often arrive float64 (pandas / np.loadtxt): cast so
    # class-count logic works; use unique counts, not bincount, so label
    # vocabularies like {1, 2} don't pick up a phantom empty 0-bin
    labels = np.asarray(labels).astype(np.int64)
    if lifetime_threshold is None:
        lifetime_threshold = codes.shape[1] / 4

    split = transient_persistent_split(codes, lifetime_threshold)
    pooled = codes.mean(axis=1)  # [B, D]
    _, class_counts = np.unique(labels, return_counts=True)

    def probe_acc(mask: np.ndarray) -> float:
        if mask.sum() == 0 or len(class_counts) < 2:
            return 0.5
        x = pooled[:, mask]
        clf = LogisticRegression(max_iter=1000, random_state=seed)
        folds = min(3, int(class_counts.min()))
        if folds < 2:
            return 0.5
        return float(cross_val_score(clf, x, labels, cv=folds).mean())

    return {
        "n_transient": int(split["transient"].sum()),
        "n_persistent": int(split["persistent"].sum()),
        "acc_transient_only": probe_acc(split["transient"]),
        "acc_persistent_only": probe_acc(split["persistent"]),
        "acc_all": probe_acc(split["ever_active"]),
        "lifetime_threshold": float(lifetime_threshold),
    }


def global_cue_consistency(codes: np.ndarray, top_k: int = 20) -> Dict[str, float]:
    """Utterance-global cue overlap (reference:
    analyze_global_cue_consistency.py compute_global_metrics): for each
    utterance, the top-k features by total activation form the global cue
    set; consistency = mean Jaccard between each frame's active set and
    the global set, plus cross-utterance global-set overlap."""
    codes = np.asarray(codes)
    B, T, D = codes.shape
    totals = codes.sum(axis=1)  # [B, D]
    k = min(top_k, D)
    global_sets = np.argsort(-totals, axis=-1)[:, :k]

    frame_overlap = []
    for b in range(B):
        gset = set(global_sets[b].tolist())
        a = codes[b] > 0
        for t in range(T):
            active = set(np.flatnonzero(a[t]).tolist())
            union = active | gset
            if union:
                frame_overlap.append(len(active & gset) / len(union))

    cross = []
    for i in range(B):
        for j in range(i + 1, B):
            si, sj = set(global_sets[i].tolist()), set(global_sets[j].tolist())
            cross.append(len(si & sj) / len(si | sj))

    return {
        "frame_to_global_jaccard": float(np.mean(frame_overlap)) if frame_overlap else 1.0,
        "cross_utterance_global_jaccard": float(np.mean(cross)) if cross else 1.0,
        "top_k": float(k),
    }
