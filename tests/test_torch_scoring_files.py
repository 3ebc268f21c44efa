"""The port's official scorers and metrics against the JAX package's: the
ASV operating point and the tandem DCF (``metrics/eer.py``), the 2021
LA / DF / In-the-Wild scorers over organiser key files
(``scores/evaluate.py``, pandas-free in the port) and the standalone
scorers (``scores/standalone.py``, whose ROC curve follows scikit-learn
1.9.0 without it).  Key directories are written here: the phase filter,
a wrong row count, duplicate key rows, swapped labels (the inverted
flag) and the ``bona-fide`` literal.  Results agree at rtol 1e-12 and
every error path raises alike.
"""

import os

import numpy as np
import pytest
from sklearn.metrics import roc_curve as sk_roc_curve

from sls_tpu.metrics import eer as jeer
from sls_tpu.scores import evaluate as jev
from sls_tpu.scores import standalone as jstd
from sls_tpu_torch.metrics import eer as peer
from sls_tpu_torch.scores import evaluate as pev
from sls_tpu_torch.scores import standalone as pstd
from sls_tpu_torch.scores.writer import ScoreWriter

RTOL = 1e-12
LEGACY_COST = {"Pspoof": 0.05, "Ptar": 0.9405, "Pnon": 0.0095, "Cmiss_asv": 1,
               "Cfa_asv": 10, "Cmiss_cm": 1, "Cfa_cm": 10}


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except (ValueError, KeyError) as e:
        return (type(e).__name__, str(e))


def _close(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _close(got[k], want[k])
    elif want is None or isinstance(want, (bool, str)):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _scores(seed, n_b=40, n_s=60, sep=1.0, ties=False):
    rng = np.random.default_rng(seed)
    b, s = rng.normal(sep, 1.0, n_b), rng.normal(-sep, 1.0, n_s)
    if ties:
        b, s = np.round(b, 1), np.round(s, 1)
    return b, s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_asv_error_rates_match_jax(seed):
    rng = np.random.default_rng(seed)
    tar, non, spoof = rng.normal(2, 1, 30), rng.normal(-2, 1, 30), rng.normal(0, 1, 20)
    for thr in (-0.5, 0.0, 0.3):
        _close(peer.asv_error_rates(tar, non, spoof, thr),
               jeer.asv_error_rates(tar, non, spoof, thr))
    _close(peer.asv_error_rates(tar, non, [], 0.0), jeer.asv_error_rates(tar, non, [], 0.0))
    assert peer.DEFAULT_COST_MODEL == jeer.DEFAULT_COST_MODEL


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_tdcf_matches_jax(seed, ties):
    b, s = _scores(seed, ties=ties)
    _close(peer.compute_tdcf(b, s, 0.05, 0.04, 0.3), jeer.compute_tdcf(b, s, 0.05, 0.04, 0.3))
    _close(peer.compute_tdcf(b, s, 0.1, 0.02, 0.4, dict(jeer.DEFAULT_COST_MODEL, Cfa=5.0)),
           jeer.compute_tdcf(b, s, 0.1, 0.02, 0.4, dict(jeer.DEFAULT_COST_MODEL, Cfa=5.0)))
    _close(peer.compute_tdcf_legacy(b, s, 0.05, 0.04, 0.6, LEGACY_COST),
           jeer.compute_tdcf_legacy(b, s, 0.05, 0.04, 0.6, LEGACY_COST))


_B, _S = _scores(9)
_TDCF_ERRORS = [
    ((_B, _S, 0.05, 0.04, None), {}),
    ((_B, _S, 0.05, 0.04, 0.3), {"cost_model": dict(jeer.DEFAULT_COST_MODEL, Pspoof=0.5)}),
    ((_B, _S, 0.05, 0.04, 0.3), {"cost_model": dict(jeer.DEFAULT_COST_MODEL, Ptar=-0.1)}),
    ((np.r_[_B, np.nan], _S, 0.05, 0.04, 0.3), {}),
    ((np.r_[_B, np.inf], _S, 0.05, 0.04, 0.3), {}),
    ((np.array([0.0, 1.0]), np.array([0.0, 1.0]), 0.05, 0.04, 0.3), {}),
    ((_B, _S, 1.0, 1.0, 0.3), {}),  # c1 < 0
]


@pytest.mark.parametrize("args,kw", _TDCF_ERRORS)
def test_tdcf_errors_match_jax(args, kw):
    got, want = _outcome(peer.compute_tdcf, *args, **kw), _outcome(jeer.compute_tdcf, *args,
                                                                     **kw)
    assert got[0] == want[0] != "ok" and got[1] == want[1]


@pytest.mark.parametrize("args,cost", [
    ((_B, _S, 0.05, 0.04, None), LEGACY_COST),
    ((_B, _S, 0.05, 0.04, 0.5), dict(LEGACY_COST, Pspoof=0.5)),
    ((np.r_[_B, np.nan], _S, 0.05, 0.04, 0.5), LEGACY_COST),
    ((np.ones(3), np.ones(3), 0.05, 0.04, 0.5), LEGACY_COST),
    ((_B, _S, 0.05, 0.04, 0.5), dict(LEGACY_COST, Cmiss_asv=1e3)),
])
def test_tdcf_legacy_errors_match_jax(args, cost):
    got = _outcome(peer.compute_tdcf_legacy, *args, cost)
    want = _outcome(jeer.compute_tdcf_legacy, *args, cost)
    assert got[0] == want[0] != "ok" and got[1] == want[1]


# -- key directories --------------------------------------------------------------------


def _write(path, lines):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _truth(tmp_path, n=60, seed=0, dup=0, bona="bonafide", blank=False):
    """An organiser key directory: ASV keys and scores (three phases),
    LA and DF CM keys over ``n`` trials split over the phases, ``dup``
    duplicated key rows (the first rows again), and the score file's
    utterance ids and labels."""
    rng = np.random.default_rng(seed)
    truth = tmp_path / "keys"
    asv_rows, asv_scores = [], []
    for i in range(90):
        kind = ("target", "nontarget", "spoof")[i % 3]
        phase = ("eval", "progress", "eval", "hidden_track")[i % 4]
        mean = {"target": 2.0, "nontarget": -2.0, "spoof": 0.5}[kind]
        asv_rows.append(f"LA_{i:04d} a{i} c d e {kind} f {phase}")
        asv_scores.append(f"x y {rng.normal(mean, 1.0)!r}")
    _write(str(truth / "LA/ASV/trial_metadata.txt"), asv_rows)
    _write(str(truth / "LA/ASV/ASVTorch_Kaldi/score.txt"), asv_scores)
    utts, labels, rows = [], [], []
    for i in range(n):
        u = f"LA_E_{i:07d}"
        lab = bona if i % 3 == 0 else "spoof"
        phase = ("eval", "progress", "eval", "hidden_track", "eval")[i % 5]
        rows.append(f"LA_{i:04d} {u} c d e {lab} f {phase}")
        utts.append(u)
        labels.append(lab)
    rows = rows[:n - dup] + rows[:dup] if dup else rows
    if blank:
        rows.insert(3, "")
    for rel in ("LA/CM/trial_metadata.txt", "CM/trial_metadata.txt", "wild_key.txt"):
        _write(str(truth / rel), rows)
    return truth, utts[:n - dup] if dup else utts, labels


def _score_file(tmp_path, utts, labels, sep=1.0, seed=1, flip=False, extra=0):
    rng = np.random.default_rng(seed)
    scores = [((-1 if flip else 1) * (sep if lab != "spoof" else -sep)) + rng.normal(0, 1.0)
              for lab in labels[:len(utts)]]
    path = tmp_path / f"scores_{seed}_{flip}_{extra}.txt"
    with ScoreWriter(path) as w:
        w.write_batch(utts + utts[:extra], scores + scores[:extra])
    return str(path)


def _same_result(got, want):
    assert got[0] == want[0], (got, want)
    if got[0] != "ok":
        assert got[1] == want[1]
        return
    g, w = got[1], want[1]
    _close((g.eer, g.min_tdcf, g.inverted_is_better), (w.eer, w.min_tdcf, w.inverted_is_better))


@pytest.mark.parametrize("phase", ["eval", "progress", "hidden_track"])
@pytest.mark.parametrize("flip", [False, True])
def test_la_matches_jax(tmp_path, phase, flip):
    truth, utts, labels = _truth(tmp_path)
    sf = _score_file(tmp_path, utts, labels, flip=flip)
    got = _outcome(pev.score_2021_la, sf, str(truth), phase)
    _same_result(got, _outcome(jev.score_2021_la, sf, str(truth), phase))
    assert got[1].inverted_is_better == flip


@pytest.mark.parametrize("phase", ["eval", "progress"])
def test_df_matches_jax(tmp_path, phase):
    truth, utts, labels = _truth(tmp_path, seed=4, blank=True)
    sf = _score_file(tmp_path, utts, labels, sep=0.5)
    _same_result(_outcome(pev.score_2021_df, sf, str(truth), phase),
                 _outcome(jev.score_2021_df, sf, str(truth), phase))


def test_duplicate_key_rows_match_jax(tmp_path):
    truth, utts, labels = _truth(tmp_path, dup=5)
    sf = _score_file(tmp_path, utts, labels, extra=5)  # the row count matches again
    for fn in ("score_2021_la", "score_2021_df"):
        _same_result(_outcome(getattr(pev, fn), sf, str(truth)),
                     _outcome(getattr(jev, fn), sf, str(truth)))


def test_wrong_row_count_raises_like_jax(tmp_path):
    truth, utts, labels = _truth(tmp_path)
    sf = _score_file(tmp_path, utts[:-3], labels)
    for fn in ("score_2021_la", "score_2021_df"):
        got = _outcome(getattr(pev, fn), sf, str(truth))
        assert got[0] == "ValueError" and "57 of 60" in got[1]
        _same_result(got, _outcome(getattr(jev, fn), sf, str(truth)))


def test_in_the_wild_matches_jax(tmp_path):
    truth, utts, labels = _truth(tmp_path, bona="bona-fide", seed=5)
    sf = _score_file(tmp_path, utts, labels)
    key = str(truth / "wild_key.txt")
    got = _outcome(pev.score_in_the_wild, sf, key)
    _same_result(got, _outcome(jev.score_in_the_wild, sf, key))
    assert 0.0 <= got[1].eer < 0.5


def test_wider_key_line_raises(tmp_path):
    path = tmp_path / "k.txt"
    path.write_text("a b c\na b c d\n")
    with pytest.raises(ValueError, match="expected 3 fields in line 2"):
        pev.read_key_table(str(path))
    path.write_text("a b c\na b\n\n")
    assert pev.read_key_table(str(path)) == [["a", "b", "c"], ["a", "b", None]]


def test_cli_prints_like_jax(tmp_path, capsys):
    truth, utts, labels = _truth(tmp_path)
    sf = _score_file(tmp_path, utts, labels, flip=True)
    assert pev.main(["LA", sf, str(truth)]) == 0
    got = capsys.readouterr().out
    assert jev.main(["LA", sf, str(truth)]) == 0
    assert got == capsys.readouterr().out and "CHECK: negated" in got


# -- standalone ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "ties", "few", "constant_bona", "one_each"])
def test_roc_curve_matches_sklearn(case):
    b, s = {"plain": _scores(0), "ties": _scores(1, ties=True), "few": _scores(2, 3, 4),
            "constant_bona": (np.full(10, 0.5), _scores(3)[1]),
            "one_each": (np.array([0.2]), np.array([0.2]))}[case]
    scores = np.concatenate([b, s])
    labels = np.concatenate([np.ones(len(b)), np.zeros(len(s))])
    for got, want in zip(pstd.roc_curve(labels, scores), sk_roc_curve(labels, scores,
                                                                      pos_label=1)):
        assert got.dtype == want.dtype and np.array_equal(got, want), case


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_roc_interp_eer_matches_jax(seed, ties):
    b, s = _scores(seed, ties=ties, sep=0.7)
    _close(pstd.roc_interp_eer(b, s), jstd.roc_interp_eer(b, s))
    _close(pstd.simplified_min_dcf(b, s), jstd.simplified_min_dcf(b, s))
    _close(pstd.simplified_min_dcf(b, s, 0.3, 2.0, 1.5),
           jstd.simplified_min_dcf(b, s, 0.3, 2.0, 1.5))


def _protocol(tmp_path, n=50, seed=0):
    rng = np.random.default_rng(seed)
    utts = [f"LA_T_{i:05d}" for i in range(n)]
    labels = rng.permutation(np.arange(n) % 2)
    path = tmp_path / "proto.txt"
    path.write_text("".join(f"LA_0{i % 7} {u} - {'-' if lab else 'A0' + str(i % 6)} "
                            f"{'bonafide' if lab else 'spoof'}\n"
                            for i, (u, lab) in enumerate(zip(utts, labels))))
    return str(path), utts, labels


@pytest.mark.parametrize("partial", [False, True])
def test_score_2019_protocol_matches_jax(tmp_path, capsys, partial):
    proto, utts, labels = _protocol(tmp_path)
    keep = 40 if partial else len(utts)
    rng = np.random.default_rng(3)
    path = tmp_path / "s.txt"
    with ScoreWriter(path) as w:
        w.write_batch(utts[:keep], (labels[:keep] * 1.2 + rng.normal(0, 1, keep)).tolist())
    got = pstd.score_2019_protocol(str(path), proto)
    err_p = capsys.readouterr().err
    _close(got, jstd.score_2019_protocol(str(path), proto))
    err_j = capsys.readouterr().err
    assert err_p == err_j and ("PARTIAL" in err_p) == partial
    with ScoreWriter(path) as w:
        w.write_batch(["unknown_utt"], [0.5])
    got, want = (_outcome(pstd.score_2019_protocol, str(path), proto),
                 _outcome(jstd.score_2019_protocol, str(path), proto))
    assert got == want and got[0] == "ValueError"


@pytest.mark.parametrize("phase,partial", [("eval", False), ("progress", True),
                                           ("hidden_track", False)])
def test_score_2021_metadata_matches_jax(tmp_path, capsys, phase, partial):
    truth, utts, labels = _truth(tmp_path, seed=6)
    sf = _score_file(tmp_path, utts[:45] if partial else utts, labels)
    meta = str(truth / "LA/CM/trial_metadata.txt")
    got = _outcome(pstd.score_2021_metadata, sf, meta, phase)
    err_p = capsys.readouterr().err
    want = _outcome(jstd.score_2021_metadata, sf, meta, phase)
    err_j = capsys.readouterr().err
    assert got[0] == want[0] == "ok"
    _close(got[1], want[1])
    assert err_p == err_j and ("PARTIAL" in err_p) == partial
    bad = _outcome(pstd.score_2021_metadata, sf, meta, "nophase")
    assert bad == _outcome(jstd.score_2021_metadata, sf, meta, "nophase")
    assert bad[0] == "ValueError"


def test_standalone_cli_prints_like_jax(tmp_path, capsys):
    proto, utts, labels = _protocol(tmp_path)
    path = tmp_path / "s.txt"
    with ScoreWriter(path) as w:
        w.write_batch(utts, (labels * 1.0 + np.random.default_rng(0).normal(0, 1, len(utts))
                             ).tolist())
    assert pstd.main([str(path), proto]) == 0
    got = capsys.readouterr().out
    assert jstd.main([str(path), proto]) == 0
    assert got == capsys.readouterr().out and "EER:" in got
