"""The port's analysis command line (``sls_tpu_torch/cli/analyze.py``) and
report (``cli/report.py``) against the JAX package's, on run directories
written by the JAX package.

- A tiny detector run trained one epoch by the JAX ``Trainer`` (as
  ``tests/test_cli_analysis.py``'s ``tiny_run``), a window-overlap run
  and an SLS run (each the JAX trainer's initial state, saved) are read
  by both packages.
- Every one of the twelve commands runs through
  ``sls_tpu.cli.analyze.main`` and ``sls_tpu_torch.cli.analyze.main``
  with ``--synthetic --seed 0 --figures``, and the JSON reports are
  compared: integers (feature lists, counts), strings and booleans
  equal, floats within ``CONT_REL`` relative (``CONT_ABS`` near 0),
  figure paths by file name.  The compute dtype is fp32 (the tiny
  config's encoder and SAE, the SAE's plain route): the codes' supports
  are first held equal between the packages on the same loader, so no
  bf16 near-tie moves a support and every number is compared.
- The parsers agree action by action; the refusals (an SAE command on
  an SLS run, ``gates`` on a detector run) raise ``SystemExit``.
- ``cli.report --demo`` exits 0 on the CPU and writes the deliverable,
  and the three renderers give the JAX ones' text on the same reports.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sls_tpu.ckpt.checkpoint import save_checkpoint as jax_save_checkpoint
from sls_tpu.cli import analyze as j_analyze
from sls_tpu.cli import report as j_report
from sls_tpu.config import (
    ExperimentConfig,
    ModelConfig,
    RawBoostConfig,
    SAEConfig,
    TrainConfig,
    config_to_json,
    tiny_xlsr_config,
)
from sls_tpu.data.pipeline import ArrayLoader
from sls_tpu.models.sls import SLSTrainer as JaxSLSTrainer
from sls_tpu.train.loop import Trainer as JaxTrainer
from sls_tpu_torch.cli import analyze as p_analyze
from sls_tpu_torch.cli import report as p_report

CONT_REL = 1e-4   # fp32 encoder, SAE and head through the two frameworks
CONT_ABS = 1e-6   # a float near 0 (a delta, a t-statistic): fp32 noise of O(1) terms
CODES_REL_L2 = 1e-5  # the codes themselves (tests/test_torch_analysis.py's ATTR_REL_L2)
WAV_LEN, N, BATCH = 1000, 16, 8
FIGURES = {"temporal": ["temporal_stability.png"], "attribution": ["decision_relevance.png"],
           "importance": ["feature_statistics.png"], "probe": ["acoustic_probe.png"],
           "failure": ["boundary_discontinuity_analysis.png", "transient_vs_persistent.png"],
           "gates": ["layer_gates.png"]}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers do not oversubscribe the
    cores (no result here depends on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("SLS_TPU_PLATFORM", "cpu")


def _model_config(**overrides):
    base = dict(encoder=tiny_xlsr_config(), use_sae=True, use_sparse_features=True,
                sae=SAEConfig(activation_dim=64, dict_size=256, k=32), classifier_hidden=32)
    base.update(overrides)
    return ModelConfig(**base)


def _exp(model):
    return ExperimentConfig(model=model, train=TrainConfig(
        batch_size=8, lr=1e-3, num_epochs=1, cut_length=WAV_LEN,
        rawboost=dataclasses.replace(RawBoostConfig(), algo=0)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"detector", "window", "sls"}: run directories of the JAX package."""
    root = tmp_path_factory.mktemp("jax_runs")
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, 24)
    t = np.arange(WAV_LEN) / 16000
    wav = rng.normal(0, 0.05, (24, WAV_LEN)).astype(np.float32)
    wav[labels == 1] += 0.3 * np.sin(2 * np.pi * 440 * t).astype(np.float32)
    loader = ArrayLoader(wav, labels, batch_size=8)
    trainer = JaxTrainer(_exp(_model_config()), root / "detector", tensorboard=False)
    trainer.init_state(np.zeros((2, WAV_LEN), np.float32))
    trainer.fit(loader, loader)
    for name, trainer_cls, model in (
            ("window", JaxTrainer, _model_config(sae=SAEConfig(
                activation_dim=64, dict_size=256, k=32, variant="window_overlap",
                window_size=8))),
            ("sls", JaxSLSTrainer, _model_config(use_sae=False))):
        exp = _exp(model)
        tr = trainer_cls(exp, root / name, tensorboard=False)
        tr.init_state(np.zeros((2, WAV_LEN), np.float32))
        jax_save_checkpoint(root / name / "last.ckpt", tr._state_tree(), epoch=0,
                            config_json=config_to_json(exp))
    return {name: str(root / name) for name in ("detector", "window", "sls")}


def test_parser_matches_jax_action_by_action():
    port, ref = p_analyze.build_parser(), j_analyze.build_parser()
    assert len(port._actions) == len(ref._actions)
    for a, b in zip(port._actions, ref._actions):
        for f in ("option_strings", "dest", "default", "choices", "nargs", "type", "const",
                  "required"):
            assert getattr(a, f) == getattr(b, f), (a.dest, f)
    assert list(p_analyze.COMMANDS) == list(j_analyze.COMMANDS)
    assert p_report.SECTIONS == j_report.SECTIONS


@pytest.mark.parametrize("name", ["detector", "window"])
def test_code_supports_agree(runs, name):
    """The two packages' codes on the --synthetic loader share their
    supports (what every report below is computed from)."""
    argv = ["temporal", "--run_dir", runs[name], "--synthetic", "--num_samples", str(N),
            "--batch_size", str(BATCH)]
    jcfg, jmodel, params = j_analyze.load_experiment(runs[name])
    jcodes, jwavs, jlab = j_analyze._collect_codes(
        jmodel, params, j_analyze._make_loader(j_analyze.build_parser().parse_args(argv), jcfg), N)
    pcfg, pmodel = p_analyze.load_experiment(runs[name])
    pcodes, pwavs, plab = p_analyze._collect_codes(
        pmodel, p_analyze._make_loader(p_analyze.build_parser().parse_args(argv), pcfg), N)
    assert pcodes.shape == jcodes.shape == (N, 49, 256)
    np.testing.assert_array_equal(pwavs, jwavs)
    np.testing.assert_array_equal(plab, jlab)
    np.testing.assert_array_equal(pcodes > 0, jcodes > 0)
    assert np.linalg.norm(pcodes - jcodes) <= CODES_REL_L2 * np.linalg.norm(jcodes)


def same_report(got, want, where="report"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (where, got, want)
        for k in want:
            if k == "figures":
                assert [Path(p).name for p in got[k]] == [Path(p).name for p in want[k]], where
            else:
                same_report(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            same_report(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, (int, float)), where
        assert abs(got - want) <= max(CONT_REL * abs(want), CONT_ABS), (where, got, want)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


COMMAND_ARGS = {
    "temporal": [], "sparsity": [], "attribution": ["--ablation", "--top_k", "8"],
    "importance": [], "probe": ["--top_k", "5"], "handcrafted": [], "overlap": [],
    "inspect": [], "compare": ["--compare_run_dir", None], "failure": [],
    "global-cues": [], "gates": [],
}


@pytest.mark.parametrize("command", sorted(COMMAND_ARGS))
def test_command_report_matches_jax(runs, command, tmp_path):
    run = runs["sls" if command == "gates" else "detector"]
    extra = [runs["window"] if a is None else a for a in COMMAND_ARGS[command]]
    reports = {}
    for pkg, main in (("jax", j_analyze.main), ("port", p_analyze.main)):
        out, figs = tmp_path / f"{pkg}.json", tmp_path / f"{pkg}_figures"
        assert main([command, "--run_dir", run, "--synthetic", "--seed", "0",
                     "--num_samples", str(N), "--batch_size", str(BATCH), "--output", str(out),
                     "--figures", str(figs)] + extra) == 0
        reports[pkg] = json.loads(out.read_text())
        assert sorted(p.name for p in figs.glob("*.png")) == sorted(FIGURES.get(command, []))
    same_report(reports["port"], reports["jax"])
    if command == "compare":
        assert set(reports["port"]) == {"primary", "secondary", "delta"}


def test_sae_commands_refuse_an_sls_run(runs):
    with pytest.raises(SystemExit, match="SLS-family"):
        p_analyze.main(["sparsity", "--run_dir", runs["sls"], "--synthetic"])


def test_gates_refuses_a_detector_run(runs):
    with pytest.raises(SystemExit, match="'gates' needs an SLS-family checkpoint"):
        p_analyze.main(["gates", "--run_dir", runs["detector"], "--synthetic"])


def test_report_demo_writes_the_deliverable(tmp_path):
    out = tmp_path / "deliverables"
    assert p_report.main(["--demo", "--out", str(out)]) == 0
    (dest,) = out.glob("results_*")
    names = {p.name for p in dest.iterdir()}
    sections = [s for s, _ in p_report.SECTIONS] + ["compare"]
    assert {f"{s.replace('-', '_')}.json" for s in sections} <= names
    assert {"RESEARCH_SUMMARY.md", "EXECUTIVE_SUMMARY.txt", "PERFORMANCE.txt", "SUMMARY.md",
            "timings.json", "training_log.csv"} <= names
    assert {f for s in sections for f in FIGURES.get(s, [])} <= names
    timings = json.loads((dest / "timings.json").read_text())
    assert set(sections) <= set(timings) and timings["_num_samples"] == 16

    run = out / "demo_runs" / "demo_per_timestep"
    reports = {s: json.loads((run / "analysis" / f"{s.replace('-', '_')}.json").read_text())
               for s in sections}
    assert (p_report.render_research_summary(reports)
            == j_report.render_research_summary(reports))
    assert (p_report.render_executive_summary(str(run), reports, {"probe": "x"})
            == j_report.render_executive_summary(str(run), reports, {"probe": "x"}))
    metrics = tmp_path / "LA.txt"
    metrics.write_text("EER 1.0\n")
    assert (p_report.render_performance([str(metrics)])
            == j_report.render_performance([str(metrics)]).replace(
                "sls_tpu.scores", "sls_tpu_torch.scores"))
    assert p_report.render_performance([]) == j_report.render_performance([]).replace(
        "sls_tpu.scores", "sls_tpu_torch.scores")
