"""Profiling (``sls_tpu_torch/train/profiling.py``), ``cli/profile_diff``,
``cli/monitor`` and ``cli/package_results``, on the CPU.

- ``trace`` writes a chrome trace of a tiny detector's forward;
  ``op_histogram`` reads it (the host lane here, ``cpu_op``: this
  machine has no card, whose lane is ``kernel``), groups numbered names
  as the reference does, and ``compare_profiles`` diffs two captures.
- ``cli.profile_diff`` prints one capture's top ops and the diff of two;
  ``cli.monitor`` renders a port run's ``training_log.csv`` (the JAX CLI's
  rendering of the same file), and ``cli.package_results`` packages it.
"""

import json

import pytest
import torch

from sls_tpu.cli import monitor as jax_monitor
from sls_tpu.train import profiling as jax_profiling
from sls_tpu_torch import config as C
from sls_tpu_torch.cli import monitor, package_results, profile_diff
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.train import profiling
from sls_tpu_torch.train.loop import CSVLogger, EpochMetrics, epoch_row


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: its stats are checked on the chip")
    assert profiling.device_memory_stats() == {}


def _forward(tmp, n_calls):
    exp = C.ModelConfig(encoder=C.tiny_xlsr_config(),
                        sae=C.SAEConfig(activation_dim=64, dict_size=256, k=32, use_pallas=True))
    model = Detector(exp, device="cpu")
    wav = torch.zeros(2, 1000)
    with profiling.trace(tmp) as t, torch.inference_mode():
        for _ in range(n_calls):
            model.score(wav)
    return t.path


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    root = tmp_path_factory.mktemp("prof")
    return (_forward(root / "a", 1), _forward(root / "b", 2))


def test_trace_and_histogram(captures):
    path_a, path_b = captures
    assert path_a.name == "trace.json" and path_a.stat().st_size > 0
    assert json.loads(path_a.read_text())["traceEvents"]
    with pytest.raises(FileNotFoundError, match="profiling.trace"):
        profiling.op_histogram(path_a.parent / "missing")
    a = profiling.op_histogram(path_a.parent, lane_filter="cpu_op")
    b = profiling.op_histogram(path_b.parent, lane_filter="cpu_op")
    # the custom op of row 1 is an operator of its own in the trace
    assert a["sls_tpu_torch::sae_encode_topk"]["count"] == 1
    assert b["sls_tpu_torch::sae_encode_topk"]["count"] == 2
    assert all(v["ms"] >= 0 for v in a.values())
    assert profiling.op_histogram(path_a.parent) == {}  # no card: no kernel lane
    top = profiling.op_histogram(path_b.parent, lane_filter="cpu_op", top=3)
    assert len(top) == 3 and min(v["ms"] for v in top.values()) >= sorted(
        (v["ms"] for v in b.values()), reverse=True)[2]
    rows = profiling.compare_profiles(a, b, min_ms=0.0)
    assert [r["delta_ms"] for r in rows] == sorted((r["delta_ms"] for r in rows), reverse=True)
    row = next(r for r in rows if r["op"] == "sls_tpu_torch::sae_encode_topk")
    assert (row["a_count"], row["b_count"]) == (1, 2)


def test_grouping_matches_jax(tmp_path):
    events = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "fusion.12", "dur": 1500},
        {"ph": "X", "cat": "kernel", "name": "fusion.7", "dur": 500},
        {"ph": "X", "cat": "kernel", "name": "gemm_kernel", "dur": 250},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 9000},
        {"ph": "i", "cat": "kernel", "name": "marker"}]}
    (tmp_path / "trace.json").write_text(json.dumps(events))
    got = profiling.op_histogram(tmp_path)
    assert got == {"fusion": {"ms": 2.0, "count": 2}, "gemm_kernel": {"ms": 0.25, "count": 1}}
    ungrouped = profiling.op_histogram(tmp_path, group=False)
    assert set(ungrouped) == {"fusion.12", "fusion.7", "gemm_kernel"}
    a = {"x": {"ms": 1.0, "count": 1}, "y": {"ms": 0.01, "count": 1}}
    b = {"x": {"ms": 3.0, "count": 2}, "z": {"ms": 0.5, "count": 1}}
    assert profiling.compare_profiles(a, b) == jax_profiling.compare_profiles(a, b)


def test_profile_diff_cli(captures, capsys):
    path_a, path_b = captures
    assert profile_diff.main([str(path_a.parent), "--lane", "cpu_op", "--json", "--min_ms",
                              "0"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert any(r["op"] == "sls_tpu_torch::sae_encode_topk" for r in rows)
    assert profile_diff.main([str(path_a.parent), str(path_b.parent), "--lane", "cpu_op",
                              "--top", "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["op", "a_ms", "b_ms", "delta"] and len(out) <= 6


@pytest.fixture()
def run_with_log(tmp_path):
    log = CSVLogger(tmp_path / "training_log.csv")
    for epoch, eer in enumerate((12.5, 7.25, 9.0)):
        log.log(epoch_row(epoch, EpochMetrics(loss=0.5 / (epoch + 1), eer=30.0),
                          EpochMetrics(loss=0.4, acc=90.0, eer=eer), 12.3))
    (tmp_path / "scores_LA.txt").write_text("u1 0.5\n")
    return tmp_path


def test_monitor_renders_a_port_log(run_with_log, capsys):
    rows = monitor.read_log(run_with_log)
    assert len(rows) == 3
    got = monitor.render(rows)
    assert got == jax_monitor.render(jax_monitor.read_log(str(run_with_log)))
    assert "best val EER: 7.2500% @ epoch 1  (3 epochs logged)" in got
    assert monitor.main(["--run_dir", str(run_with_log), "--tail", "2"]) == 0
    assert "7.2500" in capsys.readouterr().out
    assert monitor.render([]) == "no training_log.csv yet"


def test_package_results(run_with_log, tmp_path):
    dest = package_results.package(run_with_log, tmp_path / "out")
    assert (dest / "training_log.csv").exists() and (dest / "scores_LA.txt").exists()
    summary = (dest / "SUMMARY.md").read_text()
    assert "best val EER: 7.2500% (epoch 1)" in summary and "epochs trained: 3" in summary
