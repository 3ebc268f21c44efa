"""The port's training runners, ``cli/sweep.py`` and ``cli/autotrain.py``,
against the JAX package's.

- The sweep's preset, grid, flags and run directories equal the
  reference's for the same arguments, letter for letter (a run directory
  it mispredicts would break resuming); ``--dry_run`` prints the
  reference's commands with ``sls_tpu_torch`` in place of ``sls_tpu``.
- A two-point micro-sweep of real ``cli.main`` training subprocesses on
  the CPU (``SLS_TPU_PLATFORM=cpu``, which the children inherit) reaches
  both points' target epoch, and a rerun skips both.
- autotrain's rules, with a stub ``sls_tpu_torch.cli.main`` first on
  ``PYTHONPATH`` (no training): exit code 2 fails fast, failures that do
  not advance the log stop at ``--max_no_progress``, and a crash after an
  epoch is restarted with ``--resume`` up to the target.
"""

import json
import os
import textwrap
from pathlib import Path

import pytest

from sls_tpu.cli import sweep as jax_sweep
from sls_tpu_torch.cli import autotrain, sweep
from tests.test_torch_cli import corpus  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parents[1]


def test_preset_and_grid_match_the_reference():
    assert sweep.REFERENCE_PRESET == jax_sweep.REFERENCE_PRESET
    for specs in (["k=32,64", "dict=4096,8192"], ["w=4"], ["lr=1e-4,3e-4", "bs=8"],
                  ["sae_weight=0.1,0.5", "k=16"]):
        assert sweep.parse_grid(specs) == jax_sweep.parse_grid(specs)
    for point in [*sweep.REFERENCE_PRESET, *sweep.parse_grid(["k=8", "w=4", "lr=1e-4"])]:
        assert sweep.point_args(point) == jax_sweep.point_args(point)
    with pytest.raises(SystemExit, match="bad grid spec"):
        sweep.parse_grid(["k"])


def test_run_dirs_match_the_reference(tmp_path):
    forwarded = ["--num_epochs", "40", "--track", "DF", "--lr", "3e-6"]
    points = [*sweep.REFERENCE_PRESET, *sweep.parse_grid(["k=16,64", "dict=1024"])]
    for point in points:
        got = sweep.resolve_run_dir(point, forwarded, tmp_path)
        assert got == jax_sweep.resolve_run_dir(point, forwarded, tmp_path), point["tag"]
        assert got.name.endswith("_" + point["tag"])


def test_dry_run_prints_the_reference_commands(tmp_path, capsys):
    argv = ["--preset", "reference", "--dry_run", "--target_epoch", "3", "--", "--num_epochs",
            "4"]
    assert sweep.main([*argv[:2], "--model_dir", str(tmp_path / "port"), *argv[2:]]) == 1
    port = capsys.readouterr().out
    assert jax_sweep.main([*argv[:2], "--model_dir", str(tmp_path / "jax"), *argv[2:]]) == 1
    want = capsys.readouterr().out
    assert port == want.replace("sls_tpu.cli.", "sls_tpu_torch.cli.").replace(
        str(tmp_path / "jax"), str(tmp_path / "port"))
    got = json.loads((tmp_path / "port" / "sweep_summary.json").read_text())
    ref = json.loads((tmp_path / "jax" / "sweep_summary.json").read_text())
    assert set(got) == set(ref) == {"points", "n_done", "n_points"}
    assert got["n_points"] == len(sweep.REFERENCE_PRESET) and got["n_done"] == 0
    for tag, s in got["points"].items():
        assert s["state"] == "dry_run" and set(s) == set(ref["points"][tag])
        assert s["cmd"][1:3] == ["-m", "sls_tpu_torch.cli.autotrain"]
        assert s["cmd"][s["cmd"].index("--comment") + 1] == tag


def test_micro_sweep_end_to_end(corpus, tmp_path, monkeypatch):  # noqa: F811
    """Two points, one epoch each, trained by real subprocesses."""
    root, _ = corpus
    monkeypatch.setenv("SLS_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    model_dir = tmp_path / "models"
    argv = ["--grid", "k=8,16", "--model_dir", str(model_dir), "--target_epoch", "0", "--",
            "--tiny", "--audio_ext", "wav", "--database_path", str(root / "data"),
            "--protocols_path", str(root / "protocols"), "--batch_size", "8",
            "--num_epochs", "1", "--lr", "1e-3", "--sae_dict_size", "64", "--algo", "0"]
    assert sweep.main(argv) == 0
    summary = json.loads((model_dir / "sweep_summary.json").read_text())
    assert summary["n_done"] == summary["n_points"] == 2
    for tag, s in summary["points"].items():
        assert s["state"] == "done" and s["exit_code"] == 0, (tag, s)
        assert s["last_epoch"] == 0 and s["best_val_eer"] is not None
        assert (Path(s["run_dir"]) / "last.ckpt").exists()
    # a rerun finds both points done and trains nothing
    assert sweep.main(argv) == 0
    again = json.loads((model_dir / "sweep_summary.json").read_text())
    assert again["n_done"] == 2
    assert all("exit_code" not in s for s in again["points"].values())


# -- autotrain's rules on a stub cli.main --------------------------------------------

STUB = textwrap.dedent('''
    """A stand-in for sls_tpu_torch.cli.main: logs its argv, then
    behaves as STUB_MODE says."""
    import csv, json, os, sys
    from pathlib import Path

    def main():
        args = sys.argv[1:]
        with open(os.environ["STUB_CALLS"], "a") as f:
            f.write(json.dumps(args) + "\\n")
        mode = os.environ["STUB_MODE"]
        if mode == "usage":
            return 2
        if mode == "epoch_then_crash":
            log = Path(args[args.index("--run_dir_for_stub") + 1]) / "training_log.csv"
            rows = list(csv.DictReader(open(log))) if log.exists() else []
            log.parent.mkdir(parents=True, exist_ok=True)
            with open(log, "a", newline="") as f:
                w = csv.DictWriter(f, ["epoch", "val_eer"])
                if not rows:
                    w.writeheader()
                w.writerow({"epoch": len(rows), "val_eer": 10.0})
        return 1

    if __name__ == "__main__":
        raise SystemExit(main())
''')


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """A stub package first on the path of the subprocesses autotrain
    starts (their working directory holds no package)."""
    pkg = tmp_path / "stub" / "sls_tpu_torch" / "cli"
    pkg.mkdir(parents=True)
    (pkg.parent / "__init__.py").write_text("")
    (pkg / "__init__.py").write_text("")
    (pkg / "main.py").write_text(STUB)
    calls = tmp_path / "calls.jsonl"
    monkeypatch.setenv("PYTHONPATH", str(tmp_path / "stub"))
    monkeypatch.setenv("STUB_CALLS", str(calls))
    monkeypatch.chdir(tmp_path)

    def attempts():
        return ([json.loads(line) for line in calls.read_text().splitlines()]
                if calls.exists() else [])

    return attempts


def _autotrain(run_dir, *extra):
    return autotrain.main(["--target_epoch", "2", "--run_dir", str(run_dir),
                           "--restart_delay", "0", *extra, "--", "--run_dir_for_stub",
                           str(run_dir)])


def test_autotrain_fails_fast_on_exit_code_2(stub, tmp_path, monkeypatch):
    monkeypatch.setenv("STUB_MODE", "usage")
    assert _autotrain(tmp_path / "run") == 2
    assert len(stub()) == 1  # no retry of a usage error


def test_autotrain_stops_after_failures_without_progress(stub, tmp_path, monkeypatch):
    monkeypatch.setenv("STUB_MODE", "crash")
    assert _autotrain(tmp_path / "run", "--max_no_progress", "2") == 1
    assert len(stub()) == 2
    assert all("--resume" not in a for a in stub())  # no epoch yet: nothing to resume


def test_autotrain_resumes_crashes_after_an_epoch(stub, tmp_path, monkeypatch):
    monkeypatch.setenv("STUB_MODE", "epoch_then_crash")
    assert _autotrain(tmp_path / "run", "--max_no_progress", "1") == 0
    attempts = stub()
    assert len(attempts) == 3  # epochs 0, 1, 2: each attempt advanced the log
    assert "--resume" not in attempts[0]
    assert all(a.count("--resume") == 1 for a in attempts[1:])
    assert autotrain.last_epoch(str(tmp_path / "run")) == 2


def test_autotrain_gives_up_after_max_restarts(stub, tmp_path, monkeypatch):
    monkeypatch.setenv("STUB_MODE", "epoch_then_crash")
    assert autotrain.main(["--target_epoch", "5", "--run_dir", str(tmp_path / "run"),
                           "--restart_delay", "0", "--max_restarts", "1", "--",
                           "--run_dir_for_stub", str(tmp_path / "run")]) == 1
    assert len(stub()) == 2
