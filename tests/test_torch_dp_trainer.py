"""The port's trainers across ranks (``train/loop.py``, ``models/sls.py``)
and its command line's training run inside a job (``cli/main.py``).

One job of two gloo ranks on the CPU (spawned once for the file):

- a ``Trainer.fit`` of one epoch with RawBoost off, each rank on its
  ``host_shard`` of the train and validation arrays, gives the CSV row of
  a one-process run over the same global batches (the ranks' batches
  concatenated) within 1e-6, and both ranks report the same figures;
- a second job resumes from the primary's ``last.ckpt`` on both ranks
  and trains epoch 1, again as the one-process run does;
- an ``SLSTrainer`` fit across the ranks;
- ``cli.main --quick_test`` training under ``SLS_TPU_PLATFORM=cpu`` in
  the job writes one CSV and one ``last.ckpt``; and
  ``--model_parallel 2`` in the same job trains tensor parallel.

Checkpoints, the CSV and TensorBoard are the primary's alone.
"""

import csv
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from sls_tpu_torch import config as tcfg
from sls_tpu_torch.data.pipeline import ArrayLoader
from sls_tpu_torch.parallel import workers
from sls_tpu_torch.parallel.launch import launch
from sls_tpu_torch.train.loop import CSV_FIELDS, Trainer
from tests.test_torch_cli import _args, corpus  # noqa: F401  (corpus is a fixture)

RANKS, BATCH, WAV_LEN = 2, 4, 1000
N_TRAIN, N_VAL = 16, 8
METRIC_REL = 1e-6  # the same global batches through the same step, sums reordered
CSV_ABS = 1.5e-6   # 1e-6, and the CSV's six decimals rounding either side


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(sls=False):
    if sls:
        model = tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(), use_sae=False)
    else:
        model = tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(),
                                 sae=tcfg.SAEConfig(activation_dim=64, dict_size=256, k=32),
                                 classifier_hidden=32, classifier_dropout=0.0)
    return tcfg.ExperimentConfig(model=model, train=tcfg.TrainConfig(
        batch_size=BATCH, lr=1e-3, cut_length=WAV_LEN, rawboost=tcfg.RawBoostConfig(algo=0)))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    tone = np.sin(2 * np.pi * 440 * np.arange(WAV_LEN) / 16000.0).astype(np.float32)

    def arrays(n):
        labels = rng.integers(0, 2, n).astype(np.int32)
        wav = rng.normal(0, 0.05, (n, WAV_LEN)).astype(np.float32)
        wav[labels == 1] += 0.3 * tone
        return wav, labels

    return arrays(N_TRAIN), arrays(N_VAL)


def _global_order(n):
    """The one-process order of ``n`` rows whose batches of RANKS * BATCH
    are the ranks' batches of BATCH concatenated (``host_shard`` is
    strided: rank r holds rows r, r + RANKS, ...)."""
    shards = [list(range(r, n, RANKS))[: n // RANKS] for r in range(RANKS)]
    order = []
    for lo in range(0, n // RANKS, BATCH):
        for shard in shards:
            order += shard[lo:lo + BATCH]
    return np.asarray(order)


@pytest.fixture(scope="module")
def ranks(data, corpus, tmp_path_factory):  # noqa: F811
    root, _ = corpus
    dirs = {name: str(tmp_path_factory.mktemp(name))
            for name in ("dp_run", "sls_run", "cli_models", "cli_tp_models")}
    train, val = data
    jobs = [
        ("trainer_rank", (_cfg(), "detector", dirs["dp_run"], train, val, BATCH, 1), {}),
        ("trainer_rank", (_cfg(), "detector", dirs["dp_run"], train, val, BATCH, 2),
         dict(resume=True)),
        ("trainer_rank", (_cfg(sls=True), "sls", dirs["sls_run"], train, val, BATCH, 1), {}),
        ("cli_rank", (_args(root, dirs["cli_models"], "--quick_test"),), {}),
        ("cli_rank", (_args(root, dirs["cli_tp_models"], "--quick_test",
                            "--model_parallel", "2"),), {}),
    ]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SLS_TPU_PLATFORM", "cpu")  # the spawned ranks inherit it
        res = launch(workers.jobs_rank, RANKS, (jobs,), device_type="cpu")
    names = ("fit", "resume", "sls", "cli", "cli_tp")
    return {name: [r[i] for r in res] for i, name in enumerate(names)}, dirs


@pytest.fixture(scope="module")
def one_process(data, tmp_path_factory):
    """The one-process Trainer over the same global batches, two epochs."""
    (wav, labels), (vwav, vlabels) = data
    run_dir = tmp_path_factory.mktemp("one_process")
    trainer = Trainer(_cfg(), run_dir, tensorboard=False, device="cpu")
    trainer.init_state()
    t, v = _global_order(N_TRAIN), _global_order(N_VAL)
    metrics = []
    for epoch in range(2):
        tr = trainer.train_epoch(ArrayLoader(wav[t], labels[t], batch_size=RANKS * BATCH),
                                 epoch)
        # validation: each rank's shard is one batch of BATCH; here two
        va = trainer.validate(ArrayLoader(vwav[v], vlabels[v], batch_size=BATCH))
        metrics.append((dataclasses.asdict(tr), dataclasses.asdict(va)))
    return metrics


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _close(got: dict, want: dict):
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=METRIC_REL, abs=1e-9), k


def test_fit_across_ranks_equals_one_process(ranks, one_process):
    res, dirs = ranks
    a, b = res["fit"]
    assert a["metrics"] == b["metrics"]  # both ranks report the same figures
    assert a["checksum"] == b["checksum"] and a["step"] == b["step"] == N_TRAIN // (RANKS
                                                                                   * BATCH)
    (_, _, tr), (_, _, va) = a["metrics"]
    _close(tr, one_process[0][0])
    _close(va, one_process[0][1])


def test_resume_across_ranks(ranks, one_process):
    res, dirs = ranks
    a, b = res["resume"]
    assert a["resumed"] and b["resumed"] and a["metrics"] == b["metrics"]
    assert [m[1] for m in a["metrics"] if m[0] == "train"] == [1]  # epoch 1 alone
    (_, _, tr), (_, _, va) = a["metrics"]
    _close(tr, one_process[1][0])
    _close(va, one_process[1][1])
    # the primary alone wrote: one CSV with a row an epoch, the checkpoints
    run = Path(dirs["dp_run"])
    rows = _rows(run / "training_log.csv")
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert sorted(p.name for p in run.glob("*.ckpt")) == ["best.ckpt", "last.ckpt"]
    for row, (tr, va) in zip(rows, one_process):
        for field, want in (("train_loss", tr["loss"]), ("train_acc", tr["acc"]),
                            ("train_sae_loss", tr["sae_loss"]), ("val_loss", va["loss"]),
                            ("val_eer", va["eer"])):
            assert abs(float(row[field]) - want) <= CSV_ABS * max(1.0, abs(want)), field
    assert set(rows[0]) == set(CSV_FIELDS)


def test_sls_trainer_across_ranks(ranks):
    res, dirs = ranks
    a, b = res["sls"]
    assert a["metrics"] == b["metrics"] and a["checksum"] == b["checksum"]
    assert a["step"] == N_TRAIN // (RANKS * BATCH)
    assert np.isfinite(a["metrics"][0][2]["loss"])
    assert [r["epoch"] for r in _rows(Path(dirs["sls_run"]) / "training_log.csv")] == ["0"]


@pytest.mark.parametrize("job", ["cli", "cli_tp"])
def test_cli_trains_across_ranks(ranks, job):
    res, dirs = ranks
    assert res[job] == [0, 0]
    (run_dir,) = Path(dirs[f"{job}_models"]).iterdir()
    assert len(list(run_dir.glob("training_log.csv"))) == 1
    assert [r["epoch"] for r in _rows(run_dir / "training_log.csv")] == ["0"]
    assert (run_dir / "last.ckpt").exists()
