"""Epoch-level training loop and score production, counterpart of
``sls_tpu/train/loop.py``.

``Trainer(cfg, run_dir).fit(train_loader, val_loader)`` trains the
detector the way the reference does:

- each train batch goes to the device, is dequantised and augmented
  there by RawBoost (``augment/rawboost.py``; its generator seeded from
  (seed, process, epoch, batch)) and stepped by ``make_train_step``;
- validation runs the eval step, with the loss, SAE loss, accuracy and
  EER over the valid rows only;
- each epoch appends a CSV row (the reference's columns and formats, so
  monitors read either package's logs) and TensorBoard scalars, and
  saves ``last.ckpt`` (and ``best.ckpt`` when ``val_eer`` improves) on a
  background writer;
- ``resume`` restores the parameters, moments, ``step`` and ``calls``,
  so a resumed run draws the dropout masks, RawBoost parameters and
  shuffle of an uninterrupted one.  It also takes the JAX package's
  msgpack ``last.ckpt`` / ``best.ckpt`` (parameters, Adam's moments,
  ``step`` and epoch; ``calls`` set to ``step``) and, weights only, a
  reference PyTorch ``.pth`` / ``.pt`` dict checkpoint.

The epoch loop makes no host sync per step: metric scalars fold into a
device accumulator (masked by the step's ``finite`` flag, weighted by
the valid rows), score rows and flags stay on the device, batches go
up from pinned memory without waiting, and the one fetch comes at the
epoch's end, where non-finite batches are reported.  Every
``_PIPELINE_DEPTH`` steps the host waits for the step that many behind
(a CUDA event), which bounds the batches in flight.

One difference from the reference: its fold multiplies a rejected
step's loss by 0, which keeps a NaN, so one non-finite batch turns the
epoch's mean loss into NaN; here the fold selects, and the batch is
left out as the reference's docstring intends.

Across processes (a torchrun or ``SLS_TPU_*`` job,
``parallel/distributed.py::initialize``) the trainer trains data
parallel over a 'data' mesh of every rank, as the reference trains on a
data mesh of every chip: each rank steps its own rows of the global
batch (its loader's ``host_shard``, equal row and batch counts on every
rank) through the global-batch step of ``train/steps.py``.
``init_state`` broadcasts rank 0's weights and checks them by checksum
on every rank, ``resume`` reads the same file on every rank (storage all
ranks share, as the reference requires) and checks the same; the
epoch's figures and validation combine the ranks as the reference's
``_combine_epoch`` does, so every rank reports the same ones;
checkpoints, the CSV and TensorBoard stay the primary's.  Under NCCL the
loop adds no host wait per step; under gloo (ranks sharing a card) the
backend stages the step's CUDA gradient through host memory, which
waits for the backward.  With ``model_parallel = M`` > 1 the job's ranks
(M must divide them; one host, ``parallel/tensor.py``) form a ('data',
'model') mesh: ``init_state`` cuts the model over 'model', the ranks of
one data coordinate step the same rows (``data_shard`` says which shard
a rank's loaders take), and checkpoints hold whole tensors, gathered
for the primary.

``Trainer(cfg, run_dir, mesh=mesh)`` trains on the caller's mesh
instead, as the reference's ``mesh`` argument does: a ('data', 'seq')
mesh (``parallel/sequence.py::sp_mesh``) with a config from
``sp_model_config`` trains and validates sequence parallel, the seq
ranks of one data coordinate taking that coordinate's shard
(``train/steps.py``); one rank of each coordinate writes its part of a
score file.
"""

from __future__ import annotations

import csv
import os
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from sls_tpu_torch.augment.rawboost import rawboost_batch
from sls_tpu_torch.ckpt.checkpoint import CheckpointManager, is_reference_state, load_checkpoint
from sls_tpu_torch.config import ExperimentConfig, config_to_json
from sls_tpu_torch.convert import detector_state_from_reference
from sls_tpu_torch.device import DeviceLike, resolve_device
from sls_tpu_torch.metrics.eer import roc_eer
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.parallel import distributed as dist
from sls_tpu_torch.parallel.mesh import Mesh, axis_of, make_mesh
from sls_tpu_torch.parallel.sequence import weights_checksum
from sls_tpu_torch.parallel.tensor import (
    cut_state_dict,
    gather_train_tree,
    model_shard,
    shard_model_,
    shard_train_tree,
    state_shardings,
    tp_mesh_and_config,
)
from sls_tpu_torch.scores.writer import ScoreWriter, log_probs_to_scores
from sls_tpu_torch.train import profiling
from sls_tpu_torch.train.loss import weighted_nll
from sls_tpu_torch.train.steps import (
    create_train_state,
    dequantize_wire,
    make_eval_step,
    make_train_step,
    restore_train_state,
    to_device,
    train_state_tree,
    train_state_tree_from_reference,
)

CSV_FIELDS = [
    "epoch", "train_loss", "train_cls_loss", "train_sae_loss", "train_cpc_loss",
    "train_acc", "train_eer", "val_loss", "val_acc", "val_eer", "val_sae_loss",
    "epoch_seconds",
]

# train / eval steps in flight before the host waits: deep enough that
# host preparation and device compute overlap, shallow enough that the
# pinned input buffers stay small
_PIPELINE_DEPTH = 8


class CSVLogger:
    """Append-per-epoch CSV, readable by monitors and auto-resume logic."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if not self.path.exists():
            with open(self.path, "w", newline="") as f:
                csv.DictWriter(f, CSV_FIELDS).writeheader()

    def log(self, row: Dict) -> None:
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, CSV_FIELDS).writerow({k: row.get(k, "") for k in CSV_FIELDS})

    def last_epoch(self) -> int:
        """The newest logged epoch, -1 for none (or an unreadable log)."""
        try:
            with open(self.path) as f:
                rows = list(csv.DictReader(f))
            return int(rows[-1]["epoch"]) if rows else -1
        except (OSError, ValueError, KeyError, csv.Error):
            return -1


@dataclass
class EpochMetrics:
    loss: float = 0.0
    cls_loss: float = 0.0
    sae_loss: float = 0.0
    cpc_loss: float = 0.0
    acc: float = 0.0
    eer: float = 50.0


def epoch_row(epoch: int, tr: EpochMetrics, va: EpochMetrics, seconds: float) -> Dict:
    """The CSV row of an epoch, in the reference's formats."""
    return {
        "epoch": epoch,
        "train_loss": f"{tr.loss:.6f}",
        "train_cls_loss": f"{tr.cls_loss:.6f}",
        "train_sae_loss": f"{tr.sae_loss:.6f}",
        "train_cpc_loss": f"{tr.cpc_loss:.6f}",
        "train_acc": f"{tr.acc:.3f}",
        "train_eer": f"{tr.eer:.4f}",
        "val_loss": f"{va.loss:.6f}",
        "val_acc": f"{va.acc:.3f}",
        "val_eer": f"{va.eer:.4f}",
        "val_sae_loss": f"{va.sae_loss:.6f}",
        "epoch_seconds": f"{seconds:.1f}",
    }


def _gathered_eer(scores_all: List[np.ndarray], labels_all: List[np.ndarray],
                  group=None, gather: bool = True) -> float:
    """EER over the score and label rows of every process of ``group``
    (default all; one ragged gather, the identity in one process), or
    over this process's alone without ``gather``; 50 % for an empty
    epoch."""
    scores = np.concatenate(scores_all) if scores_all else np.zeros(0)
    labels = np.concatenate(labels_all) if labels_all else np.zeros(0, np.int64)
    scores_g, labels_g = scores.astype(np.float32), labels.astype(np.int32)
    if gather:
        scores_g = dist.allgather_ragged_rows(scores_g, group)
        labels_g = dist.allgather_ragged_rows(labels_g, group)
    return 50.0 if scores_g.size == 0 else float(roc_eer(scores_g, labels_g))


def _mark(dev: torch.device) -> Optional[torch.cuda.Event]:
    """A point in the device's queue (None off the card, where work is
    done when it returns)."""
    if dev.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


def _wait(mark: Optional[torch.cuda.Event]) -> None:
    """Wait for the device to pass ``mark``, and for nothing after it."""
    if mark is not None:
        mark.synchronize()


class BaseTrainer:
    """The epoch loop, validation, fit, the resume chain and score
    emission, shared by the model families.

    Subclasses give ``_build_model_and_steps`` (``self.model``,
    ``self.train_step``, ``self.eval_step``), ``_create_state``,
    ``_state_tree``, ``_restore_state`` and ``_run_eval``.
    """

    log_prefix = ""

    def __init__(self, cfg: ExperimentConfig, run_dir, tensorboard: bool = True,
                 profile_steps: int = 0, device: DeviceLike = "cuda",
                 mesh: Optional[Mesh] = None):
        # profile_steps > 0: a torch.profiler trace of that many steps
        # from the second step of the first trained epoch, in run_dir/profile
        # (train/profiling.py: op_histogram reads it)
        self._refuse(cfg)
        if mesh is not None and len(mesh.ranks) != dist.process_count():
            # the epoch loop's weight broadcast, barriers and part files
            # span the job
            raise ValueError(f"the Trainer's mesh holds {len(mesh.ranks)} of the job's "
                             f"{dist.process_count()} ranks: give it a mesh of every rank")
        self.mesh = mesh  # the caller's (module docstring), else:
        if mesh is None and cfg.train.model_parallel > 1:
            self.mesh, cfg = tp_mesh_and_config(cfg)
        elif mesh is None and dist.process_count() > 1:
            self.mesh = make_mesh(("data",))
        self.tp = model_shard(self.mesh)
        self.data_group, self.data_index, self.data_ranks = axis_of(self.mesh, "data")
        self.tp_specs = None
        self.cfg = cfg
        self.device = resolve_device(device)
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        # exactly one process writes checkpoints, the CSV and TensorBoard
        self.io_primary = dist.is_primary()
        self._build_model_and_steps()

        self.ckpt = CheckpointManager(self.run_dir, config_to_json(cfg))
        self.csv = CSVLogger(self.run_dir / "training_log.csv") if self.io_primary else None
        self.tb = None
        if tensorboard and self.io_primary:
            try:
                from tensorboardX import SummaryWriter

                self.tb = SummaryWriter(str(self.run_dir / "tb"))
            except ImportError:  # logging only: the CSV has every number
                self.tb = None

        self.state = None
        self.start_epoch = 0
        self.profile_steps = profile_steps
        self._profiled = False
        self._nonfinite_batches = 0

    # -- subclass surface ----------------------------------------------------

    def _refuse(self, cfg: ExperimentConfig) -> None:
        """Raise for a configuration the family does not train."""

    def _build_model_and_steps(self) -> None:
        raise TypeError("use Trainer, not BaseTrainer")

    def _create_state(self):
        raise TypeError("use Trainer, not BaseTrainer")

    def _state_tree(self) -> Dict:
        raise TypeError("use Trainer, not BaseTrainer")

    def _restore_state(self, tree: Dict) -> None:
        raise TypeError("use Trainer, not BaseTrainer")

    def _run_eval(self, wav: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise TypeError("use Trainer, not BaseTrainer")

    def _resume_from_torch(self, path) -> bool:
        raise ValueError(f"no PyTorch checkpoint migration for {type(self).__name__}")

    def _torch_epoch_from(self, raw, path) -> None:
        """``start_epoch`` from a PyTorch checkpoint dict's ``epoch``, else
        from an ``epoch_<n>`` in its file name, else unchanged."""
        m = re.search(r"epoch[_-]?(\d+)", str(path))
        if isinstance(raw, dict) and "epoch" in raw:
            self.start_epoch = int(raw["epoch"]) + 1
        elif m:
            self.start_epoch = int(m.group(1)) + 1

    # -- ranks ----------------------------------------------------------------

    def data_shard(self) -> tuple:
        """(index, count) of the data shard this rank's loaders take: its
        data coordinate and the mesh's data ranks ((0, 1) in one
        process).  The ranks of one data coordinate of a tensor-parallel
        mesh take the same shard."""
        return self.data_index, self.data_ranks

    def _sum_ranks(self, values) -> np.ndarray:
        """Host scalars summed over the data ranks (the ranks of one data
        coordinate hold the same rows and are counted once)."""
        if self.data_ranks == 1:
            return np.asarray(values, np.float64)
        return dist.allreduce_sum_scalars(values, self.data_group)

    def _eer(self, scores_all, labels_all) -> float:
        """EER over the data ranks' rows (``_sum_ranks``'s ranks)."""
        return _gathered_eer(scores_all, labels_all, self.data_group,
                             gather=self.data_ranks > 1)

    def _check_replicas(self, what: str, group=None) -> None:
        """Raise unless every rank of ``group`` (default: this rank's data
        group, the ranks that hold its weights) holds them, by
        ``weights_checksum``."""
        if group is None:
            if self.data_ranks == 1:
                return
            group = self.data_group
        sums = dist.allgather_rows(weights_checksum(self.model)[None, :], group)
        if not np.all(sums == sums[0]):
            raise ValueError(f"{what}: the ranks hold different weights: checksums "
                             f"{sums.tolist()}")

    @torch.no_grad()
    def _replicate_weights(self) -> None:
        """Rank 0's weights (and buffers) on every rank of the job, checked
        by checksum: the reference's ``replicate`` requires equal host
        values.  No-op in one process."""
        if dist.process_count() == 1:
            return
        tensors = list(self.model.state_dict().values())
        for dtype in {t.dtype for t in tensors}:  # one broadcast a dtype, not a tensor
            same = [t for t in tensors if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in same])
            torch.distributed.broadcast(flat, src=0)
            for t, piece in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(piece.view_as(t))
            del flat
        self._check_replicas("init_state", group=torch.distributed.group.WORLD)

    def _load_model_state(self, state) -> None:
        """Load a whole model's state dict into ``self.model`` (this
        rank's blocks of it under tensor parallelism) and check the
        ranks agree."""
        if self.tp is not None:
            state = cut_state_dict(state, self.tp_specs, self.tp)
        self.model.load_state_dict(state, strict=True)
        self._check_replicas("resume")

    def _checkpoint_tree(self) -> Dict:
        """``_state_tree`` with whole tensors; every rank must call it
        (under tensor parallelism it gathers over 'model')."""
        tree = self._state_tree()
        if self.tp is not None:
            tree = gather_train_tree(tree, self.tp_specs, self.tp)
        return tree

    # -- state management ----------------------------------------------------

    def init_state(self) -> None:
        """Zero optimizer state over the model's current weights: in a
        job, rank 0's, broadcast; under tensor parallelism cut over
        'model' first."""
        self._replicate_weights()
        if self.tp is not None and self.tp_specs is None:
            self.tp_specs = state_shardings(self.model, self.mesh)["params"]
            shard_model_(self.model, self.tp_specs, self.tp)
        self.state = self._create_state()

    def resume(self, explicit_path=None, fresh_start: bool = False) -> bool:
        """Restore from the resume chain (explicit > last > best); True if
        resumed.  The next epoch is the checkpoint's plus one.  A
        checkpoint of either package is taken (module docstring); a
        ``.pth`` / ``.pt`` path is a reference PyTorch checkpoint, whose
        weights alone are loaded."""
        if fresh_start:
            return False
        if explicit_path and str(explicit_path).endswith((".pth", ".pt")):
            return self._resume_from_torch(explicit_path)
        path = self.ckpt.resolve_resume(explicit_path)
        if path is None:
            return False
        if self.state is None:
            raise RuntimeError("call init_state() before resume()")
        ckpt = load_checkpoint(path)
        tree = ckpt["state"]
        if is_reference_state(tree):
            tree = train_state_tree_from_reference(tree, self.state.names)
        if self.tp is not None:
            tree = shard_train_tree(tree, self.tp_specs, self.tp)
        self._restore_state(tree)
        self._check_replicas("resume")
        self.start_epoch = ckpt["meta"]["epoch"] + 1
        return True

    # -- epochs ----------------------------------------------------------------

    def _aug_generator(self, epoch: int, b_idx: int) -> torch.Generator:
        """RawBoost's generator for a batch, from (seed, data shard, epoch,
        batch): shards draw differently, the ranks of one shard alike, and
        a resumed run draws as an uninterrupted one."""
        key = (self.cfg.train.seed, self.data_index, epoch, b_idx)
        seed = int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def train_epoch(self, loader, epoch: int) -> EpochMetrics:
        """One epoch of the hot loop, with no host sync per step (module
        docstring); the one fetch is in ``_finish_epoch``."""
        if self.state is None:
            raise RuntimeError("call init_state() (and resume()) first")
        aug = self.cfg.train.rawboost
        dev = self.device
        # per process: sums of loss, cls, sae and cpc weighted by the
        # valid rows, correct rows, valid rows
        acc = torch.zeros(6, dtype=torch.float32, device=dev)
        scores: List[torch.Tensor] = []
        finite: List[torch.Tensor] = []
        meta = []  # (labels, valid, b_idx) on the host
        marks = []
        prof = None
        for b_idx, batch in enumerate(loader.epoch(epoch)):
            if self.profile_steps and not self._profiled and b_idx == 1:
                prof = self._start_profile()
            (wav, labels, valid), _ = dist.global_batch(
                (batch.wav, batch.labels, batch.valid), self.mesh, device=dev)
            if aug.algo in range(1, 9):
                wav = rawboost_batch(self._aug_generator(epoch, b_idx), dequantize_wire(wav),
                                     aug, device=dev)
            self.state, m = self.train_step(self.state, wav, labels, valid,
                                            self.cfg.train.seed)
            n = float(batch.valid.sum())
            fold = torch.stack([m["loss"] * n, m["cls_loss"] * n, m["sae_loss"] * n,
                                m["cpc_loss"] * n, m["correct"].float(),
                                torch.full((), n, device=dev)])
            acc += torch.where(m["finite"], fold, 0.0)
            scores.append(m["scores"])
            finite.append(m["finite"])
            meta.append((batch.labels, batch.valid, b_idx))
            marks.append(_mark(dev))
            if b_idx >= _PIPELINE_DEPTH and b_idx % _PIPELINE_DEPTH == 0:
                _wait(marks[b_idx - _PIPELINE_DEPTH])
            if prof is not None and b_idx >= self.profile_steps:
                self._stop_profile(prof)
                prof = None
        if prof is not None:
            self._stop_profile(prof)
        return self._finish_epoch(epoch, acc, scores, finite, meta)

    def _finish_epoch(self, epoch: int, acc: torch.Tensor, scores: List[torch.Tensor],
                      finite: List[torch.Tensor], meta) -> EpochMetrics:
        """The epoch's one device -> host fetch (accumulator, flags and
        score rows in one copy), the non-finite report, and the
        combination over the data ranks (the reference's
        ``_combine_epoch``: its ``correct`` is the global batch's, here
        each rank's, summed with the rest)."""
        parts = [acc]
        if finite:
            parts += [torch.stack(finite).float(), torch.cat(scores).float()]
        host = torch.cat(parts).cpu().numpy()
        sums, flags = host[:6].astype(np.float64), host[6:6 + len(finite)] > 0
        rows = np.split(host[6 + len(finite):], np.cumsum([s.numel() for s in scores])[:-1])
        scores_all: List[np.ndarray] = []
        labels_all: List[np.ndarray] = []
        for ok, s, (labels, valid, b_idx) in zip(flags, rows, meta):
            if not ok:
                # the step kept the state as it was; the fold left it out
                self._nonfinite_batches += 1
                print(f"WARNING: non-finite loss at batch {b_idx} (epoch {epoch}); "
                      "update was rejected in-step", flush=True)
                continue
            scores_all.append(s[valid])
            labels_all.append(labels[valid])
        loss_s, cls_s, sae_s, cpc_s, correct, n_g = self._sum_ranks(
            [sums[0], sums[1], sums[2], sums[3], sums[4], sums[5]])
        n = max(float(n_g), 1.0)
        return EpochMetrics(loss=float(loss_s) / n, cls_loss=float(cls_s) / n,
                            sae_loss=float(sae_s) / n, cpc_loss=float(cpc_s) / n,
                            acc=100.0 * float(correct) / n,
                            eer=self._eer(scores_all, labels_all))

    def _start_profile(self) -> profiling.Trace:
        return profiling.Trace(self.run_dir / "profile").start()

    def _stop_profile(self, prof: profiling.Trace) -> None:
        path = prof.stop()
        self._profiled = True
        if self.io_primary:
            print(f"{self.log_prefix}profile: {path}", flush=True)

    def validate(self, loader) -> EpochMetrics:
        """Loss (weighted NLL at ``loss_weights``), SAE loss, accuracy and
        EER over the valid rows of ``loader``'s epoch 0: a padded tail
        batch counts exactly.  Results come back ``_PIPELINE_DEPTH``
        batches behind the device, each waited for alone."""
        if self.state is None:
            raise RuntimeError("call init_state() (and resume()) first")
        weights = self.cfg.train.loss_weights
        n_seen, loss_sum, sae_sum, correct = 0.0, 0.0, 0.0, 0.0
        scores_all: List[np.ndarray] = []
        labels_all: List[np.ndarray] = []

        def take(item) -> None:
            nonlocal n_seen, loss_sum, sae_sum, correct
            out, mark, labels, valid = item
            _wait(mark)
            v = torch.from_numpy(valid)
            y = torch.from_numpy(labels)[v]
            logp = out["log_probs"][v]
            bsz = int(valid.sum())
            n_seen += bsz
            loss_sum += float(weighted_nll(logp, y, weights)) * bsz
            if "sae_loss_per_example" in out:
                sae_sum += float(out["sae_loss_per_example"][v].sum())
            else:
                sae_sum += float(out["sae_loss"]) * bsz
            correct += float((logp.argmax(-1) == y).sum())
            scores_all.append(out["score"][v].numpy())
            labels_all.append(labels[valid])

        pending = []
        for batch in loader.epoch(0):
            out = self._run_eval(to_device(batch.wav, self.device))
            host = {k: out[k].to("cpu", non_blocking=True) for k in
                    ("log_probs", "score", "sae_loss_per_example", "sae_loss") if k in out}
            pending.append((host, _mark(self.device), batch.labels, batch.valid))
            if len(pending) > _PIPELINE_DEPTH:
                take(pending.pop(0))
        for item in pending:
            take(item)

        # each data shard was validated on its own: combine once per epoch
        loss_sum, sae_sum, correct, n_seen = self._sum_ranks(
            [loss_sum, sae_sum, correct, n_seen])
        n = max(float(n_seen), 1.0)
        return EpochMetrics(loss=float(loss_sum) / n, sae_loss=float(sae_sum) / n,
                            acc=100.0 * float(correct) / n,
                            eer=self._eer(scores_all, labels_all))

    def fit(self, train_loader, val_loader, num_epochs: Optional[int] = None) -> None:
        """Train from ``start_epoch`` to ``num_epochs`` (default the
        config's), with a CSV row, TensorBoard scalars and a checkpoint
        each epoch; returns when the last checkpoint is on disk."""
        if self.state is None:
            raise RuntimeError("call init_state() (and resume()) first")
        num_epochs = num_epochs or self.cfg.train.num_epochs
        for epoch in range(self.start_epoch, num_epochs):
            t0 = time.time()
            tr = self.train_epoch(train_loader, epoch)
            va = self.validate(val_loader)
            dt = time.time() - t0
            if self.csv is not None:
                self.csv.log(epoch_row(epoch, tr, va, dt))
            if self.tb is not None:
                for key, value in [("train/loss", tr.loss), ("train/eer", tr.eer),
                                   ("train/acc", tr.acc), ("train/sae_loss", tr.sae_loss),
                                   ("val/loss", va.loss), ("val/eer", va.eer),
                                   ("val/acc", va.acc)]:
                    self.tb.add_scalar(key, value, epoch)
            tree = self._checkpoint_tree()  # every rank: a gather under TP
            if self.io_primary:
                # the host copy is made before this returns; the write
                # overlaps the next epoch
                improved = self.ckpt.save_epoch(
                    tree, epoch,
                    {"val_eer": va.eer, "val_loss": va.loss, "val_acc": va.acc}, block=False)
                marker = " *best*" if improved else ""
                print(f"{self.log_prefix}epoch {epoch}: train_loss={tr.loss:.4f} "
                      f"train_eer={tr.eer:.2f}% val_eer={va.eer:.2f}% ({dt:.1f}s){marker}",
                      flush=True)
            dist.sync_hosts()  # the processes enter the next epoch together
        self.ckpt.wait()

    # -- scoring ----------------------------------------------------------------

    def produce_scores(self, loader, out_path) -> int:
        """The ``utt score`` file of ``loader``'s utterances (module
        function ``produce_scores`` on this trainer's eval step)."""
        if self.state is None:
            raise RuntimeError("call init_state() (and resume()) first")
        coords = self.mesh.coords if self.mesh is not None else None
        if not coords or self.data_ranks == len(self.mesh.ranks):
            return produce_scores(self._run_eval, loader, out_path)
        # one writer a data shard: its rank 0 along the mesh's other axes
        return produce_scores(self._run_eval, loader, out_path,
                              part=(self.data_index, self.data_ranks,
                                    all(i == 0 for a, i in coords.items() if a != "data")))


class Trainer(BaseTrainer):
    """The trainer of the SAE detector (per-timestep and window
    variants).  The model's weights are drawn from ``cfg.train.seed`` on
    the device; load others into ``self.model`` before ``init_state``."""

    def _build_model_and_steps(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.train.seed)
        self.model = Detector(self.cfg.model, device=self.device, generator=gen)
        self.train_step = make_train_step(self.model, self.cfg, device=self.device,
                                          mesh=self.mesh)
        self.eval_step = make_eval_step(self.model, device=self.device, mesh=self.mesh)

    def _create_state(self):
        return create_train_state(self.model, self.cfg)

    def _state_tree(self) -> Dict:
        return train_state_tree(self.model, self.state)

    def _restore_state(self, tree: Dict) -> None:
        restore_train_state(self.model, self.state, tree)

    def _run_eval(self, wav: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.eval_step(wav)

    def _resume_from_torch(self, path) -> bool:
        """Weights only, from a reference PyTorch dict checkpoint (its
        ``model`` entry, or the dict itself; ``module.`` prefixes
        allowed); the moments and step stay as they are."""
        if self.state is None:
            raise RuntimeError("call init_state() before resume()")
        raw = torch.load(path, map_location="cpu", weights_only=True)
        state = raw.get("model", raw) if isinstance(raw, dict) else raw
        self._load_model_state(detector_state_from_reference(state, self.cfg.model))
        self._torch_epoch_from(raw, path)
        return True


def produce_scores(eval_step: Callable, loader, out_path: Union[str, Path],
                   part: Optional[tuple] = None) -> int:
    """Write the ``utt score`` file for every valid row the loader yields;
    returns the number of lines written.

    Multi-process: each process scores its own shard of the set
    (``ArrayLoader.host_shard``) on its own device and writes a part
    file; the primary concatenates the parts in process order, and every
    process returns the global count.  Every process must make the call.
    ``part`` = (index, count, writes) names this process's part and the
    number of parts when they are not one a process (tensor parallelism:
    one a data shard, written by one of the ranks that score it).

    Depth-2 pipeline: batch N is fetched from the device (and written)
    only after batches N+1 and N+2 are queued, so host batching, device
    compute and score writing overlap."""
    index, count, writes = part if part is not None else (None, None, True)
    n = 0
    with ScoreWriter(dist.part_path(out_path, index, count) if writes else os.devnull) as writer:
        pending = []

        def flush(item) -> None:
            nonlocal n
            utt_ids, valid, out = item
            score = log_probs_to_scores(out["log_probs"])  # waits for the device
            writer.write_batch([u for u, ok in zip(utt_ids, valid) if ok], score[valid])
            n += int(valid.sum()) if writes else 0

        for batch in loader.epoch(0):
            out = eval_step(batch.wav)
            pending.append((list(batch.utt_ids), np.asarray(batch.valid, bool), out))
            if len(pending) > 2:
                flush(pending.pop(0))
        for item in pending:
            flush(item)
    dist.merge_part_files(out_path, count)
    return int(dist.allreduce_sum_scalars([float(n)])[0])
