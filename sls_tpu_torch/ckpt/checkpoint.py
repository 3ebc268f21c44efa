"""Checkpoints: atomic last / best saves and the resume chain,
counterpart of ``sls_tpu/ckpt/checkpoint.py`` in the port's own format.

A checkpoint is one ``torch.save`` of a dict: the training state (the
Trainer's ``train/steps.py::train_state_tree``: the model's
``state_dict``, the trainable ``names``, Adam's flat ``exp_avg`` /
``exp_avg_sq``, ``step`` and ``calls``) beside ``meta`` (``epoch``,
``metrics``, ``config_json``, the config serialised whole: the
checkpoint-as-config idiom of the reference).

- Writes are atomic: a ``.tmp`` file, flushed and ``fsync``ed, then
  ``os.replace`` (a killed job leaves the old file or the new one).
- Loads use ``weights_only=True`` (no code runs from the file) and
  ``mmap=True``, so reading the meta of a multi-GB file reads its
  pickle and not its tensors.
- ``CheckpointManager``: ``last.ckpt`` every epoch and ``best.ckpt``
  when ``val_eer`` improves; resume in the order explicit > last > best.

``load_checkpoint`` also reads the JAX package's files (flax msgpack,
through ``ckpt/msgpack.py``), told apart by their first bytes: a
``torch.save`` file is a zip archive.  Such a file comes back in the
same ``{"state", "meta"}`` shape, its ``state`` the reference's tree
(``params``, ``opt_state``, ``step``) with ``params`` mapped to this
package's state dict (``convert.detector_state_from_flax``);
``train/steps.py::train_state_tree_from_reference`` turns it into a
resumable state.  The reference's ``_conform_state_dict`` migration of
pre-masked-optimizer states has no counterpart: this format always
stores the trainable names with the moments, and a mismatch raises
(``train/steps.py::restore_train_state``).  Reference ``.pth`` files
are read by ``Trainer.resume`` (weights only).
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from sls_tpu_torch.ckpt import msgpack
from sls_tpu_torch.convert import batch_stats_from_flax, detector_state_from_flax

PathLike = Union[str, Path]

LAST_NAME = "last.ckpt"
BEST_NAME = "best.ckpt"
BEST_KEY = "val_eer"  # best is the lowest


def to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor copied to host memory.  The
    copy is synchronous (the caller may update the device tensors in
    place as soon as this returns) and always a copy, on the CPU too."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def save_checkpoint(path: PathLike, state: Dict[str, Any], *, epoch: int,
                    metrics: Optional[Dict[str, float]] = None,
                    config_json: Optional[str] = None) -> int:
    """Atomically write ``state`` (host tensors, as ``to_host`` gives
    them) with its meta to ``path``; returns the bytes written."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta = {"epoch": int(epoch),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
            "config_json": config_json or ""}
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        torch.save({"state": state, "meta": meta}, f)
        f.flush()
        os.fsync(f.fileno())
        size = f.tell()
    os.replace(tmp, path)
    return size


_ZIP_MAGIC = b"PK\x03\x04"


def is_torch_file(path: PathLike) -> bool:
    """Whether ``path`` is a ``torch.save`` file (a zip archive), not a
    JAX package's msgpack checkpoint."""
    with open(path, "rb") as f:
        return f.read(4) == _ZIP_MAGIC


def load_checkpoint(path: PathLike) -> Dict[str, Any]:
    """``{"state": ..., "meta": ...}`` of a checkpoint of either package.
    This package's tensors are mapped from the file (copied in when
    used); a JAX package's file is read whole, its ``meta`` holding
    ``epoch``, ``metrics`` and ``config_json`` as here and its
    ``state["params"]`` mapped to a state dict (module docstring), with
    the running statistics of a ``batch_stats`` collection (the SLS
    family's BatchNorm) as its buffers."""
    if is_torch_file(path):
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    raw = msgpack.read(path)
    meta_raw = raw.get("meta", {})
    meta = {"epoch": int(meta_raw.get("epoch", 0)),
            "metrics": json.loads(meta_raw.get("metrics_json", "{}")),
            "config_json": meta_raw.get("config_json", "")}
    state = dict(raw["state"])
    if "params" in state:
        state["params"] = {**detector_state_from_flax(state["params"]),
                           **batch_stats_from_flax(state.get("batch_stats", {}))}
    return {"state": state, "meta": meta}


def is_reference_state(state: Dict[str, Any]) -> bool:
    """Whether a loaded ``state`` came from a JAX package's file."""
    return "params" in state


def read_meta(path: PathLike) -> Dict[str, Any]:
    """The meta (epoch, metrics, config_json) of a checkpoint; of this
    package's files without reading their tensors."""
    return load_checkpoint(path)["meta"]


class CheckpointManager:
    """last / best checkpoints of a run directory, written on one
    background thread at a time."""

    def __init__(self, run_dir: PathLike, config_json: str = ""):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.config_json = config_json
        self.best_metric: Optional[float] = None
        # bytes and seconds of the newest completed save_epoch
        self.last_save: Optional[Dict[str, float]] = None
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        if self.best_path.exists():
            try:
                self.best_metric = read_meta(self.best_path)["metrics"].get(BEST_KEY)
            except Exception:  # an unreadable best is replaced by the next one
                self.best_metric = None

    def _improves(self, metrics: Dict[str, float]) -> bool:
        """Whether ``metrics`` beat the best so far: a lower ``val_eer``."""
        value = metrics.get(BEST_KEY)
        return value is not None and (self.best_metric is None or value < self.best_metric)

    @property
    def last_path(self) -> Path:
        return self.run_dir / LAST_NAME

    @property
    def best_path(self) -> Path:
        return self.run_dir / BEST_NAME

    def save_epoch(self, state: Dict[str, Any], epoch: int, metrics: Dict[str, float],
                   block: bool = True) -> bool:
        """Save ``last``, and ``best`` too when ``metrics["val_eer"]`` is
        the lowest yet; returns True for a new best.

        ``state`` may hold device tensors.  It is copied to host memory
        before this returns, whatever ``block`` says: the train step
        updates the parameters and moments in place, so a copy left to
        run on would save a half-updated model.  ``block=False`` then
        serialises and writes on a background thread (at most one in
        flight), off the training's critical path; ``wait`` joins it."""
        improved = self._improves(metrics)
        if improved:
            self.best_metric = metrics[BEST_KEY]
        t0 = time.perf_counter()
        host = to_host(state)
        copy_s = time.perf_counter() - t0
        self.wait()  # raises if the previous write failed

        def write():
            t1 = time.perf_counter()
            size = save_checkpoint(self.last_path, host, epoch=epoch, metrics=metrics,
                                   config_json=self.config_json)
            files = [LAST_NAME]
            if improved:
                save_checkpoint(self.best_path, host, epoch=epoch, metrics=metrics,
                                config_json=self.config_json)
                files.append(BEST_NAME)
            write_s = time.perf_counter() - t1
            self.last_save = {"epoch": epoch, "bytes": size, "files": len(files),
                              "host_copy_s": copy_s, "write_s": write_s}
            print(f"[ckpt] epoch {epoch}: {' + '.join(files)}, {size / 1e9:.3f} GB each, "
                  f"host copy {copy_s:.2f} s, written in {write_s:.2f} s", flush=True)

        if block:
            write()
            return improved

        def guarded():
            try:
                write()
            except BaseException as e:  # surfaced by the next wait()
                self._writer_error = e

        self._writer = threading.Thread(target=guarded, daemon=True, name="ckpt-writer")
        self._writer.start()
        return improved

    def wait(self) -> None:
        """Join the write in flight, if any, and re-raise its failure
        (a full disk, say): left silent, last / best would stay stale
        while ``best_metric`` had moved on."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._writer_error is not None:
            err, self._writer_error = self._writer_error, None
            raise RuntimeError("async checkpoint write failed; last/best on disk may be "
                               "stale") from err

    def resolve_resume(self, explicit: Optional[PathLike] = None) -> Optional[Path]:
        """The checkpoint to resume from: ``explicit`` (which must exist),
        else last, else best, else None."""
        self.wait()  # a write in flight may still be producing 'last'
        if explicit:
            p = Path(explicit)
            if p.exists():
                return p
            raise FileNotFoundError(f"--resume checkpoint not found: {p}\n"
                                    + self.describe_available())
        for candidate in (self.last_path, self.best_path):
            if candidate.exists():
                return candidate
        return None

    def describe_available(self) -> str:
        """The run directory's checkpoints with their epoch and metrics,
        one line each."""
        ckpts = sorted(self.run_dir.glob("*.ckpt"))
        if not ckpts:
            return f"no checkpoints found in: {self.run_dir}"
        lines = [f"available checkpoints in {self.run_dir}:"]
        for p in ckpts:
            try:
                meta = read_meta(p)
                parts = [f"epoch {meta['epoch']}"]
                parts += [f"{k}={v:.4g}" for k, v in sorted(meta["metrics"].items())]
                lines.append(f"  {p.name}: " + ", ".join(parts))
            except Exception as e:  # listed as it is, whatever is wrong with it
                lines.append(f"  {p.name}: unreadable ({e})")
        return "\n".join(lines)
