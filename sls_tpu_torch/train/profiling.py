"""Profiling and step timing, counterpart of ``sls_tpu/train/profiling.py``.

- ``trace(logdir)``: a ``torch.profiler`` capture (CPU and, on a card,
  CUDA activities) of the enclosed block, written as a chrome trace
  ``logdir/trace.json`` (later captures into the same directory
  ``logdir/<n>.trace.json``; ``Trace`` is the same as an object
  with ``start`` / ``stop``, which ``BaseTrainer``'s ``profile_steps``
  uses);
- ``StepTimer``: wall-clock per-step statistics with warm-up discard,
  the reference's code and summary keys;
- ``device_memory_stats``: each card's memory in the reference's keys;
- ``op_histogram`` / ``compare_profiles``: per-op time summed over a
  capture's chrome traces, and the diff of two (``cli/profile_diff.py``).
  The device lane is the events of category ``kernel`` (one a CUDA
  kernel launch's execution on the card).
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

TRACE_GLOBS = ("*trace.json", "*trace.json.gz")
DEVICE_CATEGORY = "kernel"


class Trace:
    """One ``torch.profiler`` capture into ``logdir``: ``start()``, the
    work, ``stop()``; ``path`` is the chrome trace written by ``stop``."""

    def __init__(self, logdir):
        self.logdir = Path(logdir)
        self.path: Optional[Path] = None
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)

    def start(self) -> "Trace":
        self._prof.start()
        return self

    def stop(self) -> Path:
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the device's events end inside the capture
        self._prof.stop()
        self.logdir.mkdir(parents=True, exist_ok=True)
        n = len(list(self.logdir.glob(TRACE_GLOBS[0])))
        self.path = self.logdir / ("trace.json" if n == 0 else f"{n}.trace.json")
        self._prof.export_chrome_trace(str(self.path))
        return self.path


@contextlib.contextmanager
def trace(logdir):
    """Capture a torch.profiler trace of the enclosed block into ``logdir``."""
    t = Trace(logdir).start()
    try:
        yield t
    finally:
        t.stop()


@dataclass
class StepTimer:
    """Per-step wall-clock stats; call tick() after each blocking step."""

    warmup: int = 2
    _t_last: Optional[float] = None
    _durations: List[float] = field(default_factory=list)
    _seen: int = 0

    def start(self) -> None:
        self._t_last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        if self._t_last is None:
            self._t_last = now
            return 0.0
        dt = now - self._t_last
        self._t_last = now
        self._seen += 1
        if self._seen > self.warmup:
            self._durations.append(dt)
        return dt

    def summary(self, items_per_step: Optional[int] = None) -> Dict[str, float]:
        if not self._durations:
            return {"steps": 0}
        d = np.asarray(self._durations)
        out = {
            "steps": int(len(d)),
            "mean_s": float(d.mean()),
            "p50_s": float(np.percentile(d, 50)),
            "p90_s": float(np.percentile(d, 90)),
            "max_s": float(d.max()),
        }
        if items_per_step:
            out["items_per_sec"] = items_per_step / out["mean_s"]
        return out


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-card memory (bytes): ``bytes_in_use`` and ``peak_bytes_in_use``
    of PyTorch's allocator, ``bytes_limit`` the card's total; empty
    without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": float(torch.cuda.memory_allocated(i)),
            "peak_bytes_in_use": float(torch.cuda.max_memory_allocated(i)),
            "bytes_limit": float(total),
        }
    return out


def _trace_files(trace_dir) -> List[str]:
    paths = sorted(p for pattern in TRACE_GLOBS
                   for p in glob.glob(f"{trace_dir}/**/{pattern}", recursive=True))
    if not paths:
        raise FileNotFoundError(
            f"no {' or '.join(TRACE_GLOBS)} under {trace_dir} - pass the logdir "
            "given to profiling.trace()")
    return paths


def op_histogram(
    trace_dir,
    lane_filter: Optional[str] = None,
    group: bool = True,
    top: Optional[int] = None,
) -> Dict[str, Dict[str, float]]:
    """Per-op time from a ``trace(logdir)`` capture.

    Reads every chrome trace under ``trace_dir`` and returns ``{op_name:
    {"ms": total_ms, "count": n}}`` over the events whose category
    contains ``lane_filter`` (default ``"kernel"``: the card's kernels;
    ``"cpu_op"`` gives the host's operators).  ``group=True`` collapses
    numbered instances (``fusion.123`` -> ``fusion``) as the reference
    does; ``top`` keeps the ``top`` largest by time."""
    lane = DEVICE_CATEGORY if lane_filter is None else lane_filter
    agg: Dict[str, Dict[str, float]] = {}
    for path in _trace_files(trace_dir):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as fh:
            events = json.load(fh).get("traceEvents", [])
        for e in events:
            if e.get("ph") != "X" or lane not in str(e.get("cat", "")):
                continue
            name = e.get("name", "?")
            if group:
                name = re.sub(r"[.\d]+$", "", name)
            slot = agg.setdefault(name, {"ms": 0.0, "count": 0})
            slot["ms"] += float(e.get("dur", 0)) / 1e3
            slot["count"] += 1
    if top is not None:
        agg = dict(sorted(agg.items(), key=lambda kv: -kv[1]["ms"])[:top])
    return agg


def compare_profiles(
    a: Dict[str, Dict[str, float]],
    b: Dict[str, Dict[str, float]],
    min_ms: float = 0.05,
) -> List[Dict[str, float]]:
    """Diff two ``op_histogram`` results; rows sorted by descending
    ``delta_ms`` (b minus a).  Feed A = baseline program, B = candidate:
    the top rows name the ops the change made slower."""
    rows = []
    for name in sorted(set(a) | set(b)):
        am = a.get(name, {}).get("ms", 0.0)
        bm = b.get(name, {}).get("ms", 0.0)
        if max(am, bm) < min_ms:
            continue
        rows.append({
            "op": name,
            "a_ms": round(am, 3),
            "a_count": int(a.get(name, {}).get("count", 0)),
            "b_ms": round(bm, 3),
            "b_count": int(b.get(name, {}).get("count", 0)),
            "delta_ms": round(bm - am, 3),
        })
    rows.sort(key=lambda r: -r["delta_ms"])
    return rows
