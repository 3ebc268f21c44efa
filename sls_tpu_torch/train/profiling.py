"""Profiling, counterpart of ``sls_tpu/train/profiling.py``.

- ``span(name, key=None)`` / ``count(name, value=1)``: the program's own
  host spans and counters.  Off by default: ``span`` then returns the
  shared ``NO_SPAN`` after one module-level check, allocating nothing,
  taking no lock and leaving the device lane alone.  ``start_recording()``
  turns recording on into an in-memory ``Recording`` and
  ``stop_recording()`` turns it off and hands it back (``recording()``
  is both as a context manager); calling them is the only switch.  A
  recorded span is a ``SpanRecord``: its name, ``time.time_ns()`` at
  entry and exit (the clock of ``torch.profiler``'s device intervals),
  the innermost span open on its thread when it opened, the batch or
  clip it is for (``key``, inherited from the spans around it, or set
  with ``keyed(key)``) and its thread.  While recording on a card,
  torch's sync debug mode is at ``warn`` and each synchronizing call of
  the host is counted, not printed, as ``sls.sync`` and as
  ``sls.sync.<innermost open span>``;
- ``trace(logdir)``: a ``torch.profiler`` capture (CPU and, on a card,
  CUDA activities) of the enclosed block, written as a chrome trace
  ``logdir/trace.json`` (later captures into the same directory
  ``logdir/<n>.trace.json``; ``Trace`` is the same as an object
  with ``start`` / ``stop``, which ``BaseTrainer``'s ``profile_steps``
  uses).  The capture records the program's spans too and writes them
  into its chrome trace as events of category ``sls.span``;
- ``device_memory_stats``: each card's memory in the reference's keys;
- ``op_histogram`` / ``compare_profiles``: per-op time summed over a
  capture's chrome traces, and the diff of two (``cli/profile_diff.py``).
  The device lane is the events of category ``kernel`` (one a CUDA
  kernel launch's execution on the card); ``lane_filter="sls.span"``
  reads the program's spans.

The spans (``sls.load``, ``sls.upload``, ``sls.dispatch``,
``sls.frontend``, ``sls.layers``, ``sls.sae``, ``sls.head``,
``sls.fetch``, ``sls.write``, ``sls.tile``) are opened in
``data/pipeline.py``, ``train/steps.py``, ``train/loop.py``,
``evaluation/overlap.py``, ``encoder/xlsr.py`` and
``models/detector.py``; none is held across a ``yield``.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import re
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import torch

TRACE_GLOBS = ("*trace.json", "*trace.json.gz")
DEVICE_CATEGORY = "kernel"


SPAN_CATEGORY = "sls.span"
SYNC_COUNTER = "sls.sync"
# torch's note at each synchronizing call under sync debug mode "warn"
SYNC_MESSAGE = "called a synchronizing CUDA operation"


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]  # the innermost span open on the thread at entry
    key: Any  # the batch or clip the work is for
    thread: int


class _NoSpan:
    """The span of recording off: enters and exits doing nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


NO_SPAN = _NoSpan()


class Recording:
    """What one stretch of recording holds: ``spans`` (``SpanRecord``s in
    the order they closed) and ``counts`` (name: total)."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.counts: Dict[str, float] = {}
        self.open = True
        self._local = threading.local()
        self._lock = threading.Lock()
        self._warnings = None
        self._sync_mode = None

    def stack(self) -> List["_Span"]:
        """This thread's open spans, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def innermost(self) -> Optional[str]:
        stack = self.stack()
        return stack[-1].name or stack[-1].parent if stack else None

    def add(self, name: str, value: float) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + value

    def _watch_syncs(self) -> None:
        """Sync debug mode at ``warn``, its notes counted and not shown;
        the mode, the filters and ``showwarning`` are put back by
        ``_unwatch_syncs``.  Without a card there is nothing to wait on."""
        if not torch.cuda.is_available():
            return
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.filterwarnings("always", message=".*" + SYNC_MESSAGE)
        shown = warnings.showwarning

        def showwarning(message, category, filename, lineno, file=None, line=None):
            if SYNC_MESSAGE in str(message):
                self.add(SYNC_COUNTER, 1)
                where = self.innermost()
                if where is not None:
                    self.add(f"{SYNC_COUNTER}.{where}", 1)
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = showwarning
        self._sync_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")

    def _unwatch_syncs(self) -> None:
        if self._warnings is None:
            return
        torch.cuda.set_sync_debug_mode(self._sync_mode)
        self._warnings.__exit__(None, None, None)
        self._warnings = None


class _Span:
    __slots__ = ("rec", "name", "key", "parent", "t0")

    def __init__(self, rec: Recording, name: Optional[str], key: Any):
        self.rec, self.name, self.key, self.parent = rec, name, key, None

    def __enter__(self) -> "_Span":
        stack = self.rec.stack()
        if stack:
            outer = stack[-1]
            self.parent = outer.name or outer.parent
            if self.key is None:
                self.key = outer.key
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.time_ns()
        stack = self.rec.stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if self.name is not None and self.rec.open:
            self.rec.spans.append(SpanRecord(self.name, self.t0, t1, self.parent, self.key,
                                             threading.get_ident()))


_recording: Optional[Recording] = None
_switch = threading.Lock()  # start and stop only: a span takes no lock


def span(name: str, key: Any = None):
    """A context manager timing the enclosed host work as ``name`` for
    ``key`` (default: the key of the span around it); ``NO_SPAN`` when
    recording is off."""
    if _recording is None:
        return NO_SPAN
    return _Span(_recording, name, key)


def keyed(key: Any):
    """Give the spans opened inside ``key``, recording no span itself."""
    if _recording is None:
        return NO_SPAN
    return _Span(_recording, None, key)


def count(name: str, value: float = 1) -> None:
    """Add ``value`` to the counter ``name`` (nothing when recording is off)."""
    rec = _recording
    if rec is not None:
        rec.add(name, value)


def recording_on() -> bool:
    return _recording is not None


def start_recording() -> Recording:
    """Turn recording on; ``stop_recording`` hands back what it held."""
    global _recording
    with _switch:
        if _recording is not None:
            raise RuntimeError("the program's spans are already being recorded")
        rec = Recording()
        rec._watch_syncs()
        _recording = rec
    return rec


def stop_recording() -> Recording:
    """Turn recording off and return it.  A span still open is dropped."""
    global _recording
    with _switch:
        rec = _recording
        if rec is None:
            raise RuntimeError("the program's spans are not being recorded")
        _recording = None
        rec.open = False
        rec._unwatch_syncs()
    return rec


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    rec = start_recording()
    try:
        yield rec
    finally:
        stop_recording()


def _add_spans_to_chrome_trace(path, spans: List[SpanRecord]) -> None:
    """Append ``spans`` to the chrome trace at ``path`` as ``X`` events of
    category ``sls.span``, on the trace's own time base: microseconds
    from its ``baseTimeNanoseconds`` (from the epoch where it has none),
    the base of the profiler's own events."""
    path = Path(path)
    doc = json.loads(path.read_text())
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = next((e["pid"] for e in doc.get("traceEvents", [])
                if e.get("ph") == "X" and "pid" in e), 0)
    doc.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": SPAN_CATEGORY, "name": s.name, "pid": pid, "tid": s.thread,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"parent": s.parent, "key": None if s.key is None else str(s.key)}}
        for s in spans)
    path.write_text(json.dumps(doc))


class Trace:
    """One ``torch.profiler`` capture into ``logdir``: ``start()``, the
    work, ``stop()``; ``path`` is the chrome trace written by ``stop``.
    Unless something else is recording them already, the capture records
    the program's spans and writes them into the trace."""

    def __init__(self, logdir):
        self.logdir = Path(logdir)
        self.path: Optional[Path] = None
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._own_recording = False

    def start(self) -> "Trace":
        self._prof.start()
        if not recording_on():
            start_recording()
            self._own_recording = True
        return self

    def stop(self) -> Path:
        spans = stop_recording().spans if self._own_recording else []
        self._own_recording = False
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the device's events end inside the capture
        self._prof.stop()
        self.logdir.mkdir(parents=True, exist_ok=True)
        n = len(list(self.logdir.glob(TRACE_GLOBS[0])))
        self.path = self.logdir / ("trace.json" if n == 0 else f"{n}.trace.json")
        self._prof.export_chrome_trace(str(self.path))
        if spans:
            _add_spans_to_chrome_trace(self.path, spans)
        return self.path


@contextlib.contextmanager
def trace(logdir):
    """Capture a torch.profiler trace of the enclosed block into ``logdir``."""
    t = Trace(logdir).start()
    try:
        yield t
    finally:
        t.stop()


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
