"""The traced stretch of a ``--trace 1`` run, and its reduction.

``Tracer.tick()`` is called by the harness's wrappers at each call into
the program, from any thread.  Once the window has run ``start_s``, the
next tick starts ``torch.profiler`` on the device lane alone (recording
every host operation would slow the host's enqueue several fold, and
the trace would show a host-bound program that the window never runs)
and notes the host clock; the first tick ``length_s`` later
synchronizes, notes it again and stops.  The profiler's timestamps are
the host's wall clock in nanoseconds (``time.time_ns``), as are the
harness's own spans (``Tracer.span``, kept in memory while the stretch
runs), so both line up with the device's intervals.  Nothing is
written to disk.  The reduction, made once the window has closed,
gives:

- the stretch's window: from the first device operation launched in it
  (work queued before the profiler started is not recorded, so the
  window starts where recorded work starts) to the second note, after
  the synchronize;
- busy seconds: the union of the device intervals inside the window;
- device time by operation name;
- the idle gaps, each put to the innermost harness span open on the host
  when it began ("outside harness spans" where none was).

The arithmetic of device time by name is ``chip_smoke.py``'s
``device_time_by_kernel`` (device lane of the profiler, durations summed
by name); the categories of ``TRAIN_CATEGORIES`` are copied in
``layer_metrics``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "perfbench."


class _Span:
    def __init__(self, tracer, name):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.tracer.active:
            self.tracer.spans.append((self.name, self.t0, t1))
        elif self.tracer._t0 is None:  # set-up: each span's seconds, for the record
            phases = self.tracer.setup_phases
            phases[self.name] = phases.get(self.name, 0.0) + (t1 - self.t0) / 1e9


@dataclass
class Reduced:
    window_s: float
    busy_s: float
    by_name_s: Dict[str, float]
    idle_by_span_s: Dict[str, float]


class Tracer:
    def __init__(self, enabled: bool, start_s: float, length_s: float, device):
        self.enabled = enabled
        self.start_s, self.length_s = start_s, length_s
        self.device = device
        self.active = False
        self.done = not enabled
        self.result: Optional[Reduced] = None
        self.counts: Dict[str, float] = {}
        self.spans: List[Tuple[str, int, int]] = []
        self.setup_phases: Dict[str, float] = {}
        self._t0: Optional[float] = None
        self._prof = None
        self._begin_ns = 0
        self._started = 0.0
        self._stopped = None
        self._lock = threading.Lock()

    def prepare(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        (CUPTI's initialisation) takes seconds, which must not fall in
        the stretch."""
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            cuda = self.device.type == "cuda"
            with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]):
                pass

    def begin_window(self, t0: float) -> None:
        self._t0 = t0

    def span(self, name: str) -> _Span:
        """A harness span ``perfbench.<name>``, kept while the stretch runs."""
        return _Span(self, SPAN_PREFIX + name)

    def count(self, name: str, value: float = 1.0) -> None:
        """Add to a counter of the stretch (only while it runs)."""
        if self.active:
            self.counts[name] = self.counts.get(name, 0.0) + value

    def tick(self) -> None:
        if self.done or self._t0 is None:
            return
        with self._lock:
            now = time.perf_counter()
            if not self.active and now - self._t0 >= self.start_s:
                self._start()
                self._started = time.perf_counter()
            elif self.active and now - self._started >= self.length_s:
                self._stop()

    def finish(self) -> None:
        """Close a stretch still open when the window ends, and reduce it
        (after the window, so the reduction takes nothing from it)."""
        with self._lock:
            if self.active:
                self._stop()
            self.done = True
        if self._stopped is not None:
            self.result = reduce(*self._stopped, self.spans)
            self._stopped = None

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        self._prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self._prof.start()
        self._begin_ns = time.time_ns()
        self.active = True

    def _stop(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        end_ns = time.time_ns()
        self.active = False
        self._prof.stop()
        self._stopped = (self._prof, self._begin_ns, end_ns)
        self._prof = None
        self.done = True


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of the device's operations (kernels,
    copies, sets), annotations left out."""
    from torch.autograd import DeviceType

    out = []
    try:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
                out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    except AttributeError:  # an older profiler: its FunctionEvents
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                out.append((e.name, int(e.time_range.start * 1000), int(e.time_range.end * 1000)))
    return [ev for ev in out if not ev[0].startswith(SPAN_PREFIX)]


def reduce(prof, s_begin: int, s_end: int, spans: List[Tuple[str, int, int]]) -> Reduced:
    """The stretch [``s_begin``, ``s_end``] (host ns) of a stopped profiler,
    with the harness's spans of it."""
    kernels = sorted((s, e, n) for n, s, e in device_events(prof) if e > s_begin and s < s_end)
    if not kernels:
        raise RuntimeError("the profiler saw no device operation in the stretch")
    w0 = max(s_begin, kernels[0][0])
    by_name: Dict[str, int] = {}
    merged: List[List[int]] = []
    for s, e, n in kernels:
        s, e = max(s, w0), min(e, s_end)
        if e <= s:
            continue
        by_name[n] = by_name.get(n, 0) + (e - s)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    if merged and merged[-1][1] < s_end:
        gaps.append((merged[-1][1], s_end))
    idle: Dict[str, float] = {}
    pending = sorted((s, e, n) for n, s, e in spans)
    active: List[Tuple[int, int, str]] = []
    at = 0
    for g0, g1 in gaps:  # in time order: sweep the spans once
        while at < len(pending) and pending[at][0] <= g0:
            active.append(pending[at])
            at += 1
        active = [sp for sp in active if sp[1] > g0]
        label = max(active)[2] if active else "outside harness spans"
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e9
    return Reduced(window_s=(s_end - w0) / 1e9, busy_s=busy / 1e9,
                   by_name_s={n: v / 1e9 for n, v in by_name.items()},
                   idle_by_span_s=idle)
