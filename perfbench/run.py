"""The benchmark of ``sls_tpu_torch``: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``BENCHMARK.json``'s workload entry and
``perfbench/workloads/<cell>.json``; its configuration
``perfbench/configs/<config>.json``, whose ``family`` names
``perfbench/families/<family>.py`` (the program's model of it, and the
plain reference beside it); its traffic ``perfbench/traffic/<kind>.py``;
each per-layer metric ``perfbench/layer_metrics/<first part of its
name>.py``.  A later cell, configuration or metric is a new file and a
new entry.

A run makes the weights and inputs from ``--seed`` on the card, builds
and warms up the program (``setup_s``: from this file's first line to
the window), measures for ``--seconds``, reads the peak memory, frees
the program, and holds what the window produced to the plain reference.
It prints each number compared beside its limit as its last lines on
standard error, and one JSON line last on standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones, read from a profiled stretch of the window.  It exits
nonzero with no result line when no card is there (or fewer than the
cell asks for), when ``sls_tpu_torch`` is missing, and when the JAX
package or JAX is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Callable, Dict, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names no process that prints a result may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "sls_tpu")
# build and kernel caches, at fixed paths inside the checkout
CACHE = ROOT / "build" / "perfbench"


def cache_env() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class ForbiddenModules(RuntimeError):
    """JAX or the JAX package was loaded by the time the window closed."""


def finite(obj):
    """``obj`` with every non-finite float as None, for strict JSON."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


@dataclass
class Cell:
    name: str
    chips: int
    workload: Dict[str, Any]
    config: Dict[str, Any]
    bench: Dict[str, Any]

    @staticmethod
    def load(name: str, root: Path = ROOT, listed: bool = True) -> "Cell":
        """The cell ``name`` of ``BENCHMARK.json``; with ``listed`` False
        (tests, readings) also one that only its workload file holds,
        on one chip."""
        bench = json.loads((root / "BENCHMARK.json").read_text())
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None and listed:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        workload = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
        config = json.loads((BENCH / "configs" / f"{workload['config']}.json").read_text())
        return Cell(name, entry["chips"] if entry else 1, workload, config, bench)

    def metrics(self, kind: str):
        return [m for m in self.bench[kind] if self.name in m.get("workloads", [self.name])]


@dataclass
class Outcome:
    """What a traffic module's window gives: counts, the end-to-end
    values by metric name, and the data its check needs (no program
    state)."""

    attempted: int
    failed: int
    e2e: Dict[str, float]
    check_data: Any


@dataclass
class Run:
    """One run: the cell, its arguments, the device, and what the
    wrappers and the traced stretch record for the per-layer readers."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float = T_START
    control: Optional[Dict[str, Any]] = None
    setup_s: Optional[float] = None
    counters: Dict[str, Any] = field(default_factory=dict)
    tracer: Any = None
    tmp: Optional[Path] = None

    def __post_init__(self):
        from perfbench.trace import Tracer

        start = min(max(1.0, 0.3 * self.seconds), 0.5 * self.seconds)
        length = min(3.0, 0.3 * self.seconds)
        self.tracer = Tracer(self.trace and self.device.type == "cuda", start, length, self.device)
        self.tmp = Path(tempfile.mkdtemp(prefix="perfbench-"))

    @property
    def params(self) -> Dict[str, Any]:
        return self.cell.workload["params"]

    @property
    def family(self):
        return importlib.import_module(f"perfbench.families.{self.cell.config['family']}")

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def end_setup(self) -> float:
        """Close the set-up (after a synchronize) and open the window."""
        self.tracer.prepare()
        self.sync()
        t = time.perf_counter()
        self.setup_s = t - self.t_start
        self.tracer.begin_window(t)
        return t

    def wrap(self, fn: Callable, span: str, keep: Optional[list] = None,
             enqueue: Optional[list] = None,
             counts: Optional[Callable[[], Dict[str, float]]] = None) -> Callable:
        """``fn`` inside a ``perfbench.<span>`` span, ticking the tracer:
        the host seconds of each call outside the stretch go to
        ``enqueue``, its result to ``keep``; the stretch counts its calls
        as ``<span>.calls`` and adds each of ``counts()`` (name: value,
        such as the call's model FLOPs as ``flops``) as
        ``<span>.<name>``."""
        tracer = self.tracer

        def call(*args, **kwargs):
            tracer.tick()
            traced = tracer.active
            t0 = time.perf_counter()
            with tracer.span(span):
                out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            if traced:
                tracer.count(f"{span}.calls")
                for key, value in (counts() if counts else {}).items():
                    tracer.count(f"{span}.{key}", value)
            elif enqueue is not None:
                enqueue.append(dt)
            if keep is not None:
                keep.append(out)
            return out

        return call

    def span(self, name: str):
        """A harness span around a call into a layer (``trace.Tracer.span``)."""
        return self.tracer.span(name)

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            control: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One run of ``cell`` on ``device`` (tests drive it on the CPU at a
    tiny size).  ``control`` replaces the program by the cell's control
    (its ``control`` entry), for the limits' upper readings.  Returns the
    result line's object; raises ``ForbiddenModules`` when a forbidden
    module is loaded once the window has closed."""
    import torch

    t_enter = time.perf_counter()
    traffic = importlib.import_module(f"perfbench.traffic.{cell.workload['traffic']}")
    run = Run(cell, seed, seconds, trace, device, control=control)
    try:
        outcome = traffic.run(run)
        run.tracer.finish()
        found = forbidden_modules()
        if found:
            raise ForbiddenModules(f"loaded once the window closed: {', '.join(found)}")
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = traffic.check(run, outcome.check_data)
        check_s = time.perf_counter() - t_check
        metrics = (per_layer(run, cell) if trace else end_to_end(run, cell, outcome))
    finally:
        run.close()
    correct = all(math.isfinite(v) and v <= limit for v, limit in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {"correct": correct, "attempted": outcome.attempted,
                              "failed": outcome.failed, "metrics": metrics, "device": dev}
    red = run.tracer.result
    if trace and red is not None:
        dev["busy_s"], dev["window_s"] = red.busy_s, red.window_s
        top = sorted(red.by_name_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(red.idle_by_span_s.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n[:200], s] for n, s in top],
                               "idle_gaps": [[n, s] for n, s in gaps]}
    result["check_s"] = check_s
    result["setup_phases_s"] = dict(run.tracer.setup_phases, before_run=t_enter - T_START,
                                    setup_s=run.setup_s)
    result["numbers"] = run.counters.get("numbers", {})
    result["checks"] = {name: {"value": v, "limit": limit} for name, (v, limit) in checks.items()}
    return result


def end_to_end(run: Run, cell: Cell, outcome: Outcome) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in cell.metrics("end_to_end"):
        value = run.setup_s if m["name"] == "setup_s" else outcome.e2e.get(m["name"])
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def per_layer(run: Run, cell: Cell) -> Dict[str, Dict[str, Any]]:
    """Each per-layer metric of the cell that its reader finds something
    for; a reader that finds nothing returns None and is left out."""
    out = {}
    for m in cell.metrics("per_layer"):
        reader = importlib.import_module(f"perfbench.layer_metrics.{m['name'].split('.')[0]}")
        value = reader.read(run, m["name"])
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env()
    cell = Cell.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        importlib.import_module("sls_tpu_torch")
    except ImportError as exc:
        print(f"perfbench: the program under test is missing: {exc}", file=sys.stderr)
        return 4
    print(f"perfbench: card {card_line()}", file=sys.stderr, flush=True)
    try:
        result = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    except ForbiddenModules as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 5
    print(f"perfbench: set-up spans {result['setup_phases_s']} s; the check took "
          f"{result['check_s']:.1f} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
