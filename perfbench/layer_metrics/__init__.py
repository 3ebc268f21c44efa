"""Per-layer metrics, one reader a family of names: ``<family>.py``'s
``read(run, name)`` returns the metric ``name`` of a finished run, or None
when it finds nothing to read (the metric is then left out of the line).

The split after the first dot names the cell's kind; ``STEP_SPAN`` gives
the harness span that wraps the kind's call into the program, whose
calls, rows and FLOPs the traced stretch counts."""

STEP_SPAN = {"score": "eval_step", "train": "train_step", "long": "forward",
             "serve": "score_fn"}


def split(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def stretch_count(run, name: str) -> float:
    """A counter of the traced stretch (0 when nothing counted it)."""
    return run.tracer.counts.get(name, 0.0)


def device_seconds(run, keys) -> float:
    """Device seconds in the traced stretch of operations whose name holds
    any of ``keys``."""
    red = run.tracer.result
    if red is None:
        return 0.0
    return sum(s for n, s in red.by_name_s.items() if any(k in n for k in keys))
