"""``mfu.<kind>``: the model FLOPs (``perfbench/flops.py``) of the work the
traced stretch's steps did, over its seconds times the bf16 peak
(989 TFLOP/s; the card's power limit is printed on an earlier line)."""

from perfbench import peaks
from perfbench.layer_metrics import STEP_SPAN, split, stretch_count


def read(run, name):
    red = run.tracer.result
    work = stretch_count(run, f"{STEP_SPAN[split(name)]}.flops")
    if red is None or not work:
        return None
    return 100.0 * work / (red.window_s * peaks.BF16_FLOPS)
