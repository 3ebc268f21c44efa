"""``conv_ms.<kind>``: device milliseconds a step in convolution kernels,
over the traced stretch.  The rule is ``chip_smoke.py``'s
``TRAIN_CATEGORIES`` first category: a kernel whose name holds "cudnn",
"dgrad", "wgrad", "fprop" or "conv"."""

from perfbench.layer_metrics import STEP_SPAN, device_seconds, split, stretch_count

CONV_KEYS = ("cudnn", "dgrad", "wgrad", "fprop", "conv")


def read(run, name):
    calls = stretch_count(run, f"{STEP_SPAN[split(name)]}.calls")
    seconds = device_seconds(run, CONV_KEYS)
    return 1e3 * seconds / calls if calls and seconds else None
