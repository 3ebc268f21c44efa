"""``attention_long_roofline.<kind>``: kernel row 6 (the long-T attention),
its least time at each forward's bucket T (the kernel's own work, one
call a layer) over its device time, over the traced stretch."""

from perfbench import flops, peaks
from perfbench.layer_metrics import STEP_SPAN, device_seconds, split

KERNELS = ("attention_long_kernel",)


def read(run, name):
    prefix = f"{STEP_SPAN[split(name)]}.T"
    enc = run.cell.config["encoder"]
    least = 0.0
    for key, calls in run.tracer.counts.items():
        if key.startswith(prefix):
            ops, nbytes = flops.attention_long(int(key[len(prefix):]), enc["hidden_size"])
            least += calls * enc["num_hidden_layers"] * peaks.least_seconds(ops, nbytes)
    seconds = device_seconds(run, KERNELS)
    return 100.0 * least / seconds if least and seconds else None
