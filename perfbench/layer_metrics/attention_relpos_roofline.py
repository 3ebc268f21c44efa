"""``attention_relpos_roofline.<...>.<kind>``: kernel row 6's biased form
(WavLM's gated relative-position attention, ``attention_long_relpos_kernel``),
its least time at each forward's bucket T (one call a layer) over its
device time, over the traced stretch.

The work at T frames of width C over H heads, whatever computes it: the
products q k^T and p v, 4 T^2 C operations, and the bias's multiply-add
on each score, 2 T^2 H; T^2 H exponentials; bf16 q, k, v read and the
output written once (8 T C bytes), the fp32 gate (4 H T) and the fp32
table (4 H (2T - 1)) read once.  The least time is the largest of the
operations over the bf16 peak, the bytes over the memory's rate and the
exponentials over the special-function units' rate.  Every bucket the
stretch's forwards fill is counted, as ``attention_long_roofline``
counts them: a cell that reads this metric fills only buckets on the
kernel's route."""

from perfbench import peaks
from perfbench.layer_metrics import STEP_SPAN, device_seconds, split

KERNELS = ("attention_long_relpos_kernel",)
# ex2 on the special-function units: 16 a clock on each of 132 SMs at 1980 MHz
EXP_PER_S = 132 * 16 * 1.98e9


def work(t: int, c: int, h: int):
    """(operations, bytes, exponentials) of one call at T = ``t``."""
    ops = 4.0 * t * t * c + 2.0 * t * t * h
    nbytes = 8.0 * t * c + 4.0 * h * t + 4.0 * h * (2 * t - 1)
    return ops, nbytes, float(t * t * h)


def least_seconds(t: int, c: int, h: int) -> float:
    ops, nbytes, exps = work(t, c, h)
    return max(peaks.least_seconds(ops, nbytes), exps / EXP_PER_S)


def read(run, name):
    prefix = f"{STEP_SPAN[split(name)]}.T"
    enc = run.cell.config["encoder"]
    least = 0.0
    for key, calls in run.tracer.counts.items():
        if key.startswith(prefix):
            least += calls * enc["num_hidden_layers"] * least_seconds(
                int(key[len(prefix):]), enc["hidden_size"], enc["num_attention_heads"])
    seconds = device_seconds(run, KERNELS)
    return 100.0 * least / seconds if least and seconds else None
