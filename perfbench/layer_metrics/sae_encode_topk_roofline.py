"""``sae_encode_topk_roofline.<kind>``: kernel row 1 (the fused SAE encode
and TopK: its cast pass, bf16 GEMM and radix select), its least time at
each step's rows over its device time, over the traced stretch."""

from perfbench import flops, peaks
from perfbench.layer_metrics import STEP_SPAN, device_seconds, split, stretch_count
from perfbench.reference.xlsr import num_frames

KERNELS = ("cast_x_bf16_kernel", "cast_w_bf16_kernel", "encode_bf16_wgmma_kernel",
           "topk_radix_select_kernel")


def read(run, name):
    calls = stretch_count(run, f"{STEP_SPAN[split(name)]}.calls")
    seconds = device_seconds(run, KERNELS)
    if not calls or not seconds:
        return None
    cfg = run.cell.config
    rows = run.params["batch"] * num_frames(cfg["encoder"], run.params["samples"])
    ops, nbytes = flops.sae_encode_topk(rows, cfg["sae"]["activation_dim"], cfg["sae"]["dict_size"])
    return 100.0 * calls * peaks.least_seconds(ops, nbytes) / seconds
