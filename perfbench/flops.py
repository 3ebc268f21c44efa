"""The work that inputs need, whatever computes it: model FLOPs per row,
and the operations and bytes of the kernel rows whose rooflines the
benchmark reports.

Model FLOPs count the products of every matmul and convolution as 2 per
multiply-add, as ``torch.utils.flop_counter.FlopCounterMode`` counts them
over the plain reference (``perfbench/tests`` holds the two equal); the
elementwise passes, norms, softmax and selection are not counted.  Rows
are counted at their own length: a long clip's frames, not the bucket it
is padded to.  The positional conv computes one frame more than it
keeps (the published model drops it), and that frame is counted.
"""

from __future__ import annotations

import importlib
from typing import Dict, Mapping, Tuple


def frontend(enc: Mapping, samples: int) -> Tuple[float, int]:
    """(FLOPs of the conv front-end for one row, the frames it gives)."""
    flops, n, cin = 0.0, samples, 1
    for c, k, s in zip(enc["conv_dim"], enc["conv_kernel"], enc["conv_stride"]):
        n = (n - k) // s + 1
        flops += 2.0 * n * c * cin * k
        cin = c
    return flops, n


def encoder(enc: Mapping, samples: int) -> Dict[str, float]:
    """FLOPs of one row of ``samples`` through the encoder, by part, and
    its frame count ``T``."""
    fe, t = frontend(enc, samples)
    c, f = enc["hidden_size"], enc["intermediate_size"]
    k, g = enc["num_conv_pos_embeddings"], enc["num_conv_pos_embedding_groups"]
    layer = 8.0 * t * c * c + 4.0 * t * t * c + 4.0 * t * c * f
    pos_frames = t + 2 * (k // 2) - k + 1  # padding k // 2 a side
    return {"frontend": fe,
            "post_extract_proj": 2.0 * t * enc["conv_dim"][-1] * c,
            "pos_conv": 2.0 * pos_frames * c * (c // g) * k,
            "layers": enc["num_hidden_layers"] * layer,
            "T": float(t)}


def forward(cfg: Mapping, samples: int) -> float:
    """Model FLOPs of one row's scoring forward: the encoder's, and the
    head's as its family counts them
    (``perfbench/families/<family>.py::head_flops``)."""
    parts = encoder(cfg["encoder"], samples)
    t = int(parts.pop("T"))
    family = importlib.import_module(f"perfbench.families.{cfg['family']}")
    return sum(parts.values()) + family.head_flops(cfg, t)


def train_step(cfg: Mapping, samples: int) -> float:
    """Model FLOPs of one row's train step: forward and backward, 3 x the
    forward."""
    return 3.0 * forward(cfg, samples)


def sae_encode_topk(rows: int, d: int, m: int) -> Tuple[float, float]:
    """(operations, bytes) of kernel row 1 on ``rows`` frames: the [rows, d]
    x [d, m] product, its inputs (fp32 features, W_enc, both biases) read
    once and the fp32 codes written once."""
    ops = 2.0 * rows * d * m
    nbytes = 4.0 * (rows * d + d * m + m + d + rows * m)
    return ops, nbytes


def attention_long(t: int, c: int) -> Tuple[float, float]:
    """(operations, bytes) of kernel row 6 at T frames of width c: QK^T and
    PV (2 T^2 c each), bf16 q, k, v read once and the output written
    once."""
    return 4.0 * t * t * c, 2.0 * 4 * t * c
