"""XLS-R (wav2vec2) encoder, counterpart of ``sls_tpu/encoder/xlsr.py``.

The reference's numerics: matmuls and convs in
``config.dtype`` (bf16 at the flagship) with fp32 LayerNorm and softmax
islands; LayerNorm in flax's fast-variance form; GELU computed in fp32
and cast back, tanh-approximate iff the dtype is bf16.  Public modules
take and return ``[B, T, C]``; convs run channels-first internally.

Attention routes as the reference's eval path does: at T >=
``flash_long_t`` with T % 256 == 0 through ``flash_attention_long``,
else with ``fused_attention`` set through ``fused_attention`` (both the
hand-written kernel of ``kernels/attention.py``), else the plain einsum
path.  With ``seq_axis`` set the layer stack runs sequence-parallel
(below) and attention goes through ``sp_flash_attention_long`` or the
einsum path against gathered keys and values.  With ``fused_frontend``
set, the conv front-end after conv 0 runs through
``frontend_tail_fused`` (``kernels/frontend.py``) wherever the
reference's gate holds.  ``int8_serving`` runs fc1/fc2 (and with
``int8_scope="all"`` the attention projections) through ``int8_dot``.
``grouped_conv_einsum`` computes the pos-conv as per-tap block-diagonal
einsums on the conv's own weight.

Training (``forward(..., train=True, generator=g)``) takes the routes
the reference's ``train=True`` takes: the kernel routes (both attention
kernels, the fused front-end) and int8 are eval-only there, so under
``train`` the encoder runs the einsum attention, the unfused front-end
and ``F.linear`` whatever the config sets, and autograd differentiates
it.  Dropout goes where the reference applies it (attention
probabilities, after the FFN's activation, the FFN's and attention's
outputs, after ``post_extract_proj`` and after the pos-conv), each mask
drawn from ``g`` by ``dropout``; layerdrop computes the layer and
selects (``torch.where``), so a dropped layer's parameters still get a
(zero) gradient; ``remat`` checkpoints each layer
(``torch.utils.checkpoint``), whose replay redraws the same masks from
the layer's starting generator state.  The layerdrop draws come from
``layerdrop_generator`` when one is given (default ``g`` itself, which
one rank uses for both): a data-parallel step hands every rank one
generator seeded alike for them, so all ranks drop the same layers, as
the reference's one draw for the global batch does, and a generator of
the rank's own for the masks, so ranks do not repeat one mask over
different rows.

Tensor parallelism (``parallel/tensor.py``): a layer whose ``fc1`` /
``fc2`` were cut over the mesh's 'model' axis (``tp`` set) runs its FFN
column- then row-parallel, its activation dropout drawn at the whole
width and cut; the rest of the layer runs whole on every rank.

Sequence parallelism (``seq_axis``).  The reference pins the frame axis
of the layer stack's activations to a mesh axis and lets the compiler
derive the program; here the program is written out.  ``forward`` takes
the batch's cut on the ``Mesh`` as an argument (``shard_for(wav, mesh)``,
built once by the caller): the conv front-end, projection and pos-conv
run on the whole clip on every rank, then each rank keeps its chunk of
frames (``parallel/mesh.py::SeqShard``; and its rows, where the mesh's
data axis divides the batch) through the layers and the final norm,
which are row-parallel in T except for attention's keys and values.  The
encoder then returns this rank's ``[B_loc, T_loc, C]``.  With
``seq_axis`` set and no mesh given (``shard_for``), or no shard, it raises.

It trains that way too (``train`` with a shard), on the training routes
above: attention is the einsum path on this rank's q strip against the
keys and values gathered over 'seq' (differentiably: ``SeqShard``), never
the long-T kernels, which are eval-only as in the reference.  Each rank
draws every mask after the cut at the whole T and keeps its frames
(``dropout(..., shard)``; attention probabilities at ``[b, H, T, T]``,
cut by q row), so its masks are the ones the same call draws without a
shard on the same rows, and the generator moves on alike on every seq
rank; layerdrop draws one scalar a layer, alike too.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sls_tpu_torch.config import XLSRConfig
from sls_tpu_torch.kernels.attention import (
    flash_attention_long,
    fused_attention,
    sp_block_q,
    sp_flash_attention_long,
)
from sls_tpu_torch.kernels.frontend import (
    choose_tile,
    fp32_layer_norm,
    frontend_tail_fused,
    tail_lengths,
)
from sls_tpu_torch.parallel.mesh import Mesh, SeqShard
from sls_tpu_torch.parallel.tensor import column_linear, cut_dropout, row_linear
from sls_tpu_torch.quant.int8 import int8_dot


def _fp32_group_norm_per_channel(x, scale, bias, eps=1e-5):
    """fairseq Fp32GroupNorm with num_groups == num_channels on [B, T, C]:
    per-(batch, channel) norm over time, fast-variance form."""
    xf = x.float()
    mean = xf.mean(1, keepdim=True)
    mean2 = (xf * xf).mean(1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return ((xf - mean) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def gelu_fp32(h: torch.Tensor, approximate: bool, dtype: torch.dtype) -> torch.Tensor:
    return F.gelu(h.float(), approximate="tanh" if approximate else "none").to(dtype)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator],
            shard: Optional[SeqShard] = None, dim: int = 1) -> torch.Tensor:
    """flax ``nn.Dropout``: each entry kept with probability 1 - p and
    scaled by 1 / (1 - p), else zero; the mask drawn from ``generator``
    (``F.dropout`` takes none).  The identity when ``generator`` is None
    (eval) or p is 0.  With ``shard``, axis ``dim`` of ``x`` holds this
    rank's frames: the mask is drawn at all T and cut to them."""
    if generator is None or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if shard is not None:
        shape[dim] = shard.frames
    keep = torch.rand(shape, generator=generator, device=x.device) >= p
    if shard is not None:
        keep = shard.take_frames(keep, dim)
    return torch.where(keep, x / (1.0 - p), 0.0)


class Fp32LayerNorm(nn.Module):
    """LayerNorm computed in fp32 regardless of the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fp32_layer_norm(x.float(), self.weight, self.bias, self.eps).to(x.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=...)``: input, weight and bias cast to
    ``dtype``; parameters stay fp32.  weight is [out, in].  With
    ``int8`` the reference's ``QuantizableDense``: at eval the product
    through ``int8_dot``, then the bias in ``dtype``; under ``train``
    ``F.linear`` (the parameters are the same)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 device=None, int8: bool = False):
        super().__init__()
        self.dtype, self.int8 = dtype, int8
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        if self.int8 and not train:
            return int8_dot(x, self.weight.t(), dt) + self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv1d(nn.Module):
    """flax ``nn.Conv(dtype=...)`` on channels-first input: operands cast
    to ``dtype``.  weight is [out, in / groups, kernel]."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, *, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.stride, self.padding, self.groups, self.dtype = stride, padding, groups, dtype
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv1d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, 1, self.groups)


class ConvFeatureExtractor(nn.Module):
    """Strided 1-D conv waveform front-end: [B, samples] -> [B, T, C].

    'layer_norm' mode (XLS-R) normalises after every conv; 'default'
    group-norms only the first layer.  Conv 0 runs on cuDNN on both
    routes; the rest runs unfused (``tail``) or, with ``fused_frontend``
    where ``_fused_ok`` holds, through ``frontend_tail_fused``, which at
    bf16 is a different function (fp32 conv sums reach the norm
    unrounded)."""

    def __init__(self, config: XLSRConfig, device=None):
        super().__init__()
        cfg = self.config = config
        if cfg.extractor_mode not in ("layer_norm", "default"):
            raise ValueError(f"unknown extractor_mode {cfg.extractor_mode!r}")
        self.conv = nn.ModuleList()
        self.norm = nn.ModuleList()
        in_ch = 1
        for i, (dim, kernel, stride) in enumerate(cfg.conv_layers):
            self.conv.append(Conv1d(in_ch, dim, kernel, stride=stride,
                                    bias=cfg.conv_bias, dtype=cfg.dtype, device=device))
            if cfg.extractor_mode == "layer_norm" or i == 0:
                self.norm.append(Fp32LayerNorm(dim, device=device))
            in_ch = dim

    def level0(self, wav: torch.Tensor) -> torch.Tensor:
        """Conv 0's output of ``wav`` [B, samples] as the [B, T, C] view
        both routes take."""
        h = wav[:, :, None].to(self.config.dtype)  # [B, samples, 1]
        return self.conv[0](h.transpose(1, 2)).transpose(1, 2)

    def forward(self, wav: torch.Tensor, train: bool = False) -> torch.Tensor:
        # [B, T, C] views over the convs' storage between layers
        h = self.level0(wav)
        if self._fused_ok(wav.shape[1], train):
            args, kwargs = self.tail_fused_args()
            return frontend_tail_fused(h, *args, **kwargs)
        return self.tail(h)

    def tail(self, h: torch.Tensor) -> torch.Tensor:
        """The unfused route from conv 0's output: norm and GELU of level
        0, then conv, norm and GELU per layer."""
        cfg = self.config
        for i, conv in enumerate(self.conv):
            if i:
                h = conv(h.transpose(1, 2)).transpose(1, 2)
            if cfg.extractor_mode == "layer_norm":
                h = self.norm[i](h)
            elif i == 0:
                h = _fp32_group_norm_per_channel(h, self.norm[0].weight, self.norm[0].bias)
            h = gelu_fp32(h, cfg.use_approx_gelu, cfg.dtype)
        return h

    def tail_fused_args(self):
        """``frontend_tail_fused``'s arguments after ``h0``: the tail's WIO
        weights, and the biases and norm affines stacked as the reference
        stacks them."""
        cfg = self.config
        tail = self.conv[1:]
        if cfg.conv_bias:
            bias_stack = torch.stack([conv.bias for conv in tail])
        else:
            bias_stack = torch.zeros(len(tail), tail[0].weight.shape[0],
                                     device=tail[0].weight.device)
        args = (tuple(conv.weight.permute(2, 1, 0) for conv in tail),  # [k, in, out]
                bias_stack,
                torch.stack([norm.weight for norm in self.norm]),
                torch.stack([norm.bias for norm in self.norm]))
        return args, dict(specs=tuple((k, s) for _, k, s in cfg.conv_layers[1:]),
                          approx_gelu=cfg.use_approx_gelu, out_dtype=cfg.dtype)

    def _fused_ok(self, num_samples: int, train: bool = False) -> bool:
        """The reference's gate (a shape decision, not a fallback): the
        flag, eval (the kernel has no backward), 'layer_norm' mode, equal
        widths, at least two layers, and a feasible tiling."""
        cfg = self.config
        if not cfg.fused_frontend or train or cfg.extractor_mode != "layer_norm":
            return False
        dims = [d for d, _, _ in cfg.conv_layers]
        if len(set(dims)) != 1 or len(cfg.conv_layers) < 2:
            return False
        specs = tuple((k, s) for _, k, s in cfg.conv_layers[1:])
        d0, k0, s0 = cfg.conv_layers[0]
        n0 = (num_samples - k0) // s0 + 1
        t_out = tail_lengths(n0, specs)[-1]
        return choose_tile(t_out, n0, specs, d0, itemsize=cfg.dtype.itemsize) is not None


class PositionalConv(nn.Module):
    """Grouped conv positional embedding: kernel conv_pos, groups
    conv_pos_groups, padding conv_pos // 2 on each side with the last
    frame dropped for an even kernel (fairseq SamePad), then GELU."""

    def __init__(self, config: XLSRConfig, device=None):
        super().__init__()
        cfg = self.config = config
        self.conv = Conv1d(cfg.embed_dim, cfg.embed_dim, cfg.conv_pos,
                           padding=cfg.conv_pos // 2, groups=cfg.conv_pos_groups,
                           dtype=cfg.dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.grouped_conv_einsum:
            h = self._einsum_grouped(x)
        else:
            h = self.conv(x.transpose(1, 2)).transpose(1, 2)
            if cfg.conv_pos % 2 == 0:
                h = h[:, :-1, :]
        return gelu_fp32(h, cfg.use_approx_gelu, cfg.dtype)

    def _einsum_grouped(self, x: torch.Tensor) -> torch.Tensor:
        """The grouped conv as one block-diagonal einsum per tap, summed
        in ``dtype`` tap by tap as the reference's scan sums them: the
        same function on the same parameter (the conv's [C, C/G, K]
        weight read as [K, G, C/G in, C/G out]).  The reference takes it
        under tensor-parallel meshes, where its compiler mis-scales
        grouped-conv weight gradients; here it is a single-device
        function until tensor parallelism is ported."""
        cfg = self.config
        K, G, C = cfg.conv_pos, cfg.conv_pos_groups, cfg.embed_dim
        cg = C // G
        dt = cfg.dtype
        B, T = x.shape[0], x.shape[1]
        xp = F.pad(x.to(dt), (0, 0, K // 2, K - 1 - K // 2))
        # weight[g * cg + o, c, k] -> wg[k, g, c, o]
        wg = self.conv.weight.to(dt).reshape(G, cg, cg, K).permute(3, 0, 2, 1)
        acc = torch.zeros(B, T, G, cg, dtype=dt, device=x.device)
        for k in range(K):
            xs = xp[:, k:k + T].reshape(B, T, G, cg)
            acc = acc + torch.einsum("btgc,gco->btgo", xs, wg[k])
        return acc.reshape(B, T, C) + self.conv.bias.to(dt)


class SelfAttention(nn.Module):
    """Multi-head self-attention with an fp32 softmax: the attention
    kernel on the long-T and ``fused_attention`` routes at eval, else
    matmuls (the reference's einsum path; no library attention kernel),
    with dropout on the probabilities under ``train``."""

    def __init__(self, config: XLSRConfig, device=None):
        super().__init__()
        self.config = config
        C, dt = config.embed_dim, config.dtype
        int8 = config.int8_serving and config.int8_scope == "all"
        self.q_proj = Dense(C, C, dt, device, int8)
        self.k_proj = Dense(C, C, dt, device, int8)
        self.v_proj = Dense(C, C, dt, device, int8)
        self.out_proj = Dense(C, C, dt, device, int8)

    def forward(self, x: torch.Tensor, shard: Optional[SeqShard] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, T, C], or with ``shard`` this rank's frames of it, whose
        queries then meet every frame's keys and values."""
        cfg = self.config
        B, T, C = x.shape
        H, D = cfg.num_heads, cfg.head_dim
        q, k, v = self.q_proj(x, train), self.k_proj(x, train), self.v_proj(x, train)  # [B, T, C]
        q = q * (D ** -0.5)
        # The kernel routes are eval-only, as the reference's
        # ``deterministic`` gate makes them: the kernel has no backward.
        if shard is not None:
            # The reference's gate, which depends on shapes and the mesh
            # only, so every rank takes the same route: at eval the long-T
            # kernel where the frames divide evenly into strips with a
            # q-block of 128 rows or more and the data axis divides the
            # batch, else the einsum path below against gathered k and v.
            # ``fused_attention`` is off under ``seq_axis``.
            if (not train and cfg.flash_long_t and shard.frames >= cfg.flash_long_t
                    and shard.even and sp_block_q(shard.frames // shard.n_seq)
                    and shard.rows_divide):
                return self.out_proj(sp_flash_attention_long(q, k, v, H, shard.seq_group))
            k, v = shard.gather_frames(torch.stack([k, v]), dim=2).unbind(0)
        elif not train and cfg.flash_long_t and T >= cfg.flash_long_t and T % 256 == 0:
            # long-T eval (unwindowed full utterances): the [B, H, T, T]
            # scores never reach device memory
            return self.out_proj(flash_attention_long(q, k, v, H))
        q = q.reshape(B, T, H, D)
        k, v = k.reshape(B, -1, H, D), v.reshape(B, -1, H, D)
        if cfg.fused_attention and shard is None and not train:
            return self.out_proj(fused_attention(q, k, v).reshape(B, T, C))
        scores = torch.einsum("bthd,bshd->bhts", q, k)
        probs = torch.softmax(scores.float(), dim=-1).to(cfg.dtype)
        probs = dropout(probs, cfg.attention_dropout, generator, shard, dim=2)
        ctx = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, C)
        return self.out_proj(ctx, train)


class TransformerLayer(nn.Module):
    """Pre-LN (XLS-R) or post-LN transformer block; with ``generator``
    (``train``) dropout after the FFN's activation and on the attention's
    and the FFN's outputs.  ``tp`` is set when ``fc1`` / ``fc2`` are cut
    over the mesh's 'model' axis (``parallel/tensor.py``)."""

    tp = None

    def __init__(self, config: XLSRConfig, device=None):
        super().__init__()
        cfg = self.config = config
        if cfg.activation not in ("gelu", "relu"):
            raise ValueError(f"unknown activation {cfg.activation!r}")
        self.self_attn = SelfAttention(cfg, device)
        self.self_attn_layer_norm = Fp32LayerNorm(cfg.embed_dim, device=device)
        self.final_layer_norm = Fp32LayerNorm(cfg.embed_dim, device=device)
        self.fc1 = Dense(cfg.embed_dim, cfg.ffn_dim, cfg.dtype, device, cfg.int8_serving)
        self.fc2 = Dense(cfg.ffn_dim, cfg.embed_dim, cfg.dtype, device, cfg.int8_serving)

    def _ffn(self, h: torch.Tensor, train: bool, gen: Optional[torch.Generator],
             shard: Optional[SeqShard] = None) -> torch.Tensor:
        cfg, tp = self.config, self.tp
        h = self.fc1(h, train) if tp is None else column_linear(self.fc1, h, tp)
        if cfg.activation == "gelu":
            h = gelu_fp32(h, cfg.use_approx_gelu, cfg.dtype)
        else:
            h = torch.relu(h.float()).to(cfg.dtype)
        if tp is None:
            h = dropout(h, cfg.activation_dropout, gen, shard)
            return dropout(self.fc2(h, train), cfg.dropout, gen, shard)
        h = cut_dropout(h, cfg.activation_dropout, gen, tp)
        return dropout(row_linear(self.fc2, h, tp), cfg.dropout, gen)

    def forward(self, x: torch.Tensor, shard: Optional[SeqShard] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg, gen = self.config, generator

        def attn(h):
            return dropout(self.self_attn(h, shard, train, gen), cfg.dropout, gen, shard)

        if cfg.layer_norm_first:
            x = x + attn(self.self_attn_layer_norm(x))
            return x + self._ffn(self.final_layer_norm(x), train, gen, shard)
        x = self.self_attn_layer_norm(x + attn(x))
        return self.final_layer_norm(x + self._ffn(x, train, gen, shard))


class XLSREncoder(nn.Module):
    """waveform [B, samples] -> [B, T, embed_dim]: conv features, fp32
    LayerNorm, projection, positional conv, transformer layers, final
    LayerNorm (pre-LN mode).  ``return_hidden_states=True`` also returns
    every layer's output (before the final LayerNorm).  With
    ``config.seq_axis`` the outputs are this rank's rows and frames on
    ``mesh`` (the module docstring)."""

    def __init__(self, config: XLSRConfig, device=None):
        super().__init__()
        cfg = self.config = config
        c0 = cfg.conv_layers[-1][0]
        self.feature_extractor = ConvFeatureExtractor(cfg, device)
        self.post_extract_norm = Fp32LayerNorm(c0, device=device)
        self.post_extract_proj = Dense(c0, cfg.embed_dim, cfg.dtype, device)
        self.pos_conv = PositionalConv(cfg, device)
        self.layers = nn.ModuleList(
            TransformerLayer(cfg, device) for _ in range(cfg.encoder_layers))
        self.encoder_layer_norm = Fp32LayerNorm(cfg.embed_dim, device=device)

    def shard_for(self, wav: torch.Tensor, mesh: Optional[Mesh]) -> Optional[SeqShard]:
        """The ``shard`` that ``forward`` takes for this batch on ``mesh``:
        None without ``seq_axis``.  A mesh and ``seq_axis`` come together
        or not at all: the reference's bare sharding annotation does not
        resolve without an ambient mesh either."""
        cfg = self.config
        if not cfg.seq_axis:
            if mesh is not None:
                raise ValueError(
                    f"model seq_axis={cfg.seq_axis!r} is not an axis of mesh "
                    f"{mesh.axis_names}; build the config with sp_model_config()")
            return None
        if mesh is None:
            raise ValueError(
                f"XLSRConfig.seq_axis={cfg.seq_axis!r} needs the mesh: pass mesh= to "
                "the Detector (parallel/sequence.py::sp_scoring_fn does)")
        return SeqShard(mesh, cfg.seq_axis, wav.shape[0], cfg.num_frames(wav.shape[1]))

    def forward(self, wav: torch.Tensor, return_hidden_states: bool = False,
                shard: Optional[SeqShard] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                layerdrop_generator: Optional[torch.Generator] = None):
        """``shard`` is ``shard_for(wav, mesh)``, which the caller builds
        once and also needs for what follows the encoder.  ``train`` takes
        the training routes, with every dropout mask from ``generator``
        (required then, on the encoder's device) and every layerdrop draw
        from ``layerdrop_generator`` (default ``generator``)."""
        cfg = self.config
        if train and generator is None:
            raise ValueError("train=True needs a generator for dropout and layerdrop")
        gen = generator if train else None
        ld_gen = layerdrop_generator if layerdrop_generator is not None else gen
        if (shard is None) != (not cfg.seq_axis):
            raise ValueError(f"XLSRConfig.seq_axis={cfg.seq_axis!r} and shard={shard!r} do "
                             "not go together: pass shard=shard_for(wav, mesh)")
        if shard is not None:
            wav = shard.take_rows(wav)
        feats = self.post_extract_norm(self.feature_extractor(wav, train))
        x = dropout(self.post_extract_proj(feats), cfg.dropout, gen)
        x = x + self.pos_conv(x)
        if not cfg.layer_norm_first:
            x = self.encoder_layer_norm(x)
        x = dropout(x, cfg.dropout, gen)
        if shard is not None:
            # sequence parallelism starts here: the O(T) front-end above
            # ran on the whole clip; the O(T^2) layer stack runs on this
            # rank's frames
            x = shard.take_frames(x)
        hidden_states: List[torch.Tensor] = []
        for layer in self.layers:
            x = (layer(x, shard) if gen is None
                 else self._train_layer(layer, x, shard, gen, ld_gen))
            if return_hidden_states:
                hidden_states.append(x)
        if cfg.layer_norm_first:
            x = self.encoder_layer_norm(x)
        if return_hidden_states:
            return x, hidden_states
        return x

    def _train_layer(self, layer: TransformerLayer, x: torch.Tensor,
                     shard: Optional[SeqShard], gen: torch.Generator,
                     ld_gen: torch.Generator) -> torch.Tensor:
        """One layer under ``train``: layerdrop as compute-and-select (its
        draw from ``ld_gen``, which may be ``gen``), and with ``remat`` the
        layer checkpointed.  The checkpointed function draws its masks
        from a generator set to ``gen``'s state at the layer's start, so
        the backward's replay draws the same masks; then ``gen`` moves on
        to where the layer left it, as without ``remat``.  The layerdrop
        draw is made before, outside the replayed function, so both
        generators replay as they ran.  The global generators are not
        used, so their state is not kept."""
        cfg = self.config
        keep = None
        if cfg.layerdrop > 0.0:
            keep = torch.rand((), generator=ld_gen, device=x.device) >= cfg.layerdrop
        if cfg.remat and torch.is_grad_enabled():
            start, end = gen.get_state(), []

            def run(h):
                g = torch.Generator(device=h.device)
                g.set_state(start)
                out = layer(h, shard, train=True, generator=g)
                end[:] = [g.get_state()]
                return out

            y = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
            gen.set_state(end[0])
        else:
            y = layer(x, shard, train=True, generator=gen)
        return y if keep is None else torch.where(keep, y, x)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Seeded random init in the reference's scheme: lecun-scaled normal
    weights (std 1/sqrt(fan_in)), zero biases, unit LayerNorm scales."""
    for mod in module.modules():
        if isinstance(mod, (Dense, Conv1d)):
            fan_in = mod.weight[0].numel()
            mod.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, Fp32LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
