"""Train and eval steps and wire decoding, counterpart of
``sls_tpu/train/steps.py``.

The train step (``make_train_step``) is the reference trainer's hot loop:
the wire decoded on the device, the forward with ``train=True``, loss =
weighted NLL + ``sae_weight`` * SAE MSE (+ ``cpc_weight`` * InfoNCE
with ``use_cpc``), the backward, and one Adam update with L2 added to
the gradient before the moments (torch's
``Adam(lr, weight_decay)``, not AdamW; ``make_optimizer``).  The update
is guarded on the device: when the loss is not finite, the parameters,
both moments and the step count stay bit for bit as they were
(``torch.where`` on the device, no host branch), and the metrics it
returns stay on the device too, so the step never waits for the card.

Dropout masks come from a generator seeded from (base seed, call
count).  The reference folds its *committed* step count into the key,
so a rejected step is retried with the same masks; the port counts the
host's calls (``TrainState.calls``) instead, since reading the device's
count would stall the step.  The two random streams differ anyway, and
a resumed run that restores ``calls`` draws the same masks.

Data parallelism (``make_train_step(..., mesh=...)`` with a 'data' axis
of more than one rank): the step computes the loss of the global batch,
the ranks' rows concatenated in rank order, as the reference's step on
its data mesh does.  Each rank computes its share of each loss term
(``train/loss.py``, ``sae/topk.py``, ``sae/cpc.py``), so that the shares
sum to the reference's value and their gradients sum to the global
gradient; one SUM all-reduce over the 'data' group then runs on the flat
gradient that the optimizer builds anyway, with the four loss terms
riding at its end (one collective a step, ~1.27 GB of fp32 at the
flagship).  The guard reads the all-reduced loss, so every rank commits
or rejects the step alike, and the state stays equal on every rank.
The layerdrop draws come from a generator seeded alike on every rank,
from (base seed, call), as the reference's one draw for the global
batch; dropout masks from one that also folds in the rank's data
coordinate.  ``loss``, ``cls_loss``, ``sae_loss`` and ``cpc_loss`` come
back global, ``scores`` and ``correct`` this rank's.  Under tensor
parallelism the mesh's 'model' ranks hold the same rows and compute the
same loss: the all-reduce runs over 'data' alone.  In a one-rank job
every draw and every number is what it was without a mesh.

Sequence parallelism (a ``('data', 'seq')`` mesh, ``parallel/sequence.py::
sp_mesh``, and a model built with ``sp_model_config``): the row
convention is the data-parallel step's.  Every rank is handed its data
coordinate's rows, the seq ranks of one coordinate the same rows, and
the model gets ``one_data_coordinate(mesh)``, on which the encoder cuts
frames only: the rows are cut once, by the caller.  The seq ranks share
their coordinate's dropout generator, so their masks are the ones the
data-parallel step draws for those rows (the encoder draws each at the
whole T and cuts it).  Each rank's loss terms are its shares of the
mesh's (``models/detector.py``; the NLL of the head, which every seq rank
computes whole, at 1 / n_seq), and the one all-reduce of the flat
gradient and the terms runs over every rank of the mesh.  No kernel
runs: ``sp_model_config`` turns the SAE and front-end kernels off, and
the long-T attention kernels are eval-only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

import torch.distributed as dist

from sls_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from sls_tpu_torch.device import DeviceLike, resolve_device
from sls_tpu_torch.models.detector import Detector, total_loss
from sls_tpu_torch.parallel.distributed import to_device
from sls_tpu_torch.parallel.mesh import Mesh, axis_of, one_data_coordinate
from sls_tpu_torch.train.loss import weighted_nll

_LN256 = 5.545177444479562  # log(256), mu=255 companding


def dequantize_wire(wav: torch.Tensor) -> torch.Tensor:
    """Wire format -> float32 audio (data/pipeline.to_wire).

    int16: x / 32768, exact for 16-bit sources.  uint8: mu-law decode,
    as data/mulaw.mulaw_decode.  float32 passes through."""
    if wav.dtype == torch.int16:
        return wav.float() * (1.0 / 32768.0)
    if wav.dtype == torch.uint8:
        y = wav.float() * (1.0 / 127.5) - 1.0
        return torch.sign(y) * (torch.expm1(torch.abs(y) * _LN256) * (1.0 / 255.0))
    if wav.dtype != torch.float32:
        raise TypeError(f"unknown wire dtype {wav.dtype}")
    return wav


# -- optimizer -------------------------------------------------------------------


@dataclass
class TrainState:
    """What one train step hands the next.  ``params`` are the model's own
    trainable tensors (updated in place), named by ``names``; ``exp_avg``
    and ``exp_avg_sq`` are Adam's moments as one flat fp32 buffer each
    over them, in that order; ``step`` counts committed updates on the
    device (0-d int64); ``calls`` counts the host's calls of the step,
    from which the dropout seed comes."""

    names: List[str]
    params: List[nn.Parameter]
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor
    step: torch.Tensor
    calls: int = 0

    def moments(self, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(exp_avg, exp_avg_sq) of parameter ``name``, as views."""
        start = 0
        for n, p in zip(self.names, self.params):
            if n == name:
                end = start + p.numel()
                return (self.exp_avg[start:end].view_as(p),
                        self.exp_avg_sq[start:end].view_as(p))
            start += p.numel()
        raise KeyError(f"{name!r} is not a trainable parameter")


@dataclass(frozen=True)
class AdamL2:
    """``torch.optim.Adam(lr, weight_decay)``: the decay ``wd * p`` is
    added to the gradient before the moments (the reference's
    ``add_decayed_weights`` ahead of ``scale_by_adam``), b1 0.9, b2
    0.999, eps 1e-8, bias corrections from the device's step count."""

    lr: float
    weight_decay: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    @torch.no_grad()
    def apply(self, state: TrainState, finite: torch.Tensor) -> None:
        """One update of ``state`` from its parameters' ``.grad``, which
        it consumes (a parameter without one takes a zero gradient, so it
        still decays and its moments still move, as in the reference),
        committed where the 0-d bool ``finite`` holds and else a no-op,
        bit for bit.  Works on flat buffers: a few passes over all the
        parameters, and one multi-tensor add into them."""
        self.update(state, self.flat_grad(state), finite)

    @staticmethod
    @torch.no_grad()
    def flat_grad(state: TrainState, extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The parameters' ``.grad`` (zero where there is none) as one flat
        fp32 buffer in ``state.names`` order, consumed; ``extra`` (a few
        values) rides at its end, so one collective carries both."""
        params = state.params
        parts = [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                 for p in params]
        if extra is not None:
            parts.append(extra.reshape(-1).float())
        g = torch.cat(parts)
        for p in params:
            p.grad = None
        return g

    @torch.no_grad()
    def update(self, state: TrainState, g: torch.Tensor, finite: torch.Tensor) -> None:
        """``apply`` on the flat gradient ``g`` (``flat_grad``'s, which it
        overwrites), committed where ``finite`` holds."""
        params = state.params
        if self.weight_decay:
            g.add_(torch.cat([p.reshape(-1) for p in params]), alpha=self.weight_decay)
        count = state.step + 1
        m = torch.lerp(state.exp_avg, g, 1.0 - self.b1)
        v = torch.mul(state.exp_avg_sq, self.b2).addcmul_(g, g, value=1.0 - self.b2)
        del g
        bc1 = 1.0 - torch.pow(self.b1, count.double())
        bc2 = 1.0 - torch.pow(self.b2, count.double())
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
        torch.where(finite, m, state.exp_avg, out=state.exp_avg)
        torch.where(finite, v, state.exp_avg_sq, out=state.exp_avg_sq)
        del m, v
        # p + (-lr) * 0 is p bit for bit (adding -0.0 changes no value)
        upd.masked_fill_(finite.logical_not(), 0.0)
        views = [u.view_as(p) for u, p in zip(upd.split([p.numel() for p in params]), params)]
        torch._foreach_add_(params, views, alpha=-self.lr)
        state.step = torch.where(finite, count, state.step)


def train_state_tree(model: nn.Module, state: TrainState) -> Dict:
    """What a checkpoint keeps of a training run, as device tensors: the
    model's ``state_dict`` (frozen parameters too), the trainable
    ``names``, both moments, ``step`` and ``calls``, from which the
    dropout seeds come."""
    return {"model": model.state_dict(), "names": list(state.names),
            "exp_avg": state.exp_avg, "exp_avg_sq": state.exp_avg_sq,
            "step": state.step, "calls": state.calls}


@torch.no_grad()
def restore_train_state(model: nn.Module, state: TrainState, tree: Dict) -> None:
    """Copy a ``train_state_tree`` (host or device tensors) into ``model``
    and ``state`` in place.  Raises ``ValueError`` when its trainable
    names differ from ``state``'s (a run saved without
    ``freeze_encoder`` restored with it, say): the moments would not
    line up."""
    if list(tree["names"]) != list(state.names):
        saved, here = set(tree["names"]), set(state.names)
        raise ValueError(
            f"checkpoint's trainable parameters differ from this run's: "
            f"{len(saved - here)} only in the checkpoint {sorted(saved - here)[:4]}, "
            f"{len(here - saved)} only here {sorted(here - saved)[:4]}"
            + ("" if saved != here else ", same names in another order"))
    model.load_state_dict(tree["model"], strict=True)
    state.exp_avg.copy_(tree["exp_avg"])
    state.exp_avg_sq.copy_(tree["exp_avg_sq"])
    state.step = torch.as_tensor(tree["step"], dtype=torch.int64).to(state.step.device)
    state.calls = int(tree["calls"])


def _adam_state(tree: Any) -> Optional[Dict]:
    """The ``scale_by_adam`` state (``count``, ``mu``, ``nu``) inside a
    serialised optax chain, wherever ``masked`` / ``chain`` put it."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        for value in tree.values():
            found = _adam_state(value)
            if found is not None:
                return found
    return None


def train_state_tree_from_reference(state: Dict, names: List[str]) -> Dict:
    """A ``train_state_tree`` from a JAX package checkpoint's state
    (``ckpt/checkpoint.py::load_checkpoint``: ``params`` already a state
    dict, ``opt_state`` and ``step`` as the file has them), for the
    trainable ``names`` of this run.

    The reference's optimizer is optax's ``add_decayed_weights`` ->
    ``scale_by_adam`` -> ``scale``, inside ``masked`` when the encoder is
    frozen; its moments ``mu`` / ``nu`` map through the parameters'
    naming into ``exp_avg`` / ``exp_avg_sq`` in ``names`` order (a frozen
    leaf is an empty dict there, and has no moments).  ``calls`` is set
    to ``step``: the reference seeds dropout from its step, so the
    resumed run's masks follow from where it stopped, though not the
    masks the reference would draw (ROADMAP §3)."""
    from sls_tpu_torch.convert import detector_state_from_flax

    adam = _adam_state(state["opt_state"])
    if adam is None:
        raise ValueError("the checkpoint's optimizer state holds no Adam moments")
    mu, nu = detector_state_from_flax(adam["mu"]), detector_state_from_flax(adam["nu"])
    missing = [n for n in names if n not in mu or n not in nu]
    if missing:
        raise ValueError(f"the checkpoint has no moments for {len(missing)} trainable "
                         f"parameters of this run, e.g. {missing[:4]}")
    extra = sorted(set(mu) - set(names))
    if extra:
        raise ValueError(f"the checkpoint has moments for {len(extra)} parameters this run "
                         f"does not train, e.g. {extra[:4]}")
    step = int(np.asarray(state["step"]))

    def flat(m: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([m[n].reshape(-1).float() for n in names])

    return {"model": state["params"], "names": list(names), "exp_avg": flat(mu),
            "exp_avg_sq": flat(nu), "step": torch.tensor(step, dtype=torch.int64),
            "calls": step}


def make_optimizer(lr: float, weight_decay: float) -> AdamL2:
    """Adam with L2 on the gradient (not AdamW), the reference trainer's."""
    return AdamL2(lr, weight_decay)


def trainable_names(model: nn.Module, config: ModelConfig) -> List[str]:
    """The parameters the optimizer keeps, in ``named_parameters`` order:
    all, or with ``freeze_encoder`` all but the encoder's.  They are also
    the ones that decay: a frozen parameter gets no decay and no moments
    (the reference's ``trainable_decay_mask``)."""
    return [n for n, _ in model.named_parameters()
            if not (config.freeze_encoder and n.startswith("encoder."))]


def create_train_state(model: Detector, cfg: ExperimentConfig) -> TrainState:
    """The trainable parameters, zero moments and a zero step count, on
    the parameters' device."""
    named = dict(model.named_parameters())
    names = trainable_names(model, cfg.model)
    params = [named[n] for n in names]
    dev = params[0].device
    total = sum(p.numel() for p in params)
    return TrainState(names, params,
                      exp_avg=torch.zeros(total, device=dev),
                      exp_avg_sq=torch.zeros(total, device=dev),
                      step=torch.zeros((), dtype=torch.int64, device=dev))


# -- steps -----------------------------------------------------------------------


def dropout_generator(base_seed: int, call: int, device: DeviceLike,
                      rank: Optional[int] = None) -> torch.Generator:
    """The generator of call ``call``'s dropout masks: seeded from
    (``base_seed``, ``call``) on the host, so a resumed run draws the same
    masks; with ``rank`` (a data-parallel rank's data coordinate) from
    (``base_seed``, ``call``, ``rank``)."""
    key = (base_seed, call) if rank is None else (base_seed, call, rank)
    seed = int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def step_generators(base_seed: int, call: int, device: DeviceLike, mesh: Optional[Mesh]
                    ) -> Tuple[torch.Generator, Optional[torch.Generator]]:
    """(the dropout generator, the layerdrop generator) of one call: one
    generator for both (None for the second) without a data axis, else
    the rank's own for dropout and one alike on every rank for layerdrop
    (module docstring)."""
    _, index, ranks = axis_of(mesh, "data")
    if ranks == 1:
        return dropout_generator(base_seed, call, device), None
    return (dropout_generator(base_seed, call, device, index),
            dropout_generator(base_seed, call, device))


def seq_ranks(model: nn.Module, mesh: Optional[Mesh]) -> int:
    """Ranks of ``mesh`` that share one data coordinate's rows and cut
    their frames: the size of the axis the model's ``seq_axis`` names
    (1 without one)."""
    axis = model.config.encoder.seq_axis
    return axis_of(mesh, axis)[2] if axis else 1


def _model_mesh(model: nn.Module, mesh: Optional[Mesh]) -> Optional[Mesh]:
    """What the model is handed of a step's ``mesh``: the data
    coordinate's view with a ``seq_axis`` (the rows are this
    coordinate's), else nothing (a data- or tensor-parallel step's model
    runs whole on its rows)."""
    if mesh is None or not model.config.encoder.seq_axis:
        return None
    return one_data_coordinate(mesh)


def global_terms(state: TrainState, terms: torch.Tensor, mesh: Optional[Mesh],
                 n_seq: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the flat gradient, the loss terms) summed in one all-reduce over
    the mesh's 'data' group, or with ``n_seq`` > 1 seq ranks over every
    rank of the mesh (module docstring); this rank's own when that is
    one rank.  Consumes the parameters' ``.grad``."""
    group, _, ranks = axis_of(mesh, "data")
    if n_seq > 1:
        group, ranks = mesh.group, len(mesh.ranks)
    if ranks == 1:
        return AdamL2.flat_grad(state), terms
    buf = AdamL2.flat_grad(state, terms.detach())
    dist.all_reduce(buf, group=group)
    n = buf.numel() - terms.numel()
    return buf[:n], buf[n:]


def train_loss(model: Detector, tcfg: TrainConfig, wav: torch.Tensor, labels: torch.Tensor,
               valid: torch.Tensor, generator: torch.Generator,
               class_weights: Optional[torch.Tensor] = None, data_group=None,
               layerdrop_generator: Optional[torch.Generator] = None,
               mesh: Optional[Mesh] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, cls_loss, the model's outputs) of the training forward on
    float audio ``wav``: weighted NLL at ``tcfg.loss_weights`` (or
    ``class_weights``, the same on the device) over the ``valid`` rows,
    plus ``tcfg.sae_weight`` times the SAE loss, plus with ``use_cpc``
    ``tcfg.cpc_weight`` times the CPC loss.  With ``data_group``, this
    rank's shares of them; with a ``mesh`` for the model's ``seq_axis``
    (this data coordinate's rows), its shares of the mesh's (module
    docstring)."""
    compute_cpc = model.config.use_cpc
    out = model(wav, _model_mesh(model, mesh), train=True, generator=generator,
                compute_cpc=compute_cpc, data_group=data_group,
                layerdrop_generator=layerdrop_generator)
    weights = tcfg.loss_weights if class_weights is None else class_weights
    cls = weighted_nll(out["log_probs"], labels, weights, valid,
                       group=data_group) / seq_ranks(model, mesh)
    loss = total_loss(cls, out["sae_loss"], tcfg.sae_weight, out["cpc_loss"],
                      tcfg.cpc_weight if compute_cpc else 0.0)
    return loss, cls, out


def make_train_step(model: Detector, cfg: ExperimentConfig,
                    device: DeviceLike = "cuda", mesh: Optional[Mesh] = None) -> Callable:
    """step(state, wav [B, S] on the wire, labels [B], valid [B],
    base_seed) -> (state, metrics).  One forward with ``train=True``,
    backward and guarded Adam update (module docstring); ``state`` is
    updated in place and returned.  ``metrics`` holds loss, cls_loss,
    sae_loss, cpc_loss (0 without ``use_cpc``), scores [B], correct (the
    valid rows the argmax gets right) and finite, all on the device.  Inputs already on
    the device are used as they are.  ``mesh`` (every rank of its 'data'
    axis calls the step with its own rows, all the same number) makes it
    the global batch's step, and with a 'seq' axis for the model's
    ``seq_axis`` a sequence-parallel one, the seq ranks of a data
    coordinate handed its rows (module docstring); None is one rank's."""
    dev = resolve_device(device)
    tcfg = cfg.train
    opt = make_optimizer(tcfg.lr, tcfg.weight_decay)
    class_weights = torch.tensor(tcfg.loss_weights, dtype=torch.float32, device=dev)
    data_group = axis_of(mesh, "data")[0]
    n_seq = seq_ranks(model, mesh)

    def step(state: TrainState, wav, labels, valid, base_seed: int):
        w = dequantize_wire(to_device(wav, dev))
        y, ok = to_device(labels, dev).long(), to_device(valid, dev).float()
        gen, ld_gen = step_generators(base_seed, state.calls, dev, mesh)
        state.calls += 1
        model.zero_grad(set_to_none=True)
        loss, cls, out = train_loss(model, tcfg, w, y, ok, gen, class_weights, data_group,
                                    ld_gen, mesh)
        loss.backward()
        g, terms = global_terms(state, torch.stack(
            [loss, cls, out["sae_loss"], out["cpc_loss"]]).detach(), mesh, n_seq)
        finite = torch.isfinite(terms[0])
        opt.update(state, g, finite)
        metrics = {
            "loss": terms[0],
            "cls_loss": terms[1],
            "sae_loss": terms[2],
            "cpc_loss": terms[3],
            "scores": out["score"].detach(),
            "correct": ((out["log_probs"].detach().argmax(-1) == y) * ok).sum(),
            "finite": finite,
        }
        return state, metrics

    return step


def make_eval_step(model: Detector, device: DeviceLike = "cuda",
                   mesh: Optional[Mesh] = None) -> Callable:
    """(wav [B, S] on the wire, numpy or tensor) -> dict of tensors on
    ``device``: score [B], log_probs [B, 2], sae_loss [], and
    sae_loss_per_example [B] when the model has an SAE.  Runs under
    ``torch.inference_mode``; results are left on the device, so the
    caller decides when to wait for them.  With ``mesh`` and a model
    built with ``sp_model_config`` it runs sequence-parallel, each rank
    handed its data coordinate's rows as the train step is, and returns
    every one of those rows' results on every seq rank."""
    dev = resolve_device(device)
    view = _model_mesh(model, mesh)

    def step(wav) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            w = wav if torch.is_tensor(wav) else torch.from_numpy(np.ascontiguousarray(wav))
            w = dequantize_wire(w.to(dev))
            out = model(w, view)
            res = {
                "score": out["score"],
                "log_probs": out["log_probs"],
                "sae_loss": out["sae_loss"],
            }
            if "recon" in out:
                # per-example MSE, so padded tail rows can be masked exactly
                sq = torch.square(out["recon"] - out["features"])
                shard = model.encoder.shard_for(w, view)
                if shard is None:
                    res["sae_loss_per_example"] = torch.mean(sq, dim=(1, 2))
                else:  # the features may be this rank's frames
                    sq = sq.sum(dim=(1, 2))
                    if model.sae.row_parallel:
                        sq = shard.sum_frames(sq)
                    res["sae_loss_per_example"] = sq / (shard.frames
                                                        * out["features"].shape[-1])
        return res

    return step
