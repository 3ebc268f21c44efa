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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sls_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from sls_tpu_torch.device import DeviceLike, resolve_device
from sls_tpu_torch.models.detector import Detector, total_loss
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


def to_device(x, dev: torch.device) -> torch.Tensor:
    """``x`` (numpy or tensor) on ``dev``, without waiting for the device:
    a host array bound for a card goes up from pinned memory (a pageable
    copy would wait)."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    if dev.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


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
        params = state.params
        g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                       for p in params])
        for p in params:
            p.grad = None
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


def dropout_generator(base_seed: int, call: int, device: DeviceLike) -> torch.Generator:
    """The generator of call ``call``'s dropout masks: seeded from
    (``base_seed``, ``call``) on the host, so a resumed run draws the same
    masks."""
    seed = int(np.random.SeedSequence((base_seed, call)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def train_loss(model: Detector, tcfg: TrainConfig, wav: torch.Tensor, labels: torch.Tensor,
               valid: torch.Tensor, generator: torch.Generator,
               class_weights: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, cls_loss, the model's outputs) of the training forward on
    float audio ``wav``: weighted NLL at ``tcfg.loss_weights`` (or
    ``class_weights``, the same on the device) over the ``valid`` rows,
    plus ``tcfg.sae_weight`` times the SAE loss, plus with ``use_cpc``
    ``tcfg.cpc_weight`` times the CPC loss."""
    compute_cpc = model.config.use_cpc
    out = model(wav, train=True, generator=generator, compute_cpc=compute_cpc)
    weights = tcfg.loss_weights if class_weights is None else class_weights
    cls = weighted_nll(out["log_probs"], labels, weights, valid)
    loss = total_loss(cls, out["sae_loss"], tcfg.sae_weight, out["cpc_loss"],
                      tcfg.cpc_weight if compute_cpc else 0.0)
    return loss, cls, out


def make_train_step(model: Detector, cfg: ExperimentConfig,
                    device: DeviceLike = "cuda") -> Callable:
    """step(state, wav [B, S] on the wire, labels [B], valid [B],
    base_seed) -> (state, metrics).  One forward with ``train=True``,
    backward and guarded Adam update (module docstring); ``state`` is
    updated in place and returned.  ``metrics`` holds loss, cls_loss,
    sae_loss, cpc_loss (0 without ``use_cpc``), scores [B], correct (the
    valid rows the argmax gets right) and finite, all on the device.  Inputs already on
    the device are used as they are."""
    dev = resolve_device(device)
    tcfg = cfg.train
    opt = make_optimizer(tcfg.lr, tcfg.weight_decay)
    class_weights = torch.tensor(tcfg.loss_weights, dtype=torch.float32, device=dev)

    def step(state: TrainState, wav, labels, valid, base_seed: int):
        w = dequantize_wire(to_device(wav, dev))
        y, ok = to_device(labels, dev).long(), to_device(valid, dev).float()
        gen = dropout_generator(base_seed, state.calls, dev)
        state.calls += 1
        model.zero_grad(set_to_none=True)
        loss, cls, out = train_loss(model, tcfg, w, y, ok, gen, class_weights)
        loss.backward()
        finite = torch.isfinite(loss)
        opt.apply(state, finite)
        metrics = {
            "loss": loss.detach(),
            "cls_loss": cls.detach(),
            "sae_loss": out["sae_loss"].detach(),
            "cpc_loss": out["cpc_loss"].detach(),
            "scores": out["score"].detach(),
            "correct": ((out["log_probs"].detach().argmax(-1) == y) * ok).sum(),
            "finite": finite,
        }
        return state, metrics

    return step


def make_eval_step(model: Detector, device: DeviceLike = "cuda") -> Callable:
    """(wav [B, S] on the wire, numpy or tensor) -> dict of tensors on
    ``device``: score [B], log_probs [B, 2], sae_loss [], and
    sae_loss_per_example [B] when the model has an SAE.  Runs under
    ``torch.inference_mode``; results are left on the device, so the
    caller decides when to wait for them."""
    dev = resolve_device(device)

    def step(wav) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            w = wav if torch.is_tensor(wav) else torch.from_numpy(np.ascontiguousarray(wav))
            out = model(dequantize_wire(w.to(dev)))
            res = {
                "score": out["score"],
                "log_probs": out["log_probs"],
                "sae_loss": out["sae_loss"],
            }
            if "recon" in out:
                # per-example MSE, so padded tail rows can be masked exactly
                diff = out["recon"] - out["features"]
                res["sae_loss_per_example"] = torch.mean(torch.square(diff), dim=(1, 2))
        return res

    return step
