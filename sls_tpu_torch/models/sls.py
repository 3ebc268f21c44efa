"""XLS-R + SLS detector, counterpart of ``sls_tpu/models/sls.py``: the
upstream model behind the published EERs, an XLS-R encoder whose every
layer output feeds the SLS head (``heads/sls.py``).

- ``SLSDetector``: the encoder run once with its per-layer outputs
  (``freeze_encoder`` runs it under ``torch.no_grad``, which detaches
  the final output and every layer's), then the head.  fc1's width is
  fixed by the clip: the model is built for ``cut_length`` samples.
- ``make_sls_train_step`` / ``make_sls_eval_step``: the steps of
  ``train/steps.py`` (the wire decoded on the device, dropout from
  (base seed, call), Adam with L2 and the on-device guard) with the
  BatchNorm's running statistics: the train step commits their update
  only when the loss is finite, so a rejected step leaves the
  parameters, both moments, ``step`` and the running statistics bit for
  bit as they were.
- ``layer_gate_profile``: which layers the head weighs most.
- ``SLSTrainer``: the epoch loop of ``train/loop.py::BaseTrainer`` on
  these steps, in one process or across the ranks of a job (data
  parallel: the BatchNorm's statistics are the global batch's,
  ``heads/sls.py``); checkpoints carry the running statistics (they are
  buffers of the model's ``state_dict``).  ``model_parallel > 1``
  raises, as the reference's does.  ``resume`` takes this
  package's checkpoints, a JAX ``SLSTrainer`` run directory and, weights
  only, an upstream ``.pth``.

Two differences from the reference, both deliberate:
- the reference's SLS steps feed the wire to the encoder as it comes (an
  int16 batch reaches it as raw integers); these steps dequantise it, as
  every step of this package does (ROADMAP §3);
- the reference's SLS step reports no ``cls_loss`` / ``sae_loss`` /
  ``cpc_loss`` and its trainer folds them as 0; this step reports zeros
  for them, so both packages write the same CSV row.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sls_tpu_torch.config import ExperimentConfig, ModelConfig
from sls_tpu_torch.convert import sls_detector_state_from_reference
from sls_tpu_torch.device import DeviceLike, resolve_device
from sls_tpu_torch.encoder.xlsr import XLSREncoder, init_weights_
from sls_tpu_torch.heads.sls import SLSHead
from sls_tpu_torch.parallel.mesh import Mesh, axis_of
from sls_tpu_torch.train.loop import BaseTrainer
from sls_tpu_torch.train.loss import weighted_nll
from sls_tpu_torch.train.steps import (
    TrainState,
    create_train_state,
    dequantize_wire,
    global_terms,
    make_optimizer,
    restore_train_state,
    step_generators,
    to_device,
    train_state_tree,
)


class SLSDetector(nn.Module):
    """The detector for clips of ``cut_length`` samples.  Parameters are
    fp32 on ``device`` and drawn from ``generator`` (default: seed 0 on
    that device); on the ``meta`` device they are left uninitialised."""

    def __init__(self, config: ModelConfig, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None, cut_length: int = 64600):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        enc = config.encoder
        self.encoder = XLSREncoder(enc, device=dev)
        self.sls_head = SLSHead(enc.embed_dim, enc.num_frames(cut_length), dtype=enc.dtype,
                                device=dev)
        if dev.type != "meta":
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            init_weights_(self.encoder, generator)
            init_weights_(self.sls_head, generator)

    def _encode(self, wav: torch.Tensor, train: bool, generator: Optional[torch.Generator],
                layerdrop_generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        with torch.no_grad() if self.config.freeze_encoder else nullcontext():
            return self.encoder(wav, return_hidden_states=True, train=train,
                                generator=generator, layerdrop_generator=layerdrop_generator)

    def forward(self, wav: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None, data_group=None,
                layerdrop_generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """``train`` takes the encoder's training routes with dropout from
        ``generator`` (required then) and layerdrop from
        ``layerdrop_generator`` (default ``generator``), and normalises
        with the batch's statistics (with ``data_group``, the global
        batch's).  Returns a dict with:

        log_probs  [B, 2]      log-softmax outputs (class 1 = bonafide)
        score      [B]         P(bonafide) = exp(log_probs[:, 1])
        features   [B, T, C]   the encoder's final output, fp32
        bn_stats   ([1], [1])  the batch's mean and biased variance (train only)
        """
        if train and generator is None:
            raise ValueError("train=True needs a generator for dropout")
        final, hiddens = self._encode(wav, train, generator, layerdrop_generator)
        log_probs, stats = self.sls_head(hiddens, train, data_group)
        out = {"log_probs": log_probs, "score": torch.exp(log_probs[:, 1]),
               "features": final.float()}
        if stats is not None:
            out["bn_stats"] = stats
        return out

    def score(self, wav: torch.Tensor) -> torch.Tensor:
        """log_probs [B, 2] of float audio (the serving path)."""
        _, hiddens = self._encode(wav, False, None)
        return self.sls_head(hiddens)[0]


# the trainable parameters (all, or with ``freeze_encoder`` the head's),
# zero moments and a zero step count; the running statistics are buffers
# of the model, outside the optimizer
create_sls_train_state = create_train_state


def make_sls_train_step(model: SLSDetector, cfg: ExperimentConfig,
                        device: DeviceLike = "cuda", mesh: Optional[Mesh] = None) -> Callable:
    """step(state, wav [B, S] on the wire, labels [B], valid [B],
    base_seed) -> (state, metrics), as ``train/steps.py::make_train_step``,
    and the BatchNorm's running update committed where the loss is
    finite.  ``metrics``: loss, scores [B], correct, finite, and cls_loss,
    sae_loss and cpc_loss at 0 (module docstring), all on the device.
    ``mesh``: the global batch's step over its 'data' axis, as the
    flagship's (the statistics too are the global batch's)."""
    dev = resolve_device(device)
    tcfg = cfg.train
    opt = make_optimizer(tcfg.lr, tcfg.weight_decay)
    class_weights = torch.tensor(tcfg.loss_weights, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    data_group = axis_of(mesh, "data")[0]

    def step(state: TrainState, wav, labels, valid, base_seed: int):
        w = dequantize_wire(to_device(wav, dev))
        y, ok = to_device(labels, dev).long(), to_device(valid, dev).float()
        gen, ld_gen = step_generators(base_seed, state.calls, dev, mesh)
        state.calls += 1
        model.zero_grad(set_to_none=True)
        out = model(w, train=True, generator=gen, data_group=data_group,
                    layerdrop_generator=ld_gen)
        loss = weighted_nll(out["log_probs"], y, class_weights, ok, group=data_group)
        loss.backward()
        g, terms = global_terms(state, loss.detach()[None], mesh)
        finite = torch.isfinite(terms[0])
        opt.update(state, g, finite)
        model.sls_head.first_bn.commit(out["bn_stats"], finite)
        metrics = {
            "loss": terms[0],
            "cls_loss": zero,
            "sae_loss": zero,
            "cpc_loss": zero,
            "scores": out["score"].detach(),
            "correct": ((out["log_probs"].detach().argmax(-1) == y) * ok).sum(),
            "finite": finite,
        }
        return state, metrics

    return step


def make_sls_eval_step(model: SLSDetector, device: DeviceLike = "cuda") -> Callable:
    """(wav [B, S] on the wire) -> {score [B], log_probs [B, 2], sae_loss
    (0)} on ``device``, under ``torch.inference_mode``; left on the
    device."""
    dev = resolve_device(device)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def step(wav) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            w = wav if torch.is_tensor(wav) else torch.from_numpy(np.ascontiguousarray(wav))
            log_probs = model.score(dequantize_wire(w.to(dev)))
            return {"score": torch.exp(log_probs[:, 1]), "log_probs": log_probs,
                    "sae_loss": zero}

    return step


def layer_gate_profile(model: SLSDetector, wav, return_gates: bool = False) -> Dict:
    """Which encoder layers the SLS head weighs most, over a batch ``wav``
    (on the wire): each layer's mean and (population) std of its sigmoid
    gate over the rows, the five layers of largest mean gate, and with
    ``return_gates`` the [L, B] gates themselves (numpy)."""
    dev = next(model.parameters()).device
    with torch.inference_mode():
        w = dequantize_wire(to_device(wav, dev))
        _, hiddens = model.encoder(w, return_hidden_states=True)
        gates = model.sls_head.gates(hiddens).cpu().numpy()
    mean = gates.mean(axis=1)
    out = {"mean_gate_per_layer": mean.tolist(),
           "std_gate_per_layer": gates.std(axis=1).tolist(),
           "most_sensitive_layers": np.argsort(-mean)[:5].tolist()}
    if return_gates:
        out["gates"] = gates
    return out


class SLSTrainer(BaseTrainer):
    """The trainer of the SLS detector.  The model's weights are drawn
    from ``cfg.train.seed`` on the device; load others into
    ``self.model`` before ``init_state``."""

    log_prefix = "[sls] "

    def _refuse(self, cfg: ExperimentConfig) -> None:
        if cfg.train.model_parallel > 1:
            raise ValueError(
                "model_parallel > 1 is wired for the SAE Detector family "
                "(parallel/tensor.py rules); the SLS parity model is data-parallel only")

    def _build_model_and_steps(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.train.seed)
        self.model = SLSDetector(self.cfg.model, device=self.device, generator=gen,
                                 cut_length=self.cfg.train.cut_length)
        self.train_step = make_sls_train_step(self.model, self.cfg, device=self.device,
                                              mesh=self.mesh)
        self.eval_step = make_sls_eval_step(self.model, device=self.device)

    def _create_state(self):
        return create_sls_train_state(self.model, self.cfg)

    def _state_tree(self) -> Dict:
        return train_state_tree(self.model, self.state)

    def _restore_state(self, tree: Dict) -> None:
        restore_train_state(self.model, self.state, tree)

    def _run_eval(self, wav: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.eval_step(wav)

    def _resume_from_torch(self, path) -> bool:
        """Weights only (running statistics included), from an upstream
        XLS-R + SLS checkpoint (its ``model`` entry, or the dict itself;
        ``module.`` prefixes allowed); the moments and step stay."""
        if self.state is None:
            raise RuntimeError("call init_state() before resume()")
        raw = torch.load(path, map_location="cpu", weights_only=True)
        state = raw.get("model", raw) if isinstance(raw, dict) else raw
        self._load_model_state(sls_detector_state_from_reference(state, self.cfg.model))
        self._torch_epoch_from(raw, path)
        return True
