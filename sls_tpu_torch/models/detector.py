"""The anti-spoofing detector, counterpart of ``sls_tpu/models/detector.py``.

    wav [B, 64600]
      -> XLS-R encoder          [B, T, 1024]
      -> TopK SAE encode        [B, T, dict_size]
      -> decode                 [B, T, 1024]        (MSE recon loss)
      -> classify sparse codes (use_sparse_features) or reconstruction
      -> mean-pool + MLP head   [B, 2] log-probs    (class 1 = bonafide)

With ``use_cpc`` (and an SAE) the detector also holds a ``CPCHead``:
``forward(..., compute_cpc=True)`` mean-pools the codes into windows of
``sae.window_size`` frames and returns their InfoNCE loss.  The train
step asks for it when ``use_cpc`` is set; the eval step and ``score``
never do, as in the reference.

``forward`` returns the reference's dict.  ``score`` computes only the
log-probs and skips the decode, which the JAX serving step gets from
XLA's dead-code elimination.  Both open the spans ``sls.sae`` (the SAE's
encode, and in ``forward`` its decode and loss) and ``sls.head`` (the
classifier) of ``train/profiling.py``, inside the encoder's own.

The mode is an argument, as in the reference: ``forward(wav,
train=True, generator=g)`` takes the encoder's training routes and
applies dropout (masks and layerdrop draws from ``g``); the default is
eval.  ``nn.Module.train()`` / ``eval()`` change nothing here.  With
``freeze_encoder`` the encoder runs under ``torch.no_grad()`` (the
reference's ``stop_gradient``; still in the given mode), so it keeps no
activations and gets no gradient.

With ``encoder.seq_axis`` set both take the ``Mesh`` and run
sequence-parallel (``parallel/sequence.py``): the encoder returns this
rank's rows and frames, the per-timestep SAE encodes them as they are
(the window variants gather the frames first), sums over frames are
all-reduced over the sequence axis, and every rank returns every row's
``log_probs`` and the global ``sae_loss``.  ``features``, ``codes`` and
``recon`` stay this rank's part.

Under ``train`` with a mesh (a sequence-parallel train step,
``train/steps.py``) the rows are already this data coordinate's: the
step hands the model ``parallel/mesh.py::one_data_coordinate(mesh)``,
whose shard cuts frames only.  The losses are then this rank's shares
of the mesh's, which sum over every rank of the mesh to the global
value, as a data-parallel step's sum over 'data': the per-timestep SAE
loss is this rank's frames' sum of squares over the global count; what
runs whole on every seq rank after a reduction over 'seq' (the window
variants' SAE loss on gathered features, the CPC loss on gathered codes)
enters at 1 / n_seq, since the backward of the gathers and sums sums
the seq ranks' gradients.  The step scales the NLL of the pooled head
likewise.

In a data-parallel train step the step passes its mesh's 'data' group
(``data_group``): ``sae_loss`` and ``cpc_loss`` are then this rank's
shares of the global batch's losses (``sae/topk.py::reconstruction_loss``,
``sae/cpc.py``), which sum over the ranks to the reference's values, and
``layerdrop_generator`` (alike on every rank) draws the layerdrop.  Under
tensor parallelism (``parallel/tensor.py::shard_model_``) the cut
modules run their own forward; nothing here changes.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from sls_tpu_torch.config import ModelConfig
from sls_tpu_torch.device import DeviceLike, resolve_device
from sls_tpu_torch.encoder.xlsr import XLSREncoder, init_weights_
from sls_tpu_torch.heads.classifier import MeanPoolClassifier
from sls_tpu_torch.parallel.distributed import group_size
from sls_tpu_torch.parallel.mesh import Mesh, SeqShard
from sls_tpu_torch.sae.cpc import CPCHead
from sls_tpu_torch.sae.sparsify import aggregate_windows_mean
from sls_tpu_torch.sae.topk import TopKSAE, reconstruction_loss
from sls_tpu_torch.train.profiling import span


class Detector(nn.Module):
    """The detector.  Parameters are fp32 on ``device`` and drawn from
    ``generator`` (default: seed 0 on that device); on the ``meta``
    device they are left uninitialised."""

    def __init__(self, config: ModelConfig, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.encoder = XLSREncoder(config.encoder, device=dev)
        if config.use_sae:
            sae_dtype = torch.bfloat16 if config.sae.bf16 else torch.float32
            self.sae = TopKSAE(config.sae, dtype=sae_dtype, device=dev)
        if config.use_cpc and config.use_sae:
            self.cpc = CPCHead(config.cpc, config.sae.dict_size, device=dev)
        self.classifier = MeanPoolClassifier(
            config.classifier_input_dim, config.classifier_hidden,
            config.num_classes, config.classifier_dropout, device=dev)
        if dev.type != "meta":
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            init_weights_(self.encoder, generator)
            if config.use_sae:
                self.sae.reset_parameters(generator)
            init_weights_(self.classifier, generator)
            if hasattr(self, "cpc"):
                init_weights_(self.cpc, generator)

    def _encode(self, wav: torch.Tensor, mesh: Optional[Mesh], train: bool = False,
                generator: Optional[torch.Generator] = None,
                layerdrop_generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[SeqShard], Optional[SeqShard]]:
        """fp32 encoder features; how the batch is cut on ``mesh`` (None
        without ``seq_axis``); and that cut again if the features are
        still this rank's frames, None once they are whole."""
        shard = self.encoder.shard_for(wav, mesh)
        with torch.no_grad() if self.config.freeze_encoder else nullcontext():
            feats = self.encoder(wav, shard=shard, train=train, generator=generator,
                                 layerdrop_generator=layerdrop_generator)
        feats32 = feats.float()
        frames = shard
        if shard is not None and self.config.use_sae and not self.sae.row_parallel:
            feats32, frames = shard.gather_frames(feats32), None
        return feats32, shard, frames

    def forward(self, wav: torch.Tensor, mesh: Optional[Mesh] = None, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                compute_cpc: bool = False, data_group=None,
                layerdrop_generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """``train`` takes the training routes with dropout from
        ``generator`` (required then) and layerdrop from
        ``layerdrop_generator`` (default ``generator``); ``compute_cpc``
        computes the CPC loss when the model has the head; ``data_group``
        makes the losses this rank's shares of a data-parallel step's
        (module docstring).  Returns a dict with:

        log_probs  [B, 2]      log-softmax outputs (class 1 = bonafide)
        score      [B]         P(bonafide) = exp(log_probs[:, 1])
        sae_loss   []          MSE reconstruction loss (0 when no SAE)
        cpc_loss   []          InfoNCE loss (0 unless compute_cpc and use_cpc)
        features   [B, T, D]   encoder output, fp32
        codes      [B, T, M]   sparse SAE codes (when use_sae)
        recon      [B, T, D]   SAE reconstruction (when use_sae)
        window_features [B, N, M]  the codes mean-pooled by window (with the CPC loss)
        """
        cfg = self.config
        if train and generator is None:
            raise ValueError("train=True needs a generator for dropout")
        feats32, shard, frames = self._encode(wav, mesh, train, generator, layerdrop_generator)
        ranks = group_size(data_group) if data_group is not None else 1
        # the seq ranks that compute a term whole after a reduction over
        # 'seq', each taking 1 / copies of it (module docstring)
        copies = shard.n_seq if train and shard is not None else 1
        zero = torch.zeros((), dtype=torch.float32, device=feats32.device)
        out: Dict[str, torch.Tensor] = {"features": feats32}
        sae_loss = cpc_loss = zero
        if cfg.use_sae:
            with span("sls.sae"):
                codes = self.sae.encode(feats32)
                recon = self.sae.decode(codes)
                if shard is None:
                    sae_loss = reconstruction_loss(recon, feats32, ranks)
                elif train:  # this rank's share of the mesh's mean
                    sq = torch.square(recon.float() - feats32).sum()
                    count = shard.rows * shard.frames * feats32.shape[-1] * ranks
                    sae_loss = sq / (count if frames is not None else count * copies)
                else:  # the mean over every row and frame, from this rank's sum
                    sq = torch.square(recon - feats32).sum()
                    if frames is not None:
                        sq = shard.sum_frames(sq)
                    sae_loss = shard.sum_rows(sq) / (shard.rows * shard.frames
                                                     * feats32.shape[-1])
            out["codes"] = codes
            out["recon"] = recon
            cls_in = codes if cfg.use_sparse_features else recon
            if cfg.use_cpc and compute_cpc:
                whole = codes if frames is None else shard.gather_frames(codes)
                windows = aggregate_windows_mean(whole, cfg.sae.window_size)
                cpc_loss = self.cpc(windows, data_group) / copies
                out["window_features"] = windows
        else:
            cls_in = feats32
        with span("sls.head"):
            log_probs = self.classifier(cls_in, frames, generator if train else None)
            if shard is not None:
                log_probs = shard.gather_rows(log_probs)
        out["log_probs"] = log_probs
        out["score"] = torch.exp(log_probs[:, 1])
        out["sae_loss"] = sae_loss
        out["cpc_loss"] = cpc_loss
        return out

    def score(self, wav: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
        """log_probs [B, 2] only, with no decode when the head reads the
        sparse codes (the serving path)."""
        cfg = self.config
        feats32, shard, frames = self._encode(wav, mesh)
        cls_in = feats32
        if cfg.use_sae:
            with span("sls.sae"):
                codes = self.sae.encode(feats32)
                cls_in = codes if cfg.use_sparse_features else self.sae.decode(codes)
        with span("sls.head"):
            log_probs = self.classifier(cls_in, frames)
            return log_probs if shard is None else shard.gather_rows(log_probs)

    def encode_sae(self, wav: torch.Tensor) -> Dict[str, torch.Tensor]:
        """fp32 encoder features [B, T, D] and sparse SAE codes [B, T, M],
        in eval mode, with no decode and no classifier (the analysis
        entry point)."""
        feats32, _, _ = self._encode(wav, None)
        return {"features": feats32, "codes": self.sae.encode(feats32)}

    def classify_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """log_probs [B, 2] of the classifier in eval mode on given codes
        [B, T, M]: the hook gradient attribution differentiates."""
        return self.classifier(codes)


def total_loss(cls_loss, sae_loss, sae_weight: float, cpc_loss=None,
               cpc_weight: float = 0.0):
    """L = L_cls + w_sae * L_recon [+ w_cpc * L_cpc]."""
    total = cls_loss
    if sae_loss is not None:
        total = total + sae_weight * sae_loss
    if cpc_loss is not None and cpc_weight:
        total = total + cpc_weight * cpc_loss
    return total
