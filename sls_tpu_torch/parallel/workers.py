"""Rank functions for ``parallel/launch.py``: what one rank of a
multi-process scoring job does.  They live here, not beside their
callers, because spawned ranks import them by module path.  Arguments
and results are plain picklable values (configs, numpy arrays, lists).

- ``sp_score_rank``: sequence-parallel scoring jobs on one or more
  meshes of the job's ranks, with the kernel launch counts of each.
- ``produce_scores_rank``: this rank's shard of a score file.
- ``collectives_rank``: every host-array helper of
  ``parallel/distributed.py`` once, for the tests.
- ``train_steps_rank``: train steps of the global batch, data, tensor
  or sequence parallel, with what a test holds them to (losses, scores,
  the summed gradient, the weights after, launches).
- ``draws_rank``: one training forward of the encoder on the same audio
  on every rank, with the step's generators.
- ``trainer_rank``: ``Trainer`` / ``SLSTrainer`` fits across the ranks,
  and ``cli_rank`` the command line inside the job.
- ``global_batch_rank``: the global-batch helpers on rank-tagged rows.
- ``wait_for_path_rank``: a rank waits for its caller's word.
- ``jobs_rank``: several of these in one job, in order.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple
from unittest import mock

import numpy as np
import torch

from sls_tpu_torch.data.pipeline import ArrayLoader
from sls_tpu_torch.evaluation.overlap import score_utterances_unwindowed
from sls_tpu_torch.kernels import attention, frontend, layer_norm, sae_kernels
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.parallel import distributed as dist
from sls_tpu_torch.parallel.mesh import SeqShard
from sls_tpu_torch.parallel.sequence import sp_mesh, sp_model_config, sp_scoring_fn
from sls_tpu_torch.train.loop import produce_scores
from sls_tpu_torch.train.steps import make_eval_step


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count in this process, by name."""
    return {name: fn.launches
            for module in (sae_kernels, attention, frontend, layer_norm)
            for name, fn in vars(module).items()
            if callable(fn) and hasattr(fn, "launches")}


def _delta(before: Mapping[str, int]) -> Dict[str, int]:
    return {name: n - before[name] for name, n in launch_counts().items()}


def build_model(model_cfg, weights: Mapping, device: torch.device) -> Detector:
    """The rank's Detector: ``{"seed": s}`` draws the weights on the
    device from seed ``s`` (the same on every rank of one device type),
    ``{"state": {name: array}}`` loads them."""
    if "seed" in weights:
        gen = torch.Generator(device=device).manual_seed(int(weights["seed"]))
        return Detector(model_cfg, device=device, generator=gen)
    model = Detector(model_cfg, device=device)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in weights["state"].items()}, strict=True)
    return model


def sp_score_rank(models: Sequence[Tuple], device_type: str,
                  meshes: Sequence[Tuple[int, int]], jobs: Sequence[Mapping]) -> List[Dict]:
    """Run ``jobs`` sequence-parallel; returns one result dict a job.

    ``models`` lists (``sp_model_config``, weights as ``build_model``
    takes them) and ``meshes`` (n_seq, n_data) of the meshes to build
    over the job's ranks; a job names one of each by index (``"model"``,
    ``"mesh"``, default 0).  A job's ``"kind"`` is one of the names below
    or a module-level function ``fn(job, model, mesh, device) -> dict``
    of the caller's (a measurement, say), run under ``inference_mode``:

    - ``"forward"`` (``wav`` [B, S]): ``log_probs`` and ``sae_loss`` of
      ``Detector.forward``;
    - ``"unwindowed"`` (``clips`` [(utt, wav)], ``t_targets``):
      ``scores`` [(utt, score, bucket)] of ``score_utterances_unwindowed``
      and ``per_clip`` launch counts;
    - ``"encoder"`` (``wav``): the encoder's output, gathered over the
      mesh, as ``features`` on rank 0 (None elsewhere);
    - ``"attention"`` (``q``, ``k``, ``v`` [B, T, C] float32, ``dtype``,
      ``num_heads``): ``sp_flash_attention_long`` on this rank's shards
      of the arrays rounded to ``dtype``, gathered, as ``out`` (float32)
      on rank 0.

    Every result carries ``launches`` (kernel launches during the job, by
    wrapper) and ``sp_calls``: how often the job took the
    ``sp_flash_attention_long`` route, its launches plus the calls that
    reached its plain version (the CPU's route)."""
    device = dist.local_device(device_type)
    built_models = [build_model(cfg, weights, device) for cfg, weights in models]
    built_meshes = [sp_mesh(n_seq, n_data) for n_seq, n_data in meshes]
    unknown = [job["kind"] for job in jobs
               if not callable(job["kind"]) and job["kind"] not in _JOBS]
    if unknown:
        raise ValueError(f"unknown job kind(s) {unknown}; known: {sorted(_JOBS)}")
    plain, plain_calls = attention.sp_flash_attention_long_plain, [0]

    def counted_plain(*args, **kwargs):
        plain_calls[0] += 1
        return plain(*args, **kwargs)

    out = []
    for job in jobs:
        model, mesh = built_models[job.get("model", 0)], built_meshes[job.get("mesh", 0)]
        run = job["kind"] if callable(job["kind"]) else _JOBS[job["kind"]]
        before, plain_before = launch_counts(), plain_calls[0]
        with mock.patch.object(attention, "sp_flash_attention_long_plain", counted_plain), \
                torch.inference_mode():
            res = run(job, model, mesh, device)
        res["launches"] = _delta(before)
        res["sp_calls"] = (res["launches"]["sp_flash_attention_long"]
                           + plain_calls[0] - plain_before)
        out.append(res)
    return out


def _wav(job: Mapping, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(job["wav"], np.float32)).to(device)


def _gathered_on_primary(shard: SeqShard, x: torch.Tensor) -> Optional[np.ndarray]:
    x = shard.gather_rows(shard.gather_frames(x.float()))
    return x.cpu().numpy() if dist.is_primary() else None


def _forward_job(job, model, mesh, device) -> Dict:
    full = model(_wav(job, device), mesh=mesh)
    return {"log_probs": full["log_probs"].cpu().numpy(), "sae_loss": float(full["sae_loss"])}


def _unwindowed_job(job, model, mesh, device) -> Dict:
    res: Dict = {"scores": [], "per_clip": []}
    seen = launch_counts()
    for item in score_utterances_unwindowed(
            model, iter(job["clips"]), model.config.encoder,
            t_targets=tuple(job["t_targets"]), sp_mesh=mesh, device=device):
        res["scores"].append(item)
        res["per_clip"].append(_delta(seen))
        seen = launch_counts()
    return res


def _encoder_job(job, model, mesh, device) -> Dict:
    wav = _wav(job, device)
    shard = model.encoder.shard_for(wav, mesh)
    return {"features": _gathered_on_primary(shard, model.encoder(wav, shard=shard))}


def _attention_job(job, model, mesh, device) -> Dict:
    dtype = getattr(torch, job["dtype"])
    q, k, v = (torch.from_numpy(np.asarray(job[n], np.float32)).to(device, dtype)
               for n in ("q", "k", "v"))
    shard = SeqShard(mesh, "seq", q.shape[0], q.shape[1])
    q, k, v = (shard.take_frames(shard.take_rows(x)).contiguous() for x in (q, k, v))
    out = attention.sp_flash_attention_long(q, k, v, int(job["num_heads"]), shard.seq_group)
    return {"out": _gathered_on_primary(shard, out)}


_JOBS = {"forward": _forward_job, "unwindowed": _unwindowed_job, "encoder": _encoder_job,
         "attention": _attention_job}


def produce_scores_rank(model_cfg, weights: Mapping, device_type: str, wire: np.ndarray,
                        utt_ids: Sequence[str], batch_size: int, out_path: str) -> Dict:
    """Score this rank's ``host_shard`` of the set into its part of
    ``out_path`` (``produce_scores`` merges the parts); returns the global
    ``count``, this rank's ``local`` count and its kernel ``launches``."""
    device = dist.local_device(device_type)
    model = build_model(model_cfg, weights, device)
    loader = ArrayLoader(wire, None, list(utt_ids), batch_size).host_shard(
        dist.process_index(), dist.process_count())
    step = make_eval_step(model, device=device)
    before = launch_counts()
    count = produce_scores(step, loader, out_path)
    return {"count": count, "local": len(loader.wavs), "launches": _delta(before)}


def collectives_rank(tmp_dir: str) -> Dict:
    """What this rank sees of each host-array helper: a ragged gather of
    ``rank + 1`` rows, a sum of scalars, the part-file names, a merge of
    complete parts, and a merge with one part missing (the error must
    reach every rank)."""
    rank, n = dist.process_index(), dist.process_count()
    res: Dict = {"rank": rank, "count": n, "primary": dist.is_primary()}
    res["rows"] = dist.allgather_rows(np.full((2, 3), rank, np.float32))
    res["ragged"] = dist.allgather_ragged_rows(np.full((rank + 1, 2), rank, np.int64))
    res["sum"] = dist.allreduce_sum_scalars([1.0, float(rank)])
    out = os.path.join(tmp_dir, "merged.txt")
    res["part"] = os.path.basename(dist.part_path(out))
    with open(dist.part_path(out), "w") as f:
        f.write(f"line of rank {rank}\n")
    dist.merge_part_files(out)
    with open(out) as f:
        res["merged"] = f.read()
    res["parts_left"] = sorted(p for p in os.listdir(tmp_dir) if p.startswith("merged.txt.part"))
    lost = os.path.join(tmp_dir, "lost.txt")
    if rank != n - 1:  # the last rank writes no part
        with open(dist.part_path(lost), "w") as f:
            f.write("x\n")
    try:
        dist.merge_part_files(lost)
        res["missing_part_error"] = None
    except FileNotFoundError as e:
        res["missing_part_error"] = str(e)
    return res


# -- training across ranks -----------------------------------------------------------------


def _rows(x, index: int, count: int):
    x = np.asarray(x)
    n = x.shape[0] // count
    return x[index * n:(index + 1) * n]


def train_steps_rank(exp, family: str, weights: Mapping, batches: Sequence[Tuple],
                     device_type: str = "cpu", nan_step: Optional[int] = None,
                     nan_rank: int = 1, grad_path: Optional[str] = None,
                     return_weights: bool = True, return_grads: bool = True,
                     time_allreduce: bool = False,
                     sp: Optional[Tuple[int, int]] = None) -> Dict:
    """Run ``make_train_step`` (``family`` "detector") or
    ``make_sls_train_step`` ("sls") over ``batches`` of the global batch
    (wav, labels, valid), each rank on its data coordinate's rows: on a
    'data' mesh of every rank, with ``exp.train.model_parallel`` > 1 on
    the ('data', 'model') mesh of ``parallel/tensor.py`` with the model cut
    over 'model', or with ``sp`` = (n_data, n_seq) on ``sp_mesh(n_seq,
    n_data)`` over the job's first ranks, sequence parallel where n_seq >
    1 (``sp_model_config``; ranks outside the mesh return None).
    ``weights`` is a whole state dict (numpy), ``{"seed":
    s}`` (drawn on the device) or ``{"path": p}`` (a ``torch.save`` of
    one).  At ``nan_step`` rank ``nan_rank`` plants a NaN in its batch.

    Returns per step ``terms`` (loss, cls_loss, sae_loss, cpc_loss),
    ``finite``, ``correct``, this rank's ``scores``, ``ms`` (host clock,
    synchronised) and the flat
    gradient the optimizer got (summed over 'data', whole over 'model'):
    its [sum, sum of squares] as ``grad_sums``, and the gradient itself
    as ``grad`` (numpy; with ``return_grads``) or, with ``grad_path``,
    rank 0 saving step 0's to that ``.npy``; at
    ``nan_step`` also ``bits_kept`` (the state bit for bit what it was);
    for "sls" the BatchNorm's batch statistics the step committed from
    (``bn_stats``).
    After the steps: ``checksum`` (this rank's tensors), ``buffers``,
    ``step``, ``launches``, ``peak_bytes``, with ``time_allreduce`` the ms
    of one all-reduce of a buffer of the gradient's size over the ranks
    the step sums it over ('data', or every rank of a sequence-parallel
    mesh), and
    with ``return_weights`` the whole weights (numpy, on rank 0)."""
    from sls_tpu_torch.models.sls import SLSDetector, make_sls_train_step
    from sls_tpu_torch.parallel.mesh import axis_of, make_mesh
    from sls_tpu_torch.parallel.tensor import (gather_train_tree, model_shard, shard_model_,
                                               state_shardings, tp_mesh_and_config)
    from sls_tpu_torch.train import steps as train_steps

    device = dist.local_device(device_type)
    on_card = device.type == "cuda"
    cut = int(np.asarray(batches[0][0]).shape[1])
    if exp.train.model_parallel > 1:
        mesh, exp = tp_mesh_and_config(exp)
    elif sp is not None:
        mesh = sp_mesh(sp[1], n_data=sp[0])
        if mesh.coords is None:
            return None
        if sp[1] > 1:
            exp = dataclasses.replace(exp, model=sp_model_config(exp.model))
    else:
        mesh = make_mesh(("data",))
    kwargs = {"cut_length": cut} if family == "sls" else {}
    cls = SLSDetector if family == "sls" else Detector
    make = make_sls_train_step if family == "sls" else train_steps.make_train_step
    if "seed" in weights:
        gen = torch.Generator(device=device).manual_seed(int(weights["seed"]))
        model = cls(exp.model, device=device, generator=gen, **kwargs)
    else:
        model = cls(exp.model, device="meta", **kwargs)
        state_dict = (torch.load(weights["path"], map_location=device, weights_only=True)
                      if "path" in weights else
                      {k: torch.tensor(np.asarray(v), device=device)  # a copy: jobs share arrays
                       for k, v in weights.items()})
        model.load_state_dict(state_dict, strict=True, assign=True)
        del state_dict
    shard = specs = None
    if exp.train.model_parallel > 1:
        specs = state_shardings(model, mesh)["params"]
        shard = model_shard(mesh)
        shard_model_(model, specs, shard)
    group, index, count = axis_of(mesh, "data")
    state = train_steps.create_train_state(model, exp)
    step = make(model, exp, device=device, mesh=mesh)
    captured: List[torch.Tensor] = []
    update = train_steps.AdamL2.update
    n_params = sum(p.numel() for p in state.params)

    def capture(self, st, g, finite):
        captured.append(g.detach().clone())
        return update(self, st, g, finite)

    def snapshot():
        return ([t.detach().clone() for t in model.state_dict().values()],
                [state.exp_avg.clone(), state.exp_avg_sq.clone(), state.step.clone()])

    def whole(flat: torch.Tensor) -> torch.Tensor:
        if shard is None:
            return flat
        tree = {"model": model.state_dict(), "names": state.names, "exp_avg": flat,
                "exp_avg_sq": flat}
        return gather_train_tree(tree, specs, shard)["exp_avg"]

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    bn_stats: List = []
    if family == "sls":
        first_bn = model.sls_head.first_bn
        commit = first_bn.commit

        def recorded_commit(stats, finite):
            bn_stats.append([float(t) for t in stats])
            return commit(stats, finite)

        first_bn.commit = recorded_commit

    out: Dict = {"steps": []}
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    before_launches = launch_counts()
    with mock.patch.object(train_steps.AdamL2, "update", capture):
        for i, (wav, labels, valid) in enumerate(batches):
            wav = _rows(wav, index, count).copy()
            if i == nan_step and dist.process_index() == nan_rank:
                wav = wav.astype(np.float32)
                wav[0, wav.shape[1] // 2] = np.nan
            prev = snapshot() if i == nan_step else None
            sync()
            t0 = time.perf_counter()
            state, m = step(state, wav, _rows(labels, index, count),
                            _rows(valid, index, count), 0)
            sync()
            res = {"ms": (time.perf_counter() - t0) * 1e3,
                   "terms": [float(m[k]) for k in ("loss", "cls_loss", "sae_loss", "cpc_loss")],
                   "finite": bool(m["finite"]), "correct": int(m["correct"]),
                   "scores": m["scores"].float().cpu().numpy()}
            g = whole(captured.pop()[:n_params])
            res["grad_sums"] = [float(g.double().sum()), float(g.double().square().sum())]
            if grad_path is not None:
                if i == 0 and dist.is_primary():
                    np.save(grad_path, g.cpu().numpy())
            elif return_grads:
                res["grad"] = g.cpu().numpy()
            del g
            if bn_stats:
                res["bn_stats"] = bn_stats.pop()
            if prev is not None:
                now = snapshot()
                res["bits_kept"] = all(torch.equal(a, b) for part in (0, 1)
                                       for a, b in zip(prev[part], now[part]))
                del prev, now
            out["steps"].append(res)
    out["launches"] = _delta(before_launches)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device) if on_card else 0
    if sp is not None and sp[1] > 1:  # the step sums over every rank of the mesh
        group, count = mesh.group, len(mesh.ranks)
    if time_allreduce and count > 1:
        buf = torch.zeros(n_params, device=device)
        sync()
        t0 = time.perf_counter()
        torch.distributed.all_reduce(buf, group=group)
        sync()
        out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3
        del buf
    out["checksum"] = weights_checksum_of(model)
    out["buffers"] = {k: v.cpu().numpy().copy() for k, v in model.named_buffers()}
    out["step"] = int(state.step)
    if return_weights:
        tree = train_steps.train_state_tree(model, state)
        if shard is not None:
            tree = gather_train_tree(tree, specs, shard)
        out["weights"] = ({k: v.detach().cpu().numpy().copy() for k, v in tree["model"].items()}
                          if dist.is_primary() else None)
    return out


def weights_checksum_of(model) -> List[float]:
    """[sum, sum of squares] of every tensor of ``model``'s state dict
    (buffers too), in float64."""
    with torch.no_grad():
        return [float(sum(t.double().sum() for t in model.state_dict().values())),
                float(sum(t.double().square().sum() for t in model.state_dict().values()))]


def draws_rank(exp, wav: np.ndarray, call: int, device_type: str = "cpu") -> Dict:
    """The encoder's training forward of the same ``wav`` on every rank,
    with the dropout and layerdrop generators of a data-parallel step's
    call ``call`` (``train/steps.py::step_generators``), weights from
    seed 0; returns the output (numpy)."""
    from sls_tpu_torch.parallel.mesh import make_mesh
    from sls_tpu_torch.train.steps import step_generators

    device = dist.local_device(device_type)
    model = Detector(exp.model, device=device)
    mesh = make_mesh(("data",))
    gen, ld_gen = step_generators(0, call, device, mesh)
    with torch.no_grad():
        feats = model.encoder(torch.from_numpy(wav).to(device), train=True, generator=gen,
                              layerdrop_generator=ld_gen)
    return {"features": feats.cpu().numpy()}


def trainer_rank(exp, family: str, run_dir: str, train: Tuple, val: Tuple, batch_size: int,
                 epochs: int, resume: bool = False, device_type: str = "cpu",
                 n_seq: int = 1) -> Dict:
    """``fit`` of a ``Trainer`` ("detector") or ``SLSTrainer`` ("sls") over
    this rank's data shard (``host_shard`` of ``train`` / ``val``, each
    (wav, labels)) up to ``epochs``, after ``resume()`` when asked; with
    ``n_seq`` > 1 a ``Trainer`` on ``sp_mesh(n_seq, ranks / n_seq)`` with
    ``sp_model_config``.  Returns each epoch's train and validation
    figures as this rank saw them, the state's checksum, ``step`` and
    ``calls``, the kernel ``launches`` and the fit's seconds."""
    from sls_tpu_torch.models.sls import SLSTrainer
    from sls_tpu_torch.train import loop

    device = dist.local_device(device_type)
    cls = SLSTrainer if family == "sls" else loop.Trainer
    mesh = None
    if n_seq > 1:
        mesh = sp_mesh(n_seq, n_data=dist.process_count() // n_seq)
        exp = dataclasses.replace(exp, model=sp_model_config(exp.model))
    trainer = cls(exp, run_dir, tensorboard=False, device=device, mesh=mesh)
    trainer.init_state()
    resumed = trainer.resume() if resume else False
    metrics: List = []
    train_epoch, validate = trainer.train_epoch, trainer.validate

    def recorded_train_epoch(loader, epoch):
        m = train_epoch(loader, epoch)
        metrics.append(("train", epoch, dataclasses.asdict(m)))
        return m

    def recorded_validate(loader):
        m = validate(loader)
        metrics.append(("val", None, dataclasses.asdict(m)))
        return m

    trainer.train_epoch, trainer.validate = recorded_train_epoch, recorded_validate
    shard = trainer.data_shard()
    before = launch_counts()
    t0 = time.perf_counter()
    trainer.fit(ArrayLoader(*train, batch_size=batch_size).host_shard(*shard,
                                                                      drop_remainder=True),
                ArrayLoader(*val, batch_size=batch_size).host_shard(*shard), epochs)
    return {"metrics": metrics, "resumed": resumed, "start_epoch": trainer.start_epoch,
            "checksum": weights_checksum_of(trainer.model), "launches": _delta(before),
            "fit_s": time.perf_counter() - t0,
            "step": int(trainer.state.step), "calls": trainer.state.calls}


def cli_rank(argv: Sequence[str]) -> int:
    """``cli.main(argv)`` on this rank of the job."""
    from sls_tpu_torch.cli.main import main

    return main(list(argv))


def global_batch_rank(n_rows: int) -> Dict:
    """``global_batch`` / ``fetch_global`` / ``local_rows`` over a 'data'
    mesh of every rank, on ``n_rows`` rows of 3 tagged by the rank."""
    from sls_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(("data",))
    x = np.arange(n_rows * 3, dtype=np.float32).reshape(n_rows, 3) + 100 * dist.process_index()
    (t,), rows = dist.global_batch((x,), mesh, device=torch.device("cpu"))
    return {"rows": rows, "local": dist.local_rows(t), "fetched": dist.fetch_global(t, mesh),
            "fetched_host": dist.fetch_global(x, mesh)}


def wait_for_path_rank(path: str, abort: str, timeout_s: float) -> Dict:
    """Wait until ``path`` exists (the caller's word to go on, so that the
    ranks start while the caller still works); raise when ``abort``
    appears or after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if os.path.exists(abort):
            raise RuntimeError(f"the caller gave up the job ({abort})")
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} within {timeout_s:.0f} s")
        time.sleep(0.05)
    return {}


def jobs_rank(jobs: Sequence[Tuple[str, Sequence, Mapping]]) -> List:
    """Run ``(name, args, kwargs)`` jobs of this module's rank functions in
    order; one result each (a dict result also gets its ``job_s``, the
    job's seconds on this rank, and ``job_wall``, its start and end on
    the host's wall clock)."""
    out = []
    for name, args, kwargs in jobs:
        t0, wall = time.perf_counter(), time.time()
        res = globals()[name](*args, **kwargs)
        if isinstance(res, dict):
            res["job_s"] = time.perf_counter() - t0
            res["job_wall"] = (wall, time.time())
        out.append(res)
    return out
