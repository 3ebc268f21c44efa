"""Multi-process wiring, counterpart of ``sls_tpu/parallel/distributed.py``.

The JAX package runs one controller per host over a global device mesh;
PyTorch runs one process per rank, joined by ``torch.distributed``.  This
module owns what makes the rest of the port multi-process-clean:

- ``initialize()`` joins the process group.  Each setting resolves as
  explicit argument > ``SLS_TPU_COORDINATOR`` / ``SLS_TPU_NUM_PROCESSES``
  / ``SLS_TPU_PROCESS_ID`` > torchrun's ``MASTER_ADDR`` / ``RANK`` /
  ``WORLD_SIZE``; with nothing set the run is a plain single process.
- The backend rule (``choose_backend``), logged at initialisation:
  ``nccl`` when every rank of the job has a card of its own, ``gloo``
  when ranks share a card or run on the CPU.  The backend carries the
  collectives only and never moves the model off the card: ``gloo`` takes
  CUDA tensors and stages them through host memory itself.
- Host-array collectives (``allgather_rows``, ``allgather_ragged_rows``,
  ``allreduce_sum_scalars``), a tensor collective for activations
  (``all_gather_cat``), IO gating (``is_primary``), per-process part files
  (``part_path``, ``merge_part_files``) and a barrier (``sync_hosts``).
  All of them are the identity in a single process.

The reference's ``global_batch`` / ``fetch_global`` / ``local_rows``
describe arrays that span processes; they belong to data-parallel
training and come with that slice.
"""

from __future__ import annotations

import datetime
import os
import shutil
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


def choose_backend(device_type: str, local_processes: int) -> str:
    """``nccl`` when the ranks on this host each have a card of their own,
    else ``gloo`` (ranks sharing a card, which NCCL refuses, or the CPU)."""
    if device_type == "cuda" and torch.cuda.device_count() >= local_processes:
        return "nccl"
    return "gloo"


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device_type: str = "cuda",
    local_processes: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join this process to the job's process group.

    Returns True when the group is (or already was) up, False for a plain
    single-process run (no coordinator configured anywhere).  Settings
    that are given and do not work raise; nothing falls back to a single
    process.  ``coordinator_address`` is ``host:port`` or a
    ``tcp://`` / ``file://`` URL.  ``backend`` overrides the rule of
    ``choose_backend``; ``local_processes`` (default: torchrun's
    ``LOCAL_WORLD_SIZE``, else every process) is the number of ranks on
    this host, which the rule compares with the host's cards.
    ``timeout_s`` bounds the rendezvous and every later collective."""
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator_address = coordinator_address or env.get("SLS_TPU_COORDINATOR")
    if num_processes is None and "SLS_TPU_NUM_PROCESSES" in env:
        num_processes = int(env["SLS_TPU_NUM_PROCESSES"])
    if process_id is None and "SLS_TPU_PROCESS_ID" in env:
        process_id = int(env["SLS_TPU_PROCESS_ID"])
    if coordinator_address is not None:
        init_method = _init_method(coordinator_address)
    elif "MASTER_ADDR" in env and "RANK" in env and "WORLD_SIZE" in env:
        init_method = "env://"  # torchrun
        num_processes = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(env["RANK"]) if process_id is None else process_id
    else:
        return False  # plain single-process run
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address!r} given without num_processes / process_id")
    if local_processes is None:
        local_processes = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    rule = backend is None
    if rule:
        backend = choose_backend(device_type, local_processes)
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    if process_id == 0:
        cards = torch.cuda.device_count() if device_type == "cuda" else 0
        print(f"torch.distributed: backend {backend} "
              f"({'by rule' if rule else 'as asked'}: {local_processes} local rank(s), "
              f"{cards} card(s)), {num_processes} process(es)", flush=True)
    return True


def shutdown() -> None:
    """Leave the process group (no-op single-process)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on exactly one process; gate checkpoint, log and score writes."""
    return process_index() == 0


def local_device(device_type: str = "cuda") -> torch.device:
    """The device this rank computes on: the CPU, or the card of its
    local rank (torchrun's ``LOCAL_RANK``, else its rank), wrapping round
    when ranks share cards."""
    if device_type != "cuda":
        return torch.device(device_type)
    local_rank = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", local_rank % max(torch.cuda.device_count(), 1))


def _collective_device() -> torch.device:
    """Where a host array goes for a collective: NCCL moves device
    tensors only, gloo takes host ones."""
    if dist.get_backend() == "nccl":
        return local_device("cuda")
    return torch.device("cpu")


def all_gather_cat(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The group's equal-shaped tensors concatenated along ``dim`` in rank
    order, contiguous, on ``x``'s device.  ``group=None`` with no process
    group up is a group of one.  The pieces are received as slices of one
    buffer, so for ``dim`` 0 (or leading dims of size 1) the result is
    that buffer; otherwise moving the pieces next to each other along
    ``dim`` costs one copy."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x.contiguous()
    n = dist.get_world_size(group)
    buf = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather(list(buf.unbind(0)), x.contiguous(), group=group)
    # [n, d0, .., dim, ..] -> [d0, .., n, dim, ..] -> [d0, .., n * dim, ..]
    out = buf.movedim(0, dim).reshape(
        *x.shape[:dim], n * x.shape[dim], *x.shape[dim + 1:])
    return out.contiguous()


def allgather_rows(x) -> np.ndarray:
    """Concatenate per-process host arrays (same shape everywhere) in
    process order.  Identity single-process."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x)).to(_collective_device())
    return all_gather_cat(t, dim=0).cpu().numpy()


def allgather_ragged_rows(x) -> np.ndarray:
    """``allgather_rows`` for per-process arrays of unequal leading size:
    pads to the global max, gathers, and drops the padding.  Identity
    single-process."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    lengths = allgather_rows(np.asarray([x.shape[0]], np.int64))
    max_len = int(lengths.max())
    pad = np.zeros((max_len - x.shape[0],) + x.shape[1:], x.dtype)
    gathered = allgather_rows(np.concatenate([x, pad], axis=0))
    parts = np.split(gathered, process_count(), axis=0)
    return np.concatenate([p[: int(n)] for p, n in zip(parts, lengths)], axis=0)


def allreduce_sum_scalars(values: Sequence[float]) -> np.ndarray:
    """Sum a small vector of host scalars across processes (identity
    single-process), in float64 and in process order on every process."""
    v = np.asarray(values, np.float64)
    if process_count() == 1:
        return v
    return allgather_rows(v[None, :]).sum(axis=0)


def part_path(out_path) -> str:
    """Per-process output path: ``<out>.part<i>`` multi-process, ``out``
    single-process."""
    if process_count() == 1:
        return str(out_path)
    return f"{out_path}.part{process_index()}"


def merge_part_files(out_path) -> None:
    """Merge the per-process ``<out>.part<i>`` files into ``out_path``.

    Call on every process after each wrote its part (barriers inside);
    the primary concatenates in process order and removes the parts.
    No-op single-process.  The parts must lie on storage every process
    shares; a missing part raises ``FileNotFoundError`` on every process,
    the verdict being shared before anyone raises, so that no process is
    left waiting at the last barrier."""
    n = process_count()
    if n == 1:
        return
    sync_hosts()
    missing = []
    if is_primary():
        missing = [f"{out_path}.part{i}" for i in range(n)
                   if not os.path.exists(f"{out_path}.part{i}")]
    n_missing = int(allreduce_sum_scalars([float(len(missing))])[0])
    if n_missing:
        raise FileNotFoundError(
            f"merge_part_files: the primary is missing {n_missing} part file(s)"
            f"{' ' + str(missing) if missing else ''}: part files must be written to "
            "storage shared by all processes")
    if is_primary():
        with open(out_path, "wb") as fout:
            for i in range(n):
                part = f"{out_path}.part{i}"
                with open(part, "rb") as fin:
                    shutil.copyfileobj(fin, fout)
                os.unlink(part)
    sync_hosts()


def sync_hosts() -> None:
    """Barrier across processes (no-op single-process)."""
    if process_count() > 1:
        dist.barrier()
