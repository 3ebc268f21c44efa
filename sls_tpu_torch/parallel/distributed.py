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
  ``allreduce_sum_scalars``, over the world or one mesh axis's group), a
  tensor collective for activations (``all_gather_cat``), IO gating
  (``is_primary``), per-process part files (``part_path``,
  ``merge_part_files``) and a barrier (``sync_hosts``).  All of them are
  the identity in a single process.
- The batch of a data-parallel step (``global_batch``, ``fetch_global``,
  ``local_rows``).  The reference builds one array whose rows span the
  processes; here each rank holds its own rows and the global batch is
  their concatenation in rank order over the mesh's 'data' group, which
  is what these helpers read and gather.
- Loss terms across ranks: ``sum_over`` (an all-reduce whose backward
  sums the ranks' gradients, as ``torch.distributed.nn.functional``'s)
  and ``gather_over`` (an all-gather whose backward hands each rank the
  summed gradient of its own rows).  A rank
  computes its share of a global loss, the shares summing to the
  reference's value, and the gradient all-reduce of the step sums the
  shares' gradients.
"""

from __future__ import annotations

import datetime
import os
import shutil
import socket
from typing import Any, Optional, Sequence, Tuple

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


def group_size(group=None) -> int:
    """Ranks in ``group`` (None: the world; 1 with no process group)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def allgather_rows(x, group=None) -> np.ndarray:
    """Concatenate per-process host arrays (same shape everywhere) in
    process order over ``group`` (None: every process).  Identity
    single-process."""
    x = np.asarray(x)
    if group_size(group) == 1:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x)).to(_collective_device())
    return all_gather_cat(t, group, dim=0).cpu().numpy()


def allgather_ragged_rows(x, group=None) -> np.ndarray:
    """``allgather_rows`` for per-process arrays of unequal leading size:
    pads to the group's max, gathers, and drops the padding.  Identity
    single-process."""
    x = np.asarray(x)
    if group_size(group) == 1:
        return x
    lengths = allgather_rows(np.asarray([x.shape[0]], np.int64), group)
    max_len = int(lengths.max())
    pad = np.zeros((max_len - x.shape[0],) + x.shape[1:], x.dtype)
    gathered = allgather_rows(np.concatenate([x, pad], axis=0), group)
    parts = np.split(gathered, group_size(group), axis=0)
    return np.concatenate([p[: int(n)] for p, n in zip(parts, lengths)], axis=0)


def allreduce_sum_scalars(values: Sequence[float], group=None) -> np.ndarray:
    """Sum a small vector of host scalars across the processes of
    ``group`` (None: all; identity single-process), in float64 and in
    process order on every process."""
    v = np.asarray(values, np.float64)
    if group_size(group) == 1:
        return v
    return allgather_rows(v[None, :], group).sum(axis=0)


# -- the global batch of a data-parallel step ---------------------------------------


def to_device(x, dev: torch.device) -> torch.Tensor:
    """``x`` (numpy or tensor) on ``dev``, without waiting for the device:
    a host array bound for a card goes up from pinned memory (a pageable
    copy would wait)."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    if dev.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def global_batch(tree: Sequence[Any], mesh=None, axis: str = "data",
                 device: Optional[torch.device] = None) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """(this rank's rows of each array of ``tree`` on ``device``, the
    global batch's row count over the mesh's ``axis`` group).

    Counterpart of the reference's ``global_batch``: every rank passes
    its own rows (its ``host_shard``), all ranks the same number of them
    (``host_shard(..., drop_remainder=True)``), and the global batch is
    their concatenation in rank order.  The rows stay where they are;
    the count is the local count times the group's size (no collective).
    ``device`` defaults to this rank's card.  Single-process, or with no
    mesh: the rows on the device and their own count."""
    dev = torch.device(device) if device is not None else local_device()
    arrays = tuple(to_device(x, dev) for x in tree)
    n_local = int(arrays[0].shape[0]) if arrays else 0
    group = mesh.groups.get(axis) if mesh is not None else None
    return arrays, n_local * group_size(group)


def fetch_global(x, mesh=None, axis: str = "data") -> np.ndarray:
    """The global batch's rows of a per-rank array, on the host: every
    rank's ``x`` (same shape everywhere) gathered over the mesh's
    ``axis`` group in rank order.  Every rank of the group must call it.
    Single-process, or with no mesh: ``x`` on the host."""
    group = mesh.groups.get(axis) if mesh is not None else None
    if torch.is_tensor(x):
        x = x.detach()
        if group_size(group) == 1:
            return x.cpu().numpy()
        return all_gather_cat(x.to(_collective_device()), group, dim=0).cpu().numpy()
    return allgather_rows(np.asarray(x), group) if group_size(group) > 1 else np.asarray(x)


def local_rows(x) -> np.ndarray:
    """This rank's rows of a batch-sharded array, on the host.  Each rank
    already holds only its own rows, so this is the identity (the
    reference's slices its process's block out of a global array)."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# -- loss terms across ranks -----------------------------------------------------------


class _SumOver(torch.autograd.Function):
    """An all-reduce (SUM) whose backward all-reduces the gradient: the
    semantics of ``torch.distributed.nn.functional.all_reduce``, which
    recent PyTorch marks deprecated."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, differentiable: the
    backward sums the ranks' incoming gradients, which is the gradient
    of a loss that is the sum of every rank's term.  ``x`` itself with no
    group."""
    if group is None or group_size(group) == 1:
        return x
    return _SumOver.apply(x, group)


class _GatherOver(torch.autograd.Function):
    """``all_gather_cat`` along ``dim`` whose backward sums the ranks'
    gradients of the whole gathered tensor and hands each rank its own
    slice.  ``torch.distributed.nn.functional.all_gather`` reduces the
    gradient by an all-to-all under gloo, which gloo does not take for
    CUDA tensors; one all-reduce of the (small) gathered gradient does
    the same on every backend."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return all_gather_cat(x, group, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


def gather_over(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` over ``group`` concatenated along ``dim`` in rank
    order, differentiable for a loss that is the sum of every rank's
    term (``_GatherOver``).  ``x`` itself with no group."""
    if group is None or group_size(group) == 1:
        return x
    return _GatherOver.apply(x, group, dim)


def host_count() -> int:
    """Hosts the job spans: distinct host names among its processes
    (a collective; 1 single-process)."""
    if process_count() == 1:
        return 1
    names: list = [None] * process_count()
    dist.all_gather_object(names, socket.gethostname())
    return len(set(names))


def part_path(out_path, index: Optional[int] = None, count: Optional[int] = None) -> str:
    """Per-process output path: ``<out>.part<i>`` multi-process, ``out``
    single-process.  ``index`` / ``count`` name the part and the number
    of parts when they are not the process's (one writer per data
    coordinate of a tensor-parallel job)."""
    if (process_count() if count is None else count) == 1:
        return str(out_path)
    return f"{out_path}.part{process_index() if index is None else index}"


def merge_part_files(out_path, count: Optional[int] = None) -> None:
    """Merge the per-process ``<out>.part<i>`` files (``count`` of them,
    default one a process) into ``out_path``.

    Call on every process after each wrote its part (barriers inside);
    the primary concatenates in process order and removes the parts.
    No-op single-process.  The parts must lie on storage every process
    shares; a missing part raises ``FileNotFoundError`` on every process,
    the verdict being shared before anyone raises, so that no process is
    left waiting at the last barrier."""
    if process_count() == 1:
        return
    n = process_count() if count is None else count
    sync_hosts()
    if n == 1:  # one writer wrote ``out_path`` itself
        return
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
