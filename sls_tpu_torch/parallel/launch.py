"""Start the ranks of one job on this host.

The JAX package needs nothing like this (one controller drives every
device of its host); PyTorch runs one process per rank.  ``launch``
spawns ``nprocs`` processes, joins them into one ``torch.distributed``
job through a ``file://`` rendezvous in a temporary directory (no fixed
port, so concurrent jobs on one host cannot collide), runs a picklable
function on every rank and returns the ranks' results in rank order.
A rank that raises, dies or outlasts ``timeout_s`` ends the whole job:
the other ranks, which may be waiting for it in a collective, are
killed, and the failure is raised in the caller with the rank's
traceback.  ``torchrun`` starts a job across hosts instead;
``distributed.initialize()`` reads its environment.

Rank functions must be importable by the spawned processes: module-level
functions (this package's are in ``parallel/workers.py``), not closures.
"""

from __future__ import annotations

import queue as queue_errors
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

from sls_tpu_torch.parallel import distributed as dist


def _rank_main(rank: int, nprocs: int, init_method: str, fn: Callable, args: Sequence,
               device_type: str, backend: Optional[str], timeout_s: float, results) -> None:
    try:
        if device_type == "cpu":
            torch.set_num_threads(1)  # the ranks share this host's cores
        dist.initialize(init_method, nprocs, rank, backend=backend, device_type=device_type,
                        local_processes=nprocs, timeout_s=timeout_s)
        if device_type == "cuda":
            torch.cuda.set_device(dist.local_device("cuda"))
        result = fn(*args)
        dist.sync_hosts()  # no rank leaves while another still needs it
        results.put((rank, True, result))
    except BaseException:  # reported to the parent, which ends the job
        results.put((rank, False, traceback.format_exc()))
        raise
    dist.shutdown()


def launch(fn: Callable, nprocs: int, args: Sequence = (), device_type: str = "cuda",
           backend: Optional[str] = None, timeout_s: float = 600.0) -> List:
    """Run ``fn(*args)`` on ``nprocs`` ranks of a new job on this host;
    returns their results, rank 0 first.  Inside ``fn`` the rank is
    ``distributed.process_index()`` and its device
    ``distributed.local_device(device_type)``.  The backend follows
    ``distributed.choose_backend`` unless ``backend`` names one.  Raises
    ``RuntimeError`` when a rank fails and ``TimeoutError`` when the job
    outlasts ``timeout_s``; no process outlives the call."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="sls_rendezvous_") as tmp:
        init_method = f"file://{tmp}/store"
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, nprocs, init_method, fn, tuple(args), device_type,
                                   backend, timeout_s, results))
                 for rank in range(nprocs)]
        for p in procs:
            p.start()
        try:
            out: dict = {}
            while len(out) < nprocs:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"launch: {nprocs - len(out)} of {nprocs} rank(s) gave no result "
                        f"within {timeout_s:.0f} s")
                try:
                    rank, ok, payload = results.get(timeout=0.5)
                except queue_errors.Empty:
                    dead = [i for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and i not in out]
                    if dead and results.empty():
                        raise RuntimeError(
                            f"launch: rank(s) {dead} died without a result (exit codes "
                            f"{[procs[i].exitcode for i in dead]})") from None
                    continue
                if not ok:
                    raise RuntimeError(f"launch: rank {rank} failed:\n{payload}")
                out[rank] = payload
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            return [out[rank] for rank in range(nprocs)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(30)
