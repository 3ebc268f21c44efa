"""A mesh of ranks, counterpart of ``sls_tpu/parallel/mesh.py``.

The JAX package lays devices out on a named mesh and lets the compiler
derive the collectives.  Here a ``Mesh`` lays the job's ranks out on
named axes and holds one ``ProcessGroup`` per axis (the ranks that
differ from this one in that coordinate only); the code that runs on it
calls the collectives itself.  ``make_mesh`` must be called by every
rank of the job, with the same arguments and in the same order among
other group-creating calls: ``torch.distributed.new_group`` is itself a
collective.  Without a process group the only mesh is the one-rank mesh,
whose collectives are the identity.

``SeqShard`` says how one ``[B, T, C]`` activation is cut over a
``('data', 'seq')`` mesh, and carries the collectives that the
sequence-parallel encoder, SAE and head need across the cut.
``pad_batch_to_devices`` is an own copy of the reference's batch padding.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sls_tpu_torch.parallel.distributed import all_gather_cat, process_count, process_index


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks ``ranks[0] .. ranks[-1]`` laid out row-major on ``axis_names``
    with sizes ``shape``; ``coords`` is this rank's place and ``groups``
    its process group along each axis (None on an axis of size 1 or when
    this rank is not part of the mesh)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    ranks: Tuple[int, ...]
    coords: Optional[Dict[str, int]]
    groups: Dict[str, Optional[dist.ProcessGroup]]


def axis_of(mesh: Optional[Mesh], name: str) -> Tuple[Optional[dist.ProcessGroup], int, int]:
    """(this rank's process group, its index, the axis's size) along
    ``name``: (None, 0, 1) with no mesh, an axis the mesh lacks or one of
    size 1, whose collectives are the identity."""
    if mesh is None or mesh.shape.get(name, 1) == 1 or mesh.coords is None:
        return None, 0, 1
    return mesh.groups[name], mesh.coords[name], mesh.shape[name]


def make_mesh(axis_names: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build a mesh over all (or the given) ranks of the job.

    Default: a 1-D 'data' mesh of every rank.  ``shape`` lays the ranks
    out row-major on several axes, e.g. (2, 2) with ('data', 'seq').
    Every rank of the job must make the call, also one that is not in
    ``ranks`` (it takes part in creating the groups and gets a mesh with
    ``coords`` None)."""
    world = process_count()
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (len(ranks),) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != len(ranks):
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does not hold "
                         f"{len(ranks)} rank(s)")
    if max(ranks) >= world or len(set(ranks)) != len(ranks):
        raise ValueError(f"mesh ranks {ranks} are not distinct ranks of a job of {world}")
    grid = np.asarray(ranks).reshape(shape)
    me = process_index()
    where = np.argwhere(grid == me)
    coords = dict(zip(axis_names, map(int, where[0]))) if len(where) else None
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for axis, name in enumerate(axis_names):
        groups[name] = None
        if shape[axis] == 1:
            continue
        others = [range(s) for i, s in enumerate(shape) if i != axis]
        for fixed in itertools.product(*others):
            index = list(fixed)
            index.insert(axis, slice(None))
            members = [int(r) for r in grid[tuple(index)]]
            group = dist.new_group(members)  # every rank creates every group
            if me in members:
                groups[name] = group
    return Mesh(axis_names, dict(zip(axis_names, shape)), ranks, coords, groups)


class SeqShard:
    """How this rank cuts a ``[B, T, C]`` activation of ``rows`` x
    ``frames`` on a mesh whose ``seq_axis`` shards frames and whose
    'data' axis (if any) shards rows.

    Frames are cut into ``n_seq`` chunks of ceil(T / n_seq); the last
    chunks may be short or empty, and the gathers pad and trim them.
    Rows are cut only when the data axis divides them (the reference's
    kernel gate asks the same); otherwise every data coordinate keeps
    all rows and computes the same values."""

    def __init__(self, mesh: Mesh, seq_axis: str, rows: int, frames: int):
        if seq_axis not in mesh.axis_names:
            raise ValueError(f"seq_axis={seq_axis!r} is not an axis of mesh {mesh.axis_names}")
        if mesh.coords is None:
            raise ValueError("this rank is not part of the mesh")
        self.rows, self.frames = rows, frames
        self.n_seq = mesh.shape[seq_axis]
        self.seq_index = mesh.coords[seq_axis]
        self.seq_group = mesh.groups[seq_axis]
        n_data = mesh.shape.get("data", 1) if seq_axis != "data" else 1
        self.rows_divide = rows % n_data == 0
        self.n_data = n_data if self.rows_divide else 1
        self.data_index = mesh.coords.get("data", 0) if self.n_data > 1 else 0
        self.data_group = mesh.groups.get("data") if self.n_data > 1 else None
        self.chunk = -(-frames // self.n_seq)

    @property
    def even(self) -> bool:
        """Every rank holds the same number of frames."""
        return self.frames % self.n_seq == 0

    def take_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full-batch tensor."""
        n = self.rows // self.n_data
        return x[self.data_index * n:(self.data_index + 1) * n]

    def take_frames(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's frames of a ``[b, T, ...]`` tensor."""
        lo = self.seq_index * self.chunk
        return x[:, lo:lo + self.chunk]

    def gather_frames(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """``[b, T_loc, ...]`` shards -> the whole ``[b, T, ...]`` on every
        rank of the seq group (``dim`` is the frames' axis)."""
        if self.n_seq == 1:
            return x
        if not self.even:
            pad = list(x.shape)
            pad[dim] = self.chunk - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        return all_gather_cat(x, self.seq_group, dim=dim).narrow(dim, 0, self.frames)

    def sum_frames(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of every seq rank's ``x`` (a sum over local frames becomes
        the sum over all frames)."""
        if self.n_seq > 1:
            x = x.contiguous()
            dist.all_reduce(x, group=self.seq_group)
        return x

    def sum_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of every data rank's ``x`` where rows are cut."""
        if self.n_data > 1:
            x = x.contiguous()
            dist.all_reduce(x, group=self.data_group)
        return x

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``[B / n_data, ...]`` per data coordinate -> ``[B, ...]``."""
        if self.n_data == 1:
            return x
        return all_gather_cat(x, self.data_group, dim=0)


def pad_batch_to_devices(mesh: Mesh, wav, labels=None, valid=None, axis: str = "data"):
    """Pad a batch so that it divides the mesh's data axis, which cuts it
    by rows (every rank of the mesh is handed the same batch).  Padding
    rows repeat row 0 and are marked invalid; losses and metrics mask
    them out.  Returns (wav, labels, valid) as numpy arrays."""
    wav = np.asarray(wav)
    n = wav.shape[0]
    n_dev = max(1, mesh.shape.get(axis, 1))
    if valid is None:
        valid = np.ones(n, bool)
    else:
        valid = np.asarray(valid, bool)
    pad = (-n) % n_dev
    if pad:
        wav = np.concatenate([wav, np.repeat(wav[:1], pad, axis=0)])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
        if labels is not None:
            labels = np.asarray(labels)
            labels = np.concatenate([labels, np.repeat(labels[:1], pad)])
    return wav, (None if labels is None else np.asarray(labels)), valid
