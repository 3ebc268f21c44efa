"""Tensor parallelism over a ('data', 'model') mesh, counterpart of
``sls_tpu/parallel/tensor.py``.

The wide dimensions (the transformer FFN's 4096, the SAE dictionary's
4096, the classifier's hidden width) are cut over the mesh's 'model'
axis, Megatron style (Shoeybi et al. 2019).  The reference only
annotates the layout (``_RULES``) and lets its compiler insert the
collectives; the port applies the same rules to its own parameter names
and writes the collectives out:

- ``fc1.weight [F, D]`` and ``fc1.bias [F]`` are cut by output (the
  reference's ``fc1/kernel [D, F]`` by columns), ``fc2.weight [D, F]``
  by input (its ``fc2/kernel [F, D]`` by rows); ``W_enc [D, M]`` and
  ``b_enc [M]`` by dictionary column, ``W_dec [M, D]`` by row.  A tensor
  whose cut dimension does not divide the axis stays whole on every rank
  (``spec_for_path``), as in the reference.
- Forward: a column-parallel layer takes its input through
  ``copy_to_model`` (the identity; its backward sums the ranks'
  gradients) and computes its own outputs; a row-parallel layer sums
  its partial products over 'model' with ``reduce_from_model`` (an
  all-reduce; its backward is the identity), in fp32, then rounds to
  the layer's dtype once, as the whole product is rounded.  The SAE
  encode runs on the rank's ``W_enc`` columns, the pre-activations are
  gathered over 'model' (``gather_from_model``) so that the top-k sees
  the whole dictionary (the gather the reference's compiler inserts),
  the codes are cut back to the rank's columns (``cut_to_model``) and
  ``W_dec``'s rows and an all-reduce finish the decode.  A dropout mask
  inside a cut layer is drawn at the whole width and cut, so the ranks'
  masks are the unsharded layer's.  What is not cut runs whole and
  alike on every rank of the 'model' group, which hold the same rows.
- ``shard_model_`` cuts a whole model's parameters in place and marks
  the modules that run cut (``tp``); Adam's moments are made over the
  cut parameters, so they are cut with them.  ``gather_train_tree``
  gathers a train state's tensors whole (checkpoints hold whole
  tensors, so a tensor-parallel run's files load anywhere) and
  ``shard_train_tree`` cuts a whole one back.
- ``tp_mesh_and_config`` builds the mesh over the job's ranks and turns
  ``sae.use_pallas`` off, as the reference does: the kernels need the
  whole dictionary, so under TP rows 1-3 and 5 are not launched.  The
  reference also forces ``grouped_conv_einsum``, around a fault of its
  compiler that scales grouped-conv weight gradients by the size of an
  unused mesh axis (``tests/test_tensor_parallel.py``).  PyTorch has no
  such fault, the pos-conv is not cut, and the two routes compute the
  same function, so the port keeps the configured route (cuDNN's
  grouped conv by default; the per-tap einsum costs ~20x its time).
- Tensor parallelism runs on one host: across hosts it is refused with
  the reference's reason (``tp_mesh_and_config``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from sls_tpu_torch.parallel.distributed import all_gather_cat, host_count, process_count
from sls_tpu_torch.parallel.mesh import Mesh, axis_of, make_mesh

Spec = Tuple[Optional[str], ...]  # one mesh axis (or None) per dimension; () = whole

# (suffix of the parameter's name) -> the dimension cut over the axis, in
# the port's layouts (a Linear's weight is [out, in])
_RULES = (
    (("fc1", "weight"), 0),
    (("fc1", "bias"), 0),
    (("fc2", "weight"), 1),
    (("W_enc",), 1),
    (("b_enc",), 0),
    (("W_dec",), 0),
)

CROSS_HOST_REASON = (
    "model_parallel > 1 is single-host BY DESIGN: at 0.3B params the state fits one card "
    "several times over, so cross-host TP would trade a once-per-step 1.3 GB gradient "
    "all-reduce (DP) for per-LAYER activation collectives between hosts, strictly slower "
    "at every scale this model reaches.  Scale across hosts with data parallelism.")


def _names(path: Union[str, Sequence]) -> Tuple[str, ...]:
    return tuple(path.split(".")) if isinstance(path, str) else tuple(str(p) for p in path)


def spec_for_path(path: Union[str, Sequence], leaf, axis: str, n_shards: int) -> Spec:
    """The spec of one state tensor named ``path`` (dotted, or a sequence
    of names): ``axis`` on the dimension a rule cuts, else whole (``()``),
    also when that dimension does not divide ``n_shards``."""
    names = _names(path)
    for suffix, dim in _RULES:
        if names[-len(suffix):] == suffix:
            shape = tuple(leaf.shape)
            if len(shape) <= dim or shape[dim] % n_shards:
                return ()
            return tuple(axis if d == dim else None for d in range(len(shape)))
    return ()


def cut_dim(spec: Spec) -> Optional[int]:
    """The dimension ``spec`` cuts, None for a whole tensor."""
    return next((d for d, ax in enumerate(spec) if ax is not None), None)


def state_shardings(model: nn.Module, mesh: Mesh, axis: str = "model",
                    trainable: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, Spec]]:
    """The spec of every tensor of a train state over ``model`` (whole):
    its ``params`` (and buffers) by name, and Adam's two moments, which
    mirror the ``trainable`` parameters (default all) and are cut
    alike, as the reference's optimizer state mirrors its params."""
    n = mesh.shape[axis]
    params = {name: spec_for_path(name, t, axis, n) for name, t in model.state_dict().items()}
    trainable = [name for name, _ in model.named_parameters()] if trainable is None \
        else list(trainable)
    moments = {name: params[name] for name in trainable}
    return {"params": params, "exp_avg": dict(moments), "exp_avg_sq": dict(moments)}


def count_sharded(shardings: Mapping[str, Any]) -> int:
    """Number of cut tensors in a ``state_shardings`` tree (logs, tests)."""
    return sum(count_sharded(v) if isinstance(v, Mapping) else int(v != ())
               for v in shardings.values())


def tp_mesh_and_config(cfg, ranks: Optional[int] = None):
    """(the ('data', 'model') mesh of ``cfg.train.model_parallel`` over
    the job's first ``ranks`` ranks (default all), ``cfg`` with
    ``sae.use_pallas`` off).  Every rank of the job must call it (it
    creates process groups).  Raises when ``model_parallel`` does not
    divide the ranks, or when the job spans hosts (module docstring)."""
    mp = cfg.train.model_parallel
    world = process_count() if ranks is None else ranks
    if world % mp:
        raise ValueError(f"model_parallel={mp} must divide the job's {world} rank(s): "
                         "start the job with a multiple of it")
    if host_count() > 1:
        raise ValueError(CROSS_HOST_REASON)
    mesh = make_mesh(("data", "model"), shape=(world // mp, mp), ranks=range(world))
    model_cfg = cfg.model
    if model_cfg.use_sae and model_cfg.sae.use_pallas:
        print("NOTE: model_parallel > 1 disables the hand-written SAE kernels (they need "
              "the whole dictionary); using the plain SAE path", flush=True)
        model_cfg = dataclasses.replace(
            model_cfg, sae=dataclasses.replace(model_cfg.sae, use_pallas=False))
        cfg = dataclasses.replace(cfg, model=model_cfg)
    return mesh, cfg


# -- the cut forward ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place on the 'model' axis: its process group, index
    and the axis's size."""

    group: Any
    index: int
    size: int

    def cols(self, n: int) -> slice:
        """This rank's block of a dimension of ``n`` (whole) entries."""
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.shard.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=shard.group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim, ctx.n = shard, dim, x.shape[dim]
        return all_gather_cat(x, shard.group, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.shard.index * ctx.n, ctx.n), None, None


class _CutToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        n = x.shape[dim] // shard.size
        return x.narrow(dim, shard.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad.contiguous(), ctx.shard.group, dim=ctx.dim), None, None


def copy_to_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The input of a column-parallel layer: ``x`` itself; the backward
    sums the ranks' gradients of it."""
    return _CopyToModel.apply(x, shard)


def reduce_from_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The sum of the ranks' partial products; the backward hands each
    rank the (whole, alike) gradient."""
    return _ReduceFromModel.apply(x, shard)


def gather_from_model(x: torch.Tensor, shard: ModelShard, dim: int = -1) -> torch.Tensor:
    """The ranks' column blocks concatenated along ``dim``; the backward
    keeps this rank's block of the (alike) gradient."""
    return _GatherFromModel.apply(x, shard, dim % x.dim())


def cut_to_model(x: torch.Tensor, shard: ModelShard, dim: int = -1) -> torch.Tensor:
    """This rank's block of a whole (alike) tensor along ``dim``; the
    backward gathers the ranks' blocks of the gradient."""
    return _CutToModel.apply(x, shard, dim % x.dim())


def column_linear(dense, x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """A cut ``Dense`` (``encoder/xlsr.py``) on its output: this rank's
    outputs, in the layer's dtype with its bias."""
    dt = dense.dtype
    return torch.nn.functional.linear(copy_to_model(x, shard).to(dt), dense.weight.to(dt),
                                      dense.bias.to(dt))


def row_linear(dense, x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """A ``Dense`` cut on its input, over this rank's block ``x``: exact
    products of the operands rounded to the layer's dtype, summed in
    fp32 over the block and over the ranks, rounded once to the dtype,
    then the (whole) bias added in the dtype."""
    dt = dense.dtype
    part = torch.nn.functional.linear(x.to(dt).float(), dense.weight.to(dt).float())
    return reduce_from_model(part, shard).to(dt) + dense.bias.to(dt)


def cut_dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator],
                shard: ModelShard) -> torch.Tensor:
    """flax ``nn.Dropout`` on this rank's block of the last dimension: the
    mask is drawn at the whole width from ``generator`` (alike on the
    'model' group) and cut, so it is the unsharded layer's mask."""
    if generator is None or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    whole = tuple(x.shape[:-1]) + (x.shape[-1] * shard.size,)
    keep = torch.rand(whole, generator=generator, device=x.device) >= p
    return torch.where(keep[..., shard.cols(whole[-1])], x / (1.0 - p), 0.0)


# -- cutting a model and its state ---------------------------------------------------------


def model_shard(mesh: Mesh, axis: str = "model") -> Optional[ModelShard]:
    """This rank's ``ModelShard`` on ``mesh`` (None without a 'model'
    axis of more than one rank)."""
    group, index, size = axis_of(mesh, axis)
    return None if size == 1 else ModelShard(group, index, size)


def _cut(t: torch.Tensor, spec: Spec, shard: ModelShard) -> torch.Tensor:
    dim = cut_dim(spec)
    if dim is None:
        return t
    n = t.shape[dim] // shard.size
    return t.narrow(dim, shard.index * n, n)


def _whole(t: torch.Tensor, spec: Spec, shard: ModelShard) -> torch.Tensor:
    dim = cut_dim(spec)
    if dim is None:
        return t
    return all_gather_cat(t.contiguous(), shard.group, dim=dim)


@torch.no_grad()
def shard_model_(model: nn.Module, specs: Mapping[str, Spec], shard: ModelShard) -> None:
    """Cut ``model``'s parameters named in ``specs`` to this rank's block,
    in place (new ``nn.Parameter`` objects), and set ``tp`` on the nearest
    module above each cut parameter that runs a cut forward (one whose
    class defines ``tp``: the transformer layer, the SAE, the classifier)."""
    modules = dict(model.named_modules())
    for name, param in list(model.named_parameters()):
        spec = specs.get(name, ())
        if cut_dim(spec) is None:
            continue
        owner, attr = name.rpartition(".")[::2]
        setattr(modules[owner], attr, nn.Parameter(_cut(param, spec, shard).clone(),
                                                   requires_grad=param.requires_grad))
        parts = owner.split(".") if owner else []
        runner = next((modules[p] for p in (".".join(parts[:k]) for k in
                                            range(len(parts), -1, -1))
                       if hasattr(type(modules[p]), "tp")), None)
        if runner is None:
            raise ValueError(f"{name} is cut but no module above it runs a cut forward")
        runner.tp = shard


def _moment_views(flat: torch.Tensor, shapes: Sequence[torch.Size]):
    return [v.view(s) for v, s in zip(flat.split([s.numel() for s in shapes]), shapes)]


def gather_train_tree(tree: Dict, specs: Mapping[str, Spec], shard: ModelShard) -> Dict:
    """A ``train_state_tree`` of cut tensors -> the same with whole ones
    (the model's state dict and both flat moments).  Every rank of the
    'model' group must call it."""
    model = {k: _whole(v, specs.get(k, ()), shard) for k, v in tree["model"].items()}
    local = [tree["model"][n].shape for n in tree["names"]]
    out = dict(tree, model=model)
    for key in ("exp_avg", "exp_avg_sq"):
        parts = [_whole(v, specs.get(n, ()), shard).reshape(-1)
                 for n, v in zip(tree["names"], _moment_views(tree[key], local))]
        out[key] = torch.cat(parts)
    return out


def cut_state_dict(state: Mapping[str, torch.Tensor], specs: Mapping[str, Spec],
                   shard: ModelShard) -> Dict[str, torch.Tensor]:
    """A whole model's state dict -> this rank's blocks of it."""
    return {k: _cut(torch.as_tensor(v), specs.get(k, ()), shard).contiguous()
            for k, v in state.items()}


def shard_train_tree(tree: Dict, specs: Mapping[str, Spec], shard: ModelShard) -> Dict:
    """A ``train_state_tree`` of whole tensors (a checkpoint) -> this
    rank's blocks of it."""
    model = cut_state_dict(tree["model"], specs, shard)
    whole = [torch.as_tensor(tree["model"][n]).shape for n in tree["names"]]
    out = dict(tree, model=model)
    for key in ("exp_avg", "exp_avg_sq"):
        flat = torch.as_tensor(tree[key])
        out[key] = torch.cat([_cut(v, specs.get(n, ()), shard).reshape(-1)
                              for n, v in zip(tree["names"], _moment_views(flat, whole))])
    return out
