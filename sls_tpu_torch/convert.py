"""Weights bridge: the JAX ``Detector``'s params -> this package's state dict.

``detector_state_from_flax(params)`` takes the flax param tree as a
nested dict of arrays (numpy, or anything ``np.asarray`` accepts) and
returns a state dict that ``Detector.load_state_dict(strict=True)``
takes.  The naming follows the flax scopes:

- ``layer_{i}`` -> ``layers.{i}``, ``conv_{i}`` -> ``conv.{i}``,
  ``norm_{i}`` -> ``norm.{i}``; the ``LayerNorm_0`` / ``GroupNorm_0``
  scope of ``Fp32LayerNorm`` and of the extractor's norms is dropped;
- ``scale`` -> ``weight``; a 2-D Dense ``kernel`` [in, out] -> ``weight``
  [out, in]; a 3-D conv ``kernel`` [K, in, out] -> ``weight``
  [out, in, K] (the grouped pos-conv's [K, C/G, C] -> [C, C/G, K]);
- the SAE's ``W_enc``, ``W_dec``, ``b_enc``, ``b_dec`` keep their names
  and layouts.

Tensors come back as views of the given arrays where those are
writable (transposes are strided views); ``load_state_dict`` copies them.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_INDEXED = re.compile(r"^(layer|conv|norm)_(\d+)$")
_NORM_SCOPES = ("LayerNorm_0", "GroupNorm_0")


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def torch_entry(path: Tuple[str, ...], ndim: int) -> Tuple[str, Tuple[int, ...]]:
    """(state-dict key, axis permutation) for one flax param path."""
    parts = []
    for p in path[:-1]:
        if p in _NORM_SCOPES:
            continue
        m = _INDEXED.match(p)
        if m:
            name, idx = m.groups()
            parts += ["layers" if name == "layer" else name, idx]
        else:
            parts.append(p)
    leaf = path[-1]
    perm = tuple(range(ndim))
    if leaf == "scale":
        leaf = "weight"
    elif leaf == "kernel":
        leaf = "weight"
        perm = tuple(reversed(range(ndim)))  # [in,out]->[out,in]; [K,in,out]->[out,in,K]
    return ".".join(parts + [leaf]), perm


def detector_state_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for ``sls_tpu_torch.models.detector.Detector`` from the
    JAX ``Detector``'s ``params`` (the tree under ``variables['params']``)."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        arr = np.asarray(value)
        if not arr.flags.writeable:  # torch tensors cannot share read-only memory
            arr = arr.copy()
        key, perm = torch_entry(path, arr.ndim)
        state[key] = torch.from_numpy(arr).permute(perm)
    return state
