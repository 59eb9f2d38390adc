"""Numpy bridge between the two packages' state trees.

The JAX package's state is a tree of NamedTuples (``World``,
``RigidBodyState``, ``Vec3``...).  ``jax.tree_util.tree_map(np.asarray,
tree)`` turns it into the same tree with numpy leaves;
:func:`world_from_numpy` rebuilds it field by field as this package's
NamedTuples of tensors, matching each type by its class name, and
:func:`world_to_numpy` goes back.  Dtypes carry over unchanged (float32
values, int32 indices, bool masks).  This module imports neither JAX nor
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from mgf_tpu_torch import (
    broadphase, collision, geom, manifold, math3d, physics, solver, world,
)

_TYPES = {}
for _mod in (math3d, geom, physics, collision, manifold, solver, world,
             broadphase):
    for _name in dir(_mod):
        _obj = getattr(_mod, _name)
        if isinstance(_obj, type) and hasattr(_obj, "_fields"):
            _TYPES.setdefault(_name, _obj)


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def world_from_numpy(tree, device):
    """Convert a tree of NamedTuples with numpy leaves (from either
    package) into this package's NamedTuples of tensors on ``device``."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        name = type(tree).__name__
        if name not in _TYPES:
            raise TypeError(f"no mgf_tpu_torch counterpart for {name}")
        cls = _TYPES[name]
        fields = {f: world_from_numpy(getattr(tree, f), device)
                  for f in tree._fields if f in cls._fields}
        missing = set(tree._fields) - set(cls._fields)
        if missing:
            raise TypeError(f"{name} fields {sorted(missing)} have no "
                            f"counterpart in mgf_tpu_torch")
        return cls(**fields)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.as_tensor(np.array(tree), device=device)   # a C copy


def world_to_numpy(tree):
    """Convert this package's NamedTuples of tensors to the same tree with
    numpy leaves (python scalars pass through as numpy scalars)."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(world_to_numpy(x) for x in tree))
    if isinstance(tree, dict):
        return {k: world_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
