"""Checkpoint / resume (counterpart of ``mgf_tpu.utils.checkpoint``).

The whole :class:`~mgf_tpu_torch.world.World` is one tree of NamedTuples,
so a checkpoint is a flat ``.npz``: one array per tensor leaf, keyed by
its field path (``bodies/x/x``, ``bp/count``, ...), the keys the JAX
package's ``tree_flatten_with_path`` gives.  ``None`` fields have no key,
and dtypes are kept (float32, int32, bool).  So a file either package
saves loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten_with_paths(tree, prefix=()):
    """[(key, tensor)] over a tree of NamedTuples, in field order."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for name in tree._fields
                for kv in _flatten_with_paths(getattr(tree, name),
                                              prefix + (name,))]
    return [("/".join(prefix), tree)]


def _unflatten(like, load, prefix=()):
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), load,
                                       prefix + (f,)) for f in like._fields))
    return load("/".join(prefix), like)


def save_world(path: str, world, use_orbax: bool = False):
    """Serialize a World (or any NamedTuple tree of tensors) to ``path``
    (``.npz`` is appended when missing)."""
    if use_orbax:
        raise ValueError(
            "use_orbax: orbax is a JAX checkpointer and this package has no "
            "JAX; save_world writes the .npz that both packages read")
    arrays = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v))
              for k, v in _flatten_with_paths(world)}
    np.savez_compressed(path, **arrays)


def load_world(path: str, like):
    """Load a tree saved by :func:`save_world` (or by the JAX package's)
    into the structure of ``like``, a template World with the same fields
    and shapes; each tensor goes to the device of ``like``'s leaf."""
    data = np.load(path if str(path).endswith(".npz") else path + ".npz")
    load = lambda key, leaf: torch.as_tensor(
        data[key], device=leaf.device if isinstance(leaf, torch.Tensor)
        else None)
    return _unflatten(like, load)
