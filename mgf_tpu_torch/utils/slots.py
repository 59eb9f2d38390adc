"""Fixed-capacity masked slot tables (counterpart of
``mgf_tpu.utils.slots``).

The reference's ``Pool<T>`` (pool.rs:37-41) is a growable free-list slab
with stable indices.  Here it is a fixed-capacity :class:`SlotTable` whose
free list is a validity mask and whose allocation picks the first free
slot without a branch.  ``values`` is a tensor or a NamedTuple tree of
tensors with the slot axis first.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mgf_tpu_torch.math3d import tree_map


class SlotTable(NamedTuple):
    """values: a tree with leading slot axis S; valid: (S, ...) bool."""
    values: object
    valid: torch.Tensor


def slot_table(values, valid) -> SlotTable:
    return SlotTable(values=values, valid=valid)


def slot_insert(table: SlotTable, value, enable=True) -> SlotTable:
    """Write ``value`` into the first free slot (Pool::push, pool.rs:81-96:
    freed slots are reused first).  Capacity is fixed: an insert into a
    full table is dropped, and :func:`slot_overflow` counts it."""
    free = ~table.valid
    first_free_rank = torch.cumsum(free.to(torch.int32), dim=0,
                                   dtype=torch.int32)
    is_target = free & (first_free_rank == 1) & enable

    def put(slots, v):
        cond = is_target.reshape(is_target.shape
                                 + (1,) * (slots.dim() - is_target.dim()))
        v = torch.as_tensor(v, dtype=slots.dtype, device=slots.device)
        return torch.where(cond, v.broadcast_to(slots.shape), slots)

    return SlotTable(values=tree_map(put, table.values, value),
                     valid=table.valid | is_target)


def slot_remove(table: SlotTable, index) -> SlotTable:
    """Invalidate slot ``index`` (Pool::remove, pool.rs:100-113: the other
    slots keep their indices)."""
    s = table.valid.shape[0]
    mask = torch.arange(s, device=table.valid.device) == index
    mask = mask.reshape(mask.shape + (1,) * (table.valid.dim() - 1))
    return table._replace(valid=table.valid & ~mask)


def slot_overflow(table: SlotTable, wanted):
    """How many inserts were dropped because the table was full."""
    return torch.clamp(wanted - torch.sum(table.valid, dim=0,
                                          dtype=torch.int32), min=0)
