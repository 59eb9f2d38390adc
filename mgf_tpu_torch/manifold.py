"""Contact pruning and manifold construction (counterpart of
``mgf_tpu.manifold``; reference: manifold.rs).

Per body pair, keep only the contacts at the earliest time of impact
(within COLLISION_EPSILON) and drop points closer than PERSISTENT_THRESHOLD
to an already-kept point, preferring the point farther from the bodies'
centers.  The reference's SmallVec becomes ``max_contacts`` fixed slots
(leading slot axis) with validity masks; its sequential push loop
(manifold.rs:72-102) is unrolled branch-free.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mgf_tpu_torch.collision import LocalContact
from mgf_tpu_torch.geom import compute_basis
from mgf_tpu_torch.math3d import (
    COLLISION_EPSILON, Vec3, magnitude2, safe_div, tree_map, where_vec,
)

# manifold.rs:38
PERSISTENT_THRESHOLD_SQ = 0.5
# manifold.rs:117 (SmallVec inline size)
MAX_CONTACTS = 4


class Manifold(NamedTuple):
    """A set of contacts between two objects (manifold.rs:112-118).
    Slot fields carry a LEADING slot axis of size S (max_contacts)."""
    time: torch.Tensor  # (...,)
    normal: Vec3        # (...,) averaged contact normal
    t1: Vec3            # friction tangent 1
    t2: Vec3            # friction tangent 2
    local_a: Vec3       # (S, ...)
    local_b: Vec3       # (S, ...)
    valid: torch.Tensor  # (S, ...) bool


def slot(tree, s):
    """Select slot s of a leading-slot-axis NamedTuple of tensors."""
    return tree_map(lambda x: x[s], tree)


def prune(lc: LocalContact, max_contacts: int = MAX_CONTACTS,
          prox_sq: float = PERSISTENT_THRESHOLD_SQ) -> Manifold:
    """Build a Manifold from a leading slot axis of LocalContacts
    (ContactPruner::push, manifold.rs:72-102, + Manifold::from,
    manifold.rs:131-148), unrolled over the incoming slots."""
    S = lc.contact.t.shape[0]
    like = lc.contact.t[0]
    min_t = torch.full_like(like, float("inf"))
    zero = Vec3(torch.zeros_like(like), torch.zeros_like(like),
                torch.zeros_like(like))
    kept_ga = [zero] * max_contacts
    kept_gb = [zero] * max_contacts
    kept_la = [zero] * max_contacts
    kept_lb = [zero] * max_contacts
    kept_n = [zero] * max_contacts
    kept_ok = [torch.zeros_like(like, dtype=torch.bool)] * max_contacts

    for s in range(S):
        t = lc.contact.t[s]
        ok = lc.contact.valid[s]
        ga, gb = lc.contact.a[s], lc.contact.b[s]
        la, lb = lc.local_a[s], lc.local_b[s]
        nn = lc.contact.n[s]

        earlier = ok & (t < min_t - COLLISION_EPSILON)
        later = t > min_t + COLLISION_EPSILON
        same = ok & ~earlier & ~later

        new_dist = magnitude2(la) + magnitude2(lb)
        matched = torch.zeros_like(ok)
        for k in range(max_contacts):
            close = (kept_ok[k]
                     & ((magnitude2(ga - kept_ga[k]) <= prox_sq)
                        | (magnitude2(gb - kept_gb[k]) <= prox_sq)))
            hit = same & ~matched & close
            replace = hit & ((magnitude2(kept_la[k]) + magnitude2(kept_lb[k]))
                             < new_dist)
            kept_ga[k] = where_vec(replace, ga, kept_ga[k])
            kept_gb[k] = where_vec(replace, gb, kept_gb[k])
            kept_la[k] = where_vec(replace, la, kept_la[k])
            kept_lb[k] = where_vec(replace, lb, kept_lb[k])
            kept_n[k] = where_vec(replace, nn, kept_n[k])
            matched = matched | hit

        append = same & ~matched
        placed = torch.zeros_like(ok)
        for k in range(max_contacts):
            free = append & ~placed & ~kept_ok[k]
            kept_ga[k] = where_vec(free, ga, kept_ga[k])
            kept_gb[k] = where_vec(free, gb, kept_gb[k])
            kept_la[k] = where_vec(free, la, kept_la[k])
            kept_lb[k] = where_vec(free, lb, kept_lb[k])
            kept_n[k] = where_vec(free, nn, kept_n[k])
            kept_ok[k] = kept_ok[k] | free
            placed = placed | free

        # an earlier contact restarts the manifold in slot 0
        kept_ok[0] = kept_ok[0] | earlier
        kept_ga[0] = where_vec(earlier, ga, kept_ga[0])
        kept_gb[0] = where_vec(earlier, gb, kept_gb[0])
        kept_la[0] = where_vec(earlier, la, kept_la[0])
        kept_lb[0] = where_vec(earlier, lb, kept_lb[0])
        kept_n[0] = where_vec(earlier, nn, kept_n[0])
        for k in range(1, max_contacts):
            kept_ok[k] = kept_ok[k] & ~earlier
        min_t = torch.where(earlier, t, min_t)

    count = sum(k.to(torch.float32) for k in kept_ok)
    n_sum = zero
    for k in range(max_contacts):
        n_sum = n_sum + where_vec(kept_ok[k], kept_n[k], zero)
    avg_n = n_sum * safe_div(1.0, count)
    t1, t2 = compute_basis(avg_n)

    stack = lambda vs: Vec3(*(torch.stack(c, dim=0) for c in zip(*vs)))
    return Manifold(
        time=torch.where(torch.isfinite(min_t), min_t, 0.0),
        normal=avg_n, t1=t1, t2=t2,
        local_a=stack(kept_la),
        local_b=stack(kept_lb),
        valid=torch.stack(kept_ok, dim=0),
    )


def manifold_from_local_contact(lc: LocalContact) -> Manifold:
    """Manifold::from(LocalContact) (manifold.rs:120-129): one point."""
    return prune(tree_map(lambda x: x.unsqueeze(0), lc),
                 max_contacts=MAX_CONTACTS)
