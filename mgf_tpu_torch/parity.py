"""Contact-stream parity against the f64 oracle: the resync harness.

The port's copy of the diff harness the JAX package keeps in
``tests/test_oracle.py`` (``_contact_dict``, ``_pair_set``,
``_terrain_set``, ``_oracle_sets``, ``_diff_streams``) and of the resync
loop of ``scripts/parity_curves.py`` and ``scripts/mixed_resync.py``:

* :func:`diff_streams` diffs one step's contact streams (``step(...,
  collect_contacts=True)``, the JAX package's layout) against the oracle's
  records of the same step, contact for contact;
* :func:`oracle_trajectory` runs the oracle alone: ``settle`` steps, then
  the states and records of ``steps`` more;
* :func:`resync` pushes each of those oracle states into the port's step
  and diffs the two streams, so every step starts from the reference's
  state and the drift of a free run never enters the comparison.

Host code on numpy; the step it referees runs wherever the world lies.
"""

from __future__ import annotations

import numpy as np

from mgf_tpu_torch import oracle
from mgf_tpu_torch.bridge import world_to_numpy
from mgf_tpu_torch.world import step


def _take(tree, s):
    """Slot ``s`` of every leaf of a tree of NamedTuples of arrays."""
    if isinstance(tree, tuple):
        return type(tree)(*(_take(x, s) for x in tree))
    return np.asarray(tree[s])


def _contact_dict(idx_a, idx_b, contact):
    """(a, b, slot) -> (t, n, a, b) dict over ALL contact slots."""
    ia = np.asarray(idx_a)
    ib = np.asarray(idx_b)
    out = {}
    S = contact.valid.shape[0]
    for s in range(S):
        c = _take(contact, s)
        nn = np.stack([c.n.x, c.n.y, c.n.z], -1)
        aa = np.stack([c.a.x, c.a.y, c.a.z], -1)
        bb = np.stack([c.b.x, c.b.y, c.b.z], -1)
        for k in np.nonzero(c.valid)[0]:
            out[(int(ia[k]), int(ib[k]), s)] = (float(c.t[k]), nn[k],
                                                aa[k], bb[k])
    return out


def _pair_set(m):
    """The rows form emits each pair twice ((i,j) and its mirror (j,i));
    canonicalize to the oracle's receiver-has-larger-index orientation."""
    raw = _contact_dict(m["pair_contacts"]["i"], m["pair_contacts"]["j"],
                        m["pair_contacts"]["contact"])
    out = {}
    for (i, j, s), (t, n, a, b) in raw.items():
        if i > j:
            out[(i, j, s)] = (t, n, a, b)
        elif (j, i, s) not in out:
            out[(j, i, s)] = (t, -n, b, a)
    return out


def _terrain_set(m):
    return _contact_dict(m["terrain_contacts"]["i"],
                         m["terrain_contacts"]["tri"],
                         m["terrain_contacts"]["contact"])


def _oracle_sets(rec):
    pairs, terr = {}, {}
    for k in range(len(rec["kind"])):
        val = (float(rec["t"][k]), rec["n"][k], rec["pa"][k], rec["pb"][k])
        if rec["kind"][k] == 0:
            # terrain j encodes tri * 2 + slot (capsules emit two slots)
            j = int(rec["j"][k])
            terr[(int(rec["i"][k]), j >> 1, j & 1)] = val
        else:
            # pair slot: 0 except capsule-pair "ends" second endpoints
            s = int(rec["slot"][k]) if "slot" in rec else 0
            pairs[(int(rec["i"][k]), int(rec["j"][k]), s)] = val
    return pairs, terr


def new_worst():
    """The running worst of :func:`diff_streams`."""
    return dict(dt=0.0, dn=0.0, dp=0.0, miss=0, total=0)


def diff_streams(m, rec, worst):
    """Fold one step's streams into ``worst``: ``miss`` counts the contacts
    only one side has (both streams), ``total`` the larger side's count
    (at least 1 a stream), and ``dt`` / ``dn`` / ``dp`` the largest time,
    normal and witness-point deltas over the contacts both sides have.
    ``m`` holds the step's ``pair_contacts`` and ``terrain_contacts``, as
    tensors on any device or as numpy."""
    m = {k: world_to_numpy(m[k])
         for k in ("pair_contacts", "terrain_contacts")}
    jp = _pair_set(m)
    jt = _terrain_set(m)
    op, ot = _oracle_sets(rec)
    for (port_side, oracle_side) in ((jp, op), (jt, ot)):
        common = port_side.keys() & oracle_side.keys()
        sym = (port_side.keys() | oracle_side.keys()) - common
        worst["miss"] += len(sym)
        worst["total"] += max(len(port_side), len(oracle_side), 1)
        for key in common:
            tj, nj, aj, bj = port_side[key]
            to, no, ao, bo = oracle_side[key]
            worst["dt"] = max(worst["dt"], abs(tj - to))
            worst["dn"] = max(worst["dn"], float(np.abs(nj - no).max()))
            worst["dp"] = max(worst["dp"],
                              float(np.abs(aj - ao).max()),
                              float(np.abs(bj - bo).max()))
    return worst


def oracle_trajectory(ow: oracle.OracleWorld, dt: float, iters: int, *,
                      settle: int, steps: int, cap_manifold: str = "mid"):
    """Run the oracle alone from ``ow`` (the reference's raw-lambda
    friction): ``settle`` steps, then ``steps`` more.  Returns (states,
    recs): the ``steps + 1`` states from the end of the settle on, and the
    records of the ``steps`` steps between them."""
    kw = dict(dt=dt, iters=iters, cap_manifold=cap_manifold)
    for _ in range(settle):
        ow, _ = oracle.oracle_step(ow, **kw)
    states, recs = [ow], []
    for _ in range(steps):
        ow, rec = oracle.oracle_step(ow, **kw)
        states.append(ow)
        recs.append(rec)
    return states, recs


def resync(world, cfg, *, settle: int, steps: int, cap_manifold: str = "mid",
           carry_caches: bool = False, trajectory=None):
    """Per-step resync of the port's step against the oracle.

    The oracle runs alone for ``settle`` steps from ``world``; then for each
    of ``steps`` steps its state goes into ``step(..., collect_contacts=
    True)`` (through :func:`oracle.to_world` on ``world``) and the two
    contact streams of that step are diffed.  With ``carry_caches`` each
    step's template is the port's previous output, so the warm rows and
    the broadphase cache carry from step to step as in a free run; without
    it every step starts from ``world``'s own.  ``trajectory`` is
    :func:`oracle_trajectory`'s result for these arguments, when it was
    computed elsewhere.

    Returns a dict: ``worst`` (:func:`diff_streams`), per step ``miss``,
    ``dv`` (the one-step gap max |v_y| between the port's output and the
    oracle's next state) and ``warm_hit_frac``, ``ends_slot1`` (the
    oracle's capsule-pair slot-1 contacts) and ``capsule_terrain`` (its
    capsule-terrain contacts)."""
    if trajectory is None:
        trajectory = oracle_trajectory(
            oracle.from_world(world), cfg.dt, cfg.solver_iters,
            settle=settle, steps=steps, cap_manifold=cap_manifold)
    states, recs = trajectory
    stype = world.bodies.shape_type.cpu().numpy()
    worst = new_worst()
    miss, dv, hit = [], [], []
    slot1 = cterr = 0
    template = world
    for s, rec in enumerate(recs):
        w, m = step(oracle.to_world(states[s], template), cfg,
                    collect_contacts=True)
        before = worst["miss"]
        worst = diff_streams(m, rec, worst)
        miss.append(worst["miss"] - before)
        dv.append(float(np.abs(w.bodies.v.y.cpu().numpy()
                               - states[s + 1].v[:, 1]).max()))
        hit.append(float(m["warm_hit_frac"]))
        kind = np.asarray(rec["kind"])
        slot1 += int(np.sum((kind == 1) & (np.asarray(rec["slot"]) == 1)))
        cterr += int(np.sum((kind == 0)
                            & (stype[np.asarray(rec["i"], np.int64)] == 1)))
        if carry_caches:
            template = w
    return dict(worst=worst, miss=np.asarray(miss, np.int64),
                dv=np.asarray(dv), warm_hit_frac=np.asarray(hit),
                ends_slot1=slot1, capsule_terrain=cterr)
