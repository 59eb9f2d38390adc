"""What decides ``correct``: the program's output held against the plain
reference (``physbench/reference``), number by number, each against its
limit.

The reference follows the program from the program's own state: a settled
pile of 100,000 bodies is 1,600 (or 400) steps of chaotic dynamics, which
no second implementation reproduces body for body (a float32 and a float64
run part by ~1e-3 m/s within 64 steps), so each compared chunk starts from
the world the program handed to it.  What the reference cannot follow (the
settle before the window) is checked at its ends: the first world against
the reference's own scene from the seed, the settled world against the
configuration's guarantees.

Numbers, per compared chunk (the widest over the chunks is reported):

* ``v_gap_median`` / ``v_gap_max``: the median and the largest distance,
  over the bodies, between the program's velocity after the chunk and the
  reference's after following the same chunk (same nonces, same solver
  schedule) from the same start: the solver and integration layer.
* ``contact_rows_mismatch``: the rows of the chunk's last step that the
  program solved as contacts and the reference, recomputing that step's
  contacts from the program's end state (positions, sweeps, candidate
  list, terrain), does not, and the reverse: the narrowphase.
* ``x_gap_max``: the same for positions (a step moves every body by its
  sweep, so a body left out of a step shows here even where it rests).
* ``step_count_gap``: steps the program's world is behind or ahead of
  the reference's after the chunk (the broadphase cache counts every
  step): a step that returns its state unchanged.
* ``momentum_gap``: the largest distance between a body's velocity and its
  swept velocity (``delta / dt``) minus its inverse mass times the
  impulses of its rows, as the program's accumulators give them along the
  reference's contact frames: the last step's integration and impulses.
  Bodies with a row that ``contact_rows_mismatch`` counts are left out.

The configuration's guarantees, each checked by one number against the
limit the configuration states (``GUARANTEES``; a stated guarantee with no
number to check it is refused): ``overflow_max`` (bodies dropped from full
cell-table buckets in any step: the program's own count over every step of
the window, and the reference's count from the same positions at each of
its rebuilds in a compared chunk, the larger of the two),
``drift_excess_max`` (the cached candidate list used past its slack, the
program's count over every step), ``pairs_missed_free_row`` (pairs of
bodies whose shapes overlap at the end of their sweep and that the
program's candidate list lacks while the row has a free slot; a full row
keeps the ``max_pairs`` nearest by the engine's key, which the reference
rebuilds and ``contact_rows_mismatch`` compares), ``penetration_max``,
``escaped`` (bodies below the floor or beyond a wall by more than their
reach, so that no contact holds them), ``nonfinite`` (values in x, v,
omega) and ``lower_precision_leaves`` (floating tensors of the world not in
float32), at the settled world and at every compared chunk's end; and at
the start ``scene_mismatch`` (values of the first world that differ from
the reference's scene).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from physbench.reference import geometry as G
from physbench.reference import scene as ref_scene
from physbench.reference import step as ref

FOLLOWED = ("v_gap_median", "v_gap_max", "x_gap_max", "step_count_gap",
            "contact_rows_mismatch", "momentum_gap")


def engine_of(conf: dict) -> dict:
    """The reference's view of a configuration's engine settings."""
    e = conf["engine"]
    return dict(shape_mode=e["shape_mode"], dt=e["dt"],
                max_pairs=e["max_pairs"], fatten=e["fatten"],
                grid_cell=e["grid"]["cell_size"], bp_every=e["bp_every"],
                grid_dims=list(e["grid"]["dim"]),
                bucket_cap=e["grid"]["bucket_cap"],
                terrain_cand=e["terrain_cand"],
                cap_manifold=e["cap_manifold"], warm_gamma=e["warm_gamma"],
                n_sphere_rows=e["n_sphere_rows"])


def start_mismatch(world, conf: dict, seed: int) -> int:
    """Values of the program's first world that differ from the
    reference's scene for ``seed``: body centres, capsule flags, radii,
    masses, the box."""
    b = world.bodies
    centres, caps, box = ref_scene.stress_start(conf["scene"], conf["bodies"],
                                                seed)
    h = lambda t: t.detach().cpu().numpy()
    x = np.stack([h(b.x.x), h(b.x.y), h(b.x.z)], -1)
    bad = int(np.sum(x != centres))
    bad += int(np.sum((h(b.shape_type) == 1) != caps))
    bodies = conf["bodies"]
    bad += int(np.sum(h(b.shape_r) != np.float32(bodies["radius"])))
    bad += int(np.sum(h(b.inv_mass) != np.float32(1.0 / bodies["mass"])))
    bad += int(np.sum(h(b.restitution) != np.float32(bodies["restitution"])))
    bad += int(np.sum(h(b.friction) != np.float32(bodies["friction"])))
    if caps.any():
        bad += int(np.sum(h(b.shape_half_h)[caps]
                          != np.float32(bodies["capsule_axis"] / 2)))
    t = world.terrain
    corners = np.concatenate([np.stack([h(v.x), h(v.y), h(v.z)], -1)
                              for v in (t.a, t.b, t.c)])
    have = {tuple(p) for p in corners.tolist()}
    bad += len({tuple(p) for p in box.tolist()} ^ have)
    return bad


def _seg_dist(a1, d1, a2, d2):
    """Distance between the segments a1 + s d1 and a2 + t d2 (s, t in
    [0, 1]; a zero axis is a point), by their clamped closest parameters
    (Ericson, Real-Time Collision Detection, 5.1.9)."""
    eps = 1e-12
    r = a1 - a2
    A, E, F = G.dot(d1, d1), G.dot(d2, d2), G.dot(d2, r)
    C, B = G.dot(d1, r), G.dot(d1, d2)
    div = lambda p, q: p / torch.where(q > eps, q, 1.0)
    clamp01 = lambda v: torch.clamp(v, 0.0, 1.0)
    den = A * E - B * B
    s = torch.where(den > eps, clamp01(div(B * F - C * E, den)), 0.0)
    t = div(B * s + F, E)
    s = torch.where(t < 0.0, clamp01(div(-C, A)),
                    torch.where(t > 1.0, clamp01(div(B - C, A)), s))
    t = clamp01(t)
    # a degenerate segment is its start point
    s = torch.where(A <= eps, 0.0, torch.where(E <= eps, clamp01(div(-C, A)),
                                               s))
    t = torch.where(E <= eps, 0.0, torch.where(A <= eps, clamp01(div(F, E)),
                                               t))
    return G.norm(a1 + d1 * s[..., None] - a2 - d2 * t[..., None],
                  keepdim=False)


def guarantees(s: dict, eng: dict) -> dict:
    """The configuration's guarantees at a program state (reference
    layout)."""
    x, r = s["x"], s["r"]
    xe = x + s["delta"]
    n = x.shape[0]
    # overlapping pairs at the end of the sweep, by the reference's own
    # neighbour search (a sphere's or a capsule's segment box)
    caps = s["shape_type"] == 1
    a, d = ref.capsule_segment(xe, s["q"], s["half_h"])
    lo = torch.where(caps[:, None], torch.minimum(a, a + d), xe) - r[:, None]
    hi = torch.where(caps[:, None], torch.maximum(a, a + d), xe) + r[:, None]
    c, h = (lo + hi) * 0.5, (hi - lo) * 0.5
    reach = h.max(-1).values
    i, j = ref.neighbour_pairs(c, reach + reach.max(),
                               float(2 * reach.max()) * 1.0001)
    dist = torch.where(caps[i] | caps[j],
                       _seg_dist(torch.where(caps[i, None], a[i], xe[i]),
                                 torch.where(caps[i, None], d[i], 0.0),
                                 torch.where(caps[j, None], a[j], xe[j]),
                                 torch.where(caps[j, None], d[j], 0.0)),
                       G.norm(xe[i] - xe[j], keepdim=False))
    over = dist < r[i] + r[j]
    i, j = i[over], j[over]
    listed = (s["bp"]["partner"][i] == j[:, None]).any(-1)
    # a full row keeps the max_pairs nearest by the configuration's rule;
    # a pair missing from a row with a free slot is a broadphase miss
    free = s["bp"]["ok"].sum(-1) < s["bp"]["ok"].shape[1]
    rows = ref.contact_rows(s, eng)
    pen = torch.where(rows["valid"], torch.clamp(rows["pen"], min=0.0), 0.0)
    tx = s["terrain"]["a"]
    wall = float(torch.max(torch.abs(torch.cat([tx[:, 0], tx[:, 2]]))))
    # out of the box by more than its reach: no contact brings it back
    reach = r + s["half_h"]
    out = ((x[:, 1] < -reach) | (x[:, 0].abs() > wall + reach)
           | (x[:, 2].abs() > wall + reach))
    fin = torch.cat([x, s["v"], s["omega"]], -1)
    return dict(pairs_missed_free_row=int((~listed & free[i]).sum()),
                penetration_max=float(pen.max()) if pen.numel() else 0.0,
                escaped=int(out.sum()),
                nonfinite=int((~torch.isfinite(fin)).sum()))


def last_step(s: dict, eng: dict) -> dict:
    """The one-step checks of the step that produced ``s``: its contact
    rows against the reference's, its velocity against its impulses."""
    rows = ref.contact_rows(s, eng)
    w = s["warm"]
    prog = w["partner"] != -9
    mine = rows["valid"]
    same_key = (w["key2"] == rows["key"]) & (w["partner"] == rows["partner"])
    differ = (prog != mine) | (prog & mine & ~same_key)       # (rows, N)
    vf = prog.to(s["x"].dtype)[..., None]
    imp = (rows["normal"] * w["acc_n"][..., None]
           + rows["t1"] * w["acc_t1"][..., None]
           + rows["t2"] * w["acc_t2"][..., None]) * vf
    v_pre = s["delta"] / eng["dt"]
    expect = v_pre - imp.sum(0) * s["inv_mass"][:, None]
    gap = G.norm(s["v"] - expect, keepdim=False)
    # a body with a row that contact_rows_mismatch counts has no reference
    # frame for that row's impulse: its gap would count the row twice
    gap = gap[~differ.any(0)]
    return dict(contact_rows_mismatch=int(differ.sum()),
                momentum_gap=float(gap.max()) if gap.numel() else 0.0)


def follow(s_in: dict, eng: dict, scales, schedule, dtype=None) -> dict:
    """The reference's state after stepping the chunk's nonces ``scales``
    under ``schedule`` from ``s_in``, computed in ``dtype`` (default:
    ``s_in``'s); returned in ``s_in``'s dtype.  Its cache's
    ``dropped_max`` is the most bodies a rebuild of the chunk left out of
    the cell table (None where the chunk did not rebuild)."""
    base = s_in["x"].dtype
    cast = lambda st, dt: _cast(st, dt)
    s = cast(s_in, dtype) if dtype is not None else s_in
    dropped = []
    for k in range(len(scales)):
        s, _ = ref.step(s, eng, float(scales[k]), schedule)
        dropped.append(s["bp"].pop("dropped", None))
    s = cast(s, base) if dtype is not None else s
    s["bp"]["dropped_max"] = max((d for d in dropped if d is not None),
                                 default=None)
    return s


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def chunk_numbers(s_in: dict, s_out: dict, eng: dict, scales,
                  schedule) -> dict:
    """Every followed number of one chunk: ``s_out`` (the program's world
    after the chunk, or a control's) against the reference's follow of
    ``s_in``."""
    s_ref = follow(s_in, eng, scales, schedule)
    gap = G.norm(s_out["v"] - s_ref["v"], keepdim=False)
    gap = torch.where(torch.isfinite(gap), gap, math.inf)
    xgap = G.norm(s_out["x"] - s_ref["x"], keepdim=False)
    xgap = torch.where(torch.isfinite(xgap), xgap, math.inf)
    out = dict(v_gap_median=float(gap.median()), v_gap_max=float(gap.max()),
               x_gap_max=float(xgap.max()),
               step_count_gap=abs(int(s_out["bp"]["count"])
                                  - int(s_ref["bp"]["count"])))
    if s_ref["bp"]["dropped_max"] is not None:
        out["overflow_max"] = s_ref["bp"]["dropped_max"]
    out.update(last_step(s_out, eng))
    out.update(guarantees(s_out, eng))
    return out


# each guarantee a configuration may state: the number that checks it,
# and that number's limit from the stated value and the body count
GUARANTEES = {
    "arithmetic": ("lower_precision_leaves", lambda g, n: 0),
    "bucket_overflow_max_share": ("overflow_max",
                                  lambda g, n: math.floor(g * n)),
    "cache_drift_excess_max": ("drift_excess_max", lambda g, n: g),
    "pairs_missed_free_row_max_share": ("pairs_missed_free_row",
                                        lambda g, n: math.floor(g * n)),
    "max_penetration": ("penetration_max", lambda g, n: g),
    "escaped_bodies": ("escaped", lambda g, n: g),
    "finite_state": ("nonfinite", lambda g, n: 0 if g is True else None),
}
# numbers compared exactly, whatever the cell
EXACT = ("scene_mismatch", "step_count_gap")


def guarantee_limits(conf: dict, n_bodies: int) -> dict:
    """{number: limit} for every guarantee the configuration states."""
    out = {}
    for key, stated in conf["guarantees"].items():
        if key not in GUARANTEES:
            raise KeyError(f"{conf['name']}: no number checks the "
                           f"guarantee {key!r}")
        name, lim = GUARANTEES[key]
        out[name] = lim(stated, n_bodies)
        if out[name] is None:
            raise ValueError(f"{conf['name']}: guarantee {key!r} states "
                             f"{stated!r}, which no number can check")
    return out


def judge(numbers: dict, limits: dict, conf: dict, n_bodies: int,
          complete: bool = False):
    """(correct, [(name, value, limit)]) for a dict of the widest
    readings.  A guarantee's number is held to the configuration's limit,
    ``EXACT`` numbers to 0, a followed number to the cell's limits file:
    a number there, or a string that gives the reason it is logged and not
    compared.  A followed number the file does not name fails.  With
    ``complete``, every guarantee's number and every compared followed
    number has to be among ``numbers``: one that is missing fails."""
    g = guarantee_limits(conf, n_bodies)
    rows = []
    for k, v in numbers.items():
        if k in g:
            rows.append((k, v, g[k]))
        elif k in EXACT:
            rows.append((k, v, 0))
        elif k in FOLLOWED:
            lim = limits.get(k)
            if not isinstance(lim, str):
                rows.append((k, v, lim))
        else:
            rows.append((k, v, None))
    if complete:
        want = set(g) | {k for k in FOLLOWED
                         if not isinstance(limits.get(k), str)}
        rows += [(k, None, g.get(k, limits.get(k)))
                 for k in sorted(want - set(numbers))]
    ok = all(v is not None and lim is not None and v <= lim
             for _, v, lim in rows)
    return ok, rows
