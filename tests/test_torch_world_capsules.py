"""The port's capsule step (``shape_mode="capsules"``: two contact slots,
Mat3 inertia, the "mid" and "ends" flank manifolds, dense terrain under
``terrain_rows``, ``use_grid=False``) against mgf_tpu's and against the f64
oracle.

* ``capsules_scene``: the built world and config equal mgf_tpu's exactly.
* One port step of ``capsules_scene(3)`` from mgf_tpu's state mid-landing
  (the first step after 170 that holds both kinds of contact): index streams, validity masks and integer metrics exact;
  normals atol 1e-4, witnesses atol 1e-3, contact times 1e-4 where the body
  approaches faster than 0.01 per step, else 1e-6 of travel along the
  normal; v atol 2e-4, omega atol 2e-4 plus rtol 1e-4 (40 half-sweeps with
  Mat3 inertia).
* ``prune`` at two slots with two incoming slots and both proximity
  thresholds: validity exact, floats atol 1e-6.
* Port twins of tests/test_oracle.py's two capsule stream gates: each step
  the oracle's f64 state goes into the port's step (``use_grid=False``) and
  the contact streams are diffed contact for contact at the JAX tests' own
  limits.  Where the JAX test widened the normal gate for every contact
  (the "ends" scene: 4e-5), the port is held per contact class: the wide
  gate for capsule-capsule contacts only, whose flank normals are the
  ill-conditioned ones, and the capsule test's 2e-6 for terrain contacts.
* Port twin of tests/test_world.py::test_capsules_mini_steps.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mgf_tpu import collision as jcol  # noqa: E402
from mgf_tpu import manifold as jman  # noqa: E402
from mgf_tpu.math3d import Vec3 as JVec3  # noqa: E402
from mgf_tpu.scenes import capsules_scene as j_capsules_scene  # noqa: E402
from mgf_tpu.world import step as j_step  # noqa: E402

from mgf_tpu_torch import collision as tcol  # noqa: E402
from mgf_tpu_torch import manifold as tman  # noqa: E402
from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402
from mgf_tpu_torch.math3d import Vec3 as TVec3  # noqa: E402
from mgf_tpu_torch.scenes import capsules_scene as t_capsules_scene  # noqa: E402
from mgf_tpu_torch.world import WorldConfig, step  # noqa: E402

CPU = "cpu"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("num", [3, 2])
def test_capsules_scene_matches_jax(num):
    jw, jcfg = j_capsules_scene(num)
    tw, tcfg = t_capsules_scene(num, device=CPU)
    a = jax.tree_util.tree_leaves(_np_tree(jw))
    b = jax.tree_util.tree_leaves(world_to_numpy(tw))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert tuple(jcfg) == tuple(tcfg)
    assert int(tw.bodies.shape_type.sum()) == num ** 3
    assert tw.warm is None and tw.bp is None


def _approach(delta_a, delta_b, n):
    rel = [db - da for da, db in zip(delta_a, delta_b)]
    return np.abs(sum(r * c for r, c in zip(rel, n)))


def _assert_stream(js, ts, approach, min_valid):
    for k in js:
        if k != "contact":
            np.testing.assert_array_equal(js[k], ts[k], err_msg=k)
            assert js[k].dtype == ts[k].dtype, k
    jc, tc = js["contact"], ts["contact"]
    np.testing.assert_array_equal(jc.valid, tc.valid)
    v = jc.valid
    assert v.shape[0] == 2
    assert v.sum() >= min_valid, v.sum()
    for a, b in zip(jc.n, tc.n):
        np.testing.assert_allclose(a[v], b[v], atol=1e-4, rtol=0)
    for pj, pt in ((jc.a, tc.a), (jc.b, tc.b)):
        for a, b in zip(pj, pt):
            np.testing.assert_allclose(a[v], b[v], atol=1e-3, rtol=0)
    dt = np.abs(jc.t[v] - tc.t[v])
    s = np.broadcast_to(approach, v.shape)[v]
    fast = s >= 1e-2
    assert (dt[fast] <= 1e-4).all(), dt[fast].max()
    assert (dt[~fast] * s[~fast] <= 1e-6).all()


def test_capsules_one_step_matches_jax():
    """capsules_scene(3) mid-landing: the first JAX step from step 170 on
    in which the bottom layer lies on the floor (>= 10 terrain contacts)
    while the middle one lands on it (>= 4 pair contacts)."""
    jw, cfg = j_capsules_scene(3)
    f = jax.jit(functools.partial(j_step, cfg=cfg, collect_contacts=True))
    for k in range(240):
        jw2, jm = f(jw)
        if (k >= 170
                and int(jm["pair_contacts"]["contact"].valid.sum()) >= 4
                and int(jm["terrain_contacts"]["contact"].valid.sum()) >= 10):
            break
        jw = jw2
    else:
        raise AssertionError("no landing step found")
    jw2, jm = _np_tree((jw2, jm))
    tw2, tm = step(world_from_numpy(_np_tree(jw), CPU), WorldConfig(*cfg),
                   collect_contacts=True)
    tm, tw2 = world_to_numpy(tm), world_to_numpy(tw2)

    d = [np.asarray(c) for c in tw2.bodies.delta]
    pc = jm["pair_contacts"]
    app = _approach([c[pc["i"]] for c in d], [c[pc["j"]] for c in d],
                    [np.asarray(c) for c in pc["contact"].n])
    _assert_stream(pc, tm["pair_contacts"], app, 4)
    tcn = jm["terrain_contacts"]
    z = np.zeros_like(tcn["i"], np.float32)
    app = _approach([c[tcn["i"]] for c in d], [z, z, z],
                    [np.asarray(c) for c in tcn["contact"].n])
    _assert_stream(tcn, tm["terrain_contacts"], app, 10)
    # "mid": a pair holds one contact, a lying capsule two per triangle
    assert not pc["contact"].valid[1].any()
    assert tcn["contact"].valid[1].any()

    for k in ("broadphase_overflow", "num_contacts", "num_pairs",
              "num_constraints", "num_alive"):
        assert int(jm[k]) == int(tm[k]), k
    assert int(tm["num_constraints"]) == (2 * 24 + 6) * 27
    for k in ("max_penetration", "broadphase_reach_excess",
              "broadphase_span_excess"):
        np.testing.assert_allclose(jm[k], tm[k], atol=1e-5, err_msg=k)
    for a, b in zip(jw2.bodies.v, tw2.bodies.v):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=0)
    for a, b in zip(jw2.bodies.omega, tw2.bodies.omega):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-4)
    for f_ in ("x", "q", "delta"):
        for a, b in zip(getattr(jw2.bodies, f_), getattr(tw2.bodies, f_)):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=f_)
    for a, b in zip(jw2.bodies.inv_moment, tw2.bodies.inv_moment):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    # the solve moved the landed capsules
    assert int(tm["num_contacts"]) > 20 and float(tm["solver_dv_norm"]) > 0.1


def test_capsules_mini_steps():
    """Port twin of tests/test_world.py::test_capsules_mini_steps."""
    world, cfg = t_capsules_scene(num=2, device=CPU)
    m = None
    # capsules start ~28 m above the floor: ~150 steps of free fall
    for _ in range(280):
        world, m = step(world, cfg)
    y = world.bodies.x.y.numpy()
    assert not np.isnan(y).any()
    assert y.min() > -10.0
    assert int(m["num_contacts"]) > 0
    assert int(m["broadphase_overflow"]) == 0


@pytest.mark.parametrize("prox_sq", [tman.PERSISTENT_THRESHOLD_SQ, 1.0e-4])
def test_prune_two_slots_matches_jax(prox_sq):
    """prune(max_contacts=2) on two incoming slots: same-time pairs (the
    merge path), near-coincident points on either side of both proximity
    thresholds, and every validity pattern."""
    rng = np.random.default_rng(11)
    n = 4096
    sh = (2, n)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    t = rng.uniform(0.0, 1.0, sh).astype(np.float32)
    t[:, :1500] = 0.0                     # overlaps: both slots at time 0
    t[1, 1500:2500] = t[0, 1500:2500]     # equal positive times
    valid = rng.uniform(size=sh) < 0.75
    pts = [f32(*sh, 3) for _ in range(4)]
    # slot 1 close to slot 0: offsets from 1e-3 to 0.3 straddle prox 1e-2
    # (1e-4 squared) and sqrt(0.5)'s neighbourhood is reached by the rest
    near = slice(0, n, 2)
    off = (10.0 ** rng.uniform(-3.0, -0.5, (n, 1))).astype(np.float32)
    for p in pts:
        p[1, near] = p[0, near] + (off * _unit(f32(n, 3)))[near]
    nrm = _unit(f32(*sh, 3))

    def build(vec, arr, cons, lc):
        c = cons(a=vec(pts[0]), b=vec(pts[1]), n=vec(nrm), t=arr(t),
                 valid=arr(valid))
        return lc(local_a=vec(pts[2]), local_b=vec(pts[3]), contact=c)

    jv = lambda a: JVec3(*(jnp.asarray(a[..., k]) for k in range(3)))
    tv = lambda a: TVec3(*(torch.as_tensor(np.ascontiguousarray(a[..., k]))
                           for k in range(3)))
    mj = jman.prune(build(jv, jnp.asarray, jcol.Contact, jcol.LocalContact),
                    max_contacts=2, prox_sq=prox_sq)
    mt = tman.prune(build(tv, torch.as_tensor, tcol.Contact,
                          tcol.LocalContact), max_contacts=2,
                    prox_sq=prox_sq)
    npv = lambda x: (np.stack([np.asarray(c) for c in x], -1)
                     if isinstance(x, tuple) else np.asarray(x))
    vj = npv(mj.valid)
    np.testing.assert_array_equal(vj, npv(mt.valid))
    assert vj.shape == sh
    both = valid.all(axis=0)
    # the proximity merge fired on some columns and spared others
    assert 0 < (vj.sum(0)[both] == 1).sum() < both.sum()
    for f in ("time", "normal", "t1", "t2"):
        np.testing.assert_allclose(npv(getattr(mj, f)), npv(getattr(mt, f)),
                                   atol=1e-6, rtol=0, err_msg=f)
    for f in ("local_a", "local_b"):
        np.testing.assert_allclose(npv(getattr(mj, f))[vj],
                                   npv(getattr(mt, f))[vj], atol=1e-6,
                                   rtol=0, err_msg=f)


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _diff_by_class(m, rec, worst):
    """tests/test_oracle.py::_diff_streams with the worst deviations kept
    per contact class ("pair", "terrain")."""
    from test_oracle import _oracle_sets, _pair_set, _terrain_set
    op, ot = _oracle_sets(rec)
    for name, port_side, oracle_side in (("pair", _pair_set(m), op),
                                         ("terrain", _terrain_set(m), ot)):
        w = worst[name]
        common = port_side.keys() & oracle_side.keys()
        w["miss"] += len((port_side.keys() | oracle_side.keys()) - common)
        w["total"] += max(len(port_side), len(oracle_side), 1)
        for key in common:
            tj, nj, aj, bj = port_side[key]
            to, no, ao, bo = oracle_side[key]
            w["dt"] = max(w["dt"], abs(tj - to))
            w["dn"] = max(w["dn"], float(np.abs(nj - no).max()))
            w["dp"] = max(w["dp"], float(np.abs(aj - ao).max()),
                          float(np.abs(bj - bo).max()))
    return worst


def _resync(jworld, cfg, steps, **oracle_kw):
    """Step the f64 oracle; push each of its states through one port step
    and diff the two contact streams.  Returns the per-class worst
    deviations and the oracle's records."""
    from mgf_tpu import oracle
    tcfg = WorldConfig(*cfg)
    ow = oracle.from_world(jworld)
    worst = {k: dict(dt=0.0, dn=0.0, dp=0.0, miss=0, total=0)
             for k in ("pair", "terrain")}
    recs = []
    for _ in range(steps):
        w_in = world_from_numpy(_np_tree(oracle.to_world(ow, jworld)), CPU)
        _, m = step(w_in, tcfg, collect_contacts=True)
        ow, rec = oracle.oracle_step(ow, dt=cfg.dt, iters=20, **oracle_kw)
        worst = _diff_by_class(world_to_numpy(m), rec, worst)
        recs.append(rec)
    return worst, recs


def _total(worst, key, fn=max):
    return fn((worst["pair"][key], worst["terrain"][key]))


def test_capsule_contact_stream_parity():
    """Port twin of tests/test_oracle.py::
    test_capsule_contact_stream_parity, at its gates."""
    from mgf_tpu.physics import SceneBuilder
    from mgf_tpu.scenes import _TERRAIN_FACES, _TERRAIN_VERTS
    from mgf_tpu.world import WorldConfig as JWorldConfig
    from mgf_tpu.world import make_world

    b = SceneBuilder()
    rng = np.random.default_rng(4)
    for i in range(8):
        p = rng.uniform(-4, 4, 3)
        p[1] = -6.0 - i * 0.4
        b.add_capsule(tuple(p - [0.5, 0, 0]), (1.0, 0.0, 0.0), 1.0,
                      1.0, 0.3, 0.6)
    world = make_world(b.build(), _TERRAIN_VERTS, _TERRAIN_FACES,
                       terrain_center=(0.0, -10.0, 0.0))
    cfg = JWorldConfig(shape_mode="capsules", solver="rows",
                       use_grid=False, solver_iters=20)
    worst, _ = _resync(world, cfg, 80)
    assert _total(worst, "total", sum) > 300, worst
    assert _total(worst, "miss", sum) <= 2, worst
    assert _total(worst, "dt") <= 8e-3, worst
    assert _total(worst, "dn") <= 2e-6, worst
    assert _total(worst, "dp") <= 1e-4, worst


def test_capsule_ends_contact_stream_parity():
    """Port twin of tests/test_oracle.py::
    test_capsule_ends_contact_stream_parity (``cap_manifold="ends"``), the
    normal gate per contact class."""
    from mgf_tpu.physics import SceneBuilder
    from mgf_tpu.scenes import _TERRAIN_FACES, _TERRAIN_VERTS
    from mgf_tpu.world import WorldConfig as JWorldConfig
    from mgf_tpu.world import make_world

    b = SceneBuilder()
    rng = np.random.default_rng(9)
    for i in range(6):
        p = np.asarray([(-2.0 if i % 2 else 2.0) + rng.uniform(-0.1, 0.1),
                        -7.5 - (i // 2) * 0.8, rng.uniform(-0.3, 0.3)])
        b.add_capsule(tuple(p - [0.7, 0, 0]), (1.4, 0.0, 0.0), 0.5,
                      1.0, 0.3, 0.6)
    for i in range(2):
        p = rng.uniform(-2, 2, 3)
        p[1] = -5.0 - i * 0.5
        b.add_capsule(tuple(p - [0.5, 0.1 * i, 0]), (1.0, 0.2 * i, 0.0),
                      0.5, 1.0, 0.3, 0.6)
    world = make_world(b.build(), _TERRAIN_VERTS, _TERRAIN_FACES,
                       terrain_center=(0.0, -10.0, 0.0))
    cfg = JWorldConfig(shape_mode="capsules", solver="rows",
                       use_grid=False, solver_iters=20,
                       cap_manifold="ends")
    worst, recs = _resync(world, cfg, 100, cap_manifold="ends")
    slot1_seen = sum(int(np.sum((np.asarray(r["kind"]) == 1)
                                & (np.asarray(r["slot"]) == 1)))
                     for r in recs)
    assert slot1_seen > 20, slot1_seen
    total = _total(worst, "total", sum)
    assert total > 300, worst
    assert _total(worst, "miss", sum) <= max(4, total // 100), worst
    assert _total(worst, "dt") <= 8e-3, worst
    assert worst["pair"]["dn"] <= 4e-5, worst
    assert worst["terrain"]["dn"] <= 2e-6, worst
    assert _total(worst, "dp") <= 1e-3, worst
