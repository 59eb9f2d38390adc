"""The port's f64 parity oracle, its native host runtime and its resync
harness (``mgf_tpu_torch.oracle``, ``.native``, ``.parity``) against the
JAX package's (``mgf_tpu.oracle``, ``mgf_tpu.native``,
``tests/test_oracle.py``'s diff harness).

The oracle is the same numpy float64 code in both packages, and both bind
the same ``csrc/mgf_host.cpp`` built with the same flags, so every output
is held bit-equal (``np.array_equal``): the bridges from a world, every
``OracleWorld`` field and every record array of ``oracle_step`` over ten
steps, in both friction modes and both capsule manifolds.  The native f64
solve equals its plain numpy version within atol 1e-12, the twin of
``test_oracle_native_vs_python_solver``.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mgf_tpu import native as j_native  # noqa: E402
from mgf_tpu import oracle as j_oracle  # noqa: E402
from mgf_tpu.physics import SceneBuilder as JSceneBuilder  # noqa: E402
from mgf_tpu.scenes import _TERRAIN_FACES, _TERRAIN_VERTS  # noqa: E402
from mgf_tpu.scenes import balls_scene as j_balls_scene  # noqa: E402
from mgf_tpu.world import make_world as j_make_world  # noqa: E402

from mgf_tpu_torch import native, oracle, parity  # noqa: E402
from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402
from mgf_tpu_torch.world import WorldConfig, step  # noqa: E402

CPU = "cpu"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _capsules_mid():
    """tests/test_oracle.py::test_capsule_contact_stream_parity's box of 8
    capsules."""
    b = JSceneBuilder()
    rng = np.random.default_rng(4)
    for i in range(8):
        p = rng.uniform(-4, 4, 3)
        p[1] = -6.0 - i * 0.4
        b.add_capsule(tuple(p - [0.5, 0, 0]), (1.0, 0.0, 0.0), 1.0,
                      1.0, 0.3, 0.6)
    return j_make_world(b.build(), _TERRAIN_VERTS, _TERRAIN_FACES,
                        terrain_center=(0.0, -10.0, 0.0))


def _capsules_ends():
    """tests/test_oracle.py::test_capsule_ends_contact_stream_parity's two
    stacks of parallel capsules and two tilted ones."""
    b = JSceneBuilder()
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
    return j_make_world(b.build(), _TERRAIN_VERTS, _TERRAIN_FACES,
                        terrain_center=(0.0, -10.0, 0.0))


def _assert_oracle_worlds_equal(a, b):
    assert type(a)._fields == type(b)._fields
    for f in type(a)._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


def _assert_recs_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


# (scene, oracle steps before the ten compared, cap_manifold): the balls
# fall free until step ~137, so their ten steps are the landing's first
SCENES = {"balls6": (lambda: j_balls_scene(num=6, with_dropped=True)[0], 138,
                     "mid"),
          "capsules_mid": (_capsules_mid, 20, "mid"),
          "capsules_ends": (_capsules_ends, 6, "ends")}


@pytest.mark.parametrize("mgf_friction", [True, False])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_oracle_step_bit_equal(scene, mgf_friction):
    """From the bridged world on, the port's oracle reproduces mgf_tpu's
    bit for bit: ``from_world``, then ten ``oracle_step``s (after a lead-in
    into the contacts) in every field and record."""
    make, lead, manifold = SCENES[scene]
    jworld = make()
    tworld = world_from_numpy(_np_tree(jworld), CPU)
    jo = j_oracle.from_world(jworld)
    to = oracle.from_world(tworld)
    _assert_oracle_worlds_equal(jo, to)
    kw = dict(dt=1.0 / 60.0, iters=20, mgf_friction=mgf_friction,
              cap_manifold=manifold)
    for _ in range(lead):
        jo, _ = j_oracle.oracle_step(jo, **kw)
    to = oracle.OracleWorld(*jo)
    contacts = slot1 = 0
    for _ in range(10):
        jo, jrec = j_oracle.oracle_step(jo, **kw)
        to, trec = oracle.oracle_step(to, **kw)
        _assert_oracle_worlds_equal(jo, to)
        _assert_recs_equal(jrec, trec)
        contacts += len(trec["kind"])
        slot1 += int(np.sum(trec["slot"] == 1))
    assert contacts > 0
    assert (slot1 > 0) == (manifold == "ends")   # the extension fires


def test_to_world_matches():
    """``to_world`` writes the same float32 bodies into a port world as
    mgf_tpu's does into its own, and keeps the template's other fields."""
    jworld = _capsules_ends()
    tworld = world_from_numpy(_np_tree(jworld), CPU)
    ow = j_oracle.from_world(jworld)
    for _ in range(5):
        ow, _ = j_oracle.oracle_step(ow, cap_manifold="ends")
    want = jax.tree_util.tree_leaves(_np_tree(j_oracle.to_world(ow, jworld)))
    got_world = oracle.to_world(oracle.OracleWorld(*ow), tworld)
    got = jax.tree_util.tree_leaves(world_to_numpy(got_world))
    assert len(want) == len(got)
    for x, y in zip(want, got):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)
    assert got_world.bodies.x.x.device.type == CPU


def test_native_equals_mgf_tpu_native():
    """test_ops_native.py's inputs through both packages' native calls,
    and the port's plain versions beside its native ones."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    order = native.morton_order(pos)
    assert np.array_equal(order, j_native.morton_order(pos))
    assert sorted(order.tolist()) == list(range(500))
    assert np.array_equal(native.morton_order_reference(pos), order)

    verts = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    doubled = np.vstack([verts, verts + 1e-9])
    soup = np.asarray([[1, 1, 1], [0, 0, 0], [1, 1, 1], [-2, 5, 0]],
                      np.float32)
    for vv in (doubled, soup):
        welded, remap = native.weld_vertices(vv, tol=1e-6)
        jw, jr = j_native.weld_vertices(vv, tol=1e-6)
        assert np.array_equal(welded, jw) and np.array_equal(remap, jr)
        np.testing.assert_allclose(welded[remap], vv, atol=1e-6)
        pw, pr = native.weld_vertices_reference(vv, tol=1e-6)
        assert pw.shape == welded.shape
        np.testing.assert_allclose(pw[pr], vv, atol=1e-6)
    assert native.weld_vertices(doubled)[0].shape[0] == 100

    verts = np.asarray([[-10, 0, -10], [-10, 0, 10], [10, 0, 10],
                        [10, 0, -10], [0, 5, 0]], np.float32)
    faces = np.asarray([[0, 1, 3], [1, 2, 3], [0, 1, 4]], np.int32)
    table, overflow = native.build_cell_table(verts, faces, 8.0, 16, 4)
    jt, jo = j_native.build_cell_table(verts, faces, 8.0, 16, 4)
    assert np.array_equal(table, jt) and overflow == jo == 0
    pt, po = native.build_cell_table_reference(verts, faces, 8.0, 16, 4)
    assert np.array_equal(pt, table) and po == 0
    assert (table >= 0).sum() == 3

    tree = native.AabbTree(verts, faces)
    jtree = j_native.AabbTree(verts, faces)
    for c, r, want in (([0, 0, 0], [1, 1, 1], [0, 1, 2]),
                       ([0, 4, 0], [2, 2, 2], [2])):
        hits = tree.query(c, r)
        assert np.array_equal(hits, jtree.query(c, r))
        assert sorted(hits.tolist()) == want
        assert native.aabb_query_reference(verts, faces, c, r).tolist() \
            == want


def test_native_solve_vs_reference():
    """The native C++ Gauss-Seidel loop equals the plain numpy version
    within atol 1e-12 and mgf_tpu's native call exactly (twin of
    tests/test_oracle.py::test_oracle_native_vs_python_solver)."""
    rng = np.random.default_rng(3)
    M, C = 8, 12
    v = rng.normal(size=(M, 3))
    omega = rng.normal(size=(M, 3)) * 0.1
    inv_mass = np.abs(rng.normal(size=M)) + 0.1
    inv_moment = np.broadcast_to(np.eye(3) * 0.4, (M, 3, 3)).copy()
    ia = rng.integers(0, M, C).astype(np.int32)
    ib = ((ia + 1 + rng.integers(0, M - 1, C)) % M).astype(np.int32)
    n = rng.normal(size=(C, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    t1 = np.cross(n, [0.0, 1.0, 0.001])
    t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = np.cross(n, t1)
    args = dict(ra=rng.normal(size=(C, 3)) * 0.3,
                rb=rng.normal(size=(C, 3)) * 0.3,
                normal=n, t1=t1, t2=t2,
                friction=np.abs(rng.normal(size=C)) * 0.5,
                bias=rng.normal(size=C) * 0.1,
                normal_mass=np.abs(rng.normal(size=C)) + 0.2,
                tm1=np.abs(rng.normal(size=C)) + 0.2,
                tm2=np.abs(rng.normal(size=C)) + 0.2)
    for mgf in (True, False):
        vn, on = native.solve_contacts_f64(
            v, omega, inv_mass, inv_moment, ia, ib, iters=10,
            mgf_friction=mgf, **args)
        vp, op_ = native.solve_contacts_f64_reference(
            v, omega, inv_mass, inv_moment, ia, ib, iters=10,
            mgf_friction=mgf, **args)
        vj, oj = j_native.solve_contacts_f64(
            v.copy(), omega.copy(), inv_mass, inv_moment, ia, ib, iters=10,
            mgf_friction=mgf, **args)
        np.testing.assert_allclose(vn, vp, rtol=0, atol=1e-12)
        np.testing.assert_allclose(on, op_, rtol=0, atol=1e-12)
        assert np.array_equal(vn, vj) and np.array_equal(on, oj)
        assert not np.array_equal(vn, v)        # inputs were not written


def test_native_build_location_and_missing_compiler(tmp_path, monkeypatch):
    """The library builds into build/mgf_tpu_torch/ (never csrc/), keyed by
    the source and flags; with no g++ and no library a call raises."""
    path = native._library_path()
    assert path.parent.parts[-2:] == ("build", "mgf_tpu_torch")
    native.morton_order(np.zeros((2, 3), np.float32))
    assert path.exists()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_library_path",
                        lambda: tmp_path / "libmgf_host-missing.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.native_available() is False
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.morton_order(np.zeros((2, 3), np.float32))


def test_diff_streams_matches_test_oracle():
    """parity.diff_streams on the port's CPU step gives the same worst dict
    as test_oracle._diff_streams on the same streams, over 20 resync steps
    of balls_scene(6)'s landing; parity.resync's own loop gives it too."""
    from test_oracle import _diff_streams
    jworld, cfg = j_balls_scene(num=6, with_dropped=True)   # 217 bodies
    tcfg = WorldConfig(*cfg)
    tworld = world_from_numpy(_np_tree(jworld), CPU)
    traj = parity.oracle_trajectory(oracle.from_world(tworld), cfg.dt,
                                    cfg.solver_iters, settle=135, steps=20)
    states, recs = traj
    mine, theirs = parity.new_worst(), parity.new_worst()
    for s, rec in enumerate(recs):
        _, m = step(oracle.to_world(states[s], tworld), tcfg,
                    collect_contacts=True)
        mine = parity.diff_streams(m, rec, mine)
        theirs = _diff_streams(world_to_numpy(m), rec, theirs)
        assert mine == theirs
    assert mine["total"] > 100 and mine["miss"] == 0, mine
    out = parity.resync(tworld, tcfg, settle=135, steps=20, trajectory=traj)
    assert out["worst"] == mine
    assert out["miss"].shape == (20,) and int(out["miss"].sum()) == 0
    assert out["dv"].shape == (20,) and np.isfinite(out["dv"]).all()
