"""tests/test_world.py's surgery and builder tests on the port, each
beside its mgf_tpu twin: make_step_fn, extend_world, remove_bodies,
with_capacity, spawn_bodies, kill_bodies, free_slots and num_alive.  The
file's three mini scenes have their port twins beside the JAX package's
on the same branch: test_torch_world_generic.py::test_balls_mini_settles,
test_torch_world_capsules.py::test_capsules_mini_steps and
test_torch_world_mixed.py::test_mixed_mini_steps.

The JAX package's "no recompile" check becomes: the same step callable
keeps running and no tensor of the world changes shape.  Tolerances: the
surgery functions' outputs bit-equal to mgf_tpu's on the same inputs;
resting stacks within 1e-3 of mgf_tpu's after 300 steps (eager float32
against XLA's fused code), the capacity world's survivors within 1e-5 of
mgf_tpu's, and the kill check at the JAX test's own 1e-6.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from mgf_tpu import world as jworld  # noqa: E402
from mgf_tpu.physics import SceneBuilder as JBuilder  # noqa: E402
from mgf_tpu.scenes import balls_scene as j_balls_scene  # noqa: E402

from mgf_tpu_torch import world as tworld  # noqa: E402
from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402
from mgf_tpu_torch.physics import SceneBuilder  # noqa: E402
from mgf_tpu_torch.scenes import balls_scene  # noqa: E402

CPU = "cpu"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves_equal(jtree, ttree):
    la = jax.tree_util.tree_leaves(_np_tree(jtree))
    lb = jax.tree_util.tree_leaves(world_to_numpy(ttree))
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _shapes(world):
    return [tuple(t.shape) for t in jax.tree_util.tree_leaves(
        world_to_numpy(world))]


def test_scene_builder_validation():
    for B in (SceneBuilder, JBuilder):
        b = B()
        with pytest.raises(ValueError):
            b.add_sphere((0, 0, 0), -1.0, 1.0, 0.3, 0.6)
        with pytest.raises(ValueError):
            b.add_capsule((0, 0, 0), (0, 1, 0), 0.0, 1.0, 0.3, 0.6)
        with pytest.raises(ValueError):
            b.add_sphere((0, 0, 0), 1.0, 0.0, 0.3, 0.6)


def _one_sphere(B, y, **build):
    b = B()
    b.add_sphere((0.0, y, 0.0), 0.5, mass=1.0, restitution=0.0,
                 friction=0.5)
    return b.build(**build)


def test_static_bodies_and_world_surgery():
    """Static colliders (RigidBodyRef::Static) + add/remove between steps,
    in both packages: extend_world and remove_bodies give mgf_tpu's
    world bit for bit, and the stacks come to rest where mgf_tpu's do."""
    worlds = []
    for B, mod, build in ((SceneBuilder, tworld, {"device": CPU}),
                          (JBuilder, jworld, {})):
        b = B()
        b.add_static_spheres([[0.0, 0.0, 0.0]], 1.0, friction=0.5)
        b.add_sphere((0.0, 3.0, 0.0), 0.5, mass=1.0, restitution=0.0,
                     friction=0.5)
        kw = {"device": CPU} if mod is tworld else {}
        worlds.append((mod, mod.make_world(b.build(**build), **kw), B,
                       build))
    cfg_t = tworld.WorldConfig(use_grid=False, max_pairs=4, solver_iters=10)
    cfg_j = jworld.WorldConfig(use_grid=False, max_pairs=4, solver_iters=10)
    (tm, tw, TB, tb), (jm_, jw, JB, jb) = worlds
    step_t, step_j = tm.make_step_fn(cfg_t), jm_.make_step_fn(cfg_j)
    for _ in range(300):
        tw, _ = step_t(tw)
        jw, _ = step_j(jw)
    ys = tw.bodies.x.y.numpy()
    # static anchor must not move; dynamic sphere rests on top
    assert ys[0] == 0.0 and 1.30 < ys[1] < 1.55
    np.testing.assert_allclose(ys, np.asarray(jw.bodies.x.y), atol=1e-3)

    # add a third body mid-simulation: the same world as mgf_tpu's
    # extend_world on the same state
    jw = jworld.extend_world(jw, _one_sphere(JB, 4.0, **jb))
    tw_same = tworld.extend_world(world_from_numpy(
        _np_tree(jworld.remove_bodies(jw, [2])), CPU),
        _one_sphere(TB, 4.0, **tb))
    _leaves_equal(jw, tw_same)
    tw = tworld.extend_world(tw, _one_sphere(TB, 4.0, **tb))
    assert tw.bodies.n_bodies == 3
    step3 = tworld.make_step_fn(cfg_t)
    for _ in range(300):
        tw, _ = step3(tw)
        jw, _ = step_j(jw)
    ys = tw.bodies.x.y.numpy()
    assert ys[2] > 2.0  # rests on the second sphere
    np.testing.assert_allclose(ys, np.asarray(jw.bodies.x.y), atol=1e-3)

    # remove the middle sphere; the top one drops onto the static anchor
    _leaves_equal(jworld.remove_bodies(jw, [1]), tworld.remove_bodies(
        world_from_numpy(_np_tree(jw), CPU), [1]))
    tw = tworld.remove_bodies(tw, [1])
    jw = jworld.remove_bodies(jw, [1])
    assert tw.bodies.n_bodies == 2
    for _ in range(300):
        tw, _ = step_t(tw)
        jw, _ = step_j(jw)
    ys = tw.bodies.x.y.numpy()
    assert ys[0] == 0.0 and 1.30 < ys[1] < 1.55
    np.testing.assert_allclose(ys, np.asarray(jw.bodies.x.y), atol=1e-3)


def _two_spheres(B, **build):
    b = B()
    b.add_spheres(np.asarray([[0.0, 20.0, 0.0], [3.0, 20.0, 0.0]],
                             np.float32), 0.5, mass=1.0, restitution=0.3,
                  friction=0.6)
    return b.build(**build)


def test_capacity_world_no_recompile():
    """Pool semantics (pool.rs:37-113): spawn/kill below capacity are mask
    edits; the same step callable keeps running and no tensor changes
    shape.  Each surgery gives mgf_tpu's world bit for bit on the same
    state, and the free list hands out the same slots."""
    world, cfg = balls_scene(num=3, with_dropped=False, device=CPU)  # 27
    jw0, jcfg = j_balls_scene(num=3, with_dropped=False)
    world = tworld.with_capacity(world, 40)
    jw = jworld.with_capacity(jw0, 40)
    _leaves_equal(jw, world)
    assert tworld.num_alive(world) == jworld.num_alive(jw) == 27
    f = tworld.make_step_fn(cfg)
    fj = jax.jit(functools.partial(jworld.step, cfg=jcfg))
    shapes = _shapes(world)
    w = world
    for _ in range(3):
        w, m = f(w)
        jw, jm = fj(jw)
    assert int(m["num_alive"]) == 27 and _shapes(w) == shapes

    w, idx = tworld.spawn_bodies(w, _two_spheres(SceneBuilder, device=CPU))
    jw_s, jidx = jworld.spawn_bodies(jw, _two_spheres(JBuilder))
    assert isinstance(idx, np.ndarray)
    assert list(idx) == list(jidx) == [27, 28]   # first dead rows reused
    _leaves_equal(jw_s, tworld.spawn_bodies(
        world_from_numpy(_np_tree(jw), CPU),
        _two_spheres(SceneBuilder, device=CPU))[0])
    jw = jw_s
    assert tworld.num_alive(w) == 29
    for _ in range(3):
        w, m = f(w)
        jw, jm = fj(jw)
    assert _shapes(w) == shapes, "spawn_bodies must not change a shape"
    assert int(m["num_alive"]) == 29
    # the spawned bodies actually simulate (gravity pulls them down)
    ys = w.bodies.x.y.numpy()[list(idx)]
    assert (ys < 20.0 - 1e-4).all()
    np.testing.assert_allclose(w.bodies.x.y.numpy(),
                               np.asarray(jw.bodies.x.y), atol=1e-3)

    _leaves_equal(jworld.kill_bodies(jw, jidx), tworld.kill_bodies(
        world_from_numpy(_np_tree(jw), CPU), idx))
    w = tworld.kill_bodies(w, idx)
    assert tworld.num_alive(w) == 27
    for _ in range(2):
        w, m = f(w)
    assert _shapes(w) == shapes, "kill_bodies must not change a shape"
    assert int(m["num_alive"]) == 27
    assert not np.isnan(w.bodies.x.y.numpy()).any()

    # slot REUSE: spawning again fills the killed rows (stable indices)
    w2, idx2 = tworld.spawn_bodies(w, _two_spheres(SceneBuilder,
                                                   device=CPU))
    assert list(idx2) == [27, 28]


def test_capacity_kill_matches_never_spawned():
    """Killing a body leaves survivors on the trajectory they would have
    had if it had never been spawned (its dead row is bit-identical to a
    capacity pad row), in the port as in mgf_tpu, and the port's
    survivors track mgf_tpu's."""
    world, cfg = balls_scene(num=3, with_dropped=True, device=CPU)  # 28
    f = tworld.make_step_fn(cfg)

    # A: capacity world, dropped ball killed after 2 steps
    wa = tworld.with_capacity(world, 32)
    for _ in range(2):
        wa, _ = f(wa)
    wa_before = wa
    wa = tworld.kill_bodies(wa, [27])
    # the caller's world is untouched (surgery returns new tensors)
    assert float(wa_before.bodies.shape_r[27]) > 0.0
    for _ in range(4):
        wa, _ = f(wa)

    # B: the dropped ball never existed (same capacity, same rows)
    wb, _ = balls_scene(num=3, with_dropped=False, device=CPU)
    wb = tworld.with_capacity(wb._replace(
        terrain=world.terrain, terrain_center=world.terrain_center), 32)
    wb = tworld.kill_bodies(wb, [])       # no-op; keeps tree structure
    for _ in range(6):
        wb, _ = f(wb)
    np.testing.assert_allclose(wa.bodies.x.y.numpy()[:27],
                               wb.bodies.x.y.numpy()[:27], atol=1e-6)

    jworld0, jcfg = j_balls_scene(num=3, with_dropped=True)
    fj = jax.jit(functools.partial(jworld.step, cfg=jcfg))
    ja = jworld.with_capacity(jworld0, 32)
    for _ in range(2):
        ja, _ = fj(ja)
    ja = jworld.kill_bodies(ja, [27])
    for _ in range(4):
        ja, _ = fj(ja)
    np.testing.assert_allclose(wa.bodies.x.y.numpy(),
                               np.asarray(ja.bodies.x.y), atol=1e-5)


def test_surgery_guards_match_jax():
    """with_capacity's and spawn_bodies' refusals, in mgf_tpu's order: a
    capacity below the body count first, then a full pad of zero is the
    world itself, then a warm state refuses the pad."""
    world, cfg = balls_scene(num=2, with_dropped=False, device=CPU)  # 8
    with pytest.raises(ValueError, match="capacity 4 < current bodies 8"):
        tworld.with_capacity(world, 4)
    assert tworld.with_capacity(world, 8) is world
    warm = tworld.init_warm(world, cfg._replace(warm_start=True))
    assert tworld.with_capacity(warm, 8) is warm
    with pytest.raises(ValueError, match="BEFORE init_warm"):
        tworld.with_capacity(warm, 9)
    full = tworld.with_capacity(world, 9)
    b = SceneBuilder()
    b.add_spheres(np.zeros((2, 3), np.float32), 0.5, mass=1.0,
                  restitution=0.3, friction=0.6)
    with pytest.raises(ValueError, match="1 free slots, need 2"):
        tworld.spawn_bodies(full, b.build(CPU))
    assert list(tworld.free_slots(full)) == [8]
    dead = tworld._dead_row_fields(np.asarray([8]))
    assert dead.dtype == np.float32 and float(full.bodies.x.x[8]) == dead[0]
