"""Which terrain path a step takes, on the CPU: the one-pass stage
(``ops.terrain.sphere_terrain_near``, kernel K5 on the card and its plain
version here) serves sphere worlds with the "near" cull of a small mesh
and no contact streams; every other world keeps the inline stage of
``world.step_tail``.

* the flagship's sphere pile goes through the wrapper once a step (full
  and light metrics), and its step is bit-identical to the inline stage's
  (``collect_contacts=True`` takes it);
* the mixed pile, the "grid" cull of ``terrain_scene``, the demo's dense
  terrain and ``collect_contacts=True`` never call the wrapper, nor do
  meshes or candidate counts the kernel cannot hold;
* the spatial (halo-exchange) step of the same sphere pile, on one
  in-process rank, calls it once a step and is bit-identical to its own
  inline stage; its mixed pile does not call it;
* on a hand-built box scene of corners, edges and sweeps across them, the
  plain stage's candidates and masks equal mgf_tpu's terrain stream
  exactly, its times and normals within 1e-4, and the routed step
  matches mgf_tpu's step at tests/test_torch_world.py's tolerances.
"""

import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mgf_tpu import world as jworld  # noqa: E402
from mgf_tpu.physics import SceneBuilder as JSceneBuilder  # noqa: E402
from mgf_tpu.scenes import stress_scene as j_stress_scene  # noqa: E402

from mgf_tpu_torch import world as W  # noqa: E402
from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402
from mgf_tpu_torch.ops import terrain  # noqa: E402
from mgf_tpu_torch.scenes import (  # noqa: E402
    balls_scene, stress_scene, terrain_scene,
)

CPU = "cpu"


@pytest.fixture
def calls(monkeypatch):
    """Counts the step's calls of the one-pass terrain stage."""
    seen = []
    real = W.sphere_terrain_near

    def spy(*args, **kw):
        seen.append(kw.get("with_deepest", True))
        return real(*args, **kw)

    monkeypatch.setattr(W, "sphere_terrain_near", spy)
    return seen


def _leaves(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if t is not None]


@pytest.fixture(scope="module")
def landed():
    """stress_scene(600, layers=2) after 40 steps: the bottom layer rests
    on the floor."""
    world, cfg = stress_scene(600, layers=2, device=CPU)
    for _ in range(40):
        world, _ = W.step(world, cfg)
    return world, cfg


@pytest.mark.parametrize("light", [False, True])
def test_sphere_pile_routes_through_the_wrapper(landed, calls, light):
    world, cfg = landed
    cfg = cfg._replace(light_metrics=light)
    w1, m1 = W.step(world, cfg)
    assert calls == [not light]
    w2, m2 = W.step(world, cfg, collect_contacts=True)
    assert calls == [not light]
    assert light or int(m1["num_contacts"]) > 0   # light steps count none
    a, b = _leaves(w1), _leaves(w2)
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for k in m1:
        assert torch.equal(torch.as_tensor(m1[k]), torch.as_tensor(m2[k])), k


def _mixed():
    return stress_scene(120, mixed=True, layers=2, device=CPU)


def _grid():
    return terrain_scene(40, 8, device=CPU)


def _dense():
    return balls_scene(2, device=CPU)


@pytest.mark.parametrize("make", [_mixed, _grid, _dense],
                         ids=["mixed", "grid", "dense"])
def test_other_worlds_keep_the_inline_stage(calls, make):
    world, cfg = make()
    W.step(world, cfg)
    assert calls == []


def test_streams_keep_the_inline_stage(landed, calls):
    world, cfg = landed
    _, m = W.step(world, cfg, collect_contacts=True)
    assert calls == [] and "terrain_contacts" in m


def _spatial_steps(world, cfg, steps=2):
    """``steps`` spatial steps of ``world`` on one in-process rank (a
    Comm of size 1 needs no process group); the bodies after each."""
    from mgf_tpu_torch.parallel import (init_spatial_bp_cache,
                                        make_spatial_step,
                                        shard_world_spatial)
    from mgf_tpu_torch.parallel.comm import Comm
    comm = Comm(0, 1, CPU, "gloo")
    w, bounds = shard_world_spatial(world._replace(warm=None, bp=None),
                                    comm, cfg=cfg)
    w = init_spatial_bp_cache(w, comm, cfg, 64)
    with warnings.catch_warnings():
        # the spatial step's notes on the solver and the mixed layout
        warnings.simplefilter("ignore")
        f = make_spatial_step(cfg, comm, bounds, halo=64)
    out = []
    for _ in range(steps):
        w, m = f(w)
        out.append((_leaves(w.bodies), m))
    return out


@pytest.fixture
def spatial_calls(monkeypatch):
    """Counts the spatial step's calls of the one-pass terrain stage."""
    from mgf_tpu_torch.parallel import spatial
    seen = []
    real = spatial.sphere_terrain_near

    def spy(*args, **kw):
        seen.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(spatial, "sphere_terrain_near", spy)
    return seen


def test_spatial_sphere_pile_routes_through_the_wrapper(landed, monkeypatch,
                                                        spatial_calls):
    from mgf_tpu_torch.parallel import spatial
    world, cfg = landed
    routed = _spatial_steps(world, cfg)
    assert len(spatial_calls) == 2
    monkeypatch.setattr(spatial, "_one_pass_terrain", lambda *a: False)
    inline = _spatial_steps(world, cfg)
    assert len(spatial_calls) == 2
    assert int(routed[-1][1]["num_contacts"]) > 0
    for (a, ma), (b, mb) in zip(routed, inline):
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        for k in ma:
            assert torch.equal(torch.as_tensor(ma[k]),
                               torch.as_tensor(mb[k])), k


def test_spatial_mixed_pile_keeps_the_inline_stage(spatial_calls):
    world, cfg = _mixed()
    _spatial_steps(world, cfg, steps=1)
    assert spatial_calls == []


def test_route_needs_what_the_kernel_holds():
    _, cfg = stress_scene(50, device=CPU)
    route = W._one_pass_terrain
    assert route(cfg, 10, False)
    assert not route(cfg, 10, True)
    assert not route(cfg, 0, False)
    assert not route(cfg, terrain.MAX_FACES + 1, False)
    assert route(cfg, terrain.MAX_FACES, False)
    assert not route(cfg._replace(terrain_cand=terrain.MAX_CAND + 1), 64,
                     False)
    assert not route(cfg._replace(terrain_cand=4), 3, False)
    for other in (dict(shape_mode="mixed"), dict(shape_mode="capsules"),
                  dict(terrain_bp="grid"), dict(terrain_bp="dense")):
        assert not route(cfg._replace(**other), 10, False)


# the box of the stress scene, wall 8 and 40 high, and twelve spheres at its
# corners and edges, inside and out, resting and swept across them (those
# swept onto an edge start outside its capsule: a sweep that starts inside
# one reports no edge hit)
WALL, HIGH = 8.0, 40.0
BODIES = np.asarray([
    # centre                       velocity
    [-(WALL - 0.45), 0.45, -(WALL - 0.45), 0.0, 0.0, 0.0],   # floor corner
    [WALL - 0.45, 0.45, WALL - 0.45, 3.0, -1.0, 3.0],        # into a corner
    [WALL - 1.2, 0.5, 0.0, 45.0, 0.0, 0.0],                  # into a wall
    [0.6, 0.48, -0.5, -20.0, -2.0, 20.0],     # across the floor's diagonal
    [WALL + 0.45, HIGH + 0.45, 1.0, -15.0, -15.0, 0.0],      # a wall's top
    [WALL + 0.4, 10.0, WALL + 0.4, -20.0, 0.0, -20.0],       # a wall corner
    [WALL + 0.45, -0.45, 2.0, -20.0, 15.0, 0.0],  # the floor's outer edge
    [0.05, 0.49, -0.05, 0.0, 0.0, 0.0],          # on the diagonal, resting
    [-(WALL - 1.0), 1.0, -(WALL - 1.0), -40.0, -40.0, -40.0],
    [0.0, 20.0, 0.0, 0.0, 0.0, 0.0],             # out of reach
    [WALL + 0.3, HIGH + 0.3, WALL + 0.3, -10.0, -10.0, -10.0],  # top corner
    [WALL - 0.5, 5.0, 0.0, 0.0, -30.0, 0.0],     # grazing down a wall
], np.float32)


def _box():
    verts = np.asarray([
        [-WALL, 0.0, -WALL], [-WALL, 0.0, WALL], [WALL, 0.0, WALL],
        [WALL, 0.0, -WALL],
        [-WALL, HIGH, -WALL], [-WALL, HIGH, WALL], [WALL, HIGH, WALL],
        [WALL, HIGH, -WALL]], np.float32)
    faces = np.asarray([(0, 1, 3), (1, 2, 3), (0, 5, 1), (0, 4, 5),
                        (0, 3, 7), (0, 7, 4), (2, 6, 3), (3, 6, 7),
                        (1, 5, 2), (2, 5, 6)], np.int32)
    return verts, faces


@pytest.fixture(scope="module")
def corner_scene():
    """The scene in mgf_tpu (the flagship's config at its own 64-body
    grid), its jitted step with the contact streams, and the port's
    world from the same arrays."""
    _, cfg = j_stress_scene(64)
    b = JSceneBuilder()
    b.add_spheres(BODIES[:, :3], 0.5, mass=1.0, restitution=0.3,
                  friction=0.6)
    bodies = b.build()
    v = BODIES[:, 3:]
    bodies = bodies._replace(v=type(bodies.v)(*(jnp.asarray(v[:, k])
                                                 for k in range(3))))
    jw = jworld.make_world(bodies, *_box())
    jw = jworld.init_bp_cache(jworld.init_warm(jw, cfg), cfg)
    f = jax.jit(functools.partial(jworld.step, cfg=cfg,
                                  collect_contacts=True))
    jw2, jm = f(jw)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return (world_from_numpy(np_tree(jw), CPU), W.WorldConfig(*cfg),
            np_tree(jw2), np_tree(jm))


def test_plain_stage_matches_jax_at_corners_and_edges(corner_scene):
    tw, tcfg, _, jm = corner_scene
    s = W.step_head(tw, tcfg).state
    man, tris, deep = terrain.sphere_terrain_near_reference(
        s.x, s.delta, s.shape_r, s.shape_half_h, tw.terrain,
        tw.terrain_center, tcfg.terrain_cand, tcfg.stable_pairs)
    js = jm["terrain_contacts"]
    np.testing.assert_array_equal(tris.reshape(-1).numpy(), js["tri"])
    valid = man.valid.reshape(-1).numpy()
    np.testing.assert_array_equal(valid, js["contact"].valid.reshape(-1))
    np.testing.assert_allclose(man.time.reshape(-1).numpy()[valid],
                               js["contact"].t.reshape(-1)[valid],
                               atol=1e-4, rtol=0)
    for a, b in zip(man.normal, js["contact"].n):
        np.testing.assert_allclose(a.reshape(-1).numpy()[valid],
                                   b.reshape(-1)[valid], atol=1e-4, rtol=0)
    # what the scene exercises: the corners' two and three faces, sweeps,
    # and the contacts only an edge test finds (a wall's top, the floor's
    # outer edge: their plane points fall outside every face)
    per_body = man.valid[0].sum(0)
    assert int(per_body[0]) >= 2 and int(per_body[9]) == 0
    assert bool(per_body[4]) and bool(per_body[5]) and bool(per_body[6])
    assert bool((man.time[man.valid[0]] > 0).any())
    np.testing.assert_allclose(float(deep), float(
        np.max(np.where(js["contact"].valid, np.maximum(-sum(
            (bb - aa) * nn for aa, bb, nn in zip(
                js["contact"].a, js["contact"].b, js["contact"].n)), 0.0),
            0.0))), atol=1e-5)


def test_routed_step_matches_jax_at_corners_and_edges(corner_scene, calls):
    tw, tcfg, jw2, jm = corner_scene
    tw2, tm = W.step(tw, tcfg)
    assert calls == [True]
    tm, tw2 = world_to_numpy(tm), world_to_numpy(tw2)
    for k in ("num_contacts", "num_pairs", "broadphase_overflow"):
        assert int(jm[k]) == int(tm[k]), k
    np.testing.assert_allclose(jm["max_penetration"], tm["max_penetration"],
                               atol=1e-5)
    for f, tol in (("x", 1e-6), ("delta", 1e-6), ("v", 2e-4),
                   ("omega", 2e-4)):
        for a, b in zip(getattr(jw2.bodies, f), getattr(tw2.bodies, f)):
            np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=f)
