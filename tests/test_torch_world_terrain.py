"""The port's mesh terrain step (``terrain_bp="grid"``: the static face
table, the 27-cell window cull with its fused distance | face-id key) and
its row compaction (``solver_rows``) against mgf_tpu's.

* ``terrain_scene(160, 16)``, the rain dropped 5 units as
  tests/test_terrain.py's partition test drops it, is stepped by mgf_tpu
  until the step holds both terrain and pair contacts; one port step from
  the same state is compared with the JAX step.  Exact: the grid cull's
  candidate faces and their mask (against a numpy transcription of the
  JAX stage on the JAX state), the terrain and pair streams, their masks,
  ``solver_rows_dropped``, ``terrain_reach_excess`` and every contact
  count.  v within 1e-5 and omega within 1e-4, as the mixed tests hold
  them (a capsule's inverse inertia multiplies summation-order noise into
  omega).
* ``balls_scene(4)`` with ``solver_rows`` 8 (the compaction on a
  warm-start-free sphere config: rows reordered, none dropped) and 1 (the
  stacked columns' bottom balls hold the floor and the ball above: rows
  dropped), one step from a JAX state with the block on the floor:
  ``solver_rows_dropped`` exact, v and omega within 1e-5.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from mgf_tpu.scenes import balls_scene as j_balls_scene  # noqa: E402
from mgf_tpu.scenes import terrain_scene as j_terrain_scene  # noqa: E402
from mgf_tpu.world import step as j_step  # noqa: E402

from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402
from mgf_tpu_torch import world as tworld  # noqa: E402
from mgf_tpu_torch.physics import integrate  # noqa: E402
from mgf_tpu_torch.world import WorldConfig, step  # noqa: E402

CPU = "cpu"
TOL_V = 1e-5
TOL_W = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _vel_errs(jw, tw):
    err = lambda f: max(float(np.abs(np.asarray(a) - b.numpy()).max())
                        for a, b in zip(getattr(jw.bodies, f),
                                        getattr(tw.bodies, f)))
    return err("v"), err("omega")


@pytest.fixture(scope="module")
def terrain_step():
    """(JAX state before the compared step, the JAX step's (world,
    metrics), cfg): the first step with terrain AND pair contacts (step 43:
    the rain's lowest layer has reached the heightfield)."""
    world, cfg = j_terrain_scene(n_bodies=160, grid_n=16)
    world = world._replace(bodies=world.bodies._replace(
        x=world.bodies.x._replace(y=world.bodies.x.y - 5.0)))
    f = jax.jit(functools.partial(j_step, cfg=cfg, collect_contacts=True))
    for k in range(60):
        out = _np_tree(f(world))
        m = out[1]
        n_t = int(m["terrain_contacts"]["contact"].valid.sum())
        n_p = int(m["pair_contacts"]["contact"].valid.sum())
        if k >= 4 and n_t > 0 and n_p > 0:
            return _np_tree(world), out, cfg
        world = out[0]
    raise AssertionError("no step with terrain and pair contacts")


def _np_grid_cull(table, x, cell, dim, k_cand):
    """mgf_tpu/world.py's "grid" candidate stage in numpy: the 27 window
    rows' fused keys, the 4x top, the adjacent duplicates masked, the
    top k.  Returns (face ids (N, k), ok)."""
    cap = table.shape[1] // 4
    c = [np.floor(comp / np.float32(cell)).astype(np.int32) for comp in x]
    inv_scale = np.float32(16383.0 / (3.0 * cell) ** 2)
    keys = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                h = ((((c[0] + dx) & (dim - 1)) * dim
                      + ((c[1] + dy) & (dim - 1))) * dim
                     + ((c[2] + dz) & (dim - 1)))
                rows = table[h]
                fid = rows[:, :cap]
                d = [rows[:, (a + 1) * cap:(a + 2) * cap] - x[a][:, None]
                     for a in range(3)]
                d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
                q = np.minimum((d2 * inv_scale).astype(np.int32), 16383)
                keys.append(np.where(fid >= 0, ((16383 - q) << 17)
                                     | fid.astype(np.int32), -1))
    keym = np.concatenate(keys, axis=1)
    top1 = -np.sort(-keym, axis=1)[:, :min(4 * k_cand, keym.shape[1])]
    dup = np.zeros_like(top1, bool)
    dup[:, 1:] = top1[:, 1:] == top1[:, :-1]
    top2 = -np.sort(-np.where(dup, -1, top1), axis=1)[:, :k_cand]
    ok = top2 >= 0
    return np.where(ok, top2 & 0x1FFFF, -1), ok


def test_grid_cull_matches_jax_stage(terrain_step):
    state, _, cfg = terrain_step
    tcfg = WorldConfig(*cfg)
    tw = world_from_numpy(state, CPU)
    # the cull reads the integrated positions, as the step does
    st = integrate(tw.bodies, tcfg.dt)
    cand, ok, excess = tworld._grid_terrain(tw, st, tcfg)
    tg = cfg.terrain_grid_cfg
    ref, ref_ok = _np_grid_cull(state.terrain_grid,
                                [c.numpy() for c in st.x], tg.cell_size,
                                tg.dim, cfg.terrain_cand)
    np.testing.assert_array_equal(ok.numpy(), ref_ok)
    np.testing.assert_array_equal(cand.numpy(), ref)
    assert ref_ok.any(axis=1).sum() > 20          # bodies over the mesh
    assert float(excess) == 0.0


def test_terrain_step_matches_jax(terrain_step):
    state, (jw, jm), cfg = terrain_step
    tw, tm = step(world_from_numpy(state, CPU), WorldConfig(*cfg),
                  collect_contacts=True)
    tm = world_to_numpy(tm)
    for key in ("num_contacts", "num_constraints", "num_pairs",
                "solver_rows_dropped", "broadphase_overflow"):
        assert int(np.asarray(jm[key])) == int(tm[key]), key
    assert float(jm["terrain_reach_excess"]) == float(
        tm["terrain_reach_excess"]) == 0.0
    for kind, other in (("pair_contacts", "j"), ("terrain_contacts", "tri")):
        js, ts = jm[kind], tm[kind]
        np.testing.assert_array_equal(js["i"], ts["i"])
        np.testing.assert_array_equal(js[other], ts[other])
        np.testing.assert_array_equal(js["contact"].valid,
                                      ts["contact"].valid)
        assert int(ts["contact"].valid.sum()) > 0, kind
    ev, ew = _vel_errs(jw, tw)
    print(f"terrain step: max |dv| {ev:.3g}, |domega| {ew:.3g} vs JAX")
    assert ev <= TOL_V and ew <= TOL_W, (ev, ew)


@pytest.fixture(scope="module")
def balls_block():
    """balls_scene(4) after 150 steps (the block on the floor), as a numpy
    tree, and its config."""
    world, cfg = j_balls_scene(num=4, with_dropped=True)
    f = jax.jit(functools.partial(j_step, cfg=cfg))
    for _ in range(150):
        world, _ = f(world)
    return _np_tree(world), cfg


@pytest.mark.parametrize("rows", [8, 1])
def test_solver_rows_compaction_matches_jax(balls_block, rows):
    state, cfg = balls_block
    cfg = cfg._replace(solver_rows=rows)
    jw, jm = _np_tree(jax.jit(functools.partial(j_step, cfg=cfg))(state))
    tw, tm = step(world_from_numpy(state, CPU), WorldConfig(*cfg))
    for key in ("num_contacts", "num_constraints", "solver_rows_dropped"):
        assert int(np.asarray(jm[key])) == int(tm[key]), key
    assert int(tm["num_constraints"]) == rows * 65
    assert (int(tm["solver_rows_dropped"]) > 0) == (rows == 1)
    ev, ew = _vel_errs(jw, tw)
    print(f"solver_rows={rows}: dropped {int(tm['solver_rows_dropped'])}, "
          f"max |dv| {ev:.3g}, |domega| {ew:.3g} vs JAX")
    assert ev <= TOL_V and ew <= TOL_V, (ev, ew)
