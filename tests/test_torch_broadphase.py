"""Exact parity of the port's fat-grid broadphase (build_fat_grid(width=4)
+ fat_grid_pairs(window="27") + world._stable_sort_pairs) with mgf_tpu's,
on a stress_scene(2000) pile.

The partner lists, ok masks, overflow counts and the grid table itself must
be bit-identical: the key arithmetic is int32 on both sides, the sort is
stable, and rows JAX drops with mode='drop' go to a sliced-off sentinel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mgf_tpu import broadphase as jbp  # noqa: E402
from mgf_tpu import world as jworld  # noqa: E402
from mgf_tpu.bounds import sphere_aabb as j_sphere_aabb  # noqa: E402
from mgf_tpu.geom import Sphere as JSphere  # noqa: E402
from mgf_tpu.math3d import Vec3 as JVec3  # noqa: E402
from mgf_tpu.scenes import stress_scene as j_stress_scene  # noqa: E402

from mgf_tpu_torch import broadphase as tbp  # noqa: E402
from mgf_tpu_torch import world as tworld  # noqa: E402
from mgf_tpu_torch.bounds import sphere_aabb as t_sphere_aabb  # noqa: E402
from mgf_tpu_torch.geom import Sphere as TSphere  # noqa: E402
from mgf_tpu_torch.math3d import Vec3 as TVec3  # noqa: E402

N_BODIES = 2000


@pytest.fixture(scope="module")
def pile():
    """Positions, radii and sweeps of a jostled stress_scene(2000) pile,
    with a few dead rows (shape_r <= 0) that must stay out of the table."""
    world, cfg = j_stress_scene(N_BODIES)
    rng = np.random.default_rng(7)
    x = np.stack([np.asarray(c) for c in world.bodies.x], -1)
    x = (x + rng.normal(0.0, 0.25, x.shape)).astype(np.float32)
    x[:, 1] = np.maximum(x[:, 1] - 2.0, 0.5)     # compress toward the floor
    delta = rng.normal(0.0, 0.02, x.shape).astype(np.float32)
    r = np.asarray(world.bodies.shape_r).copy()
    r[rng.choice(N_BODIES, 25, replace=False)] = -1.0
    slack = rng.uniform(0.0, 0.2, N_BODIES).astype(np.float32)
    return x, delta, r, slack, cfg


def _bounds(mods, vec, arr, x, delta, r, slack, fatten):
    bp_mod, aabb, sphere = mods
    b = bp_mod.swept_fat_bounds(aabb(sphere(c=vec(x), r=arr(r))), vec(delta),
                                fatten)
    s = arr(slack)
    return b._replace(r=type(b.r)(b.r.x + s, b.r.y + s, b.r.z + s))


@pytest.mark.parametrize("cap", [12, 3])
def test_fat_grid_pairs_exact(pile, cap):
    """cap 12 is the flagship grid; cap 3 forces bucket overflow so the
    stable rank order decides which bodies are dropped."""
    x, delta, r, slack, cfg = pile
    jv = lambda a: JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))
    tv = lambda a: TVec3(*(torch.as_tensor(np.ascontiguousarray(a[:, k]))
                           for k in range(3)))
    jg = jbp.GridConfig(cell_size=cfg.grid.cell_size, dim=cfg.grid.dim,
                        bucket_cap=cap)
    tg = tbp.GridConfig(cell_size=cfg.grid.cell_size, dim=cfg.grid.dim,
                        bucket_cap=cap)
    jb = _bounds((jbp, j_sphere_aabb, JSphere), jv, jnp.asarray,
                 x, delta, r, slack, cfg.fatten)
    tb = _bounds((tbp, t_sphere_aabb, TSphere), tv, torch.as_tensor,
                 x, delta, r, slack, cfg.fatten)
    for cj, ct in zip(jb.c + jb.r, tb.c + tb.r):
        np.testing.assert_array_equal(np.asarray(cj), ct.numpy())

    alive = r > 0
    jgrid = jbp.build_fat_grid(jb, jg, width=4, valid=jnp.asarray(alive))
    tgrid = tbp.build_fat_grid(tb, tg, width=4,
                               valid=torch.as_tensor(alive))
    np.testing.assert_array_equal(np.asarray(jgrid.table),
                                  tgrid.table.numpy())
    assert int(jgrid.overflow) == int(tgrid.overflow)
    assert tgrid.overflow.dtype == torch.int32
    if cap == 3:
        assert int(tgrid.overflow) > 0
    else:
        assert int(tgrid.overflow) == 0

    jp, jok = jbp.fat_grid_pairs(jb, jgrid, jg, 9, ordered=False,
                                 window="27")
    tp, tok = tbp.fat_grid_pairs(tb, tgrid, tg, 9, ordered=False,
                                 window="27")
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    assert tp.dtype == torch.int32

    jp, jok = jworld._stable_sort_pairs(jp, jok)
    tp, tok = tworld._stable_sort_pairs(tp, tok)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    # non-degenerate: most live bodies have partners, dead rows none
    assert tok.numpy()[alive].any(axis=1).mean() > 0.9
    assert not np.isin(np.nonzero(~alive)[0], tp.numpy()).any()


def test_bucket_ranks_runs():
    """Rank within runs of equal keys (the cummax form of the JAX
    package's associative max scan)."""
    h = np.asarray([0, 0, 0, 2, 2, 5, 7, 7, 7, 7], np.int32)
    want = np.asarray(jbp._bucket_ranks(jnp.asarray(h), h.shape[0]))
    got = tbp._bucket_ranks(torch.as_tensor(h)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 1, 2, 0, 1, 0, 0, 1, 2, 3])


@pytest.fixture(scope="module")
def lattice():
    """The unjittered 217-ball demo lattice (balls_scene(6)) one frame into
    its fall: every centre sits on the 1.25 lattice, so many candidates
    tie on distance and the top-k tie order decides the slots."""
    from mgf_tpu.scenes import balls_scene
    world, cfg = balls_scene(6)
    x = np.stack([np.asarray(c) for c in world.bodies.x], -1)
    delta = np.tile(np.asarray([[0.0, -9.8 / 3600.0, 0.0]], np.float32),
                    (x.shape[0], 1))
    r = np.asarray(world.bodies.shape_r)
    return x, delta, r, cfg


@pytest.mark.parametrize("cap,ordered", [(10, False), (3, False),
                                         (10, True)])
def test_packed_grid_pairs_exact(lattice, cap, ordered):
    """build_grid + neighbor_candidates + refine_pairs bit-exact against
    mgf_tpu: the demo's cap-10 grid, and a cap-3 grid whose full buckets
    overflow (the stable sort's rank order decides who is dropped)."""
    x, delta, r, cfg = lattice
    jv = lambda a: JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))
    tv = lambda a: TVec3(*(torch.as_tensor(np.ascontiguousarray(a[:, k]))
                           for k in range(3)))
    jg = jbp.GridConfig(cell_size=cfg.grid.cell_size, dim=cfg.grid.dim,
                        bucket_cap=cap)
    tg = tbp.GridConfig(cell_size=cfg.grid.cell_size, dim=cfg.grid.dim,
                        bucket_cap=cap)
    zero = np.zeros_like(r)
    jb = _bounds((jbp, j_sphere_aabb, JSphere), jv, jnp.asarray,
                 x, delta, r, zero, cfg.fatten)
    tb = _bounds((tbp, t_sphere_aabb, TSphere), tv, torch.as_tensor,
                 x, delta, r, zero, cfg.fatten)
    alive = np.ones(r.shape, bool)
    alive[5] = False                        # a dead row stays out
    jt = jbp.build_grid(jb.c, jg, valid=jnp.asarray(alive))
    tt = tbp.build_grid(tb.c, tg, valid=torch.as_tensor(alive))
    np.testing.assert_array_equal(np.asarray(jt.table), tt.table.numpy())
    assert int(jt.overflow) == int(tt.overflow)
    assert (int(tt.overflow) > 0) == (cap == 3)
    jc = jbp.neighbor_candidates(jb.c, jt, jg)
    tc = tbp.neighbor_candidates(tb.c, tt, tg)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    jp, jok = jbp.refine_pairs(jb, jc, cfg.max_pairs, ordered=ordered)
    tp, tok = tbp.refine_pairs(tb, tc, cfg.max_pairs, ordered=ordered)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    assert tp.dtype == torch.int32
    # ties really decide slots: some body has more candidates in reach
    # than max_pairs, at equal distances
    assert ((tc.numpy() >= 0).sum(axis=1)).max() > cfg.max_pairs
    if not ordered:
        assert tok.numpy().sum(axis=1).max() == cfg.max_pairs
    jp, jok = jworld._stable_sort_pairs(jp, jok)
    tp, tok = tworld._stable_sort_pairs(tp, tok)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


def test_all_pairs_refine_exact(lattice):
    """refine_pairs over the O(N^2) candidate matrix, both pad and top-k
    paths, bit-exact against mgf_tpu."""
    x, delta, r, cfg = lattice
    n = 40
    x, delta, r = x[:n], delta[:n], r[:n]
    jv = lambda a: JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))
    tv = lambda a: TVec3(*(torch.as_tensor(np.ascontiguousarray(a[:, k]))
                           for k in range(3)))
    zero = np.zeros_like(r)
    jb = _bounds((jbp, j_sphere_aabb, JSphere), jv, jnp.asarray,
                 x, delta, r, zero, 0.5)
    tb = _bounds((tbp, t_sphere_aabb, TSphere), tv, torch.as_tensor,
                 x, delta, r, zero, 0.5)
    jc = jbp.all_pairs_candidates(n)
    tc = tbp.all_pairs_candidates(n, "cpu")
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    for max_pairs in (8, n + 4):
        jp, jok = jbp.refine_pairs(jb, jc, max_pairs, ordered=False)
        tp, tok = tbp.refine_pairs(tb, tc, max_pairs, ordered=False)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
        assert tok.numpy().any()
