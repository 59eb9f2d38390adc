"""Exact parity of the port's remaining fat-grid variants with mgf_tpu's:
width-8 bucket rows, the "sel8" octant window, the per-slot width-8 cull,
the ``self_rows`` / ``query_centers`` queries the multi-device paths make,
``refine_pairs`` over a subset of rows, and the float-score selection past
2^17 bodies.

Every table, partner list and validity mask must be bit-identical: the
fused key is int32 arithmetic on both sides, the float scores come from
the same float32 operations, and ``lax.top_k``'s lower-index-first tie
order is a stable descending sort in the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mgf_tpu import broadphase as jbp  # noqa: E402
from mgf_tpu.bounds import sphere_aabb as j_sphere_aabb  # noqa: E402
from mgf_tpu.geom import Sphere as JSphere  # noqa: E402
from mgf_tpu.math3d import Vec3 as JVec3  # noqa: E402

from mgf_tpu_torch import broadphase as tbp  # noqa: E402
from mgf_tpu_torch.bounds import sphere_aabb as t_sphere_aabb  # noqa: E402
from mgf_tpu_torch.geom import Sphere as TSphere  # noqa: E402
from mgf_tpu_torch.math3d import Vec3 as TVec3  # noqa: E402

jv = lambda a: JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))
tv = lambda a: TVec3(*(torch.as_tensor(np.ascontiguousarray(a[:, k]))
                       for k in range(3)))


def _both_bounds(x, delta, r, slack, fatten):
    """The same swept fat bounds in both packages (with a per-body slack,
    as the broadphase cache adds), checked bit-equal."""
    out = []
    for mod, aabb, sphere, vec, arr in (
            (jbp, j_sphere_aabb, JSphere, jv, jnp.asarray),
            (tbp, t_sphere_aabb, TSphere, tv, torch.as_tensor)):
        b = mod.swept_fat_bounds(aabb(sphere(c=vec(x), r=arr(r))),
                                 vec(delta), fatten)
        s = arr(slack)
        out.append(b._replace(r=type(b.r)(b.r.x + s, b.r.y + s, b.r.z + s)))
    for cj, ct in zip(out[0].c + out[0].r, out[1].c + out[1].r):
        np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    return out


def _grids(cell, dim, cap):
    return (jbp.GridConfig(cell_size=cell, dim=dim, bucket_cap=cap),
            tbp.GridConfig(cell_size=cell, dim=dim, bucket_cap=cap))


@pytest.fixture(scope="module")
def pile():
    """A jostled 12-layer block of 2,000 r=0.5 spheres on the floor with
    mixed sweeps and slacks (so per-occupant radii differ) and 25 dead
    rows (shape_r <= 0) that must stay out of every table."""
    n, layers, side = 2000, 12, 13
    rng = np.random.default_rng(11)
    i = np.arange(n)
    x = np.stack([(i // (side * layers) - side / 2) * 1.25,
                  0.6 + (i % layers) * 1.05,
                  ((i // layers) % side - side / 2) * 1.25], -1)
    x = (x + rng.normal(0.0, 0.2, x.shape)).astype(np.float32)
    delta = rng.normal(0.0, 0.03, x.shape).astype(np.float32)
    r = np.full(n, 0.5, np.float32)
    r[rng.choice(n, 25, replace=False)] = -1.0
    slack = rng.uniform(0.0, 0.15, n).astype(np.float32)
    return x, delta, r, slack


@pytest.mark.parametrize("cap", [24, 3])
def test_width8_table_exact(pile, cap):
    """The width-8 rows [cx cy cz r_eff idx+0.5 0 0 0] (empty: slot 4 =
    -1) and the overflow count; cap 3 forces overflow, so the stable rank
    decides who is dropped."""
    x, delta, r, slack = pile
    jb, tb = _both_bounds(x, delta, r, slack, 0.02)
    jg, tg = _grids(2.4, (32, 16, 32), cap)
    alive = r > 0
    jgrid = jbp.build_fat_grid(jb, jg, width=8, valid=jnp.asarray(alive))
    tgrid = tbp.build_fat_grid(tb, tg, width=8, valid=torch.as_tensor(alive))
    np.testing.assert_array_equal(np.asarray(jgrid.table),
                                  tgrid.table.numpy())
    assert int(jgrid.overflow) == int(tgrid.overflow)
    assert float(jgrid.r_max) == float(tgrid.r_max)
    assert tgrid.width == 8 and tgrid.table.shape[1] == 8 * cap
    assert (int(tgrid.overflow) > 0) == (cap == 3)
    empty = tgrid.table.numpy().reshape(-1, cap, 8)[..., 4] < 0
    assert empty.any() and (~empty).sum() == alive.sum() - int(
        tgrid.overflow)


# (width, window, ordered, subset): every fat-mode pairing of width and
# window (fat: 8/"27", fat8: 8/"sel8", fat8x4: 4/"sel8", fat27x4: 4/"27"),
# both pair orders, and queries by a slice or a scattered subset of rows
# (self_rows with query_centers, as the multi-device steps make them)
VARIANTS = [(8, "27", False, None), (8, "27", True, None),
            (8, "sel8", False, None), (8, "sel8", True, None),
            (4, "sel8", False, None), (4, "sel8", True, None),
            (8, "sel8", False, "slice"), (4, "sel8", False, "scatter"),
            (4, "27", False, "slice"), (8, "27", True, "scatter")]


@pytest.mark.parametrize("width,window,ordered,subset", VARIANTS)
def test_fat_grid_pairs_variants_exact(pile, width, window, ordered,
                                       subset):
    x, delta, r, slack = pile
    jb, tb = _both_bounds(x, delta, r, slack, 0.02)
    # the sel8 window guarantees reach cell/2: the scene's sel8 grid
    cell, cap = (2.4, 24) if window == "sel8" else (1.6, 12)
    jg, tg = _grids(cell, (32, 16, 32), cap)
    alive = r > 0
    jgrid = jbp.build_fat_grid(jb, jg, width=width, valid=jnp.asarray(alive))
    tgrid = tbp.build_fat_grid(tb, tg, width=width,
                               valid=torch.as_tensor(alive))
    kw_j, kw_t = {}, {}
    if subset is not None:
        rows = (np.arange(500, 1300) if subset == "slice" else
                np.sort(np.random.default_rng(3).choice(
                    x.shape[0], 700, replace=False)))
        rows = rows.astype(np.int32)
        kw_j = dict(self_rows=jnp.asarray(rows),
                    query_centers=JVec3(*(c[rows] for c in jb.c)))
        kw_t = dict(self_rows=torch.as_tensor(rows),
                    query_centers=TVec3(*(c[torch.as_tensor(rows).long()]
                                          for c in tb.c)))
    jp, jok = jbp.fat_grid_pairs(jb, jgrid, jg, 9, ordered=ordered,
                                 window=window, **kw_j)
    tp, tok = tbp.fat_grid_pairs(tb, tgrid, tg, 9, ordered=ordered,
                                 window=window, **kw_t)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    assert tp.dtype == torch.int32 and tok.dtype == torch.bool
    own = alive if subset is None else alive[rows]
    assert tok.numpy()[own].any(axis=1).mean() > (0.5 if ordered else 0.9)
    assert not np.isin(np.nonzero(~alive)[0], tp.numpy()).any()


def test_sel8_octant_choice():
    """The octant per axis is the own cell and the neighbour on the side
    of the cell's midpoint the point lies in (p - c*cell > cell/2).  Pair
    reach past cell/2 is not guaranteed: of two r=0.8 spheres 1.5 apart
    across the boundary x = 2.4, the one in the low half of cell 0 looks
    at cells -1 and 0 and misses the other, which looks back and finds
    it; pairs within the guarantee are found from both sides."""
    cell = 2.4
    x = np.asarray([[1.0, 5.0, 1.0], [2.5, 5.0, 1.0],
                    [1.9, 13.0, 1.0], [2.8, 13.0, 1.0],
                    [3.5, 20.0, 1.0], [4.4, 20.0, 1.0]], np.float32)
    r = np.asarray([0.8, 0.8, 0.5, 0.5, 0.5, 0.5], np.float32)
    z = np.zeros_like(x)
    jb, tb = _both_bounds(x, z, r, np.zeros(6, np.float32), 0.0)
    jg, tg = _grids(cell, (16, 16, 16), 4)
    out = []
    for mod, b, g in ((jbp, jb, jg), (tbp, tb, tg)):
        grid = mod.build_fat_grid(b, g, width=8)
        p, ok = mod.fat_grid_pairs(b, grid, g, 2, ordered=False,
                                   window="sel8")
        out.append((np.asarray(p), np.asarray(ok)))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    p = out[1][0]
    assert p[0].tolist() == [-1, -1] and p[1].tolist() == [0, -1]
    assert p[2].tolist() == [3, -1] and p[3].tolist() == [2, -1]
    assert p[4].tolist() == [5, -1] and p[5].tolist() == [4, -1]


def test_refine_pairs_self_rows_exact(pile):
    """refine_pairs over a scattered subset of candidate rows, with and
    without a caller's pack_bounds."""
    x, delta, r, slack = pile
    jb, tb = _both_bounds(x, delta, r, slack, 0.02)
    jg, tg = _grids(1.6, (32, 16, 32), 12)
    rows = np.sort(np.random.default_rng(5).choice(
        x.shape[0], 600, replace=False)).astype(np.int32)
    jc = jbp.neighbor_candidates(
        JVec3(*(c[rows] for c in jb.c)),
        jbp.build_grid(jb.c, jg, valid=jnp.asarray(r > 0)), jg)
    tc = tbp.neighbor_candidates(
        TVec3(*(c[torch.as_tensor(rows).long()] for c in tb.c)),
        tbp.build_grid(tb.c, tg, valid=torch.as_tensor(r > 0)), tg)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    for packed in (False, True):
        jp, jok = jbp.refine_pairs(
            jb, jc, 9, self_rows=jnp.asarray(rows), ordered=False,
            packed=jbp.pack_bounds(jb) if packed else None)
        tp, tok = tbp.refine_pairs(
            tb, tc, 9, self_rows=torch.as_tensor(rows), ordered=False,
            packed=tbp.pack_bounds(tb) if packed else None)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
        assert tok.numpy().any(axis=1).mean() > 0.9


@pytest.fixture(scope="module")
def sparse():
    """140,000 bodies (past the fused key's 2^17) spread over the whole
    128 x 16 x 128 grid modulus at cell 1.6, about half a body per cell,
    so a small bucket cap still sees neighbours and some overflow."""
    n = 140_000
    rng = np.random.default_rng(17)
    span = np.asarray([128 * 1.6, 16 * 1.6, 128 * 1.6], np.float32)
    x = (rng.uniform(0.0, 1.0, (n, 3)) * span).astype(np.float32)
    delta = rng.normal(0.0, 0.02, x.shape).astype(np.float32)
    r = rng.uniform(0.3, 0.7, n).astype(np.float32)
    r[rng.choice(n, 100, replace=False)] = -1.0
    return x, delta, r


@pytest.mark.parametrize("width,window", [(4, "27"), (8, "sel8")])
def test_float_score_path_past_2_17(sparse, width, window):
    x, delta, r = sparse
    assert x.shape[0] > (1 << 17)
    jb, tb = _both_bounds(x, delta, r, np.zeros_like(r), 0.25)
    jg, tg = _grids(1.6, (128, 16, 128), 3)
    alive = r > 0
    jgrid = jbp.build_fat_grid(jb, jg, width=width, valid=jnp.asarray(alive))
    tgrid = tbp.build_fat_grid(tb, tg, width=width,
                               valid=torch.as_tensor(alive))
    assert int(jgrid.overflow) == int(tgrid.overflow) > 0
    jp, jok = jbp.fat_grid_pairs(jb, jgrid, jg, 4, ordered=False,
                                 window=window)
    tp, tok = tbp.fat_grid_pairs(tb, tgrid, tg, 4, ordered=False,
                                 window=window)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    assert tp.dtype == torch.int32
    # indices past 2^17 are kept whole (the int key would truncate them)
    assert tp.numpy().max() >= (1 << 17)
    assert tok.numpy().any(axis=1).mean() > 0.3
