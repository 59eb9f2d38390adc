"""The port's world queries (mgf_tpu_torch.queries) against mgf_tpu's.

* tests/test_ops_native.py's test_queries,
  test_raytrace_mesh_grid_matches_dense, test_raytrace_mesh_grid_dealigned
  and test_raytrace_bodies_grid_matches_dense replayed on the port, one ray
  at a time (0-d components), with their goldens and tolerances;
* ``build_body_grid``'s table and overflow equal to mgf_tpu's exactly, on
  the 120-body cloud and on an overflowing cell, where the reference's
  scatter leaves slot cap - 1 empty (the cell keeps cap - 1 bodies);
* batched rays against ``jax.vmap`` of mgf_tpu's single-ray functions:
  ``hit`` and the body / face index equal, t within 1e-5 + 5e-5 t where
  hit (a ray that meets a capsule at t ~ 30 takes the quadratic's
  discriminant from the difference of two ~900-sized products, where
  float32 rounding, and XLA's fused products on the CPU, leave ~1e-5 of t:
  measured 1.5e-5 of t at most), except on body rays that pass within 5 %
  of the radius of the body's surface, where t moves like the square root
  of that rounding (measured: 1.3e-4 of t on one grazing ray);
* a batch whose rays finish at different DDA iterations gives each ray its
  single-ray answer (a finished ray's state is frozen);
* ``query_aabb`` equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mgf_tpu import queries as jq  # noqa: E402
from mgf_tpu.geom import AABB as JAABB  # noqa: E402
from mgf_tpu.math3d import Vec3 as JVec3  # noqa: E402
from mgf_tpu.mesh import build_mesh_grid as j_build_mesh_grid  # noqa: E402
from mgf_tpu.mesh import mesh_from_arrays as j_mesh_from_arrays  # noqa: E402
from mgf_tpu.physics import SceneBuilder as JSceneBuilder  # noqa: E402

from mgf_tpu_torch.geom import AABB  # noqa: E402
from mgf_tpu_torch.math3d import Vec3, vec3  # noqa: E402
from mgf_tpu_torch.mesh import build_mesh_grid, mesh_from_arrays  # noqa: E402
from mgf_tpu_torch.physics import SceneBuilder  # noqa: E402
from mgf_tpu_torch.queries import (  # noqa: E402
    build_body_grid, query_aabb, raytrace_bodies, raytrace_bodies_grid,
    raytrace_bodies_grid_steps, raytrace_mesh, raytrace_mesh_grid,
)
from mgf_tpu_torch.scenes import terrain_scene  # noqa: E402

CPU = "cpu"


def V(x, y, z):
    return vec3(x, y, z, device=CPU)


def v3(a):
    return Vec3(*(torch.tensor(float(x)) for x in a))


# ---------------------------------------------------------------------------
# scenes, built identically in both packages
# ---------------------------------------------------------------------------

def _three_bodies(builder):
    b = builder()
    b.add_sphere((0, 0, 0), 1.0, 1.0, 0.0, 0.5, gravity=(0, 0, 0))
    b.add_sphere((5, 0, 0), 1.0, 1.0, 0.0, 0.5, gravity=(0, 0, 0))
    b.add_capsule((10, -1, 0), (0, 2, 0), 0.5, 1.0, 0.0, 0.5,
                  gravity=(0, 0, 0))
    return b


def _cloud(builder):
    """tests/test_ops_native.py's 120-body sphere/capsule cloud."""
    rng = np.random.default_rng(11)
    b = builder()
    for i in range(120):
        c = rng.uniform(-18, 18, 3)
        if i % 3 == 0:
            d = rng.standard_normal(3)
            d = d / np.linalg.norm(d) * 0.8
            b.add_capsule(tuple(c - d), tuple(2 * d), 0.35, 1.0, 0.0, 0.5,
                          gravity=(0, 0, 0))
        else:
            b.add_sphere(tuple(c), 0.6, 1.0, 0.0, 0.5, gravity=(0, 0, 0))
    return b, rng


def _heightfield(shift=(0.0, 0.0, 0.0)):
    """The faces of terrain_scene(grid_n=24) as a mesh soup (1,152 faces)."""
    w, _ = terrain_scene(n_bodies=10, grid_n=24, device=CPU)
    verts = np.concatenate([np.stack([getattr(w.terrain, s).x.numpy(),
                                      getattr(w.terrain, s).y.numpy(),
                                      getattr(w.terrain, s).z.numpy()], -1)
                            for s in "abc"])
    verts = verts + np.asarray([shift], np.float32)
    faces = np.arange(verts.shape[0]).reshape(3, -1).T
    return verts, faces


@pytest.fixture(scope="module")
def cloud():
    return (_cloud(JSceneBuilder)[0].build(),
            _cloud(SceneBuilder)[0].build(device=CPU))


# ---------------------------------------------------------------------------
# tests/test_ops_native.py on the port
# ---------------------------------------------------------------------------

def test_queries():
    state = _three_bodies(SceneBuilder).build(device=CPU)

    mask = query_aabb(state, AABB(c=V(0, 0, 0), r=V(2, 2, 2)))
    assert mask.tolist() == [True, False, False]

    inter, idx = raytrace_bodies(state, V(-5, 0, 0), V(1, 0, 0))
    assert bool(inter.hit) and int(idx) == 0
    assert float(inter.t) == pytest.approx(4.0, abs=1e-4)
    inter, idx = raytrace_bodies(state, V(20, 0, 0), V(-1, 0, 0))
    assert bool(inter.hit) and int(idx) == 2
    assert float(inter.t) == pytest.approx(9.5, abs=1e-4)

    m = mesh_from_arrays([(-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1)],
                         [(0, 1, 3), (1, 2, 3)], device=CPU)
    inter, face = raytrace_mesh(m, V(0.5, 3.0, 0.5), V(0, -1, 0))
    assert bool(inter.hit)
    assert float(inter.t) == pytest.approx(3.0, abs=1e-5)


def test_raytrace_mesh_grid_matches_dense():
    verts, faces = _heightfield()
    m = mesh_from_arrays(verts, faces, device=CPU)
    grid = build_mesh_grid(m, cell_size=4.0, dim=16, cap=16)
    assert int(grid.overflow) == 0

    rng = np.random.default_rng(5)
    for i in range(12):
        p = v3([rng.uniform(-20, 20), 25.0, rng.uniform(-20, 20)])
        dv = np.asarray([rng.uniform(-0.4, 0.4), -1.0,
                         rng.uniform(-0.4, 0.4)])
        dv /= np.linalg.norm(dv)
        i1, f1 = raytrace_mesh(m, p, v3(dv))
        i2, f2 = raytrace_mesh_grid(m, grid, p, v3(dv))
        assert bool(i1.hit) == bool(i2.hit)
        if bool(i1.hit):
            assert abs(float(i1.t) - float(i2.t)) < 1e-4


def test_raytrace_mesh_grid_dealigned():
    """Faces straddling cell boundaries must stay visible to rays entering
    from the neighbouring cell (AABB binning keeps the DDA exact)."""
    verts, faces = _heightfield(shift=(2.0, 1.3, 2.0))
    m = mesh_from_arrays(verts, faces, device=CPU)
    grid = build_mesh_grid(m, cell_size=4.0, dim=16, cap=24)
    assert int(grid.overflow) == 0

    rng = np.random.default_rng(7)
    hits = 0
    for i in range(16):
        p = v3([rng.integers(-4, 5) * 4.0 + rng.uniform(-0.05, 0.05),
                25.0,
                rng.integers(-4, 5) * 4.0 + rng.uniform(-0.05, 0.05)])
        dv = np.asarray([rng.uniform(-0.3, 0.3), -1.0,
                         rng.uniform(-0.3, 0.3)])
        dv /= np.linalg.norm(dv)
        i1, f1 = raytrace_mesh(m, p, v3(dv))
        i2, f2 = raytrace_mesh_grid(m, grid, p, v3(dv))
        assert bool(i1.hit) == bool(i2.hit)
        if bool(i1.hit):
            hits += 1
            assert abs(float(i1.t) - float(i2.t)) < 1e-4
    assert hits >= 8  # the probe set must actually exercise hits


def test_raytrace_bodies_grid_matches_dense(cloud):
    _, state = cloud
    rng = _cloud(_Sink)[1]         # the cloud's rng, past the cloud
    grid = build_body_grid(state, cell_size=2.5, dim=32, cap=16)
    assert int(grid.overflow) == 0
    xs = np.stack([state.x.x.numpy(), state.x.y.numpy(),
                   state.x.z.numpy()], -1)
    hits = 0
    for i in range(20):
        p = rng.uniform(-25, 25, 3)
        # aim at a random body (slightly off-center) so most rays hit
        tgt = xs[rng.integers(0, len(xs))] + rng.uniform(-0.3, 0.3, 3)
        dv = tgt - p
        dv /= np.linalg.norm(dv)
        i1, b1 = raytrace_bodies(state, v3(p), v3(dv))
        i2, b2 = raytrace_bodies_grid(grid, v3(p), v3(dv))
        assert bool(i1.hit) == bool(i2.hit), f"ray {i}"
        if bool(i1.hit):
            hits += 1
            assert abs(float(i1.t) - float(i2.t)) < 1e-4
            assert int(b1) == int(b2)
    assert hits >= 10


class _Sink:
    """A SceneBuilder stand-in that only consumes _cloud's random draws."""

    def add_capsule(self, *a, **k):
        pass

    def add_sphere(self, *a, **k):
        pass


# ---------------------------------------------------------------------------
# the body grid, exactly
# ---------------------------------------------------------------------------

def test_body_grid_table_equals_jax(cloud):
    sj, st = cloud
    gj = jq.build_body_grid(sj, cell_size=2.5, dim=32, cap=16)
    gt = build_body_grid(st, cell_size=2.5, dim=32, cap=16)
    np.testing.assert_array_equal(gt.table.numpy(), np.asarray(gj.table))
    assert int(gt.overflow) == int(gj.overflow) == 0
    assert gt.dims == tuple(gj.dims)


def test_body_grid_overflow_keeps_cap_minus_one():
    """4 spheres in one cell with cap 2: the reference's scatter writes the
    2 overflowing insertions' empty rows to slot 1 after the second body,
    and the later writes win, so slot 1 holds -1 and the overflow is 2."""
    def four(builder):
        b = builder()
        for k in range(4):
            b.add_sphere((0.3 + 0.1 * k, 0.3, 0.3), 0.1, 1.0, 0.0, 0.5,
                         gravity=(0, 0, 0))
        return b
    gj = jq.build_body_grid(four(JSceneBuilder).build(), cell_size=2.0,
                            dim=8, cap=2)
    gt = build_body_grid(four(SceneBuilder).build(device=CPU), cell_size=2.0,
                         dim=8, cap=2)
    np.testing.assert_array_equal(gt.table.numpy(), np.asarray(gj.table))
    assert int(gt.overflow) == int(gj.overflow) == 2
    assert gt.table[0, :, 11].tolist() == [0.0, -1.0]

    # a cloud with overflowing cells: the whole table equals the
    # reference's
    bj, _ = _cloud(JSceneBuilder)
    bt, _ = _cloud(SceneBuilder)
    gj = jq.build_body_grid(bj.build(), cell_size=4.0, dims=(4, 2, 4), cap=3)
    gt = build_body_grid(bt.build(device=CPU), cell_size=4.0, dims=(4, 2, 4),
                         cap=3)
    assert int(gj.overflow) > 0
    np.testing.assert_array_equal(gt.table.numpy(), np.asarray(gj.table))
    assert int(gt.overflow) == int(gj.overflow)


# ---------------------------------------------------------------------------
# batched rays against jax.vmap
# ---------------------------------------------------------------------------

def _ray_batch(rng, n, lo, hi, y):
    p = np.stack([rng.uniform(lo, hi, n), np.full(n, y),
                  rng.uniform(lo, hi, n)], -1).astype(np.float32)
    d = np.stack([rng.uniform(-0.4, 0.4, n), -np.ones(n),
                  rng.uniform(-0.4, 0.4, n)], -1)
    d[: n // 8] = rng.standard_normal((n // 8, 3))   # any direction
    d[n // 8: n // 8 + 4] = 0.0                      # zero directions
    return p, d.astype(np.float32)


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _tv(a):
    return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, k]))
                  for k in range(3)))


def _grazing(state, p, d, body):
    """Rays whose line passes within 5 % of the radius of the hit body's
    surface (f64): there t moves like the square root of the rounding in
    the discriminant."""
    p, d = p.astype(np.float64), d.astype(np.float64)
    d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    x = np.stack([c.numpy() for c in state.x], -1)[body].astype(np.float64)
    r = state.shape_r.numpy()[body].astype(np.float64)
    hh = state.shape_half_h.numpy()[body].astype(np.float64)
    q = np.stack([c.numpy() for c in state.q], -1)[body].astype(np.float64)
    w, v = q[:, :1], q[:, 1:]
    y = np.zeros_like(v)
    y[:, 1] = hh
    t2 = 2.0 * np.cross(v, y)
    axis = y + w * t2 + np.cross(v, t2)            # rot(q, (0, half_h, 0))
    # closest approach of the line p + s d to the segment x +- axis
    best = np.full(len(p), np.inf)
    for u in np.linspace(-1.0, 1.0, 201):
        c = x + axis * u
        m = c - p
        dist = np.linalg.norm(m - d * np.sum(m * d, 1, keepdims=True), axis=1)
        best = np.minimum(best, dist)
    return np.abs(r - best) < 0.05 * r


def _compare(j_out, t_out, state=None, p=None, d=None):
    (ij, bj), (it, bt) = j_out, t_out
    hit = np.asarray(ij.hit)
    np.testing.assert_array_equal(it.hit.numpy(), hit)
    np.testing.assert_array_equal(bt.numpy()[hit], np.asarray(bj)[hit])
    ok = hit
    if state is not None:
        ok = hit & ~_grazing(state, p, d, np.asarray(bj))
    np.testing.assert_allclose(it.t.numpy()[ok], np.asarray(ij.t)[ok],
                               rtol=5e-5, atol=1e-5)
    return int(hit.sum())


def test_batched_body_rays_match_vmap(cloud):
    sj, st = cloud
    rng = np.random.default_rng(21)
    p, d = _ray_batch(rng, 512, -20, 20, 22.0)
    # half the rays aimed at a body, slightly off its center
    xs = np.stack([c.numpy() for c in st.x], -1)
    tgt = xs[rng.integers(0, len(xs), 256)] + rng.uniform(-0.3, 0.3, (256, 3))
    d[256:] = (tgt - p[256:]) / np.linalg.norm(tgt - p[256:], axis=1,
                                               keepdims=True)
    gj = jq.build_body_grid(sj, cell_size=2.5, dim=32, cap=16)
    gt = build_body_grid(st, cell_size=2.5, dim=32, cap=16)
    fd = jax.jit(jax.vmap(jq.raytrace_bodies, in_axes=(None, 0, 0)))
    fg = jax.jit(jax.vmap(jq.raytrace_bodies_grid, in_axes=(None, 0, 0)))
    hits = _compare(fd(sj, _jv(p), _jv(d)),
                    raytrace_bodies(st, _tv(p), _tv(d)), st, p, d)
    assert hits >= 200
    _compare(fg(gj, _jv(p), _jv(d)), raytrace_bodies_grid(gt, _tv(p),
                                                          _tv(d)), st, p, d)


def test_batched_mesh_rays_match_vmap():
    verts, faces = _heightfield(shift=(2.0, 1.3, 2.0))
    mj = j_mesh_from_arrays(verts, faces)
    mt = mesh_from_arrays(verts, faces, device=CPU)
    gj = j_build_mesh_grid(mj, cell_size=4.0, dim=16, cap=24)
    gt = build_mesh_grid(mt, cell_size=4.0, dim=16, cap=24)
    rng = np.random.default_rng(23)
    p, d = _ray_batch(rng, 256, -20, 20, 25.0)
    fd = jax.jit(jax.vmap(lambda p, d: jq.raytrace_mesh(mj, p, d)))
    fg = jax.jit(jax.vmap(lambda p, d: jq.raytrace_mesh_grid(mj, gj, p, d)))
    hits = _compare(fd(_jv(p), _jv(d)), raytrace_mesh(mt, _tv(p), _tv(d)))
    assert hits >= 100
    _compare(fg(_jv(p), _jv(d)), raytrace_mesh_grid(mt, gt, _tv(p), _tv(d)))


def test_batched_rays_keep_single_ray_answers(cloud):
    """Rays that finish at very different DDA iterations (a hit in the
    first cell, a long miss, a zero direction, a segment that ends early),
    cast as one batch and one at a time: the same answers."""
    _, st = cloud
    grid = build_body_grid(st, cell_size=2.5, dim=32, cap=16)
    x0 = [float(c[0]) for c in st.x]
    p = np.asarray([x0, [-40.0, 0.0, 0.0], [0.0, 30.0, 0.0], x0,
                    [-25.0, -25.0, -25.0], [0.0, 0.0, 0.0]], np.float32)
    d = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.001, 0.0], [0.0, 0.0, 0.0],
                    [0.3, 0.2, 0.1], [1.0, 1.0, 1.0], [0.0, 1.0, 0.0]],
                   np.float32)
    # per-ray segment lengths, some ending inside the grid
    dt = torch.tensor([3.0, float("inf"), 3.0, 1.0, 50.0, 3.0])
    (ib, bb, sb) = raytrace_bodies_grid_steps(grid, _tv(p), _tv(d), dt)
    assert len(set(sb.tolist())) >= 4         # they finish apart
    for k in range(len(p)):
        (i1, b1, s1) = raytrace_bodies_grid_steps(grid, v3(p[k]), v3(d[k]),
                                                  dt[k])
        assert bool(i1.hit) == bool(ib.hit[k])
        assert int(b1) == int(bb[k]) and int(s1) == int(sb[k])
        assert float(i1.t) == float(ib.t[k]) or not bool(i1.hit)


def test_query_aabb_matches_jax(cloud):
    sj, st = cloud
    rng = np.random.default_rng(29)
    for _ in range(8):
        c = rng.uniform(-15, 15, 3)
        r = rng.uniform(1, 8, 3)
        mj = jq.query_aabb(sj, JAABB(c=JVec3(*(jnp.float32(x) for x in c)),
                                     r=JVec3(*(jnp.float32(x) for x in r))),
                           fatten=0.25)
        mt = query_aabb(st, AABB(c=v3(c), r=v3(r)), fatten=0.25)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
