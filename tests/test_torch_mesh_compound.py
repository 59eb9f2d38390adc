"""The port's meshes, face grid and compounds (mgf_tpu_torch.mesh,
mgf_tpu_torch.compound, the rectangle routines of mgf_tpu_torch.collision)
against mgf_tpu's.

tests/test_mesh_compound.py's compound and mesh tests are replayed on the
port with their own goldens and tolerances.  The face grid of the
72 x 72 heightfield of ``terrain_scene`` (10,368 faces, cell 4.0, dim 64,
cap 16) and the world's face table built from it must equal mgf_tpu's
exactly (integer binning of identical float32 inputs), as must a grid whose
cells overflow.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mgf_tpu import mesh as jmesh  # noqa: E402
from mgf_tpu.scenes import terrain_scene as j_terrain_scene  # noqa: E402

from mgf_tpu_torch.collision import (  # noqa: E402
    contact_moving_static, contact_sphere_moving_sphere,
)
from mgf_tpu_torch.compound import (  # noqa: E402
    compound_contacts, compound_contacts_polygon, compound_from_parts,
    compound_inertia, compound_raytrace,
)
from mgf_tpu_torch.geom import Rectangle, Sphere, rectangle  # noqa: E402
from mgf_tpu_torch.math3d import (  # noqa: E402
    Vec3, qnormalize, quat_from_arc,
)
from mgf_tpu_torch.mesh import (  # noqa: E402
    build_mesh_grid, mesh_contacts, mesh_from_arrays, mesh_grid_query,
)
from mgf_tpu_torch.scenes import terrain_scene as t_terrain_scene  # noqa: E402

CPU = "cpu"


def V(x, y, z):
    return Vec3(*(torch.tensor(float(c)) for c in (x, y, z)))


def F(x):
    return torch.tensor(float(x))


def _vec_np(v, k=None):
    a = np.stack([c.numpy() for c in v], axis=-1)
    return a if k is None else a[k]


def test_compound_contacts():
    # compound.rs:361-388
    comp = compound_from_parts([
        dict(kind="sphere", center=(-5.0, 0.0, 0.0), r=1.0),
        dict(kind="sphere", center=(5.0, 0.0, 0.0), r=1.0),
    ], device=CPU)
    test_sphere = Sphere(c=V(0.0, 8.0, 0.0), r=F(1.0))
    v = V(0.0, -1.5, 0.0)
    out = compound_contacts(comp, test_sphere, v)
    assert not bool(out.valid.any())

    # rotate the compound: x-axis components swing onto the y-axis
    comp2 = comp._replace(rot=qnormalize(
        quat_from_arc(V(1, 0, 0), V(0, 1, 0))))
    out = compound_contacts(comp2, test_sphere, v)
    assert bool(out.valid.any())
    # last_contact: the reference reads the final callback hit
    idx = int(torch.nonzero(out.valid)[-1, 0])
    assert float(out.t[idx]) == pytest.approx(0.6666663, abs=1e-4)
    np.testing.assert_allclose(_vec_np(out.a, idx), [0.0, 6.0, 0.0],
                               atol=1e-4)


def test_compound_raytrace():
    comp = compound_from_parts([
        dict(kind="sphere", center=(0.0, 0.0, 0.0), r=1.0),
        dict(kind="capsule", a=(3.0, -1.0, 0.0), d=(0.0, 2.0, 0.0), r=0.5),
    ], device=CPU)
    inter = compound_raytrace(comp, V(-5.0, 0.0, 0.0), V(1.0, 0.0, 0.0))
    assert bool(inter.hit)
    assert float(inter.t) == pytest.approx(4.0, abs=1e-4)  # sphere at x=-1
    np.testing.assert_allclose(_vec_np(inter.p), [-1.0, 0.0, 0.0], atol=1e-4)
    inter = compound_raytrace(comp, V(5.0, 0.0, 0.0), V(-1.0, 0.0, 0.0))
    assert bool(inter.hit)
    assert float(inter.t) == pytest.approx(1.5, abs=1e-4)  # capsule at x=3.5
    inter = compound_raytrace(comp, V(-5.0, 5.0, 0.0), V(1.0, 0.0, 0.0))
    assert not bool(inter.hit)


def test_compound_inertia():
    inv = compound_inertia(compound_from_parts([
        dict(kind="sphere", center=(0.0, 0.0, 0.0), r=1.0)], device=CPU),
        1.0)
    m = np.asarray([c.item() for c in inv]).reshape(3, 3)
    np.testing.assert_allclose(m, np.eye(3) / 0.4, atol=1e-4)
    # two displaced spheres: parallel-axis terms dominate
    inv2 = compound_inertia(compound_from_parts([
        dict(kind="sphere", center=(-2.0, 0.0, 0.0), r=1.0),
        dict(kind="sphere", center=(2.0, 0.0, 0.0), r=1.0)], device=CPU),
        2.0)
    m = np.asarray([c.item() for c in inv2]).reshape(3, 3)
    # I_yy = I_zz = 2*(0.4 + 4) = 8.8 ; I_xx = 0.8
    assert m[0, 0] == pytest.approx(1 / 0.8, rel=1e-4)
    assert m[1, 1] == pytest.approx(1 / 8.8, rel=1e-4)


def test_mesh_contacts_and_grid():
    # a 2-triangle floor at y=0
    verts = [(-10, 0, -10), (-10, 0, 10), (10, 0, 10), (10, 0, -10)]
    faces = [(0, 1, 3), (1, 2, 3)]
    m = mesh_from_arrays(verts, faces, device=CPU)
    s = Sphere(c=V(0.0, 5.0, 0.0), r=F(1.0))
    out = mesh_contacts(m, s, V(0.0, -4.0, 0.0))
    # flipped: a = mesh point, n = -tri normal; the contact at t=1
    hit = out.valid.numpy()
    assert hit.any()
    k = tuple(np.argwhere(hit)[0])
    assert float(out.t[k]) == pytest.approx(1.0)
    assert float(out.n.y[k]) == pytest.approx(-1.0, abs=1e-5)
    assert float(out.b.y[k]) == pytest.approx(0.0, abs=1e-5)

    grid = build_mesh_grid(m, cell_size=8.0, dim=16, cap=4)
    cand = mesh_grid_query(grid, V(0.0, 0.0, 0.0)).numpy()
    assert set(cand[cand >= 0].tolist()) == {0, 1}


def test_compound_vs_moving_rect():
    # compound.rs:379-387: compound vs a rect moving up at (0, 3, 0)
    comp = compound_from_parts([
        dict(kind="sphere", center=(-5.0, 0.0, 0.0), r=1.0),
        dict(kind="sphere", center=(5.0, 0.0, 0.0), r=1.0)], device=CPU)
    rect = Rectangle(c=V(0.0, -2.0, 0.0), u0=V(1, 0, 0), u1=V(0, 0, 1),
                     e0=F(6.0), e1=F(6.0))
    out = compound_contacts_polygon(comp, rect, V(0.0, 3.0, 0.0))
    v = out.valid.numpy()
    assert v.any()
    k = tuple(np.argwhere(v)[0])
    # gap 1 closed at speed 3 -> t = 1/3; contact on the sphere bottom
    assert float(out.t[k]) == pytest.approx(1.0 / 3.0, abs=1e-5)
    assert float(out.a.y[k]) == pytest.approx(-1.0, abs=1e-4)
    # the same rectangle through the constructor; a capsule part takes the
    # rectangle x capsule routine (two slots)
    rect2 = rectangle(V(0.0, -2.0, 0.0), V(1, 0, 0), V(0, 0, 1), 6.0, 6.0)
    comp3 = compound_from_parts([
        dict(kind="sphere", center=(-5.0, 0.0, 0.0), r=1.0),
        dict(kind="capsule", a=(4.0, 0.0, 0.0), d=(2.0, 0.0, 0.0),
             r=1.0)], device=CPU)
    out3 = compound_contacts_polygon(comp3, rect2, V(0.0, 3.0, 0.0))
    assert out3.valid.shape == (2, 2)
    assert bool(out3.valid[0, 1])
    assert float(out3.t[0, 1]) == pytest.approx(1.0 / 3.0, abs=1e-5)


def test_contact_moving_static():
    """A sphere moving at +x onto a static one (collision.rs:1368-1382):
    the receiver's sweep reduces to the argument moving at -v."""
    c = contact_moving_static(contact_sphere_moving_sphere,
                              Sphere(c=V(0, 0, 0), r=F(1.0)), V(2, 0, 0),
                              Sphere(c=V(3, 0, 0), r=F(1.0)))
    assert bool(c.valid)
    assert float(c.t) == pytest.approx(0.5, abs=1e-6)
    np.testing.assert_allclose(_vec_np(c.a), [2.0, 0.0, 0.0], atol=1e-6)


@pytest.fixture(scope="module")
def j_terrain():
    """mgf_tpu's terrain_scene at 40 bodies (its face table built once)."""
    return j_terrain_scene(n_bodies=40)


def _terrain_mesh(w):
    """terrain_scene's 72 x 72 heightfield as (verts, faces)."""
    tri = w.terrain
    corners = [np.stack([np.asarray(c) for c in p], -1)
               for p in (tri.a, tri.b, tri.c)]
    verts = np.concatenate(corners, axis=0)
    T = corners[0].shape[0]
    faces = np.stack([np.arange(T), T + np.arange(T), 2 * T + np.arange(T)],
                     -1).astype(np.int32)
    return verts, faces


@pytest.mark.parametrize("cell,cap", [(4.0, 16), (4.0, 3)])
def test_build_mesh_grid_matches_jax(cell, cap, j_terrain):
    """The heightfield's face grid at terrain_scene's settings, and with
    cap 3, where cells overflow (JAX's scatter then leaves -1 in an
    overflowing cell's last slot)."""
    verts, faces = _terrain_mesh(j_terrain[0])
    jg = jmesh.build_mesh_grid(jmesh.mesh_from_arrays(verts, faces), cell,
                               64, cap)
    tg = build_mesh_grid(mesh_from_arrays(verts, faces, device=CPU), cell,
                         64, cap)
    np.testing.assert_array_equal(np.asarray(jg.table), tg.table.numpy())
    assert int(jg.overflow) == int(tg.overflow)
    assert (int(tg.overflow) > 0) == (cap == 3)
    if cap == 16:     # AABB binning puts faces into several cells
        assert int((tg.table >= 0).sum()) > faces.shape[0]
    q = Vec3(*(torch.tensor([-30.0, 0.5, 71.0])[i:i + 1] for i in range(3)))
    jq = jmesh.mesh_grid_query(jg, jmesh.Vec3(*(jnp.asarray(c.numpy())
                                                 for c in q)))
    np.testing.assert_array_equal(np.asarray(jq),
                                  mesh_grid_query(tg, q).numpy())


def test_terrain_world_face_table_matches_jax(j_terrain):
    jw, jcfg = j_terrain
    tw, tcfg = t_terrain_scene(n_bodies=40, device=CPU)
    assert tw.terrain_grid.shape == (64 ** 3, 4 * 16)
    np.testing.assert_array_equal(np.asarray(jw.terrain_grid),
                                  tw.terrain_grid.numpy())
    assert tcfg == type(tcfg)(*jcfg)
    assert tw.terrain.a.x.shape[0] == 10_368
