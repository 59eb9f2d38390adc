"""Triangle meshes and their static face grid.

Counterpart of the ``Mesh`` and ``MeshGrid`` part of ``mgf_tpu.mesh``
(reference: mesh.rs):

* :class:`Mesh` — a non-convex triangle soup with a displacement
  (mesh.rs:32-37).  Where mgf looks faces up with a pointer BVH, collision
  here is a dense masked test against all faces (:func:`mesh_contacts`);
* :class:`MeshGrid` — a static cell -> face-id table
  (:func:`build_mesh_grid`), the BVH::query equivalent for large meshes
  (mesh.rs:121): the world step's "grid" terrain cull reads it.

Contacts against a Mesh are flipped so the mesh is the receiver
(mesh.rs:127-134): a = point on the mesh, b = point on the other shape,
n = -n_tri.

* :class:`ConvexMesh` — a closed convex point soup (mesh.rs:144-148) whose
  support function serves GJK (``gjk``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mgf_tpu_torch.broadphase import _bucket_ranks
from mgf_tpu_torch.collision import (
    Contact, contact_neg, contact_stack, contact_triangle_moving_capsule,
    contact_triangle_moving_sphere,
)
from mgf_tpu_torch.geom import Sphere, Triangle
from mgf_tpu_torch.math3d import Vec3, qrotate, tree_map

CUDA = torch.device("cuda")


class Mesh(NamedTuple):
    """Triangle soup + displacement (mesh.rs:32-37).  ``verts`` is a Vec3
    of (V,) components; ``faces`` is (T, 3) int32."""
    x: Vec3
    verts: Vec3
    faces: torch.Tensor

    @property
    def n_faces(self):
        return self.faces.shape[0]


def mesh_from_arrays(verts, faces, x=(0.0, 0.0, 0.0), *,
                     device=CUDA) -> Mesh:
    """Build a mesh from numpy-like (V, 3) vertices and (T, 3) faces
    (Mesh::push_vert/push_face, mesh.rs:58-73), on ``device``."""
    v = np.asarray(verts, np.float32)
    p = np.asarray(x, np.float32)
    vec = lambda a: Vec3(*(torch.as_tensor(np.array(a[..., k]),
                                           device=device) for k in range(3)))
    return Mesh(x=vec(p), verts=vec(v),
                faces=torch.as_tensor(np.asarray(faces, np.int32),
                                      device=device))


def mesh_set_pos(m: Mesh, p: Vec3) -> Mesh:
    """Shape::set_pos for Mesh: the center is ``x`` (mesh.rs:89-91)."""
    return m._replace(x=p)


def mesh_triangles(m: Mesh) -> Triangle:
    """World-space triangle batch (T,): the faces displaced by x
    (mesh.rs:122-126)."""
    f = m.faces.long()
    pick = lambda i: tree_map(lambda c: c[f[:, i]], m.verts)
    return Triangle(a=pick(0) + m.x, b=pick(1) + m.x, c=pick(2) + m.x)


def rotate_mesh(m: Mesh, q) -> Mesh:
    """Rotate every vertex (Volumetric for Mesh, mesh.rs:100-113); a face
    grid built before must be rebuilt by the caller."""
    return m._replace(verts=qrotate(q, m.verts))


def mesh_contacts(m: Mesh, shape, v: Vec3, face_mask=None) -> Contact:
    """Mesh vs a moving Sphere or Capsule: flipped contacts with leading
    axes (slots, T)."""
    tris = mesh_triangles(m)
    T = tris.a.x.shape[0]
    bc = lambda t: tree_map(lambda x: x.expand((T,) + x.shape), t)
    if isinstance(shape, Sphere):
        c = contact_triangle_moving_sphere(tris, bc(shape), bc(v))
        c = contact_stack([c, c._replace(valid=torch.zeros_like(c.valid))])
    else:
        c = contact_triangle_moving_capsule(tris, bc(shape), bc(v))
    if face_mask is not None:
        c = c._replace(valid=c.valid & face_mask[None, :])
    # flip: the mesh is the receiver (mesh.rs:127-134)
    return contact_neg(c)


class MeshGrid(NamedTuple):
    """Cell -> face-id table over a mesh's triangles (in place of the
    per-face BVH of mesh.rs:36, built once for a static mesh)."""
    table: torch.Tensor     # (dim^3, cap) int32 face id or -1
    cell_size: float
    dim: int
    overflow: torch.Tensor  # () int32: insertions dropped from full cells


def build_mesh_grid(m: Mesh, cell_size: float, dim: int = 64,
                    cap: int = 8) -> MeshGrid:
    """Bin each face into EVERY cell its AABB overlaps.  The sizing
    contract is cell_size >= the largest face radius, so a face spans at
    most 3 cells per axis: 27 insertion slots per face, masked to the
    face's AABB span (the AABB shrunk by 1e-5 * cell_size, so a face that
    only touches a cell plane stays out of the neighbour cell).

    Built as the JAX package builds it: a stable sort of the insertions by
    cell, each one's rank in its cell, a scatter of the first ``cap``.  The
    JAX scatter also writes -1 for every insertion past ``cap`` to its
    cell's last slot, and the later writes win: a cell that overflows
    loses its last face.  The port writes that -1 explicitly."""
    tris = mesh_triangles(m)
    n = m.n_faces
    dev = m.faces.device
    cc = lambda comp: torch.floor(comp / cell_size).to(torch.int32)
    eps = 1e-5 * cell_size
    lo_ = lambda u, v, w: cc(torch.minimum(torch.minimum(u, v), w) + eps)
    hi_ = lambda u, v, w: cc(torch.maximum(torch.maximum(u, v), w) - eps)
    comps = lambda p: (p.x, p.y, p.z)
    lo = [lo_(a, b, c) for a, b, c in zip(comps(tris.a), comps(tris.b),
                                          comps(tris.c))]
    hi = [torch.maximum(hi_(a, b, c), low) for a, b, c, low in
          zip(comps(tris.a), comps(tris.b), comps(tris.c), lo)]
    mmask = dim - 1
    hs, oks = [], []
    for dx in (0, 1, 2):
        for dy in (0, 1, 2):
            for dz in (0, 1, 2):
                cx, cy, cz = lo[0] + dx, lo[1] + dy, lo[2] + dz
                # no duplicate inserts past the face's AABB
                oks.append((cx <= hi[0]) & (cy <= hi[1]) & (cz <= hi[2]))
                hs.append(((cx & mmask) * dim + (cy & mmask)) * dim
                          + (cz & mmask))
    h = torch.cat(hs)                              # (27T,)
    ins_ok = torch.cat(oks)
    face = torch.arange(n, dtype=torch.int32, device=dev).repeat(27)
    sentinel = dim ** 3                            # invalid slots sort last
    hk = torch.where(ins_ok, h, sentinel)
    order = torch.argsort(hk, stable=True)
    sorted_h = hk[order]
    rank = _bucket_ranks(sorted_h)
    in_table = sorted_h < sentinel
    ok = (rank < cap) & in_table
    over = (rank >= cap) & in_table
    # one extra sentinel row takes the insertions JAX drops (mode='drop')
    table = torch.full((sentinel + 1, cap), -1, dtype=torch.int32,
                       device=dev)
    table[torch.where(ok, sorted_h, sentinel).long(),
          torch.clamp(rank, max=cap - 1).long()] = face[order]
    table[torch.where(over, sorted_h, sentinel).long(), cap - 1] = -1
    return MeshGrid(table=table[:sentinel], cell_size=cell_size, dim=dim,
                    overflow=torch.sum(over).to(torch.int32))


def mesh_grid_query(grid: MeshGrid, centers: Vec3):
    """(N, 27 * cap) candidate face ids around each query point (the
    BVH::query equivalent for meshes, mesh.rs:121)."""
    cc = lambda comp: torch.floor(comp / grid.cell_size).to(torch.int32)
    cx, cy, cz = cc(centers.x), cc(centers.y), cc(centers.z)
    mmask = grid.dim - 1
    cols = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                h = ((((cx + dx) & mmask) * grid.dim + ((cy + dy) & mmask))
                     * grid.dim + ((cz + dz) & mmask))
                cols.append(grid.table[h.long()])
    return torch.cat(cols, dim=-1)


class ConvexMesh(NamedTuple):
    """Closed convex point soup: displacement + vertices (mesh.rs:144-148).
    ``center`` is x + mean(verts) (mesh.rs:203-206)."""
    x: Vec3
    verts: Vec3   # (V,) components


def convex_mesh_from_points(points, x=(0.0, 0.0, 0.0), *,
                            device=CUDA) -> ConvexMesh:
    """A convex mesh from numpy-like (V, 3) points, on ``device``."""
    p = np.asarray(points, np.float32)
    o = np.asarray(x, np.float32)
    vec = lambda a: Vec3(*(torch.as_tensor(np.array(a[..., k]),
                                           device=device) for k in range(3)))
    return ConvexMesh(x=vec(o), verts=vec(p))


def _centroid(v: Vec3) -> Vec3:
    return Vec3(v.x.mean(), v.y.mean(), v.z.mean())


def convex_mesh_center(cm: ConvexMesh) -> Vec3:
    return cm.x + _centroid(cm.verts)


def rotate_convex_mesh(cm: ConvexMesh, q) -> ConvexMesh:
    """Rotate the vertices about the soup's centroid (mesh.rs:213-221)."""
    c = _centroid(cm.verts)
    return cm._replace(verts=qrotate(q, cm.verts - c) + c)


def support_convex_mesh(cm: ConvexMesh, d: Vec3) -> Vec3:
    """Linear-scan support (mesh.rs:224-235), batched over d's shape: the
    (V,) x batch dot products reduce with argmax (the first maximum, as
    ``jnp.argmax``)."""
    batch = d.x.shape
    col = lambda c: c.reshape((-1,) + (1,) * len(batch))
    score = (col(cm.verts.x) * d.x + col(cm.verts.y) * d.y
             + col(cm.verts.z) * d.z)                  # (V, *batch)
    best = torch.argmax(score, dim=0)
    return Vec3(cm.verts.x[best], cm.verts.y[best], cm.verts.z[best]) + cm.x
