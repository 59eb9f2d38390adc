"""The sphere step's "near" terrain stage in one pass: the hand-written
CUDA kernel K5.

For each body, against a small triangle mesh: the ``near`` cull (the
``cand`` faces whose AABBs are nearest within the body's reach), with
``stable`` their ids in ascending order, then
``collision.contact_triangle_moving_sphere`` and ``contact_neg`` for each
candidate, the local contact and ``manifold.prune`` at one slot, and the
body's deepest penetration.  It returns the terrain ``Manifold`` over
(1, cand, N), the candidate face ids (cand, N) int32 that key the warm
start, and the deepest penetration over all bodies.  The kernel
(``csrc/sphere_terrain.cu``) runs one thread per body with the mesh in
shared memory.  It replaces no TPU kernel: mgf_tpu runs the stage as XLA
fusions.

:func:`sphere_terrain_near` launches the kernel for CUDA tensors and runs
:func:`sphere_terrain_near_reference`, the plain PyTorch stage (the inline
stage of ``world.step_tail`` for spheres), for CPU tensors.  Nothing else selects
between them: a CUDA call that cannot build or launch the kernel raises.
:func:`near_terrain`, :func:`stable_candidates`, :func:`gather_triangles`
and :func:`deepest` are the stage's pieces that the other terrain paths of
``world`` share.
"""

from __future__ import annotations

import ctypes

import torch

from mgf_tpu_torch.collision import (
    Contact, LocalContact, contact_neg, contact_stack_bcast,
    contact_triangle_moving_sphere,
)
from mgf_tpu_torch.geom import Sphere, Triangle
from mgf_tpu_torch.manifold import Manifold, prune
from mgf_tpu_torch.math3d import Vec3, dot, magnitude2
from mgf_tpu_torch.ops import _build, launches

# kernel launches made by sphere_terrain_near in this process (a replayed
# graph counts the launches its capture recorded)
LAUNCHES = 0

# what the kernel takes: faces in shared memory, candidates in registers
MAX_FACES = 64
MAX_CAND = 8


def near_terrain(terrain: Triangle, x: Vec3, delta: Vec3, shape_r,
                 shape_half_h, cand: int):
    """Dense AABB-distance terrain cull: the ``cand`` nearest faces within
    reach per body, as (N, cand) int32 ids and their mask.
    ``lax.top_k`` keeps the LOWER index among equal scores, and both
    triangles of a box face share one AABB, so ties are certain: a stable
    descending sort reproduces that order exactly."""
    n = x.x.shape[0]
    comps = lambda v: (v.x, v.y, v.z)
    tlo = [torch.minimum(torch.minimum(a, b), c) for a, b, c in zip(
        comps(terrain.a), comps(terrain.b), comps(terrain.c))]
    thi = [torch.maximum(torch.maximum(a, b), c) for a, b, c in zip(
        comps(terrain.a), comps(terrain.b), comps(terrain.c))]
    px = comps(x)
    d2 = torch.zeros((n, terrain.a.x.shape[0]), dtype=torch.float32,
                     device=x.x.device)
    for k in range(3):
        d_ax = torch.clamp(torch.maximum(tlo[k][None, :] - px[k][:, None],
                                         px[k][:, None] - thi[k][None, :]),
                           min=0.0)
        d2 = d2 + d_ax * d_ax
    reach = shape_r + shape_half_h + torch.sqrt(magnitude2(delta)) + 0.1
    score = torch.where(d2 <= (reach * reach)[:, None], -d2, -float("inf"))
    top, pick = torch.sort(score, dim=1, descending=True, stable=True)
    top, pick = top[:, :cand], pick[:, :cand]
    return pick.to(torch.int32), torch.isfinite(top)


def stable_candidates(t_cand, t_ok):
    """``stable_pairs`` for (N, width) terrain candidates: valid ids in
    ascending order with duplicates dropped, invalid slots last with id
    0."""
    tb = 1 << 28
    tcs = torch.sort(torch.where(t_ok, t_cand, tb), dim=1).values
    tdup = torch.zeros_like(t_ok)
    tdup[:, 1:] = tcs[:, 1:] == tcs[:, :-1]
    t_ok = (tcs < tb) & ~tdup
    return torch.where(t_ok, tcs, 0), t_ok


def gather_triangles(terrain: Triangle, idx) -> Triangle:
    """The faces ``idx`` (int32, any shape) of ``terrain``, by one 9-wide
    row gather."""
    tpack = torch.stack([terrain.a.x, terrain.a.y, terrain.a.z,
                         terrain.b.x, terrain.b.y, terrain.b.z,
                         terrain.c.x, terrain.c.y, terrain.c.z], dim=-1)
    g = tpack[idx.long()]
    return Triangle(a=Vec3(g[..., 0], g[..., 1], g[..., 2]),
                    b=Vec3(g[..., 3], g[..., 4], g[..., 5]),
                    c=Vec3(g[..., 6], g[..., 7], g[..., 8]))


def deepest(c: Contact):
    """Max penetration depth over valid contacts ((ca-cb)·n > 0 when
    overlapping; solver.rs:140 sign convention)."""
    pen = dot(c.b - c.a, c.n)
    return torch.max(torch.where(c.valid, torch.clamp(-pen, min=0.0), 0.0))


def sphere_terrain_near_reference(x: Vec3, delta: Vec3, shape_r,
                                  shape_half_h, terrain: Triangle,
                                  center: Vec3, cand: int, stable: bool,
                                  with_deepest: bool = True):
    """The plain PyTorch version of the kernel: the stage as
    ``world.step_tail`` runs it for spheres with the ``near`` cull.
    Returns (Manifold over (1, cand, N), face ids (cand, N) int32, the
    deepest penetration or None)."""
    t_cand, t_ok = near_terrain(terrain, x, delta, shape_r, shape_half_h,
                                cand)
    if stable:
        t_cand, t_ok = stable_candidates(t_cand, t_ok)
    t_tris = torch.where(t_ok, t_cand, 0).T                 # (cand, N)
    t_valid = t_ok.T
    tri = gather_triangles(terrain, t_tris)
    # the body side as (1, N) broadcasts, as world.self_shapes gives it
    bx = Vec3(*(c[None, :] for c in x))
    bd = Vec3(*(c[None, :] for c in delta))
    tc = contact_neg(contact_stack_bcast([contact_triangle_moving_sphere(
        tri, Sphere(c=bx, r=shape_r[None, :]), bd)]))      # (1, cand, N)
    tc = tc._replace(valid=tc.valid & t_valid[None])
    t_lc = LocalContact(local_a=tc.a - (bx + bd * tc.t),
                        local_b=tc.b - center, contact=tc)
    # one slot and one kept contact: the proximity merge never runs
    man = prune(t_lc, max_contacts=1)
    return man, t_tris, (deepest(tc) if with_deepest else None)


def _check(x, delta, shape_r, shape_half_h, terrain, center, cand):
    n = x.x.shape[0]
    body = [*x, *delta, shape_r, shape_half_h]
    tris = [c for v in terrain for c in v] + list(center)
    for t in body + tris:
        if t.dtype != torch.float32:
            raise TypeError(f"sphere_terrain_near takes float32, got "
                            f"{t.dtype}")
        if t.device != x.x.device:
            raise ValueError(f"a tensor is on {t.device}, x on {x.x.device}")
    for t in body:
        if t.shape != (n,):
            raise ValueError(f"body fields must be ({n},), got "
                             f"{tuple(t.shape)}")
        if t.device.type == "cuda" and not t.is_contiguous():
            raise ValueError("the kernel takes contiguous body fields")
    n_tris = terrain.a.x.shape[0]
    if not 1 <= n_tris <= MAX_FACES:
        raise ValueError(f"the kernel takes 1 to {MAX_FACES} faces, got "
                         f"{n_tris}")
    if not 1 <= cand <= min(MAX_CAND, n_tris):
        raise ValueError(f"cand must be 1 to min({MAX_CAND}, faces), got "
                         f"{cand}")


def _lib():
    fn = _build.load("sphere_terrain").mgf_sphere_terrain
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


def sphere_terrain_near(x: Vec3, delta: Vec3, shape_r, shape_half_h,
                        terrain: Triangle, center: Vec3, cand: int,
                        stable: bool, with_deepest: bool = True):
    """The terrain stage of spheres ``x`` swept by ``delta`` against the
    mesh ``terrain`` (at most ``MAX_FACES`` faces, ``center`` its body's
    centre) with ``cand`` candidate faces a body (at most ``MAX_CAND``):
    (Manifold over (1, cand, N), face ids (cand, N) int32, the deepest
    penetration as a 0-d tensor, or None without ``with_deepest``).
    CUDA tensors launch the kernel; CPU tensors run
    :func:`sphere_terrain_near_reference`."""
    _check(x, delta, shape_r, shape_half_h, terrain, center, cand)
    dev = x.x.device
    if dev.type == "cpu":
        return sphere_terrain_near_reference(
            x, delta, shape_r, shape_half_h, terrain, center, cand, stable,
            with_deepest)
    if dev.type != "cuda":
        raise ValueError(f"sphere_terrain_near runs on cuda or cpu, not "
                         f"{dev}")
    fn = _lib()
    n = x.x.shape[0]
    n_tris = terrain.a.x.shape[0]
    tri = torch.cat([c for v in terrain for c in v]
                    + [c.reshape(1) for c in center])
    man = torch.empty((16, cand, n), dtype=torch.float32, device=dev)
    valid = torch.empty((1, cand, n), dtype=torch.bool, device=dev)
    tris = torch.empty((cand, n), dtype=torch.int32, device=dev)
    deep = (torch.empty((n,), dtype=torch.float32, device=dev)
            if with_deepest else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*(t.data_ptr() for t in (*x, *delta, shape_r, shape_half_h,
                                      tri)),
             n_tris, cand, int(bool(stable)), n, man.data_ptr(),
             valid.data_ptr(), tris.data_ptr(),
             None if deep is None else deep.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sphere_terrain kernel launch failed: "
                           f"cudaError {err}")
    launches.count(__name__, "LAUNCHES")
    v3 = lambda k: Vec3(man[k], man[k + 1], man[k + 2])
    slot = lambda k: Vec3(man[k, None], man[k + 1, None], man[k + 2, None])
    manifold = Manifold(time=man[0], normal=v3(1), t1=v3(4), t2=v3(7),
                        local_a=slot(10), local_b=slot(13), valid=valid)
    return manifold, tris, (torch.max(deep) if with_deepest else None)
