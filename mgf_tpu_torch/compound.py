"""Compound shapes: aggregates of sphere and capsule components.

Counterpart of ``mgf_tpu.compound`` (reference: compound.rs).  A
:class:`Compound` is a set of components with a shared displacement and
rotation (compound.rs:232-242), each component in the engine-wide
(shape type, r, half_h) encoding of ``physics.SHAPE_*``.  Where mgf looks
components up with a BVH, compounds here are small fixed-size batches
tested densely (a compound body has a handful of parts, and the broadphase
already culled the pair):

* contacts against a moving sphere or capsule (compound.rs:334-352) and
  against a moving triangle or rectangle, every component tested and the
  contacts flipped so the compound is the receiver;
* the raytrace (Intersects, compound.rs:309-332);
* the inertia: the summed parallel-axis tensor (physics.rs:86-93).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mgf_tpu_torch.collision import (
    Contact, Intersection, contact_advect, contact_capsule_moving_capsule,
    contact_capsule_moving_sphere, contact_neg, contact_rectangle_moving_capsule,
    contact_rectangle_moving_sphere, contact_select,
    contact_sphere_moving_capsule, contact_sphere_moving_sphere,
    contact_stack, contact_triangle_moving_capsule,
    contact_triangle_moving_sphere, intersect_capsule, intersect_sphere,
)
from mgf_tpu_torch.geom import Capsule, Sphere, Triangle
from mgf_tpu_torch.math3d import (
    Mat3, Quat, Vec3, mat_inv3, qconj, qmul, qrotate, tree_map,
)
from mgf_tpu_torch.physics import (
    SHAPE_CAPSULE, SHAPE_SPHERE, _np_quat_from_arc_y, capsule_tensor,
    sphere_tensor,
)

CUDA = torch.device("cuda")


class Compound(NamedTuple):
    """An aggregate of components with a displacement + rotation
    (compound.rs:232-242).  Component fields are (P,) SoA in the compound's
    local frame."""
    disp: Vec3               # world displacement
    rot: Quat                # world rotation (assumed normalized)
    kind: torch.Tensor       # (P,) int32 SHAPE_*
    local_x: Vec3            # (P,) component centers (local frame)
    local_q: Quat            # (P,) component orientations (local frame)
    r: torch.Tensor          # (P,)
    half_h: torch.Tensor     # (P,)

    @property
    def n_parts(self):
        return self.r.shape[0]


def compound_from_parts(parts, disp=(0.0, 0.0, 0.0), *,
                        device=CUDA) -> Compound:
    """Build a compound on ``device`` from a list of dicts:
    {"kind": "sphere"|"capsule", "center"|("a", "d"), "r"}."""
    kinds, xs, qs, rs, hh = [], [], [], [], []
    for p in parts:
        if p["kind"] == "sphere":
            kinds.append(SHAPE_SPHERE)
            xs.append(np.asarray(p["center"], np.float32))
            qs.append(np.asarray([1, 0, 0, 0], np.float32))
            hh.append(0.0)
        else:
            a = np.asarray(p["a"], np.float64)
            d = np.asarray(p["d"], np.float64)
            kinds.append(SHAPE_CAPSULE)
            xs.append((a + d * 0.5).astype(np.float32))
            qs.append(_np_quat_from_arc_y(d[None])[0])
            hh.append(float(np.linalg.norm(d)) * 0.5)
        rs.append(float(p["r"]))
    t = lambda a: torch.as_tensor(np.array(a), device=device)   # a copy
    x, q = np.stack(xs), np.stack(qs)
    dp = np.asarray(disp, np.float32)
    one, zero = t(np.float32(1.0)), t(np.float32(0.0))
    return Compound(
        disp=Vec3(*(t(dp[k]) for k in range(3))),
        rot=Quat(one, zero, zero.clone(), zero.clone()),
        kind=t(np.asarray(kinds, np.int32)),
        local_x=Vec3(*(t(x[:, k]) for k in range(3))),
        local_q=Quat(*(t(q[:, k]) for k in range(4))),
        r=t(np.asarray(rs, np.float32)),
        half_h=t(np.asarray(hh, np.float32)))


def compound_world_components(c: Compound):
    """Components rotated about the origin and displaced
    (compound.rs:347: rotate_about(rot, origin) + disp).  Returns
    (Sphere (P,), Capsule (P,), kind)."""
    x = qrotate(c.rot, c.local_x) + c.disp
    q = qmul(c.rot, c.local_q)
    zero = torch.zeros_like(c.half_h)
    d_half = qrotate(q, Vec3(zero, c.half_h, zero))
    return (Sphere(c=x, r=c.r),
            Capsule(a=x - d_half, d=d_half * 2.0, r=c.r),
            c.kind)


def _bcast(t, P: int):
    """Every field of a single shape or vector broadcast to (P, ...)."""
    return tree_map(lambda x: x.expand((P,) + x.shape), t)


def compound_contacts(c: Compound, shape, v: Vec3) -> Contact:
    """Contacts<RHS> for Compound (compound.rs:334-352): every component
    against the moving ``shape`` (one Sphere or Capsule, swept by ``v``).
    Returns a Contact batch over the components (P,), with a leading slot
    axis where a capsule pair emits two; callers prune."""
    spheres, capsules, kind = compound_world_components(c)
    P = c.n_parts
    s, vb = _bcast(shape, P), _bcast(v, P)
    if isinstance(shape, Sphere):
        cs = contact_sphere_moving_sphere(spheres, s, vb)
        cc = contact_capsule_moving_sphere(capsules, s, vb)
    else:
        cs = contact_sphere_moving_capsule(spheres, s, vb)
        cc = contact_capsule_moving_capsule(capsules, s, vb)
    return contact_select(kind == SHAPE_SPHERE, cs, cc)


def compound_raytrace(c: Compound, p: Vec3, d: Vec3, dt=float("inf")
                      ) -> Intersection:
    """Ray/segment vs Compound (Intersects, compound.rs:309-332): the ray
    is rotated into the compound frame and tested against every component;
    the smallest t wins."""
    conj = qconj(c.rot)
    p_l = qrotate(conj, p - c.disp) + c.disp
    d_l = qrotate(conj, d)
    # the reference tests the ROTATED components against the local ray
    # (compound.rs:320: shape = comp.rotate(rhs.rot) + rhs.disp)
    spheres, capsules, _ = compound_world_components(c)
    P = c.n_parts
    i_s = intersect_sphere(_bcast(p_l, P), _bcast(d_l, P), dt, spheres)
    i_c = intersect_capsule(_bcast(p_l, P), _bcast(d_l, P), dt, capsules)
    hit_s = i_s.hit & (c.kind == SHAPE_SPHERE)
    hit_c = i_c.hit & (c.kind == SHAPE_CAPSULE)
    inf = torch.full_like(i_s.t, float("inf"))
    t = torch.where(hit_s, i_s.t, torch.where(hit_c, i_c.t, inf))
    best = torch.argmin(t, dim=0)        # the first of equal minima
    is_s = (c.kind == SHAPE_SPHERE).reshape((-1,) + (1,) * (t.dim() - 1))
    pt = tree_map(lambda a, b: torch.where(is_s, a, b), i_s.p, i_c.p)
    pick = lambda arr: torch.gather(arr, 0, best[None]).squeeze(0)
    return Intersection(p=tree_map(pick, pt), t=pick(t),
                        hit=torch.min(t, dim=0).values < float("inf"))


def compound_inertia(c: Compound, mass) -> Mat3:
    """Summed component tensors with parallel-axis terms about the compound
    origin, the mass split evenly (Inertia for Component,
    physics.rs:86-93).  Returns the inverse tensor."""
    P = c.n_parts
    m_part = torch.full((P,), mass / P, dtype=torch.float32,
                        device=c.r.device)
    zero = torch.zeros_like(c.half_h)
    d_half = qrotate(c.local_q, Vec3(zero, c.half_h, zero))
    t_sph = sphere_tensor(c.local_x, c.r, m_part)
    t_cap = capsule_tensor(c.local_x - d_half, d_half * 2.0, c.r, m_part)
    sel = c.kind == SHAPE_SPHERE
    t = Mat3(*(torch.where(sel, a, b) for a, b in zip(t_sph, t_cap)))
    return mat_inv3(Mat3(*(comp.sum(dim=0) for comp in t)))


def compound_contacts_polygon(c: Compound, poly, v: Vec3) -> Contact:
    """Contacts between a Compound and a moving Triangle or Rectangle
    (Contacts<RHS> for Compound with a polygon RHS, compound.rs:334-352).
    The reference dispatches rhs.contacts(component): the polygon receives
    the component moving at -v, and the compound commute flips twice, so
    the polygon tests the component swept by -v, the contacts are advected
    by v * t and flipped so the compound is side a.  Returns slots (2, P)
    over the components."""
    spheres, capsules, kind = compound_world_components(c)
    P = c.n_parts
    polyb, vb = _bcast(poly, P), _bcast(v, P)
    if isinstance(poly, Triangle):
        f_s, f_c = contact_triangle_moving_sphere, \
            contact_triangle_moving_capsule
    else:
        f_s, f_c = contact_rectangle_moving_sphere, \
            contact_rectangle_moving_capsule
    cs = f_s(polyb, spheres, -vb)
    cs2 = contact_stack([cs, cs._replace(valid=torch.zeros_like(cs.valid))])
    cc = f_c(polyb, capsules, -vb)
    out = contact_select((kind == SHAPE_SPHERE)[None, :], cs2, cc)
    out = contact_advect(out, vb * out.t)
    return contact_neg(out)
