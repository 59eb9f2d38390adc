"""Rigid-body state and integration for spheres and capsules (counterpart
of ``mgf_tpu.physics``; reference: physics.rs).

The body store is one structure-of-arrays NamedTuple,
:class:`RigidBodyState`, with the same fields as the JAX package's.  Scenes
are assembled on the host in numpy with :class:`SceneBuilder` and moved to a
device once, in :meth:`SceneBuilder.build` (the CUDA card unless the
caller names another).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mgf_tpu_torch.geom import Capsule, Sphere
from mgf_tpu_torch.math3d import (
    Mat3, Quat, Vec3, dot, magnitude, mat_diag, mat_identity, mat_mul, mat_t,
    mat_vec, outer, qmul, qnormalize, qrotate, quat_from_arc, quat_from_sv,
    quat_to_mat,
)

SHAPE_SPHERE = 0
SHAPE_CAPSULE = 1


class RigidBodyState(NamedTuple):
    """SoA rigid-body store (physics.rs:141-155).  ``delta`` is the
    current frame's sweep displacement (``Moving::delta``)."""
    x: Vec3                  # position (collider center)
    q: Quat                  # orientation
    v: Vec3                  # linear velocity
    omega: Vec3              # angular velocity
    force: Vec3              # constant world force (gravity * mass)
    torque: Vec3
    restitution: torch.Tensor  # (N,)
    friction: torch.Tensor     # (N,)
    inv_mass: torch.Tensor     # (N,)
    inv_moment_body: Mat3      # body-frame inverse inertia
    inv_moment: Mat3           # world-frame inverse inertia
    shape_type: torch.Tensor   # (N,) int32: 0 sphere / 1 capsule
    shape_r: torch.Tensor      # (N,)
    shape_half_h: torch.Tensor  # (N,) capsule half height (0 for spheres)
    delta: Vec3                # sweep displacement v*dt this frame

    @property
    def n_bodies(self):
        return self.inv_mass.shape[0]


def sphere_tensor(c: Vec3, r, m) -> Mat3:
    """physics.rs:30-46 (0.4 m r^2 + parallel-axis displacement term)."""
    i = 0.4 * m * r * r
    base = mat_identity(i.shape, device=i.device) * i
    par = mat_identity(i.shape, device=i.device) * dot(c, c) - outer(c, c)
    return base + par * m


def capsule_tensor(a: Vec3, d: Vec3, r, m) -> Mat3:
    """physics.rs:48-84: hemispheres + cylinder split, rotated by from_arc.

    The hemisphere term is the reference formula verbatim (physics.rs:62:
    ``is_x = mh * (3r + 2h)/4 * h``), kept for parity even where it differs
    from the textbook expression."""
    h = magnitude(d)
    mh = m * 2.0 * r / (4.0 * r + 3.0 * h)
    mc = m * h / (4.0 / 3.0 * r + h)
    ic_x = 1.0 / 12.0 * mc * (3.0 * r * r + h * h)
    ic_y = 0.5 * mc * r * r
    is_x = mh * (3.0 * r + 2.0 * h) / 4.0 * h
    is_y = 4.0 / 5.0 * mh * r * r
    i_x = ic_x + is_x
    i_y = ic_y + is_y
    zero = torch.zeros_like(h)
    rot = quat_to_mat(quat_from_arc(Vec3(zero, h, zero), d))
    i = mat_mul(mat_mul(rot, mat_diag(i_x, i_y, i_x)), mat_t(rot))
    center = a + d * 0.5
    ident = mat_identity(i_x.shape, device=i_x.device)
    par = ident * dot(center, center) - outer(center, center)
    return i + par * m


def obb_tensor(c: Vec3, q: Quat, r: Vec3, m) -> Mat3:
    """physics.rs:95-120."""
    x, y, z = 2.0 * r.x, 2.0 * r.y, 2.0 * r.z
    i_x = 1.0 / 12.0 * m * (y * y + z * z)
    i_y = 1.0 / 12.0 * m * (x * x + z * z)
    i_z = 1.0 / 12.0 * m * (x * x + y * y)
    rot = quat_to_mat(q)
    i = mat_mul(mat_mul(rot, mat_diag(i_x, i_y, i_z)), mat_t(rot))
    ident = mat_identity(i_x.shape, device=i_x.device)
    par = ident * dot(c, c) - outer(c, c)
    return i + par * m


def integrate(state: RigidBodyState, dt, iso: bool = False) -> RigidBodyState:
    """One semi-implicit Euler step (physics.rs:222-253):
    q += 0.5 (0, w dt) * q (normalized); world inverse inertia R I^-1 R^T;
    v += F m^-1 dt; w += I^-1 tau dt; collider swept by v dt.

    ``iso``: every body's inverse inertia is isotropic (spheres), so
    R I^-1 R^T == I^-1 identically and the rotation is skipped."""
    omega_q = quat_from_sv(torch.zeros_like(state.omega.x), state.omega * dt)
    q = qnormalize(state.q + qmul(omega_q, state.q) * 0.5)
    if iso:
        inv_moment = state.inv_moment_body
    else:
        r = quat_to_mat(q)
        inv_moment = mat_mul(mat_mul(r, state.inv_moment_body), mat_t(r))
    v = state.v + state.force * (state.inv_mass * dt)
    omega = state.omega + mat_vec(inv_moment, state.torque) * dt
    return state._replace(q=q, inv_moment=inv_moment, v=v, omega=omega,
                          delta=v * dt)


def complete_motion(state: RigidBodyState) -> RigidBodyState:
    """Commit the previous frame's sweep: x += delta (physics.rs:262-269)."""
    return state._replace(x=state.x + state.delta)


def capsule_axis(state) -> Vec3:
    """Rotated half-axis of each capsule body: rot(q, (0, half_h, 0))."""
    zero = torch.zeros_like(state.shape_half_h)
    return qrotate(state.q, Vec3(zero, state.shape_half_h, zero))


def colliders(state):
    """World colliders as a (Sphere, Capsule) SoA pair (compound.rs:217-228
    + physics.rs:243-251).  Both batches cover all N bodies; ``shape_type``
    says which is live.  Sphere centers are x; capsules run
    x - d_half .. x + d_half."""
    d_half = capsule_axis(state)
    spheres = Sphere(c=state.x, r=state.shape_r)
    capsules = Capsule(a=state.x - d_half, d=d_half * 2.0, r=state.shape_r)
    return spheres, capsules


def body_centers(state) -> Vec3:
    """Collider centers (== x for both shapes by construction)."""
    return state.x


def _np_quat_from_arc_y(d):
    """Vectorized numpy from_arc((0,1,0), d) for capsule frames."""
    d = np.asarray(d, np.float64)
    dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
    y = np.asarray([0.0, 1.0, 0.0])
    w = 1.0 + dn @ y
    v = np.cross(np.broadcast_to(y, dn.shape), dn)
    q = np.concatenate([w[..., None], v], axis=-1)
    anti = w < 1e-6
    q[anti] = np.asarray([0.0, 1.0, 0.0, 0.0])  # pi around x
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return q.astype(np.float32)


class SceneBuilder:
    """Accumulates bodies on the host (numpy), then moves them to a device
    as one :class:`RigidBodyState` (RigidBodyVec::add_body,
    physics.rs:200-218).  Produces the same arrays as the JAX class.

    Inertia: mgf computes the "body-frame" inverse inertia from the collider
    in its initial world orientation and then also rotates it by q each step
    (physics.rs:212 + 230-233).  As the JAX package does, it stores
    the canonical y-aligned capsule tensor instead (PARITY.md)."""

    def __init__(self):
        self._batches = []

    def add_spheres(self, centers, radii, mass, restitution, friction,
                    gravity=(0.0, -9.8, 0.0)):
        """Vectorized sphere batch: centers (B,3); scalars broadcast."""
        centers = np.atleast_2d(np.asarray(centers, np.float32))
        if np.any(np.asarray(radii) <= 0.0):
            raise ValueError("sphere radius must be > 0 (geom.rs:300)")
        if np.any(np.asarray(mass) <= 0.0):
            raise ValueError("mass must be > 0")
        b = centers.shape[0]
        br = lambda s: np.broadcast_to(np.asarray(s, np.float32), (b,)).copy()
        self._batches.append(dict(
            kind=np.full(b, SHAPE_SPHERE, np.int32), x=centers,
            q=np.tile(np.asarray([[1, 0, 0, 0]], np.float32), (b, 1)),
            r=br(radii), half_h=np.zeros(b, np.float32), mass=br(mass),
            restitution=br(restitution), friction=br(friction),
            gravity=np.broadcast_to(np.asarray(gravity, np.float32),
                                    (b, 3)).copy()))

    def add_capsules(self, a, d, radii, mass, restitution, friction,
                     gravity=(0.0, -9.8, 0.0)):
        """Vectorized capsule batch from start points + axis vectors
        (Component::deconstruct, compound.rs:46-50: center = a + d/2,
        rot = from_arc(y, d))."""
        a = np.atleast_2d(np.asarray(a, np.float64))
        d = np.atleast_2d(np.asarray(d, np.float64))
        if np.any(np.asarray(radii) <= 0.0):
            raise ValueError("capsule radius must be > 0 (geom.rs:329)")
        if np.any(np.asarray(mass) <= 0.0):
            raise ValueError("mass must be > 0")
        d = np.broadcast_to(d, a.shape)
        b = a.shape[0]
        br = lambda s: np.broadcast_to(np.asarray(s, np.float32), (b,)).copy()
        self._batches.append(dict(
            kind=np.full(b, SHAPE_CAPSULE, np.int32),
            x=(a + d * 0.5).astype(np.float32),
            q=_np_quat_from_arc_y(d),
            r=br(radii),
            half_h=(np.linalg.norm(d, axis=-1) * 0.5).astype(np.float32),
            mass=br(mass), restitution=br(restitution), friction=br(friction),
            gravity=np.broadcast_to(np.asarray(gravity, np.float32),
                                    (b, 3)).copy()))

    def add_sphere(self, center, radius, mass, restitution, friction,
                   gravity=(0.0, -9.8, 0.0)):
        self.add_spheres(np.asarray(center, np.float32)[None, :], radius,
                         mass, restitution, friction, gravity)
        return sum(len(b['r']) for b in self._batches) - 1

    def add_capsule(self, a, d, radius, mass, restitution, friction,
                    gravity=(0.0, -9.8, 0.0)):
        self.add_capsules(np.asarray(a, np.float64)[None, :],
                          np.asarray(d, np.float64)[None, :], radius,
                          mass, restitution, friction, gravity)
        return sum(len(b['r']) for b in self._batches) - 1

    def add_static_spheres(self, centers, radii, friction):
        """Immovable sphere colliders (RigidBodyRef::Static, physics.rs:
        159-177: inv_mass 0, zero moment, restitution 0)."""
        self.add_spheres(centers, radii, mass=np.inf, restitution=0.0,
                         friction=friction, gravity=(0.0, 0.0, 0.0))

    def add_static_capsules(self, a, d, radii, friction):
        """Immovable capsule colliders (RigidBodyRef::Static)."""
        self.add_capsules(a, d, radii, mass=np.inf, restitution=0.0,
                          friction=friction, gravity=(0.0, 0.0, 0.0))

    def build(self, device=torch.device("cuda")) -> RigidBodyState:
        g = lambda k: np.concatenate([b[k] for b in self._batches], axis=0)
        kind = g('kind')
        r = g('r')
        half_h = g('half_h')
        mass = g('mass')
        n = r.shape[0]
        # inverse body inertia at the collider origin (physics.rs:212):
        # spheres diag(1/(0.4 m r^2)), capsules y-aligned; mass=inf statics
        # invert to 0
        inv_t = np.zeros((n, 3, 3), np.float32)
        sph = kind == SHAPE_SPHERE
        with np.errstate(divide="ignore"):
            i_sph = 0.4 * mass * r * r
            for ax in range(3):
                inv_t[sph, ax, ax] = 1.0 / i_sph[sph]
        cap = ~sph
        if cap.any():
            h = 2.0 * half_h[cap]
            rr = r[cap]
            m = mass[cap]
            mh = m * 2.0 * rr / (4.0 * rr + 3.0 * h)
            mc = m * h / (4.0 / 3.0 * rr + h)
            ic_x = 1.0 / 12.0 * mc * (3.0 * rr * rr + h * h)
            ic_y = 0.5 * mc * rr * rr
            is_x = mh * (3.0 * rr + 2.0 * h) / 4.0 * h
            is_y = 4.0 / 5.0 * mh * rr * rr
            i_x = ic_x + is_x
            i_y = ic_y + is_y
            idx = np.nonzero(cap)[0]
            with np.errstate(divide="ignore", invalid="ignore"):
                inv_t[idx, 0, 0] = 1.0 / i_x
                inv_t[idx, 1, 1] = 1.0 / i_y
                inv_t[idx, 2, 2] = 1.0 / i_x
            inv_t[np.isnan(inv_t) | np.isinf(inv_t)] = 0.0
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        cols = lambda a: [t(a[..., k]) for k in range(a.shape[-1])]
        zeros3 = Vec3(*cols(np.zeros((n, 3), np.float32)))
        inv_m = Mat3(*cols(inv_t.reshape(n, 9)))
        finite = np.isfinite(mass)
        return RigidBodyState(
            x=Vec3(*cols(g('x'))), q=Quat(*cols(g('q'))),
            v=zeros3, omega=zeros3,
            force=Vec3(*cols((g('gravity') * np.where(finite, mass, 0.0)
                              [:, None]).astype(np.float32))),
            torque=zeros3,
            restitution=t(g('restitution')),
            friction=t(g('friction')),
            inv_mass=t(np.where(finite, 1.0 / mass, 0.0).astype(np.float32)),
            inv_moment_body=inv_m,
            inv_moment=inv_m,
            shape_type=t(kind),
            shape_r=t(r),
            shape_half_h=t(half_h),
            delta=zeros3,
        )
