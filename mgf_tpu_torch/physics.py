"""Rigid-body state and integration, sphere slice (counterpart of
``mgf_tpu.physics``; reference: physics.rs).

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

from mgf_tpu_torch.geom import Sphere
from mgf_tpu_torch.math3d import (
    Mat3, Quat, Vec3, dot, mat_identity, mat_vec, outer, qmul, qnormalize,
    quat_from_sv,
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


def integrate(state: RigidBodyState, dt, iso: bool = False) -> RigidBodyState:
    """One semi-implicit Euler step (physics.rs:222-253):
    q += 0.5 (0, w dt) * q (normalized); v += F m^-1 dt; w += I^-1 tau dt;
    collider swept by v dt.

    Only the isotropic form (``iso=True``: every body's inverse inertia is
    diag-isotropic, so the world inverse inertia equals the body one) is on
    the sphere slice."""
    if not iso:
        raise NotImplementedError(
            "integrate(iso=False) rotates the inertia tensor; it arrives "
            "with the capsule slice (ROADMAP slice 9)")
    omega_q = quat_from_sv(torch.zeros_like(state.omega.x), state.omega * dt)
    q = qnormalize(state.q + qmul(omega_q, state.q) * 0.5)
    inv_moment = state.inv_moment_body
    v = state.v + state.force * (state.inv_mass * dt)
    omega = state.omega + mat_vec(inv_moment, state.torque) * dt
    return state._replace(q=q, inv_moment=inv_moment, v=v, omega=omega,
                          delta=v * dt)


def complete_motion(state: RigidBodyState) -> RigidBodyState:
    """Commit the previous frame's sweep: x += delta (physics.rs:262-269)."""
    return state._replace(x=state.x + state.delta)


def colliders(state) -> Sphere:
    """World sphere colliders (compound.rs:217-228 + physics.rs:243-251):
    the sphere half of ``mgf_tpu.physics.colliders``; the capsule half
    arrives with the capsule slice."""
    return Sphere(c=state.x, r=state.shape_r)


class SceneBuilder:
    """Accumulates sphere bodies on the host (numpy), then moves them to a
    device as one :class:`RigidBodyState` (RigidBodyVec::add_body,
    physics.rs:200-218).  Produces the same arrays as the JAX builder."""

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

    def add_sphere(self, center, radius, mass, restitution, friction,
                   gravity=(0.0, -9.8, 0.0)):
        self.add_spheres(np.asarray(center, np.float32)[None, :], radius,
                         mass, restitution, friction, gravity)
        return sum(len(b['r']) for b in self._batches) - 1

    def build(self, device=torch.device("cuda")) -> RigidBodyState:
        g = lambda k: np.concatenate([b[k] for b in self._batches], axis=0)
        r = g('r')
        mass = g('mass')
        n = r.shape[0]
        # inverse body inertia at the collider origin (physics.rs:212):
        # spheres diag(1/(0.4 m r^2)); mass=inf statics invert to 0
        inv_t = np.zeros((n, 3, 3), np.float32)
        with np.errstate(divide="ignore"):
            i_sph = 0.4 * mass * r * r
            for ax in range(3):
                inv_t[:, ax, ax] = 1.0 / i_sph
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
            shape_type=t(g('kind')),
            shape_r=t(r),
            shape_half_h=t(g('half_h')),
            delta=zeros3,
        )
