"""Bounding volumes of the sphere and capsule slices (counterpart of
``mgf_tpu.bounds``)."""

from __future__ import annotations

from mgf_tpu_torch.geom import AABB, Capsule, Sphere
from mgf_tpu_torch.math3d import magnitude, vsplat


def sphere_aabb(s: Sphere) -> AABB:
    """bounds.rs:170-177."""
    return AABB(c=s.c, r=vsplat(s.r))


def capsule_aabb(c: Capsule) -> AABB:
    """bounds.rs:179-188: conservative cube covering all rotations."""
    r = c.r + magnitude(c.d) * 0.5
    return AABB(c=c.a + c.d * 0.5, r=vsplat(r))
