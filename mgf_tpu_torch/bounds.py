"""Bounding volumes of the sphere slice (counterpart of ``mgf_tpu.bounds``)."""

from __future__ import annotations

from mgf_tpu_torch.geom import AABB, Sphere
from mgf_tpu_torch.math3d import vsplat


def sphere_aabb(s: Sphere) -> AABB:
    """bounds.rs:170-177."""
    return AABB(c=s.c, r=vsplat(s.r))
