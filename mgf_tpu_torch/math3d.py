"""Vector / quaternion / 3x3-matrix math in component form, on torch tensors.

Counterpart of ``mgf_tpu.math3d``: a :class:`Vec3` is a NamedTuple of three
separate component tensors, a :class:`Quat` four (w, x, y, z) and a
:class:`Mat3` nine (row-major).  Keeping the component layout at the public
boundary lets every function here take and return the same fields as its
JAX twin, so the two packages compare field by field through numpy.

All ops broadcast like tensors.  The ``safe_*`` helpers never produce NaN or
Inf from masked-out lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Maximum tolerance for error (reference: geom.rs:27).
COLLISION_EPSILON = 1e-6


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise across NamedTuples (nested) of tensors, the
    role ``jax.tree_util.tree_map`` plays in the JAX package.  ``None``
    fields stay ``None``."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(tree_map(fn, *parts) for parts in zip(*trees)))
    return fn(*trees)


# ---------------------------------------------------------------------------
# scalar helpers
# ---------------------------------------------------------------------------

def safe_div(num, den, default=0.0):
    """num / den where den != 0, else default; never NaN/Inf from 0/0."""
    ok = den != 0.0
    return torch.where(ok, num / torch.where(ok, den, 1.0), default)


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


# ---------------------------------------------------------------------------
# Vec3
# ---------------------------------------------------------------------------

class Vec3(NamedTuple):
    """A 3-vector as three component tensors."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # arithmetic (overrides tuple concat/repeat)
    def __add__(self, o):
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, s):
        """Scale by a scalar (tensor)."""
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __getitem__(self, idx):
        """Index/slice every component (e.g. gather by an index tensor)."""
        return Vec3(self.x[idx], self.y[idx], self.z[idx])

    @property
    def shape(self):
        return self.x.shape


def vsplat(s) -> Vec3:
    """Vec3 with all components equal to the scalar tensor s."""
    return Vec3(s, s, s)


def vzeros_like(v: Vec3) -> Vec3:
    return Vec3(torch.zeros_like(v.x), torch.zeros_like(v.y),
                torch.zeros_like(v.z))


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y,
                a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)


def magnitude2(v: Vec3):
    return dot(v, v)


def normalize(v: Vec3) -> Vec3:
    return v * (1.0 / torch.sqrt(magnitude2(v)))


def safe_normalize(v: Vec3) -> Vec3:
    m2 = magnitude2(v)
    ok = m2 > 0.0
    inv = torch.where(ok, 1.0 / safe_sqrt(torch.where(ok, m2, 1.0)), 0.0)
    return v * inv


def where_vec(cond, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.where(cond, a.x, b.x), torch.where(cond, a.y, b.y),
                torch.where(cond, a.z, b.z))


def vmin(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.minimum(a.x, b.x), torch.minimum(a.y, b.y),
                torch.minimum(a.z, b.z))


def vmax(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.maximum(a.x, b.x), torch.maximum(a.y, b.y),
                torch.maximum(a.z, b.z))


def perpendicular(v: Vec3) -> Vec3:
    """Some unit vector perpendicular to v (cgmath from_arc fallback rule)."""
    zero = torch.zeros_like(v.x)
    one = torch.ones_like(v.x)
    w1 = cross(Vec3(one, zero, zero), v)
    w2 = cross(Vec3(zero, one, zero), v)
    use1 = magnitude2(w1) > COLLISION_EPSILON
    return safe_normalize(where_vec(use1, w1, w2))


# ---------------------------------------------------------------------------
# Quat (w, x, y, z) — cgmath's scalar-first convention
# ---------------------------------------------------------------------------

class Quat(NamedTuple):
    w: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def v(self) -> Vec3:
        return Vec3(self.x, self.y, self.z)

    def __add__(self, o):
        return Quat(self.w + o.w, self.x + o.x, self.y + o.y, self.z + o.z)

    def __mul__(self, s):
        return Quat(self.w * s, self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __getitem__(self, idx):
        return Quat(self.w[idx], self.x[idx], self.y[idx], self.z[idx])


def quat_from_sv(s, v: Vec3) -> Quat:
    return Quat(s, v.x, v.y, v.z)


def qmul(p: Quat, q: Quat) -> Quat:
    """Hamilton product p * q."""
    w = p.w * q.w - (p.x * q.x + p.y * q.y + p.z * q.z)
    v = p.v * q.w + q.v * p.w + cross(p.v, q.v)
    return Quat(w, v.x, v.y, v.z)


def qnormalize(q: Quat) -> Quat:
    m2 = q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z
    ok = m2 > 0.0
    inv = torch.where(ok, 1.0 / safe_sqrt(torch.where(ok, m2, 1.0)), 0.0)
    out = q * inv
    return Quat(torch.where(ok, out.w, 1.0), torch.where(ok, out.x, 0.0),
                torch.where(ok, out.y, 0.0), torch.where(ok, out.z, 0.0))


# ---------------------------------------------------------------------------
# Mat3 — row-major 3x3 as nine component tensors
# ---------------------------------------------------------------------------

class Mat3(NamedTuple):
    xx: torch.Tensor
    xy: torch.Tensor
    xz: torch.Tensor
    yx: torch.Tensor
    yy: torch.Tensor
    yz: torch.Tensor
    zx: torch.Tensor
    zy: torch.Tensor
    zz: torch.Tensor

    def __add__(self, o):
        return Mat3(*(a + b for a, b in zip(self, o)))

    def __sub__(self, o):
        return Mat3(*(a - b for a, b in zip(self, o)))

    def __mul__(self, s):
        return Mat3(*(a * s for a in self))

    __rmul__ = __mul__

    def __getitem__(self, idx):
        return Mat3(*(a[idx] for a in self))


def mat_vec(m: Mat3, v: Vec3) -> Vec3:
    return Vec3(m.xx * v.x + m.xy * v.y + m.xz * v.z,
                m.yx * v.x + m.yy * v.y + m.yz * v.z,
                m.zx * v.x + m.zy * v.y + m.zz * v.z)


def mat_identity(shape=(), device=None, dtype=torch.float32) -> Mat3:
    one = torch.ones(shape, dtype=dtype, device=device)
    zero = torch.zeros(shape, dtype=dtype, device=device)
    return Mat3(one, zero, zero, zero, one, zero, zero, zero, one)


def outer(a: Vec3, b: Vec3) -> Mat3:
    return Mat3(a.x * b.x, a.x * b.y, a.x * b.z,
                a.y * b.x, a.y * b.y, a.y * b.z,
                a.z * b.x, a.z * b.y, a.z * b.z)
