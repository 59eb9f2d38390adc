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


def clamp(n, lo, hi):
    return torch.clamp(n, lo, hi)


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


def magnitude(v: Vec3):
    return torch.sqrt(magnitude2(v))


def normalize(v: Vec3) -> Vec3:
    return v * (1.0 / magnitude(v))


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


def vabs(v: Vec3) -> Vec3:
    return Vec3(torch.abs(v.x), torch.abs(v.y), torch.abs(v.z))


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


def qconj(q: Quat) -> Quat:
    return Quat(q.w, -q.x, -q.y, -q.z)


def qnormalize(q: Quat) -> Quat:
    m2 = q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z
    ok = m2 > 0.0
    inv = torch.where(ok, 1.0 / safe_sqrt(torch.where(ok, m2, 1.0)), 0.0)
    out = q * inv
    return Quat(torch.where(ok, out.w, 1.0), torch.where(ok, out.x, 0.0),
                torch.where(ok, out.y, 0.0), torch.where(ok, out.z, 0.0))


def qrotate(q: Quat, v: Vec3) -> Vec3:
    """Rotate v by unit quaternion q: v + 2 u x (u x v + w v)."""
    u = q.v
    t = cross(u, v) * 2.0
    return v + t * q.w + cross(u, t)


def quat_from_arc(src: Vec3, dst: Vec3) -> Quat:
    """Shortest-arc rotation src -> dst; cgmath ``from_arc(src, dst, None)``
    semantics (non-unit inputs ok, antiparallel spins pi around an arbitrary
    perpendicular axis).  Used for capsule frames (physics.rs:70,
    compound.rs:48)."""
    mag_avg = safe_sqrt(magnitude2(src) * magnitude2(dst))
    d = dot(src, dst)
    general = qnormalize(quat_from_sv(mag_avg + d, cross(src, dst)))
    anti = quat_from_sv(torch.zeros_like(d), perpendicular(src))
    is_anti = d < -mag_avg * (1.0 - 1e-6)
    return Quat(*(torch.where(is_anti, a, g) for a, g in zip(anti, general)))


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


def mat3_rows(r0: Vec3, r1: Vec3, r2: Vec3) -> Mat3:
    return Mat3(r0.x, r0.y, r0.z, r1.x, r1.y, r1.z, r2.x, r2.y, r2.z)


def mat_mul(a: Mat3, b: Mat3) -> Mat3:
    return Mat3(
        a.xx * b.xx + a.xy * b.yx + a.xz * b.zx,
        a.xx * b.xy + a.xy * b.yy + a.xz * b.zy,
        a.xx * b.xz + a.xy * b.yz + a.xz * b.zz,
        a.yx * b.xx + a.yy * b.yx + a.yz * b.zx,
        a.yx * b.xy + a.yy * b.yy + a.yz * b.zy,
        a.yx * b.xz + a.yy * b.yz + a.yz * b.zz,
        a.zx * b.xx + a.zy * b.yx + a.zz * b.zx,
        a.zx * b.xy + a.zy * b.yy + a.zz * b.zy,
        a.zx * b.xz + a.zy * b.yz + a.zz * b.zz,
    )


def mat_t(m: Mat3) -> Mat3:
    return Mat3(m.xx, m.yx, m.zx, m.xy, m.yy, m.zy, m.xz, m.yz, m.zz)


def mat_diag(x, y, z) -> Mat3:
    zero = torch.zeros_like(x)
    return Mat3(x, zero, zero, zero, y, zero, zero, zero, z)


def mat_inv3(m: Mat3) -> Mat3:
    """Closed-form inverse (adjugate/det); zero matrix for singular lanes."""
    c00 = m.yy * m.zz - m.yz * m.zy
    c01 = m.yz * m.zx - m.yx * m.zz
    c02 = m.yx * m.zy - m.yy * m.zx
    det = m.xx * c00 + m.xy * c01 + m.xz * c02
    inv_det = safe_div(torch.ones_like(det), det)
    return Mat3(
        c00 * inv_det,
        (m.xz * m.zy - m.xy * m.zz) * inv_det,
        (m.xy * m.yz - m.xz * m.yy) * inv_det,
        c01 * inv_det,
        (m.xx * m.zz - m.xz * m.zx) * inv_det,
        (m.xz * m.yx - m.xx * m.yz) * inv_det,
        c02 * inv_det,
        (m.xy * m.zx - m.xx * m.zy) * inv_det,
        (m.xx * m.yy - m.xy * m.yx) * inv_det,
    )


def quat_to_mat(q: Quat) -> Mat3:
    w, x, y, z = q.w, q.x, q.y, q.z
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return Mat3(
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    )
