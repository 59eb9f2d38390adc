"""Batched sphere x moving-sphere contact: the hand-written CUDA kernel K2.

Counterpart of ``mgf_tpu/ops/narrowphase.py`` (the Pallas TPU kernel
``sphere_contact_pairs``).  Computes Contact(a, b, n, t, valid) for P pairs
of swept spheres from two component-major (8, P) blocks
``[x y z dx dy dz r _]`` (column 7 is not read): the math of
``collision.contact_sphere_moving_sphere`` with the moving-moving reduction.
The kernel (``csrc/sphere_contact.cu``) runs one thread per pair.

:func:`sphere_contact_pairs` launches the kernel for CUDA tensors and runs
:func:`sphere_contact_pairs_reference`, the plain PyTorch version that
transcribes the Pallas body op for op (float masks included), for CPU
tensors.  Nothing else selects between them: a CUDA call that cannot
build or launch the kernel raises.
"""

from __future__ import annotations

import ctypes

import torch

from mgf_tpu_torch.collision import Contact
from mgf_tpu_torch.math3d import Vec3
from mgf_tpu_torch.ops import _build, launches

# kernel launches made by sphere_contact_pairs in this process (read and
# reset by callers that must show the main path went through the kernel)
LAUNCHES = 0


def _contact(o1, n) -> Contact:
    """Contact from the (8, P) block [ca cb t valid] and the normal's
    three rows (the Pallas kernel's second block holds n and five zero
    rows; nothing reads the zeros, so neither version writes them)."""
    return Contact(a=Vec3(o1[0], o1[1], o1[2]), b=Vec3(o1[3], o1[4], o1[5]),
                   n=Vec3(n[0], n[1], n[2]), t=o1[6], valid=o1[7] > 0.5)


def sphere_contact_pairs_reference(ga8, gb8) -> Contact:
    """The plain PyTorch version of the kernel: the Pallas body
    (``mgf_tpu/ops/narrowphase.py::_kernel``) transcribed op for op."""
    ga, gb = ga8, gb8
    ax, ay, az, r1 = ga[0], ga[1], ga[2], ga[6]
    bx, by, bz, r2 = gb[0], gb[1], gb[2], gb[6]
    vx = gb[3] - ga[3]
    vy = gb[4] - ga[4]
    vz = gb[5] - ga[5]

    def sel(m, t, f):
        return m * t + (1.0 - m) * f

    def mask(cond):
        return cond.to(torch.float32)

    r = r1 + r2
    dx, dy, dz = bx - ax, by - ay, bz - az
    len2 = dx * dx + dy * dy + dz * dz
    v2 = vx * vx + vy * vy + vz * vz
    m_over = mask(len2 <= r * r)
    m_len0 = mask(len2 == 0.0)
    m_vok = mask(v2 != 0.0)

    inv_len = torch.rsqrt(torch.clamp(len2, min=1e-30))
    inv_v = torch.rsqrt(torch.clamp(v2, min=1e-30))
    # overlap normal: d/|d|, or -v/|v| when coincident
    nox = sel(m_len0, -vx * inv_v, dx * inv_len)
    noy = sel(m_len0, -vy * inv_v, dy * inv_len)
    noz = sel(m_len0, -vz * inv_v, dz * inv_len)
    oax, oay, oaz = ax + nox * r1, ay + noy * r1, az + noz * r1
    obx, oby, obz = bx - nox * r2, by - noy * r2, bz - noz * r2
    over_valid = sel(m_len0, m_vok, 1.0)

    # sweep: ray from a along -v vs sphere(b, r) (intersect_sphere)
    mx, my, mz = ax - bx, ay - by, az - bz
    a_q = v2
    b_q = -(mx * vx + my * vy + mz * vz)
    c_q = len2 - r * r
    disc = b_q * b_q - a_q * c_q
    sdisc = torch.sqrt(torch.clamp(disc, min=0.0))
    t = torch.clamp((-b_q - sdisc) / torch.clamp(a_q, min=1e-30), min=0.0)
    hit = (mask(disc >= 0.0) * mask(a_q > 0.0) * mask(t <= 1.0)
           * (1.0 - mask(c_q > 0.0) * mask(b_q > 0.0)))
    ex, ey, ez = bx + vx * t - ax, by + vy * t - ay, bz + vz * t - az
    e2 = ex * ex + ey * ey + ez * ez
    inv_e = torch.rsqrt(torch.clamp(e2, min=1e-30))
    nsx, nsy, nsz = ex * inv_e, ey * inv_e, ez * inv_e
    sax, say, saz = ax + nsx * r1, ay + nsy * r1, az + nsz * r1

    # select overlap vs sweep, then advect by va * t
    t_out = sel(m_over, 0.0, t)
    valid = sel(m_over, over_valid, m_vok * hit)
    cax = sel(m_over, oax, sax) + ga[3] * t_out
    cay = sel(m_over, oay, say) + ga[4] * t_out
    caz = sel(m_over, oaz, saz) + ga[5] * t_out
    cbx = sel(m_over, obx, sax) + ga[3] * t_out
    cby = sel(m_over, oby, say) + ga[4] * t_out
    cbz = sel(m_over, obz, saz) + ga[5] * t_out
    nx = sel(m_over, nox, nsx)
    ny = sel(m_over, noy, nsy)
    nz = sel(m_over, noz, nsz)

    o1 = torch.stack([cax, cay, caz, cbx, cby, cbz, t_out, valid], dim=0)
    return _contact(o1, (nx, ny, nz))


def _check(ga8, gb8):
    if ga8.dim() != 2 or ga8.shape[0] != 8:
        raise ValueError(f"ga8 must be (8, P), got {tuple(ga8.shape)}")
    if gb8.shape != ga8.shape:
        raise ValueError(f"gb8 must be {tuple(ga8.shape)}, "
                         f"got {tuple(gb8.shape)}")
    for name, t in (("ga8", ga8), ("gb8", gb8)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if gb8.device != ga8.device:
        raise ValueError(f"gb8 is on {gb8.device}, ga8 on {ga8.device}")


def _lib():
    fn = _build.load("sphere_contact").mgf_sphere_contact
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sphere_contact_pairs(ga8, gb8) -> Contact:
    """Contact for P sphere pairs from component-major (8, P) blocks
    (side a receives, side b is the argument, as in
    ``contact_moving_moving``).  Any P works: the kernel masks the ragged
    edge.  CUDA tensors launch the kernel; CPU tensors run
    :func:`sphere_contact_pairs_reference`."""
    _check(ga8, gb8)
    if ga8.device.type == "cpu":
        return sphere_contact_pairs_reference(ga8, gb8)
    if ga8.device.type != "cuda":
        raise ValueError(f"sphere_contact_pairs runs on cuda or cpu, not "
                         f"{ga8.device}")
    fn = _lib()
    o1 = torch.empty_like(ga8)
    o2 = ga8.new_empty((3, ga8.shape[1]))
    stream = torch.cuda.current_stream(ga8.device).cuda_stream
    err = fn(ga8.data_ptr(), gb8.data_ptr(), o1.data_ptr(), o2.data_ptr(),
             ga8.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"sphere_contact kernel launch failed: "
                           f"cudaError {err}")
    launches.count(__name__, "LAUNCHES")
    return _contact(o1, o2)
