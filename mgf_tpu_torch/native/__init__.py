"""ctypes bindings for the native host runtime (``csrc/mgf_host.cpp``).

The port's counterpart of ``mgf_tpu/native``.  The C++ source belongs to
neither package; this module compiles it, at first use, with

    g++ -O3 -shared -fPIC -o <lib> csrc/mgf_host.cpp

into ``build/mgf_tpu_torch/`` at the repository root, in a file named after
a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads the existing library.  A missing ``g++`` or a failed
build raises: nothing falls back.  Each function has a plain numpy version
beside it (``*_reference``), for the tests and for a caller that asks for
it by name.

Provided:
* :func:`morton_order` — spatial sort permutation for bodies,
* :func:`build_cell_table` — host-side static mesh face grid build,
* :func:`weld_vertices` — mesh vertex dedup,
* :func:`solve_contacts_f64` — the f64 sequential Gauss-Seidel solve, the
  inner loop of the parity oracle (``mgf_tpu_torch.oracle``),
* :class:`AabbTree` — median-split AABB tree over triangles with overlap
  queries (the host-side bvh.rs equivalent for tooling).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "csrc" / "mgf_host.cpp"
_BUILD_DIR = _ROOT / "build" / "mgf_tpu_torch"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"libmgf_host-{digest[:16]}.so"


def _build(so: Path):
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the native host runtime "
                           "of mgf_tpu_torch cannot be built")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, str(_SRC), "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed building {_SRC.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)   # atomic


def load() -> ctypes.CDLL:
    """Build the library if it is missing, then load it (once per
    process)."""
    global _lib
    if _lib is not None:
        return _lib
    so = _library_path()
    if not so.exists():
        _build(so)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        # a library built on another machine (a copied checkout): rebuild
        # it here once
        _build(so)
        lib = ctypes.CDLL(str(so))
    i64 = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.morton_order.argtypes = [f32p, i64, i32p]
    lib.morton_order.restype = None
    lib.build_cell_table.argtypes = [f32p, i64, i32p, i64, ctypes.c_float,
                                     ctypes.c_int32, ctypes.c_int32, i32p]
    lib.build_cell_table.restype = i64
    lib.weld_vertices.argtypes = [f32p, i64, ctypes.c_float, i32p, f32p]
    lib.weld_vertices.restype = i64
    lib.aabb_tree_build.argtypes = [f32p, i64, i32p, i64, f32p, i32p, i32p]
    lib.aabb_tree_build.restype = i64
    lib.aabb_tree_query.argtypes = [f32p, i32p, i32p, i64, f32p, f32p, i32p,
                                    i64]
    lib.aabb_tree_query.restype = i64
    lib.solve_contacts_f64.argtypes = [
        f64p, f64p, f64p, f64p, i64,          # v omega inv_mass inv_moment M
        i32p, i32p,                           # body_a body_b
        f64p, f64p, f64p, f64p, f64p,         # ra rb normal t1 t2
        f64p, f64p, f64p, f64p, f64p,         # friction bias nm tm1 tm2
        i64, ctypes.c_int32, ctypes.c_int32]  # C iters mgf_friction
    lib.solve_contacts_f64.restype = None
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the library is built or ``g++`` is there to build it (no
    build is attempted)."""
    return (_lib is not None or _library_path().exists()
            or shutil.which("g++") is not None)


def morton_order(pos) -> np.ndarray:
    """Permutation sorting positions (n, 3) by 30-bit morton code."""
    pos = np.ascontiguousarray(pos, np.float32)
    out = np.empty(pos.shape[0], np.int32)
    load().morton_order(pos, pos.shape[0], out)
    return out


def morton_order_reference(pos) -> np.ndarray:
    """The plain numpy version of :func:`morton_order`."""
    pos = np.ascontiguousarray(pos, np.float32)
    lo = pos.min(0)
    rng = np.maximum(pos.max(0) - lo, 1e-9)
    q = np.clip(((pos - lo) / rng * 1023.0), 0, 1023).astype(np.uint32)

    def expand(v):
        v = (v * 0x00010001) & 0xFF0000FF
        v = (v * 0x00000101) & 0x0F00F00F
        v = (v * 0x00000011) & 0xC30C30C3
        v = (v * 0x00000005) & 0x49249249
        return v
    code = (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) | expand(q[:, 2])
    return np.argsort(code, kind="stable").astype(np.int32)


def build_cell_table(verts, faces, cell_size: float, dim: int, cap: int):
    """(dim^3, cap) int32 face table (+ overflow count), host-built."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    table = np.full((dim ** 3, cap), -1, np.int32)
    overflow = load().build_cell_table(verts, verts.shape[0], faces,
                                       faces.shape[0], cell_size, dim, cap,
                                       table)
    return table, int(overflow)


def build_cell_table_reference(verts, faces, cell_size: float, dim: int,
                               cap: int):
    """The plain numpy version of :func:`build_cell_table`."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    table = np.full((dim ** 3, cap), -1, np.int32)
    cent = verts[faces].mean(axis=1)
    cc = np.floor(cent / cell_size).astype(np.int64) & (dim - 1)
    bucket = (cc[:, 0] * dim + cc[:, 1]) * dim + cc[:, 2]
    overflow = 0
    fill = {}
    for f, b in enumerate(bucket):
        k = fill.get(b, 0)
        if k < cap:
            table[b, k] = f
            fill[b] = k + 1
        else:
            overflow += 1
    return table, overflow


def weld_vertices(verts, tol: float = 1e-6):
    """Dedup a vertex soup; returns (new_verts, remap old->new)."""
    verts = np.ascontiguousarray(verts, np.float32)
    n = verts.shape[0]
    remap = np.empty(n, np.int32)
    out = np.empty_like(verts)
    count = load().weld_vertices(verts, n, tol, remap, out)
    return out[:count].copy(), remap


def weld_vertices_reference(verts, tol: float = 1e-6):
    """The plain numpy version of :func:`weld_vertices` (the same welded
    set; its vertex order is the keys' sorted order)."""
    verts = np.ascontiguousarray(verts, np.float32)
    key = np.round(verts / max(tol, 1e-12)).astype(np.int64)
    _, first, remap = np.unique(key, axis=0, return_index=True,
                                return_inverse=True)
    # remap indexes np.unique's KEY-SORTED order, so the welded verts are
    # emitted in that same order
    return verts[first], remap.reshape(-1).astype(np.int32)


def _solve_args(v, omega, inv_mass, inv_moment, body_a, body_b, rows):
    f64 = lambda a: np.ascontiguousarray(a, np.float64)
    return (f64(v).copy(), f64(omega).copy(), f64(inv_mass),
            f64(inv_moment).reshape(-1, 9),
            np.ascontiguousarray(body_a, np.int32),
            np.ascontiguousarray(body_b, np.int32), [f64(a) for a in rows])


def solve_contacts_f64(v, omega, inv_mass, inv_moment, body_a, body_b,
                       ra, rb, normal, t1, t2, friction, bias, normal_mass,
                       tm1, tm2, iters: int, mgf_friction: bool):
    """Reference-exact sequential-impulse Gauss-Seidel sweeps in f64
    (solver.rs:203-253 semantics): constraints in insertion order, per
    contact a friction phase then a normal phase; with ``mgf_friction``
    the raw tangent lambdas (solver.rs:226-227), else the clamped
    accumulator.  ``v`` / ``omega`` are (M, 3); returns updated copies
    (v, omega)."""
    v, omega, im, I9, ia, ib, rows = _solve_args(
        v, omega, inv_mass, inv_moment, body_a, body_b,
        (ra, rb, normal, t1, t2, friction, bias, normal_mass, tm1, tm2))
    load().solve_contacts_f64(v, omega, im, I9, v.shape[0], ia, ib, *rows,
                              ia.shape[0], int(iters),
                              int(bool(mgf_friction)))
    return v, omega


def solve_contacts_f64_reference(v, omega, inv_mass, inv_moment, body_a,
                                 body_b, ra, rb, normal, t1, t2, friction,
                                 bias, normal_mass, tm1, tm2, iters: int,
                                 mgf_friction: bool):
    """The plain numpy version of :func:`solve_contacts_f64`, one contact at
    a time (slow; small systems only)."""
    v, omega, inv_mass, I9, body_a, body_b, rows = _solve_args(
        v, omega, inv_mass, inv_moment, body_a, body_b,
        (ra, rb, normal, t1, t2, friction, bias, normal_mass, tm1, tm2))
    ra, rb, normal, t1, t2, friction, bias, normal_mass, tm1, tm2 = rows
    C = body_a.shape[0]
    acc_n = np.zeros(C)
    acc_t1 = np.zeros(C)
    acc_t2 = np.zeros(C)
    I3 = I9.reshape(-1, 3, 3)
    for _ in range(int(iters)):
        for c in range(C):
            a, b = int(body_a[c]), int(body_b[c])

            def apply(direction, lam):
                imp = direction * lam
                v[a] -= imp * inv_mass[a]
                omega[a] -= I3[a] @ np.cross(ra[c], imp)
                v[b] += imp * inv_mass[b]
                omega[b] += I3[b] @ np.cross(rb[c], imp)

            def rel():
                return (v[b] + np.cross(omega[b], rb[c])
                        - v[a] - np.cross(omega[a], ra[c]))

            dv = rel()
            lam1 = -dv @ t1[c] * tm1[c]
            lam2 = -dv @ t2[c] * tm2[c]
            if mgf_friction:
                app1, app2 = lam1, lam2
                acc_t1[c] += lam1
                acc_t2[c] += lam2
            else:
                max_l = friction[c] * acc_n[c]
                n1 = np.clip(acc_t1[c] + lam1, -max_l, max_l)
                n2 = np.clip(acc_t2[c] + lam2, -max_l, max_l)
                app1, app2 = n1 - acc_t1[c], n2 - acc_t2[c]
                acc_t1[c], acc_t2[c] = n1, n2
            apply(t1[c], app1)
            apply(t2[c], app2)
            dv = rel()
            lam = normal_mass[c] * (-(dv @ normal[c]) + bias[c])
            new_acc = max(acc_n[c] + lam, 0.0)
            apply(normal[c], new_acc - acc_n[c])
            acc_n[c] = new_acc
    return v, omega


class AabbTree:
    """Host-side median-split AABB tree over triangles (bvh.rs tooling
    equivalent: build + overlap query)."""

    def __init__(self, verts, faces):
        verts = np.ascontiguousarray(verts, np.float32)
        faces = np.ascontiguousarray(faces, np.int32)
        t = faces.shape[0]
        n_nodes = max(2 * t - 1, 1)
        self.bounds = np.zeros((n_nodes, 6), np.float32)
        self.children = np.full((n_nodes, 2), -1, np.int32)
        self.leaf_face = np.full(n_nodes, -1, np.int32)
        self.n_nodes = 0
        if t > 0:
            self.n_nodes = int(load().aabb_tree_build(
                verts, verts.shape[0], faces, t, self.bounds,
                self.children, self.leaf_face))

    def query(self, center, radius, cap: int = 256) -> np.ndarray:
        """Face ids whose AABBs overlap the query box (center, radius)."""
        qc = np.ascontiguousarray(center, np.float32)
        qr = np.ascontiguousarray(radius, np.float32)
        out = np.empty(cap, np.int32)
        cnt = load().aabb_tree_query(self.bounds, self.children,
                                     self.leaf_face, self.n_nodes, qc, qr,
                                     out, cap)
        return out[:cnt].copy()


def aabb_query_reference(verts, faces, center, radius,
                         cap: int = 256) -> np.ndarray:
    """The plain numpy version of :meth:`AabbTree.query`: every face whose
    AABB overlaps the box, in face order (the tree returns the same set in
    its traversal order)."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    qc = np.ascontiguousarray(center, np.float32)
    qr = np.ascontiguousarray(radius, np.float32)
    tri = verts[faces]        # (t, 3, 3)
    lo = tri.min(1)
    hi = tri.max(1)
    hit = np.all((lo <= qc + qr) & (hi >= qc - qr), axis=1)
    return np.nonzero(hit)[0].astype(np.int32)[:cap]
