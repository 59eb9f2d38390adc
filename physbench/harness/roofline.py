"""The table of peaks and the work of kernels K1 (the hand-written rows
solver sweep) and K5 (the sphere step's "near" terrain stage), frozen from
``chip_smoke.py``'s ``bound`` / ``sweep_bound`` / ``k5_bound``.

The least time for a kernel's work is the larger of its bytes (each input
read once, each output written once) over the H100 SXM's 3.35 TB/s and its
float32 operations over the 67 TFLOP/s outside the tensor cores (NVIDIA's
data sheet, at the 700 W limit).  K1's operations per unit of work were
counted from ``solver_sweep.cu``, K5's from ``sphere_terrain.cu``.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K1_OPS_PER_ROW_SWEEP = 83     # dv, friction, normal, impulse, sums
K1_OPS_PER_COL_SWEEP = 12     # the velocity update
K1_OPS_PER_GATHER_ROW = 12    # gather mode: vb + wb x rb, once per call
# K5, an FMA as two: a body's sweep length and reach 15, the cull 18 a
# face (three axes of two subtractions, a max, a clamp, a multiply and an
# add), a candidate 444 (the plane test 44, the containment test 22, three
# edge sweeps of 111, the manifold and basis 45)
K5_OPS_PER_BODY, K5_OPS_PER_FACE, K5_OPS_PER_CAND = 15, 18, 444


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds for ``n_bytes`` and ``n_ops`` of work."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def k1_work(R: int, N: int, inner: int, K: int):
    """(bytes, float32 operations) of one K1 launch in gather mode: R rows
    of N bodies, ``inner`` sweeps, the K leading rows gathering their
    partner's state (an (8, N) state in and out, 18 fields, the
    accumulators in and out, the partner index and contact point)."""
    gather = K * N
    n_bytes = 4 * ((8 + 2 + 8) * N + (18 + 3 + 3) * R * N + 4 * gather)
    n_ops = (inner * (K1_OPS_PER_ROW_SWEEP * R * N
                      + K1_OPS_PER_COL_SWEEP * N)
             + K1_OPS_PER_GATHER_ROW * gather)
    return n_bytes, n_ops


def k1_bound_s(R: int, N: int, inner: int, K: int) -> float:
    return bound_s(*k1_work(R, N, inner, K))


def k5_work(n_bodies: int, n_faces: int, cand: int, with_deepest: bool):
    """(bytes, float32 operations) of one K5 launch: a body's 8 floats in
    (centre, sweep, radius, half height), a candidate's 16 floats, valid
    byte and face id out, on full steps the body's deepest penetration
    out, and the mesh (9 floats a face and its centre) read once."""
    n_bytes = (4 * 8 * n_bodies + (16 * 4 + 1 + 4) * cand * n_bodies
               + 4 * n_bodies * int(bool(with_deepest))
               + 4 * (9 * n_faces + 3))
    n_ops = n_bodies * (K5_OPS_PER_BODY + K5_OPS_PER_FACE * n_faces
                        + K5_OPS_PER_CAND * cand)
    return n_bytes, n_ops


def k5_bound_s(n_bodies: int, n_faces: int, cand: int,
               with_deepest: bool) -> float:
    return bound_s(*k5_work(n_bodies, n_faces, cand, with_deepest))
