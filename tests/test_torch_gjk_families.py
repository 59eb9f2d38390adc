"""The port's GJK/EPA against one ``jax.jit`` of mgf_tpu's per support
family, for the families tests/test_torch_gjk.py does not hold: capsule x
OBB (512 pairs, the capsule's cylinder-style support) and ConvexMesh x OBB
(256 pairs of an icosahedron, the linear-scan support).

The same calls as there (``gjk`` from +y, ``epa`` with the saturation
mask, ``separation`` from +x) on the same pairs in both packages.  A pair
is clear when its f64 oracle puts it 2e-3 or more from touching: for the
icosahedron a SAT over its 20 face normals, the box's 3 and the 90 edge
cross products (exact for convex polyhedra); for the capsule the minimum
over unit directions of the Minkowski difference's support value (20,000
directions on a Fibonacci sphere, then a shrinking local search), with the
reference's capsule support: a cylinder of half-length |d|/2 + r and
radius r, which is what GJK sees (geom.rs:1056-1072).

* ConvexMesh x OBB is polyhedral, like OBB x OBB: the bars of
  test_torch_gjk.py's ``EXACT`` (measured: no flip, closest 1.3e-6,
  distance 1.2e-7, depth 4.8e-7, normal 3.6e-7 rad).
* The capsule's round side makes GJK converge linearly and leaves its
  stopping iteration, EPA's last iterations and, on a few pairs near a
  degenerate simplex, GJK's enclosure test to float32 rounding (XLA's
  fused CPU code against torch's kernels; mgf_tpu's own answer on such a
  pair changes under 1-ulp nudges of its input).  So at most 1 % of the
  clear pairs may flip a flag, the closest point, distance and EPA depth
  agree within 1e-2 and the normal within 0.05 rad (measured: 1 pair's
  ``separated`` and 3 saturation flags flipped, closest 5.0e-3, distance
  6.4e-3, depth 5.5e-3, normal 0.037 rad), and against the oracle the port
  makes at most 1 % more decision errors than mgf_tpu (measured: 1 against
  0 of 509 clear pairs; distances within 0.0104 against 0.0067).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mgf_tpu import mesh as j_mesh  # noqa: E402

from mgf_tpu_torch import mesh as t_mesh  # noqa: E402

from test_torch_gjk import (  # noqa: E402
    EXACT, MARGIN, _jax_run, _np_obbs, _obb, _port_run, _quat_rot,
    check_parity, obb_support_of,
)

N_CAP = 512
N_CM = 256
SMOOTH = dict(flips=N_CAP // 100, closest=1e-2, dist=1e-2, depth=1e-2,
              normal=0.05)


def _icosahedron(scale=0.6):
    g = (1 + 5 ** 0.5) / 2
    v = []
    for a in (-1, 1):
        for b in (-g, g):
            v += [(0, a, b), (a, b, 0), (b, 0, a)]
    v = np.asarray(v, np.float64) * scale
    d = np.linalg.norm(v[:, None] - v[None], axis=-1)
    edge = np.min(d[d > 0])
    near = np.abs(d - edge) < 1e-9
    edges = [(i, j) for i in range(12) for j in range(i + 1, 12) if near[i, j]]
    faces = [(i, j, k) for i, j in edges for k in range(j + 1, 12)
             if near[i, k] and near[j, k]]
    return v, edges, faces


def _sat_poly_obb(verts, edges, faces, x, c, R, e):
    """SAT depth of a convex polyhedron (``verts`` + x) against an OBB,
    f64: positive = penetration depth, negative = a lower bound on the
    distance."""
    p = verts + x
    axes = [np.cross(p[j] - p[i], p[k] - p[i]) for i, j, k in faces]
    axes += [R[:, k] for k in range(3)]
    axes += [np.cross(p[j] - p[i], R[:, k]) for i, j in edges
             for k in range(3)]
    depth = np.inf
    for ax in axes:
        nrm = np.linalg.norm(ax)
        if nrm < 1e-12:
            continue
        ax = ax / nrm
        pa = p @ ax
        rb = np.sum(e * np.abs(R.T @ ax))
        cb = c @ ax
        depth = min(depth, pa.max() - (cb - rb), (cb + rb) - pa.min())
    return depth


def _fibonacci_dirs(k):
    i = np.arange(k) + 0.5
    z = 1.0 - 2.0 * i / k
    phi = np.pi * (1.0 + 5 ** 0.5) * i
    rxy = np.sqrt(1.0 - z * z)
    return np.stack([rxy * np.cos(phi), rxy * np.sin(phi), z], -1)


def _min_support_gap(h, n, k=20_000, rounds=6, probes=64, seed=0):
    """min over unit directions u of h(u), the support function of the
    Minkowski difference A - B (``h(dirs (n, m, 3)) -> (n, m)``), in f64:
    positive = penetration depth, negative = minus the distance.  A
    Fibonacci sphere of ``k`` directions, then ``rounds`` of ``probes``
    random directions around each pair's best, the radius shrinking 8x a
    round (a smooth h is within ~1e-9 of its minimum after that)."""
    rng = np.random.default_rng(seed)
    dirs = np.broadcast_to(_fibonacci_dirs(k), (n, k, 3))
    vals = h(dirs)
    best = dirs[np.arange(n), np.argmin(vals, 1)]
    val = vals.min(1)
    rad = 2.0 / np.sqrt(k)
    for _ in range(rounds):
        cand = best[:, None, :] + rad * rng.standard_normal((n, probes, 3))
        cand /= np.linalg.norm(cand, axis=-1, keepdims=True)
        cv = h(cand)
        k_best = np.argmin(cv, 1)
        take = cv[np.arange(n), k_best] < val
        best = np.where(take[:, None], cand[np.arange(n), k_best], best)
        val = np.where(take, cv[np.arange(n), k_best], val)
        rad /= 8.0
    return val


def _h_obb(c, R, e, dirs):
    """Support value of OBBs at ``-dirs`` (the B side of A - B)."""
    return (-np.einsum("nk,nmk->nm", c, dirs)
            + np.sum(e[:, None, :] * np.abs(np.einsum("nki,nmk->nmi", R,
                                                      dirs)), -1))


def _h_capsule(a, d, r, dirs):
    """Support value of the reference's capsule support (geom.rs:1056-1072:
    a cylinder of half-length |d|/2 + r and radius r about the capsule's
    axis)."""
    center = a + 0.5 * d
    h = np.linalg.norm(d, axis=-1)
    u = d / h[:, None]
    ud = np.einsum("nk,nmk->nm", u, dirs)
    return (np.einsum("nk,nmk->nm", center, dirs)
            + (0.5 * h + r)[:, None] * np.abs(ud)
            + r[:, None] * np.sqrt(np.maximum(1.0 - ud * ud, 0.0)))


@pytest.fixture(scope="module")
def capsule_case():
    rng = np.random.default_rng(13)
    cb, qb, eb = _np_obbs(rng, N_CAP, 1.0)
    ca = rng.uniform(-1.5, 1.5, (N_CAP, 3))
    da = rng.standard_normal((N_CAP, 3))
    da *= rng.uniform(0.2, 1.5, (N_CAP, 1)) / np.linalg.norm(
        da, axis=1, keepdims=True)
    ra = rng.uniform(0.2, 0.8, N_CAP)
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)

    def make_cap(geom, m3, arr):
        f = lambda a: arr(np.ascontiguousarray(a, np.float32))
        cap = geom.Capsule(a=m3.Vec3(*(f(ca[:, k]) for k in range(3))),
                           d=m3.Vec3(*(f(da[:, k]) for k in range(3))),
                           r=f(ra))
        return lambda d: geom.support_capsule(cap, d)
    make_obb = lambda g, m, arr: obb_support_of(g, _obb(g, m, arr, cb, qb,
                                                          eb))
    R = _quat_rot(f32(qb))
    true = -_min_support_gap(
        lambda u: (_h_capsule(f32(ca), f32(da), f32(ra), u)
                   + _h_obb(f32(cb), R, f32(eb), u)), N_CAP)
    return dict(true=true, port=_port_run(make_cap, make_obb, N_CAP),
                jax=_jax_run(make_cap, make_obb, N_CAP))


def test_capsule_obb_decisions_vs_oracle(capsule_case):
    """The port decides as well as mgf_tpu does against the oracle (GJK's
    48 iterations on a round side can stop short), and its distances are
    as close."""
    true = capsule_case["true"]
    clear = np.abs(true) > MARGIN
    assert clear.sum() > 0.9 * N_CAP
    sep = clear & (true > 0)
    errors = lambda o: int(np.sum((o["separated"] != (true > 0)) & clear)
                           + np.sum((o["enclosed"] != (true < 0)) & clear))
    dist_err = lambda o: float(np.max(np.abs(o["dist"] - true)[
        sep & o["separated"]]))
    port, ref = capsule_case["port"], capsule_case["jax"]
    assert errors(port) <= errors(ref) + N_CAP // 100
    assert max(dist_err(port), dist_err(ref)) <= 2e-2


def test_capsule_obb_parity_with_jax(capsule_case):
    clear = np.abs(capsule_case["true"]) > MARGIN
    check_parity(capsule_case["jax"], capsule_case["port"], clear,
                 np.ones(N_CAP, bool), SMOOTH)


@pytest.fixture(scope="module")
def convex_mesh_case():
    rng = np.random.default_rng(17)
    cb, qb, eb = _np_obbs(rng, N_CM, 1.0)
    xs = rng.uniform(-1.2, 1.2, (N_CM, 3))
    verts, edges, faces = _icosahedron()

    def make_cm(geom, m3, arr):
        if arr is torch.as_tensor:
            cm = t_mesh.convex_mesh_from_points(verts, x=xs, device="cpu")
            return lambda d: t_mesh.support_convex_mesh(cm, d)
        cm = j_mesh.convex_mesh_from_points(verts, x=xs)
        return lambda d: j_mesh.support_convex_mesh(cm, d)
    make_obb = lambda g, m, arr: obb_support_of(g, _obb(g, m, arr, cb, qb,
                                                          eb))
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)
    vf, xf, cf, ef = f32(verts), f32(xs), f32(cb), f32(eb)
    R = _quat_rot(f32(qb))
    depth = np.asarray([_sat_poly_obb(vf, edges, faces, xf[i], cf[i], R[i],
                                      ef[i]) for i in range(N_CM)])
    return dict(depth=depth, n_faces=len(faces), n_edges=len(edges),
                port=_port_run(make_cm, make_obb, N_CM),
                jax=_jax_run(make_cm, make_obb, N_CM))


def test_convex_mesh_obb_vs_sat(convex_mesh_case):
    assert (convex_mesh_case["n_faces"], convex_mesh_case["n_edges"]) == (
        20, 30)
    depth, port = convex_mesh_case["depth"], convex_mesh_case["port"]
    clear = np.abs(depth) > MARGIN
    np.testing.assert_array_equal(port["valid"][clear], depth[clear] > 0)
    pen = clear & (depth > 0)
    assert np.max(np.abs(-(np.sum((port["b"] - port["a"]) * port["n"], -1))
                         - depth)[pen]) <= 0.02


def test_convex_mesh_obb_parity_with_jax(convex_mesh_case):
    clear = np.abs(convex_mesh_case["depth"]) > MARGIN
    check_parity(convex_mesh_case["jax"], convex_mesh_case["port"], clear,
                 np.ones(N_CM, bool), EXACT)
