"""The port's GJK/EPA (mgf_tpu_torch.gjk) against mgf_tpu's and against
f64 oracles.

* tests/test_gjk.py's goldens (collision.rs:1646-1671, 1822-1843) and
  tests/test_gjk_property.py's suites replayed on the port: 1,024 random
  OBB pairs (seed 7) against a 15-axis SAT oracle (0 decision errors), 2,048
  sphere pairs against the analytic distance, and EPA's saturation flag;
* parity with one ``jax.jit`` of mgf_tpu's ``gjk`` + ``epa`` +
  ``separation`` per support family, on the same pairs: OBB x OBB (the SAT
  suite's 1,024) and sphere x sphere (the analytic suite's 2,048).
  tests/test_torch_gjk_families.py holds capsule x OBB and ConvexMesh x OBB.

The parity bars of the polyhedral families (``EXACT``), on every pair
clear of the 2e-3 margin (|SAT depth| > 2e-3): ``enclosed``, ``separated``,
``valid`` and the saturation mask equal; the GJK closest point within
5e-6, the separation distance within 1e-6, the EPA depth within 1e-5 and
the normal within 1e-5 rad where the SAT's two best axes differ by more
than 1e-2 (near-tied faces may rightly differ).  Measured on the OBB pairs:
closest 1.2e-7, distance 1.5e-7, depth 8.3e-7, normal 4.6e-7 rad.  The
witness points are not compared: on a box face EPA may pick either of two
coplanar triangles, whose barycentric witnesses differ.  The sphere pairs
are smooth, and their bars are in ``test_sphere_parity_with_jax``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mgf_tpu import geom as j_geom  # noqa: E402
from mgf_tpu import gjk as j_gjk  # noqa: E402
from mgf_tpu import math3d as j_m3  # noqa: E402

from mgf_tpu_torch import geom as t_geom  # noqa: E402
from mgf_tpu_torch import gjk as t_gjk  # noqa: E402
from mgf_tpu_torch import math3d as t_m3  # noqa: E402
from mgf_tpu_torch.geom import (  # noqa: E402
    OBB, Sphere, support_obb, support_sphere,
)
from mgf_tpu_torch.gjk import (  # noqa: E402
    contact_convex_convex, epa, gjk, minkowski_support, separation,
)
from mgf_tpu_torch.math3d import (  # noqa: E402
    Quat, Vec3, quat, quat_from_arc, vec3,
)

CPU = "cpu"
MARGIN = 2e-3          # SAT-marginal pairs are skipped (f32 boundary noise)
# the parity bars of the polyhedral families (module docstring)
EXACT = dict(flips=0, closest=5e-6, dist=1e-6, depth=1e-5, normal=1e-5)


def V(x, y, z):
    return vec3(x, y, z, device=CPU)


def F(x):
    return torch.tensor(float(x))


# ---------------------------------------------------------------------------
# tests/test_gjk.py on the port
# ---------------------------------------------------------------------------

def sphere_support(s):
    return lambda d: support_sphere(s, d)


def obb_support(o):
    return lambda d: support_obb(o, d)


def test_sphere_penetration():
    # collision.rs:1646-1671
    one = F(1.0)
    s1 = Sphere(c=V(0, 0, 0), r=F(1.0))
    s2 = Sphere(c=V(2, 0, 0), r=F(1.5))
    d, sep = separation(sphere_support(s1), sphere_support(s2), one)
    assert not bool(sep)  # overlapping -> None in the reference
    d, sep = separation(sphere_support(s2), sphere_support(s1), one)
    assert not bool(sep)
    s3 = Sphere(c=V(2, 0, 0), r=F(0.75))
    d, sep = separation(sphere_support(s1), sphere_support(s3), one)
    assert bool(sep)
    assert float(d) == pytest.approx(0.25, abs=1e-4)


def _ident():
    return quat(1.0, 0.0, 0.0, 0.0, device=CPU)


def test_obb_contacts():
    # collision.rs:1822-1843
    one = F(1.0)
    box1 = OBB(c=V(0, 0, 0), q=_ident(), r=V(1, 1, 1))
    box2 = OBB(c=V(0, 1, 0), q=_ident(), r=V(1, 1.5, 1))
    c = contact_convex_convex(obb_support(box1), obb_support(box2), one)
    assert bool(c.valid)
    assert float(c.a.y) == pytest.approx(1.0, abs=1e-3)
    assert float(c.b.y) == pytest.approx(-0.5, abs=1e-3)

    c = contact_convex_convex(obb_support(box2), obb_support(box1), one)
    assert bool(c.valid)
    assert float(c.b.y) == pytest.approx(1.0, abs=1e-3)
    assert float(c.a.y) == pytest.approx(-0.5, abs=1e-3)

    box3 = OBB(c=V(0, 4.1, 0), q=_ident(), r=V(1, 1.5, 1))
    c = contact_convex_convex(obb_support(box1), obb_support(box3), one)
    assert not bool(c.valid)

    box4 = OBB(c=V(0, 2.0, 0), q=quat_from_arc(V(1, 0, 0), V(0, 1, 0)),
               r=V(1.7, 1.5, 1))
    c = contact_convex_convex(obb_support(box1), obb_support(box4), one)
    assert bool(c.valid)
    assert float(c.a.y) == pytest.approx(1.0, abs=1e-3)
    assert float(c.b.y) == pytest.approx(0.3, abs=2e-3)


def test_gjk_batched():
    # a batch of sphere pairs, some separated, some penetrating
    n = 8
    cx = torch.linspace(1.0, 4.0, n)
    c1 = Vec3(torch.zeros(n), torch.zeros(n), torch.zeros(n))
    c2 = Vec3(cx, torch.zeros(n), torch.zeros(n))
    sup1 = lambda d: support_sphere(Sphere(c=c1, r=torch.ones(n)), d)
    sup2 = lambda d: support_sphere(Sphere(c=c2, r=torch.full((n,), 0.5)), d)
    dist, sep = separation(sup1, sup2, torch.ones(n))
    expected_gap = cx.numpy() - 1.5
    for i in range(n):
        if expected_gap[i] > 1e-3:
            assert bool(sep[i])
            assert float(dist[i]) == pytest.approx(expected_gap[i], abs=1e-3)
        else:
            assert not bool(sep[i])


# ---------------------------------------------------------------------------
# f64 oracles (as tests/test_gjk_property.py computes them)
# ---------------------------------------------------------------------------

def _quat_rot(q):
    """(…, 4) wxyz -> (…, 3, 3) rotation, f64."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _sat_obb(c1, R1, e1, c2, R2, e2):
    """15-axis SAT for two OBBs, f64.  Returns (overlap, depth, gap):
    depth = min over axes of (sum of projected extents - |projected center
    delta|), positive = penetration depth (exact for boxes), negative = a
    lower bound on the distance; gap = the second-smallest axis value minus
    the smallest (how clearly the MTD axis is decided)."""
    axes = [R1[:, k] for k in range(3)] + [R2[:, k] for k in range(3)]
    for i in range(3):
        for j in range(3):
            cr = np.cross(R1[:, i], R2[:, j])
            n = np.linalg.norm(cr)
            if n > 1e-12:
                axes.append(cr / n)
    d = c2 - c1
    pens = sorted(np.sum(e1 * np.abs(R1.T @ ax)) + np.sum(
        e2 * np.abs(R2.T @ ax)) - abs(d @ ax) for ax in axes)
    return pens[0] > 0.0, pens[0], pens[1] - pens[0]


def _rand_quats(rng, n):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _np_obbs(rng, n, spread):
    q = _rand_quats(rng, n)
    c = rng.uniform(-spread, spread, (n, 3))
    e = rng.uniform(0.4, 1.2, (n, 3))
    return c, q, e


def _obb(geom, m3, arr, c, q, e):
    f = lambda a: arr(np.ascontiguousarray(a, np.float32))
    return geom.OBB(c=m3.Vec3(*(f(c[:, k]) for k in range(3))),
                    q=m3.Quat(*(f(q[:, k]) for k in range(4))),
                    r=m3.Vec3(*(f(e[:, k]) for k in range(3))))


def _sphere(geom, m3, arr, c, r):
    f = lambda a: arr(np.ascontiguousarray(a, np.float32))
    return geom.Sphere(c=m3.Vec3(*(f(c[:, k]) for k in range(3))), r=f(r))


# ---------------------------------------------------------------------------
# one run of gjk + epa + separation, the same calls in both packages
# ---------------------------------------------------------------------------

def _run(gjk_mod, m3, support_a, support_b, ones):
    diff = gjk_mod.minkowski_support(support_a, support_b)
    res = gjk_mod.gjk(diff, m3.Vec3(ones * 0.0, ones, ones * 0.0))
    c, sat = gjk_mod.epa(diff, res, return_saturated=True)
    touching = m3.magnitude2(res.closest) <= m3.COLLISION_EPSILON
    dist, separated = gjk_mod.separation(support_a, support_b, ones)
    return dict(closest=res.closest, enclosed=res.enclosed, a=c.a, b=c.b,
                n=c.n, valid=c.valid & touching & res.enclosed, sat=sat,
                dist=dist, separated=separated)


def _numpy(out):
    vec = lambda v: np.stack([np.asarray(c) for c in v], -1)
    return {k: (vec(v) if isinstance(v, tuple) else np.asarray(v))
            for k, v in out.items()}


def _jax_run(make_a, make_b, n):
    """mgf_tpu's side, jitted once: ``make_*(geom, m3, arr)`` builds the
    shape and returns its support function."""
    def f():
        sa = make_a(j_geom, j_m3, jnp.asarray)
        sb = make_b(j_geom, j_m3, jnp.asarray)
        return _run(j_gjk, j_m3, sa, sb, jnp.ones(n, jnp.float32))
    return _numpy(jax.jit(f)())


def _port_run(make_a, make_b, n):
    sa = make_a(t_geom, t_m3, torch.as_tensor)
    sb = make_b(t_geom, t_m3, torch.as_tensor)
    return _numpy(_run(t_gjk, t_m3, sa, sb, torch.ones(n)))


def _depth(o):
    return np.sum((o["b"] - o["a"]) * o["n"], -1)


def _angle(n1, n2):
    n1, n2 = n1.astype(np.float64), n2.astype(np.float64)
    return np.arctan2(np.linalg.norm(np.cross(n1, n2), axis=-1),
                      np.sum(n1 * n2, -1))


def check_parity(want, got, clear, normal_ok, bars):
    """Hold the port against mgf_tpu on the ``clear`` pairs: ``enclosed``,
    ``separated``, ``valid`` and the saturation mask different on at most
    ``bars["flips"]`` of them each, the GJK closest point, the separation
    distance (where separated), the EPA depth and the normal (where both
    are valid and ``normal_ok``) within their bars.  Returns the measured
    worst differences."""
    worst = {k: int(np.sum((got[k] != want[k]) & clear))
             for k in ("enclosed", "separated", "valid", "sat")}
    worst["closest"] = float(np.max(np.abs(got["closest"] - want["closest"])
                                    [clear]))
    sep = clear & want["separated"]
    worst["dist"] = float(np.max(np.abs(got["dist"] - want["dist"])[sep],
                                 initial=0.0))
    pen = clear & want["valid"] & got["valid"]
    worst["depth"] = float(np.max(np.abs(_depth(got) - _depth(want))[pen],
                                  initial=0.0))
    worst["normal"] = float(np.max(_angle(got["n"], want["n"])[
        pen & normal_ok], initial=0.0))
    for k in ("enclosed", "separated", "valid", "sat"):
        assert worst[k] <= bars["flips"], (k, worst)
    for k in ("closest", "dist", "depth", "normal"):
        assert worst[k] <= bars[k], (k, worst)
    return worst


# ---------------------------------------------------------------------------
# OBB pairs: the SAT suite and parity
# ---------------------------------------------------------------------------

N_OBB = 1024


@pytest.fixture(scope="module")
def obb_case():
    rng = np.random.default_rng(7)
    ca, qa, ea = _np_obbs(rng, N_OBB, 0.8)
    cb, qb, eb = _np_obbs(rng, N_OBB, 0.8)
    sat = [_sat_obb(ca[i], _quat_rot(qa[i]), ea[i], cb[i], _quat_rot(qb[i]),
                    eb[i]) for i in range(N_OBB)]
    over, depth, gap = (np.asarray(x) for x in zip(*sat))
    make_a = lambda g, m, arr: obb_support_of(g, _obb(g, m, arr, ca, qa, ea))
    make_b = lambda g, m, arr: obb_support_of(g, _obb(g, m, arr, cb, qb, eb))
    return dict(over=over, depth=depth, gap=gap,
                port=_port_run(make_a, make_b, N_OBB),
                jax=_jax_run(make_a, make_b, N_OBB))


def obb_support_of(geom, o):
    return lambda d: geom.support_obb(o, d)


def test_obb_pairs_vs_sat_oracle(obb_case):
    # tests/test_gjk_property.py on the port
    port = obb_case["port"]
    depth_epa = _depth(port)
    n_checked = bad_decision = 0
    worst_depth = worst_dist = 0.0
    for i in range(N_OBB):
        over, depth = bool(obb_case["over"][i]), obb_case["depth"][i]
        if abs(depth) < MARGIN:
            continue
        n_checked += 1
        if over != bool(port["valid"][i]):
            bad_decision += 1
            continue
        if over:
            worst_depth = max(worst_depth, abs(abs(depth_epa[i]) - depth))
        else:
            assert port["separated"][i]
            worst_dist = max(worst_dist, max(0.0, -depth - port["dist"][i]))
    assert n_checked > 800
    assert bad_decision == 0, (bad_decision, n_checked)
    assert worst_depth <= 0.02, worst_depth
    assert worst_dist <= 0.01, worst_dist


def test_obb_parity_with_jax(obb_case):
    clear = np.abs(obb_case["depth"]) >= MARGIN
    check_parity(obb_case["jax"], obb_case["port"], clear,
                 obb_case["gap"] > 1e-2, EXACT)


# ---------------------------------------------------------------------------
# sphere pairs: the analytic suite and parity
# ---------------------------------------------------------------------------

N_SPH = 2048


@pytest.fixture(scope="module")
def sphere_case():
    rng = np.random.default_rng(11)
    c1 = rng.uniform(-2, 2, (N_SPH, 3))
    c2 = rng.uniform(-2, 2, (N_SPH, 3))
    r1 = rng.uniform(0.2, 1.0, N_SPH)
    r2 = rng.uniform(0.2, 1.0, N_SPH)
    sup = lambda c, r: (lambda g, m, arr: sphere_support_of(
        g, _sphere(g, m, arr, c, r)))
    return dict(true=np.linalg.norm(c2 - c1, axis=-1) - r1 - r2,
                port=_port_run(sup(c1, r1), sup(c2, r2), N_SPH),
                jax=_jax_run(sup(c1, r1), sup(c2, r2), N_SPH))


def sphere_support_of(geom, s):
    return lambda d: geom.support_sphere(s, d)


def test_sphere_pairs_vs_analytic(sphere_case):
    # tests/test_gjk_property.py on the port
    dist = sphere_case["port"]["dist"]
    separated = sphere_case["port"]["separated"]
    true = sphere_case["true"]
    clear = np.abs(true) > MARGIN
    np.testing.assert_array_equal(separated[clear], true[clear] > 0)
    sep = clear & (true > 0)
    # GJK on smooth surfaces converges linearly; measured err <= ~2e-3
    assert np.max(np.abs(dist[sep] - true[sep])) <= 1e-2


def test_sphere_parity_with_jax(sphere_case):
    """A smooth Minkowski sum: GJK converges linearly (the closest point
    slides along the surface until the gap test stops it) and EPA reaches
    growth < 1e-6 within its 32 iterations on only part of the penetrating
    pairs, so float32 rounding (XLA's fused CPU code against torch's
    kernels) decides which lanes converge and on which face.  The GJK
    decisions hold exactly; EPA is held to the analytic truth as well as
    mgf_tpu's own EPA gets there."""
    want, got = sphere_case["jax"], sphere_case["port"]
    true = sphere_case["true"]
    clear = np.abs(true) > MARGIN
    for k in ("enclosed", "separated"):
        np.testing.assert_array_equal(got[k][clear], want[k][clear], err_msg=k)
    sep = clear & want["separated"]
    assert np.max(np.abs(got["dist"] - want["dist"])[sep]) <= 1e-4
    assert np.max(np.abs(got["closest"] - want["closest"])[clear]) <= 1e-2
    pen = clear & (true < 0)
    for k in ("valid", "sat"):
        share = lambda o: np.mean(o[k][pen])
        assert abs(share(got) - share(want)) <= 0.01, (k, share(got),
                                                       share(want))
    err = lambda o: np.max(np.abs(_depth(o) - true)[pen & o["valid"]])
    assert err(got) <= err(want) + 1e-3, (err(got), err(want))


# ---------------------------------------------------------------------------
# EPA saturation (tests/test_gjk_property.py on the port)
# ---------------------------------------------------------------------------

def test_epa_saturation_flag():
    n = 4
    one = torch.ones(n)
    z = torch.zeros(n)
    a = OBB(c=Vec3(z, z, z), q=Quat(one, z, z, z), r=Vec3(one, one, one))
    b = OBB(c=Vec3(z + 0.3, z + 0.2, z + 0.1), q=Quat(one, z, z, z),
            r=Vec3(one, one, one))
    diff = minkowski_support(lambda d: support_obb(a, d),
                             lambda d: support_obb(b, d))
    res = gjk(diff, Vec3(z, one, z))

    def depth(c):
        return float(torch.abs((c.b.x - c.a.x) * c.n.x
                               + (c.b.y - c.a.y) * c.n.y
                               + (c.b.z - c.a.z) * c.n.z)[0])

    c, sat = epa(diff, res, return_saturated=True)
    assert not bool(sat.any())
    assert abs(depth(c) - 1.7) < 1e-3          # min overlap axis = x

    # a 5-slot table (the tetra seed alone is 4 faces) must saturate and
    # flag the degraded result
    c_s, sat_small = epa(diff, res, max_tris=5, return_saturated=True)
    assert bool(sat_small.any())
