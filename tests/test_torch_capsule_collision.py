"""Parity of the port's capsule geometry and narrowphase
(mgf_tpu_torch.geom, .bounds, .collision) with mgf_tpu's, on the same numpy
inputs, plus port replays of the reference's golden capsule cases.

Both sides run eagerly on the CPU.  Tolerances:

* ``closest_pts_seg``: points atol 1e-6, the parallel flag exact, on a batch
  that holds exactly parallel, nearly parallel (1e-4 rad) and degenerate
  (zero-length) segments;
* ``capsule_aabb``: atol 1e-6;
* every contact function, on batches of >= 4,096 built from jittered copies
  of the golden scenarios (so that each case of each routine is taken) plus
  random poses: ``valid`` exact, n atol 1e-4, witnesses atol 1e-3, t atol
  1e-4 where the shapes approach along the normal faster than 0.01 per step
  and 1e-6 of travel along the normal elsewhere (t = gap / (n . v) divides
  rounding noise by a tiny n . v, as tests/test_torch_world.py holds it);
* golden replays: the tolerances of tests/test_collision.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mgf_tpu import bounds as jbounds  # noqa: E402
from mgf_tpu import collision as jcol  # noqa: E402
from mgf_tpu import geom as jgeom  # noqa: E402
from mgf_tpu.math3d import Vec3 as JVec3  # noqa: E402

from mgf_tpu_torch import bounds as tbounds  # noqa: E402
from mgf_tpu_torch import collision as tcol  # noqa: E402
from mgf_tpu_torch import geom as tgeom  # noqa: E402
from mgf_tpu_torch.math3d import Vec3 as TVec3  # noqa: E402


def _jv(a):
    return JVec3(*(jnp.asarray(a[..., k]) for k in range(3)))


def _tv(a):
    return TVec3(*(torch.as_tensor(np.ascontiguousarray(a[..., k]))
                   for k in range(3)))


def _ja(a):
    return jnp.asarray(a)


def _ta(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, tuple):
        return np.stack([_np(c) for c in x], axis=-1)
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _assert_contacts(cj, ct, v, min_valid):
    """valid exact; n 1e-4; witnesses 1e-3; t by approach speed."""
    vj, vt = _np(cj.valid), _np(ct.valid)
    np.testing.assert_array_equal(vj, vt)
    assert vj.sum() >= min_valid, vj.sum()
    nj, nt = _np(cj.n), _np(ct.n)
    np.testing.assert_allclose(nj[vj], nt[vj], atol=1e-4, rtol=0)
    for f in ("a", "b"):
        np.testing.assert_allclose(_np(getattr(cj, f))[vj],
                                   _np(getattr(ct, f))[vj], atol=1e-3,
                                   rtol=0, err_msg=f)
    app = np.abs(np.sum(nj * np.broadcast_to(v, nj.shape), axis=-1))[vj]
    dt = np.abs(_np(cj.t)[vj] - _np(ct.t)[vj])
    fast = app >= 1e-2
    assert (dt[fast] <= 1e-4).all(), dt[fast].max()
    assert (dt[~fast] * app[~fast] <= 1e-6).all()


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _segment_batch():
    """4,096 segment pairs: random, exactly parallel, nearly parallel
    (1e-4 rad), and degenerate (zero-length first, second, both)."""
    rng = np.random.default_rng(11)
    n = 4096
    a1, d1 = _f32(rng, n, 3, scale=2.0), _f32(rng, n, 3)
    a2, d2 = _f32(rng, n, 3, scale=2.0), _f32(rng, n, 3)
    kind = np.arange(n) % 8
    par = kind == 1                      # exactly parallel, random scale
    s = rng.choice([-2.0, -1.0, 0.5, 1.0, 3.0], n).astype(np.float32)
    d2[par] = d1[par] * s[par, None]
    ax = kind == 2                       # exactly parallel, axis aligned
    d1[ax] = np.asarray([0.0, 1.0, 0.0], np.float32)
    d2[ax] = np.asarray([0.0, 2.0, 0.0], np.float32)
    a2[ax] = a1[ax] + np.asarray([1.0, 0.5, 0.0], np.float32)
    near = kind == 3                     # 1e-4 rad off parallel
    perp = np.cross(d1[near], _f32(rng, int(near.sum()), 3))
    perp /= np.linalg.norm(perp, axis=-1, keepdims=True)
    ln = np.linalg.norm(d1[near], axis=-1, keepdims=True)
    d2[near] = (d1[near] + 1e-4 * ln * perp).astype(np.float32)
    d1[kind == 4] = 0.0                  # first segment a point
    d2[kind == 5] = 0.0                  # second segment a point
    both = kind == 6
    d1[both] = 0.0
    d2[both] = 0.0
    return a1, d1, a2, d2, kind


def test_closest_pts_seg_matches_jax():
    a1, d1, a2, d2, kind = _segment_batch()
    pj = jgeom.closest_pts_seg(jgeom.Segment(a=_jv(a1), b=_jv(a1 + d1)),
                               jgeom.Segment(a=_jv(a2), b=_jv(a2 + d2)))
    pt = tgeom.closest_pts_seg(tgeom.Segment(a=_tv(a1), b=_tv(a1 + d1)),
                               tgeom.Segment(a=_tv(a2), b=_tv(a2 + d2)))
    np.testing.assert_array_equal(_np(pj[2]), _np(pt[2]))
    np.testing.assert_allclose(_np(pj[0]), _np(pt[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(pj[1]), _np(pt[1]), atol=1e-6, rtol=0)
    flag = _np(pt[2])
    # the relative test: exactly and nearly parallel pairs are parallel,
    # degenerate ones never, random ones (almost) never
    assert flag[kind == 2].all() and flag[kind == 3].all()
    assert flag[kind == 1].mean() > 0.99
    assert not flag[(kind >= 4) & (kind <= 6)].any()
    assert flag[(kind == 0) | (kind == 7)].mean() < 0.01


def test_closest_pt_capsule_and_aabb_match_jax():
    rng = np.random.default_rng(12)
    n = 4096
    a, d, to = _f32(rng, n, 3, scale=2.0), _f32(rng, n, 3), _f32(rng, n, 3,
                                                                  scale=3.0)
    d[::7] = 0.0
    r = rng.uniform(0.2, 1.5, n).astype(np.float32)
    cj = jgeom.Capsule(a=_jv(a), d=_jv(d), r=_ja(r))
    ct = tgeom.Capsule(a=_tv(a), d=_tv(d), r=_ta(r))
    np.testing.assert_allclose(_np(jgeom.closest_pt_capsule(cj, _jv(to))),
                               _np(tgeom.closest_pt_capsule(ct, _tv(to))),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(jgeom.capsule_center(cj)),
                               _np(tgeom.capsule_center(ct)), atol=0, rtol=0)
    bj, bt = jbounds.capsule_aabb(cj), tbounds.capsule_aabb(ct)
    np.testing.assert_allclose(_np(bj.c), _np(bt.c), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(bj.r), _np(bt.r), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# capsule x sphere, capsule x capsule: random + structured batches
# ---------------------------------------------------------------------------

def _capsule_pairs(seed):
    """8,192 capsule pairs with relative sweeps: random poses, exactly
    parallel flanks (overlapping and swept, shifted along the axis so the
    interval is partial, full or past an end), colinear end caps, sweeps
    along the first axis (the parallel first sub-segment), zero sweeps and
    coincident axes."""
    rng = np.random.default_rng(seed)
    n = 8192
    a1, d1 = _f32(rng, n, 3), _f32(rng, n, 3)
    a2, d2 = _f32(rng, n, 3, scale=1.5), _f32(rng, n, 3)
    v = _f32(rng, n, 3, scale=0.7)
    r1 = rng.uniform(0.3, 1.0, n).astype(np.float32)
    r2 = rng.uniform(0.3, 1.0, n).astype(np.float32)
    kind = np.arange(n) % 8
    flank = (kind == 1) | (kind == 2) | (kind == 3)
    m = int(flank.sum())
    axis = np.eye(3, dtype=np.float32)[rng.integers(0, 3, m)]
    side = np.roll(axis, 1, axis=-1)
    ln = rng.choice([0.5, 1.0, 2.0], m).astype(np.float32)
    d1[flank] = axis * ln[:, None]
    d2[flank] = axis * (ln * rng.choice([-1.0, 0.5, 1.0, 2.0], m)
                        .astype(np.float32))[:, None]
    shift = rng.choice([-3.0, -1.5, -0.5, 0.0, 0.25, 0.75, 2.5],
                       m).astype(np.float32)
    gap = rng.uniform(0.2, 3.0, m).astype(np.float32)
    a2[flank] = a1[flank] + axis * shift[:, None] + side * gap[:, None]
    # kind 1: sweep toward the flank; 2: at rest; 3: sweep away / oblique
    v[kind == 1] = -side[(kind == 1)[flank]] * rng.uniform(
        0.1, 2.5, (int((kind == 1).sum()), 1)).astype(np.float32)
    v[kind == 2] = 0.0
    col = kind == 4                       # colinear end caps
    m = int(col.sum())
    axis = np.eye(3, dtype=np.float32)[rng.integers(0, 3, m)]
    d1[col] = axis
    d2[col] = axis * rng.choice([-1.0, 1.0], (m, 1)).astype(np.float32)
    a2[col] = a1[col] + axis * rng.choice([-4.0, -2.5, 2.5, 4.0],
                                          (m, 1)).astype(np.float32)
    v[col] = axis * rng.choice([-2.0, -0.5, 0.5, 2.0],
                               (m, 1)).astype(np.float32)
    along = kind == 5                     # sweep along the first axis
    v[along] = d1[along] * rng.uniform(-1.0, 1.0, (int(along.sum()), 1)
                                       ).astype(np.float32)
    same = kind == 6                      # coincident axes, some at rest
    a2[same] = a1[same]
    d2[same] = d1[same]
    v[same & (np.arange(n) % 16 == 6)] = 0.0
    return a1, d1, r1, a2, d2, r2, v


def _caps(a, d, r):
    return (jgeom.Capsule(a=_jv(a), d=_jv(d), r=_ja(r)),
            tgeom.Capsule(a=_tv(a), d=_tv(d), r=_ta(r)))


def test_capsule_sphere_contacts_match_jax():
    """Against mgf_tpu's routines compiled (``jax.jit``), as its step runs
    them: the port's ``intersect_capsule`` fuses each multiply-add as XLA
    does (see collision._fma)."""
    a1, d1, r1, a2, _, r2, v = _capsule_pairs(21)
    cj, ct = _caps(a1, d1, r1)
    sj = jgeom.Sphere(c=_jv(a2), r=_ja(r2))
    st = tgeom.Sphere(c=_tv(a2), r=_ta(r2))
    _assert_contacts(
        jax.jit(jcol.contact_capsule_moving_sphere)(cj, sj, _jv(v)),
        tcol.contact_capsule_moving_sphere(ct, st, _tv(v)), v, 2000)
    _assert_contacts(
        jax.jit(jcol.contact_sphere_moving_capsule)(sj, cj, _jv(v)),
        tcol.contact_sphere_moving_capsule(st, ct, _tv(v)), v, 2000)


@pytest.mark.parametrize("ends", [False, True])
def test_capsule_capsule_contacts_match_jax(ends):
    a1, d1, r1, a2, d2, r2, v = _capsule_pairs(22)
    c1j, c1t = _caps(a1, d1, r1)
    c2j, c2t = _caps(a2, d2, r2)
    oj = jcol.contact_capsule_moving_capsule(c1j, c2j, _jv(v), ends=ends)
    ot = tcol.contact_capsule_moving_capsule(c1t, c2t, _tv(v), ends=ends)
    _assert_contacts(oj, ot, v, 3000)
    valid = _np(ot.valid)
    t = _np(ot.t)
    if ends:
        assert valid.shape[0] == 2
        # the second endpoint of an extended flank interval is emitted
        assert valid[1].sum() > 200
        valid, t = valid[0], t[0]
    # overlaps (t = 0) and sweeps (0 < t <= 1) both occur
    assert (valid & (t == 0.0)).sum() > 500
    assert (valid & (t > 0.0)).sum() > 500


def test_plane_capsule_contacts_match_jax():
    rng = np.random.default_rng(23)
    n = 4096
    nrm = _f32(rng, n, 3)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pd = _f32(rng, n)
    a, d, v = _f32(rng, n, 3), _f32(rng, n, 3, scale=0.6), _f32(rng, n, 3)
    k = np.arange(n) % 4
    d[k == 1] = np.cross(nrm[k == 1], _f32(rng, int((k == 1).sum()), 3))
    r = rng.uniform(0.2, 0.8, n).astype(np.float32)
    cj, ct = _caps(a, d, r)
    oj = jcol.contact_plane_moving_capsule(
        jgeom.Plane(n=_jv(nrm), d=_ja(pd)), cj, _jv(v))
    ot = tcol.contact_plane_moving_capsule(
        tgeom.Plane(n=_tv(nrm), d=_ta(pd)), ct, _tv(v))
    _assert_contacts(oj, ot, v, 1500)


# ---------------------------------------------------------------------------
# triangle x capsule: jittered copies of the golden scenarios
# ---------------------------------------------------------------------------

_F1 = ((1, 1, 0), (0, 1, -1), (0, 1, 1))          # collision.rs:1762-1766
_F2 = ((1, 1, 0), (0, 1, 2), (0, 1, -2))
_BIG = ((-10, 0, -10), (-10, 0, 10), (10, 0, -10))

# (triangle, a, d, r, v, [(valid, t, a_point, b_point)] per slot); None
# skips a field.  tests/test_collision.py:301-468, :540-580.
_TRI_GOLDENS = [
    ("clip_edge", _F1, (0.9, 3, 1), (0, 0, -2), 1.0, (0, -1, 0),
     [(True, 1.0, (0.9, 1, 0.1), None), (True, None, (0.9, 1, -0.1), None)]),
    ("clip_off_center", _F1, (0.9, 3, 0), (0, 0, 2), 1.0, (0, -1, 0),
     [(True, 1.0, (0.9, 1, 0), None), (True, None, (0.9, 1, 0.1), None)]),
    ("clip_off_center_rev", _F1, (0.9, 3, 0), (0, 0, -2), 1.0, (0, -1, 0),
     [(True, 1.0, (0.9, 1, 0), None), (True, None, (0.9, 1, -0.1), None)]),
    ("through_center", _F1, (0.9, 2, 0), (1, 0, 0), 1.0, (0, -1, 0),
     [(True, 0.0, (0.9, 1, 0), None), (True, None, (1.0, 1, 0), None)]),
    ("tilted_center", _F1, (0.5, 4, 0), (-1, -0.5, 0), 1.0, (0, -2, 0),
     [(True, 0.81598306, (0, 1, 0), None), (False, None, None, None)]),
    ("tilted_center_3d", _F1, (0.5, 4, 0), (-1, -1, 2), 1.0, (0, -2, 0),
     [(True, 0.7022774, (0, 1, 1), None)]),
    ("parallel_to_edge", _F1, (-1, 2, 2), (0, 0, -2), 1.0, (0, -1, 0),
     [(True, 1.0, (0, 1, 1), None), (True, None, (0, 1, 0), None)]),
    ("parallel_to_edge_tilted", _F1, (-1, 4, 2), (0, -2, -2), 1.0,
     (0, -1, 0),
     [(True, 1.0, (0, 1, 0), None), (False, None, None, None)]),
    ("parallel_to_edge_miss", _F1, (-1, 4, 0), (0, 2, -2), 1.0, (0, -1, 0),
     [(False, None, None, None), (False, None, None, None)]),
    ("longer_than_edge", _F1, (-1, 2, 2), (0, 0, -4), 1.0, (0, -1, 0),
     [(True, 1.0, (0, 1, 1), None), (True, None, (0, 1, -1), None)]),
    ("longer_than_edge_rev", _F1, (-1, 2, -2), (0, 0, 4), 1.0, (0, -1, 0),
     [(True, 1.0, (0, 1, -1), None), (True, None, (0, 1, 1), None)]),
    ("parallel_contained", _F2, (-0.5, 2, 0.5), (0, 0, -1), 0.5, (0, -1, 0),
     [(True, 1.0, (0, 1, 0.5), None), (True, None, (0, 1, -0.5), None)]),
    ("perp_to_edge", _F2, (-1, 2, 0), (-3, 0, 0), 1.0, (0, -1, 0),
     [(True, 1.0, (0, 1, 0), None), (False, None, None, None)]),
    ("perp_to_edge_rev", _F2, (-4, 2, 0), (3, 0, 0), 1.0, (0, -1, 0),
     [(True, 1.0, (0, 1, 0), None), (False, None, None, None)]),
    ("next_to_vert", _F2, (2, 2, 1), (0, 0, -2), 1.0, (0, -1, 0),
     [(True, 1.0, (1, 1, 0), None), (False, None, None, None)]),
    ("next_to_vert_tilted", _F2, (2, 2, 1), (0, -1, -2), 1.0, (0, -1, 0),
     [(True, 0.5, (1, 1, 0), None), (False, None, None, None)]),
    ("intersects_plane", _F2, (0, 4, 0), (-2, -4, 0), 1.0, (0, -1, 0),
     [(True, 0.7639319, (0, 1, 0), None), (False, None, None, None)]),
    ("intersects_plane_touch", _F2, (-1, 2, 0), (-1, -2, 0), 1.0,
     (0, -1, 0),
     [(True, 1.0, (0, 1, 0), None), (False, None, None, None)]),
    # the pierce test on the actual segment parameter (short capsules)
    ("short_hover_no_pierce", _BIG, (0.0, 1.12, 0.0), (0, -0.5, 0), 0.5,
     (0, 0, 0),
     [(False, None, None, None), (False, None, None, None)]),
    ("short_pierce", _BIG, (0.5, 0.2, -3.0), (0, -0.5, 0), 0.5, (0, 0, 0),
     [(True, 0.0, (0.5, 0.0, -3.0), (0.5, -0.8, -3.0)),
      (False, None, None, None)]),
    # both endpoint spheres rest on the face: the double resting contact
    ("double_rest", _BIG, (-3.0, 0.4, -3.0), (1.0, 0, 0), 0.5, (0, 0, 0),
     [(True, 0.0, None, None), (True, 0.0, None, None)]),
]


def _vec1(p, dtype=np.float32):
    return np.asarray([p], dtype)


def _t_tri(tri):
    return tgeom.Triangle(*(_tv(_vec1(p)) for p in tri))


@pytest.mark.parametrize("case", _TRI_GOLDENS, ids=[c[0] for c in
                                                    _TRI_GOLDENS])
def test_tri_capsule_golden_port(case):
    """The reference's triangle x capsule scenario suite, replayed on the
    port alone."""
    _, tri, a, d, r, v, want = case
    cap = tgeom.Capsule(a=_tv(_vec1(a)), d=_tv(_vec1(d)),
                        r=_ta(np.asarray([r], np.float32)))
    out = tcol.contact_triangle_moving_capsule(_t_tri(tri), cap,
                                               _tv(_vec1(v)))
    assert out.valid.shape == (2, 1)
    for s, (valid, t, pa, pb) in enumerate(want):
        assert bool(out.valid[s, 0]) == valid, (s, out.valid)
        if t is not None:
            assert float(out.t[s, 0]) == pytest.approx(t, abs=1e-4)
        if pa is not None:
            np.testing.assert_allclose(_np(out.a)[s, 0], pa, atol=1e-4)
        if pb is not None:
            np.testing.assert_allclose(_np(out.b)[s, 0], pb, atol=1e-4)


def _tri_capsule_batch():
    """Every golden scenario jittered 256 times (capsule start, axis, radius
    and sweep moved by up to 0.04; half of the copies keep the exact axis,
    so exactly parallel edges and silhouettes stay in the batch), plus
    random poses over a large floor triangle."""
    rng = np.random.default_rng(31)
    reps = 256
    tri, a, d, r, v = [], [], [], [], []
    for _, t_, a_, d_, r_, v_, _w in _TRI_GOLDENS:
        tri.append(np.broadcast_to(np.asarray(t_, np.float32), (reps, 3, 3)))
        jit = lambda p: (np.asarray(p, np.float32)[None]
                         + rng.uniform(-0.04, 0.04, (reps, 3))
                         .astype(np.float32))
        a.append(jit(a_))
        dd = jit(d_)
        dd[::2] = np.asarray(d_, np.float32)
        d.append(dd)
        r.append((r_ + rng.uniform(-0.04, 0.04, reps)).astype(np.float32))
        vv = jit(v_)
        vv[::4] = np.asarray(v_, np.float32)
        v.append(vv)
    m = 2048
    tri.append(np.broadcast_to(np.asarray(_BIG, np.float32), (m, 3, 3)))
    pos = _f32(rng, m, 3, scale=4.0)
    pos[:, 1] = rng.uniform(-0.3, 2.0, m)
    a.append(pos)
    d.append(_f32(rng, m, 3, scale=0.5))
    r.append(rng.uniform(0.3, 0.6, m).astype(np.float32))
    vv = _f32(rng, m, 3, scale=0.5)
    vv[::5] = 0.0
    v.append(vv)
    cat = lambda xs: np.ascontiguousarray(np.concatenate(xs, axis=0))
    return cat(tri), cat(a), cat(d), cat(r), cat(v)


def test_triangle_capsule_contacts_match_jax():
    """Against the compiled mgf_tpu routine, as
    test_capsule_sphere_contacts_match_jax."""
    tri, a, d, r, v = _tri_capsule_batch()
    assert a.shape[0] >= 4096
    tj = jgeom.Triangle(*(_jv(tri[:, k]) for k in range(3)))
    tt = tgeom.Triangle(*(_tv(tri[:, k]) for k in range(3)))
    cj, ct = _caps(a, d, r)
    oj = jax.jit(jcol.contact_triangle_moving_capsule)(tj, cj, _jv(v))
    ot = tcol.contact_triangle_moving_capsule(tt, ct, _tv(v))
    _assert_contacts(oj, ot, v, 3000)
    valid, t = _np(ot.valid), _np(ot.t)
    # one- and two-contact results, resting (t = 0) and swept, all occur
    assert (valid[0] & valid[1]).sum() > 500
    assert (valid[0] & ~valid[1]).sum() > 500
    assert (valid[0] & (t[0] == 0.0)).sum() > 300
    assert (valid[0] & (t[0] > 0.0)).sum() > 1000


# ---------------------------------------------------------------------------
# golden replays: capsule x sphere, capsule x capsule, the "ends" extension
# ---------------------------------------------------------------------------

_CC_GOLDENS = [
    # (c1 a, d, r), (c2 a, d, r), v, t, a, b    tests/test_collision.py:224
    ("side_sweep", ((4, 3, 5.5), (0, 1, 0), 2.0), ((0, 3, 5.5), (0, 1, 0),
                                                    1.0),
     (1, 0, 0), 1.0, (2, 3.5, 5.5), (2, 3.5, 5.5)),
    ("side_sweep_radii", ((4, 3, 5.5), (0, 1, 0), 1.0),
     ((0, 3, 5.5), (0, 1, 0), 2.0), (1, 0, 0), 1.0, (3, 3.5, 5.5),
     (3, 3.5, 5.5)),
    ("colinear_ends", ((1, 0, 0), (1, 0, 0), 1.0), ((-2, 0, 0), (-1, 0, 0),
                                                    1.0),
     (2, 0, 0), 0.5, (0, 0, 0), (0, 0, 0)),
    ("colinear_overlap", ((0, 0, 0), (1, 0, 0), 1.0), ((0, 0, 0), (-1, 0, 0),
                                                       1.0),
     (2, 0, 0), 0.0, (-1, 0, 0), (1, 0, 0)),
    ("offset_parallel", ((4, 3, 5.5), (0, 1, 0), 2.0), ((0, 2, 5.5),
                                                        (0, 1, 0), 1.0),
     (1, 0, 0), 1.0, (2, 3, 5.5), (2, 3, 5.5)),
    ("half_offset_parallel", ((4, 3, 5.5), (0, 1, 0), 2.0),
     ((0, 2.5, 5.5), (0, 1, 0), 1.0), (1, 0, 0), 1.0, (2, 3.25, 5.5),
     (2, 3.25, 5.5)),
]


def _t_cap(spec):
    a, d, r = spec
    return tgeom.Capsule(a=_tv(_vec1(a)), d=_tv(_vec1(d)),
                         r=_ta(np.asarray([r], np.float32)))


@pytest.mark.parametrize("case", _CC_GOLDENS, ids=[c[0] for c in
                                                   _CC_GOLDENS])
def test_capsule_capsule_golden_port(case):
    _, c1, c2, v, t, pa, pb = case
    out = tcol.contact_capsule_moving_capsule(_t_cap(c1), _t_cap(c2),
                                              _tv(_vec1(v)))
    assert bool(out.valid[0])
    assert float(out.t[0]) == pytest.approx(t)
    np.testing.assert_allclose(_np(out.a)[0], pa, atol=1e-5)
    np.testing.assert_allclose(_np(out.b)[0], pb, atol=1e-5)


def test_capsule_sphere_golden_port():
    """tests/test_collision.py:200, both directions."""
    cap = _t_cap(((4, 3, 5.5), (0, 1, 0), 2.0))
    s = tgeom.Sphere(c=_tv(_vec1((0, 3, 5.5))),
                     r=_ta(np.asarray([1.0], np.float32)))
    v = _tv(_vec1((1, 0, 0)))
    c = tcol.contact_capsule_moving_sphere(cap, s, v)
    assert bool(c.valid[0]) and float(c.t[0]) == pytest.approx(1.0)
    np.testing.assert_allclose(_np(c.a)[0], (2, 3, 5.5), atol=1e-5)
    np.testing.assert_allclose(_np(c.b)[0], (2, 3, 5.5), atol=1e-5)
    c = tcol.contact_sphere_moving_capsule(s, cap, -v)
    c = tcol.contact_advect(c, v * c.t)
    assert bool(c.valid[0]) and float(c.t[0]) == pytest.approx(1.0)
    np.testing.assert_allclose(_np(c.a)[0], (2, 3, 5.5), atol=1e-5)
    np.testing.assert_allclose(_np(c.b)[0], (2, 3, 5.5), atol=1e-5)


def test_capsule_capsule_ends_extension_port():
    """tests/test_collision.py:495: the parallel flank case emits the
    overlap interval's two endpoints instead of the single midpoint."""
    c1 = _t_cap(((-1.0, 0.0, 0.0), (2.0, 0.0, 0.0), 0.5))
    c2 = _t_cap(((-0.5, 0.9, 0.0), (2.0, 0.0, 0.0), 0.5))
    v = _tv(_vec1((0.0, -0.1, 0.0)))
    cm = tcol.contact_capsule_moving_capsule(c1, c2, v)
    assert bool(cm.valid[0])
    # overlap interval on c1 is t in [0.25, 1.0] -> midpoint x = 0.25
    assert float(cm.a.x[0]) == pytest.approx(0.25, abs=1e-5)
    ce = tcol.contact_capsule_moving_capsule(c1, c2, v, ends=True)
    assert ce.valid.shape[0] == 2
    assert bool(ce.valid[0, 0]) and bool(ce.valid[1, 0])
    assert float(ce.a.x[0, 0]) == pytest.approx(-0.5, abs=1e-5)
    assert float(ce.a.x[1, 0]) == pytest.approx(1.0, abs=1e-5)
    for s in range(2):
        assert float(ce.n.y[s, 0]) == pytest.approx(1.0, abs=1e-5)
        assert float(ce.a.y[s, 0]) == pytest.approx(0.5, abs=1e-5)
        assert float(ce.b.y[s, 0]) == pytest.approx(0.4, abs=1e-5)
    # non-parallel axes: slot 1 stays invalid
    c3 = _t_cap(((-0.5, 0.9, -1.0), (0.0, 0.0, 2.0), 0.5))
    cx = tcol.contact_capsule_moving_capsule(c1, c3, v, ends=True)
    assert bool(cx.valid[0, 0]) and not bool(cx.valid[1, 0])


# ---------------------------------------------------------------------------
# the plane x capsule pierce test on short capsules, in BOTH packages
# ---------------------------------------------------------------------------

_PLANE_CASES = [
    # (a, d, r, v) -> (valid, t, a.y, b.y); the plane is y = 0
    # a short (|d| = 0.5) near-vertical capsule hovering 0.12 above the
    # plane at rest: the segment does not cross, the bottom sphere is clear
    ("hover", (0.0, 1.12, 0.0), (0.0, -0.5, 0.0), 0.5, (0, 0, 0),
     (False, None, None, None)),
    # the same capsule sinking 0.2 per step touches at t = 0.6
    ("hover_sinking", (0.0, 1.12, 0.0), (0.0, -0.5, 0.0), 0.5, (0, -0.2, 0),
     (True, 0.6, 0.0, 0.0)),
    # the bottom sphere overlaps the plane, the segment stays above it
    ("rest", (0.0, 0.9, 0.0), (0.0, -0.5, 0.0), 0.5, (0, 0, 0),
     (True, 0.0, 0.0, -0.1)),
    # the segment crosses the plane at its own parameter 0.4: one t = 0
    # contact at the crossing, witness below the deep end
    ("pierce", (0.5, 0.2, -3.0), (0.0, -0.5, 0.0), 0.5, (0, 0, 0),
     (True, 0.0, 0.0, -0.8)),
    # |d| = 2: the crossing at parameter 0.25 (0.5 along the unit axis)
    ("pierce_long", (0.0, 0.5, 0.0), (0.0, -2.0, 0.0), 0.5, (0, 0, 0),
     (True, 0.0, 0.0, -2.0)),
    # a short capsule wholly below the plane is no pierce
    ("below", (0.0, -0.7, 0.0), (0.0, -0.5, 0.0), 0.5, (0, 0, 0),
     (False, None, None, None)),
]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("case", _PLANE_CASES, ids=[c[0] for c in
                                                    _PLANE_CASES])
def test_plane_short_capsule_hover_pierce(case, pkg):
    """contact_plane_moving_capsule classifies the pierce by the capsule's
    own segment parameter, so a short (|d| != 1) capsule that hovers clear
    of the plane makes no contact; held against both packages."""
    _, a, d, r, v, (valid, t, ay, by) = case
    if pkg == "jax":
        out = jcol.contact_plane_moving_capsule(
            jgeom.Plane(n=_jv(_vec1((0, 1, 0))), d=_ja(np.zeros(1,
                                                               np.float32))),
            jgeom.Capsule(a=_jv(_vec1(a)), d=_jv(_vec1(d)),
                          r=_ja(np.asarray([r], np.float32))),
            _jv(_vec1(v)))
    else:
        out = tcol.contact_plane_moving_capsule(
            tgeom.Plane(n=_tv(_vec1((0, 1, 0))), d=_ta(np.zeros(1,
                                                               np.float32))),
            _t_cap((a, d, r)), _tv(_vec1(v)))
    assert bool(_np(out.valid)[0]) == valid
    if valid:
        assert float(_np(out.t)[0]) == pytest.approx(t, abs=1e-5)
        assert float(_np(out.a.y)[0]) == pytest.approx(ay, abs=1e-5)
        assert float(_np(out.b.y)[0]) == pytest.approx(by, abs=1e-5)
