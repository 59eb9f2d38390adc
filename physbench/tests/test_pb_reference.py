"""The plain reference's contact routines on hand-built cases with
closed-form answers."""

import pytest
import torch

from physbench.reference import capsules as C
from physbench.reference import geometry as G
from physbench.reference.mixed import prune

T = lambda *v: torch.tensor([v], dtype=torch.float64)
S = lambda v: torch.tensor([v], dtype=torch.float64)
approx = lambda t, v: pytest.approx(t.squeeze().tolist(), abs=1e-12) == v


def test_sphere_sweeps_into_sphere_at_half_the_frame():
    # centres 2 apart, radii 0.5: they touch when 1 apart, half way
    a, b, n, t, ok = G.sphere_moving_sphere(
        T(0, 0, 0), S(0.5), T(2, 0, 0), S(0.5), T(-2, 0, 0))
    assert bool(ok) and float(t) == pytest.approx(0.5)
    assert approx(n, [1.0, 0.0, 0.0]) and approx(a, [0.5, 0.0, 0.0])


def test_overlapping_spheres_touch_now_with_their_depth():
    a, b, n, t, ok = G.sphere_moving_sphere(
        T(0, 0, 0), S(0.5), T(0.8, 0, 0), S(0.5), T(0, 0, 0))
    assert bool(ok) and float(t) == 0.0
    assert float(-G.dot(b - a, n)) == pytest.approx(0.2)


def test_separating_spheres_miss():
    *_, ok = G.sphere_moving_sphere(
        T(0, 0, 0), S(0.5), T(2, 0, 0), S(0.5), T(1, 0, 0))
    assert not bool(ok)


FLOOR = (T(-10, 0, -10), T(-10, 0, 10), T(10, 0, -10))


def test_sphere_falls_onto_a_floor_triangle():
    a, b, n, t, ok = G.triangle_moving_sphere(
        *FLOOR, T(-1, 1.0, -1), S(0.5), T(0, -1, 0))
    assert bool(ok) and float(t) == pytest.approx(0.5)
    assert abs(float(n[0, 1])) == pytest.approx(1.0)
    assert approx(a, [-1.0, 0.0, -1.0])


def test_sphere_resting_in_a_floor_triangle():
    a, b, n, t, ok = G.triangle_moving_sphere(
        *FLOOR, T(-1, 0.4, -1), S(0.5), T(0, 0, 0))
    assert bool(ok) and float(t) == 0.0
    assert float(G.norm(a - b)) == pytest.approx(0.1)


def test_sphere_falls_onto_a_capsule():
    a, b, n, t, ok = C.contact_capsule_moving_sphere_np(
        T(-1, 0, 0), T(2, 0, 0), S(0.5), T(0, 2, 0), S(0.5), T(0, -2, 0))
    assert bool(ok) and float(t) == pytest.approx(0.5)
    assert approx(n, [0.0, 1.0, 0.0]) and approx(a, [0.0, 0.5, 0.0])


def test_parallel_capsules_touch_at_both_ends_of_their_overlap():
    # two capsules along x, 0.9 apart (radii 0.5): the "ends" manifold
    # keeps the overlap interval's two ends, x = -1 and x = 1
    s0, s1 = C.contact_capsule_moving_capsule_np(
        T(-1, 0, 0), T(2, 0, 0), S(0.5), T(-1, 0.9, 0), T(2, 0, 0), S(0.5),
        T(0, 0, 0), ends=True)
    assert bool(s0[4]) and bool(s1[4])
    assert float(s0[3]) == 0.0 and float(s1[3]) == 0.0
    assert sorted([float(s0[0][0, 0]), float(s1[0][0, 0])]) == \
        pytest.approx([-1.0, 1.0])
    assert approx(s0[2], [0.0, 1.0, 0.0])


def test_crossed_capsules_touch_at_one_point():
    s0 = C.contact_capsule_moving_capsule_np(
        T(-1, 0, 0), T(2, 0, 0), S(0.5), T(0, 0.9, -1), T(0, 0, 2), S(0.5),
        T(0, 0, 0))
    assert bool(s0[4]) and approx(s0[0], [0.0, 0.5, 0.0])


def test_capsule_lying_on_a_floor_touches_at_both_ends():
    s0, s1 = C.contact_triangle_moving_capsule_np(
        *FLOOR, T(-4, 0.45, -4), T(2, 0, 0), S(0.5), T(0, 0, 0))
    assert bool(s0[4]) and bool(s1[4])
    assert sorted([float(s0[0][0, 0]), float(s1[0][0, 0])]) == \
        pytest.approx([-4.0, -2.0])


def test_tangent_basis_is_orthonormal():
    n = G.normalize(torch.randn(64, 3, dtype=torch.float64))
    t1, t2 = G.compute_basis(n)
    for u, v in ((n, t1), (n, t2), (t1, t2)):
        assert torch.allclose(G.dot(u, v), torch.zeros(64,
                                                       dtype=torch.float64),
                              atol=1e-12)
    assert torch.allclose(G.norm(t1, keepdim=False),
                          torch.ones(64, dtype=torch.float64))


def _slot(x, t=0.0):
    p = T(*x)
    return dict(a=p, b=p, n=T(0, 1, 0), t=S(t), valid=torch.tensor([True]),
                la=p, lb=p)


def test_manifold_merges_near_points_and_keeps_far_ones():
    near = prune([_slot((1, 0, 0)), _slot((1.001, 0, 0))], 2, 1e-4)
    far = prune([_slot((1, 0, 0)), _slot((-1, 0, 0))], 2, 1e-4)
    assert int(near["valid"].sum()) == 1
    assert int(far["valid"].sum()) == 2
    # an earlier contact restarts the manifold
    first = prune([_slot((1, 0, 0), 0.5), _slot((-1, 0, 0), 0.1)], 2, 1e-4)
    assert int(first["valid"].sum()) == 1 and float(first["time"]) == 0.1


def test_the_cell_table_drops_the_bodies_past_a_full_bucket():
    from physbench.reference.step import in_table
    cfg = dict(grid_dims=[8, 8, 8], grid_cell=2.0, bucket_cap=3)
    # five bodies in cell (0, 0, 0), two in cell (1, 0, 0), one in a cell
    # that wraps onto (0, 0, 0) at dims 8
    c = torch.tensor([[0.1, 0.1, 0.1]] * 5 + [[2.5, 0.5, 0.5]] * 2
                     + [[16.5, 0.5, 0.5]], dtype=torch.float32)
    kept, dropped = in_table(c, cfg)
    assert dropped == 3
    assert kept.tolist() == [True] * 3 + [False] * 2 + [True] * 2 + [False]
