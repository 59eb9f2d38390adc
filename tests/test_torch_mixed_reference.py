"""The port's mixed pile held against the benchmark's plain reference
(``physbench/reference``), as the benchmark's mixed cell holds it on the
card: ``stress_scene(2_000, mixed=True)`` pressed together (its layers
0.75 of their spacing apart, so that the first steps have sphere and
capsule contacts), one chunk of 16 steps through the benchmark's stepper
(``AdaptiveChunkStepper``, light interior metrics, the traffic's nonces),
and the reference following the same chunk from the same world with the
same nonces and solver schedule (``compare.chunk_numbers``, which also
checks ``compare.guarantees`` at the chunk's end).

Limits and their reasons (the readings on this pile, float32 program
against float32 reference, and the bfloat16 reference in the program's
place, which has to fail at least one of them):

* ``v_gap_median`` <= 1e-4 m/s: 16 steps of two rows-Jacobi blocks summed
  in another order read ~2e-6; bfloat16 ~0.6;
* ``v_gap_max`` <= 0.05 m/s: the body whose contacts are nearest a
  threshold reads ~4e-4; bfloat16 ~19;
* ``x_gap_max`` <= 1e-3 m: ~3e-5; bfloat16 ~0.9;
* ``contact_rows_mismatch`` <= 8 rows of ~48,000: 0; bfloat16 ~300;
* ``momentum_gap`` <= 1e-3 m/s: ~3e-6; bfloat16 ~0.4;
* ``step_count_gap`` exactly 0, and the configuration's guarantees at
  their stated limits (``physbench/configs/mixed_pile_100k.json``):
  bodies dropped by the cell table 0, pairs missing from a row with a
  free slot 0, penetration 0.5, escaped 0, non-finite values 0.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mgf_tpu_torch.math3d import Vec3  # noqa: E402
from mgf_tpu_torch.scenes import stress_scene  # noqa: E402
from physbench import run  # noqa: E402
from physbench.harness import compare, system  # noqa: E402
from physbench.harness.state import state_from_world  # noqa: E402

CPU = "cpu"
N_BODIES = 2000
C = 16
LIMITS = dict(v_gap_median=1e-4, v_gap_max=0.05, x_gap_max=1e-3,
              contact_rows_mismatch=8, momentum_gap=1e-3, step_count_gap=0,
              overflow_max=0, pairs_missed_free_row=0, penetration_max=0.5,
              escaped=0, nonfinite=0)


@pytest.fixture(scope="module")
def chunk():
    """(start state, the program's state after the chunk, engine, nonces,
    schedule) in the reference's layout."""
    world, cfg = stress_scene(N_BODIES, mixed=True, seed=2 ** 31 + 5,
                              device=CPU)
    b = world.bodies
    y0 = b.x.y.min()
    world = world._replace(bodies=b._replace(
        x=Vec3(b.x.x, y0 + 0.75 * (b.x.y - y0), b.x.z)))
    st = system.stepper(cfg, C)
    scales = run._nonces(C, 64, 1e-6, CPU)[0]
    s_in = state_from_world(world)
    world, m = st.step_chunk(world, scales)
    assert int(m["broadphase_overflow"].max()) == 0
    eng = compare.engine_of(dict(engine=system._plain(cfg)))
    return (s_in, state_from_world(world), eng, scales.tolist(),
            system.schedule_of(st))


@pytest.fixture(scope="module")
def followed(chunk):
    """The float32 reference's follow of the chunk."""
    s_in, _, eng, scales, sched = chunk
    return compare.follow(s_in, eng, scales, sched)


def _numbers(chunk, followed, s_out):
    """``compare.chunk_numbers`` for ``s_out`` after the chunk, with the
    reference's follow computed once for the module."""
    s_in, _, eng, scales, sched = chunk
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compare, "follow", lambda *a, **k: followed)
        return compare.chunk_numbers(s_in, s_out, eng, scales, sched)


@pytest.fixture(scope="module")
def numbers(chunk, followed):
    return _numbers(chunk, followed, chunk[1])


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_chunk_number_within_its_limit(numbers, name):
    assert numbers[name] <= LIMITS[name], (name, numbers[name])


def test_the_chunk_has_capsule_contacts(chunk):
    _, s_out, _, _, _ = chunk
    ns = int((s_out["shape_type"] == 0).sum())
    rows = s_out["warm"]["partner"] != -9
    assert int(rows[:, ns:].sum()) > 100 and int(rows[:, :ns].sum()) > 100


def test_bfloat16_follow_fails_a_limit(chunk, followed):
    s_in, _, eng, scales, sched = chunk
    control = compare.follow(s_in, eng, scales, sched, dtype=torch.bfloat16)
    got = _numbers(chunk, followed, control)
    failed = [k for k, lim in LIMITS.items() if got[k] > lim]
    assert {"v_gap_median", "contact_rows_mismatch",
            "momentum_gap"} <= set(failed), got


def test_near_cull_keeps_every_face_in_reach_at_walls_and_corners():
    """Both triangles of a box face share one bounding box, so a body at a
    wall's foot has four faces at the same cull distance and one in a
    corner six: the mixed pile's ``terrain_cand`` keeps every face within
    a body's reach there, the floor triangle under it among them (with 3,
    a body pressed into a wall's foot kept the wall's two triangles and
    the floor triangle of lower index, not always the one under it, and
    sank through the floor)."""
    from mgf_tpu_torch.ops.terrain import near_terrain
    world, cfg = stress_scene(400, mixed=True, device=CPU)
    t = world.terrain
    w = float(t.a.x.abs().max())
    d = w - 0.45                    # pressed 0.05 into the wall
    pos = torch.tensor([[d, 0.45, 10.0], [d, 0.45, -10.0], [-d, 0.45, 3.0],
                        [10.0, 0.45, d], [d, 0.45, d], [-d, 0.45, -d],
                        [d, 0.45, -d], [0.0, 0.45, 0.0]])
    x = Vec3(pos[:, 0], pos[:, 1], pos[:, 2])
    zero = torch.zeros(len(pos))
    r = torch.full((len(pos),), 0.5)
    half_h = torch.full((len(pos),), 0.25)
    ids, ok = near_terrain(t, x, Vec3(zero, zero, zero), r, half_h,
                           cfg.terrain_cand)
    lo = torch.stack([torch.minimum(torch.minimum(a, b), c) for a, b, c in
                      zip((t.a.x, t.a.y, t.a.z), (t.b.x, t.b.y, t.b.z),
                          (t.c.x, t.c.y, t.c.z))], -1)
    hi = torch.stack([torch.maximum(torch.maximum(a, b), c) for a, b, c in
                      zip((t.a.x, t.a.y, t.a.z), (t.b.x, t.b.y, t.b.z),
                          (t.c.x, t.c.y, t.c.z))], -1)
    gap = torch.clamp(torch.maximum(lo[None] - pos[:, None],
                                    pos[:, None] - hi[None]), min=0.0)
    reach = 0.5 + 0.25 + 0.1
    within = (gap * gap).sum(-1) <= reach * reach
    for b in range(len(pos)):
        kept = set(ids[b][ok[b]].tolist())
        want = set(torch.nonzero(within[b])[:, 0].tolist())
        assert want <= kept, (pos[b].tolist(), sorted(want), sorted(kept))
    # the corners have six faces in reach: the floor's two and two walls'
    assert int(within[4].sum()) == 6
