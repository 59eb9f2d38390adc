"""Kernel K5 (``mgf_tpu_torch/ops/csrc/sphere_terrain.cu``): the sphere
step's "near" terrain stage in one pass per body, against its plain
PyTorch version (``ops.terrain.sphere_terrain_near_reference``) on the
same CUDA tensors, and inside the step's CUDA graphs.  Runs only where
CUDA is available (the ``cuda_device`` fixture skips without a card,
decided at run time); imports no JAX, so that it runs on the machine with
the card: ``python3 -m pytest --noconftest -q -s
tests/test_torch_terrain_kernel.py`` (``-s`` prints the lanes that
differ).

Tolerances: the face ids and ``valid`` exactly; every float within 1e-6
or 4 ulp.  Both versions round each operation once in float32 in the same
order; where the plain version fuses a multiply-add (``collision._fma``)
it sums in float64 and rounds twice, the kernel's ``__fmaf_rn`` once, so
a few lanes may differ in the last bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mgf_tpu_torch import tracing  # noqa: E402
from mgf_tpu_torch import world as W  # noqa: E402
from mgf_tpu_torch.driver import (  # noqa: E402
    AdaptiveChunkStepper, make_chunk_step,
)
from mgf_tpu_torch.math3d import Vec3  # noqa: E402
from mgf_tpu_torch.ops import terrain  # noqa: E402
from mgf_tpu_torch.scenes import stress_scene  # noqa: E402

pytestmark = pytest.mark.cuda

ATOL = 1e-6
ULPS = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _ulps(a, b):
    """Distance in float32 steps (ordered integers of the bit patterns)."""
    ia, ib = (t.contiguous().view(torch.int32).to(torch.int64)
              for t in (a, b))
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


def _assert_close(name, a, b):
    """``a`` and ``b`` equal within ATOL or ULPS (NaN where both are);
    returns the lanes that differ at all."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    near = ((a - b).abs() <= ATOL) | (_ulps(a, b) <= ULPS)
    bad = ~(same | near)
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} lanes off, e.g. {a[bad][:4].tolist()} "
        f"against {b[bad][:4].tolist()}")
    return int((~same).sum())


def _fields(man):
    return {"time": man.time, **{f"{k}.{c}": getattr(getattr(man, k), c)
                                 for k in ("normal", "t1", "t2", "local_a",
                                           "local_b") for c in "xyz"}}


def _compare(state_or_bodies, world, cand, stable, with_deepest):
    """K5 against the plain version on the same tensors; returns the lanes
    that differ at all, by field."""
    x, delta, r, hh = state_or_bodies
    args = (x, delta, r, hh, world.terrain, world.terrain_center, cand,
            stable, with_deepest)
    before = terrain.LAUNCHES
    mk, tk, dk = terrain.sphere_terrain_near(*args)
    assert terrain.LAUNCHES == before + 1
    mp, tp, dp = terrain.sphere_terrain_near_reference(*args)
    torch.cuda.synchronize()
    assert tk.dtype == torch.int32 and tk.shape == tp.shape
    assert torch.equal(tk, tp)
    assert torch.equal(mk.valid, mp.valid)
    diff = {k: _assert_close(k, a, b) for (k, a), b in zip(
        _fields(mk).items(), _fields(mp).values())}
    if with_deepest:
        diff["deepest"] = _assert_close("deepest", dk.reshape(1),
                                        dp.reshape(1))
    else:
        assert dk is None and dp is None
    return diff, int(mp.valid.sum())


def _box_features(world):
    """The stress box's faces (vertex triples), edges and corners."""
    t = world.terrain
    tri = np.stack([np.stack([c.cpu().numpy() for c in v], -1)
                    for v in (t.a, t.b, t.c)], 1)        # (T, 3, 3)
    edges = {tuple(sorted((tuple(p), tuple(q))))
             for f in tri for p, q in ((f[0], f[1]), (f[1], f[2]),
                                        (f[2], f[0]))}
    corners = {tuple(p) for f in tri for p in f}
    return (tri, np.asarray(sorted(edges), np.float32),
            np.asarray(sorted(corners), np.float32))


def _random_bodies(world, n, seed, dev):
    """Spheres on and near every face, edge and corner of the box, resting
    (zero sweep) and swept across the features; some far out of reach."""
    rng = np.random.default_rng(seed)
    tri, edges, corners = _box_features(world)
    kind = rng.integers(0, 4, n)
    bary = rng.dirichlet((1.0, 1.0, 1.0), n).astype(np.float32)
    on_face = np.einsum("nk,nkc->nc", bary, tri[rng.integers(0, len(tri),
                                                             n)])
    e = edges[rng.integers(0, len(edges), n)]
    s = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    on_edge = e[:, 0] + (e[:, 1] - e[:, 0]) * s
    on_corner = corners[rng.integers(0, len(corners), n)]
    far = rng.uniform(-5.0, 5.0, (n, 3)).astype(np.float32) + \
        np.asarray([0.0, 20.0, 0.0], np.float32)
    base = np.select([kind[:, None] == k for k in range(4)],
                     [on_face, on_edge, on_corner, far])
    off = rng.standard_normal((n, 3)).astype(np.float32)
    off *= rng.uniform(-0.8, 0.8, (n, 1)).astype(np.float32) / \
        np.linalg.norm(off, axis=1, keepdims=True)
    x = base + off
    sweep = rng.standard_normal((n, 3)).astype(np.float32)
    mag = rng.choice([0.0, 1e-3, 0.1, 0.5, 1.2], n).astype(np.float32)
    delta = sweep / np.linalg.norm(sweep, axis=1, keepdims=True) * \
        mag[:, None]
    # half of the movers head at the feature they sit by
    back = rng.uniform(size=n) < 0.5
    to_base = base - x
    norm = np.maximum(np.linalg.norm(to_base, axis=1, keepdims=True), 1e-6)
    delta[back] = (to_base / norm * mag[:, None] * 2.0)[back]
    r = rng.choice([0.5, 0.5, 0.3, 0.7], n).astype(np.float32)
    vec = lambda a: Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, k]),
                                           device=dev) for k in range(3)))
    return (vec(x), vec(delta), torch.as_tensor(r, device=dev),
            torch.zeros((n,), dtype=torch.float32, device=dev))


@pytest.mark.parametrize("cand", [3, 1, 8])
@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("with_deepest", [True, False])
def test_kernel_matches_plain_near_box_features(cuda_device, cand, stable,
                                                with_deepest):
    world, _ = stress_scene(2000, device=cuda_device)
    bodies = _random_bodies(world, 200_000, seed=cand + 10 * stable,
                            dev=cuda_device)
    diff, n_valid = _compare(bodies, world, cand, stable, with_deepest)
    print(f"cand {cand} stable {stable} deepest {with_deepest}: "
          f"{n_valid} valid slots of {cand * 200_000}; lanes that differ: "
          f"{ {k: v for k, v in diff.items() if v} }")
    assert n_valid > 10_000


def test_kernel_floor_tie_and_out_of_reach(cuda_device):
    """Both floor triangles share one AABB: a body resting on face 0
    keeps face 0 before face 1 (the lower id on a tie, sorted or not) and
    touches face 0 alone; a body out of every face's reach keeps no face
    and writes id 0."""
    world, _ = stress_scene(2000, device=cuda_device)
    t = lambda *v: torch.tensor(v, dtype=torch.float32, device=cuda_device)
    x = Vec3(t(-0.3, 1.0, 0.0), t(0.45, 20.0, 1e4), t(-0.2, 0.0, 0.0))
    delta = Vec3(t(0.0, 0.0, 0.0), t(-0.01, 0.0, 0.0), t(0.0, 0.0, 0.0))
    r = t(0.5, 0.5, 0.5)
    hh = t(0.0, 0.0, 0.0)
    for stable in (True, False):
        man, tris, _ = terrain.sphere_terrain_near(
            x, delta, r, hh, world.terrain, world.terrain_center, 3, stable)
        ref = terrain.sphere_terrain_near_reference(
            x, delta, r, hh, world.terrain, world.terrain_center, 3, stable)
        assert tris[:, 0].tolist() == [0, 1, 0]
        assert tris[:, 1:].tolist() == [[0, 0]] * 3
        assert man.valid[0, :, 0].tolist() == [True, False, False]
        assert not bool(man.valid[0, :, 1:].any())
        assert torch.equal(tris, ref[1])
        assert torch.equal(man.valid, ref[0].valid)


def test_kernel_matches_plain_on_settled_pile(cuda_device):
    """The flagship 100k pile after 640 steps (chunks of 64, replayed from
    the graphs): the stage on its next step's head, with and without the
    deepest penetration."""
    world, cfg = stress_scene(100_000, device=cuda_device)
    st = AdaptiveChunkStepper(cfg, chunk=64, light=True)
    for _ in range(10):
        world, _ = st.step_chunk(world)
    head = W.step_head(world, cfg)
    s = head.state
    for with_deepest in (True, False):
        diff, n_valid = _compare((s.x, s.delta, s.shape_r, s.shape_half_h),
                                 world, cfg.terrain_cand, cfg.stable_pairs,
                                 with_deepest)
        print(f"settled 100k, deepest {with_deepest}: {n_valid} valid "
              f"slots; lanes that differ: "
              f"{ {k: v for k, v in diff.items() if v} }")
        assert n_valid > 10_000


def _terrain_kernels(fn):
    """Kernels the profiler sees between each step's ``narrow`` and
    ``terrain`` stamps while ``fn`` runs a chunk with tracing on (the
    stamps come 3 a chunk and 12 a step: call_gap, chunk_in, then each
    step's step_gap, integrate, bounds, need_gap, pairs, narrow, terrain,
    ..., finish, then chunk_out)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted(
        (e.time_range.start, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False))
    at = [i for i, (_, name) in enumerate(kernels) if "stamp_kernel" in name]
    steps = (len(at) - 3) // 12
    assert len(at) == 3 + 12 * steps and steps > 0
    return [[name for _, name in kernels[at[2 + 12 * k + 5] + 1:
                                         at[2 + 12 * k + 6]]]
            for k in range(steps)]


def test_captured_chunk_launches_k5_once_a_step(cuda_device):
    """A chunk of 8 replayed from the step's graphs launches K5 once a
    step; with tracing on, a light step's ``terrain`` interval holds K5
    and three small operations; the positions and velocities after the
    chunk are the eagerly stepped chunk's."""
    world, cfg = stress_scene(8000, device=cuda_device)
    # the chunk driver's graphs take a fixed schedule (adapt_schedule
    # reads the host, graphs.capture_refusal)
    cfg = cfg._replace(adapt_schedule=None)
    C = 8
    ones = torch.ones((C,), device=cuda_device)
    eager = make_chunk_step(cfg, light=True, capture=False)
    chunk = make_chunk_step(cfg, light=True)
    for _ in range(3):                    # captures, then replays
        world, _ = chunk(world, ones)
    torch.cuda.synchronize()
    before = terrain.LAUNCHES
    w_graph, _ = chunk(world, ones)
    torch.cuda.synchronize()
    assert terrain.LAUNCHES - before == C
    assert chunk.captured.replays > 0
    w_eager, _ = eager(world, ones)
    torch.cuda.synchronize()
    for a, b in zip((*w_graph.bodies.x, *w_graph.bodies.v),
                    (*w_eager.bodies.x, *w_eager.bodies.v)):
        _assert_close("x, v after the chunk", a, b)

    tracing.disable()
    tracing.enable(cuda_device)
    try:
        traced = make_chunk_step(cfg, light=True)
        w = world
        for _ in range(2):
            w, _ = traced(w, ones)
        tracing.reset()
        per_step = _terrain_kernels(lambda: traced(w, ones))
        rec = tracing.record()
    finally:
        tracing.disable()
    print("kernels in the terrain interval a step:",
          [len(k) for k in per_step], sorted({n for k in per_step
                                               for n in k}))
    print("terrain ms a step:", tracing.summary(rec)["stages"]["terrain"])
    assert len(per_step) == C
    for names in per_step:
        assert sum("sphere_terrain_kernel" in n for n in names) == 1
    # a light step: the zeros of max_pen and t_reach_excess, the mesh's cat
    # and K5; the chunk's last, full step adds the pair contacts' and K5's
    # deepest reductions
    for names in per_step[:-1]:
        assert len(names) <= 4, names
