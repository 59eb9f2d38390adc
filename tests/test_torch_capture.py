"""The step split at its one host read (``world.step_head`` /
``world.step_tail``) and the static-buffer bookkeeping of
``graphs.CapturedStep``, which the chunk driver replays from CUDA graphs on
the card and runs eagerly on the CPU.

* (a) head + tail equal ``step`` bit for bit: the flagship config on a
  rebuild and a reuse step with light and full metrics, ``balls_scene(3)``
  (no cache: no host read) and the mixed pile;
* (b) chunks through the bookkeeping equal the functional chunk
  (``capture=False``) bit for bit over 3 chunks of 16 and a shorter one
  on the same buffers: state, every metric
  row, the force nonces and the two-chunk-late schedule choice; a chunk's
  world and metrics are copies later chunks leave alone, and an in-place
  edit of a returned world is stepped from;
* (c) under a dispatch mode that records every aten op, no segment that is
  captured reads the host or builds a tensor from host data, and a cached
  step's one host read is ``need``;
* (d) 16 steps through the chunk driver's CPU path against mgf_tpu's step
  from the same state, at the guards and tolerances of
  ``test_torch_world.py::test_sixteen_steps_guards_match_jax``;
* (e) the refusals: ``capture=True`` on a CPU world, ``profile_stage``,
  debug mode;
* the card's twin, the flagship replayed from graphs against eager runs,
  is ``tests/test_torch_capture_cuda.py`` (no JAX there: the machine with
  the card has none).

Bit-equality is the tolerance wherever both sides run the same operations
on the same inputs; (d) compares two packages and uses the tolerances of
the test it mirrors.
"""

import collections
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from mgf_tpu.scenes import stress_scene as j_stress_scene  # noqa: E402
from mgf_tpu.world import step as j_step  # noqa: E402

from mgf_tpu_torch import world as W  # noqa: E402
from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402
from mgf_tpu_torch.driver import (  # noqa: E402
    AdaptiveChunkStepper, make_chunk_step,
)
from mgf_tpu_torch.graphs import CapturedStep  # noqa: E402
from mgf_tpu_torch.scenes import balls_scene, stress_scene  # noqa: E402
from mgf_tpu_torch.world import (  # noqa: E402
    WorldConfig, reads_need, step, step_head, step_tail,
)

CPU = "cpu"
FORBIDDEN = ("_local_scalar_dense", "lift_fresh", "nonzero", "masked_select")


def _leaves(world):
    out = []
    for t in (world.bodies, world.bp, world.warm):
        if t is not None:
            out += jax.tree_util.tree_leaves(t)
    return out


def _assert_worlds_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _assert_metrics_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = torch.as_tensor(a[k]), torch.as_tensor(b[k])
        assert x.dtype == y.dtype and torch.equal(x, y), k


def _nonces(k, C):
    """bench.py's per-step force nonces for chunk ``k``."""
    return torch.tensor([1.0 + 1e-6 * ((k * C + j) % 64 + 1)
                         for j in range(C)], dtype=torch.float32)


def _scene(name, n=1000):
    if name == "balls":
        world, cfg = balls_scene(3, device=CPU)
    elif name == "cold":
        world, cfg = stress_scene(n, device=CPU)
        cfg = cfg._replace(warm_start=False, fused_iso=False,
                           warm_match="search", adapt_schedule=None,
                           solver_iters=20, solver_inner=1, two_phase=True,
                           pallas_narrowphase=True)
        world = world._replace(warm=None)
    else:
        world, cfg = stress_scene(n, mixed=name == "mixed", device=CPU)
    return world, cfg._replace(adapt_schedule=None)


# ---- (a) ----

@pytest.mark.parametrize("name,n,want", [
    ("flagship", 2000, [True, False]), ("mixed", 2000, [True, False]),
    ("balls", 0, [True, True])])
@pytest.mark.parametrize("light", [False, True])
def test_head_tail_equal_step(name, n, want, light):
    world, cfg = _scene(name, n)
    cfg = cfg._replace(light_metrics=light)
    assert reads_need(world, cfg) == (name != "balls")
    rebuilt = []
    for _ in want:
        head = step_head(world, cfg)
        rebuild = bool(head.need)
        rebuilt.append(rebuild)
        w_s, m_s = step(world, cfg)
        w_t, m_t = step_tail(world, cfg, head, rebuild)
        _assert_worlds_equal(w_s, w_t)
        _assert_metrics_equal(m_s, m_t)
        world = w_s
    assert rebuilt == want


# ---- (b) ----

@pytest.mark.parametrize("name", ["flagship", "balls"])
def test_bookkeeping_equals_functional_chunks(name):
    """3 chunks of 16 through CapturedStep's bookkeeping and through the
    Python loop over ``step``: bit-equal state and metrics; the flagship
    through AdaptiveChunkStepper with patience 1 and a threshold of 0, so
    that the third chunk runs the hot schedule chosen from the first."""
    world, cfg = _scene(name)
    C = 16
    if name == "flagship":
        cfg = cfg._replace(adapt_schedule=(0.0, 2, 6))
        st = {cap: AdaptiveChunkStepper(cfg, chunk=C, patience=1,
                                        light=True, capture=cap)
              for cap in (None, False)}
        run = {cap: s.step_chunk for cap, s in st.items()}
        chunks = {cap: s.run_chunk for cap, s in st.items()}
    else:
        st = None
        chunks = {cap: make_chunk_step(cfg, capture=cap)
                  for cap in (None, False)}
        run = chunks
    w = {cap: world for cap in run}
    first = None
    for k in range(3):
        out = {cap: run[cap](w[cap], _nonces(k, C)) for cap in run}
        _assert_worlds_equal(out[None][0], out[False][0])
        _assert_metrics_equal(out[None][1], out[False][1])
        assert out[None][1]["num_constraints"].shape == (C,)
        if st is not None:
            assert st[None].hot_on == st[False].hot_on == (k == 2)
        if k == 0:
            first = out[None]
            kept = ([t.clone() for t in _leaves(first[0])],
                    {m: v.clone() for m, v in first[1].items()})
        w = {cap: out[cap][0] for cap in run}
        if k == 1:
            # an in-place edit of a returned world is stepped from
            for cap in run:
                w[cap].bodies.v.y.mul_(0.5)
    # a shorter chunk runs on the same static buffers and graphs
    cap = chunks[None].captured
    out = {cap_: run[cap_](w[cap_], _nonces(3, 5)) for cap_ in run}
    _assert_worlds_equal(out[None][0], out[False][0])
    _assert_metrics_equal(out[None][1], out[False][1])
    assert out[None][1]["num_constraints"].shape == (5,)
    assert chunks[None].captured is cap
    # the chunk's own copies: later chunks did not write them
    for x, y in zip(_leaves(first[0]), kept[0]):
        assert torch.equal(x, y)
    _assert_metrics_equal(first[1], kept[1])
    assert isinstance(chunks[None].captured, CapturedStep)
    assert chunks[None].captured.graphs is False
    assert chunks[False].captured is None


# ---- (c) ----

class _Ops(TorchDispatchMode):
    """Counts every aten op by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _forbidden(ops):
    return {k: v for k, v in ops.items()
            if k in FORBIDDEN or "unique" in k}


@pytest.mark.parametrize("name", ["flagship", "cold", "mixed", "balls"])
def test_captured_segments_make_no_host_read(name, monkeypatch, capsys):
    world, cfg = _scene(name)
    C = 8
    seen = {}

    def segment(self, key, fn, pure):
        with _Ops() as rec:
            out = fn()
        seen.setdefault(key, rec.ops)
        assert _forbidden(rec.ops) == {}, (key, _forbidden(rec.ops))
        return out

    monkeypatch.setattr(CapturedStep, "_segment", segment)
    run = make_chunk_step(cfg, light=True)
    with _Ops() as whole:
        run(world, torch.ones(C))
    cached = reads_need(world, cfg)
    # the chunk's only host reads are ``need``, one per cached step
    assert _forbidden(whole.ops) == ({"_local_scalar_dense": C} if cached
                                     else {})
    kinds = {k[0] for k in seen}
    assert kinds == ({"head", "tail"} if cached else {"step"})
    if cached:
        assert {k[2] for k in seen if k[0] == "tail"} == {True, False}
    with capsys.disabled():
        for key, ops in sorted(seen.items(), key=str):
            print(f"\n{name} segment {key}: {sum(ops.values())} aten ops")


# ---- (d) ----

@pytest.fixture(scope="module")
def jax_pile():
    """mgf_tpu's 800-body pile after 120 steps and its jitted step, with
    the solver schedule fixed (the chunk driver's config)."""
    world, cfg = j_stress_scene(800)
    cfg = cfg._replace(adapt_schedule=None)
    f = jax.jit(functools.partial(j_step, cfg=cfg))
    for _ in range(120):
        world, _ = f(world)
    return world, cfg, f


def test_sixteen_chunk_steps_guards_match_jax(jax_pile):
    jw, cfg, f = jax_pile
    tw = world_from_numpy(jax.tree_util.tree_map(np.asarray, jw), CPU)
    run = make_chunk_step(WorldConfig(*cfg))
    tw, tm = run(tw, torch.ones(16))
    assert isinstance(run.captured, CapturedStep)
    tm = world_to_numpy(tm)
    for i in range(16):
        jw, jm = f(jw)
        jm = jax.tree_util.tree_map(np.asarray, jm)
        nj, nt = int(jm["num_contacts"]), int(tm["num_contacts"][i])
        assert abs(nj - nt) <= 0.01 * nj, (i, nj, nt)
        assert abs(float(jm["max_penetration"])
                   - float(tm["max_penetration"][i])) <= 0.01
        assert abs(float(jm["warm_hit_frac"])
                   - float(tm["warm_hit_frac"][i])) <= 0.02
        for o, d in ((jm["broadphase_overflow"], jm[
                "broadphase_cache_drift_excess"]), (
                tm["broadphase_overflow"][i],
                tm["broadphase_cache_drift_excess"][i])):
            assert int(o) == 0 and float(d) == 0.0


# ---- (e) ----

def test_refusals(monkeypatch):
    world, cfg = _scene("flagship", 300)
    ones = torch.ones(4)
    with pytest.raises(ValueError, match="CPU world"):
        make_chunk_step(cfg, capture=True)(world, ones)
    with pytest.raises(ValueError, match="profile_stage"):
        CapturedStep(cfg._replace(profile_stage="pairs"), world, 4)
    with pytest.raises(ValueError, match="profile_stage"):
        make_chunk_step(cfg._replace(profile_stage="pairs"),
                        capture=True)(world, ones)
    with pytest.raises(ValueError, match="adapt_schedule"):
        CapturedStep(cfg._replace(adapt_schedule=(0.97, 2, 6)), world, 4)
    cap = CapturedStep(cfg, world, 4)
    # debug mode (utils.debug.enable_debug_mode sets this flag; the module
    # is not imported here, so that the utils package's names stay as
    # tests/test_torch_utils.py expects them)
    monkeypatch.setattr(W, "DEBUG_NANS", True)
    with pytest.raises(ValueError, match="debug mode"):
        cap.run(world, ones)
    with pytest.raises(ValueError, match="debug mode"):
        CapturedStep(cfg, world, 4)
    # the default chunk takes the eager loop, which checks every step
    run = make_chunk_step(cfg)
    monkeypatch.setattr(type(run), "_loop",
                        lambda self, c, w, s: ("eager", c, w))
    assert run(world, ones) == ("eager", cfg, world)
    assert run.captured is None
