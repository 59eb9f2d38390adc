"""Tracing inside the port (``mgf_tpu_torch.tracing``) on the CPU, where a
stamp reads the host's clock into host memory with the same bookkeeping
the card's one-thread kernel does:

* (a) off: nothing recorded, no stamp, counter or span call, and a chunk's
  world and metrics bit-equal with tracing on and off;
* (b) a step's intervals come in order under ``profile_stage``'s names, and
  tile the time from the head's start to the step's end;
* (c) the counters equal the full metrics' ``num_pairs`` and
  ``num_contacts`` summed over the same steps, and ``CapturedStep``'s CPU
  bookkeeping counts what the Python loop over ``step`` counts;
* (d) the host spans nest, come once a step, and are ``span:`` ranges of
  a profiler that records, with tracing off too;
* (e) ``summary`` on a synthetic record, and on an empty one;
* (f) on the card (``cuda`` marker, skipped without one): a replayed
  graph's stamps count replays x stamps, and the graphs captured with
  tracing off launch what those captured with it on launch, less the
  stamps and counters.
"""

import time

import pytest

torch = pytest.importorskip("torch")

from mgf_tpu_torch import tracing  # noqa: E402
from mgf_tpu_torch import world as W  # noqa: E402
from mgf_tpu_torch.driver import (  # noqa: E402
    AdaptiveChunkStepper, make_chunk_step,
)
from mgf_tpu_torch.math3d import Vec3, tree_map  # noqa: E402
from mgf_tpu_torch.ops import stamp as stamp_op  # noqa: E402
from mgf_tpu_torch.scenes import stress_scene  # noqa: E402

CPU = "cpu"
# profile_stage's checkpoints, in the order a step passes them
PROBES = ("integrate", "pairs", "narrow", "terrain", "rows", "constraints",
          "warm", "solve")


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _pile(n=300):
    """A small flagship pile pressed together, so that the first steps
    have contacts."""
    world, cfg = stress_scene(n, device=CPU)
    b = world.bodies
    y0 = b.x.y.min()
    x = Vec3(b.x.x, y0 + 0.75 * (b.x.y - y0), b.x.z)
    return world._replace(bodies=b._replace(x=x)), cfg


def _leaves(world):
    out = []
    for t in (world.bodies, world.bp, world.warm):
        tree_map(out.append, t)
    return out


def _nonces(C):
    return torch.tensor([1.0 + 1e-6 * (j + 1) for j in range(C)])


# ---- (a) ----

def test_off_records_nothing_and_changes_nothing(monkeypatch):
    world, cfg = _pile()
    cfg = cfg._replace(adapt_schedule=None)
    C = 4

    def refuse(*a, **k):
        raise AssertionError("tracing called while off")

    with monkeypatch.context() as mp:
        for name in ("stamp", "count", "count_schedule", "span"):
            mp.setattr(tracing, name, refuse)
        mp.setattr(stamp_op, "stamp", refuse)
        w_off, m_off = make_chunk_step(cfg, light=True)(world, _nonces(C))
    rec = tracing.record()
    assert rec["steps"] == 0 and rec["span_ns"] == 0 and rec["spans"] == []
    assert all(v["count"] == 0 for v in rec["intervals"].values())
    assert rec["schedules"] == {} and rec["hot_steps"] == 0

    tracing.enable(CPU)
    w_on, m_on = make_chunk_step(cfg, light=True)(world, _nonces(C))
    assert tracing.record()["steps"] == C
    for x, y in zip(_leaves(w_off), _leaves(w_on)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert m_off.keys() == m_on.keys()
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k


# ---- (b) ----

def test_intervals_in_order_and_tile_the_step(monkeypatch):
    world, cfg = _pile()
    tracing.enable(CPU)
    world, _ = W.step(world, cfg)              # warm the caches
    name_of = {slot: key for key, slot in tracing._SLOT.items()}
    seen = []
    real = stamp_op.stamp

    def logged(buf, slot):
        seen.append(name_of[slot])
        real(buf, slot)

    monkeypatch.setattr(stamp_op, "stamp", logged)
    tracing.reset()
    t0 = time.perf_counter_ns()
    _, m = W.step(world, cfg)
    wall = time.perf_counter_ns() - t0
    rebuild = bool(m["broadphase_rebuilt"])
    variant = "rebuild" if rebuild else "reuse"
    assert seen == ([(n, None) for n in tracing.HEAD]
                    + [(n, variant) for n in tracing.TAIL])
    assert set(PROBES) <= set(tracing.HEAD + tracing.TAIL)
    names = [n for n, _ in seen]
    assert [n for n in names if n in PROBES] == list(PROBES)
    rec = tracing.record()
    # the first stamp opens the step; each later one closes an interval
    assert rec["steps"] == 1
    counted = {n: v["count"] for n, v in rec["intervals"].items()}
    assert counted == {n: int(n in names[1:]) for n in counted}
    total = sum(v["ns"] for v in rec["intervals"].values())
    assert total == rec["span_ns"]
    assert 0 < rec["span_ns"] <= wall
    tail = rec["tails"][variant]
    assert all(tail[n]["count"] == 1 for n in tracing.TAIL)
    other = rec["tails"]["reuse" if rebuild else "rebuild"]
    assert all(v["count"] == 0 for v in other.values())


# ---- (c) ----

def test_counters_equal_full_metrics():
    world, cfg = _pile()
    steps = 4
    tracing.enable(CPU)
    w = world
    for _ in range(steps):
        w, _ = W.step(w, cfg._replace(light_metrics=True))
    counted = tracing.record()["counters"]
    tracing.disable()
    w, pairs, contacts = world, 0, 0
    for _ in range(steps):
        w, m = W.step(w, cfg._replace(light_metrics=False))
        pairs += int(m["num_pairs"])
        contacts += int(m["num_contacts"])
    assert contacts > 0
    assert counted == {"pairs_tested": pairs, "contacts": contacts}


def test_bookkeeping_counts_what_the_loop_counts():
    world, cfg = _pile()
    cfg = cfg._replace(adapt_schedule=None)
    C = 4
    tracing.enable(CPU)
    recs = {}
    for capture in (None, False):
        tracing.reset()
        chunk = make_chunk_step(cfg, light=True, capture=capture)
        w = world
        for _ in range(2):
            w, _ = chunk(w, _nonces(C))
        assert (chunk.captured is not None) == (capture is None)
        recs[capture] = tracing.record()
    a, b = recs[None], recs[False]
    assert a["counters"] == b["counters"]
    assert a["counters"]["contacts"] > 0
    assert a["steps"] == b["steps"] == 2 * C
    for n in tracing.HEAD[1:] + tracing.TAIL:
        assert a["intervals"][n]["count"] == b["intervals"][n]["count"], n
    for v in tracing.VARIANTS:
        for n in tracing.TAIL:
            assert a["tails"][v][n]["count"] == b["tails"][v][n]["count"]
    # the captured chunk stamps its own work: two chunks, the first
    # call's stamp opens the window
    assert [a["intervals"][n]["count"] for n in tracing.CHUNK] == [1, 2, 2]
    assert all(b["intervals"][n]["count"] == 0 for n in tracing.CHUNK)


def test_schedule_counts():
    world, cfg = _pile()
    C = 4
    cfg = cfg._replace(adapt_schedule=(0.0, 2, 6))
    st = AdaptiveChunkStepper(cfg, chunk=C, patience=1, light=True)
    tracing.enable(CPU)
    w = world
    for _ in range(4):
        w, _ = st.step_chunk(w)
    rec = tracing.record()
    # the hot schedule is chosen two chunks late, from the first chunk on
    full = f"{cfg.solver_iters}x{cfg.solver_inner}"
    assert rec["schedules"] == {full: 2 * C, "2x6": 2 * C}
    assert rec["hot_steps"] == 2 * C
    assert tracing.summary(rec)["hot_schedule_pct"] == 50.0


# ---- (d) ----

def _parents(spans, i):
    out = []
    while spans[i][3] is not None:
        i = spans[i][3]
        out.append(spans[i][0])
    return out


def test_spans_nest_once_a_step():
    world, cfg = _pile()
    C = 4
    st = AdaptiveChunkStepper(cfg, chunk=C, light=True)
    tracing.enable(CPU)
    w = world
    for _ in range(3):
        w, _ = st.step_chunk(w)
    spans = tracing.record()["spans"]
    names = [s[0] for s in spans]
    assert names.count("driver.chunk") == 3
    assert names.count("driver.schedule_read") == 1    # two chunks late
    for n in ("graphs.replay_head", "graphs.need_read",
              "graphs.replay_tail"):
        assert names.count(n) == 3 * C, n
    assert names.count("graphs.load") == names.count("graphs.snapshot") == 3
    for i, (name, start, end, parent) in enumerate(spans):
        assert start <= end
        if name == "driver.chunk":
            assert parent is None
            continue
        assert _parents(spans, i) == ["driver.chunk"], name
        p = spans[parent]
        assert p[1] <= start and end <= p[2]


@pytest.mark.parametrize("on", [False, True])
def test_spans_are_profiler_ranges(on):
    world, cfg = _pile()
    C = 2
    st = AdaptiveChunkStepper(cfg, chunk=C, light=True)
    w, _ = st.step_chunk(world)
    if on:
        tracing.enable(CPU)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        st.step_chunk(w)
    names = [e.name for e in prof.events() if e.name.startswith("span:")]
    assert names.count("span:driver.chunk") == 1
    assert names.count("span:graphs.need_read") == C
    assert names.count("span:graphs.replay_tail") == C
    assert len(tracing.record()["spans"]) == (len(names) if on else 0)


# ---- (e) ----

def _synthetic():
    iv = {n: {"ns": 0, "count": 0} for n in tracing.CHUNK + tracing.HEAD
          + tracing.TAIL}
    ms = dict(call_gap=1, chunk_in=1, chunk_out=2, step_gap=4,
              integrate=10, bounds=20, need_gap=40, pairs=30, narrow=60,
              terrain=40, rows=5, constraints=10, warm=5, solve=200,
              finish=20)
    for n, v in ms.items():
        iv[n] = {"ns": v * 1_000_000, "count": 10}
    tails = {v: {n: {"ns": 0, "count": 0} for n in tracing.TAIL}
             for v in tracing.VARIANTS}
    for n in tracing.TAIL:
        tails["rebuild"][n] = {"ns": ms[n] * 400_000, "count": 2}
    span_ns = sum(v["ns"] for v in iv.values())
    return dict(clock="globaltimer", device="cuda:0", span_ns=span_ns,
                steps=10, intervals=iv, tails=tails,
                counters={"pairs_tested": 9000, "contacts": 2250},
                schedules={"4x4": 4, "2x6": 12}, hot_steps=12,
                spans=[["driver.chunk", 0, 100, None],
                       ["graphs.need_read", 10, 30_010, 0],
                       ["graphs.need_read", 40_000, 60_000, 0]])


def test_summary_of_a_record():
    s = tracing.summary(_synthetic())
    assert s["steps"] == 10
    assert s["broadphase"] == pytest.approx(5.0)      # (20 + 30) / 10
    assert s["narrowphase"] == pytest.approx(10.0)
    assert s["constraints"] == pytest.approx(2.0)
    assert s["solver"] == pytest.approx(20.0)
    assert s["commit"] == pytest.approx(2.0)
    assert s["need_gap"] == pytest.approx(4.0)
    # head (10 + 20 ms over 10 steps) + the rebuild tail's stages but
    # its need_gap (370 ms x 0.4 over 2 rebuild steps)
    assert s["rebuild_step"] == pytest.approx(3.0 + 74.0)
    assert s["need_wait"] == pytest.approx(0.005)     # 50 us over 10
    assert s["idle_pct"] == pytest.approx(100.0 * 44 / 448)
    assert s["unassigned_pct"] == 0.0
    assert s["hot_schedule_pct"] == pytest.approx(75.0)
    assert s["pairs_tested_per_step"] == pytest.approx(900.0)
    assert s["contacts_per_pair_pct"] == pytest.approx(25.0)
    assert s["stages"]["solve"] == pytest.approx(20.0)


def test_summary_of_an_empty_record():
    s = tracing.summary(tracing.record())
    assert s["steps"] == 0
    assert all(v is None for k, v in s.items()
               if k not in ("steps", "stages"))
    assert all(v is None for v in s["stages"].values())


# ---- (f) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the stamp kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


def _cache_at(world, count, slack=None):
    """``world`` with its broadphase cache stepped ``count`` times and,
    with ``slack``, a slack no body outruns."""
    bp = world.bp._replace(count=torch.full_like(world.bp.count, count))
    if slack is not None:
        bp = bp._replace(slack=torch.full_like(bp.slack, slack))
    return world._replace(bp=bp)


def _device_ops(fn):
    """The device operations a profiler sees while ``fn`` runs."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))


@pytest.mark.cuda
def test_replayed_stamps_count_on_card(cuda_device, monkeypatch):
    from mgf_tpu_torch.ops import solver_sweep
    world, cfg = stress_scene(8000, device=cuda_device)
    cfg = cfg._replace(adapt_schedule=None)
    C = 8
    ones = torch.ones((C,), device=cuda_device)

    def drive(on):
        tracing.disable()
        if on:
            tracing.enable(cuda_device)
        chunk = make_chunk_step(cfg, light=True)
        chunk(world, ones)
        cap = chunk.captured
        # every variant: rebuild and reuse tails, light and full metrics
        for count, slack in ((0, None), (1, 1e9), (cfg.bp_every - 1, 1e9)):
            cap.run(_cache_at(world, count, slack), ones[:2])
        graphs = cap.n_graphs
        torch.cuda.synchronize()
        tracing.reset()
        r0, k0, s0 = cap.replays, solver_sweep.LAUNCHES, stamp_op.LAUNCHES
        w = world
        for _ in range(2):
            w, _ = chunk(w, ones)
        rec = tracing.record()
        assert cap.n_graphs == graphs
        counts = (cap.replays - r0, solver_sweep.LAUNCHES - k0,
                  stamp_op.LAUNCHES - s0)
        return (cap, rec, *counts, _device_ops(lambda: chunk(w, ones)))

    cap_on, rec, replays, k1_on, stamps, ops_on = drive(True)
    steps = 2 * C
    assert replays == 2 * steps                   # head and tail a step
    # 3 head + 9 tail stamps a step, 3 a chunk; the first only opens
    assert stamps == 12 * steps + 3 * 2
    assert sum(v["count"] for v in rec["intervals"].values()) == stamps - 1
    assert rec["steps"] == steps
    assert all(rec["intervals"][n]["count"] == steps
               for n in tracing.HEAD + tracing.TAIL)
    assert sum(v["ns"] for v in rec["intervals"].values()) == rec["span_ns"]
    assert rec["span_ns"] > 0 and rec["clock"] == "globaltimer"
    assert rec["counters"]["pairs_tested"] > 0
    assert {k[-1] for k in cap_on._segments} == {True}

    cap_off, rec_off, replays_off, k1_off, stamps_off, ops_off = drive(False)
    assert rec_off["steps"] == 0 and stamps_off == 0
    assert replays_off == replays and k1_off == k1_on
    assert {k[-1] for k in cap_off._segments} == {False}
    # what each capture recorded: the same kernels, less the stamps
    stamp_key = (stamp_op.__name__, "LAUNCHES")
    assert len(cap_off._segments) == len(cap_on._segments)
    for key, (_, _, rec_off_) in cap_off._segments.items():
        rec_on_ = cap_on._segments[key[:-1] + (True,)][2]
        assert stamp_key not in rec_off_
        assert rec_on_[stamp_key] == (3 if key[0] == "head" else 9)
        assert {k: v for k, v in rec_on_.items() if k != stamp_key} == \
            dict(rec_off_)
    # and on the device: a chunk replayed with tracing on runs 12 stamps
    # and the counters' operations a step, and 3 stamps a chunk, more than
    # the graphs captured with it off, which are the graphs of a port
    # without tracing; the counters' operations are an eager step's with
    # and without them
    tracing.enable(cuda_device)
    light = cfg._replace(light_metrics=True)
    W.step(world, light)
    with_counters = _device_ops(lambda: W.step(world, light))
    monkeypatch.setattr(tracing, "count", lambda *a: None)
    counter_ops = with_counters - _device_ops(lambda: W.step(world, light))
    assert ops_off > 0 and counter_ops >= 4
    # the profiler's count of one chunk's operations varies by one from run
    # to run (19,535 and 19,534 for the same chunk captured off)
    assert abs(ops_on - ops_off - ((12 + counter_ops) * C + 3)) <= 1
