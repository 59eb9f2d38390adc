"""Run one cell of the port's benchmark once and print its result line.

    python3 physbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``physbench/configs/<name>.json``) and a traffic mix
(``physbench/traffic/<name>.json``).  A run

1. makes the configuration's scene from ``--seed`` on the card
   (``mgf_tpu_torch.scenes``), loading the port's CUDA kernels (nvcc runs
   only on a checkout's first run, into ``build/mgf_tpu_torch``);
2. settles the pile through the traffic's stepper
   (``driver.AdaptiveChunkStepper``, CUDA graphs of the step) and captures
   every graph variant the window can meet;
3. runs the window for ``--seconds``: chunks of the traffic's length, each
   one call, with per-frame position copies and metric reads where the
   traffic asks for them;
4. with ``--trace 1``, traces ``trace_steps`` more steps with
   ``torch.profiler``, then runs ``4 x trace_steps`` more with the
   program's own tracing on (``mgf_tpu_torch.tracing``: stage stamps and
   counters), and reads the per-layer metrics;
5. frees the program and holds what the window produced against the plain
   reference (``physbench/harness/compare.py``);
6. prints each compared number beside its limit on stderr and, as the
   last line of stdout, one JSON object: ``correct``, ``attempted``,
   ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
   ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
   ``breakdown``, and last ``checks``.

Without a CUDA card (or with fewer than the cell asks for) it exits 2 and
prints no result; it never falls back to the CPU.  It imports neither JAX
nor the JAX package, and exits 3 with no result if either is loaded once
the window has closed.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "mgf_tpu")


def _process_start():
    """The process's start on the ``perf_counter`` clock (Linux's
    /proc; elsewhere the moment this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.perf_counter() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def _cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own kernels build into build/mgf_tpu_torch there)."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _to_host(world):
    from mgf_tpu_torch.math3d import tree_map
    return tree_map(lambda t: t.detach().to("cpu", copy=True), world)


def _host_mirror(world):
    """Host tensors shaped as ``world``'s, pinned where it is on the card,
    for copies that leave the card without waiting for it."""
    import torch
    from mgf_tpu_torch.math3d import tree_map
    pin = world.bodies.x.x.is_cuda
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=pin), world)


def _copy_to(mirror, world):
    """Queue a copy of ``world`` into ``mirror`` behind the work that makes
    it (the copy is done once the queue has drained)."""
    from mgf_tpu_torch.math3d import tree_map
    return tree_map(lambda m, t: m.copy_(t.detach(), non_blocking=True),
                    mirror, world)


def lower_precision_leaves(world) -> int:
    """The world's floating tensors that are not float32."""
    import torch
    from mgf_tpu_torch.math3d import tree_map
    bad = []
    tree_map(lambda t: bad.append(t.is_floating_point()
                                  and t.dtype != torch.float32), world)
    return sum(bad)


class _Watch:
    """The guarantees the program counts itself, over every step it runs:
    the most bodies its cell table dropped, and the largest drift of a
    cached candidate list past its slack.  Kept on the device."""

    def __init__(self, device):
        import torch
        self.overflow = torch.zeros((), dtype=torch.int64, device=device)
        self.drift = torch.zeros((), dtype=torch.float32, device=device)

    def __call__(self, m):
        import torch
        torch.maximum(self.overflow,
                      m["broadphase_overflow"].max().to(torch.int64),
                      out=self.overflow)
        torch.maximum(self.drift,
                      m["broadphase_cache_drift_excess"].max().float(),
                      out=self.drift)

    def numbers(self) -> dict:
        return dict(overflow_max=int(self.overflow),
                    drift_excess_max=float(self.drift))


def _nonces(chunk: int, period: int, step: float, device):
    """The traffic's force nonces, one row per distinct chunk: step k of
    the run scales the force by 1 + step * (k % period + 1)."""
    import torch
    rows = period // math.gcd(period, chunk)
    return torch.tensor([[1.0 + step * ((k * chunk + j) % period + 1)
                          for j in range(chunk)] for k in range(rows)],
                        dtype=torch.float32, device=device)


def run_cell(cell: dict, conf: dict, traffic: dict, limits: dict, seed: int,
             seconds: float, trace: bool, device, t_start_proc: float,
             stepper_hook=None, log=None, control_dtype=None):
    """One run of a cell on ``device``; returns the result dict (without
    printing it).  ``stepper_hook``, for the harness's own tests, wraps the
    stepper's chunk call to break the timed path.  ``control_dtype``, for
    ``physbench/control.py`` alone, also puts the reference computed in
    that dtype in the program's place for every compared chunk and adds
    its widest readings to the result as ``control``."""
    import torch

    from physbench.harness import compare, system
    from physbench.harness.state import state_from_world
    from physbench.harness.trace import Spans

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spans = Spans()
    on_card = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize()) if on_card else (lambda: None)
    eng = compare.engine_of(conf)
    chunk = int(traffic["chunk"])

    with spans.span("build"):
        if on_card:
            from mgf_tpu_torch.ops import _build
            _build.build_all()
    with spans.span("scene"):
        world, cfg = system.build_world(conf, seed, device)
        n_bodies = world.bodies.n_bodies
        scene_mismatch = compare.start_mismatch(world, conf, seed)
    st = system.stepper(cfg, chunk)
    call = st.step_chunk if stepper_hook is None else stepper_hook(st)
    nonce = _nonces(chunk, traffic["nonce_period"], traffic["nonce_step"],
                    device)
    rows = nonce.shape[0]
    with spans.span("settle"):
        for k in range(-(-int(traffic["settle_steps"]) // chunk)):
            world, m = st.step_chunk(world, nonce[k % rows])
        sync()
    with spans.span("capture"):
        missing = system.warm_variants(st, world, cfg.bp_every, nonce[0])
        sync()
    if missing:
        log(f"warning: {missing} graph variant(s) not captured in set-up")
    settled = _to_host(world)
    lower_prec = lower_precision_leaves(world)
    cap = system.captured(st)
    graphs_before = cap.n_graphs if cap is not None else 0

    # the compared chunks: the first chunk to start after each of
    # ``compare_chunks`` moments drawn from the seed
    rng = random.Random(seed)
    marks = sorted(rng.uniform(0.05, 0.5) * seconds
                   for _ in range(int(traffic["compare_chunks"])))
    # their worlds leave the card by queued copies into pinned host memory,
    # so that the window waits for none of them
    mirrors = [(_host_mirror(world), _host_mirror(world))
               for _ in marks]
    samples = []
    watch = _Watch(device)
    frame_ms = [] if traffic["frame_reads"] else None
    rebuilt = torch.zeros((), dtype=torch.int64, device=device)
    system.reset_launches()
    replays0 = cap.replays if cap is not None else 0
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start_proc
    k = steps = 0
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        take = bool(marks) and now >= marks[0]
        if take:
            marks.pop(0)
            w_in, w_out = mirrors[len(samples)]
            _copy_to(w_in, world)
        sc = nonce[k % rows]
        t_call = time.perf_counter()
        world, m = call(world, sc)
        if frame_ms is not None:
            b = world.bodies
            torch.stack([b.x.x, b.x.y, b.x.z], 1).cpu()
            torch.cat([v.reshape(-1).float() for v in m.values()]).cpu()
            frame_ms.append(1e3 * (time.perf_counter() - t_call))
        rebuilt += m["broadphase_rebuilt"].sum()
        watch(m)
        if take:
            _copy_to(w_out, world)
            samples.append((w_in, w_out, sc, system.schedule_of(st)))
        k += 1
        steps += chunk
    world.bodies.x.y.cpu()          # the queue drained, heights on the host
    window_s = time.perf_counter() - t0
    log(f"the program's counts over the window: {watch.numbers()}")
    replays = (cap.replays - replays0) if cap is not None else None
    rebuilds = int(rebuilt)
    graphs_in_window = (cap.n_graphs - graphs_before) if cap is not None \
        else 0
    if graphs_in_window:
        log(f"warning: {graphs_in_window} graph(s) captured inside the "
            "window")
    ctx = dict(steps=steps, window_s=window_s, frame_ms=frame_ms,
               replays=replays, rebuilds=rebuilds,
               capture_s=cap.capture_seconds if cap is not None else None,
               trace=None, k1=None, chunk=chunk)

    breakdown = None
    dev_extra = {}
    if trace:
        order = (k + torch.arange(rows, device=nonce.device)) % rows
        ctx.update(_traced(st, world, nonce[order], traffic, conf, spans,
                           sync, n_bodies, watch))
        tr = ctx["trace"]
        if tr is not None:
            dev_extra = dict(busy_s=tr["busy_s"], window_s=tr["window_s"])
            breakdown = dict(device_ops=[[n, s] for n, s in tr["top_ops"]],
                             idle_gaps=tr["idle_gaps"])

    if on_card:
        peak = int(torch.cuda.max_memory_reserved())
        kind = torch.cuda.get_device_name(0)
    else:
        peak, kind = 0, "cpu"

    if trace:
        # the program's own stage stamps and counters, over steps run after
        # every other reading of the run (the profiled steps, the peak
        # above): the settle, the window and the profiled steps replay the
        # graphs they replay with the program's tracing off
        with spans.span("stamped"):
            ctx["program"] = _stamped(st, world, nonce[order], traffic,
                                      cfg.bp_every, sync, watch, device)

    lower_prec = max(lower_prec, lower_precision_leaves(world))
    counted = watch.numbers()
    log(f"the program's counts over all its steps: {counted}")
    # the program's state goes before the reference runs
    del st, world, m, call, cap
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    with spans.span("reference"):
        # the reference runs in float32, the configuration's precision
        ref = lambda w: state_from_world(w, torch.float32, device)
        numbers = dict(scene_mismatch=scene_mismatch,
                       lower_precision_leaves=lower_prec, **counted)
        _widen(numbers, compare.guarantees(ref(settled), eng))
        failed = 0
        control = {}
        for w_in, w_out, sc, sched in samples:
            sc = sc.tolist()
            s_in = ref(w_in)
            got = compare.chunk_numbers(s_in, ref(w_out), eng, sc, sched)
            ok, _ = compare.judge(got, limits, conf, n_bodies)
            log(f"compared chunk (schedule {sched}): {got}")
            failed += 0 if ok else 1
            _widen(numbers, got)
            if control_dtype is not None:
                _widen(control, compare.chunk_numbers(
                    s_in, compare.follow(s_in, eng, sc, sched,
                                         dtype=control_dtype),
                    eng, sc, sched))
    correct, checks = compare.judge(numbers, limits, conf, n_bodies,
                                    complete=bool(samples))
    if len(samples) < int(traffic["compare_chunks"]):
        log(f"only {len(samples)} of {traffic['compare_chunks']} compared "
            "chunks ran in the window")
        correct = False

    if trace:
        metrics = {}
        for e in cell["per_layer"]:
            from physbench.harness.manifest import metric
            v = metric(e["name"]).read(ctx)
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    else:
        values = dict(steps_per_s=steps / window_s,
                      peak_mem_gib=peak / 2 ** 30, setup_s=setup_s)
        if frame_ms:
            values["frame_ms_p95"] = statistics.quantiles(
                frame_ms, n=100, method="inclusive")[94]
        metrics = {e["name"]: {"value": values[e["name"]], "unit": e["unit"]}
                   for e in cell["end_to_end"]}
    out_dir = ROOT / "build" / "physbench"
    out_dir.mkdir(parents=True, exist_ok=True)
    spans.write(out_dir / f"spans-{cell['name']}.json")
    result = dict(correct=bool(correct), attempted=steps, failed=failed,
                  metrics=metrics,
                  device=dict(platform="gpu" if on_card else "cpu",
                              kind=kind, count=1, memory_peak_bytes=peak,
                              **dev_extra))
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control_dtype is not None:
        result["control"] = control
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result


def _widen(acc: dict, readings: dict):
    """Keep in ``acc`` the widest of each reading."""
    for k, v in readings.items():
        acc[k] = max(acc.get(k, -math.inf), v)


def _traced(st, world, nonce, traffic, conf, spans, sync, n_bodies, watch):
    """Trace ``trace_steps`` more steps of the window's traffic (``nonce``:
    its nonce rows in the order the window would have gone on with): the
    device operations, the host spans, K1's and K5's launches and their
    work."""
    import torch

    from physbench.harness import system
    from physbench.harness.roofline import k1_bound_s, k5_bound_s
    from physbench.harness.trace import read_trace
    eng = conf["engine"]
    chunk = int(traffic["chunk"])
    frames = bool(traffic["frame_reads"])
    n_chunks = max(1, int(traffic["trace_steps"]) // chunk)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    bound = 0.0
    R = eng["max_pairs"] + eng["terrain_cand"]

    n_faces = world.terrain.a.x.shape[0]
    system.reset_launches()
    sync()
    spans.profiling = True
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n_chunks):
            with spans.span("chunk call"):
                world, m = st.step_chunk(world, nonce[i % nonce.shape[0]])
            watch(m)
            it, inner = system.schedule_of(st)
            if eng["pallas_solver"]:
                bound += it * chunk * k1_bound_s(R, n_bodies, inner,
                                                 eng["max_pairs"])
            if frames:
                with spans.span("positions copy"):
                    b = world.bodies
                    torch.stack([b.x.x, b.x.y, b.x.z], 1).cpu()
                with spans.span("metrics read"):
                    torch.cat([v.reshape(-1).float()
                               for v in m.values()]).cpu()
        sync()
        window_s = time.perf_counter() - t0
    spans.profiling = False
    counts = system.launch_counts()
    launches = counts["K1"]
    tr = read_trace(prof, window_s, n_chunks * chunk)
    k1 = k5 = None
    if tr is not None and eng["pallas_solver"]:
        k1_s = sum(s for name, s in tr["by_name"].items()
                   if "solver_sweep" in name)
        k1 = dict(time_s=k1_s, launches=launches, bound_s=bound)
    if tr is not None:
        # K5 writes the deepest penetration on a chunk's last step (full
        # metrics) and not on the light steps before it
        full = min(counts["K5"], n_chunks)
        cand = eng["terrain_cand"]
        k5 = dict(time_s=sum(s for name, s in tr["by_name"].items()
                             if "sphere_terrain" in name),
                  launches=counts["K5"],
                  bound_s=full * k5_bound_s(n_bodies, n_faces, cand, True)
                  + (counts["K5"] - full) * k5_bound_s(n_bodies, n_faces,
                                                       cand, False))
    return dict(trace=tr, k1=k1, k5=k5)


def _stamped(st, world, nonce, traffic, bp_every, sync, watch, device):
    """Run ``4 x trace_steps`` more steps of the window's traffic from
    ``world`` (``nonce``: its nonce rows in the order the window would have
    gone on with; a frame's positions copy and metrics read each frame)
    with the program's own tracing on, its stamped graph variants captured
    first, outside any timed or profiled span.  Returns
    ``system.program_record()``.  The tracing is off again on return."""
    import torch

    from physbench.harness import system
    tracing = system.program_tracing(True, device)
    try:
        system.warm_variants(st, world, bp_every, nonce[0])
        sync()
        tracing.reset()
        chunk = int(traffic["chunk"])
        for i in range(max(1, 4 * int(traffic["trace_steps"]) // chunk)):
            world, m = st.step_chunk(world, nonce[i % nonce.shape[0]])
            watch(m)
            if traffic["frame_reads"]:
                b = world.bodies
                torch.stack([b.x.x, b.x.y, b.x.z], 1).cpu()
                torch.cat([v.reshape(-1).float() for v in m.values()]).cpu()
        sync()
        return system.program_record()
    finally:
        system.program_tracing(False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_proc = _process_start()
    from physbench.harness import manifest
    cell = manifest.cell(args.workload)
    conf = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    limits = manifest.limits(cell["name"])
    _cache_dirs()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"physbench: the cell needs {cell['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no CPU fallback)", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    seed = args.seed % (1 << 64)
    result = run_cell(cell, conf, traffic, limits, seed, args.seconds,
                      bool(args.trace), torch.device("cuda"), t_proc)
    bad = forbidden_modules()
    if bad:
        print(f"physbench: loaded in this process after the window: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
