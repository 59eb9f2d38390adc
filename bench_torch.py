"""Benchmark harness of the PyTorch/CUDA port (``mgf_tpu_torch``): the twin
of ``bench.py``, on one NVIDIA GPU.

It runs bench.py's rows with bench.py's scenes, configs, warm-ups, windows,
chunking and force nonces, and prints bench.py's two JSON lines: the
secondary dict (every key of BENCH_r05.json's) on stderr and the headline
dict (steps/s on the settled stress pile) as the last line of stdout.
Before them it prints the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them (stdout), and one line of each row's kernel launches (stderr).

    python3 bench_torch.py              # the full run at 100k bodies
    python3 bench_torch.py --quick      # 10k bodies, the headline row only
    python3 bench_torch.py --quick --bodies 2000 --device cpu   # small

Rows, in bench.py's order (steps are warm-up + timed):

* ``balls_scene()`` 180 + 60, ``capsules_scene()`` 280 + 60,
  ``terrain_scene(10_000)`` 120 + 40, one step per call;
* GJK/EPA on 8,192 OBB pairs and compound-vs-rectangle on 8,192 parts,
  10 pre-staged argument sets each;
* the cold reference-schedule pile (warm starting off, 20 two-phase
  sweeps) 180 + 30;
* the mixed pile 400 + 2 windows x 64, chunk 16, with its p99 penetration;
* the headline ``stress_scene(n)``: 1,600 steps of warm-up, then the
  fastest of 3 windows x 128 steps, chunk 64, the schedule chosen on the
  host (``AdaptiveChunkStepper``), then ``2 * bp_every`` single steps
  certifying the rebuild cadence;
* 16,384 rays into the settled headline pile, grid and dense.

Departures from bench.py:

* a failing row raises and the script exits non-zero (bench.py records
  ``*_error`` and carries on);
* ``vs_baseline`` is null: bench.py divides by BASELINE.json's target,
  which was set for a TPU, not for this card;
* values are not rounded, and the headline names the device it ran on;
* ``--bodies`` also sizes the ``--quick`` run (bench.py's ``--quick`` is
  10k bodies whatever ``--bodies`` says; here that is the default);
* ``--cold-cache`` builds the CUDA kernels into a fresh temporary
  directory, so the ``*_compile_s`` of the first row that launches each
  kernel includes nvcc (bench.py's flag points JAX's compilation cache at
  a fresh directory);
* the chunked rows (the mixed pile and the headline) replay CUDA graphs
  of the step on the card, as bench.py's run its compiled ``lax.scan``;
  two keys bench.py does not have: ``stress_captured`` (the headline's
  windows replayed graphs) and ``stress_eager_steps_per_sec`` (one
  128-step window of the same settled pile stepped eagerly,
  ``capture=False``, after the captured windows).

``--device cpu`` runs every row on the CPU, where each kernel's plain
PyTorch version runs in its place; the default is the card, and without
one the script exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mgf_tpu_torch.math3d import CUDA

# (warmup, iters, windows, chunk) of bench.py's time_steps rows
SCHEDULE = {
    "balls": (180, 60, 1, 0),
    "capsules": (280, 60, 1, 0),
    "terrain": (120, 40, 1, 0),
    "cold20": (180, 30, 1, 0),
    "mixed": (400, 64, 2, 16),
    "stress": (1600, 128, 3, 64),
}
# the headline's eager window (capture=False) after its captured ones
STRESS_EAGER_STEPS = 128
# bench.py's sizes of the other rows
N_TERRAIN = 10_000
N_GJK_PAIRS = 8192
N_COMPOUND_PARTS = 8192
N_RAYS = 16384


def _barrier(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host_y(world):
    """The completion barrier (bench.py's ``np.asarray``): the card's
    queue drained and the bodies' heights read on the host."""
    _barrier(world.bodies.x.y.device)
    return world.bodies.x.y.cpu().numpy()


def _check_finite(y):
    if np.isnan(y).any():
        raise RuntimeError("NaN in the bodies' positions")


def time_steps(world, cfg, warmup, iters, windows=1, chunk=0, eager_iters=0):
    """Time ``windows`` back-to-back windows of ``iters`` steps after
    ``warmup`` steps, and return (the fastest window's steps/s, the first
    call's seconds, the world, the last step's metrics).

    Every step multiplies the bodies' forces by a nonce, 1 + 1e-6 * (k % 64
    + 1), exactly as bench.py does (there it keeps a memoizing transport
    from replaying steps; here it keeps the physics equal to bench.py's).
    ``chunk`` > 0 runs ``chunk`` steps per call through
    ``driver.make_chunk_step`` (light interior metrics, full metrics on
    each chunk's last step), with the solver schedule chosen on the host by
    ``driver.AdaptiveChunkStepper`` when ``cfg.adapt_schedule`` is set; the
    nonces are pre-staged on the device, and each chunk copies its own
    into the stepper's static nonce buffer (a copy on the card).  On the
    card those chunks replay CUDA graphs of the step
    (``graphs.CapturedStep``); ``time_steps.last_captured`` says whether
    they did.  ``eager_iters`` > 0 then times one more window of that many
    steps from the same world on the same stepper switched to
    ``capture=False`` (the Python loop over ``step``), kept in
    ``time_steps.last_eager_rate``.  The first call's seconds include
    loading (or, without a built library, compiling) the kernels it
    launches and capturing the graphs it meets.  Each window ends in a
    device sync and a host read of the heights; the window rates are kept
    in ``time_steps.last_rates``."""
    from mgf_tpu_torch.world import step

    dev = world.bodies.x.x.device
    if chunk:
        n_warm, n_chunks = -(-warmup // chunk), -(-iters // chunk)
        n_eager = -(-eager_iters // chunk)
        scales = [torch.tensor([1.0 + 1e-6 * ((i * chunk + j) % 64 + 1)
                                for j in range(chunk)], dtype=torch.float32,
                               device=dev)
                  for i in range(max(n_warm, n_chunks, n_eager, 1))]
        from mgf_tpu_torch.driver import AdaptiveChunkStepper, make_chunk_step
        if cfg.adapt_schedule is not None:
            st = AdaptiveChunkStepper(cfg, chunk=chunk, light=True)
            run, fc = st.run_chunk, st.step_chunk
        else:
            run = fc = make_chunk_step(cfg, light=True)
        t0 = time.perf_counter()
        world, m = fc(world, scales[0])
        _barrier(dev)
        compile_s = time.perf_counter() - t0
        for i in range(n_warm):
            world, m = fc(world, scales[i])
        _host_y(world)
        rates = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for i in range(n_chunks):
                world, m = fc(world, scales[i])
            y = _host_y(world)
            dt = time.perf_counter() - t0
            _check_finite(y)
            rates.append(n_chunks * chunk / dt)
        time_steps.last_rates = rates
        time_steps.last_captured = bool(run.captured is not None
                                        and run.captured.graphs)
        if n_eager:
            # the same stepper, schedule state and world, stepped eagerly
            run.capture = False
            w = world
            t0 = time.perf_counter()
            for i in range(n_eager):
                w, _ = fc(w, scales[i])
            _check_finite(_host_y(w))
            time_steps.last_eager_rate = (n_eager * chunk
                                          / (time.perf_counter() - t0))
        return max(rates), compile_s, world, {k: v[-1] for k, v in m.items()}

    def stepped(world, scale):
        b = world.bodies
        world = world._replace(bodies=b._replace(force=b.force * scale))
        return step(world, cfg)

    scales = torch.tensor([np.float32(1.0 + 1e-6 * ((i % 64) + 1))
                           for i in range(max(warmup, iters) + 1)],
                          dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    world, m = stepped(world, scales[0])
    _barrier(dev)
    compile_s = time.perf_counter() - t0
    for i in range(warmup):
        world, m = stepped(world, scales[i])
    _host_y(world)
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for i in range(iters):
            world, m = stepped(world, scales[i])
        y = _host_y(world)
        dt = time.perf_counter() - t0
        _check_finite(y)
        rates.append(iters / dt)
    time_steps.last_rates = rates
    return max(rates), compile_s, world, m


def _penetration_p99(world, cfg):
    """The 99th-percentile penetration over every valid contact (pairs and
    terrain) at the world's state: one ``collect_contacts`` step, its new
    state dropped, the statistic computed on the host as bench.py does."""
    from mgf_tpu_torch.world import step

    _, m = step(world, cfg, collect_contacts=True)
    h = lambda t: t.cpu().numpy()
    pens = []
    for key in ("pair_contacts", "terrain_contacts"):
        if key not in m:
            continue
        c = m[key]["contact"]
        pen = -((h(c.b.x) - h(c.a.x)) * h(c.n.x)
                + (h(c.b.y) - h(c.a.y)) * h(c.n.y)
                + (h(c.b.z) - h(c.a.z)) * h(c.n.z))
        pens.append(np.maximum(pen[h(c.valid)], 0.0))
    if not pens:
        return 0.0
    allp = np.concatenate(pens)
    return float(np.percentile(allp, 99.0)) if allp.size else 0.0


def _first_leaf(tree):
    while not isinstance(tree, torch.Tensor):
        tree = tuple.__getitem__(tree, 0)   # Vec3 indexes its components
    return tree


def _time_op(f, argsets):
    """Seconds per call of ``f`` over pre-staged argument sets: one call
    first, then every set, each output's first element read on the host
    and the device drained (bench.py's barrier)."""
    _first_leaf(f(*argsets[0])).reshape(-1)[:1].cpu()
    dev = _first_leaf(argsets[0]).device
    _barrier(dev)
    t0 = time.perf_counter()
    outs = [f(*a) for a in argsets]
    for o in outs:
        _first_leaf(o).reshape(-1)[:1].cpu()
    _barrier(dev)
    return (time.perf_counter() - t0) / len(argsets)


def bench_obb_arrays(n, rng=None, eps=0.0):
    """One argument set of bench.py's ``bench_gjk_batch`` as float32 numpy
    arrays ((c, q, r), (c, q, r)), drawn from ``rng`` (default: a fresh
    numpy ``default_rng(0)``, giving bench.py's first set): per box 4
    normal quaternion components (normalised in float32, as
    ``qnormalize`` does), 3 centre components U(-1.5, 1.5) + shift + eps
    and 3 half extents U(0.5, 1.0), the second box shifted by +1."""
    rng = np.random.default_rng(0) if rng is None else rng
    f32 = lambda a: np.asarray(a, np.float32)

    def obb(shift):
        q = [f32(rng.standard_normal(n)) for _ in range(4)]
        m2 = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]
        inv = np.float32(1.0) / np.sqrt(m2)
        c = [f32(rng.uniform(-1.5, 1.5, n) + shift + eps) for _ in range(3)]
        r = [f32(rng.uniform(0.5, 1.0, n)) for _ in range(3)]
        return (np.stack(c, -1), np.stack([x * inv for x in q], -1),
                np.stack(r, -1))
    return obb(0.0), obb(1.0)


def obb_pairs(arrays, device):
    """The port's OBB pair from :func:`bench_obb_arrays`' arrays."""
    from mgf_tpu_torch.geom import OBB
    from mgf_tpu_torch.math3d import Quat, Vec3
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return tuple(OBB(c=Vec3(*(t(c[:, k]) for k in range(3))),
                     q=Quat(*(t(q[:, k]) for k in range(4))),
                     r=Vec3(*(t(r[:, k]) for k in range(3))))
                 for c, q, r in arrays)


def bench_gjk_batch(n=8192, iters=10, *, device=CUDA):
    """BASELINE config 4: GJK/EPA contacts between ``n`` OBB pairs, one
    ``gjk.contact_convex_convex`` call per argument set (bench.py's draws:
    numpy seed 0, set i's centres shifted by 1e-5 * i).  Pairs/s."""
    from mgf_tpu_torch.geom import support_obb
    from mgf_tpu_torch.gjk import contact_convex_convex

    rng = np.random.default_rng(0)
    argsets = [obb_pairs(bench_obb_arrays(n, rng, 1e-5 * i), device)
               for i in range(iters)]
    ones = torch.ones(n, dtype=torch.float32, device=device)

    def run(a, b):
        return contact_convex_convex(lambda d: support_obb(a, d),
                                     lambda d: support_obb(b, d), ones)

    return n / _time_op(run, argsets)


def bench_compound_parts(parts):
    """bench.py's compound: numpy seed 1, a centre U(-20, 20)^3 per part,
    even parts spheres of radius 0.5, odd ones capsules along +x of
    radius 0.4."""
    rng = np.random.default_rng(1)
    specs = []
    for i in range(parts):
        c = rng.uniform(-20, 20, 3)
        if i % 2 == 0:
            specs.append(dict(kind="sphere", center=tuple(c), r=0.5))
        else:
            specs.append(dict(kind="capsule", a=tuple(c),
                              d=(1.0, 0.0, 0.0), r=0.4))
    return specs


def bench_compound_batch(parts=8192, iters=10, *, device=CUDA):
    """BASELINE config 3: a compound of ``parts`` parts against a polygon
    face (``compound.compound_contacts_polygon``, a rectangle of half
    widths 25 at y = -21), the compound moving at (0, -3 - 1e-5 * i, 0) in argument set
    i.  Part tests/s."""
    from mgf_tpu_torch.compound import (
        compound_contacts_polygon, compound_from_parts,
    )
    from mgf_tpu_torch.geom import Rectangle
    from mgf_tpu_torch.math3d import vec3

    comp = compound_from_parts(bench_compound_parts(parts), device=device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    rect = Rectangle(c=vec3(0.0, -21.0, 0.0, device=device),
                     u0=vec3(1.0, 0.0, 0.0, device=device),
                     u1=vec3(0.0, 0.0, 1.0, device=device),
                     e0=f32(25.0), e1=f32(25.0))
    argsets = [(comp, vec3(0.0, -3.0 - 1e-5 * i, 0.0, device=device))
               for i in range(iters)]
    return parts / _time_op(
        lambda comp, v: compound_contacts_polygon(comp, rect, v), argsets)


def bench_rays(state, rays, iters):
    """bench.py's ray argument sets against ``state``: numpy seed 3; set i
    draws x, y, z U(-side, side) + 1e-4 * i (y then replaced by the pile's
    top + 2) and directions (U(-0.3, 0.3), -1, U(-0.3, 0.3)).  A list of
    (p, d) Vec3 pairs on the state's device."""
    from mgf_tpu_torch.math3d import Vec3
    dev = state.x.x.device
    rng = np.random.default_rng(3)
    side = float(state.x.x.max())
    top = float(state.x.y.max())
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    out = []
    for i in range(iters):
        px, _, pz = (rng.uniform(-side, side, rays) + 1e-4 * i
                     for _ in range(3))
        p = Vec3(t(px), t(np.full(rays, np.float32(top + 2.0))), t(pz))
        d = Vec3(t(rng.uniform(-0.3, 0.3, rays)), t(np.full(rays, -1.0)),
                 t(rng.uniform(-0.3, 0.3, rays)))
        out.append((p, d))
    return out


def ray_mismatch(grid_out, dense_out):
    """bench.py's count of rays whose grid and dense casts disagree: hit
    differs, or both hit and t differs by more than 1e-3."""
    (ig, _), (i_d, _) = grid_out, dense_out
    hg, hd = ig.hit.cpu().numpy(), i_d.hit.cpu().numpy()
    tg, td = ig.t.cpu().numpy(), i_d.t.cpu().numpy()
    tdiff = np.where(hg & hd, tg - np.where(hd, td, 0.0), 0.0)
    return int(np.sum((hg != hd) | (np.abs(tdiff) > 1e-3)))


def bench_raytrace(world, rays=16384, iters=8):
    """Downward rays into the pile, through the body grid's DDA
    (``queries.raytrace_bodies_grid``; cell 1.25, dims (128, 8, 128), cap
    24, bench.py's sizing for the settled pile) and the dense scan
    (``queries.raytrace_bodies``).  Returns (grid rays/s, dense rays/s,
    the grid's overflow, grid/dense mismatches on the first set)."""
    from mgf_tpu_torch.queries import (
        build_body_grid, raytrace_bodies, raytrace_bodies_grid,
    )

    state = world.bodies
    argsets = bench_rays(state, rays, iters)
    grid = build_body_grid(state, cell_size=1.25, dims=(128, 8, 128),
                           cap=24)
    fg = lambda p, d: raytrace_bodies_grid(grid, p, d)
    fd = lambda p, d: raytrace_bodies(state, p, d)
    sec_g = _time_op(fg, argsets)
    sec_d = _time_op(fd, argsets)
    mism = ray_mismatch(fg(*argsets[0]), fd(*argsets[0]))
    return rays / sec_g, rays / sec_d, int(grid.overflow), mism


def escaped_bodies(world, floor=-1.0):
    """Bodies below y = ``floor`` or outside the scene's walls (the
    terrain's x/z extent)."""
    b, t = world.bodies, world.terrain
    wall = max(float(c.abs().max()) for v in t for c in (v.x, v.z))
    out = (b.x.y < floor) | (b.x.x.abs() > wall) | (b.x.z.abs() > wall)
    return int(out.sum())


def launch_counters():
    """(kernel, module, attribute) of each hand-written kernel's launch
    count."""
    from mgf_tpu_torch.ops import (
        narrowphase, sequential_solve, solver_sweep, terrain,
    )
    return (("K1", solver_sweep, "LAUNCHES"), ("K2", narrowphase, "LAUNCHES"),
            ("K3", solver_sweep, "BLOCKMAJOR_LAUNCHES"),
            ("K4", sequential_solve, "LAUNCHES"),
            ("K5", terrain, "LAUNCHES"))


@contextlib.contextmanager
def _row(name, launches):
    """Count the kernels' launches of one row into ``launches[name]`` and
    report the row's wall seconds on stderr."""
    for _, mod, attr in launch_counters():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    yield
    launches[name] = {k: getattr(mod, attr)
                      for k, mod, attr in launch_counters()}
    print(f"bench_torch: row {name} done in {time.perf_counter() - t0:.1f} "
          f"s", file=sys.stderr, flush=True)


def card_line(dev):
    """nvidia-smi's name and power limit of the card (or "cpu")."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def run(args, dev):
    """bench.py's rows; returns (secondary dict, headline dict, launches
    by row)."""
    from mgf_tpu_torch.scenes import (
        balls_scene, capsules_scene, stress_scene, terrain_scene,
    )
    from mgf_tpu_torch.world import step

    secondary, launches = {}, {}
    if not args.quick:
        with _row("balls", launches):
            w, cfg = balls_scene(device=dev)
            sps, comp, _, m = time_steps(w, cfg, *SCHEDULE["balls"])
            secondary["balls_1332_steps_per_sec"] = sps
            secondary["balls_compile_s"] = comp
        with _row("capsules", launches):
            w, cfg = capsules_scene(device=dev)
            sps, comp, _, m = time_steps(w, cfg, *SCHEDULE["capsules"])
            secondary["capsules_1331_steps_per_sec"] = sps
            secondary["capsules_compile_s"] = comp
        with _row("terrain", launches):
            # BASELINE config 3 as a world: 10k mixed bodies raining on the
            # 10,368-triangle heightfield, terrain culled by the face grid
            w, cfg = terrain_scene(n_bodies=N_TERRAIN, device=dev)
            sps, comp, _, m = time_steps(w, cfg, *SCHEDULE["terrain"])
            secondary["terrain_10k_steps_per_sec"] = sps
            secondary["terrain_10k_contacts"] = int(m["num_contacts"])
        with _row("gjk", launches):
            secondary["gjk_obb_pairs_per_sec"] = bench_gjk_batch(
                N_GJK_PAIRS, device=dev)
        with _row("compound", launches):
            secondary["compound_part_tests_per_sec"] = bench_compound_batch(
                N_COMPOUND_PARTS, device=dev)

    n = args.bodies or (10_000 if args.quick else 100_000)
    if not args.quick:
        with _row("cold20", launches):
            # the reference's solver semantics on the same scene:
            # accumulators zeroed every frame, 20 two-phase sweeps
            w, cfg = stress_scene(n, device=dev)
            cfg = cfg._replace(warm_start=False, fused_iso=False,
                               warm_match="search", adapt_schedule=None,
                               solver_iters=20, solver_inner=1,
                               two_phase=True)
            sps, comp, _, m = time_steps(w._replace(warm=None), cfg,
                                         *SCHEDULE["cold20"])
            secondary["stress_cold20_steps_per_sec"] = sps
            secondary["stress_cold20_max_penetration"] = float(
                m["max_penetration"])
        if not args.mixed:
            with _row("mixed", launches):
                w, cfg = stress_scene(n, mixed=True, device=dev)
                sps, comp, wm, m = time_steps(w, cfg, *SCHEDULE["mixed"])
                secondary["stress_mixed_steps_per_sec"] = sps
                secondary["stress_mixed_max_penetration"] = float(
                    m["max_penetration"])
                secondary["stress_mixed_compile_s"] = comp
                secondary["stress_mixed_p99_penetration"] = _penetration_p99(
                    wm, cfg)
                if cfg.bp_every > 1:
                    secondary["stress_mixed_bp_drift_excess"] = float(
                        m["broadphase_cache_drift_excess"])

    with _row("stress", launches):
        # the headline at the SETTLED pile: 1,600 steps of warm-up, as
        # bench.py (the 12-layer pile goes on consolidating long past the
        # nominal settle), chunks of 64 with the host-chosen schedule
        w, cfg = stress_scene(n, mixed=args.mixed, device=dev)
        sps, comp, world, m = time_steps(w, cfg, *SCHEDULE["stress"],
                                         eager_iters=STRESS_EAGER_STEPS)
        secondary["stress_chunk"] = SCHEDULE["stress"][3]
        secondary["stress_captured"] = time_steps.last_captured
        secondary["stress_eager_steps_per_sec"] = time_steps.last_eager_rate
        secondary["stress_host_adaptive"] = cfg.adapt_schedule is not None
        secondary["stress_light_interior_metrics"] = True
        secondary["stress_steps_per_sec_mean3"] = float(
            np.mean(time_steps.last_rates))
        secondary["stress_compile_s"] = comp
        secondary["stress_num_contacts"] = int(m["num_contacts"])
        secondary["stress_broadphase_overflow"] = int(
            m["broadphase_overflow"])
        secondary["stress_max_penetration"] = float(m["max_penetration"])
    if cfg.bp_every > 1:
        with _row("stress_rebuild_cycle", launches):
            # the rebuild cadence engaged in the measured regime: the next
            # 2 * bp_every single steps
            reb = 0
            for _ in range(2 * cfg.bp_every):
                world, m2 = step(world, cfg)
                reb += int(m2["broadphase_rebuilt"])
            secondary["stress_bp_rebuilds_per_cycle"] = reb / 2.0
            secondary["stress_bp_drift_excess"] = float(
                m2["broadphase_cache_drift_excess"])
    # candidate pairs tested per second
    secondary["narrowphase_pair_tests_per_sec"] = float(
        m["num_constraints"]) * sps

    if not args.quick:
        with _row("raytrace", launches):
            sps_g, sps_d, ovf, mism = bench_raytrace(world, N_RAYS)
            secondary["raytrace_grid_rays_per_sec"] = sps_g
            secondary["raytrace_dense_rays_per_sec"] = sps_d
            secondary["raytrace_grid_overflow"] = ovf
            secondary["raytrace_grid_mismatch"] = mism

    headline = {
        "metric": (f"physics steps/sec at {n} "
                   + ("mixed sphere/capsule bodies" if args.mixed
                      else "spheres") + " (stress scene)"),
        "value": sps,
        "unit": "steps/s",
        "vs_baseline": None,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    return secondary, headline, launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="10k bodies, the headline row only")
    ap.add_argument("--full", action="store_true",
                    help="accepted as bench.py accepts it; the capsules "
                         "row runs without it, as in bench.py")
    ap.add_argument("--bodies", type=int, default=None,
                    help="the stress pile's bodies (default 100,000; "
                         "10,000 with --quick)")
    ap.add_argument("--mixed", action="store_true",
                    help="the headline on the mixed sphere/capsule pile")
    ap.add_argument("--cold-cache", action="store_true",
                    help="build the CUDA kernels into a fresh temporary "
                         "directory, so compile_s includes nvcc")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("bench_torch: no CUDA device (torch.cuda.is_available() "
                 "is false); pass --device cpu to run on the CPU")
    with contextlib.ExitStack() as stack:
        if args.cold_cache:
            from mgf_tpu_torch.ops import _build
            tmp = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="mgf_tpu_torch_cold_"))
            stack.callback(_build.set_build_dir, _build.build_dir())
            _build.set_build_dir(tmp)
        print(card_line(dev), flush=True)
        secondary, headline, launches = run(args, dev)
    print(f"launches by row {json.dumps(launches)}", file=sys.stderr)
    print(json.dumps(secondary), file=sys.stderr, flush=True)
    print(json.dumps(headline), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
