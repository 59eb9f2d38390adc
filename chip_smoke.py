"""Smoke run of mgf_tpu_torch on one NVIDIA GPU: build the kernels, check
them, drive the flagship path, the generic sphere branch, the mixed
sphere/capsule pile, the capsules demo, the reference's flat solvers and
the heightfield terrain scene, and check what comes out.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

1. the device: torch's name for it and nvidia-smi's name and power limit;
2. build every kernel source (ops/csrc/*.cu) with nvcc, one process per
   source, all started together, timed;
3. K1 against its plain PyTorch version at the flagship shapes (R=12 rows,
   N=100,000 bodies, 4 and 6 inner sweeps, warm accumulators) in both
   modes: term mode (the frozen partner term given) and gather mode (K=9
   pair rows gathered in the kernel from neighbour partners, invalid rows
   out of range), with both times from CUDA events; tolerance atol 2e-4 /
   rtol 1e-4 on the state and on the accumulators of valid rows; beside
   them the time of the torch launches gather mode replaced in each outer
   iteration (gather, term, zero rows, stack, the state's cat).  Every
   kernel time in this script is the median of 5 blocks of 20 calls after
   a warm-up, printed with the fastest and the slowest block; the card
   spins before each block so that the launches are queued when it starts
   and the time is the device's, not the host's pace of issuing them;
4. the main path: stress_scene(100_000) stepped 128 steps by
   AdaptiveChunkStepper(chunk=16, light=True), with the physics guards
   checked and K1's launch count held to the solver's outer iterations
   (one gather-mode launch per outer iteration)
   (every kernel's count is set to 0 before each path, [4], [7], [8],
   [11], [13], [15], [16] and [17], and read after it; the kernels line
   sums them);
5. kernel path against plain path end to end: an 8,000-body pile stepped
   40 steps on the card, copied to the CPU, then one more step on each;
6. K2 against its plain version at P = 900,000 pairs (the cold pile's 9
   slots x 100k), random blocks plus one row per branch of the kernel;
   valid exactly, t and n atol 1e-4, witness points atol 1e-3;
7. the generic branch at full size: the cold reference-schedule pile
   (stress_scene(100_000), warm starting off, 20 two-phase sweeps, K2 on)
   stepped 64 steps, with its guards and K2's launches held to the steps;
8. the demo balls_scene(11) (1,332 bodies, packed grid, dense terrain,
   K2 on) stepped 280 steps, with its guards and K2's launches; its grid
   overflows while the block lands, as mgf_tpu's does on the same scene
   (test_demo_overflow_series_matches_jax in
   tests/test_torch_world_generic.py): at most 96 bodies in a step, and
   none from step 201 on;
9. the generic branch on the card against the CPU: one more demo step on
   each, contact counts within 0.1 %, v and omega within 1e-3 on every
   body whose contact set is the same in both runs;
10. K3 (K1's kernel over the block-major layout) against its plain version
    at R=12, N=100,352, block 512/1024/2048, inner 1 and 8, timed beside
    K1 on the same data;
11. the mixed pile at full width: stress_scene(100_000, mixed=True)
    (75,000 spheres, then 25,000 capsules; the type-partitioned
    narrowphase, two chained block solves, the hybrid warm match at 24
    rows) stepped 128 steps by AdaptiveChunkStepper(chunk=16, light=True):
    finite state, drift excess 0 in every step, contacts, no body below
    y = -1 or outside the walls, and no launch of K1, K2 or K3 (this path
    runs no hand-written kernel, as in the JAX package).  Two guards are
    set at what mgf_tpu's own mixed pile meets over the same 128 steps
    (test_mixed_reference_meets_smoke_guard in
    tests/test_torch_world_mixed.py at 2,000 bodies;
    scripts/mixed_reference_guards.py at 8,000 and 30,000): max penetration
    < 0.5 at the LAST step (the reference passes 0.5 during the collapse),
    and a bucket overflow of at most 0.05 % of the bodies in any step (the
    reference's grid, cell 2.0 and cap 14, drops 1 body of 2,000 and 3 of
    30,000 on its worst step; it is not 0 there either);
12. the mixed step on the card against the CPU: an 8,000-body mixed pile
    after 40 card steps, one more step on each from the same state; equal
    contact counts per class (sphere-sphere, sphere-capsule,
    capsule-capsule, terrain), v and omega within 1e-4;
13. the demo capsules_scene(11) (1,331 capsules, Mat3 inertia, 20
    two-phase sweeps) stepped 280 steps: finite state, overflow 0,
    contacts, and the count of capsules at rest inside the box beside the
    count that missed it and go on falling, as in the reference demo;
14. K4 (the sequential Gauss-Seidel solve, one CUDA block) against its
    plain PyTorch version on the card, on the constraint list of the
    126-body balls_scene(5) landing step, 20 sweeps, both friction modes
    (atol 1e-4, rtol 1e-5); K4 timed there (mgf friction) and, after
    [15], at the full demo's list (its mgf friction), with the bound of
    the mode timed; there it is also held against the plain version run on
    CPU copies of the inputs (on the card the plain version makes ~60
    launches per point update, ~3 M per solve at the demo's size: it is
    timed at the small size only);
15. the demo on the reference's sequential solver: balls_scene(11,
    solver="sequential") with the raw-lambda friction and K2 on, 280 steps:
    steps/s over the last 80, contacts, max penetration at the last step,
    the overflow series, K4 and K2 launches (one each per step); finite
    state, no body out of the demo box (floor y = -10, walls |x|, |z| = 10);
    the overflow and penetration guards at what mgf_tpu's own sequential
    demo meets on the CPU (scripts/mixed_reference_guards.py --balls): at
    most 32 bodies in a step of steps 1-200 and none later, max
    penetration < 1.0 at the last step (mgf_tpu 0.8417);
16. the same demo on the mass-split parallel solver (the demo's textbook
    friction), 280 steps, the same prints and guards at mgf_tpu's parallel
    run (at most 96 bodies, max penetration < 1.0; mgf_tpu 0.8417); K4
    launches 0;
17. terrain_scene() at its defaults: 10,000 spheres and capsules (a quarter
    capsules) raining onto the 10,368-face heightfield (face grid dim 64,
    cap 16; solver_rows 14), 240 steps from scratch (the rain reaches the
    heightfield after ~160): steps/s over steps 161-240, contacts by class
    at the last step, max penetration, solver_rows_dropped, the face grid's
    overflow (from a rebuild checked equal to the face table the step
    reads) and terrain_reach_excess; finite state, overflow 0,
    terrain_reach_excess 0 on every step, no body below y = -4 or above its
    start, terrain contacts > 0, max penetration < 0.8 at the last step
    (tests/test_terrain.py's bar; mgf_tpu meets it at 2,000 and 10,000
    bodies, scripts/mixed_reference_guards.py --terrain), and no launch of
    K1-K4 (this path runs no hand-written kernel, as in the JAX package);
18. the terrain step on the card against the CPU: terrain_scene(2_000)
    after 100 card steps (the rain on the heightfield), one more step on
    each: equal contact counts per class, v within 1e-5, omega within 1e-4;
19. a JSON line of per-kernel results, then the result line.

Needs a CUDA card; it exits non-zero without one, and imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL = dict(atol=2e-4, rtol=1e-4)
N_MAIN = 100_000      # the flagship pile
N_E2E = 8_000         # the end-to-end kernel-vs-plain pile
N_K3 = 100_352        # K3's micro-bench width (512 | N)
# the mixed pile's bucket overflow in any step, as a share of the bodies:
# mgf_tpu's own worst step at 2,000 bodies (1 body)
MIXED_OVERFLOW_SHARE = 0.0005

# The least time for a kernel's work: the larger of its bytes (each input
# read once, each output written once) over the H100 SXM's 3.35 TB/s and
# its float32 operations over the 67 TFLOP/s outside the tensor cores
# (NVIDIA's data sheet, 700 W).  Operations per unit of work are counted
# from the kernel sources.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K1_OPS_PER_ROW_SWEEP = 83     # dv, friction, normal, impulse, sums
K1_OPS_PER_COL_SWEEP = 12     # the velocity update
K1_OPS_PER_GATHER_ROW = 12    # gather mode: vb + wb x rb, once per call
K2_OPS_PER_PAIR = 170
# one point update of sequential_solve.cu by friction mode: 220 float32
# operations in both (two relative velocities, the normal impulse, four
# impulse applications with a Mat3 product each), then the raw lambda's 2
# adds ("mgf") or the clamp's mul, 2 x (add, max, min) and 2 subs
# ("textbook"); a negation folds into its consumer's operand and is not
# counted
K4_OPS_PER_UPDATE = {"mgf": 222, "textbook": 229}
K4_TOL = dict(atol=1e-4, rtol=1e-5)
N_TERRAIN = 10_000            # terrain_scene's default rain
N_TERRAIN_E2E = 2_000
# the demos on the flat solvers, at what mgf_tpu's own runs of the same
# 280 steps meet on the CPU (scripts/mixed_reference_guards.py --balls
# sequential|parallel): bucket overflow in its worst step of steps 1-200
# (none later) and max penetration at the last step (0.8417 for both; the
# peaks 0.9671 at step 170 and 0.9761 at step 179)
FLAT_OVERFLOW_LANDING = {"sequential": 32, "parallel": 96}
FLAT_PEN_LAST = {"sequential": 1.0, "parallel": 1.0}


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by) for work of ``n_bytes`` and ``n_ops``."""
    t_b = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_o = 1e3 * n_ops / F32_OPS_PER_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def sweep_bound(R, N, inner, K=None):
    """K1/K3 in term mode: S, fields, term, self_p, acc in; S', acc' out.
    Gather mode (``K`` pair rows, an (8, N) state): the K rows' partner
    index and rb in place of the term."""
    term_rows = 3 if K is None else 0
    gather = 0 if K is None else K * N
    n_bytes = 4 * ((8 + 2 + 8) * N + (18 + 3 + 3 + term_rows) * R * N
                   + 4 * gather)
    n_ops = (inner * (K1_OPS_PER_ROW_SWEEP * R * N + K1_OPS_PER_COL_SWEEP * N)
             + K1_OPS_PER_GATHER_ROW * gather)
    return bound(n_bytes, n_ops)


def _launch_counters():
    """(kernel, module, attribute) of each kernel's launch count."""
    from mgf_tpu_torch.ops import narrowphase, sequential_solve, solver_sweep
    return (("K1", solver_sweep, "LAUNCHES"), ("K2", narrowphase, "LAUNCHES"),
            ("K3", solver_sweep, "BLOCKMAJOR_LAUNCHES"),
            ("K4", sequential_solve, "LAUNCHES"))


def _zero_counts():
    torch.cuda.synchronize()
    for _, mod, attr in _launch_counters():
        setattr(mod, attr, 0)


def _counts():
    torch.cuda.synchronize()
    return {k: getattr(mod, attr) for k, mod, attr in _launch_counters()}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _flagship_rows(R, N, dev, seed=0):
    """A random self-consistent row system as in
    tests/test_solver_sweep.py (unit normals, orthonormal tangents, masses
    in [0.2, 1]), with the effective masses divided by each column's count
    of valid rows — the mass splitting the flagship's constraint build
    applies, without which 12 Jacobi rows per body overshoot and amplify
    rounding noise sweep after sweep."""
    rng = np.random.default_rng(seed)
    nrm = rng.standard_normal((3, R, N))
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    helper = np.broadcast_to(np.asarray([1.0, 0.1, -0.2])[:, None, None],
                             nrm.shape)
    t1 = np.cross(nrm, helper, axis=0)
    t1 /= np.linalg.norm(t1, axis=0, keepdims=True)
    t2 = np.cross(nrm, t1, axis=0)
    valid = rng.uniform(size=(1, R, N)) < 0.7
    count = np.maximum(valid.sum(axis=1, keepdims=True), 1)
    fields = np.concatenate([
        nrm, t1, t2, rng.standard_normal((3, R, N)) * 0.4,
        rng.uniform(0.2, 0.8, (1, R, N)), rng.uniform(-0.5, 1.5, (1, R, N)),
        rng.uniform(0.2, 1.0, (3, R, N)) / count, valid], axis=0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    S = np.zeros((8, N))
    S[:6] = rng.standard_normal((6, N))
    S[3:6] *= 0.3
    return (t(S), t(fields), t(rng.standard_normal((3, R, N)) * 0.5),
            t(np.stack([rng.uniform(0.5, 1.5, N), rng.uniform(0.5, 2.0, N)])),
            t(rng.uniform(0.0, 0.3, (3, R, N)))), t(valid[0]).bool()


class Ms(float):
    """A time in ms: the median over the timed blocks, with the fastest and
    the slowest block beside it."""
    lo = hi = 0.0

    def __str__(self):
        return (f"{float(self):.4f} ms (min {self.lo:.4f}, max "
                f"{self.hi:.4f})")


# the card spins this long before each timed block (~10 ms at 1.98 GHz), so
# that the host has the block's launches queued before the first one runs
SPIN_CYCLES = 20_000_000


def _time_ms(fn, reps=20, blocks=5):
    """Median per-call DEVICE time over ``blocks`` blocks of ``reps`` calls,
    each block between two CUDA events, after a warm-up block.  A wrapper
    whose kernel takes less than the host needs to issue it (K2: ~30 us of
    kernel behind two allocations, a ctypes call and a dozen views) would
    otherwise be timed at the host's pace, which moves 2x with the load on
    a shared host: the device first spins, the launches queue up behind it,
    and the events see them run back to back."""
    for _ in range(reps):
        fn()
    times = []
    for _ in range(blocks):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    ms = Ms(float(np.median(times)))
    ms.lo, ms.hi = min(times), max(times)
    return ms


def _flagship_partners(valid, K, dev, seed=0):
    """(R, N) int32 row partners and (3, K, N) partner contact points for
    gather mode: each of the K pair rows points at a neighbour of the
    column in stress_scene's initial block (index i * side * 12 + j * 12 +
    k, side 92), rows that are not valid at N (out of range, as the
    flagship's invalid pair rows)."""
    R, N = valid.shape
    rng = np.random.default_rng(seed)
    offs = np.asarray([dk + 12 * dj + 12 * 92 * di for di in (-1, 0, 1)
                       for dj in (-1, 0, 1) for dk in (-1, 0, 1)
                       if (di, dj, dk) != (0, 0, 0)])
    partner = (np.arange(N)[None, :] + rng.choice(offs, (R, N))) % N
    partner[~valid.cpu().numpy()] = N
    rb = rng.standard_normal((3, K, N)) * 0.4
    return (torch.as_tensor(partner.astype(np.int32), device=dev),
            torch.as_tensor(rb.astype(np.float32), device=dev))


def _replaced_glue(ss, S, index, rb, R):
    """The torch launches that ran around K1 in each outer iteration before
    the gather moved into the kernel: the row-major partner gather, the
    term, the zero tail rows, the stack, the state's slice and its cat
    after the kernel (the slice's copy is free where M = N)."""
    term = torch.stack(ss.partner_term(S, index, rb, R))
    n = term.shape[-1]
    return torch.cat([S[:, :n].contiguous(), S[:, n:]], dim=1), term


def phase_kernel(ss, dev):
    R, N, K = 12, N_MAIN, 9
    args, valid = _flagship_rows(R, N, dev)
    partner, rb = _flagship_partners(valid, K, dev)
    S, fields, _, self_p, acc = args
    gargs = (S, fields, partner, rb, self_p, acc)
    index = ss.partner_index(partner, K, N)
    glue_ms = _time_ms(lambda: _replaced_glue(ss, S, index, rb, R))
    out = {}
    for mode in ("term", "gather"):
        for inner in (4, 6):
            if mode == "term":
                run = lambda: ss.inner_sweeps(*args, inner)
                plain = lambda: ss.inner_sweeps_reference(*args, inner)
                b_ms, b_by = sweep_bound(R, N, inner)
            else:
                run = lambda: ss.inner_sweeps_gather(*gargs, inner, K)
                plain = lambda: ss.inner_sweeps_gather_reference(
                    *gargs, inner, K)
                b_ms, b_by = sweep_bound(R, N, inner, K)
            (s_k, a_k), (s_p, a_p) = run(), plain()
            torch.cuda.synchronize()
            err_s = float((s_k - s_p).abs().max())
            err_a = float((a_k - a_p).abs()[:, valid].max())
            torch.testing.assert_close(s_k, s_p, **TOL)
            torch.testing.assert_close(a_k[:, valid], a_p[:, valid], **TOL)
            ms = _time_ms(run)
            plain_ms = _time_ms(plain)
            out[(mode, inner)] = dict(err=max(err_s, err_a), ms=ms,
                                      plain_ms=plain_ms, bound_ms=b_ms,
                                      bound_by=b_by)
            print(f"[3] K1 {mode} mode R={R} N={N} inner={inner}: "
                  f"max_abs_err state {err_s:.3g} acc {err_a:.3g} (atol "
                  f"2e-4, rtol 1e-4); kernel {ms}, plain "
                  f"{plain_ms}, bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
    print(f"[3] the torch launches gather mode replaced, per outer "
          f"iteration (K={K}): {glue_ms}", flush=True)
    return out


def phase_main_path(dev):
    from mgf_tpu_torch.driver import AdaptiveChunkStepper
    from mgf_tpu_torch.scenes import stress_scene
    world, cfg = stress_scene(N_MAIN, device=dev)
    chunk, n_chunks = 16, 8
    st = AdaptiveChunkStepper(cfg, chunk=chunk, light=True)
    it2 = int(cfg.adapt_schedule[1])
    expected = 0
    chunk_s, last, rebuilds = [], None, 0
    overflow, drift = 0, 0.0
    _zero_counts()
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        world, m = st.step_chunk(world)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        expected += chunk * (it2 if st.hot_on else cfg.solver_iters)
        rebuilds += int(m["broadphase_rebuilt"].sum())
        overflow = max(overflow, int(m["broadphase_overflow"].max()))
        drift = max(drift, float(m["broadphase_cache_drift_excess"].max()))
        last = {k: v[-1] for k, v in m.items()}
    counts = _counts()
    launches = counts["K1"]
    b = world.bodies
    finite = all(bool(torch.isfinite(c).all())
                 for c in (*b.x, *b.v, *b.omega))
    steps = chunk * n_chunks
    sps_all = steps / sum(chunk_s)
    sps_late = chunk * (n_chunks - 2) / sum(chunk_s[2:])
    contacts = int(last["num_contacts"])
    pen = float(last["max_penetration"])
    hit = float(last["warm_hit_frac"])
    print(f"[4] main path stress_scene({N_MAIN}) {steps} steps, chunk "
          f"{chunk}: {sps_late:.2f} steps/s (chunks 3-{n_chunks}; "
          f"{sps_all:.2f} incl. first two), contacts {contacts}, max "
          f"penetration {pen:.4f}, rebuilds {rebuilds}, warm_hit_frac "
          f"{hit:.4f}, overflow {overflow}, drift excess {drift}, K1 "
          f"launches {launches} (expected {expected})", flush=True)
    check(finite, "non-finite x, v or omega")
    check(overflow == 0, f"broadphase overflow {overflow}")
    check(drift == 0.0, f"broadphase drift excess {drift}")
    check(contacts > 0, "no contacts")
    check(pen < 0.5, f"max penetration {pen}")
    check(launches == expected and launches > 0,
          f"K1 launches {launches} != solver outer iterations {expected}")
    return counts


def phase_end_to_end(dev):
    from mgf_tpu_torch import world_from_numpy, world_to_numpy
    from mgf_tpu_torch.scenes import stress_scene
    from mgf_tpu_torch.world import step
    world, cfg = stress_scene(N_E2E, device=dev)
    for _ in range(40):
        world, _ = step(world, cfg)
    one = cfg._replace(adapt_schedule=None)
    w_cpu = world_from_numpy(world_to_numpy(world), "cpu")
    w_g, m_g = step(world, one)
    w_c, m_c = step(w_cpu, one)
    n_g, n_c = int(m_g["num_contacts"]), int(m_c["num_contacts"])
    err = max(float((a.cpu() - b).abs().max())
              for f in ("v", "omega")
              for a, b in zip(getattr(w_g.bodies, f), getattr(w_c.bodies, f)))
    print(f"[5] {N_E2E}-body pile after 40 card steps, one more step: contacts "
          f"card {n_g} / cpu {n_c}; max |dv|,|domega| {err:.3g} "
          f"(atol 1e-3)", flush=True)
    check(n_c > 0 and abs(n_g - n_c) <= 0.001 * n_c,
          f"contact counts {n_g} vs {n_c}")
    check(err <= 1e-3, f"v/omega differ by {err}")


def _edge_blocks():
    """One (8,) column pair per branch of K2: coincident centres with
    v = 0 and with v != 0, overlap, a sweep hit at t = 2/3, a miss
    (disc < 0), a separating pair, a hit beyond t = 1."""
    col = lambda x, d, r: [*x, *d, r, 0.0]
    a0 = col((0, 0, 0), (0, 0, 0), 0.5)
    rows = [(a0, col((0, 0, 0), (0, 0, 0), 0.5)),
            (a0, col((0, 0, 0), (0.3, -0.1, 0.2), 0.5)),
            (a0, col((0.6, 0.2, 0), (0, 0, 0), 0.5)),
            (a0, col((2.0, 0, 0), (-1.5, 0, 0), 0.5)),
            (a0, col((2.0, 3.0, 0), (-1.5, 0, 0), 0.5)),
            (a0, col((2.0, 0, 0), (1.0, 0.5, 0), 0.5)),
            (a0, col((5.0, 0, 0), (-1.0, 0, 0), 0.5))]
    f = lambda side: np.asarray([r[side] for r in rows], np.float32).T
    return f(0), f(1), [False, True, True, True, False, False, False]


def phase_k2(nph, dev, P=9 * N_MAIN):
    rng = np.random.default_rng(0)
    ga = rng.standard_normal((8, P)).astype(np.float32)
    gb = rng.standard_normal((8, P)).astype(np.float32)
    ga[6] = np.abs(ga[6]) + 0.1
    gb[6] = np.abs(gb[6]) + 0.1
    ea, eb, want = _edge_blocks()
    ga[:, :ea.shape[1]] = ea
    gb[:, :eb.shape[1]] = eb
    ga, gb = (torch.as_tensor(x, device=dev) for x in (ga, gb))
    ck = nph.sphere_contact_pairs(ga, gb)
    cp = nph.sphere_contact_pairs_reference(ga, gb)
    torch.cuda.synchronize()
    check(torch.equal(ck.valid, cp.valid), "K2 valid differs from plain")
    check(cp.valid[:len(want)].tolist() == want,
          f"K2 edge rows valid {cp.valid[:len(want)].tolist()}")
    v = cp.valid
    err_tn = max(float((a[v] - b[v]).abs().max())
                 for a, b in zip([*ck.n, ck.t], [*cp.n, cp.t]))
    err_p = max(float((a[v] - b[v]).abs().max())
                for a, b in zip([*ck.a, *ck.b], [*cp.a, *cp.b]))
    check(err_tn <= 1e-4, f"K2 t/n differ by {err_tn}")
    check(err_p <= 1e-3, f"K2 witness points differ by {err_p}")
    ms = _time_ms(lambda: nph.sphere_contact_pairs(ga, gb))
    plain_ms = _time_ms(lambda: nph.sphere_contact_pairs_reference(ga, gb))
    # rows 0-6 of each input (row 7 is not read), [ca cb t valid] and n out
    b_ms, b_by = bound(4 * (7 + 7 + 8 + 3) * P, K2_OPS_PER_PAIR * P)
    print(f"[6] K2 P={P}: valid equal ({int(v.sum())} valid), max_abs_err "
          f"t/n {err_tn:.3g} (atol 1e-4) points {err_p:.3g} (atol 1e-3); "
          f"kernel {ms}, plain {plain_ms}, bound {b_ms:.4f} ms ({b_by})",
          flush=True)
    return dict(err=max(err_tn, err_p), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


def _finite(world):
    b = world.bodies
    return all(bool(torch.isfinite(c).all()) for c in (*b.x, *b.v, *b.omega))


def _run_chunks(run, world, n_chunks, chunk):
    """Step ``n_chunks`` chunks; per-chunk wall seconds, rebuilds, the
    per-step overflow series, the worst drift excess, and the last step's
    metrics."""
    chunk_s, rebuilds, overflow, drift, last = [], 0, [], 0.0, None
    ones = torch.ones((chunk,), dtype=torch.float32,
                      device=world.bodies.x.x.device)
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        world, m = run(world, ones)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        rebuilds += int(m["broadphase_rebuilt"].sum())
        overflow += m["broadphase_overflow"].tolist()
        drift = max(drift, float(m["broadphase_cache_drift_excess"].max()))
        last = {k: v[-1] for k, v in m.items()}
    return world, chunk_s, rebuilds, overflow, drift, last


def phase_cold_path(dev):
    from mgf_tpu_torch.driver import make_chunk_step
    from mgf_tpu_torch.scenes import stress_scene
    world, cfg = stress_scene(N_MAIN, device=dev)
    cfg = cfg._replace(warm_start=False, fused_iso=False,
                       warm_match="search", adapt_schedule=None,
                       solver_iters=20, solver_inner=1, two_phase=True,
                       pallas_narrowphase=True)
    world = world._replace(warm=None)
    chunk, n_chunks = 16, 4
    _zero_counts()
    world, chunk_s, rebuilds, overflow, drift, last = _run_chunks(
        make_chunk_step(cfg, light=True), world, n_chunks, chunk)
    counts = _counts()
    launches = counts["K2"]
    overflow = max(overflow)
    steps = chunk * n_chunks
    sps_late = chunk * (n_chunks - 1) / sum(chunk_s[1:])
    contacts = int(last["num_contacts"])
    pen = float(last["max_penetration"])
    print(f"[7] cold reference-schedule pile stress_scene({N_MAIN}), 20 "
          f"two-phase sweeps, {steps} steps: {sps_late:.2f} steps/s (steps "
          f"17-{steps}), contacts {contacts}, max penetration {pen:.4f}, "
          f"rebuilds {rebuilds}, overflow {overflow}, drift excess {drift}, "
          f"K2 launches {launches} (expected {steps})", flush=True)
    check(_finite(world), "cold pile: non-finite x, v or omega")
    check(overflow == 0, f"cold pile: broadphase overflow {overflow}")
    check(drift == 0.0, f"cold pile: broadphase drift excess {drift}")
    check(contacts > 0, "cold pile: no contacts")
    check(pen < 0.5, f"cold pile: max penetration {pen}")
    check(launches == steps, f"cold pile: K2 launches {launches} != {steps}")
    return counts


def phase_demo(dev):
    from mgf_tpu_torch.driver import make_chunk_step
    from mgf_tpu_torch.scenes import balls_scene
    world, cfg = balls_scene(11, device=dev)
    cfg = cfg._replace(pallas_narrowphase=True)
    chunk, n_chunks = 20, 14
    _zero_counts()
    world, chunk_s, rebuilds, overflow, drift, last = _run_chunks(
        make_chunk_step(cfg, light=True), world, n_chunks, chunk)
    counts = _counts()
    launches = counts["K2"]
    steps = chunk * n_chunks
    landing, settling = max(overflow[:200]), max(overflow[200:])
    y_min = float(world.bodies.x.y.min())
    contacts = int(last["num_contacts"])
    print(f"[8] demo balls_scene(11) ({world.bodies.n_bodies} bodies) "
          f"{steps} steps: {steps / sum(chunk_s):.2f} steps/s, contacts "
          f"{contacts}, max penetration {float(last['max_penetration']):.4f}"
          f", lowest y {y_min:.4f}, dropped ball at y "
          f"{float(world.bodies.x.y[-1]):.2f}, overflow worst step "
          f"{landing} in steps 1-200 (limit 96), {settling} in 201-{steps}, "
          f"K2 launches {launches} (expected {steps})", flush=True)
    check(_finite(world), "demo: non-finite x, v or omega")
    check(y_min > -10.0, f"demo: a body below the floor (y {y_min})")
    # the demo's own grid (cell 2.0, cap 10) overflows while the block
    # lands, mgf_tpu's too: at most 96 bodies in a step, none from 201 on
    check(landing <= 96, f"demo: broadphase overflow {landing} while "
          f"landing")
    check(settling == 0, f"demo: broadphase overflow {settling} after "
          f"step 200")
    check(contacts > 0, "demo: no contacts")
    check(launches == steps, f"demo: K2 launches {launches} != {steps}")
    return world, cfg, counts


def _contact_sets(m):
    """Per body, the set of its valid pair partners and terrain faces."""
    out = {}
    for key, other in (("pair_contacts", "j"), ("terrain_contacts", "tri")):
        s = m[key]
        v = s["contact"].valid.reshape(-1).cpu()
        i = s["i"].cpu()[v].tolist()
        j = s[other].cpu()[v].tolist()
        for a, b in zip(i, j):
            out.setdefault(a, set()).add((key, b))
    return out


def phase_demo_card_vs_cpu(world, cfg):
    from mgf_tpu_torch import world_from_numpy, world_to_numpy
    from mgf_tpu_torch.world import step
    w_cpu = world_from_numpy(world_to_numpy(world), "cpu")
    w_g, m_g = step(world, cfg, collect_contacts=True)
    w_c, m_c = step(w_cpu, cfg, collect_contacts=True)
    n_g, n_c = int(m_g["num_contacts"]), int(m_c["num_contacts"])
    s_g, s_c = _contact_sets(m_g), _contact_sets(m_c)
    n = world.bodies.n_bodies
    differ = [i for i in range(n) if s_g.get(i, set()) != s_c.get(i, set())]
    same = torch.ones(n, dtype=torch.bool)
    same[differ] = False
    err = max(float((a.cpu() - b).abs()[same].max())
              for f in ("v", "omega")
              for a, b in zip(getattr(w_g.bodies, f), getattr(w_c.bodies, f)))
    print(f"[9] demo one more step, card (K2) vs cpu (plain): contacts card "
          f"{n_g} / cpu {n_c}; bodies whose contact set differs "
          f"{len(differ)} of {n}; max |dv|,|domega| on the rest {err:.3g} "
          f"(atol 1e-3)", flush=True)
    check(n_c > 0 and abs(n_g - n_c) <= 0.001 * n_c,
          f"demo contact counts {n_g} vs {n_c}")
    check(len(differ) <= 0.001 * n, f"{len(differ)} bodies' contacts differ")
    check(err <= 1e-3, f"demo v/omega differ by {err}")


def phase_k3(ss, dev):
    args, valid = _flagship_rows(12, N_K3, dev, seed=1)
    k1 = {inner: _time_ms(lambda: ss.inner_sweeps(*args, inner))
          for inner in (1, 8)}
    out = {}
    for block in (512, 1024, 2048):
        blk = [ss._to_blocks(x, N_K3 // block) for x in args]
        vb = ss._to_blocks(valid, N_K3 // block)
        for inner in (1, 8):
            s_k, a_k = ss.inner_sweeps_blockmajor(*blk, inner)
            s_p, a_p = ss.inner_sweeps_blockmajor_reference(*blk, inner)
            torch.cuda.synchronize()
            live = lambda a: a.transpose(0, 1)[:, vb]    # valid rows
            torch.testing.assert_close(s_k, s_p, **TOL)
            torch.testing.assert_close(live(a_k), live(a_p), **TOL)
            err = max(float((s_k - s_p).abs().max()),
                      float((live(a_k) - live(a_p)).abs().max()))
            ms = _time_ms(lambda: ss.inner_sweeps_blockmajor(*blk, inner))
            plain_ms = _time_ms(
                lambda: ss.inner_sweeps_blockmajor_reference(*blk, inner))
            b_ms, b_by = sweep_bound(12, N_K3, inner)
            out[(block, inner)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                       bound_ms=b_ms, bound_by=b_by)
            print(f"[10] K3 R=12 N={N_K3} block={block} inner={inner}: "
                  f"max_abs_err {err:.3g} (atol 2e-4, rtol 1e-4); kernel "
                  f"{ms}, K1 same data {k1[inner]}, plain "
                  f"{plain_ms}, bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
    return out


def _escaped(world, floor=-1.0):
    """Bodies below y = ``floor`` or outside the scene's walls (the
    terrain's x/z extent)."""
    b, t = world.bodies, world.terrain
    wall = max(float(c.abs().max()) for v in t for c in (v.x, v.z))
    out = (b.x.y < floor) | (b.x.x.abs() > wall) | (b.x.z.abs() > wall)
    return int(out.sum())


def phase_mixed_path(dev):
    from mgf_tpu_torch.driver import AdaptiveChunkStepper
    from mgf_tpu_torch.scenes import stress_scene
    world, cfg = stress_scene(N_MAIN, mixed=True, device=dev)
    n_caps = int(world.bodies.shape_type.sum())
    n_sph = world.bodies.n_bodies - n_caps
    chunk, n_chunks = 16, 8
    st = AdaptiveChunkStepper(cfg, chunk=chunk, light=True)
    _zero_counts()
    world, chunk_s, rebuilds, overflow, drift, last = _run_chunks(
        lambda w, _ones: st.step_chunk(w), world, n_chunks, chunk)
    counts = _counts()
    overflow = max(overflow)
    steps = chunk * n_chunks
    sps_late = chunk * (n_chunks - 2) / sum(chunk_s[2:])
    contacts = int(last["num_contacts"])
    pen = float(last["max_penetration"])
    hit = float(last["warm_hit_frac"])
    escaped = _escaped(world)
    print(f"[11] mixed path stress_scene({N_MAIN}, mixed=True) ({n_sph} "
          f"spheres, {n_caps} capsules) {steps} steps, chunk {chunk}: "
          f"{sps_late:.2f} steps/s (steps 33-{steps}; "
          f"{steps / sum(chunk_s):.2f} incl. the first two chunks), contacts "
          f"{contacts}, max penetration {pen:.4f}, rebuilds {rebuilds}, "
          f"warm_hit_frac {hit:.4f}, overflow worst step {overflow} (limit "
          f"{MIXED_OVERFLOW_SHARE * N_MAIN:.0f}), drift excess "
          f"{drift}, escaped bodies {escaped}, hot schedule {st.hot_on}, "
          f"kernel launches {counts}", flush=True)
    check(n_sph == cfg.n_sphere_rows == 75_000 and n_caps == 25_000,
          f"mixed pile: {n_sph} spheres, {n_caps} capsules")
    check(_finite(world), "mixed pile: non-finite x, v or omega")
    check(overflow <= MIXED_OVERFLOW_SHARE * N_MAIN,
          f"mixed pile: broadphase overflow {overflow} in one step")
    check(drift == 0.0, f"mixed pile: broadphase drift excess {drift}")
    check(contacts > 0, "mixed pile: no contacts")
    check(escaped == 0, f"mixed pile: {escaped} bodies escaped")
    check(pen < 0.5, f"mixed pile: max penetration {pen}")
    check(not any(counts.values()),
          f"mixed pile launched a hand-written kernel: {counts}")
    return counts


def _class_counts(m, ns):
    """Valid contacts of a step by class, over both slots."""
    pc, tc = m["pair_contacts"], m["terrain_contacts"]
    v = pc["contact"].valid
    a_cap, b_cap = (pc["i"] >= ns)[None], (pc["j"] >= ns)[None]
    return {"sphere-sphere": int((v & ~a_cap & ~b_cap).sum()),
            "sphere-capsule": int((v & (a_cap ^ b_cap)).sum()),
            "capsule-capsule": int((v & a_cap & b_cap).sum()),
            "terrain": int(tc["contact"].valid.sum())}


def phase_mixed_card_vs_cpu(dev):
    from mgf_tpu_torch import world_from_numpy, world_to_numpy
    from mgf_tpu_torch.scenes import stress_scene
    from mgf_tpu_torch.world import step
    world, cfg = stress_scene(N_E2E, mixed=True, device=dev)
    one = cfg._replace(adapt_schedule=None)
    for _ in range(40):
        world, _ = step(world, one)
    w_cpu = world_from_numpy(world_to_numpy(world), "cpu")
    w_g, m_g = step(world, one, collect_contacts=True)
    w_c, m_c = step(w_cpu, one, collect_contacts=True)
    c_g = _class_counts(m_g, cfg.n_sphere_rows)
    c_c = _class_counts(m_c, cfg.n_sphere_rows)
    err = {f: max(float((a.cpu() - b).abs().max())
                  for a, b in zip(getattr(w_g.bodies, f),
                                  getattr(w_c.bodies, f)))
           for f in ("v", "omega")}
    print(f"[12] {N_E2E}-body mixed pile after 40 card steps, one more step: "
          f"contacts by class card {c_g} / cpu {c_c}; max |dv| "
          f"{err['v']:.3g}, max |domega| {err['omega']:.3g} (atol 1e-4)",
          flush=True)
    check(c_g == c_c, f"mixed contact counts {c_g} vs {c_c}")
    check(all(n > 0 for n in c_c.values()), f"a contact class is empty: {c_c}")
    check(max(err.values()) <= 1e-4, f"mixed v/omega differ by {err}")


def phase_capsules_demo(dev):
    from mgf_tpu_torch.driver import make_chunk_step
    from mgf_tpu_torch.scenes import capsules_scene
    world, cfg = capsules_scene(11, device=dev)
    chunk, n_chunks = 20, 14
    _zero_counts()
    world, chunk_s, _, overflow, _, last = _run_chunks(
        make_chunk_step(cfg, light=True), world, n_chunks, chunk)
    counts = _counts()
    steps = chunk * n_chunks
    b = world.bodies
    inside = ((b.x.x.abs() < 10.0) & (b.x.z.abs() < 10.0) & (b.x.y > -10.0))
    speed = torch.sqrt(b.v.x ** 2 + b.v.y ** 2 + b.v.z ** 2)
    resting = int((inside & (speed < 1.0)).sum())
    falling = int((~inside).sum())
    contacts = int(last["num_contacts"])
    print(f"[13] demo capsules_scene(11) ({b.n_bodies} capsules) {steps} "
          f"steps: {steps / sum(chunk_s):.2f} steps/s, contacts {contacts}, "
          f"max penetration {float(last['max_penetration']):.4f}, overflow "
          f"worst step {max(overflow)}, inside the box {int(inside.sum())} "
          f"({resting} slower than 1 m/s), missed the box and falling "
          f"{falling} (lowest y {float(b.x.y.min()):.1f}), kernel launches "
          f"{counts}", flush=True)
    check(_finite(world), "capsules demo: non-finite x, v or omega")
    check(max(overflow) == 0, f"capsules demo: overflow {max(overflow)}")
    check(contacts > 0, "capsules demo: no contacts")
    check(int(inside.sum()) > 0 and falling > int(inside.sum()),
          f"capsules demo: {int(inside.sum())} inside, {falling} falling "
          f"(most capsules miss the +-10 box)")
    check(not any(counts.values()),
          f"capsules demo launched a hand-written kernel: {counts}")
    return counts


def k4_bound(inp, iters, mgf):
    """K4's (bound_ms, bound_by) in the friction mode ``mgf`` names: the
    valid flags, the valid points' rows and body indices and the body table
    read once, v and omega written once; iters x valid points x the
    update's float32 operations.  Neither is what limits K4: its sweeps are
    one chain of dependent updates."""
    C, M = inp["valid"].numel(), inp["bodies"].shape[0]
    nv = int(inp["valid"].sum())
    n_bytes = C + nv * (4 * 20 + 8) + M * 4 * 16 + M * 4 * 6
    ops = K4_OPS_PER_UPDATE["mgf" if mgf else "textbook"]
    return bound(n_bytes, iters * nv * ops)


def _record_sequential(seq, world, cfg):
    """K4's inputs in one sequential step of ``world``."""
    from mgf_tpu_torch.world import step
    return seq.capture_inputs(
        lambda: step(world, cfg._replace(solver="sequential")))[0]


def _k4_run(seq, inp, iters, mgf, plain=False):
    fn = seq.sequential_solve_reference if plain else seq.sequential_solve
    return fn(inp["pts"], inp["a"], inp["b"], inp["valid"], inp["bodies"],
              iters, mgf)


def _vw_err(a, b):
    a, b = a.cpu(), b.cpu()
    return (float((a[:, :3] - b[:, :3]).abs().max()),
            float((a[:, 3:6] - b[:, 3:6]).abs().max()))


def phase_k4_small(seq, dev):
    """[14] K4 against its plain version on the card at the 126-body
    landing step (the parallel solver brings the demo there, so the inputs
    do not depend on K4)."""
    from mgf_tpu_torch import world as tworld
    from mgf_tpu_torch.scenes import balls_scene
    world, cfg = balls_scene(5, device=dev)
    par = cfg._replace(solver="parallel")
    for _ in range(141):        # the block lands: 117 valid points, 45 m/s
        world, _ = tworld.step(world, par)
    inp = _record_sequential(seq, world, cfg)
    iters, nv = 20, int(inp["valid"].sum())
    err = 0.0
    for mgf in (False, True):
        out_k = _k4_run(seq, inp, iters, mgf)
        out_p = _k4_run(seq, inp, iters, mgf, plain=True)
        torch.cuda.synchronize()
        ev, ew = _vw_err(out_k, out_p)
        err = max(err, ev, ew)
        print(f"[14] K4 vs plain on the card, balls_scene(5) landing "
              f"({inp['bodies'].shape[0]} body rows, "
              f"{inp['valid'].numel()} points, {nv} valid), {iters} sweeps, "
              f"friction {'mgf' if mgf else 'textbook'}: max |dv| {ev:.3g}, "
              f"|domega| {ew:.3g} (atol 1e-4, rtol 1e-5)", flush=True)
        torch.testing.assert_close(out_k, out_p, **K4_TOL)
        check(float((out_k[:, :3] - inp["bodies"][:, :3]).abs().max())
              > 0.1, "K4: the landing solve moved nothing")
    ms = _time_ms(lambda: _k4_run(seq, inp, iters, True))
    # the plain version: ~60 launches per point update, host-bound
    plain_ms = _time_ms(lambda: _k4_run(seq, inp, iters, True, plain=True),
                        reps=1, blocks=3)
    b_ms, b_by = k4_bound(inp, iters, True)
    print(f"[14] K4 at the landing, friction mgf: kernel {ms}, "
          f"{1e6 * ms / (iters * nv):.1f} ns per valid point-update; plain "
          f"{plain_ms} (1 call a block: ~60 small launches per point "
          f"update); bound {b_ms:.6f} ms "
          f"({b_by})", flush=True)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def phase_k4_demo(seq, k4, world, cfg):
    """[14], continued: K4 at the full demo's constraint list (one more
    sequential step from the state [15] ends in), timed, and held against
    the plain version on CPU copies of the inputs."""
    inp = _record_sequential(seq, world, cfg)
    iters, mgf = inp["iters"], inp["mgf"]
    nv = int(inp["valid"].sum())
    out_k = _k4_run(seq, inp, iters, mgf)
    cpu = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in inp.items()}
    out_p = _k4_run(seq, cpu, iters, mgf, plain=True)
    ev, ew = _vw_err(out_k, out_p)
    torch.testing.assert_close(out_k.cpu(), out_p, **K4_TOL)
    ms = _time_ms(lambda: _k4_run(seq, inp, iters, mgf), reps=5)
    b_ms, b_by = k4_bound(inp, iters, mgf)
    print(f"[14] K4 at the demo's list after [15] "
          f"({inp['bodies'].shape[0]} body rows, {inp['valid'].numel()} "
          f"points, {nv} valid, {iters} sweeps, friction "
          f"{'mgf' if mgf else 'textbook'}): kernel {ms}, "
          f"{1e6 * ms / (iters * max(nv, 1)):.1f} ns per valid point-update; vs "
          f"plain on the CPU max |dv| {ev:.3g}, |domega| {ew:.3g} (atol "
          f"1e-4, rtol 1e-5); bound {b_ms:.6f} ms ({b_by})", flush=True)
    return dict(k4, err=max(k4["err"], ev, ew), ms=ms, bound_ms=b_ms,
                bound_by=b_by, n_valid=nv)


def phase_flat_demo(dev, solver):
    """[15] / [16] the demo on a flat solver, 280 steps from scratch."""
    from mgf_tpu_torch.driver import make_chunk_step
    from mgf_tpu_torch.scenes import balls_scene
    tag = "[15]" if solver == "sequential" else "[16]"
    world, cfg = balls_scene(11, solver=solver, device=dev)
    cfg = cfg._replace(pallas_narrowphase=True)
    if solver == "sequential":
        cfg = cfg._replace(friction_mode="mgf")
    chunk, n_chunks = 20, 14
    _zero_counts()
    world, chunk_s, _, overflow, _, last = _run_chunks(
        make_chunk_step(cfg, light=True), world, n_chunks, chunk)
    counts = _counts()
    steps = chunk * n_chunks
    landing, settling = max(overflow[:200]), max(overflow[200:])
    contacts = int(last["num_contacts"])
    pen = float(last["max_penetration"])
    out = _escaped(world, floor=-10.0)
    sps = 4 * chunk / sum(chunk_s[-4:])
    want_k4 = steps if solver == "sequential" else 0
    print(f"{tag} demo balls_scene(11, solver={solver!r}, friction_mode="
          f"{cfg.friction_mode!r}) ({world.bodies.n_bodies} bodies) {steps} "
          f"steps: {sps:.2f} steps/s over the last {4 * chunk} "
          f"({steps / sum(chunk_s):.2f} over all), contacts {contacts}, max "
          f"penetration at the last step {pen:.4f} (limit "
          f"{FLAT_PEN_LAST[solver]}), "
          f"overflow worst step {landing} in steps 1-200 (limit "
          f"{FLAT_OVERFLOW_LANDING[solver]}), {settling} in 201-{steps}, on "
          f"{sum(o > 0 for o in overflow)} steps; out of the box {out}; "
          f"lowest y {float(world.bodies.x.y.min()):.4f}; kernel launches "
          f"{counts} (K2 expected {steps}, K4 {want_k4})", flush=True)
    check(_finite(world), f"{solver} demo: non-finite x, v or omega")
    check(out == 0, f"{solver} demo: {out} bodies out of the box")
    check(landing <= FLAT_OVERFLOW_LANDING[solver],
          f"{solver} demo: broadphase overflow {landing} while landing")
    check(settling == 0, f"{solver} demo: overflow {settling} after step 200")
    check(contacts > 0, f"{solver} demo: no contacts")
    check(pen < FLAT_PEN_LAST[solver],
          f"{solver} demo: max penetration {pen}")
    check(counts["K2"] == steps and counts["K4"] == want_k4
          and counts["K1"] == counts["K3"] == 0,
          f"{solver} demo: kernel launches {counts}")
    return world, cfg, counts


def _terrain_grid_overflow(world, cfg):
    """The face grid's dropped insertions, from a build over the world's
    triangles with the scene's grid settings that is checked to give the
    very face table the step reads (``world.terrain_grid``'s id block)."""
    from mgf_tpu_torch.mesh import build_mesh_grid, mesh_from_arrays
    tri = world.terrain
    corners = [torch.stack(list(p), -1).cpu().numpy()
               for p in (tri.a, tri.b, tri.c)]
    T = corners[0].shape[0]
    faces = np.stack([np.arange(T), T + np.arange(T), 2 * T + np.arange(T)],
                     -1)
    tg = cfg.terrain_grid_cfg
    mg = build_mesh_grid(mesh_from_arrays(np.concatenate(corners), faces,
                                          device=tri.a.x.device),
                         tg.cell_size, tg.dim, tg.bucket_cap)
    check(torch.equal(mg.table.float(),
                      world.terrain_grid[:, :tg.bucket_cap]),
          "terrain: the rebuilt face grid is not the step's face table")
    return int(mg.overflow), T


def phase_terrain(dev):
    """[17] terrain_scene() at its defaults, 240 steps from scratch."""
    from mgf_tpu_torch.driver import make_chunk_step
    from mgf_tpu_torch.scenes import terrain_scene
    from mgf_tpu_torch.world import step
    world, cfg = terrain_scene(N_TERRAIN, device=dev)
    grid_over, n_faces = _terrain_grid_overflow(world, cfg)
    y0 = world.bodies.x.y.clone()
    chunk, n_chunks = 20, 12
    run = make_chunk_step(cfg, light=True)
    chunk_s, overflow, excess = [], [], []
    _zero_counts()
    for k in range(n_chunks):
        # the last chunk ends in a step that returns the contact streams
        n = chunk - 1 if k == n_chunks - 1 else chunk
        t0 = time.perf_counter()
        world, m = run(world, torch.ones((n,), device=dev))
        overflow += m["broadphase_overflow"].tolist()
        excess += m["terrain_reach_excess"].tolist()
        if n < chunk:
            world, last = step(world, cfg, collect_contacts=True)
            overflow.append(int(last["broadphase_overflow"]))
            excess.append(float(last["terrain_reach_excess"]))
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    counts = _counts()
    steps = chunk * n_chunks
    classes = _class_counts(last, cfg.n_sphere_rows)
    pen = float(last["max_penetration"])
    dropped = int(last["solver_rows_dropped"])
    y = world.bodies.x.y
    y_min, rise = float(y.min()), float((y - y0).max())
    print(f"[17] terrain_scene({N_TERRAIN}) ({cfg.n_sphere_rows} spheres, "
          f"{N_TERRAIN - cfg.n_sphere_rows} capsules, {n_faces} faces) "
          f"{steps} steps: {4 * chunk / sum(chunk_s[-4:]):.2f} steps/s over "
          f"steps 161-{steps} ({steps / sum(chunk_s):.2f} over all), "
          f"contacts {int(last['num_contacts'])}, by class {classes}, max "
          f"penetration at the last step {pen:.4f} (limit 0.8), "
          f"solver_rows_dropped {dropped}, face grid overflow {grid_over}, "
          f"broadphase overflow worst step {max(overflow)}, "
          f"terrain_reach_excess worst {max(excess)}, lowest y {y_min:.4f}, "
          f"largest rise over the start {rise:.4f}; kernel launches "
          f"{counts}", flush=True)
    check(_finite(world), "terrain: non-finite x, v or omega")
    check(grid_over == 0, f"terrain: face grid overflow {grid_over}")
    check(len(excess) == steps and max(excess) == 0.0,
          f"terrain: terrain_reach_excess {max(excess)}")
    check(y_min > -4.0, f"terrain: a body below y = -4 ({y_min})")
    check(rise <= 0.0, f"terrain: a body rose {rise} over its start")
    check(classes["terrain"] > 0, "terrain: no terrain contacts")
    check(pen < 0.8, f"terrain: max penetration {pen}")
    check(not any(counts.values()),
          f"terrain launched a hand-written kernel: {counts}")
    return counts


def phase_terrain_card_vs_cpu(dev):
    """[18] one terrain step on the card against the CPU."""
    from mgf_tpu_torch import world_from_numpy, world_to_numpy
    from mgf_tpu_torch.scenes import terrain_scene
    from mgf_tpu_torch.world import step
    world, cfg = terrain_scene(N_TERRAIN_E2E, device=dev)
    for _ in range(100):
        world, _ = step(world, cfg)
    w_cpu = world_from_numpy(world_to_numpy(world), "cpu")
    w_g, m_g = step(world, cfg, collect_contacts=True)
    w_c, m_c = step(w_cpu, cfg, collect_contacts=True)
    c_g = _class_counts(m_g, cfg.n_sphere_rows)
    c_c = _class_counts(m_c, cfg.n_sphere_rows)
    err = {f: max(float((a.cpu() - b).abs().max())
                  for a, b in zip(getattr(w_g.bodies, f),
                                  getattr(w_c.bodies, f)))
           for f in ("v", "omega")}
    print(f"[18] terrain_scene({N_TERRAIN_E2E}) after 100 card steps, one "
          f"more step: contacts by class card {c_g} / cpu {c_c}; "
          f"solver_rows_dropped {int(m_g['solver_rows_dropped'])} / "
          f"{int(m_c['solver_rows_dropped'])}; max |dv| {err['v']:.3g} "
          f"(atol 1e-5), max |domega| {err['omega']:.3g} (atol 1e-4)",
          flush=True)
    check(c_g == c_c, f"terrain contact counts {c_g} vs {c_c}")
    check(c_c["terrain"] > 0, f"terrain: no terrain contacts {c_c}")
    check(err["v"] <= 1e-5 and err["omega"] <= 1e-4,
          f"terrain v/omega differ by {err}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    from mgf_tpu_torch.ops import _build
    from mgf_tpu_torch.ops import narrowphase as nph
    from mgf_tpu_torch.ops import sequential_solve as seq
    from mgf_tpu_torch.ops import solver_sweep as ss
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[1] device {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(smi, flush=True)
    wall_s = _build.build_all()
    per_src = ", ".join(f"{k} {v:.2f} s"
                        for k, v in sorted(_build.BUILD_SECONDS.items()))
    print(f"[2] kernels built in {wall_s:.2f} s wall, one nvcc per source "
          f"in parallel ({per_src})", flush=True)
    k1 = phase_kernel(ss, dev)
    paths = [phase_main_path(dev)]
    phase_end_to_end(dev)
    k2 = phase_k2(nph, dev)
    paths.append(phase_cold_path(dev))
    demo, demo_cfg, demo_counts = phase_demo(dev)
    paths.append(demo_counts)
    phase_demo_card_vs_cpu(demo, demo_cfg)
    k3 = phase_k3(ss, dev)
    paths.append(phase_mixed_path(dev))
    phase_mixed_card_vs_cpu(dev)
    paths.append(phase_capsules_demo(dev))
    k4 = phase_k4_small(seq, dev)
    seq_demo, seq_cfg, seq_counts = phase_flat_demo(dev,
                                                    "sequential")
    paths.append(seq_counts)
    k4 = phase_k4_demo(seq, k4, seq_demo, seq_cfg)
    paths.append(phase_flat_demo(dev, "parallel")[2])
    paths.append(phase_terrain(dev))
    phase_terrain_card_vs_cpu(dev)
    launches = {k: sum(p[k] for p in paths) for k in paths[0]}

    def row(name, source, replaces, n, r):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None}

    # no single PyTorch call computes K1, K2, K3 or K4: library_ms is null.
    # launches: each kernel's count summed over the paths ([4], [7], [8],
    # [15], [16]; [11], [13] and [17] launch none).  K1 in gather mode at
    # the main path's settled shape (inner 6); K2 at the cold pile's
    # 900,000 pairs; K3 at block 1024, inner 8; K4 at the full demo's
    # constraint list (ms, bound) with plain_ms at the 126-body landing
    print(json.dumps({"kernels": [
        row("solver_sweep.inner_sweeps",
            "mgf_tpu_torch/ops/csrc/solver_sweep.cu",
            "mgf_tpu/ops/solver_sweep.py:113", launches["K1"],
            dict(k1[("gather", 6)],
                 err=max(v["err"] for v in k1.values()))),
        row("narrowphase.sphere_contact_pairs",
            "mgf_tpu_torch/ops/csrc/sphere_contact.cu",
            "mgf_tpu/ops/narrowphase.py:110", launches["K2"], k2),
        row("solver_sweep.inner_sweeps_blockmajor",
            "mgf_tpu_torch/ops/csrc/solver_sweep.cu",
            "scripts/micro_sweep.py:61", launches["K3"],
            dict(k3[(1024, 8)], err=max(v["err"] for v in k3.values()))),
        row("sequential_solve.sequential_solve",
            "mgf_tpu_torch/ops/csrc/sequential_solve.cu",
            "mgf_tpu/solver.py:192 (lax.scan; no Pallas twin)",
            launches["K4"], k4),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
