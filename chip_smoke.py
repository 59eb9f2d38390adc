"""Smoke run of mgf_tpu_torch on one NVIDIA GPU: build the kernels, check
them, drive the flagship path, the generic sphere branch, the mixed
sphere/capsule pile, the capsules demo, the reference's flat solvers, the
heightfield terrain scene, GJK/EPA and the world queries, the broadphase
variants, the refit cache, the stage probes, the capacity world with its
surgery and checkpoint, the torch demos and the entry point, the
multi-device paths as ranks sharing the card, hold the card's steps
contact for contact against the f64 parity oracle, replay the flagship,
cold-pile and mixed-pile steps from CUDA graphs against their eager runs,
and check what comes out.

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
   AdaptiveChunkStepper(chunk=16, light=True) (replayed from CUDA graphs,
   the chunk driver's default on the card, as in every phase that steps
   through it: [4], [7], [8], [11], [21], [24], [33], [35]; the capsule,
   terrain and flat-solver paths step eagerly), with the physics guards
   checked, K1's launch count held to the solver's outer iterations
   (one gather-mode launch per outer iteration) and K5's to the steps;
   its contacts at steps 64 and 128 are [21]'s and [26]'s yardsticks
   (every kernel's count is set to 0 before each path, [4], [7], [8],
   [11], [13], [15]-[17], [19]-[25], [29]-[32] and each run of [35], and
   in every rank of [26]-[28], and read after it; [33]'s process reports
   its own; the kernels line sums them; a replayed graph counts the
   launches its capture recorded);
5. kernel path against plain path end to end: an 8,000-body pile stepped
   40 steps on the card, copied to the CPU, then one more step on each;
6. K2 against its plain version at P = 900,000 pairs (the cold pile's 9
   slots x 100k), random blocks plus one row per branch of the kernel;
   valid exactly, t and n atol 1e-4, witness points atol 1e-3;
7. the generic branch at full size: the cold reference-schedule pile
   (stress_scene(100_000), warm starting off, 20 two-phase sweeps, K2 on)
   stepped 64 steps, with its guards and K2's and K5's launches held to
   the steps;
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
    narrowphase, two chained block solves, the hybrid warm match at 36
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
14. K4 (the sequential Gauss-Seidel solve, one CUDA block running the
    points' body-dependency graph level by level) on the constraint list
    of the 126-body balls_scene(5) landing step, 20 sweeps, both friction
    modes: equal (torch.equal, and within atol 1e-4 / rtol 1e-5) to the
    level plain version on the card and to the serial plain version (the
    oracle, one point at a time) on CPU copies of the inputs; after [15],
    at the full demo's list (its mgf friction), equal to the serial plain
    version on CPU copies.  Printed at both: the levels a sweep, the widest
    level, the pipelined depth over the sweeps (``sequential_schedule``),
    K4's time and ns per point update, and its bound, the pipelined depth
    times one update's latency chain, beside the earlier bound (the whole
    list as one chain); at the demo's list also the level plain version's
    time on the card;
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
19. GJK/EPA at BASELINE.json config 4 (bench.py's bench_gjk_batch, drawn
    by bench_torch.bench_obb_arrays): 8,192 random OBB pairs (numpy seed
    0, normalised random quaternions, centres U(-1.5, 1.5) with the second
    box shifted by +1, half extents U(0.5, 1.0)) through
    ``gjk.contact_convex_convex_ex`` and ``gjk.separation`` on the card,
    held against an f64 15-axis SAT oracle on every pair clear of its 2e-3
    margin with tests/test_gjk_property.py's
    checks: decision errors, EPA depth errors (worst, and how many pass
    0.02), the worst distance short of the SAT bound (limit 0.01) and the
    separated pairs ``separation`` reports touching.  mgf_tpu itself, run on
    the same pairs by scripts/mixed_reference_guards.py --gjk, makes 5
    decision errors and 2 depth errors past 0.02 here (its property suite's
    distribution is kinder), so each count may pass mgf_tpu's by 0.1 % of
    the pairs (``GJK_REFERENCE``).  Also: the EPA-saturated lanes; the
    first 1,024 pairs again through the port on the CPU (``valid`` equal on
    the clear pairs, depth and distance within 1e-4); pairs/s of the
    contact call (median of 5 calls), its device operations and device time
    per call (torch.profiler), and no launch of K1-K4 (plain PyTorch, as the
    JAX package runs it as plain jnp);
20. the world queries on the flagship pile after [4]: ``build_body_grid``
    with bench.py's cell 1.25 and cap 24 at dims (128, 16, 128) (the pile at
    step 128 is taller than bench's settled one, and each axis' modulus
    must exceed the occupied span, bench.py:254-261), overflow 0; 16,384
    downward rays made as bench.py's bench_raytrace makes them (numpy seed
    3, bench_torch.bench_rays) through ``raytrace_bodies_grid`` and the
    chunked dense ``raytrace_bodies``: every ray's hit equal, t within 1e-4
    and body index equal where hit (0 mismatches); ``raytrace_mesh_grid``
    against ``raytrace_mesh`` with 4,096 downward rays over terrain_scene()'s
    10,368-face heightfield (face grid cell 4.0, dim 64, cap 16): hit equal,
    t within 1e-4; ``query_aabb`` on one box against a numpy recount; grid
    and dense rays/s (median of 5 calls), the most DDA iterations any ray
    took, and no launch of K1-K4;
21. the broadphase variants on the flagship pile: stress_scene(100_000)
    from scratch, 64 steps by AdaptiveChunkStepper(chunk=16) in each of
    "fat" (width-8 rows, 27 cells, the scene's grid), "fat8" (width 8,
    the sel8 octant) and "fat8x4" (width 4, sel8) on the sel8 grid of
    mgf_tpu/scenes.py:255-261 (cell 2.4, cap 24, x/z dims by the scene's
    rule, 16 cells in y): steps/s, rebuilds, contacts and max penetration
    at step 64; overflow 0, drift excess 0, max penetration < 0.5,
    contacts within 2 % of [4]'s at step 64, K1's launches equal to the
    outer iterations; the reach excess at the chunks' full-metric steps 0
    for "fat"; for the octant modes (guarantee: half a cell) it is printed
    beside what mgf_tpu's own runs of them show in the same collapse
    (``REACH_REFERENCE``: not 0 either), and the window is held to what the
    excess could cost: at every chunk end, 0 pairs of a 27-cell build on
    the same grid missing from the octant build where its row has a free
    slot (both keeping 64 partners); then each
    mode on an 8k pile, the card's step against the CPU's (contacts within
    0.1 %, pair streams within 0.1 % of their entries, v and omega within
    1e-3);
22. the refit cache on [4]'s pile: bp_margin 0.1 and 0.5, each 64 steps
    with bp_every=1 (a fresh cache), then 64 with bp_every=32: rebuilds,
    reuse steps, and on every reuse step the cached list against a fresh
    build of that step (a pair missing where the cached row has a free
    slot is a miss, guarded at 0; pairs past a full row's top-9 are
    printed); drift excess 0, reach excess 0, overflow 0; reuse steps at
    the larger margin;
23. the eight ``profile_stage`` prefixes on [4]'s pile: each probe (finite)
    and the prefix's ms (median of 5, printed, not guarded); on an 8k pile
    after 40 steps the card's eight probes against the CPU's ([5]'s
    tolerances: counts within 0.1 %, the solve's velocities within 1e-3
    each);
24. world surgery at full size: [4]'s pile without its caches,
    ``with_capacity(150_000)`` (past 2^17 rows: the float-score top-k),
    ``init_warm``, ``init_bp_cache``; 64 steps, kill 1,000 live bodies
    (every 100th), 16 steps, spawn 1,000 spheres above the pile, 64
    steps: ``free_slots`` reuses the killed rows first, ``num_alive``
    100,000 -> 99,000 -> 100,000, no tensor changes shape,
    ``validate_world`` on the live bodies and
    ``check_step_metrics(max_penetration=0.5)`` pass, overflow 0; then
    ``save_world`` / ``load_world``: every leaf bit-equal, one step from
    each within [5]'s tolerance, the file's size and the save and load
    seconds;
25. the torch demos as processes of their own: ``demos/balls_torch.py
    --steps 60 --save --render`` (1,332 bodies, K2) and
    ``demos/capsules_torch.py --steps 60 --render`` (1,331): exit 0, the
    trajectory's shape (60, 1332, 3), the PPM headers, 61 K2 launches in
    the balls run; then one call of ``entry()``'s step on the card, finite
    metrics;
26. the spatial (x-slab halo-exchange) step of mgf_tpu_torch.parallel on
    the flagship pile: stress_scene(100_000) from scratch, 128 steps on 4
    gloo ranks sharing the card (every message staged through host
    memory; halo 4,096 rows per direction; the scene's own config: the
    bp_every cache, hybrid warm matching, the adaptive schedule, fused_iso
    count semantics, the "near" terrain cull), re-sharded whenever
    spatial_stray turns above 0 (counted): per-rank steps/s over steps
    33-128, rebuilds, warm_hit_frac, comm_floats_per_step (mgf_tpu's
    formula) beside the bytes and messages each rank really sent per step;
    halo_overflow, broadphase overflow and drift excess 0 on every step, a
    finite state, max penetration < 0.5 at step 128, no escaped body,
    contacts at steps 64 and 128 within 3.5 % of [4]'s (mgf_tpu's own
    spatial-versus-single gap, scripts/mixed_reference_guards.py
    --spatial: 3.34 % at 8,000 bodies, 1.06 % at 100,000), K5's launches
    one a step on every rank and no other kernel's; the wall time split
    into start-up, set-up, steps, checks and exit;
27. the spatial step on the card against the CPU and against one device:
    an 8,000-body pile after 40 single-device card steps; one spatial step
    on 4 card ranks and on 4 CPU ranks from the same state (each rank's
    halo membership and candidate lists equal, v and omega within 1e-3);
    the 4 card ranks' 8 steps beside the port's single-device step on the
    card from the same state with fresh caches (contacts equal at step 8,
    as mgf_tpu's are on the same scene; positions within 1e-5, mgf_tpu's
    gap 2.86e-6);
28. the all-gather (sharded) step on [4]'s pile at step 128, 4 gloo ranks
    sharing the card, 16 steps: steps/s per rank, bytes and messages per
    step, contacts at step 1 within 0.1 % of the single-device step's from
    the same state, overflow 0, a finite state, no escaped body, no kernel
    launch; then ``dryrun_multichip(4, backend="gloo")`` on the card and
    ``dryrun_multichip(n, backend="nccl")`` with one rank per card (n = 1
    on a one-card machine: NCCL's failure to start raises);
29. the f64 parity oracle (``mgf_tpu_torch.oracle``: numpy float64 on the
    host, its Gauss-Seidel loop in ``mgf_tpu_torch.native``, built from
    csrc/mgf_host.cpp with g++) against the card, PARITY.md's headline:
    balls_scene(11) on its generic step with K2, the oracle alone through
    the 60-step free fall, then 160 steps resynced (each step the oracle's
    state goes into the card's step and both contact streams are diffed
    contact for contact, ``mgf_tpu_torch.parity``): tests/test_oracle.py's
    gates, 0 misses on every step, dt <= 1e-4, dn <= 2e-7, dp <= 2e-6,
    median one-step |dv| <= 1e-3, at most 15 steps with |dv| > 5; K2's
    launches equal to the steps.  The oracle's runs of [29], [31] and [32]
    go to three worker processes on the CPU at the smoke's start, after
    [2], so that they overlap [3]-[28];
30. the reference-exact path free-running beside the oracle:
    balls_scene(3) on the sequential solver (K4) with the raw-lambda
    friction and all-pairs candidates, 160 steps; worst |dy| <= 5e-3
    (PARITY.md: 1.5e-4 at impact, 6e-5 settled); K4's launches equal to
    the steps;
31. the flagship config (K1) against the oracle: stress_scene(2_000) on
    its shipped config (fused_iso, the bp_every=32 fat27x4 cache, the
    hybrid warm match, the adaptive schedule), the oracle alone 100 steps
    into the pile, then 100 resynced with the warm rows and the cache
    carried from step to step.  The "near" terrain cull keeps 3 candidates
    and the manifold 1 slot, so misses need not be 0: the bars are twice
    what mgf_tpu itself gives on the CPU at the same scene and windows
    (``FLAGSHIP_BARS``); K1's launches equal to the outer iterations.
    Then scripts/cold_bridge.py's row: [7]'s cold config (K2) on the same
    2,000-body pile, 300 steps, max penetration at every 30th step from
    150 on, beside the f64 oracle's 0.073-0.081 (PARITY.md), its mean held
    to mgf_tpu's own row's within ``COLD_BRIDGE_TOL``;
32. the mixed pile's shipped semantics: stress_scene(2_000, mixed=True,
    layers=6) with cap_manifold "ends", the oracle alone 150 steps, then
    120 resynced (scripts/mixed_resync.py's case), mgf_tpu's own figures
    beside: tests/test_oracle.py's "ends" gates where mgf_tpu meets them
    (miss <= max(4, 1 % of the contacts compared), dp <= 1e-3), twice
    mgf_tpu's figures where it does not (dt, dn; ``MIXED_GATES``), and
    capsule-terrain contacts > 0 (the oracle finds no ends slot-1 contact
    on this pile, in either package); no kernel launch;
33. ``python3 bench_torch.py --quick`` as a process of its own (the
    port's bench: stress_scene(10_000) through 1,600 steps of warm-up, the
    fastest of 3 windows of 128 steps in chunks of 64, then 2 x bp_every
    single steps): exit 0, broadphase overflow 0, drift excess 0, max
    penetration < 0.5, finite steps/s and penetration, and K1's launches
    between 2 and 4 per step (the 2x6 and the 4x4 schedule);
35. (printed before [34]) the compiled chunk: the flagship (K1, 128
    steps), the cold pile (K2, 64 steps) and the mixed pile (64 steps) at
    100k bodies, each from a state of its own stepped eager twice
    (``capture=False``) and once replayed from CUDA graphs
    (``graphs.CapturedStep``), chunks of 16 with light metrics as in [4],
    [7] and [11]: if the two eager runs are bit-equal, the captured run
    must equal them bit for bit (x, v, omega and every metric of every
    step), else stay within twice their gap (x, v, omega, and the contacts
    of each step); the case that held is printed.  On the captured run the
    guards of [4] / [7] / [11] (finite state, overflow, drift excess 0,
    max penetration < 0.5, contacts, 0 escaped bodies) and K1's launches
    equal to the outer iterations, K2's to the steps, K5's to the steps
    (the flagship and the cold pile; the mixed pile launches none), on
    every run, counted from 0 before each.  Then
    steps/s captured and eager (after the first chunks), 4 more steps of
    each (a shorter chunk on the same stepper and graphs) traced by
    torch.profiler (the device alone): device
    operations, device ms and graph launches per step and the device's
    busy share of the timed ms per step; capture seconds, the graphs'
    reserved memory, and nvidia-smi's name and power limit;
36. (printed after [5]) K5 against its plain PyTorch version on the same
    CUDA tensors: [4]'s pile stepped 512 more steps (640 from scratch,
    eager), then the terrain stage of its next step's head (3 candidates,
    ``stable_pairs``), light (no deepest penetration) and full: face ids
    and ``valid`` exactly, every float within 1e-6 or 4 ulp, the lanes
    that differ at all counted; both times (CUDA events) and the bound
    from the run's bytes and operations (``k5_bound``);
34. the smoke's wall time and each phase's seconds, a JSON line of
    per-kernel results, then the result line.

Needs a CUDA card; it exits non-zero without one, and imports no JAX.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import re
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from bench_torch import (
    bench_obb_arrays, bench_rays, card_line, escaped_bodies, launch_counters,
    obb_pairs,
)

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
# K4's bound is the dependency graph's depth times one point update's
# latency chain: the longest run of dependent float32 operations in one
# update of sequential_solve.cu (the relative velocity 5, the tangent
# projection 4, the friction clamp 4 in "textbook" (add, max, min, sub; 0
# in "mgf"), the impulse 2, the angular update through the inverse inertia
# 6, the second relative velocity 5, the normal projection 5, the clamp and
# impulse 4, the angular update 6), each 4 cycles of latency on Hopper's
# FP32 pipe, plus the reload of the bodies the previous level wrote from
# shared memory (~30 cycles)
K4_CHAIN_OPS = {"mgf": 37, "textbook": 41}
K4_OP_CYCLES, K4_SMEM_CYCLES = 4, 30
K4_TOL = dict(atol=1e-4, rtol=1e-5)
# K5 (sphere_terrain.cu), float32 operations counted from the source, an
# FMA as two: a body's sweep length and reach 15, the cull 18 a face
# (three axes of two subtractions, a max, a clamp, a multiply and an add),
# and a candidate 444 (the plane test 44, the containment test 22, three
# edge sweeps of 111 with the closest point on the edge, the manifold and
# basis 45)
K5_OPS_PER_BODY, K5_OPS_PER_FACE, K5_OPS_PER_CAND = 15, 18, 444
K5_ATOL, K5_ULPS = 1e-6, 4
K5_MORE_STEPS = 512           # [36]: [4]'s pile 128 -> 640 steps
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


def k5_bound(n, n_tris, cand, with_deepest):
    """K5: a body's 8 floats in, 16 floats, a valid byte and a face id a
    candidate out, and its deepest penetration; the mesh read once."""
    n_bytes = (4 * 8 * n + (16 * 4 + 1 + 4) * cand * n
               + 4 * n * int(with_deepest) + 4 * (9 * n_tris + 3))
    n_ops = n * (K5_OPS_PER_BODY + K5_OPS_PER_FACE * n_tris
                 + K5_OPS_PER_CAND * cand)
    return bound(n_bytes, n_ops)


def _zero_counts():
    torch.cuda.synchronize()
    for _, mod, attr in launch_counters():
        setattr(mod, attr, 0)


def _counts():
    torch.cuda.synchronize()
    return {k: getattr(mod, attr) for k, mod, attr in launch_counters()}


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
    for k in range(n_chunks):
        t0 = time.perf_counter()
        world, m = st.step_chunk(world)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        expected += chunk * (it2 if st.hot_on else cfg.solver_iters)
        rebuilds += int(m["broadphase_rebuilt"].sum())
        overflow = max(overflow, int(m["broadphase_overflow"].max()))
        drift = max(drift, float(m["broadphase_cache_drift_excess"].max()))
        last = {k: v[-1] for k, v in m.items()}
        if (k + 1) * chunk == 64:
            contacts64 = int(last["num_contacts"])
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
          f"launches {launches} (expected {expected}), K5 launches "
          f"{counts['K5']}; contacts at step 64 {contacts64}", flush=True)
    check(finite, "non-finite x, v or omega")
    check(overflow == 0, f"broadphase overflow {overflow}")
    check(drift == 0.0, f"broadphase drift excess {drift}")
    check(contacts > 0, "no contacts")
    check(pen < 0.5, f"max penetration {pen}")
    check(launches == expected and launches > 0,
          f"K1 launches {launches} != solver outer iterations {expected}")
    check(counts["K5"] == steps,
          f"K5 launches {counts['K5']} != steps {steps}")
    return counts, world, cfg, contacts64, contacts


def _ulps(a, b):
    """Distance in float32 steps (ordered integers of the bit patterns)."""
    ia, ib = (t.contiguous().view(torch.int32).to(torch.int64)
              for t in (a, b))
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


def _k5_fields(out):
    """K5's outputs as named float tensors: the manifold's 16 fields and,
    where computed, the deepest penetration."""
    man, _, deep = out
    f = {"time": man.time}
    for k in ("normal", "t1", "t2", "local_a", "local_b"):
        for c in "xyz":
            f[f"{k}.{c}"] = getattr(getattr(man, k), c)
    if deep is not None:
        f["deepest"] = deep.reshape(1)
    return f


def phase_k5(pile, cfg, dev):
    """[36] K5 against its plain version on the same CUDA tensors, at the
    head of the step after [4]'s pile has run 512 more steps."""
    from mgf_tpu_torch.driver import AdaptiveChunkStepper
    from mgf_tpu_torch.ops import terrain
    from mgf_tpu_torch.world import step_head
    st = AdaptiveChunkStepper(cfg, chunk=64, light=True, capture=False)
    world = _clone_world(pile)
    for _ in range(K5_MORE_STEPS // 64):
        world, _ = st.step_chunk(world)
    s = step_head(world, cfg).state
    n, n_tris = s.x.x.shape[0], world.terrain.a.x.shape[0]
    cand = cfg.terrain_cand
    out = {}
    for with_deepest in (False, True):
        args = (s.x, s.delta, s.shape_r, s.shape_half_h, world.terrain,
                world.terrain_center, cand, cfg.stable_pairs, with_deepest)
        got = terrain.sphere_terrain_near(*args)
        ref = terrain.sphere_terrain_near_reference(*args)
        torch.cuda.synchronize()
        check(torch.equal(got[1], ref[1]) and torch.equal(got[0].valid,
                                                          ref[0].valid),
              f"[36] K5 face ids or valid differ from the plain version "
              f"(deepest {with_deepest})")
        err, differ, off = 0.0, {}, {}
        for (k, a), b in zip(_k5_fields(got).items(),
                             _k5_fields(ref).values()):
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            gap = torch.where(same, 0.0, (a - b).abs())
            near = (gap <= K5_ATOL) | (_ulps(a, b) <= K5_ULPS)
            err = max(err, float(gap.max()))
            if not bool(same.all()):
                differ[k] = int((~same).sum())
            if not bool((same | near).all()):
                off[k] = int((~(same | near)).sum())
        check(not off, f"[36] K5 lanes past 1e-6 / 4 ulp: {off}")
        ms = _time_ms(lambda: terrain.sphere_terrain_near(*args))
        plain_ms = _time_ms(
            lambda: terrain.sphere_terrain_near_reference(*args))
        b_ms, b_by = k5_bound(n, n_tris, cand, with_deepest)
        n_valid = int(ref[0].valid.sum())
        tag = "full" if with_deepest else "light"
        out[tag] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, differ=differ, n_valid=n_valid)
        print(f"[36] K5 {tag} (deepest {with_deepest}) on [4]'s pile after "
              f"{128 + K5_MORE_STEPS} steps, N={n}, {n_tris} faces, cand "
              f"{cand}, stable {cfg.stable_pairs}: ids and valid equal "
              f"({n_valid} valid slots), max_abs_err {err:.3g} (1e-6 or 4 "
              f"ulp), lanes that differ at all {differ}; kernel {ms}, plain "
              f"{plain_ms}, bound {b_ms:.4f} ms ({b_by})", flush=True)
    return out


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


def _cold_scene(dev):
    """The cold reference-schedule pile of [7] and [35]: stress_scene on
    the generic branch, no warm start, 20 two-phase sweeps, K2."""
    from mgf_tpu_torch.scenes import stress_scene
    world, cfg = stress_scene(N_MAIN, device=dev)
    cfg = cfg._replace(warm_start=False, fused_iso=False,
                       warm_match="search", adapt_schedule=None,
                       solver_iters=20, solver_inner=1, two_phase=True,
                       pallas_narrowphase=True)
    return world._replace(warm=None), cfg


def phase_cold_path(dev):
    from mgf_tpu_torch.driver import make_chunk_step
    world, cfg = _cold_scene(dev)
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
          f"K2 launches {launches} (expected {steps}), K5 launches "
          f"{counts['K5']}", flush=True)
    check(_finite(world), "cold pile: non-finite x, v or omega")
    check(overflow == 0, f"cold pile: broadphase overflow {overflow}")
    check(drift == 0.0, f"cold pile: broadphase drift excess {drift}")
    check(contacts > 0, "cold pile: no contacts")
    check(pen < 0.5, f"cold pile: max penetration {pen}")
    check(launches == steps, f"cold pile: K2 launches {launches} != {steps}")
    check(counts["K5"] == steps,
          f"cold pile: K5 launches {counts['K5']} != {steps}")
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
    escaped = escaped_bodies(world)
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


def _sm_clock_mhz():
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    return float(out.split()[0])


def k4_update_ns(mgf):
    """One point update's latency chain in ns (``K4_CHAIN_OPS`` dependent
    float32 operations and a shared-memory reload) at the card's maximum
    SM clock."""
    cycles = (K4_CHAIN_OPS["mgf" if mgf else "textbook"] * K4_OP_CYCLES
              + K4_SMEM_CYCLES)
    return 1e3 * cycles / _sm_clock_mhz()


def k4_bound(seq, inp, iters, mgf):
    """K4's least time on the captured list: its body-dependency graph's
    depth with the sweeps pipelined (``sequential_schedule`` run on over
    all ``iters`` sweeps: updates that share no dynamic body may run
    together, each body's in list order) times one update's latency chain.
    Returns (bound_ms, the schedule's numbers, ns per update); beside it
    the earlier design's bound, the whole list as one chain, for the
    record."""
    cpu = [inp[k].cpu() for k in ("a", "b", "valid", "bodies")]
    level = seq.sequential_schedule(*cpu)
    nv = int(cpu[2].sum())
    piped = int(seq.sequential_schedule(*cpu, sweeps=iters).max())
    ns = k4_update_ns(mgf)
    sched = dict(levels=int(level.max()), piped=piped, n_valid=nv,
                 widest=int(torch.bincount(level[cpu[2]]).max()) if nv else 0,
                 chain_ms=1e-6 * ns * iters * nv)
    return 1e-6 * ns * piped, sched, ns


def _k4_sched_str(sched, b_ms, ns):
    return (f"{sched['levels']} levels a sweep (widest "
            f"{sched['widest']} points), pipelined depth {sched['piped']}; "
            f"bound {1e3 * b_ms:.3f} us (depth x {ns:.1f} ns per update; "
            f"the earlier bound, the list as one chain of "
            f"iters x {sched['n_valid']} updates: "
            f"{sched['chain_ms']:.4f} ms)")


def _record_sequential(seq, world, cfg):
    """K4's inputs in one sequential step of ``world``."""
    from mgf_tpu_torch.world import step
    return seq.capture_inputs(
        lambda: step(world, cfg._replace(solver="sequential")))[0]


def _k4_run(seq, inp, iters, mgf, fn=None):
    fn = fn or seq.sequential_solve
    return fn(inp["pts"], inp["a"], inp["b"], inp["valid"], inp["bodies"],
              iters, mgf)


def _vw_err(a, b):
    a, b = a.cpu(), b.cpu()
    return (float((a[:, :3] - b[:, :3]).abs().max()),
            float((a[:, 3:6] - b[:, 3:6]).abs().max()))


def _k4_exact(seq, inp, iters, mgf, out_k, where):
    """K4's output against the serial plain version (the oracle) run on
    CPU copies of the inputs: equal bit for bit, and within K4_TOL."""
    cpu = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in inp.items()}
    out_s = _k4_run(seq, cpu, iters, mgf, seq.sequential_solve_reference)
    ev, ew = _vw_err(out_k, out_s)
    exact = torch.equal(out_k.cpu(), out_s)
    print(f"[14] K4 vs the serial plain version on the CPU, {where}, "
          f"friction {'mgf' if mgf else 'textbook'}: torch.equal {exact}, "
          f"max |dv| {ev:.3g}, |domega| {ew:.3g}", flush=True)
    torch.testing.assert_close(out_k.cpu(), out_s, **K4_TOL)
    check(exact, f"K4 differs from the serial plain version ({where})")
    return max(ev, ew)


def phase_k4_small(seq, dev):
    """[14] K4 against its plain versions at the 126-body landing step (the
    parallel solver brings the demo there, so the inputs do not depend on
    K4): the level plain version on the card and the serial one on the CPU,
    both modes, bit for bit."""
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
        out_p = _k4_run(seq, inp, iters, mgf,
                        seq.sequential_solve_levels_reference)
        torch.cuda.synchronize()
        ev, ew = _vw_err(out_k, out_p)
        err = max(err, ev, ew)
        print(f"[14] K4 vs the level plain version on the card, "
              f"balls_scene(5) landing ({inp['bodies'].shape[0]} body rows, "
              f"{inp['valid'].numel()} points, {nv} valid), {iters} sweeps, "
              f"friction {'mgf' if mgf else 'textbook'}: torch.equal "
              f"{torch.equal(out_k, out_p)}, max |dv| {ev:.3g}, |domega| "
              f"{ew:.3g} (atol 1e-4, rtol 1e-5)", flush=True)
        torch.testing.assert_close(out_k, out_p, **K4_TOL)
        check(torch.equal(out_k, out_p),
              "K4 differs from the level plain version at the landing")
        check(float((out_k[:, :3] - inp["bodies"][:, :3]).abs().max())
              > 0.1, "K4: the landing solve moved nothing")
        err = max(err, _k4_exact(seq, inp, iters, mgf, out_k, "landing"))
    ms = _time_ms(lambda: _k4_run(seq, inp, iters, True))
    b_ms, sched, ns = k4_bound(seq, inp, iters, True)
    print(f"[14] K4 at the landing, friction mgf: kernel {ms}, "
          f"{1e6 * ms / (iters * nv):.1f} ns per valid point-update; "
          f"{_k4_sched_str(sched, b_ms, ns)}", flush=True)
    return dict(err=err)


def phase_k4_demo(seq, k4, world, cfg):
    """[14], continued: K4 at the full demo's constraint list (one more
    sequential step from the state [15] ends in), held bit for bit against
    the serial plain version on CPU copies of the inputs, and timed beside
    the level plain version on the card and the depth-based bound."""
    inp = _record_sequential(seq, world, cfg)
    iters, mgf = inp["iters"], inp["mgf"]
    nv = int(inp["valid"].sum())
    out_k = _k4_run(seq, inp, iters, mgf)
    err = _k4_exact(seq, inp, iters, mgf, out_k, "the demo's list after [15]")
    ms = _time_ms(lambda: _k4_run(seq, inp, iters, mgf), reps=20)
    plain_ms = _time_ms(lambda: _k4_run(
        seq, inp, iters, mgf, seq.sequential_solve_levels_reference),
        reps=1, blocks=3)
    b_ms, sched, ns = k4_bound(seq, inp, iters, mgf)
    print(f"[14] K4 at the demo's list after [15] "
          f"({inp['bodies'].shape[0]} body rows, {inp['valid'].numel()} "
          f"points, {nv} valid, {iters} sweeps, friction "
          f"{'mgf' if mgf else 'textbook'}): kernel {ms} "
          f"({1e3 * ms:.2f} us; the earlier one-thread design 9.8670 ms), "
          f"{1e6 * ms / (iters * max(nv, 1)):.2f} ns per valid "
          f"point-update; the level plain version on the card {plain_ms}; "
          f"{_k4_sched_str(sched, b_ms, ns)}; bound / kernel "
          f"{100 * b_ms / ms:.1f} %", flush=True)
    return dict(err=max(k4["err"], err), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by="operations", n_valid=nv)


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
    out = escaped_bodies(world, floor=-10.0)
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


# [19] GJK/EPA: the f64 SAT oracle's margin and bars
# (tests/test_gjk_property.py)
N_GJK = 8192
N_GJK_CPU = 1024
SAT_MARGIN = 2e-3
# mgf_tpu's own answers on these pairs (jitted, on the CPU;
# scripts/mixed_reference_guards.py --gjk): tests/test_gjk_property.py's
# bars (0 decision errors, EPA depth within 0.02) hold on its own
# distribution but not on bench.py's, where separated pairs at up to 0.053
# come out as contacts and two deep pairs converge on a wrong face
GJK_REFERENCE = dict(errors=5, worst_depth=0.679, deep=2, touching=7)


def _rot_f64(q):
    """(n, 4) wxyz -> (n, 3, 3) rotations, f64."""
    w, x, y, z = (q[:, k] for k in range(4))
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def sat_depth(c1, q1, e1, c2, q2, e2):
    """15-axis SAT for n OBB pairs, f64: the smallest over the axes of the
    projected extents' sum minus the projected centre distance (positive:
    the penetration depth, exact for boxes; negative: a lower bound on the
    distance)."""
    r1, r2 = _rot_f64(q1), _rot_f64(q2)
    axes = [r1[:, :, k] for k in range(3)] + [r2[:, :, k] for k in range(3)]
    for i in range(3):
        for j in range(3):
            cr = np.cross(r1[:, :, i], r2[:, :, j])
            nrm = np.linalg.norm(cr, axis=-1, keepdims=True)
            axes.append(np.where(nrm > 1e-12, cr / np.maximum(nrm, 1e-300),
                                 np.nan))
    d = c2 - c1
    depth = np.full(len(c1), np.inf)
    for ax in axes:
        ra = np.sum(e1 * np.abs(np.einsum("nki,nk->ni", r1, ax)), -1)
        rb = np.sum(e2 * np.abs(np.einsum("nki,nk->ni", r2, ax)), -1)
        pen = ra + rb - np.abs(np.sum(d * ax, -1))
        depth = np.fmin(depth, pen)          # a degenerate axis is NaN
    return depth


def sat_oracle(out, depth_sat):
    """tests/test_gjk_property.py's checks on every pair clear of the SAT
    margin: decision errors (``valid`` against the SAT overlap), EPA depth
    errors (worst, and the count past 0.02), the worst distance shortfall
    below the SAT bound among the pairs ``separation`` reports separated,
    and the separated pairs it reports touching."""
    clear = np.abs(depth_sat) >= SAT_MARGIN
    over = depth_sat > 0.0
    pen = clear & over & out["valid"]
    err = np.abs(np.abs(out["depth"]) - depth_sat)[pen]
    sep = clear & ~over & ~out["valid"]
    return dict(
        clear=int(clear.sum()), over=int((clear & over).sum()),
        errors=int(np.sum(clear & (out["valid"] != over))),
        worst_depth=float(np.max(err, initial=0.0)),
        deep=int(np.sum(err > 0.02)),
        short=float(np.max(np.maximum(0.0, -depth_sat - out["dist"])[
            sep & out["sep"]], initial=0.0)),
        touching=int(np.sum(sep & ~out["sep"])))


def _gjk_call(a, b):
    """One call of the port's contact + separation on OBB pairs."""
    from mgf_tpu_torch.geom import support_obb
    from mgf_tpu_torch.gjk import contact_convex_convex_ex, separation
    sa = lambda d: support_obb(a, d)
    sb = lambda d: support_obb(b, d)
    ones = torch.ones_like(a.r.x)
    (c, sat), (dist, sep) = (contact_convex_convex_ex(sa, sb, ones),
                             separation(sa, sb, ones))
    depth = ((c.b.x - c.a.x) * c.n.x + (c.b.y - c.a.y) * c.n.y
             + (c.b.z - c.a.z) * c.n.z)
    return {k: v.cpu().numpy() for k, v in dict(
        valid=c.valid, sat=sat, depth=depth, dist=dist, sep=sep).items()}


def _profile_ops(fn):
    """(device operations, device ms, the three kernels with the most device
    time as "name share%") of one call of ``fn``, from torch.profiler's
    CUDA events (the device alone is traced: the host's events would cost
    ~0.1 ms each to collect and are not read)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    def short(name):
        # the functor or the op (where_kernel_impl -> where) of an
        # at::native kernel, else its name
        ops = (re.findall(r"(\w+?)_?[Ff]unctor\b", name)
               or re.findall(r"::(\w+?)_kernel_(?:impl|cuda)\b", name))
        return ops[-1] if ops else name.split("<")[0][-48:]
    return len(kernels), total / 1e3, ", ".join(
        f"{short(k)} {100.0 * v / max(total, 1e-9):.0f}%" for k, v in top)


def _median_s(fn, calls=5):
    """Median wall time of ``calls`` calls of ``fn``, each ended by a sync,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), min(times), max(times)


def phase_gjk(dev):
    """[19] GJK/EPA on 8,192 OBB pairs (BASELINE.json config 4)."""
    from mgf_tpu_torch.geom import support_obb
    from mgf_tpu_torch.gjk import contact_convex_convex
    from mgf_tpu_torch.math3d import tree_map
    a, b = obb_pairs(bench_obb_arrays(N_GJK), dev)
    _zero_counts()
    out = _gjk_call(a, b)
    counts = _counts()
    f64 = lambda box: tuple(x.astype(np.float64) for x in box)
    depth_sat = sat_depth(*(x for box in bench_obb_arrays(N_GJK)
                             for x in f64(box)))
    o = sat_oracle(out, depth_sat)

    # the first 1,024 pairs again on the CPU
    k = N_GJK_CPU
    cut = lambda o: tree_map(lambda x: x[:k].cpu(), o)
    cpu = _gjk_call(cut(a), cut(b))
    gpu = {key: v[:k] for key, v in out.items()}
    clear_k = (np.abs(depth_sat) >= SAT_MARGIN)[:k]
    flips = int(np.sum(cpu["valid"] != gpu["valid"]))
    flips_clear = int(np.sum((cpu["valid"] != gpu["valid"]) & clear_k))
    both = cpu["valid"] & gpu["valid"]
    d_depth = float(np.max(np.abs(cpu["depth"] - gpu["depth"])[both],
                           initial=0.0))
    both_sep = cpu["sep"] & gpu["sep"]
    d_dist = float(np.max(np.abs(cpu["dist"] - gpu["dist"])[both_sep],
                          initial=0.0))

    ones = torch.ones(N_GJK, device=dev)
    contact = lambda: contact_convex_convex(
        lambda d: support_obb(a, d), lambda d: support_obb(b, d), ones)
    med, lo, hi = _median_s(contact)
    ops, dev_ms, top = _profile_ops(contact)
    ref, slack = GJK_REFERENCE, N_GJK // 1000
    print(f"[19] GJK/EPA, {N_GJK} OBB pairs (BASELINE config 4): "
          f"{N_GJK / med:.1f} pairs/s ({1e3 * med:.2f} ms per "
          f"contact_convex_convex call, median of 5; min {1e3 * lo:.2f}, max "
          f"{1e3 * hi:.2f}); {ops} device operations, {dev_ms:.2f} ms device "
          f"time per call (top: {top}); SAT oracle on {o['clear']} clear "
          f"pairs ({o['over']} penetrating): {o['errors']} decision errors "
          f"(mgf_tpu {ref['errors']}), worst EPA depth error "
          f"{o['worst_depth']:.3g} (mgf_tpu {ref['worst_depth']}), depth "
          f"errors past 0.02 {o['deep']} (mgf_tpu {ref['deep']}), worst "
          f"distance shortfall {o['short']:.3g} (limit 0.01), separated "
          f"pairs reported touching {o['touching']} (mgf_tpu "
          f"{ref['touching']}); EPA-saturated lanes {int(out['sat'].sum())}; "
          f"card vs CPU on the first {k}: valid differs on {flips} "
          f"({flips_clear} clear), max |ddepth| {d_depth:.3g}, max |ddist| "
          f"{d_dist:.3g} (atol 1e-4); kernel launches {counts}", flush=True)
    # mgf_tpu itself misses tests/test_gjk_property.py's bars on these
    # pairs (GJK_REFERENCE): each count may pass its own by 0.1 % of them
    for key in ("errors", "deep", "touching"):
        check(o[key] <= ref[key] + slack,
              f"gjk: {key} {o[key]}, mgf_tpu {ref[key]}")
    check(o["short"] <= 0.01, f"gjk: distance shortfall {o['short']}")
    check(flips_clear == 0, f"gjk: card vs CPU valid on {flips_clear}")
    check(d_depth <= 1e-4 and d_dist <= 1e-4,
          f"gjk: card vs CPU depth {d_depth}, dist {d_dist}")
    check(not any(counts.values()),
          f"gjk launched a hand-written kernel: {counts}")
    return counts


# [20] the world queries (bench.py's bench_raytrace sizes)
N_RAYS = 16384
N_MESH_RAYS = 4096
RAY_GRID = dict(cell_size=1.25, dims=(128, 16, 128), cap=24)


def _mismatch(grid_out, dense_out, atol=1e-4):
    (ig, bg), (i_d, bd) = grid_out, dense_out
    hg, hd = ig.hit, i_d.hit
    both = hg & hd
    bad = (hg != hd) | (both & (((ig.t - i_d.t).abs() > atol) | (bg != bd)))
    return int(bad.sum()), int(hd.sum())


def _query_recount(state, box_c, box_r):
    """query_aabb's answer recounted in numpy: swept sphere / capsule AABBs
    (radius r, or r + half height) against the box."""
    x = np.stack([c.cpu().numpy() for c in state.x], -1).astype(np.float64)
    dl = np.stack([c.cpu().numpy() for c in state.delta], -1).astype(
        np.float64)
    reach = (state.shape_r + torch.where(state.shape_type == 0, 0.0,
                                         state.shape_half_h)).cpu().numpy()
    lo = np.minimum(x, x + dl) - reach[:, None]
    hi = np.maximum(x, x + dl) + reach[:, None]
    return int(np.sum(np.all((lo <= box_c + box_r) & (hi >= box_c - box_r),
                             axis=1)))


def phase_queries(dev, pile):
    """[20] grid and dense ray casts into the flagship pile, the mesh ray
    casts over the heightfield, one AABB query."""
    from mgf_tpu_torch.geom import AABB
    from mgf_tpu_torch.math3d import Vec3
    from mgf_tpu_torch.mesh import build_mesh_grid, mesh_from_arrays
    from mgf_tpu_torch.queries import (
        build_body_grid, query_aabb, raytrace_bodies,
        raytrace_bodies_grid_steps, raytrace_mesh, raytrace_mesh_grid,
    )
    from mgf_tpu_torch.scenes import terrain_scene
    state = pile.bodies
    _zero_counts()
    grid = build_body_grid(state, **RAY_GRID)
    overflow = int(grid.overflow)
    (p, d), = bench_rays(state, N_RAYS, 1)      # bench.py's first set
    ig, bg, steps = raytrace_bodies_grid_steps(grid, p, d)
    dense = raytrace_bodies(state, p, d)
    mism, hits = _mismatch((ig, bg), dense)

    w_t, _ = terrain_scene(10, device=dev)
    tri = w_t.terrain
    v = np.concatenate([np.stack([getattr(tri, s_).x.cpu().numpy(),
                                  getattr(tri, s_).y.cpu().numpy(),
                                  getattr(tri, s_).z.cpu().numpy()], -1)
                        for s_ in "abc"])
    mesh = mesh_from_arrays(v, np.arange(v.shape[0]).reshape(3, -1).T,
                            device=dev)
    mgrid = build_mesh_grid(mesh, 4.0, dim=64, cap=16)
    rng = np.random.default_rng(5)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    ext = float(np.abs(v[:, 0]).max())
    mp = Vec3(t(rng.uniform(-ext, ext, N_MESH_RAYS)),
              t(np.full(N_MESH_RAYS, 25.0)),
              t(rng.uniform(-ext, ext, N_MESH_RAYS)))
    md = np.stack([rng.uniform(-0.4, 0.4, N_MESH_RAYS),
                   -np.ones(N_MESH_RAYS),
                   rng.uniform(-0.4, 0.4, N_MESH_RAYS)], -1)
    md /= np.linalg.norm(md, axis=1, keepdims=True)
    md = Vec3(*(t(md[:, k]) for k in range(3)))
    mg, fg = raytrace_mesh_grid(mesh, mgrid, mp, md)
    mdn, fdn = raytrace_mesh(mesh, mp, md)
    m_hit = mg.hit & mdn.hit
    m_bad = int(((mg.hit != mdn.hit)
                 | (m_hit & ((mg.t - mdn.t).abs() > 1e-4))).sum())

    box_c = np.asarray([float(state.x.x.mean()), float(state.x.y.mean()),
                        float(state.x.z.mean())])
    box_r = np.asarray([6.0, 3.0, 6.0])
    mask = query_aabb(state, AABB(c=Vec3(*(t(c) for c in box_c)),
                                  r=Vec3(*(t(r) for r in box_r))))
    n_query, n_recount = int(mask.sum()), _query_recount(state, box_c, box_r)
    counts = _counts()

    g_call = lambda: raytrace_bodies_grid_steps(grid, p, d)
    d_call = lambda: raytrace_bodies(state, p, d)
    g_med, g_lo, g_hi = _median_s(g_call)
    d_med, d_lo, d_hi = _median_s(d_call)
    g_prof, d_prof = _profile_ops(g_call), _profile_ops(d_call)
    print(f"[20] world queries on the flagship pile after [4] "
          f"({state.n_bodies} bodies): body grid cell "
          f"{RAY_GRID['cell_size']} dims {RAY_GRID['dims']} cap "
          f"{RAY_GRID['cap']} overflow {overflow}; {N_RAYS} downward rays: "
          f"grid {N_RAYS / g_med:.1f} rays/s ({1e3 * g_med:.2f} ms per call, "
          f"min {1e3 * g_lo:.2f}, max {1e3 * g_hi:.2f}), dense "
          f"{N_RAYS / d_med:.1f} rays/s ({1e3 * d_med:.2f} ms, min "
          f"{1e3 * d_lo:.2f}, max {1e3 * d_hi:.2f}); device operations and "
          f"ms a call: grid {g_prof[0]}, {g_prof[1]:.2f} (top: {g_prof[2]}), "
          f"dense {d_prof[0]}, {d_prof[1]:.2f} (top: {d_prof[2]}); "
          f"{hits} hits, grid vs "
          f"dense mismatches {mism} (hit, t atol 1e-4, body); most DDA "
          f"iterations {int(steps.max())} (median "
          f"{float(steps.float().median()):.0f}); mesh "
          f"({mesh.n_faces} faces, face grid overflow "
          f"{int(mgrid.overflow)}): {N_MESH_RAYS} rays, "
          f"{int(mdn.hit.sum())} hits, grid vs dense mismatches {m_bad}; "
          f"query_aabb {n_query} bodies, numpy recount {n_recount}; kernel "
          f"launches {counts}", flush=True)
    check(overflow == 0, f"queries: body grid overflow {overflow}")
    check(mism == 0 and hits > 0, f"queries: {mism} grid/dense mismatches")
    check(int(mgrid.overflow) == 0 and m_bad == 0 and int(mdn.hit.sum()) > 0,
          f"queries: mesh grid/dense mismatches {m_bad}")
    check(n_query == n_recount and n_query > 0,
          f"queries: query_aabb {n_query} vs recount {n_recount}")
    check(not any(counts.values()),
          f"queries launched a hand-written kernel: {counts}")
    return counts


# ---------------------------------------------------------------------------
# [21]-[25]: the broadphase variants, the refit cache, the stage probes,
# the capacity world with its surgery and checkpoint, the demos and entry
# ---------------------------------------------------------------------------

# the sel8 octant grid of mgf_tpu/scenes.py:255-261: cell 2.4, cap 24
SEL8_CELL, SEL8_CAP = 2.4, 24
FAT_VARIANTS = ("fat", "fat8", "fat8x4")
# [21]: each variant's contacts at step 64 within this share of [4]'s
VARIANT_CONTACT_SHARE = 0.02
# [21]: the pair reach excess mgf_tpu's own octant modes show in the same
# collapse on the CPU (scripts/mixed_reference_guards.py --fat-variants,
# 64 steps; the excess at step 64 and the worst step): the half-cell
# guarantee of cell 2.4 is not met there either, so the octant's window
# is held to the pairs it could miss, not to this metric
REACH_REFERENCE = {3000: (0.025504, 0.045480), 8000: (0.050861, 0.077453)}
N_CAPACITY = 150_000          # past 2^17 rows: the float-score top-k
N_SURGERY = 1_000             # bodies killed, then spawned, in [24]
STAGES = ("integrate", "pairs", "narrow", "terrain", "rows", "constraints",
          "warm", "solve")
# [22]: a margin of 0.1, and one whose drift trigger (margin / 2) passes
# the fastest body's step on the pile, so that reuse steps happen
BP_MARGINS = (0.1, 0.5)
SMOKE_DIR = "build/smoke"     # [24]'s checkpoint, [25]'s demo outputs


def _variant_cfg(world, cfg, mode):
    """The flagship config in broadphase ``mode``: "fat" on the scene's own
    grid, the octant modes on the sel8 grid, its x/z dims by the scene's
    rule (the modulus past the box's span, mgf_tpu/scenes.py:265-267) and
    16 cells in y."""
    from mgf_tpu_torch.broadphase import GridConfig
    cfg = cfg._replace(broadphase=mode)
    if mode == "fat":
        return cfg
    wall = float(world.terrain.a.x.abs().max())
    dim = 32
    while dim * SEL8_CELL < 2.0 * wall + 10.0:
        dim *= 2
    return cfg._replace(grid=GridConfig(cell_size=SEL8_CELL,
                                        dim=(dim, 16, dim),
                                        bucket_cap=SEL8_CAP))


def _stream_diff(m_g, m_c):
    """The share of pair-stream entries (partner index or validity) in
    which the card's step differs from the CPU's."""
    pg, pc = m_g["pair_contacts"], m_c["pair_contacts"]
    j_g, j_c = pg["j"].cpu(), pc["j"]
    v_g, v_c = pg["contact"].valid.cpu(), pc["contact"].valid
    return float(((j_g != j_c) | (v_g != v_c).any(0)).float().mean())


def phase_fat_variants(dev, contacts64):
    """[21] stress_scene(100_000) from scratch, 64 steps in each of the
    broadphase modes fat / fat8 / fat8x4, then the card against the CPU on
    an 8k pile in each."""
    from mgf_tpu_torch import world_from_numpy, world_to_numpy
    from mgf_tpu_torch.driver import AdaptiveChunkStepper
    from mgf_tpu_torch.scenes import stress_scene
    from mgf_tpu_torch.world import step
    paths = []
    for mode in FAT_VARIANTS:
        world, cfg = stress_scene(N_MAIN, device=dev)
        cfg = _variant_cfg(world, cfg, mode)
        chunk, n_chunks = 16, 4
        st = AdaptiveChunkStepper(cfg, chunk=chunk, light=True)
        it2 = int(cfg.adapt_schedule[1])
        expected, window, reach_ends = 0, [0, 0], []
        _zero_counts()

        def run(w, _ones):
            nonlocal expected
            w, m = st.step_chunk(w)
            expected += chunk * (it2 if st.hot_on else cfg.solver_iters)
            reach_ends.append(float(m["broadphase_reach_excess"][-1]))
            if mode != "fat":
                for k, v in enumerate(_window_misses(w, cfg)):
                    window[k] += v
            return w, m

        world, chunk_s, rebuilds, overflow, drift, last = _run_chunks(
            run, world, n_chunks, chunk)
        counts = _counts()
        overflow = max(overflow)
        reach = max(reach_ends)
        contacts = int(last["num_contacts"])
        pen = float(last["max_penetration"])
        sps = chunk * (n_chunks - 1) / sum(chunk_s[1:])
        print(f"[21] stress_scene({N_MAIN}) broadphase={mode} grid "
              f"{tuple(cfg.grid)}, 64 steps: {sps:.2f} steps/s (steps "
              f"17-64), rebuilds {rebuilds}, contacts {contacts} ([4] at step "
              f"64: {contacts64}), max penetration {pen:.4f}, overflow "
              f"{overflow}, reach excess worst chunk end {reach}"
              + ("" if mode == "fat" else
                 f" (the octant covers half a cell; mgf_tpu's own run, "
                 f"bodies: (at step 64, worst step) {REACH_REFERENCE}; "
                 f"pairs of a 27-cell build of the same grid that the "
                 f"octant lacks at the chunk ends: {window[0]}, and "
                 f"{window[1]} past a full row)")
              + f", drift excess {drift}, warm_hit_frac "
              f"{float(last['warm_hit_frac']):.4f}, K1 launches "
              f"{counts['K1']} (expected {expected})", flush=True)
        check(_finite(world), f"{mode}: non-finite x, v or omega")
        check(overflow == 0, f"{mode}: broadphase overflow {overflow}")
        if mode == "fat":
            check(reach == 0.0, f"{mode}: broadphase reach excess {reach}")
        else:
            # mgf_tpu's own octant runs pass the half-cell guarantee in the
            # collapse too (REACH_REFERENCE): hold the window to what the
            # excess could cost, a pair the 27-cell window finds
            check(window[0] == 0, f"{mode}: the octant window missed "
                  f"{window[0]} pairs")
        check(drift == 0.0, f"{mode}: broadphase drift excess {drift}")
        check(pen < 0.5, f"{mode}: max penetration {pen}")
        check(abs(contacts - contacts64) <= VARIANT_CONTACT_SHARE * contacts64,
              f"{mode}: contacts {contacts} vs [4]'s {contacts64}")
        check(counts["K1"] == expected and expected > 0,
              f"{mode}: K1 launches {counts['K1']} != {expected}")
        paths.append(counts)
        del world
    for mode in FAT_VARIANTS:
        world, cfg = stress_scene(N_E2E, device=dev)
        one = _variant_cfg(world, cfg, mode)._replace(adapt_schedule=None)
        for _ in range(40):
            world, _ = step(world, one)
        w_cpu = world_from_numpy(world_to_numpy(world), "cpu")
        w_g, m_g = step(world, one, collect_contacts=True)
        w_c, m_c = step(w_cpu, one, collect_contacts=True)
        n_g, n_c = int(m_g["num_contacts"]), int(m_c["num_contacts"])
        differ = _stream_diff(m_g, m_c)
        err = max(float((a.cpu() - b).abs().max())
                  for f in ("v", "omega")
                  for a, b in zip(getattr(w_g.bodies, f),
                                  getattr(w_c.bodies, f)))
        print(f"[21] {N_E2E}-body pile, broadphase={mode}, after 40 card "
              f"steps, one more step: contacts card {n_g} / cpu {n_c}, pair "
              f"stream entries that differ {differ:.3g} (limit 1e-3), max "
              f"|dv|,|domega| {err:.3g} (atol 1e-3)", flush=True)
        check(n_c > 0 and abs(n_g - n_c) <= 0.001 * n_c,
              f"{mode}: contact counts {n_g} vs {n_c}")
        check(differ <= 1e-3, f"{mode}: pair streams differ in {differ}")
        check(err <= 1e-3, f"{mode}: v/omega differ by {err}")
    return paths


def _fresh_pairs(world, cfg):
    """The candidate list a fresh, uncached build makes in this step (the
    step's own integrate and swept fat bounds, no cache slack)."""
    from mgf_tpu_torch import broadphase
    from mgf_tpu_torch import world as tw
    from mgf_tpu_torch.physics import complete_motion, integrate
    state = integrate(complete_motion(world.bodies), cfg.dt, iso=True)
    bounds = broadphase.swept_fat_bounds(
        tw._body_bounds(cfg, tw.shape_view(state)), state.delta, cfg.fatten)
    partner, ok, _ = tw._fat_pairs(bounds, state.shape_r > 0.0, cfg)
    return partner, ok


def _window_misses(world, cfg):
    """The next step's octant build against a 27-cell build on the same
    grid (which covers reach up to a whole cell), both keeping 64
    partners: (pairs the octant lacks where its row has a free slot,
    pairs it lacks past a full row)."""
    wide = cfg._replace(max_pairs=64, stable_pairs=False)
    return _cache_misses(_fresh_pairs(world, wide._replace(broadphase="fat")),
                         _fresh_pairs(world, wide))


def _cache_misses(fresh, cached):
    """(misses, cut): pairs of the fresh build that the cached list lacks
    where the body's cached row has a free slot (a miss: the cached
    candidate set was not conservative), and where its row is full (the
    top-k cut of the build kept 9 partners that were closer then)."""
    (fp, fok), (cp, cok) = fresh, cached
    found = (fp[:, :, None] == torch.where(cok, cp, -2)[:, None, :]).any(-1)
    lacking = fok & ~found
    full = cok.all(dim=1, keepdim=True)
    return int((lacking & ~full).sum()), int((lacking & full).sum())


def phase_bp_margin(pile, cfg):
    """[22] the refit cache on [4]'s pile: for each margin, 64 steps with
    bp_every=1 (fresh cache), then 64 with bp_every=32; on every reuse
    step the cached list is held against a fresh build of that step."""
    from mgf_tpu_torch.world import init_bp_cache, step
    world = pile
    _zero_counts()
    for margin in BP_MARGINS:
        for every in (1, 32):
            c = cfg._replace(bp_every=every, bp_margin=margin)
            world = init_bp_cache(world, c)
            rebuilds = reuse = misses = cut = 0
            drift = reach = fastest = 0.0
            t0 = time.perf_counter()
            for _ in range(64):
                fresh = _fresh_pairs(world, c)
                world, m = step(world, c)
                d = world.bodies.delta
                fastest = max(fastest, float(torch.sqrt(
                    d.x * d.x + d.y * d.y + d.z * d.z).max()))
                if bool(m["broadphase_rebuilt"]):
                    rebuilds += 1
                else:
                    reuse += 1
                    mi, cu = _cache_misses(fresh, (world.bp.partner,
                                                   world.bp.ok))
                    misses += mi
                    cut += cu
                drift = max(drift, float(m["broadphase_cache_drift_excess"]))
                reach = max(reach, float(m["broadphase_reach_excess"]))
            torch.cuda.synchronize()
            sps = 64 / (time.perf_counter() - t0)
            print(f"[22] bp_margin={margin}, bp_every={every}, 64 steps on "
                  f"[4]'s pile: rebuilds {rebuilds}, reuse steps {reuse}, "
                  f"pairs of a fresh build missing from the cached list "
                  f"{misses} (and {cut} past a full row's top-9), fastest "
                  f"body {fastest:.4f} a step (the drift trigger: "
                  f"{0.5 * margin}), drift excess {drift}, reach excess "
                  f"{reach}, contacts {int(m['num_contacts'])}, max "
                  f"penetration {float(m['max_penetration']):.4f}; "
                  f"{sps:.2f} steps/s with the check", flush=True)
            check(_finite(world), "bp_margin: non-finite x, v or omega")
            check(drift == 0.0, f"bp_margin: drift excess {drift}")
            check(reach == 0.0, f"bp_margin: reach excess {reach}")
            check(int(m["broadphase_overflow"]) == 0, "bp_margin: overflow")
            check(misses == 0, f"bp_margin: {misses} pairs missed by the "
                  f"cache")
            if margin == BP_MARGINS[-1]:
                check(reuse > 0, f"bp_margin={margin}: no reuse step")
    return _counts()


def _probe_ms(world, cfg, stage, reps=5):
    """(probe, median ms of ``reps`` timed calls) of one stage prefix."""
    from mgf_tpu_torch.world import step
    c = cfg._replace(profile_stage=stage)
    step(world, c)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(world, c)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return m.get("probe"), float(np.median(times))


def phase_probes(pile, cfg, dev):
    """[23] the eight stage prefixes on [4]'s pile, timed; the probes of an
    8k pile on the card against the CPU."""
    from mgf_tpu_torch import world_from_numpy, world_to_numpy
    from mgf_tpu_torch.scenes import stress_scene
    from mgf_tpu_torch.world import step
    one = cfg._replace(adapt_schedule=None)
    parts = []
    _zero_counts()
    for stage in STAGES:
        probe, ms = _probe_ms(pile, one, stage)
        check(bool(torch.isfinite(probe.float())), f"probe {stage} {probe}")
        parts.append(f"{stage} {probe.item():.6g} in {ms:.2f} ms")
    full_ms = _probe_ms(pile, one, "")[1]
    counts = _counts()
    print(f"[23] stage prefixes on [4]'s pile (median of 5, the full step "
          f"{full_ms:.2f} ms): " + "; ".join(parts), flush=True)
    world, cfg8 = stress_scene(N_E2E, device=dev)
    one8 = cfg8._replace(adapt_schedule=None)
    for _ in range(40):
        world, _ = step(world, one8)
    w_cpu = world_from_numpy(world_to_numpy(world), "cpu")
    worst = {}
    n = world.bodies.n_bodies
    for stage in STAGES:
        c = one8._replace(profile_stage=stage)
        g = step(world, c)[1]["probe"].cpu()
        h = step(w_cpu, c)[1]["probe"]
        d = abs(float(g) - float(h))
        # [5]'s tolerances: counts within 0.1 %, each velocity within 1e-3
        lim = (1e-3 * 2 * n if stage == "solve"
               else 1e-3 * max(1.0, abs(float(h))))
        worst[stage] = (float(g), float(h))
        check(d <= lim, f"probe {stage}: card {float(g)} vs cpu {float(h)}")
    print(f"[23] {N_E2E}-body pile after 40 card steps, probes card / cpu: "
          + "; ".join(f"{k} {g:.6g} / {h:.6g}" for k, (g, h) in worst.items()),
          flush=True)
    return counts


def _spawn_block(n, dev):
    """``n`` spheres in two layers above the pile (y 16.5 and 17.75)."""
    from mgf_tpu_torch.physics import SceneBuilder
    per = n // 2
    side = int(np.ceil(np.sqrt(per)))
    i = np.arange(per)
    layer = np.stack([(i // side - side / 2) * 1.25, np.zeros(per),
                      (i % side - side / 2) * 1.25], -1)
    pos = np.concatenate([layer + [0.0, 16.5, 0.0],
                          layer + [0.0, 17.75, 0.0]]).astype(np.float32)
    b = SceneBuilder()
    b.add_spheres(pos, 0.5, mass=1.0, restitution=0.3, friction=0.6)
    return b.build(dev)


def phase_capacity(pile, cfg, dev):
    """[24] [4]'s pile padded to a 150,000-row capacity world: 64 steps,
    kill 1,000, 16 steps, spawn 1,000, 64 steps; validation, metrics
    checks, and a checkpoint round trip."""
    import os
    from mgf_tpu_torch.driver import AdaptiveChunkStepper
    from mgf_tpu_torch.utils import load_world, save_world
    from mgf_tpu_torch.utils.debug import check_step_metrics, validate_world
    from mgf_tpu_torch.world import (free_slots, init_bp_cache, init_warm,
                                     kill_bodies, num_alive, remove_bodies,
                                     spawn_bodies, step, with_capacity)
    world = with_capacity(pile._replace(warm=None, bp=None), N_CAPACITY)
    world = init_bp_cache(init_warm(world, cfg), cfg)
    shapes = [tuple(t.shape) for t in _leaves(world)]
    st = AdaptiveChunkStepper(cfg, chunk=16, light=True)
    _zero_counts()
    alive, overflow, sps = [num_alive(world)], 0, []

    def run(w, n_chunks):
        nonlocal overflow
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            w, m = st.step_chunk(w)
            overflow = max(overflow, int(m["broadphase_overflow"].max()))
        torch.cuda.synchronize()
        sps.append(16 * n_chunks / (time.perf_counter() - t0))
        return w, {k: v[-1] for k, v in m.items()}

    world, m = run(world, 4)
    killed = np.arange(0, N_MAIN, N_MAIN // N_SURGERY)[:N_SURGERY]
    world = kill_bodies(world, killed)
    alive.append(num_alive(world))
    world, m = run(world, 1)
    free = free_slots(world)
    world, idx = spawn_bodies(world, _spawn_block(N_SURGERY, dev))
    alive.append(num_alive(world))
    world, m = run(world, 4)
    counts = _counts()
    same_shapes = [tuple(t.shape) for t in _leaves(world)] == shapes
    live = remove_bodies(world, free_slots(world))._replace(warm=None,
                                                            bp=None)
    validate_world(live, cfg)
    check_step_metrics(m, max_penetration=0.5)
    os.makedirs(SMOKE_DIR, exist_ok=True)
    path = os.path.join(SMOKE_DIR, "capacity_world.npz")
    t0 = time.perf_counter()
    save_world(path, world)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_world(path, world)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    size_mb = os.path.getsize(path) / 1e6
    bit_equal = all(bool(torch.equal(a, b)) and a.dtype == b.dtype
                    for a, b in zip(_leaves(world), _leaves(loaded)))
    one = cfg._replace(adapt_schedule=None)
    w_a, m_a = step(world, one)
    w_b, m_b = step(loaded, one)
    err = max(float((a - b).abs().max()) for f in ("v", "omega")
              for a, b in zip(getattr(w_a.bodies, f), getattr(w_b.bodies, f)))
    os.remove(path)
    print(f"[24] capacity world {N_CAPACITY} rows from [4]'s pile: num_alive "
          f"{' -> '.join(map(str, alive))}; {N_SURGERY} killed (every "
          f"{N_MAIN // N_SURGERY}th), {N_SURGERY} spawned into rows "
          f"{int(idx.min())}..{int(idx.max())} (the killed rows first: "
          f"{bool(np.array_equal(idx, killed))}); steps/s {', '.join(f'{s:.2f}' for s in sps)} "
          f"(64, 16, 64 steps); overflow worst step {overflow}; shapes "
          f"unchanged {same_shapes}; contacts {int(m['num_contacts'])}, max "
          f"penetration {float(m['max_penetration']):.4f}; checkpoint "
          f"{size_mb:.1f} MB, save {save_s:.2f} s, load {load_s:.2f} s, "
          f"bit-equal {bit_equal}, one step from each: contacts "
          f"{int(m_a['num_contacts'])} / {int(m_b['num_contacts'])}, max "
          f"|dv|,|domega| {err:.3g} (atol 1e-3)", flush=True)
    check(alive == [N_MAIN, N_MAIN - N_SURGERY, N_MAIN],
          f"num_alive {alive}")
    check(np.array_equal(free[:N_SURGERY], killed)
          and np.array_equal(idx, killed), "spawn did not reuse the killed "
          "rows first")
    check(same_shapes, "a tensor of the capacity world changed shape")
    check(overflow == 0, f"capacity world: overflow {overflow}")
    check(_finite(world), "capacity world: non-finite x, v or omega")
    check(bit_equal, "checkpoint round trip is not bit-equal")
    check(int(m_a["num_contacts"]) == int(m_b["num_contacts"]) and err <= 1e-3,
          f"step from the loaded world differs by {err}")
    check(counts["K1"] > 0, f"capacity world: K1 launches {counts}")
    return counts


def _leaves(world):
    from mgf_tpu_torch.utils.checkpoint import _flatten_with_paths
    return [t for _, t in _flatten_with_paths(world)]


def _run_demo(script, *args):
    """Run a torch demo in a fresh process; its stdout (exit code 0 is
    checked)."""
    import os
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, f"demos/{script}", *args],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"{script} exited {out.returncode}: "
          f"{out.stderr[-2000:]}")
    return out.stdout, wall


def _ppm_header(path):
    with open(path, "rb") as fh:
        return fh.read(15)


def phase_demos_entry(dev):
    """[25] both torch demos as processes of their own, 60 steps, and one
    call of entry()'s step on the card."""
    import os
    import re as _re
    from mgf_tpu_torch.entry import entry
    os.makedirs(SMOKE_DIR, exist_ok=True)
    traj, b_ppm = f"{SMOKE_DIR}/balls.npz", f"{SMOKE_DIR}/balls.ppm"
    c_ppm = f"{SMOKE_DIR}/capsules.ppm"
    out_b, wall_b = _run_demo("balls_torch.py", "--steps", "60", "--save",
                              traj, "--render", b_ppm)
    out_c, wall_c = _run_demo("capsules_torch.py", "--steps", "60",
                              "--render", c_ppm)
    x = np.load(traj)["x"]
    k2 = int(_re.search(r"K2 (\d+)", out_b).group(1))
    ms = [float(v) for v in _re.findall(r"took ([0-9.]+) ms", out_c)]
    ms_b = [float(v) for v in _re.findall(r"took ([0-9.]+) ms", out_b)]
    heads = (_ppm_header(b_ppm), _ppm_header(c_ppm))
    fn, args = entry()
    _zero_counts()
    w_e, m_e = fn(*args)
    counts = _counts()
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(torch.as_tensor(v).float()).all())
                 for v in m_e.values())
    print(f"[25] demos/balls_torch.py --steps 60: exit 0 in {wall_b:.1f} s, "
          f"trajectory {x.shape}, median step {np.median(ms_b):.2f} ms, K2 "
          f"launches {k2}; demos/capsules_torch.py --steps 60: exit 0 in "
          f"{wall_c:.1f} s, median step {np.median(ms):.2f} ms; PPM headers "
          f"{heads}; entry(): {args[0].bodies.n_bodies} bodies on "
          f"{args[0].bodies.x.x.device}, contacts "
          f"{int(m_e['num_contacts'])}, metrics finite {finite}",
          flush=True)
    n_b = x.shape[1] if x.ndim == 3 else -1
    check(x.shape == (60, n_b, 3) and n_b == 1332,
          f"balls trajectory shape {x.shape}")
    check(k2 == 61, f"balls demo K2 launches {k2} != 61 (one per step)")
    check(all(h == b"P6\n640 480\n255\n" for h in heads),
          f"PPM headers {heads}")
    check("capsules: 1331 capsules" in out_c, "capsules demo scene")
    check(args[0].bodies.x.x.is_cuda and finite, "entry() step on the card")
    for p in (traj, b_ppm, c_ppm):
        os.remove(p)
    # the demo processes' own launches ([25]'s path) beside entry()'s
    demo = {k: sum(int(v) for v in _re.findall(rf"{k} (\d+)", o))
            for k, o in (("K1", out_b + out_c), ("K2", out_b + out_c),
                         ("K4", out_b + out_c))}
    return {k: counts[k] + demo.get(k, 0) for k in counts}


# ---------------------------------------------------------------------------
# [26]-[28]: the multi-device paths (mgf_tpu_torch.parallel) as ranks: four
# processes sharing the one card over gloo (host-staged messages), four CPU
# ranks, and NCCL with one rank per card
# ---------------------------------------------------------------------------

N_RANKS = 4
HALO_MAIN = 4096      # [26]: halo rows per direction at 100k bodies
HALO_E2E = 1024       # [27]: at 8,000 bodies
# [26]: contacts at steps 64 and 128 within this share of [4]'s: the worst
# gap between mgf_tpu's own spatial step on 4 CPU devices and its
# single-device step on the same pile (scripts/mixed_reference_guards.py
# --spatial, 128 steps from scratch): 3.34 % at 8,000 bodies (step 128),
# 1.06 % at 100,000 (212,243 / 212,239 at step 64, 497,946 / 503,295 at
# step 128).  [4]'s chunk stepper picks its schedule two chunks late and
# sits 1.87 % below mgf_tpu's single-device step at step 64 (208,260), so
# 100k's 1.06 + 1.87 % is inside the 8k gap too
SPATIAL_CONTACT_SHARE = 0.035
# [27]: positions of the card ranks after 8 steps beside the port's
# single-device step on the card: mgf_tpu meets a gap of 2.86e-6 on the same
# scene (--spatial --bodies 8000 --settle 40 --steps 8) with equal
# contacts; the guard is the CPU tests' per-row tolerance after one step
SPATIAL_GAP_8 = 1e-5
SPATIAL_TOL = 1e-3    # [27]: v and omega, card ranks against CPU ranks
N_SHARDED_STEPS = 16


def _rank_counters():
    """Launch and message counters of this rank's process."""
    from mgf_tpu_torch.ops import (
        narrowphase, sequential_solve, solver_sweep, terrain,
    )
    from mgf_tpu_torch.parallel import comm as pcomm
    return ((narrowphase, "LAUNCHES"), (sequential_solve, "LAUNCHES"),
            (solver_sweep, "LAUNCHES"), (solver_sweep, "BLOCKMAJOR_LAUNCHES"),
            (terrain, "LAUNCHES"), (pcomm, "BYTES"), (pcomm, "MESSAGES"))


def _rank_zero():
    for mod, attr in _rank_counters():
        setattr(mod, attr, 0)


def _rank_launches():
    """This rank's kernel launches since _rank_zero, as _counts names them."""
    from mgf_tpu_torch.ops import (
        narrowphase, sequential_solve, solver_sweep, terrain,
    )
    return {"K1": solver_sweep.LAUNCHES, "K2": narrowphase.LAUNCHES,
            "K3": solver_sweep.BLOCKMAJOR_LAUNCHES,
            "K4": sequential_solve.LAUNCHES, "K5": terrain.LAUNCHES}


def _timed_steps(comm, world, step_fn, steps, on_step=None):
    """Step ``steps`` times; per step the wall seconds, the reduced metrics
    (host floats), and the bytes and messages this rank sent.  ``on_step(k,
    world, metrics)`` may return a new (world, step_fn)."""
    from mgf_tpu_torch.parallel import comm as pcomm
    sync = (torch.cuda.synchronize if comm.device.type == "cuda"
            else (lambda: None))
    series = []
    for k in range(steps):
        b0, n0 = pcomm.BYTES, pcomm.MESSAGES
        sync()
        t0 = time.perf_counter()
        world, m = step_fn(world)
        sync()
        rec = {key: float(v) for key, v in m.items()}
        rec.update(s=time.perf_counter() - t0, bytes=pcomm.BYTES - b0,
                   messages=pcomm.MESSAGES - n0)
        series.append(rec)
        if on_step is not None:
            world, step_fn = on_step(k + 1, world, m) or (world, step_fn)
    return world, series


def _phases_str(t_call, t_back, stamps):
    """Where a ranks call's wall time went, from rank 0's clock stamps
    (enter, steps start, steps end, leave; the host's one clock)."""
    enter, s0, s1, leave = stamps
    return (f"start-up {enter - t_call:.1f} s, set-up {s0 - enter:.1f} s, "
            f"steps {s1 - s0:.1f} s, checks {leave - s1:.1f} s, exit "
            f"{t_back - leave:.1f} s")


def _gathered_checks(comm, world):
    """Finite state and escaped bodies of the gathered world (pads out)."""
    from mgf_tpu_torch.parallel import gather_world
    g = gather_world(world, comm)
    alive = g.bodies.shape_r > 0.0
    b = g.bodies
    finite = all(bool(torch.isfinite(c[alive]).all())
                 for c in (*b.x, *b.v, *b.omega))
    wall = max(float(c.abs().max()) for v in g.terrain for c in (v.x, v.z))
    out = alive & ((b.x.y < -1.0) | (b.x.x.abs() > wall)
                   | (b.x.z.abs() > wall))
    return g, finite, int(out.sum())


def _spatial_pile_rank(comm, n_bodies, steps, halo):
    """[26] on one rank: the flagship pile on the spatial step from
    scratch, re-sharded whenever a body strays out of halo reach."""
    from mgf_tpu_torch.parallel import (gather_world, init_spatial_bp_cache,
                                        make_spatial_step,
                                        shard_world_spatial)
    from mgf_tpu_torch.scenes import stress_scene
    import warnings
    warnings.simplefilter("ignore")        # pallas_solver is ignored here
    enter = time.time()
    world, cfg = stress_scene(n_bodies, device=comm.device)

    def shard(w):
        ws, bounds = shard_world_spatial(w, comm, cfg=cfg)
        return (init_spatial_bp_cache(ws, comm, cfg, halo),
                make_spatial_step(cfg, comm, bounds, halo=halo,
                                  halo_width=cfg.grid.cell_size))

    w, f = shard(world)
    del world
    reshards = []

    def on_step(k, w, m):
        if int(m["spatial_stray"]) > 0:
            reshards.append(k)
            return shard(gather_world(w, comm)._replace(warm=None, bp=None))
        return None

    _rank_zero()
    s0 = time.time()
    w, series = _timed_steps(comm, w, f, steps, on_step)
    s1 = time.time()
    launches = _rank_launches()
    _, finite, escaped = _gathered_checks(comm, w)
    return dict(series=series, reshards=reshards, launches=launches,
                finite=finite, escaped=escaped, n_loc=w.bodies.n_bodies,
                stamps=(enter, s0, s1, time.time()))


def phase_spatial_pile(dev, contacts64, contacts128):
    """[26] stress_scene(100_000) on the spatial step, 4 ranks sharing the
    card over gloo, 128 steps from scratch."""
    from mgf_tpu_torch.parallel import run_ranks
    steps = 128
    t_call = time.time()
    out = run_ranks(_spatial_pile_rank, N_RANKS, "cuda", "gloo", N_MAIN,
                    steps, HALO_MAIN, timeout_s=900)
    t_back = time.time()
    wall = t_back - t_call
    ser = out[0]["series"]
    late = slice(32, steps)
    sps = [round((steps - 32) / sum(r["s"] for r in o["series"][late]), 3)
           for o in out]
    col = lambda key: [r[key] for r in ser]
    c64, c128 = int(ser[63]["num_contacts"]), int(ser[-1]["num_contacts"])
    last = ser[-1]
    bytes_step = [int(np.mean([r["bytes"] for r in o["series"][late]]))
                  for o in out]
    msgs_step = [int(np.mean([r["messages"] for r in o["series"][late]]))
                 for o in out]
    launches = {k: sum(o["launches"][k] for o in out)
                for k in out[0]["launches"]}
    print(f"[26] spatial step, stress_scene({N_MAIN}) on {N_RANKS} gloo "
          f"ranks sharing the card (host-staged), halo {HALO_MAIN}, "
          f"{steps} steps from scratch in {wall:.1f} s wall ("
          f"{_phases_str(t_call, t_back, out[0]['stamps'])}): steps/s per "
          f"rank over steps 33-{steps} {sps}; "
          f"contacts at step 64 {c64} ([4] {contacts64}, ratio "
          f"{c64 / contacts64:.6f}), at step {steps} {c128} ([4] "
          f"{contacts128}, ratio {c128 / contacts128:.6f}); max penetration "
          f"{last['max_penetration']:.4f}; rebuilds "
          f"{int(sum(col('broadphase_rebuilt')))}; warm_hit_frac "
          f"{last['warm_hit_frac']:.4f}; halo_overflow worst "
          f"{int(max(col('halo_overflow')))}; spatial_stray worst "
          f"{int(max(col('spatial_stray')))}, re-shards after steps "
          f"{out[0]['reshards']}; overflow worst "
          f"{int(max(col('broadphase_overflow')))}; drift excess worst "
          f"{max(col('broadphase_cache_drift_excess'))}; escaped bodies "
          f"{out[0]['escaped']}; comm_floats_per_step (mgf_tpu's formula, all "
          f"ranks) {int(last['comm_floats_per_step'])} = "
          f"{4 * int(last['comm_floats_per_step'])} bytes; bytes really "
          f"sent per step and rank {bytes_step}, messages per step and rank "
          f"{msgs_step}; kernel launches {launches}", flush=True)
    check(all(o["finite"] for o in out), "spatial pile: non-finite state")
    check(max(col("halo_overflow")) == 0, "spatial pile: halo overflow")
    check(max(col("broadphase_overflow")) == 0,
          "spatial pile: broadphase overflow")
    check(max(col("broadphase_cache_drift_excess")) == 0.0,
          "spatial pile: drift excess")
    check(last["max_penetration"] < 0.5,
          f"spatial pile: max penetration {last['max_penetration']}")
    check(out[0]["escaped"] == 0,
          f"spatial pile: {out[0]['escaped']} bodies escaped")
    for c, ref, k in ((c64, contacts64, 64), (c128, contacts128, steps)):
        check(abs(c - ref) <= SPATIAL_CONTACT_SHARE * ref,
              f"spatial pile: contacts {c} at step {k} vs [4]'s {ref}")
    check(launches["K5"] == N_RANKS * steps
          and not any(v for k, v in launches.items() if k != "K5"),
          f"spatial pile: launches {launches}, K5 not one a step on each of "
          f"{N_RANKS} ranks or another kernel launched")
    return launches


def _spatial_8k_rank(comm, np_world, cfg, steps, halo):
    """[27] on one rank: ``steps`` spatial steps of the 8k pile; the
    gathered cache and bodies after step 1, every step's metrics and the
    gathered bodies after the last."""
    from mgf_tpu_torch import world_from_numpy
    from mgf_tpu_torch.parallel import (gather_world, init_spatial_bp_cache,
                                        make_spatial_step,
                                        shard_world_spatial)
    import warnings
    warnings.simplefilter("ignore")
    enter = time.time()
    w, bounds = shard_world_spatial(world_from_numpy(np_world, comm.device),
                                    comm, cfg=cfg)
    w = init_spatial_bp_cache(w, comm, cfg, halo)
    f = make_spatial_step(cfg, comm, bounds, halo=halo,
                          halo_width=cfg.grid.cell_size)
    first = {}

    def on_step(k, w, m):
        if k == 1:
            g = gather_world(w, comm)
            first.update(bp=g.bp, bodies=g.bodies)

    _rank_zero()
    s0 = time.time()
    w, series = _timed_steps(comm, w, f, steps, on_step)
    s1 = time.time()
    final = gather_world(w, comm).bodies
    return dict(first=first, series=series, launches=_rank_launches(),
                final=final, stamps=(enter, s0, s1, time.time()))


def phase_spatial_card_vs_cpu(dev):
    """[27] on an 8,000-body pile after 40 single-device card steps: one
    spatial step on 4 card ranks and on 4 CPU ranks from the same state
    (halo membership and candidate lists equal, v and omega within 1e-3),
    then 8 steps of the card ranks beside the port's single-device step on
    the card."""
    from mgf_tpu_torch import world_from_numpy, world_to_numpy
    from mgf_tpu_torch.parallel import run_ranks
    from mgf_tpu_torch.scenes import stress_scene
    from mgf_tpu_torch.world import init_bp_cache, init_warm, step
    world, cfg = stress_scene(N_E2E, device=dev)
    for _ in range(40):
        world, _ = step(world, cfg)
    np_world = world_to_numpy(world._replace(warm=None, bp=None))
    t_call = time.time()
    card = run_ranks(_spatial_8k_rank, N_RANKS, "cuda", "gloo", np_world,
                     cfg, 8, HALO_E2E, timeout_s=600)[0]
    t_back = time.time()
    host = run_ranks(_spatial_8k_rank, N_RANKS, "cpu", "gloo", np_world,
                     cfg, 1, HALO_E2E, timeout_s=600)[0]
    t_host = time.time()
    fields = ("sl_idx", "sl_ok", "sr_idx", "sr_ok", "partner", "ok")
    diff = {f: int(np.sum(getattr(card["first"]["bp"], f)
                          != getattr(host["first"]["bp"], f)))
            for f in fields}
    err = max(float(np.abs(getattr(card["first"]["bodies"], f)[k]
                           - getattr(host["first"]["bodies"], f)[k]).max())
              for f in ("v", "omega") for k in range(3))
    single = init_bp_cache(init_warm(world_from_numpy(np_world, dev), cfg),
                           cfg)
    c_single = []
    for _ in range(8):
        single, m = step(single, cfg)
        c_single.append(int(m["num_contacts"]))
    c_card = [int(r["num_contacts"]) for r in card["series"]]
    order = np.argsort(np_world.bodies.x.x, kind="stable")
    pos = lambda b: np.stack([np.asarray(c) for c in b.x], -1)
    gap = float(np.abs(pos(card["final"])[:N_E2E]
                       - pos(world_to_numpy(single.bodies))[order]).max())
    members = int(card["first"]["bp"].sl_ok.sum()
                  + card["first"]["bp"].sr_ok.sum())
    print(f"[27] {N_E2E}-body pile after 40 card steps, {N_RANKS} gloo ranks "
          f"(halo {HALO_E2E}), one spatial step on the card against the CPU: "
          f"halo members {members}, mismatches per field {diff}, max "
          f"|dv|,|domega| {err:.3g} (atol {SPATIAL_TOL}); 8 steps beside the "
          f"single-device step on the card: contacts ranks {c_card} / single "
          f"{c_single}, position gap {gap:.3g} (limit {SPATIAL_GAP_8}; "
          f"mgf_tpu 2.86e-6); card ranks: "
          f"{_phases_str(t_call, t_back, card['stamps'])}; CPU ranks: "
          f"{_phases_str(t_back, t_host, host['stamps'])}", flush=True)
    check(not any(diff.values()), f"card vs CPU ranks: halo membership or "
          f"candidate lists differ {diff}")
    check(err <= SPATIAL_TOL, f"card vs CPU ranks: v/omega differ by {err}")
    check(c_card[-1] == c_single[-1],
          f"ranks vs single device: contacts {c_card} vs {c_single}")
    check(gap <= SPATIAL_GAP_8, f"ranks vs single device: gap {gap}")
    return {k: card["launches"][k] for k in card["launches"]}


def _sharded_rank(comm, np_world, cfg, steps):
    """[28] on one rank: the all-gather step on the rank-cut pile."""
    from mgf_tpu_torch import world_from_numpy
    from mgf_tpu_torch.parallel import make_sharded_step, shard_world
    import warnings
    warnings.simplefilter("ignore")     # bp_every: rebuilt every step here
    enter = time.time()
    w = shard_world(world_from_numpy(np_world, comm.device), comm)
    f = make_sharded_step(cfg, comm)
    _rank_zero()
    s0 = time.time()
    w, series = _timed_steps(comm, w, f, steps)
    s1 = time.time()
    launches = _rank_launches()
    _, finite, escaped = _gathered_checks(comm, w)
    return dict(series=series, launches=launches, finite=finite,
                escaped=escaped, stamps=(enter, s0, s1, time.time()))


def phase_sharded_dryrun(dev, pile_np, pile_cfg):
    """[28] the all-gather step on [4]'s pile at step 128, 4 ranks sharing
    the card, 16 steps; ``dryrun_multichip`` over gloo on 4 card ranks and
    over NCCL with one rank per card."""
    from mgf_tpu_torch import world_from_numpy
    from mgf_tpu_torch.entry import dryrun_multichip
    from mgf_tpu_torch.parallel import run_ranks
    from mgf_tpu_torch.world import init_bp_cache, init_warm, step
    w1 = init_bp_cache(init_warm(world_from_numpy(pile_np, dev), pile_cfg),
                       pile_cfg)
    c_single = int(step(w1, pile_cfg._replace(adapt_schedule=None))[1][
        "num_contacts"])
    del w1
    t_call = time.time()
    out = run_ranks(_sharded_rank, N_RANKS, "cuda", "gloo", pile_np,
                    pile_cfg, N_SHARDED_STEPS, timeout_s=900)
    t_back = time.time()
    wall = t_back - t_call
    ser = out[0]["series"]
    sps = [round((N_SHARDED_STEPS - 1) / sum(r["s"] for r in o["series"][1:]),
                 3) for o in out]
    c1 = int(ser[0]["num_contacts"])
    bytes_step = [int(np.mean([r["bytes"] for r in o["series"]]))
                  for o in out]
    msgs_step = [int(np.mean([r["messages"] for r in o["series"]]))
                 for o in out]
    overflow = int(max(r["broadphase_overflow"] for r in ser))
    pen = ser[-1]["max_penetration"]
    launches = {k: sum(o["launches"][k] for o in out)
                for k in out[0]["launches"]}
    print(f"[28] sharded (all-gather) step on [4]'s pile at step 128, "
          f"{N_RANKS} gloo ranks sharing the card, {N_SHARDED_STEPS} steps "
          f"in {wall:.1f} s wall ({_phases_str(t_call, t_back, out[0]['stamps'])}"
          f"): steps/s per rank over "
          f"steps 2-{N_SHARDED_STEPS} {sps}; contacts at step 1 {c1} "
          f"(single-device step from the same state {c_single}), at step "
          f"{N_SHARDED_STEPS} {int(ser[-1]['num_contacts'])}; max "
          f"penetration {pen:.4f}; overflow worst {overflow}; escaped "
          f"{out[0]['escaped']}; bytes sent per step and rank {bytes_step}, "
          f"messages per step and rank {msgs_step}; kernel launches "
          f"{launches}", flush=True)
    check(all(o["finite"] for o in out), "sharded step: non-finite state")
    check(overflow == 0, f"sharded step: overflow {overflow}")
    check(abs(c1 - c_single) <= 0.001 * c_single,
          f"sharded step: contacts {c1} vs single device {c_single}")
    check(out[0]["escaped"] == 0, "sharded step: escaped bodies")
    check(not any(launches.values()),
          f"sharded step launched a hand-written kernel: {launches}")
    t0 = time.perf_counter()
    lines = dryrun_multichip(N_RANKS, device="cuda", backend="gloo")
    gloo_s = time.perf_counter() - t0
    n_cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    lines_n = dryrun_multichip(n_cards, device="cuda", backend="nccl")
    nccl_s = time.perf_counter() - t0
    print(f"[28] dryrun_multichip({N_RANKS}, gloo on the card) in "
          f"{gloo_s:.1f} s: {len(lines)} cases OK; dryrun_multichip("
          f"{n_cards}, nccl, one rank per card) in {nccl_s:.1f} s: "
          f"{len(lines_n)} cases OK", flush=True)
    check(len(lines) == 3 and len(lines_n) == 3, "dryrun_multichip cases")
    return launches



# ---------------------------------------------------------------------------
# [29]-[32]: the f64 parity oracle (mgf_tpu_torch.oracle, numpy float64 on
# the host, its Gauss-Seidel loop in mgf_tpu_torch.native) against the
# card's steps.  The oracle's runs of [29], [31] and [32] do not depend on
# the port's (in resync mode the oracle advances alone and each step of the
# port starts from its state), so they run in worker processes on the CPU
# while the card steps
# ---------------------------------------------------------------------------

# (oracle-only steps, resync steps): [29] is PARITY.md's 220-step headline
# (the free fall is contact-free); [31] and [32] fall into the
# contact-rich pile first
ORACLE_WINDOWS = {"balls": (60, 160), "flagship": (100, 100),
                  "mixed": (150, 120)}
N_ORACLE = 2_000      # [31] and [32]: the piles' bodies
N_ORACLE_FREE = 160   # [30]: free-running steps
# What mgf_tpu itself gives on the CPU at the same scenes and windows
# (scripts/mixed_reference_guards.py --oracle balls|flagship|mixed
# --bodies 2000): contacts compared, misses, the worst deltas, the one-step
# velocity gap, and the oracle's ends slot-1 and capsule-terrain contacts
ORACLE_REFERENCE = {
    "balls": dict(total=45708, miss=0, dt=6.88e-05, dn=1.19e-07,
                  dp=9.5e-07, dv_median=9.93e-07, dv_over_5=8),
    "flagship": dict(total=411470, miss=12, dt=0.0247, dn=5.81e-05,
                     dp=0.000233, dv_median=2.07, dv_max=9.66),
    "mixed": dict(total=569228, miss=718, dt=0.105, dn=0.00011,
                  dp=0.000357, dv_median=0.914, ends_slot1=0,
                  capsule_terrain=41774),
}
# [29]: tests/test_oracle.py::test_balls_contact_stream_parity's gates
BALLS_GATES = dict(dt=1e-4, dn=2e-7, dp=2e-6)
# [31]: no test of the JAX package gates the fused branch against the
# oracle; its bars are twice what mgf_tpu gives on the same scene and
# windows, the margin tests/test_oracle.py's gates keep over their own
# measurements ("CI bounds ~2x measured").  The 12 misses are the fused
# branch's by design (the "near" terrain cull keeps 3 candidates, the
# manifold 1 slot), on the same steps in both packages
FLAGSHIP_BARS = {k: 2 * ORACLE_REFERENCE["flagship"][k]
                 for k in ("miss", "dt", "dn", "dp")}
# [32]: tests/test_oracle.py::test_capsule_ends_contact_stream_parity's
# gates where mgf_tpu itself meets them on this pile (the misses within
# max(4, 1 %) of the contacts, dp 1e-3); where it does not (dt 0.105
# against 8e-3, dn 1.1e-4 against 4e-5: the tumbling pile's grazing
# capsule contacts), twice mgf_tpu's figure, as [31]
MIXED_GATES = dict(dt=2 * ORACLE_REFERENCE["mixed"]["dt"],
                   dn=2 * ORACLE_REFERENCE["mixed"]["dn"], dp=1e-3)
# [31]: scripts/cold_bridge.py's row in mgf_tpu on the CPU (--oracle cold):
# max penetration at steps 150, 180, ..., 300 of the cold 2,000-body pile
COLD_BRIDGE_REFERENCE = (0.1435, 0.148, 0.1655, 0.1487, 0.1147, 0.1029)
# the port's mean of the six within half the spread of mgf_tpu's own six
# (0.1029-0.1655): two float32 runs of the pile part ways chaotically after
# ~100 steps, so the samples are not compared one by one
COLD_BRIDGE_TOL = 0.03


def _oracle_scene(case, dev):
    """The world, config and oracle options of [29], [31] or [32]."""
    from mgf_tpu_torch.scenes import balls_scene, stress_scene
    if case == "balls":
        world, cfg = balls_scene(11, device=dev)
        return world, cfg._replace(pallas_narrowphase=True), {}
    if case == "flagship":
        world, cfg = stress_scene(N_ORACLE, device=dev)
        return world, cfg, {}
    world, cfg = stress_scene(N_ORACLE, mixed=True, layers=6, device=dev)
    return world, cfg, dict(cap_manifold="ends")


def _oracle_job(case):
    """In a worker process: the oracle alone on ``case``'s scene, its
    settle and its resync window.  Returns (trajectory, seconds)."""
    from mgf_tpu_torch import oracle, parity
    torch.set_num_threads(1)
    world, cfg, kw = _oracle_scene(case, "cpu")
    settle, steps = ORACLE_WINDOWS[case]
    t0 = time.perf_counter()
    traj = parity.oracle_trajectory(oracle.from_world(world), cfg.dt,
                                    cfg.solver_iters, settle=settle,
                                    steps=steps, **kw)
    return traj, time.perf_counter() - t0


def _resync(case, dev, job, **kw):
    """Resync ``case``'s scene on the card to the worker's trajectory; the
    result, the kernel launches, the port's seconds and the oracle's."""
    from mgf_tpu_torch import parity
    world, cfg, okw = _oracle_scene(case, dev)
    settle, steps = ORACLE_WINDOWS[case]
    traj, oracle_s = job.result()
    _zero_counts()
    t0 = time.perf_counter()
    out = parity.resync(world, cfg, settle=settle, steps=steps,
                        trajectory=traj, **okw, **kw)
    counts = _counts()
    return out, counts, time.perf_counter() - t0, oracle_s, cfg


def _worst_str(w):
    return (f"contacts compared {w['total']}, miss {w['miss']}, dt "
            f"{w['dt']:.3g}, dn {w['dn']:.3g}, dp {w['dp']:.3g}")


def _miss_steps(out, settle):
    """The steps with misses (step, count): all of them, or the count of
    steps and the first eight."""
    hit = [(settle + k + 1, int(n)) for k, n in enumerate(out["miss"]) if n]
    return hit if len(hit) <= 8 else f"{len(hit)} steps, first {hit[:8]}"


def phase_oracle_demo(dev, job):
    """[29] PARITY.md's headline on the card: the 1,332-ball demo on its
    generic step with K2, resynced to the oracle over 160 steps after the
    oracle's 60-step free fall alone (220 in all)."""
    out, counts, port_s, oracle_s, _ = _resync("balls", dev, job)
    settle, steps = ORACLE_WINDOWS["balls"]
    w, dv = out["worst"], out["dv"]
    over5 = int((dv > 5.0).sum())
    ref = ORACLE_REFERENCE["balls"]
    print(f"[29] oracle resync, balls_scene(11) (K2), oracle alone {settle} "
          f"steps, then {steps} resynced ({settle + steps} in all): "
          f"{_worst_str(w)} (gates: miss 0 on every step, dt "
          f"{BALLS_GATES['dt']}, dn {BALLS_GATES['dn']}, dp "
          f"{BALLS_GATES['dp']}); misses on steps "
          f"{_miss_steps(out, settle)}; one-step |dv| median "
          f"{np.median(dv):.3g} (gate 1e-3), max {dv.max():.3g}, steps past "
          f"5: {over5} (gate 15); mgf_tpu on the CPU: {ref}; kernel "
          f"launches {counts} (K2 expected {steps}); port {port_s:.1f} s, "
          f"oracle {oracle_s:.1f} s in its worker", flush=True)
    check(w["miss"] == 0, f"[29] {w['miss']} contacts missed")
    for k, g in BALLS_GATES.items():
        check(w[k] <= g, f"[29] {k} {w[k]} past {g}")
    check(np.median(dv) <= 1e-3, f"[29] median |dv| {np.median(dv)}")
    check(over5 <= 15, f"[29] {over5} steps with |dv| > 5")
    check(counts["K2"] == steps and counts["K1"] == counts["K3"]
          == counts["K4"] == 0, f"[29] kernel launches {counts}")
    return counts


def phase_oracle_sequential(dev):
    """[30] the reference-exact path free-running beside the oracle:
    balls_scene(3) on the sequential solver (K4) with the raw-lambda
    friction and all-pairs candidates, 160 steps."""
    from mgf_tpu_torch import oracle
    from mgf_tpu_torch.scenes import balls_scene
    from mgf_tpu_torch.world import step
    world, cfg = balls_scene(3, device=dev)
    cfg = cfg._replace(solver="sequential", friction_mode="mgf",
                       use_grid=False)
    ow = oracle.from_world(world)
    gaps = []
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(N_ORACLE_FREE):
        world, _ = step(world, cfg)
        ow, _ = oracle.oracle_step(ow, dt=cfg.dt, iters=cfg.solver_iters,
                                   mgf_friction=True)
        gaps.append(float(np.abs(world.bodies.x.y.cpu().numpy()
                                 - ow.x[:, 1]).max()))
    counts = _counts()
    wall = time.perf_counter() - t0
    worst = max(gaps)
    print(f"[30] balls_scene(3) ({world.bodies.n_bodies} bodies, sequential "
          f"solver (K4), friction mgf, all pairs) free-running "
          f"{N_ORACLE_FREE} steps beside the oracle: worst |dy| {worst:.3g} "
          f"at step {int(np.argmax(gaps)) + 1} (gate 5e-3; PARITY.md 1.5e-4 "
          f"at impact, 6e-5 settled), at the last step {gaps[-1]:.3g}; "
          f"kernel launches {counts} (K4 expected {N_ORACLE_FREE}); "
          f"{wall:.1f} s", flush=True)
    check(worst <= 5e-3, f"[30] |dy| {worst} past 5e-3")
    check(counts["K4"] == N_ORACLE_FREE and counts["K1"] == counts["K3"]
          == 0, f"[30] kernel launches {counts}")
    return counts



def _cold_bridge_row(dev):
    """scripts/cold_bridge.py's row on the card: the cold reference-schedule
    config ([7]'s: warm starting and fused_iso off, 20 two-phase sweeps, K2
    on; bp_every 1) on stress_scene(2_000), 300 steps in chunks of 30; max
    penetration at each chunk end from step 150 on."""
    from mgf_tpu_torch.driver import make_chunk_step
    from mgf_tpu_torch.scenes import stress_scene
    world, cfg = stress_scene(N_ORACLE, device=dev)
    cfg = cfg._replace(warm_start=False, fused_iso=False,
                       warm_match="search", adapt_schedule=None,
                       solver_iters=20, solver_inner=1, two_phase=True,
                       bp_every=1, pallas_narrowphase=True)
    world = world._replace(warm=None, bp=None)
    run = make_chunk_step(cfg, light=True)
    ones = torch.ones((30,), dtype=torch.float32, device=dev)
    pens = []
    _zero_counts()
    t0 = time.perf_counter()
    for k in range(10):
        world, m = run(world, ones)
        if 30 * (k + 1) >= 150:
            pens.append(float(m["max_penetration"][-1]))
    counts = _counts()
    return pens, int(m["num_contacts"][-1]), _finite(world), counts, \
        time.perf_counter() - t0


def phase_oracle_flagship(dev, job):
    """[31] the flagship config (fused_iso, the bp_every=32 fat27x4 cache,
    the hybrid warm match, the adaptive schedule, K1 in gather mode) on
    stress_scene(2_000), resynced to the oracle with its warm rows and
    cache carried from step to step; then cold_bridge.py's row."""
    out, counts, port_s, oracle_s, cfg = _resync("flagship", dev, job,
                                                 carry_caches=True)
    settle, steps = ORACLE_WINDOWS["flagship"]
    thr, it2, _ = cfg.adapt_schedule
    expected = sum(int(it2) if h >= thr else cfg.solver_iters
                   for h in out["warm_hit_frac"])
    w, dv, ref = out["worst"], out["dv"], ORACLE_REFERENCE["flagship"]
    print(f"[31] oracle resync, stress_scene({N_ORACLE}) on the flagship "
          f"config (K1), oracle alone {settle} steps, then {steps} resynced "
          f"(caches carried): {_worst_str(w)}; misses on steps "
          f"{_miss_steps(out, settle)}; one-step |dv| median "
          f"{np.median(dv):.3g}, max {dv.max():.3g}; warm_hit_frac min "
          f"{out['warm_hit_frac'].min():.4f}; mgf_tpu on the CPU: {ref} "
          f"(bars: miss <= {FLAGSHIP_BARS['miss']}, dt <= "
          f"{FLAGSHIP_BARS['dt']}, dn <= {FLAGSHIP_BARS['dn']}, dp <= "
          f"{FLAGSHIP_BARS['dp']}); kernel launches {counts} (K1 expected "
          f"{expected}); port {port_s:.1f} s, oracle {oracle_s:.1f} s in "
          f"its worker", flush=True)
    for k, bar in FLAGSHIP_BARS.items():
        check(w[k] <= bar, f"[31] {k} {w[k]} past mgf_tpu's bar {bar}")
    check(counts["K1"] == expected > 0 and counts["K2"] == counts["K3"]
          == counts["K4"] == 0, f"[31] kernel launches {counts}")
    pens, contacts, finite, c_counts, cold_s = _cold_bridge_row(dev)
    mean, ref_mean = float(np.mean(pens)), float(np.mean(COLD_BRIDGE_REFERENCE))
    print(f"[31] cold_bridge.py's row, stress_scene({N_ORACLE}), 20 "
          f"two-phase sweeps (K2), 300 steps: max penetration at steps "
          f"150-300 every 30 {[round(p, 4) for p in pens]}, range "
          f"{min(pens):.4f}-{max(pens):.4f}, mean {mean:.4f}; mgf_tpu on "
          f"the CPU {list(COLD_BRIDGE_REFERENCE)}, mean {ref_mean:.4f} "
          f"(tolerance {COLD_BRIDGE_TOL} on the mean); the f64 oracle's cold "
          f"Gauss-Seidel at 2,000 bodies 0.073-0.081 (PARITY.md); contacts "
          f"{contacts}; kernel launches {c_counts} (K2 expected 300); "
          f"{cold_s:.1f} s", flush=True)
    check(finite, "[31] cold row: non-finite state")
    check(abs(mean - ref_mean) <= COLD_BRIDGE_TOL,
          f"[31] cold row mean {mean} vs mgf_tpu's {ref_mean}")
    check(c_counts["K2"] == 300 and c_counts["K1"] == c_counts["K3"]
          == c_counts["K4"] == 0, f"[31] cold row launches {c_counts}")
    return {k: counts[k] + c_counts[k] for k in counts}


def phase_oracle_mixed(dev, job):
    """[32] the mixed pile's shipped semantics: stress_scene(2_000,
    mixed=True, layers=6) with cap_manifold="ends", the oracle alone 150
    steps, then 120 resynced (scripts/mixed_resync.py's case; no kernel on
    this path)."""
    out, counts, port_s, oracle_s, _ = _resync("mixed", dev, job)
    settle, steps = ORACLE_WINDOWS["mixed"]
    w, ref = out["worst"], ORACLE_REFERENCE["mixed"]
    miss_bar = max(4, w["total"] // 100)
    share = 100.0 * w["miss"] / max(w["total"], 1)
    print(f"[32] oracle resync, stress_scene({N_ORACLE}, mixed=True, "
          f"layers=6), cap_manifold 'ends', oracle alone {settle} steps, "
          f"then {steps} resynced: {_worst_str(w)} ({share:.3f} %); "
          f"misses on steps "
          f"{_miss_steps(out, settle)}; ends slot-1 {out['ends_slot1']}, "
          f"capsule-terrain {out['capsule_terrain']} (gates: miss <= "
          f"{miss_bar}, dt {MIXED_GATES['dt']:.3g}, dn "
          f"{MIXED_GATES['dn']:.3g}, dp {MIXED_GATES['dp']}, capsule-terrain "
          f"> 0); mgf_tpu on the CPU: {ref}; "
          f"kernel launches {counts}; port {port_s:.1f} s, oracle "
          f"{oracle_s:.1f} s in its worker", flush=True)
    check(w["miss"] <= miss_bar, f"[32] {w['miss']} contacts missed")
    for k, g in MIXED_GATES.items():
        check(w[k] <= g, f"[32] {k} {w[k]} past {g}")
    check(out["capsule_terrain"] > 0, "[32] no capsule-terrain contact")
    check(not any(counts.values()), f"[32] kernel launches {counts}")
    return counts


# [33] bench_torch.py --quick: the headline row (stress_scene(10_000), its
# first chunk of 64, 1,600 steps of warm-up, 3 windows x 128 steps in chunks
# of 64, 128 steps stepped eagerly, then 2 x bp_every single steps), 2,240
# steps, each with 2 (the settled 2x6 schedule) to 4 (4x4) outer
# iterations, one K1 launch each, and one K5 launch
BENCH_QUICK_STEPS = 64 + 1600 + 3 * 128 + 128 + 64


def phase_bench_quick():
    """[33] ``python3 bench_torch.py --quick`` as a process of its own:
    exit 0, the guards of its secondary dict, its K1 launches."""
    import os
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "bench_torch.py", "--quick"],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"bench_torch.py --quick exited "
          f"{out.returncode}: {out.stderr[-3000:]}")
    head = json.loads(out.stdout.strip().splitlines()[-1])
    err = out.stderr.strip().splitlines()
    sec = json.loads(err[-1])
    prefix = "launches by row "
    rows = json.loads(next(x for x in err if x.startswith(prefix))[
        len(prefix):])
    counts = {k: sum(r[k] for r in rows.values())
              for k in ("K1", "K2", "K3", "K4", "K5")}
    print(f"[33] bench_torch.py --quick: exit 0 in {wall:.1f} s; {head}; "
          f"{sec}; launches {rows}", flush=True)
    values = [head["value"], sec["stress_max_penetration"],
              sec["stress_steps_per_sec_mean3"]]
    check(all(np.isfinite(v) for v in values), f"bench quick: {values}")
    check(sec["stress_broadphase_overflow"] == 0,
          f"bench quick: overflow {sec['stress_broadphase_overflow']}")
    check(sec["stress_bp_drift_excess"] == 0.0,
          f"bench quick: drift excess {sec['stress_bp_drift_excess']}")
    check(sec["stress_max_penetration"] < 0.5,
          f"bench quick: max penetration {sec['stress_max_penetration']}")
    check(2 * BENCH_QUICK_STEPS <= counts["K1"] <= 4 * BENCH_QUICK_STEPS,
          f"bench quick: K1 launches {counts['K1']} for "
          f"{BENCH_QUICK_STEPS} steps")
    check(counts["K5"] == BENCH_QUICK_STEPS,
          f"bench quick: K5 launches {counts['K5']} for "
          f"{BENCH_QUICK_STEPS} steps")
    return counts


# [35] the three paths the port replays from CUDA graphs, each stepped
# eager twice and captured once from one state of its own: (steps, chunk)
CAPTURED_PATHS = {"flagship": (128, 16), "cold": (64, 16), "mixed": (64, 16)}
# steps of the window traced after each run (the profiler's events cost
# ~0.1 ms each to collect: a 16-step mixed chunk has 235,000)
WINDOW_STEPS = 4


def _captured_scene(name, dev):
    from mgf_tpu_torch.scenes import stress_scene
    if name == "cold":
        return _cold_scene(dev)
    return stress_scene(N_MAIN, mixed=name == "mixed", device=dev)


def _clone_world(world):
    from mgf_tpu_torch.math3d import tree_map
    c = lambda t: tree_map(torch.clone, t)
    return world._replace(bodies=c(world.bodies), bp=c(world.bp),
                          warm=c(world.warm))


def _drive(cfg, world, steps, chunk, capture):
    """Step a clone of ``world`` ``steps`` steps through the chunk driver
    as [4] / [7] / [11] do, eager (``capture=False``) or from CUDA graphs
    (None, the default on the card); the per-step metrics, the chunks'
    wall seconds, the launches and the solver's outer iterations."""
    from mgf_tpu_torch.driver import AdaptiveChunkStepper, make_chunk_step
    ones = torch.ones((chunk,), dtype=torch.float32,
                      device=world.bodies.x.x.device)
    if cfg.adapt_schedule is not None:
        st = AdaptiveChunkStepper(cfg, chunk=chunk, light=True,
                                  capture=capture)
        run, f = st.run_chunk, st.step_chunk
        it2 = int(cfg.adapt_schedule[1])
    else:
        st, run = None, make_chunk_step(cfg, light=True, capture=capture)
        f = run
    world = _clone_world(world)
    chunk_s, ms, outer = [], [], 0
    _zero_counts()
    for _ in range(steps // chunk):
        iters = it2 if st is not None and st.hot_on else cfg.solver_iters
        t0 = time.perf_counter()
        world, m = f(world, ones)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        outer += chunk * iters
        ms.append(m)
    return dict(world=world, counts=_counts(), outer=outer, chunk_s=chunk_s,
                metrics={k: torch.cat([m[k] for m in ms]) for k in ms[0]},
                run=run, window=lambda w: f(w, ones[:WINDOW_STEPS]))


def _state_rows(world):
    b = world.bodies
    return {"x": torch.stack(list(b.x)), "v": torch.stack(list(b.v)),
            "omega": torch.stack(list(b.omega))}


def _bit_equal(a, b):
    sa, sb = _state_rows(a["world"]), _state_rows(b["world"])
    return (all(torch.equal(sa[k], sb[k]) for k in sa)
            and all(torch.equal(a["metrics"][k], b["metrics"][k])
                    for k in a["metrics"]))


def _gaps(a, b):
    """Max |a - b| of x, v, omega, and of the per-step contact counts."""
    sa, sb = _state_rows(a["world"]), _state_rows(b["world"])
    out = {k: float((sa[k] - sb[k]).abs().max()) for k in sa}
    ca, cb = (r["metrics"]["num_contacts"].long() for r in (a, b))
    out["contacts"] = int((ca - cb).abs().max())
    return out


def _window(r):
    """``WINDOW_STEPS`` more steps of a run (a shorter chunk on the same
    stepper and graphs) under torch.profiler: device operations and device
    ms per step, graph launches per step, the top kernels."""
    cap = r["run"].captured
    replays = cap.replays if cap is not None else 0
    ops, dev_ms, top = _profile_ops(lambda: r["window"](r["world"]))
    replays = (cap.replays if cap is not None else 0) - replays
    n = WINDOW_STEPS
    return ops / n, dev_ms / n, replays / n, top


def phase_captured(dev):
    """[35] the flagship (K1), the cold pile (K2) and the mixed pile at
    100k bodies, each stepped eager twice and once from CUDA graphs
    (``graphs.CapturedStep``) from one state of its own: captured against
    eager equality, the guards of [4] / [7] / [11] on the captured run,
    K1 launches equal to the outer iterations and K2's to the steps, then
    steps/s, device operations and graph launches per step, busy share,
    capture seconds and graph memory."""
    total = {k: 0 for k in ("K1", "K2", "K3", "K4", "K5")}
    smi = card_line(dev)
    for name, (steps, chunk) in CAPTURED_PATHS.items():
        t_path = time.perf_counter()
        world, cfg = _captured_scene(name, dev)
        runs = {}
        for tag, capture in (("eager", False), ("eager2", False),
                             ("captured", None)):
            torch.cuda.empty_cache()
            runs[tag] = _drive(cfg, world, steps, chunk, capture)
        a, b, c = runs["eager"], runs["eager2"], runs["captured"]
        cap = c["run"].captured
        check(cap is not None and cap.graphs and cap.replays > 0,
              f"[35] {name}: the captured run replayed no graph")
        if _bit_equal(a, b):
            case = "eager runs bit-equal; captured bit-equal to them"
            check(_bit_equal(a, c), f"[35] {name}: captured differs from "
                  f"eager {_gaps(a, c)}")
        else:
            gap, cgap = _gaps(a, b), _gaps(a, c)
            case = (f"eager runs differ by {gap}; captured within twice "
                    f"that: {cgap}")
            check(all(cgap[k] <= 2 * gap[k] for k in gap),
                  f"[35] {name}: captured {cgap} past twice the eager gap "
                  f"{gap}")
        w, m = c["world"], c["metrics"]
        overflow = int(m["broadphase_overflow"].max())
        drift = float(m["broadphase_cache_drift_excess"].max())
        pen = float(m["max_penetration"][-1])
        contacts = int(m["num_contacts"][-1])
        escaped = escaped_bodies(w)
        late = 2 if name != "cold" else 1
        sps = {t: chunk * (len(r["chunk_s"]) - late)
               / sum(r["chunk_s"][late:]) for t, r in runs.items()}
        counts = {t: r["counts"] for t, r in runs.items()}
        _zero_counts()
        prof = {t: _window(runs[t]) for t in ("eager2", "captured")}
        window_counts = _counts()
        ms_step = {t: 1e3 / sps[t] for t in prof}
        busy = {t: 100.0 * prof[t][1] / ms_step[t] for t in prof}
        for k in total:
            total[k] += window_counts[k] + sum(r["counts"][k]
                                               for r in runs.values())
        scene = f"{N_MAIN}, mixed=True" if name == "mixed" else N_MAIN
        print(f"[35] {name} stress_scene({scene}) {steps} steps in chunks "
              f"of {chunk}, eager twice and captured from one state: {case}; steps/s (chunks {late + 1}-"
              f"{steps // chunk}) captured {sps['captured']:.2f}, eager "
              f"{sps['eager']:.2f} / {sps['eager2']:.2f}; {WINDOW_STEPS} "
              f"more steps traced: device operations per step captured "
              f"{prof['captured'][0]:.1f} / eager {prof['eager2'][0]:.1f}, "
              f"graph launches per step {prof['captured'][2]:.2f}, device ms "
              f"per step {prof['captured'][1]:.3f} / {prof['eager2'][1]:.3f}, "
              f"busy {busy['captured']:.1f} % / {busy['eager2']:.1f} % (of "
              f"the timed chunks' ms per step), top kernels captured "
              f"{prof['captured'][3]}; capture {cap.capture_seconds:.2f} s "
              f"for {cap.n_graphs} graphs, graph memory "
              f"{cap.graph_bytes / 2**20:.1f} MiB reserved; contacts "
              f"{contacts}, max penetration {pen:.4f}, overflow worst step "
              f"{overflow}, drift excess {drift}, escaped {escaped}; "
              f"launches eager {counts['eager']} captured "
              f"{counts['captured']} (outer iterations {c['outer']}); "
              f"{time.perf_counter() - t_path:.1f} s; {smi}", flush=True)
        check(_finite(w), f"[35] {name}: non-finite x, v or omega")
        limit = MIXED_OVERFLOW_SHARE * N_MAIN if name == "mixed" else 0
        check(overflow <= limit, f"[35] {name}: overflow {overflow}")
        check(drift == 0.0, f"[35] {name}: drift excess {drift}")
        check(contacts > 0, f"[35] {name}: no contacts")
        check(pen < 0.5, f"[35] {name}: max penetration {pen}")
        check(escaped == 0, f"[35] {name}: {escaped} bodies escaped")
        for t, r in runs.items():
            n = r["counts"]
            if name == "flagship":
                ok = n["K1"] == r["outer"] and n["K2"] == 0
            elif name == "cold":
                ok = n["K2"] == steps and n["K1"] == 0
            else:
                ok = not any(n.values())
            k5 = 0 if name == "mixed" else steps
            check(ok and n["K3"] == n["K4"] == 0 and n["K5"] == k5,
                  f"[35] {name} {t}: launches {n} (outer iterations "
                  f"{r['outer']}, steps {steps})")
        del runs, a, b, c, cap, w
    return total


def main():
    t_start = time.perf_counter()
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
    print(f"[1] device {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(card_line(dev), flush=True)
    wall_s = _build.build_all()
    per_src = ", ".join(f"{k} {v:.2f} s"
                        for k, v in sorted(_build.BUILD_SECONDS.items()))
    print(f"[2] kernels built in {wall_s:.2f} s wall, one nvcc per source "
          f"in parallel ({per_src})", flush=True)
    # the f64 oracle's runs of [29], [31] and [32] start now, in three CPU
    # workers, so that they overlap the phases before [29]
    from mgf_tpu_torch import native
    t0 = time.perf_counter()
    native.load()
    native_s = time.perf_counter() - t0
    with ProcessPoolExecutor(max_workers=3,
                             mp_context=mp.get_context("spawn")) as pool:
        jobs = {c: pool.submit(_oracle_job, c) for c in ORACLE_WINDOWS}
        return _phases(dev, name, t_start, jobs, native_s, ss, nph, seq)


def _phases(dev, name, t_start, jobs, native_s, ss, nph, seq):
    """[3]-[35] and the closing lines; ``jobs`` are the oracle workers'
    runs, ``native_s`` the seconds the native runtime took to load."""
    laps = [("1-2", time.perf_counter())]

    def lap(tag):
        laps.append((tag, time.perf_counter()))

    k1 = phase_kernel(ss, dev)
    lap("3")
    main_counts, pile, pile_cfg, contacts64, contacts128 = phase_main_path(
        dev)
    paths = [main_counts]
    phase_end_to_end(dev)
    k5 = phase_k5(pile, pile_cfg, dev)
    lap("4-5, 36")
    k2 = phase_k2(nph, dev)
    paths.append(phase_cold_path(dev))
    demo, demo_cfg, demo_counts = phase_demo(dev)
    paths.append(demo_counts)
    phase_demo_card_vs_cpu(demo, demo_cfg)
    lap("6-9")
    k3 = phase_k3(ss, dev)
    paths.append(phase_mixed_path(dev))
    phase_mixed_card_vs_cpu(dev)
    lap("10-12")
    paths.append(phase_capsules_demo(dev))
    k4 = phase_k4_small(seq, dev)
    seq_demo, seq_cfg, seq_counts = phase_flat_demo(dev,
                                                    "sequential")
    paths.append(seq_counts)
    k4 = phase_k4_demo(seq, k4, seq_demo, seq_cfg)
    paths.append(phase_flat_demo(dev, "parallel")[2])
    lap("13-16")
    paths.append(phase_terrain(dev))
    phase_terrain_card_vs_cpu(dev)
    lap("17-18")
    paths.append(phase_gjk(dev))
    paths.append(phase_queries(dev, pile))
    lap("19-20")
    paths += phase_fat_variants(dev, contacts64)
    lap("21")
    paths.append(phase_bp_margin(pile, pile_cfg))
    paths.append(phase_probes(pile, pile_cfg, dev))
    paths.append(phase_capacity(pile, pile_cfg, dev))
    lap("22-24")
    from mgf_tpu_torch import world_to_numpy
    pile_np = world_to_numpy(pile._replace(warm=None, bp=None))
    del pile
    paths.append(phase_demos_entry(dev))
    lap("25")
    paths.append(phase_spatial_pile(dev, contacts64, contacts128))
    paths.append(phase_spatial_card_vs_cpu(dev))
    paths.append(phase_sharded_dryrun(dev, pile_np, pile_cfg))
    lap("26-28")
    print(f"[29] the native host runtime (csrc/mgf_host.cpp, g++) loaded in "
          f"{native_s:.2f} s (before [3])", flush=True)
    paths.append(phase_oracle_demo(dev, jobs["balls"]))
    paths.append(phase_oracle_sequential(dev))
    paths.append(phase_oracle_flagship(dev, jobs["flagship"]))
    paths.append(phase_oracle_mixed(dev, jobs["mixed"]))
    lap("29-32")
    paths.append(phase_bench_quick())
    lap("33")
    paths.append(phase_captured(dev))
    lap("35")
    launches = {k: sum(p[k] for p in paths) for k in paths[0]}

    def row(name, source, replaces, n, r):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None}

    # no single PyTorch call computes K1-K5: library_ms is null.
    laps.insert(0, ("", t_start))
    per_phase = ", ".join(f"[{t}] {t1 - t0:.1f}" for (_, t0), (t, t1)
                          in zip(laps, laps[1:]))
    print(f"[34] chip_smoke.py wall time {time.perf_counter() - t_start:.1f}"
          f" s; seconds by phase: {per_phase}", flush=True)
    # launches: each kernel's count summed over the paths ([4], [7], [8],
    # [15], [16], [21]-[25], [29]-[31], [33], [35], and K5 in the ranks of
    # [26] and [27]; [11], [13], [17], [19], [20], [32] and the ranks of
    # [28] launch none).  K1 in
    # gather mode at the main path's settled shape (inner 6); K2 at the
    # cold pile's 900,000 pairs; K3 at block 1024, inner 8; K4 at the full
    # demo's constraint list (ms, plain_ms: the level plain version on the
    # card), its bound the list's pipelined dependency depth times one
    # update's chain of dependent float32 operations (k4_bound); K5 at
    # [36]'s full call (the deepest penetration written)
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
        row("terrain.sphere_terrain_near",
            "mgf_tpu_torch/ops/csrc/sphere_terrain.cu",
            "none (mgf_tpu runs the stage as XLA fusions)", launches["K5"],
            dict(k5["full"], err=max(v["err"] for v in k5.values()))),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
