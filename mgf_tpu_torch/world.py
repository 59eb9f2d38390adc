"""The end-to-end physics step for spheres, capsules and mixed piles: the
flagship ``fused_iso`` branch, the generic row branch and the reference's
flat constraint list.

Counterpart of ``mgf_tpu.world`` (reference: ``mgf_demo/world.rs:227-294``,
``World::step``):

    complete_motion -> integrate -> broadphase -> narrowphase -> terrain
    -> manifolds -> row constraints -> [warm match] -> row solver

* **fused_iso** (the flagship ``stress_scene``): the fat grid, cached
  or rebuilt every step; one 18-wide partner gather
  that feeds the contact test and a gather-free constraint build; the
  "near" terrain cull; warm starting; kernel K1 for the solver's inner
  sweeps.
* **generic** (``fused_iso=False``: the 1,332-ball demo ``balls_scene``
  and the cold reference-schedule pile): the packed grid or the fat grid;
  the pair contact through kernel K2 when ``pallas_narrowphase`` is set;
  dense or "near" terrain; the 16-wide-gather constraint build over the
  body arrays extended by one static terrain row; a cold solve (two-phase
  with 20 sweeps in the reference schedule).

* **capsules and mixed** (``shape_mode`` "capsules" / "mixed", always on
  the generic branch): two contact slots per pair and per (body, triangle),
  Mat3 inertia, the capsule flank manifold "mid" or "ends".  With
  ``n_sphere_rows >= 0`` and a culled terrain the mixed step is
  TYPE-PARTITIONED: bodies are type-sorted (spheres in columns [0, ns),
  capsules in [ns, N)), each column block evaluates two contact types
  instead of four, the four-stage triangle x capsule routine runs on the
  capsule block only, and the solve is two chained block solves (spheres
  with scalar inertia over their live rows, then capsules with Mat3), a
  two-colour Gauss-Seidel.  No hand-written kernel runs on these paths, as
  none does in the JAX package.
* **warm starting on the generic branch**: the positional, search and
  hybrid row matches, ``warm_gamma`` and the adaptive schedule, as on the
  fused branch.
* **row compaction** (``solver_rows``): every body keeps its
  ``solver_rows`` earliest valid rows before the constraint build, and
  ``solver_rows_dropped`` counts the rest.
* **the flat constraint list** (``solver="sequential"`` / ``"parallel"``,
  the reference's single-direction form, world.rs:266-268): ordered pair
  candidates, one ``build_constraints`` per manifold (pairs first, then
  terrain), and the sequential Gauss-Seidel solve (kernel K4) or the
  mass-split parallel one.
* **mesh terrain** (``terrain_bp="grid"``): the static face cell table
  ``World.terrain_grid`` (built by :func:`make_world` with
  ``terrain_grid_cfg``) culls the faces of a large mesh to
  ``terrain_cand`` per body, the mesh BVH::query equivalent (mesh.rs:121).
* **the broadphase modes**: ``"packed"`` (and any name that is not a fat
  mode, as in the JAX package) or the fat grid as ``"fat"`` (width-8
  rows, 27 cells), ``"fat8"`` (width 8, the 2x2x2 octant ``"sel8"``),
  ``"fat8x4"`` (width 4, sel8) and ``"fat27x4"`` (width 4, 27 cells).
  The octant modes guarantee pair reach up to half a cell only, so the
  reach excess and the cache's slack budget use that.
* **the broadphase caches** (fat modes, ``init_bp_cache`` state):
  ``bp_margin > 0`` alone builds the candidate list with that much extra
  fat and rebuilds when any body drifts more than ``bp_margin / 2`` from
  where it was built (fat-proxy refit, world.rs:233-238); ``bp_every >
  1`` rebuilds on that cadence or the moment a body outruns its build
  slack, and with ``bp_margin`` also on the drift test.
* **stage probes** (``profile_stage``): the step stops after the named
  stage and returns the INPUT world with ``{"probe": scalar}``, the JAX
  package's probe expressions; the stages after ``"terrain"`` exist on
  the rows solver only.  With ``tracing`` on, a device stamp closes each
  stage at the same checkpoints, in a whole step (and inside CUDA graphs).

The module also holds the host-side world surgery of the JAX package:
:func:`extend_world` / :func:`remove_bodies` (the body count changes) and
the capacity world (:func:`with_capacity`, :func:`spawn_bodies`,
:func:`kill_bodies`: dead rows with ``shape_r <= 0``, shapes unchanged).
Every one of them returns new tensors and leaves the caller's world as it
was, as the JAX package's ``.at[].set`` does.

All branches keep every pair and terrain batch 2-D and slot-major,
(width, N), so the self side of a batch is a broadcast of the body
columns.  The JAX generic branch flattens the same batches to
(width * N,), which is the row-major reshape of the port's;
``collect_contacts`` returns the JAX package's flat streams, and the flat
constraint list takes its points in that same order (point s * K * N +
k * N + i is slot s of body i's k-th pair): the order of the points is
the Gauss-Seidel order.

:class:`WorldConfig` keeps every field name and default of the JAX
package's, so a config moves between the two unchanged, and every value
the JAX package accepts runs here.

The JAX step is one jitted graph with ``lax.cond`` switches.  Here the two
conds on ``need`` (rebuild or reuse the broadphase cache; keyed or
positional warm matching) become ONE host read of ``need`` per cached
step and a Python branch, and ``adapt_schedule`` reads ``warm_hit_frac``
on the host when it is set.  That costs a device->host synchronisation
per step.  :func:`step` is :func:`step_head` (everything up to ``need``),
that read, then :func:`step_tail`; neither segment reads the host or
builds a tensor from host data, so ``graphs.CapturedStep`` replays each
as a CUDA graph.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from mgf_tpu_torch import broadphase, tracing
from mgf_tpu_torch.bounds import capsule_aabb, sphere_aabb
from mgf_tpu_torch.broadphase import GridConfig
from mgf_tpu_torch.collision import (
    Contact, LocalContact, contact_capsule_moving_capsule,
    contact_capsule_moving_sphere, contact_moving_moving, contact_neg,
    contact_select, contact_sphere_moving_capsule,
    contact_sphere_moving_sphere, contact_stack_bcast,
    contact_triangle_moving_capsule, contact_triangle_moving_sphere,
)
from mgf_tpu_torch.geom import AABB, Capsule, Sphere, Triangle
from mgf_tpu_torch.manifold import PERSISTENT_THRESHOLD_SQ, Manifold, prune
from mgf_tpu_torch.mesh import build_mesh_grid, mesh_from_arrays
from mgf_tpu_torch.math3d import (
    Quat, Vec3, magnitude2, qrotate, tree_map, where_vec,
)
from mgf_tpu_torch.ops.narrowphase import sphere_contact_pairs
from mgf_tpu_torch.ops.terrain import (
    MAX_CAND, MAX_FACES, deepest as _deepest, gather_triangles,
    near_terrain, sphere_terrain_near, stable_candidates,
)
from mgf_tpu_torch.physics import (
    SHAPE_CAPSULE, SHAPE_SPHERE, RigidBodyState, colliders, complete_motion,
    integrate,
)
from mgf_tpu_torch.solver import (
    BodyView, PartnerFields, build_constraints, build_row_constraints,
    build_row_constraints_iso, build_row_constraints_iso_fused,
    solve_parallel, solve_rows, solve_sequential, unpack_body_state,
)

CUDA = torch.device("cuda")

# the fat-grid broadphase modes (every other name runs the packed grid)
FAT_MODES = ("fat", "fat8", "fat8x4", "fat27x4")
# set by utils.debug.enable_debug_mode: every step's output state and
# metrics are checked for non-finite values (jax_debug_nans' role)
DEBUG_NANS = False


class WorldConfig(NamedTuple):
    """Static configuration of the step pipeline: the JAX package's
    fields and defaults (see ``mgf_tpu.world.WorldConfig`` for each field's
    full rationale)."""
    dt: float = 1.0 / 60.0
    solver_iters: int = 20           # world.rs:293
    grid: GridConfig = GridConfig(cell_size=2.0, dim=64, bucket_cap=4)
    use_grid: bool = True            # False: O(N^2) candidates
    max_pairs: int = 16              # partner slots per body
    fatten: float = 0.25             # fat-proxy margin (world.rs:181)
    shape_mode: str = "spheres"      # "spheres" | "capsules" | "mixed"
    solver: str = "rows"             # "rows" | "parallel" | "sequential"
    friction_mode: str = "textbook"  # "textbook" | "mgf"
    two_phase: bool = True           # rows solver: friction/normal phases
    solver_inner: int = 1            # rows solver: inner sweeps per gather
    broadphase: str = "packed"       # "packed" | "fat" | "fat8" |
                                     # "fat8x4" | "fat27x4"
    terrain_rows: int = 0            # keep only the top-k terrain rows
    terrain_bp: str = "dense"        # "dense" | "grid" | "near"
    terrain_cand: int = 8            # candidate faces per body (near/grid)
    terrain_grid_cfg: GridConfig = None  # face-table geometry ("grid")
    profile_stage: str = ""          # "" or a stage name: stop after it
                                     # and return a probe scalar
    bp_margin: float = 0.0           # > 0: fat-proxy refit cache (needs
                                     # init_bp_cache state)
    bp_every: int = 1                # > 1: rebuild the candidate list on
                                     # this cadence, or the moment a body
                                     # outruns its build slack (needs
                                     # init_bp_cache state)
    warm_start: bool = False         # persist accumulated impulses across
                                     # frames (needs init_warm state)
    pallas_narrowphase: bool = False  # generic branch: the pair contact
                                      # runs as kernel K2
                                      # (ops/narrowphase.py; its plain
                                      # PyTorch version on CPU tensors)
    pallas_solver: bool = False      # iso rows path (fused_iso, single-
                                     # phase, textbook friction): run each
                                     # outer iteration's inner sweeps as
                                     # the hand-written CUDA kernel
                                     # (ops/solver_sweep.py; its plain
                                     # PyTorch version on CPU tensors)
    solver_rows: int = 0             # compact rows to the top-k per body
    cap_manifold: str = "mid"        # capsule flank contacts: mid | ends
    stable_pairs: bool = False       # canonical (sorted) partner slots
    warm_match: str = "search"       # "search" | "pos" | "hybrid"
    warm_gamma: float = 1.0          # scale of the warm-start transfer
    adapt_schedule: tuple = None     # (hit_frac, iters, inner)
    n_sphere_rows: int = -1          # mixed mode type partition
    light_metrics: bool = False      # skip the heavy observability metrics
    bias_max: float = -1.0           # >= 0: clamp the Baumgarte bias
    fused_iso: bool = False          # spheres+rows+warm_start fast path


class BpCache(NamedTuple):
    """Cached broadphase candidate list + the positions it was built at."""
    partner: torch.Tensor   # (N, K) int32
    ok: torch.Tensor        # (N, K) bool
    anchor: Vec3            # positions at build time (end-of-sweep)
    overflow: torch.Tensor  # () int32 from the build
    count: torch.Tensor     # () int32 steps since init (bp_every cadence)
    slack: torch.Tensor     # (N,) float32 per-body extra fat at build time
    r_build: torch.Tensor = None  # (N,) float32 swept fat radius at build


class SolverWarm(NamedTuple):
    """Previous frame's constraint rows + accumulated impulses."""
    partner: torch.Tensor   # (R, N) int32
    key2: torch.Tensor      # (R, N) int32: pair slot id / terrain tri id
    acc_n: torch.Tensor     # (R, N) float32
    acc_t1: torch.Tensor
    acc_t2: torch.Tensor


class World(NamedTuple):
    """Dynamic world state."""
    bodies: RigidBodyState
    terrain: Triangle        # triangle soup in world space, Vec3 (T,)
    terrain_center: Vec3
    terrain_grid: torch.Tensor = None  # (dim^3, 4*cap) float face table
                                       # for terrain_bp="grid": rows
                                       # [fid*cap | cx*cap | cy*cap |
                                       # cz*cap] (face id + centroid)
    warm: SolverWarm = None            # cfg.warm_start state (init_warm)
    bp: BpCache = None                 # broadphase cache (init_bp_cache)


def solver_row_count(cfg: WorldConfig, n_tris: int) -> int:
    """The rows solver's row count R for a config (mirrors step())."""
    n_slots = 1 if cfg.shape_mode == "spheres" else 2
    r = n_slots * cfg.max_pairs
    if n_tris > 0:
        t_width = (cfg.terrain_cand if cfg.terrain_bp in ("grid", "near")
                   else n_tris)
        t_rows = n_slots * t_width
        if cfg.terrain_rows and t_rows > cfg.terrain_rows:
            t_rows = cfg.terrain_rows
        r += t_rows
    if cfg.solver_rows and r > cfg.solver_rows:
        r = cfg.solver_rows
    return r


def _world_device(world: World, device):
    return world.bodies.x.x.device if device is None else device


def init_bp_cache(world: World, cfg: WorldConfig, device=None) -> World:
    """Attach an (invalid) broadphase cache; the first step rebuilds.  The
    state goes to ``device``, by default the world's own."""
    device = _world_device(world, device)
    n = world.bodies.n_bodies
    full = lambda v, dt: torch.full((n,), v, dtype=dt, device=device)
    far = full(1.0e9, torch.float32)
    return world._replace(bp=BpCache(
        partner=torch.full((n, cfg.max_pairs), -1, dtype=torch.int32,
                           device=device),
        ok=torch.zeros((n, cfg.max_pairs), dtype=torch.bool, device=device),
        anchor=Vec3(far, far.clone(), far.clone()),
        overflow=torch.zeros((), dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        slack=full(0.0, torch.float32),
        r_build=full(0.0, torch.float32)))


def init_warm(world: World, cfg: WorldConfig, device=None) -> World:
    """Attach a zeroed warm-start state (cfg.warm_start scenes), on
    ``device``, by default the world's own."""
    device = _world_device(world, device)
    n = world.bodies.n_bodies
    R = solver_row_count(cfg, world.terrain.a.x.shape[0])
    z = torch.zeros((R, n), dtype=torch.float32, device=device)
    none = torch.full((R, n), -9, dtype=torch.int32, device=device)
    return world._replace(warm=SolverWarm(partner=none, key2=none.clone(),
                                          acc_n=z, acc_t1=z.clone(),
                                          acc_t2=z.clone()))


def make_world(bodies: RigidBodyState, terrain_verts=None, terrain_faces=None,
               terrain_center=(0.0, 0.0, 0.0),
               terrain_grid_cfg: GridConfig = None, *, device=CUDA) -> World:
    """Assemble a world; terrain given as (V, 3) vertices + (T, 3) faces
    (numpy).

    ``terrain_grid_cfg`` builds the static face cell table of the "grid"
    terrain broadphase (large meshes): every face is binned into each cell
    its AABB overlaps (:func:`mesh.build_mesh_grid`, on the host), so the
    +-1-cell query window only has to cover the body's reach (radius + half
    height + sweep); keep ``cell_size`` >= both the largest face radius and
    the largest body reach.  The step reports ``terrain_reach_excess``
    (the largest body reach minus ``cell_size``, at least 0)."""
    grid_table = None
    if terrain_verts is None:
        tv = np.zeros((0, 3), np.float32)
        corners = (tv, tv, tv)
    else:
        tv = np.asarray(terrain_verts, np.float32)
        tf = np.asarray(terrain_faces, np.int32)
        corners = tuple(tv[tf[:, k]] for k in range(3))
        if terrain_grid_cfg is not None:
            mg = build_mesh_grid(mesh_from_arrays(tv, tf, device="cpu"),
                                 terrain_grid_cfg.cell_size,
                                 terrain_grid_cfg.dim,
                                 terrain_grid_cfg.bucket_cap)
            # component-blocked float rows [fid*cap | cx*cap | cy*cap |
            # cz*cap]: the face centroid rides the window gather, so the
            # cull's distance scoring needs no per-candidate gather
            ids = mg.table.numpy()                       # (C, cap)
            cent = tv[tf[:, 0]] / 3 + tv[tf[:, 1]] / 3 + tv[tf[:, 2]] / 3
            safe = np.maximum(ids, 0)
            okm = ids >= 0
            comp = [np.where(okm, ids, -1).astype(np.float32),
                    np.where(okm, cent[safe, 0], 0).astype(np.float32),
                    np.where(okm, cent[safe, 1], 0).astype(np.float32),
                    np.where(okm, cent[safe, 2], 0).astype(np.float32)]
            grid_table = torch.as_tensor(np.concatenate(comp, axis=1),
                                         device=device)
    vec = lambda a: Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, k]),
                                           device=device) for k in range(3)))
    tri = Triangle(*(vec(c) for c in corners))
    tc = np.asarray(terrain_center, np.float32)
    center = Vec3(*(torch.as_tensor(tc[k], device=device) for k in range(3)))
    return World(bodies=bodies, terrain=tri, terrain_center=center,
                 terrain_grid=grid_table)


def _stable_sort_pairs(partner, pair_ok):
    """Canonical slot order: sort each body's partner list by index
    (invalid slots to the end) and mask duplicate partners.  The partner
    SET is unchanged; slot positions become deterministic."""
    big = 1 << 28
    p_s = torch.sort(torch.where(pair_ok, partner, big), dim=1).values
    dup = torch.zeros_like(pair_ok)
    dup[:, 1:] = p_s[:, 1:] == p_s[:, :-1]
    ok = (p_s < big) & ~dup
    return torch.where(ok, p_s, -1), ok


class ShapeView(NamedTuple):
    """The slice of body state the narrowphase reads."""
    x: Vec3
    q: Quat
    delta: Vec3
    shape_type: torch.Tensor
    shape_r: torch.Tensor
    shape_half_h: torch.Tensor


def shape_view(state: RigidBodyState) -> ShapeView:
    return ShapeView(x=state.x, q=state.q, delta=state.delta,
                     shape_type=state.shape_type, shape_r=state.shape_r,
                     shape_half_h=state.shape_half_h)


class PackedShapes(NamedTuple):
    """Per-body shape data packed for one wide row gather.  ``p8`` has 8
    columns for spheres and 13 in capsule/mixed modes: the quaternion and
    the shape type ride the same row, so the capsule frame costs no second
    gather."""
    p8: torch.Tensor          # (N, 8|13): x y z dx dy dz r half_h
                              #            [q wxyz, shape type]
    shape_type: torch.Tensor  # (N,)


class GatheredShapes(NamedTuple):
    """One side of a pair batch."""
    x: Vec3
    delta: Vec3
    sphere: Sphere
    capsule: Capsule = None
    shape_type: torch.Tensor = None


def pack_shapes(sv: ShapeView, shape_mode: str = "spheres") -> PackedShapes:
    cols = [sv.x.x, sv.x.y, sv.x.z, sv.delta.x, sv.delta.y, sv.delta.z,
            sv.shape_r, sv.shape_half_h]
    if shape_mode != "spheres":
        cols += [sv.q.w, sv.q.x, sv.q.y, sv.q.z,
                 sv.shape_type.to(torch.float32)]
    return PackedShapes(p8=torch.stack(cols, dim=-1),
                        shape_type=sv.shape_type)


def _capsule_of(x: Vec3, q: Quat, r, half_h) -> Capsule:
    d_half = qrotate(q, Vec3(torch.zeros_like(half_h), half_h,
                             torch.zeros_like(half_h)))
    return Capsule(a=x - d_half, d=d_half * 2.0, r=r)


def self_shapes(cfg: WorldConfig, sv: ShapeView) -> GatheredShapes:
    """The SELF side of a slot-major (width, N) batch without a gather:
    every slot row reads the same body arrays, so a (1, N) broadcast."""
    exp = lambda a: a[None, :]
    x = Vec3(exp(sv.x.x), exp(sv.x.y), exp(sv.x.z))
    delta = Vec3(exp(sv.delta.x), exp(sv.delta.y), exp(sv.delta.z))
    r = exp(sv.shape_r)
    sphere = Sphere(c=x, r=r)
    if cfg.shape_mode == "spheres":
        return GatheredShapes(x=x, delta=delta, sphere=sphere)
    q = Quat(exp(sv.q.w), exp(sv.q.x), exp(sv.q.y), exp(sv.q.z))
    capsule = _capsule_of(x, q, r, exp(sv.shape_half_h))
    stype = (exp(sv.shape_type) if cfg.shape_mode == "mixed"
             else torch.ones_like(exp(sv.shape_type)))
    return GatheredShapes(x=x, delta=delta, sphere=sphere, capsule=capsule,
                          shape_type=stype)


def gather_shapes(cfg: WorldConfig, ps: PackedShapes, idx) -> GatheredShapes:
    """The partner side: one 8- or 13-wide row gather per (slot, body)
    index."""
    g = ps.p8[idx.long()]
    x = Vec3(g[..., 0], g[..., 1], g[..., 2])
    delta = Vec3(g[..., 3], g[..., 4], g[..., 5])
    r = g[..., 6]
    sphere = Sphere(c=x, r=r)
    if cfg.shape_mode == "spheres":
        return GatheredShapes(x=x, delta=delta, sphere=sphere)
    capsule = _capsule_of(
        x, Quat(g[..., 8], g[..., 9], g[..., 10], g[..., 11]), r, g[..., 7])
    stype = (g[..., 12].to(torch.int32) if cfg.shape_mode == "mixed"
             else torch.ones_like(idx))
    return GatheredShapes(x=x, delta=delta, sphere=sphere, capsule=capsule,
                          shape_type=stype)


def _block8(g: GatheredShapes, shape):
    """One side of a (width, N) pair batch as the contiguous component-major
    (8, width * N) block ``[x y z dx dy dz r 0]`` kernel K2 reads."""
    cols = [*g.x, *g.delta, g.sphere.r]
    cols = [c.expand(shape) for c in cols]
    cols.append(torch.zeros(shape, dtype=torch.float32,
                            device=cols[0].device))
    return torch.stack(cols).reshape(8, -1)


def manifold_prox_sq(cfg: WorldConfig) -> float:
    """Pruner proximity-merge threshold for this config (manifold.rs:38,
    or the tight one of the capsule "ends" extension, so that intentional
    endpoint pairs less than sqrt(0.5) apart survive the merge)."""
    return 1.0e-4 if cfg.cap_manifold == "ends" else PERSISTENT_THRESHOLD_SQ


def _two_slot(c: Contact) -> Contact:
    """[c, invalid]: a single contact in a two-slot manifold."""
    return contact_stack_bcast([c, c._replace(
        valid=torch.zeros_like(c.valid))])


def _slot(c: Contact, s: int) -> Contact:
    return tree_map(lambda x: x[s], c)


def _cols(t, lo: int, hi: int):
    """Columns [lo, hi) of every tensor of a tree of (..., N) tensors."""
    return tree_map(lambda g: g[..., lo:hi], t)


def _cat_cols(parts):
    return tree_map(lambda *xs: torch.cat(xs, dim=-1), *parts)


def _pair_contact(cfg: WorldConfig, ga: GatheredShapes,
                  gb: GatheredShapes) -> Contact:
    """Contact slots (S, width, N) for body pairs (receiver a, argument b),
    the reference's loop order (world.rs:260-275); S = 1 for spheres, else
    2."""
    ends = cfg.cap_manifold == "ends"
    cc_fn = lambda c1, c2, v: contact_capsule_moving_capsule(c1, c2, v,
                                                             ends=ends)
    va, vb = ga.delta, gb.delta
    if cfg.shape_mode == "spheres":
        # sphere pairs emit exactly one contact: no second slot
        return contact_stack_bcast([contact_moving_moving(
            contact_sphere_moving_sphere, ga.sphere, va, gb.sphere, vb)])
    if cfg.shape_mode == "capsules":
        c_cc = contact_moving_moving(cc_fn, ga.capsule, va, gb.capsule, vb)
        return c_cc if ends else _two_slot(c_cc)

    # mixed: evaluate all four type pairs, select by (type_a, type_b)
    c_ss = contact_moving_moving(contact_sphere_moving_sphere,
                                 ga.sphere, va, gb.sphere, vb)
    c_cc = contact_moving_moving(cc_fn, ga.capsule, va, gb.capsule, vb)
    c_cs = contact_moving_moving(contact_capsule_moving_sphere,
                                 ga.capsule, va, gb.sphere, vb)
    c_sc = contact_moving_moving(contact_sphere_moving_capsule,
                                 ga.sphere, va, gb.capsule, vb)
    both_s = (ga.shape_type == SHAPE_SPHERE) & (gb.shape_type == SHAPE_SPHERE)
    both_c = ((ga.shape_type == SHAPE_CAPSULE)
              & (gb.shape_type == SHAPE_CAPSULE))
    cap_sph = ((ga.shape_type == SHAPE_CAPSULE)
               & (gb.shape_type == SHAPE_SPHERE))
    if ends:
        cc0, cc1 = _slot(c_cc, 0), _slot(c_cc, 1)
        s0 = contact_select(both_s, c_ss,
                            contact_select(both_c, cc0,
                                           contact_select(cap_sph, c_cs,
                                                          c_sc)))
        s1 = cc1._replace(valid=cc1.valid & both_c)
        return contact_stack_bcast([s0, s1])
    c = contact_select(both_s, c_ss,
                       contact_select(both_c, c_cc,
                                      contact_select(cap_sph, c_cs, c_sc)))
    return _two_slot(c)


def _pair_contact_split(cfg: WorldConfig, ga: GatheredShapes,
                        gb: GatheredShapes, ns: int) -> Contact:
    """Mixed-mode pair narrowphase with bodies PARTITIONED by type along
    the column axis: spheres in columns [0, ns), capsules in [ns, N).  The
    self side's shape type is then static per block, so each pair evaluates
    TWO type routines instead of four; the contacts are bit-identical to
    :func:`_pair_contact`.  Needs type-sorted bodies (SceneBuilder callers
    add the spheres first)."""
    ends = cfg.cap_manifold == "ends"
    cc_fn = lambda c1, c2, v: contact_capsule_moving_capsule(c1, c2, v,
                                                             ends=ends)
    n = gb.sphere.r.shape[-1]
    parts = []
    if ns > 0:
        a, b = _cols(ga, 0, ns), _cols(gb, 0, ns)
        va, vb = a.delta, b.delta
        c_ss = contact_moving_moving(contact_sphere_moving_sphere,
                                     a.sphere, va, b.sphere, vb)
        c_sc = contact_moving_moving(contact_sphere_moving_capsule,
                                     a.sphere, va, b.capsule, vb)
        part_sph = b.shape_type == SHAPE_SPHERE
        parts.append(_two_slot(contact_select(part_sph, c_ss, c_sc)))
    if ns < n:
        a, b = _cols(ga, ns, n), _cols(gb, ns, n)
        va, vb = a.delta, b.delta
        c_cs = contact_moving_moving(contact_capsule_moving_sphere,
                                     a.capsule, va, b.sphere, vb)
        c_cc = contact_moving_moving(cc_fn, a.capsule, va, b.capsule, vb)
        part_sph = b.shape_type == SHAPE_SPHERE
        if ends:
            cc0, cc1 = _slot(c_cc, 0), _slot(c_cc, 1)
            s0 = contact_select(part_sph, c_cs, cc0)
            s1 = cc1._replace(valid=cc1.valid & ~part_sph)
            parts.append(contact_stack_bcast([s0, s1]))
        else:
            parts.append(_two_slot(contact_select(part_sph, c_cs, c_cc)))
    return _cat_cols(parts)


def _terrain_contact(cfg: WorldConfig, gt: GatheredShapes,
                     tri: Triangle) -> Contact:
    """Contact slots (S, width, N) for (triangle, body) pairs, flipped so
    the BODY is side "a" (a = body point, b = terrain point,
    n = -triangle normal)."""
    v = gt.delta
    if cfg.shape_mode == "spheres":
        out = contact_stack_bcast([contact_triangle_moving_sphere(
            tri, gt.sphere, v)])
    elif cfg.shape_mode == "capsules":
        out = contact_triangle_moving_capsule(tri, gt.capsule, v)
    else:
        cs2 = _two_slot(contact_triangle_moving_sphere(tri, gt.sphere, v))
        cc = contact_triangle_moving_capsule(tri, gt.capsule, v)
        out = contact_select(gt.shape_type == SHAPE_SPHERE, cs2, cc)
    return contact_neg(out)


def _terrain_contact_split(cfg: WorldConfig, gt: GatheredShapes,
                           tri: Triangle, ns: int) -> Contact:
    """Type-partitioned terrain narrowphase: the four-stage triangle x
    capsule routine (collision.rs:693-1086) runs ONLY on the capsule column
    block; sphere columns get the face/edge sphere test.  Bit-identical
    contacts to :func:`_terrain_contact`."""
    n = gt.sphere.r.shape[-1]
    parts = []
    if ns > 0:
        g, t_ = _cols(gt, 0, ns), _cols(tri, 0, ns)
        parts.append(_two_slot(contact_triangle_moving_sphere(
            t_, g.sphere, g.delta)))
    if ns < n:
        g, t_ = _cols(gt, ns, n), _cols(tri, ns, n)
        parts.append(contact_triangle_moving_capsule(t_, g.capsule,
                                                     g.delta))
    return contact_neg(_cat_cols(parts))


def _body_bounds(cfg: WorldConfig, sv) -> AABB:
    spheres, capsules = colliders(sv)
    if cfg.shape_mode == "spheres":
        return sphere_aabb(spheres)
    if cfg.shape_mode == "capsules":
        return capsule_aabb(capsules)
    sb = sphere_aabb(spheres)
    cb = capsule_aabb(capsules)
    is_sph = sv.shape_type == SHAPE_SPHERE
    return AABB(c=where_vec(is_sph, sb.c, cb.c),
                r=where_vec(is_sph, sb.r, cb.r))


def _check_config(cfg: WorldConfig, world: World, n_tris: int):
    """The JAX package's own guards on a configuration."""
    if cfg.shape_mode not in ("spheres", "capsules", "mixed"):
        raise ValueError(f"unknown shape_mode {cfg.shape_mode!r}")
    if cfg.solver not in ("rows", "parallel", "sequential"):
        raise ValueError(f"unknown solver {cfg.solver!r}")
    if n_tris > 0 and cfg.terrain_bp == "grid" and (
            world.terrain_grid is None or cfg.terrain_grid_cfg is None):
        raise ValueError("terrain_bp='grid' needs make_world("
                         "terrain_grid_cfg=...) and cfg.terrain_grid_cfg")
    if cfg.fused_iso and (
            cfg.shape_mode != "spheres" or not cfg.warm_start
            or cfg.solver_rows or cfg.solver != "rows" or world.warm is None
            or (n_tris > 0 and cfg.terrain_bp not in ("near", "grid"))):
        raise ValueError(
            "cfg.fused_iso requires shape_mode='spheres', solver='rows',"
            " warm_start=True, solver_rows=0, and a culled terrain_bp")
    if (cfg.warm_start and cfg.warm_match == "hybrid"
            and not cfg.stable_pairs):
        raise ValueError("warm_match='hybrid' requires stable_pairs")


def _isum(x):
    """A sum in int32, as ``jnp.sum`` of a bool or int32 array is (torch
    would widen it to int64)."""
    return torch.sum(x, dtype=torch.int32)


def _one_pass_terrain(cfg: WorldConfig, n_tris: int,
                      collect_contacts: bool) -> bool:
    """Whether the terrain stage runs as one pass per body
    (``ops.terrain.sphere_terrain_near``, kernel K5 on the card): spheres,
    the "near" cull of a mesh small enough for the kernel's shared memory,
    and no contact streams (they need the raw contacts)."""
    return (cfg.shape_mode == "spheres" and cfg.terrain_bp == "near"
            and not collect_contacts and 0 < n_tris <= MAX_FACES
            and cfg.terrain_cand <= min(MAX_CAND, n_tris))


def _grid_terrain(world: World, state: RigidBodyState, cfg: WorldConfig):
    """The "grid" terrain cull (the mesh BVH::query equivalent,
    mesh.rs:121): the 27 face-table rows around each body's cell, scored
    by a fused int32 key (14-bit quantized centroid distance | 17-bit face
    id), over-selected 4x, the adjacent duplicates a face binned into two
    window cells leaves masked, and the ``terrain_cand`` nearest distinct
    faces kept.  Keys are unique per face, so the selected VALUES do not
    depend on the order of ties; the selections are stable descending
    sorts all the same, as the "near" cull's.  Returns (candidate face ids
    (N, terrain_cand) int32, valid, terrain_reach_excess)."""
    tg = cfg.terrain_grid_cfg
    table = world.terrain_grid
    cap = table.shape[1] // 4
    c = state.x
    cell = lambda comp: torch.floor(comp / tg.cell_size).to(torch.int32)
    cx, cy, cz = cell(c.x), cell(c.y), cell(c.z)
    mmask = tg.dim - 1
    inv_scale = 16383.0 / (3.0 * tg.cell_size) ** 2
    keys = []
    for (dx, dy, dz) in broadphase._OFFSETS:
        h = ((((cx + dx) & mmask) * tg.dim + ((cy + dy) & mmask)) * tg.dim
             + ((cz + dz) & mmask))
        rows = table[h.long()]                       # (N, 4*cap) ONE gather
        fid = rows[:, :cap]
        dxc = rows[:, cap:2 * cap] - c.x[:, None]
        dyc = rows[:, 2 * cap:3 * cap] - c.y[:, None]
        dzc = rows[:, 3 * cap:4 * cap] - c.z[:, None]
        d2 = dxc * dxc + dyc * dyc + dzc * dzc
        q = torch.clamp((d2 * inv_scale).to(torch.int32), max=16383)
        keys.append(torch.where(fid >= 0.0,
                                ((16383 - q) << 17) | fid.to(torch.int32),
                                -1))
    keym = torch.cat(keys, dim=1)                    # (N, 27*cap) int32
    top = lambda k, x: torch.sort(x, dim=1, descending=True,
                                  stable=True).values[:, :k]
    top1 = top(min(4 * cfg.terrain_cand, keym.shape[1]), keym)
    dup = torch.zeros_like(top1, dtype=torch.bool)
    dup[:, 1:] = top1[:, 1:] == top1[:, :-1]
    top2 = top(cfg.terrain_cand, torch.where(dup, -1, top1))
    t_ok = top2 >= 0
    # the +-1-cell window covers a body only while its reach <= cell_size
    t_reach = (state.shape_r + state.shape_half_h
               + torch.sqrt(magnitude2(state.delta)))
    excess = torch.clamp(torch.max(t_reach) - tg.cell_size, min=0.0)
    return torch.where(t_ok, top2 & 0x1FFFF, -1), t_ok, excess


def _match_warm(warm: SolverWarm, partner_rows, key2_rows, n: int,
                n_tris: int, search: bool):
    """Warm-start accumulators for this frame's rows.  Positional: a row
    warms iff the SAME slot held the same (partner, key2) last frame.
    Search: match by (partner, key2) key across all previous slots, first
    match wins (a one-hot contraction over the previous slots)."""
    if not search:
        hit = (partner_rows == warm.partner) & (key2_rows == warm.key2)
        hf = hit.to(torch.float32)
        return warm.acc_n * hf, warm.acc_t1 * hf, warm.acc_t2 * hf, hit
    kbit = 1 << 17
    if (n + 1) < kbit and max(n_tris, 8) < (1 << 14):
        # (partner, key2) fused into one injective int32 key
        k_now = key2_rows * kbit + partner_rows
        k_prev = torch.where(warm.partner < 0, -9,
                             warm.key2 * kbit + warm.partner)
        eq = k_now[:, None, :] == k_prev[None]
    else:
        eq = ((partner_rows[:, None, :] == warm.partner[None])
              & (key2_rows[:, None, :] == warm.key2[None]))
    # first-match one-hot over the previous slots.  The running count is
    # int32 on purpose: torch.cumsum would promote a narrower integer to
    # int64, and the (R, R_prev, N) tensor is the step's largest
    first = eq & (torch.cumsum(eq, dim=1, dtype=torch.int32) == 1)
    wn = torch.zeros(partner_rows.shape, dtype=torch.float32,
                     device=partner_rows.device)
    wt1, wt2 = wn, wn
    for k in range(warm.partner.shape[0]):
        mk = first[:, k, :].to(torch.float32)
        wn = wn + mk * warm.acc_n[k][None]
        wt1 = wt1 + mk * warm.acc_t1[k][None]
        wt2 = wt2 + mk * warm.acc_t2[k][None]
    return wn, wt1, wt2, torch.any(first, dim=1)


def _fat_pairs(bounds, alive, cfg: WorldConfig):
    """One fat-grid candidate build in the mode ``cfg.broadphase`` names
    (width 4 for "fat8x4"/"fat27x4", else 8; the sel8 octant for
    "fat8"/"fat8x4", else 27 cells): partner (N, K), ok, overflow;
    canonically sorted with ``stable_pairs``.  The flat solvers take each
    pair once (the partner of smaller index), the rows solver in both
    directions."""
    grid = broadphase.build_fat_grid(
        bounds, cfg.grid,
        width=4 if cfg.broadphase in ("fat8x4", "fat27x4") else 8,
        valid=alive)
    partner, pair_ok = broadphase.fat_grid_pairs(
        bounds, grid, cfg.grid, cfg.max_pairs, ordered=cfg.solver != "rows",
        window="sel8" if cfg.broadphase in ("fat8", "fat8x4") else "27")
    if cfg.stable_pairs:
        partner, pair_ok = _stable_sort_pairs(partner, pair_ok)
    return partner, pair_ok, grid.overflow


def _man_to_rows(man: Manifold, width: int, n: int) -> Manifold:
    """Manifold over slot-major (S, width, N) pairs -> (S * width, N)
    solver rows; the per-pair fields repeat for each slot."""
    S = man.valid.shape[0]
    slotf = lambda x: x.reshape(S * width, n)
    pairf = lambda x: x.reshape(1, width, n).expand(S, width, n).reshape(-1, n)
    return Manifold(time=pairf(man.time), normal=tree_map(pairf, man.normal),
                    t1=tree_map(pairf, man.t1), t2=tree_map(pairf, man.t2),
                    local_a=tree_map(slotf, man.local_a),
                    local_b=tree_map(slotf, man.local_b),
                    valid=slotf(man.valid))


def _compact_rows(man_rows: Manifold, partner_rows, key2_rows, kk: int):
    """Keep every body's top-``kk`` rows, valid and earliest first (score
    valid * (2 - clip(time, 0, 1))), as one gather of the packed (R0, N,
    20) rows (body indices < 2^24 are exact in float32).  ``lax.top_k``
    keeps the lower row among equal scores: a stable descending sort.
    Returns the compacted rows and the count of valid rows dropped."""
    m = man_rows
    n_valid = torch.sum(m.valid, dim=0)
    score = m.valid.to(torch.float32) * (2.0 - torch.clamp(m.time, 0.0, 1.0))
    packed = torch.stack([
        m.time, *m.normal, *m.t1, *m.t2, *m.local_a, *m.local_b,
        m.valid.to(torch.float32), partner_rows.to(torch.float32),
        key2_rows.to(torch.float32), torch.zeros_like(m.time)], dim=-1)
    r_idx = torch.sort(score.T, dim=1, descending=True,
                       stable=True).indices[:, :kk].T       # (kk, N)
    g = torch.gather(packed, 0, r_idx[:, :, None].expand(-1, -1, 20))
    out = Manifold(time=g[..., 0], normal=Vec3(g[..., 1], g[..., 2],
                                               g[..., 3]),
                   t1=Vec3(g[..., 4], g[..., 5], g[..., 6]),
                   t2=Vec3(g[..., 7], g[..., 8], g[..., 9]),
                   local_a=Vec3(g[..., 10], g[..., 11], g[..., 12]),
                   local_b=Vec3(g[..., 13], g[..., 14], g[..., 15]),
                   valid=g[..., 16] > 0.5)
    dropped = torch.sum(torch.clamp(n_valid - kk, min=0)).to(torch.int32)
    return (out, g[..., 17].to(torch.int32), g[..., 18].to(torch.int32),
            dropped)


def _flat_solve(cfg: WorldConfig, manifolds, idx_a, idx_b, bodies_ext,
                n: int):
    """The reference's single-direction constraint list: mass-splitting
    counts over the n + 1 body rows (``solver="parallel"`` only), one
    ``build_constraints`` per manifold in order (pairs, then terrain), and
    the sequential or the parallel solve.  Manifolds come slot-major (S,
    width, N) and are flattened row-major, the JAX package's layout.
    Returns (v, omega, the constraint list's valid mask)."""
    dev = bodies_ext.inv_mass.device
    flat = lambda man: tree_map(lambda x: x.reshape(x.shape[0], -1)
                                if x.dim() == 3 else x.reshape(-1), man)
    manifolds = [flat(m) for m in manifolds]
    use_split = cfg.solver == "parallel"
    if use_split:
        counts = torch.zeros((n + 1,), dtype=torch.float32, device=dev)
        for man, ia, ib in zip(manifolds, idx_a, idx_b):
            pts = torch.sum(man.valid, dim=0).to(torch.float32)
            counts.index_add_(0, ia.long(), pts)
            counts.index_add_(0, ib.long(), pts)
        counts = torch.clamp(counts, min=1.0)
    cons = []
    for man, ia, ib in zip(manifolds, idx_a, idx_b):
        split = ((counts[ia.long()], counts[ib.long()]) if use_split
                 else (None, None))
        cons.append(build_constraints(bodies_ext, ia, ib, man, cfg.dt,
                                      *split, bias_max=cfg.bias_max))
    con = tree_map(lambda *xs: torch.cat(xs, dim=0), *cons)
    solve = solve_parallel if use_split else solve_sequential
    v, omega = solve(con, bodies_ext, cfg.solver_iters, cfg.friction_mode)
    return v, omega, con.valid


def _top_terrain_rows(tman: Manifold, t_key2, kk: int):
    """Keep the top-``kk`` terrain rows of every body, valid and earliest
    first (score valid * (2 - time)).  ``lax.top_k`` keeps the lower row
    among equal scores, and ties are certain (every invalid row scores 0,
    every overlap 2), so a stable descending sort; the kept order is the
    order the solver sums the rows in."""
    score = tman.valid.to(torch.float32) * (2.0 - tman.time)
    t_idx = torch.sort(score.T, dim=1, descending=True,
                       stable=True).indices[:, :kk].T       # (kk, N)
    sel = lambda f: torch.gather(f, 0, t_idx)
    return tree_map(sel, tman), sel(t_key2)


def step(world: World, cfg: WorldConfig, collect_contacts: bool = False):
    """One physics frame (World::step, world.rs:227-294).  Returns
    (new_world, metrics dict of device tensors).  ``collect_contacts``
    adds the raw pair and terrain contact streams with their index vectors
    to the metrics, in the JAX package's flat layout.  With
    ``cfg.profile_stage`` set, (world, {"probe": scalar}) after that
    stage.  In debug mode (``utils.debug.enable_debug_mode``) a
    non-finite value in the output state or metrics raises
    ``FloatingPointError``."""
    out = _step(world, cfg, collect_contacts)
    if DEBUG_NANS:
        from mgf_tpu_torch.utils.debug import check_finite
        check_finite(*out)
    return out


class StepHead(NamedTuple):
    """What the step's first segment (:func:`step_head`) hands to the rest
    (:func:`step_tail`): the integrated state, the broadphase bounds, the
    head's metric scalars and, on a cached fat grid, the staleness test
    whose ``need`` the host reads.  ``x_end``, ``drift2`` and ``slack``
    are None where the step keeps no cache."""
    state: RigidBodyState
    sv: ShapeView
    alive: torch.Tensor
    body_bounds: AABB
    bounds: AABB
    r_eff: torch.Tensor
    reach_excess: torch.Tensor
    span_excess: torch.Tensor
    need: torch.Tensor
    x_end: Vec3 = None
    drift2: torch.Tensor = None
    slack: torch.Tensor = None


def reads_need(world: World, cfg: WorldConfig) -> bool:
    """Whether a step of ``cfg`` on ``world`` reads ``need`` on the host:
    the fat grid with a cache (``bp_every > 1`` or ``bp_margin > 0``) and
    its state.  Every other step has no host read; its ``need`` is True."""
    return (cfg.use_grid and cfg.broadphase in FAT_MODES
            and (cfg.bp_margin > 0.0 or cfg.bp_every > 1)
            and world.bp is not None)


def _step(world: World, cfg: WorldConfig, collect_contacts: bool):
    if tracing.ON:
        tracing.stamp("step_gap", world.bodies.x.x.device)
    head = step_head(world, cfg)
    if cfg.profile_stage == "integrate":
        return world, {"probe": torch.sum(head.bounds.c.x)}
    # the one host read of the step: rebuild or reuse (JAX: lax.cond)
    rebuild = bool(head.need) if reads_need(world, cfg) else True
    out = step_tail(world, cfg, head, rebuild, collect_contacts)
    if tracing.ON:
        tracing.stamp("finish", world.bodies.x.x.device, rebuild)
    return out


def step_head(world: World, cfg: WorldConfig) -> StepHead:
    """The step up to its one host read: complete_motion, integrate, the
    swept fat bounds with their excess metrics and, on a cached fat grid,
    the staleness test ``need`` (rebuild the candidate list or reuse it).
    It reads nothing on the host and builds no tensor from host data."""
    n_tris = world.terrain.a.x.shape[0]
    _check_config(cfg, world, n_tris)
    iso_mode = cfg.shape_mode == "spheres"
    state = complete_motion(world.bodies)
    state = integrate(state, cfg.dt, iso=iso_mode)
    n = state.n_bodies
    dev = state.x.x.device
    if tracing.ON:
        tracing.stamp("integrate", dev)
    f32 = lambda v: torch.full((), v, dtype=torch.float32, device=dev)
    sv = shape_view(state)
    light = cfg.light_metrics

    # ---- broadphase bounds ----
    alive = state.shape_r > 0.0
    body_bounds = _body_bounds(cfg, sv)
    bounds = broadphase.swept_fat_bounds(body_bounds, state.delta, cfg.fatten)
    r_eff = torch.where(alive, torch.maximum(
        bounds.r.x, torch.maximum(bounds.r.y, bounds.r.z)), 0.0)
    # the window covers pair reach up to a cell ("27", packed) or half a
    # cell (the sel8 octant)
    guarantee = cfg.grid.cell_size * (0.5 if cfg.broadphase in
                                      ("fat8", "fat8x4") else 1.0)
    if n >= 2 and not light:
        m1 = torch.max(r_eff)
        m2 = torch.clamp(torch.max(torch.where(r_eff < m1, r_eff,
                                               -float("inf"))), min=0.0)
        top2sum = torch.where(torch.sum(r_eff == m1) >= 2, 2.0 * m1, m1 + m2)
    else:
        top2sum = f32(0.0)
    if light or not cfg.use_grid:
        reach_excess = f32(0.0)
        span_excess = f32(0.0)
    else:
        reach_excess = torch.clamp(top2sum - guarantee, min=0.0)
        gdims = broadphase.grid_dims(cfg.grid)
        span = lambda c: (torch.max(torch.where(alive, c, -float("inf")))
                          - torch.min(torch.where(alive, c, float("inf"))))
        span_excess = torch.clamp(torch.maximum(torch.maximum(
            span(bounds.c.x) / (gdims[0] * cfg.grid.cell_size),
            span(bounds.c.y) / (gdims[1] * cfg.grid.cell_size)),
            span(bounds.c.z) / (gdims[2] * cfg.grid.cell_size)) - 1.0,
            min=0.0)

    need = torch.ones((), dtype=torch.bool, device=dev)
    x_end = drift2 = slack = None
    if reads_need(world, cfg):
        bp = world.bp
        x_end = state.x + state.delta
        drift2 = magnitude2(x_end - bp.anchor)
        margin_trip = (0.5 * cfg.bp_margin) ** 2
        if cfg.bp_every > 1:
            # cadence cache: slack per body covers the skipped steps'
            # motion, clamped to the window budget; a body outrunning its
            # slack (drift + growth of its reach) forces a rebuild now
            dmag = torch.sqrt(magnitude2(state.delta))
            desired = (cfg.bp_every - 1) * (2.0 * dmag + 0.02)
            budget = torch.clamp(0.5 * guarantee - r_eff, min=0.0)
            slack = torch.minimum(desired, budget)
            r_grow = torch.clamp(r_eff - bp.r_build, min=0.0)
            stale = torch.max(torch.where(
                alive, torch.sqrt(drift2) + r_grow - bp.slack, 0.0)) > 0.0
            need = ((bp.count % cfg.bp_every) == 0) | stale
            if cfg.bp_margin > 0.0:
                # the drift safety net composes (max over every row, the
                # dead ones too, as in the JAX package)
                need = need | (torch.max(drift2) > margin_trip)
        else:
            # fat-proxy refit: rebuild once some body drifted more than
            # margin / 2 from where the list was built
            slack = torch.full((n,), 0.5 * cfg.bp_margin,
                               dtype=torch.float32, device=dev)
            need = torch.max(drift2) > margin_trip
    if tracing.ON:
        tracing.stamp("bounds", dev)
    return StepHead(state=state, sv=sv, alive=alive, body_bounds=body_bounds,
                    bounds=bounds, r_eff=r_eff, reach_excess=reach_excess,
                    span_excess=span_excess, need=need, x_end=x_end,
                    drift2=drift2, slack=slack)


def step_tail(world: World, cfg: WorldConfig, head: StepHead, rebuild: bool,
              collect_contacts: bool = False):
    """The step after its host read, from :func:`step_head`'s output:
    ``rebuild`` (a Python bool, the value of ``head.need``; True where the
    step keeps no cache) picks the candidate list's rebuild or reuse and,
    with ``warm_match="hybrid"``, the keyed or the positional warm match.
    Returns what :func:`step` returns."""
    n_tris = world.terrain.a.x.shape[0]
    rows_form = cfg.solver == "rows"
    fused = cfg.fused_iso
    iso_mode = cfg.shape_mode == "spheres"
    n_slots = 1 if iso_mode else 2
    state, sv, alive = head.state, head.sv, head.alive
    bounds, r_eff, need = head.bounds, head.r_eff, head.need
    n = state.n_bodies
    dev = state.x.x.device
    if tracing.ON:
        tracing.stamp("need_gap", dev, rebuild)
    f32 = lambda v: torch.full((), v, dtype=torch.float32, device=dev)
    light = cfg.light_metrics
    # type-partitioned mixed narrowphase (see cfg.n_sphere_rows): needs
    # the rows solver, type-sorted bodies and a culled (or absent) terrain
    split_mixed = (rows_form and cfg.shape_mode == "mixed"
                   and cfg.n_sphere_rows >= 0
                   and (n_tris == 0 or cfg.terrain_bp in ("near", "grid")))

    # ---- broadphase: all pairs, packed grid, or the fat grid (cached or
    # not) ----
    bp = world.bp
    new_bp = bp
    bp_drift_excess = f32(0.0)
    fat = cfg.use_grid and cfg.broadphase in FAT_MODES
    if not fat:
        # the packed grid (any broadphase name that is not a fat mode, as
        # the JAX package's `elif cfg.use_grid`) or all pairs
        if cfg.use_grid:
            table = broadphase.build_grid(bounds.c, cfg.grid, valid=alive)
            cand = broadphase.neighbor_candidates(bounds.c, table, cfg.grid)
            overflow = table.overflow
        else:
            cand = broadphase.all_pairs_candidates(n, dev)
            overflow = torch.zeros((), dtype=torch.int32, device=dev)
        partner, pair_ok = broadphase.refine_pairs(bounds, cand,
                                                   cfg.max_pairs,
                                                   ordered=not rows_form)
        if cfg.stable_pairs and cfg.broadphase not in FAT_MODES:
            partner, pair_ok = _stable_sort_pairs(partner, pair_ok)
    elif reads_need(world, cfg):
        slack = head.slack
        if rebuild:
            fat_bounds = broadphase.swept_fat_bounds(
                head.body_bounds, state.delta, cfg.fatten + cfg.bp_margin)
            if cfg.bp_every > 1:
                fat_bounds = fat_bounds._replace(r=Vec3(
                    fat_bounds.r.x + slack, fat_bounds.r.y + slack,
                    fat_bounds.r.z + slack))
            partner, pair_ok, overflow = _fat_pairs(fat_bounds, alive, cfg)
            new_bp = BpCache(partner=partner, ok=pair_ok, anchor=head.x_end,
                             overflow=overflow, count=bp.count + 1,
                             slack=slack, r_build=r_eff)
        else:
            partner, pair_ok = bp.partner, bp.ok
            new_bp = bp._replace(count=bp.count + 1)
            bp_drift_excess = torch.clamp(torch.max(torch.where(
                alive, torch.sqrt(head.drift2) - bp.slack, 0.0)), min=0.0)
        overflow = new_bp.overflow
    else:
        partner, pair_ok, overflow = _fat_pairs(bounds, alive, cfg)
    if tracing.ON:
        tracing.stamp("pairs", dev, rebuild)
    if cfg.profile_stage == "pairs":
        return world, {"probe": _isum(partner) + _isum(pair_ok)}

    # ---- body-body narrowphase over slot-major (K, N) partner rows ----
    K = partner.shape[1]
    partner_t = partner.T
    pair_ok_t = pair_ok.T
    cols2 = torch.where(pair_ok_t, partner_t, 0)
    ga = self_shapes(cfg, sv)                     # (1, N) broadcasts
    if fused:
        # previous frame's mass-splitting counts, from the warm state
        cnt_prev = torch.clamp(torch.sum(
            (world.warm.partner != -9).to(torch.float32), dim=0), min=1.0)
        pw = torch.stack([
            sv.x.x, sv.x.y, sv.x.z,
            sv.delta.x, sv.delta.y, sv.delta.z, sv.shape_r,
            state.v.x, state.v.y, state.v.z,
            state.omega.x, state.omega.y, state.omega.z,
            state.restitution, state.friction, state.inv_mass,
            cnt_prev, state.inv_moment.xx], dim=-1)   # (N, 18)
        g18 = pw[cols2.long()]                    # (K, N, 18) — THE gather
        gx = Vec3(g18[..., 0], g18[..., 1], g18[..., 2])
        gd = Vec3(g18[..., 3], g18[..., 4], g18[..., 5])
        gb = GatheredShapes(x=gx, delta=gd,
                            sphere=Sphere(c=gx, r=g18[..., 6]))
        pf = PartnerFields(
            x_end=gx + gd,
            v=Vec3(g18[..., 7], g18[..., 8], g18[..., 9]),
            omega=Vec3(g18[..., 10], g18[..., 11], g18[..., 12]),
            restitution=g18[..., 13], friction=g18[..., 14],
            inv_mass=g18[..., 15], count=g18[..., 16], iso=g18[..., 17])
    else:
        # (K, N) partner side: one wide row gather
        gb = gather_shapes(cfg, pack_shapes(sv, cfg.shape_mode), cols2)
    if cfg.pallas_narrowphase and iso_mode and not fused:
        # kernel K2 on (8, K*N) blocks: the self side is the body columns
        # repeated per slot, the partner side the gathered rows
        c = sphere_contact_pairs(_block8(ga, (K, n)), _block8(gb, (K, n)))
        pc = contact_stack_bcast([tree_map(lambda x: x.reshape(K, n), c)])
    elif split_mixed:
        pc = _pair_contact_split(cfg, ga, gb, cfg.n_sphere_rows)
    else:
        pc = _pair_contact(cfg, ga, gb)           # slots (S, K, N)
    pc = pc._replace(valid=pc.valid & pair_ok_t[None])
    lc = LocalContact(local_a=pc.a - (ga.x + ga.delta * pc.t),
                      local_b=pc.b - (gb.x + gb.delta * pc.t),
                      contact=pc)
    prox = manifold_prox_sq(cfg)
    pair_manifold = prune(lc, max_contacts=n_slots, prox_sq=prox)
    if tracing.ON:
        tracing.stamp("narrow", dev, rebuild)
    if cfg.profile_stage == "narrow":
        return world, {"probe": _isum(pair_manifold.valid)
                       + torch.sum(pair_manifold.local_a.x)}
    max_pen = f32(0.0) if light else _deepest(pc)

    # ---- terrain narrowphase: one pass for spheres against a small mesh
    # (kernel K5), else dense, the "near" cull or the face grid ----
    t_reach_excess = f32(0.0)
    if _one_pass_terrain(cfg, n_tris, collect_contacts):
        t_width = cfg.terrain_cand
        t_manifold, t_tris, t_deep = sphere_terrain_near(
            state.x, state.delta, state.shape_r, state.shape_half_h,
            world.terrain, world.terrain_center, t_width, cfg.stable_pairs,
            with_deepest=not light)
        if not light:
            max_pen = torch.maximum(max_pen, t_deep)
    elif n_tris > 0:
        if cfg.terrain_bp in ("near", "grid"):
            if cfg.terrain_bp == "near":
                t_cand, t_ok = near_terrain(
                    world.terrain, state.x, state.delta, state.shape_r,
                    state.shape_half_h, cfg.terrain_cand)
            else:
                t_cand, t_ok, t_reach_excess = _grid_terrain(world, state,
                                                             cfg)
            if cfg.stable_pairs:
                t_cand, t_ok = stable_candidates(t_cand, t_ok)
            t_width = cfg.terrain_cand
            t_tris = torch.where(t_ok, t_cand, 0).T        # (T_w, N)
            t_valid = t_ok.T
            tri = gather_triangles(world.terrain, t_tris)
        else:
            # dense: every (triangle, body) pair, triangles down the rows
            t_width = n_tris
            t_tris = torch.arange(n_tris, dtype=torch.int32, device=dev)[
                :, None].expand(n_tris, n)
            t_valid = None
            tri = tree_map(lambda x: x[:, None].expand(n_tris, n),
                           world.terrain)
        tc = (_terrain_contact_split(cfg, ga, tri, cfg.n_sphere_rows)
              if split_mixed else _terrain_contact(cfg, ga, tri))
        if t_valid is not None:                        # slots (S, T_w, N)
            tc = tc._replace(valid=tc.valid & t_valid[None])
        t_lc = LocalContact(local_a=tc.a - (ga.x + ga.delta * tc.t),
                            local_b=tc.b - world.terrain_center,
                            contact=tc)
        t_manifold = prune(t_lc, max_contacts=n_slots, prox_sq=prox)
        if not light:
            max_pen = torch.maximum(max_pen, _deepest(tc))
    if tracing.ON:
        tracing.stamp("terrain", dev, rebuild)
    if cfg.profile_stage == "terrain":
        n_valid = _isum(pair_manifold.valid)
        if n_tris > 0:
            n_valid = n_valid + _isum(t_manifold.valid)
        return world, {"probe": n_valid + max_pen}

    # what the step's tail reports, whichever solver runs
    tail = dict(alive=alive, overflow=overflow,
                reach_excess=head.reach_excess,
                span_excess=head.span_excess, t_reach_excess=t_reach_excess,
                need=need, bp_drift_excess=bp_drift_excess,
                pair_ok_t=pair_ok_t, max_pen=max_pen,
                rows_dropped=torch.zeros((), dtype=torch.int32, device=dev),
                warm_hit_frac=f32(0.0))
    streams = None
    if collect_contacts:
        streams = dict(K=K, cols2=cols2, pc=pc)
        if n_tris > 0:
            streams.update(t_width=t_width, t_tris=t_tris, tc=tc)
    if not fused:
        # the body arrays extended by one virtual static row for the
        # terrain (RigidBodyRef::Static, physics.rs:289-302)
        srow = lambda g: torch.cat([g, torch.zeros(
            (1,) + g.shape[1:], dtype=g.dtype, device=dev)], dim=0)
        bodies_ext = BodyView(
            x=Vec3(*(torch.cat([g, c.reshape(1)]) for g, c in zip(
                state.x + state.delta, world.terrain_center))),
            v=tree_map(srow, state.v), omega=tree_map(srow, state.omega),
            restitution=srow(state.restitution),
            friction=srow(state.friction),   # Static{friction: 0}, world.rs:247
            inv_mass=srow(state.inv_mass),
            inv_moment=tree_map(srow, state.inv_moment))
    if not rows_form:
        # ---- flat constraint list (reference single-direction form) ----
        rows_idx = lambda w: torch.arange(n, dtype=torch.int32, device=dev)[
            None, :].expand(w, n).reshape(-1)
        manifolds, idx_a, idx_b = [pair_manifold], [rows_idx(K)], [
            cols2.reshape(-1)]
        if n_tris > 0:
            manifolds.append(t_manifold)
            idx_a.append(rows_idx(t_width))
            idx_b.append(torch.full((t_width * n,), n, dtype=torch.int32,
                                    device=dev))
        v, omega, rc_valid = _flat_solve(cfg, manifolds, idx_a, idx_b,
                                         bodies_ext, n)
        if tracing.ON:
            tracing.stamp("solve", dev, rebuild)
        return _finish(world, cfg, state, v, omega, rc_valid, tail,
                       world.warm, new_bp, streams)

    # ---- scatter-free row constraints ----
    # row layout: [pair slot0 K | pair slot1 K | terrain slot0 C | terrain
    # slot1 C] (one slot block each for spheres)
    blocks = [_man_to_rows(pair_manifold, K, n)]
    partners = [torch.where(pair_ok_t, partner_t, n)[None].expand(
        n_slots, K, n).reshape(-1, n)]
    # warm-start row keys: pair rows by manifold slot id, terrain rows by
    # triangle id (their partner is the static row n: no collision)
    key2s = [torch.arange(n_slots, dtype=torch.int32, device=dev)[
        :, None, None].expand(n_slots, K, n).reshape(-1, n)]
    if n_tris > 0:
        tman = _man_to_rows(t_manifold, t_width, n)    # (S*T_w, N)
        t_key2 = t_tris.reshape(1, t_width, n).expand(
            n_slots, t_width, n).reshape(-1, n)
        t_rows_n = tman.valid.shape[0]
        if cfg.terrain_rows and t_rows_n > cfg.terrain_rows:
            tman, t_key2 = _top_terrain_rows(tman, t_key2, cfg.terrain_rows)
            t_rows_n = cfg.terrain_rows
        blocks.append(tman)
        partners.append(torch.full((t_rows_n, n), n, dtype=torch.int32,
                                   device=dev))
        key2s.append(t_key2)
    man_rows = tree_map(lambda *xs: torch.cat(xs, dim=0), *blocks)
    partner_rows = torch.cat(partners, dim=0)
    key2_rows = torch.cat(key2s, dim=0)
    if cfg.solver_rows and man_rows.valid.shape[0] > cfg.solver_rows:
        # compact to the top-k valid rows per body (earliest TOI first):
        # identical physics whenever a body has <= k contacts; beyond that
        # the latest-TOI rows are dropped (counted in the metrics)
        man_rows, partner_rows, key2_rows, tail["rows_dropped"] = \
            _compact_rows(man_rows, partner_rows, key2_rows, cfg.solver_rows)
    if tracing.ON:
        tracing.stamp("rows", dev, rebuild)
    if cfg.profile_stage == "rows":
        return world, {"probe": _isum(man_rows.valid) + _isum(partner_rows)}
    rc_valid = man_rows.valid
    new_warm = world.warm

    # TWO-BLOCK split (mixed): sphere columns can never hold slot-1 pair or
    # terrain rows (spheres emit one contact per pair) and their self
    # inertia is a scalar, so both the constraint build and the solve run
    # as: sphere block over its K + C live rows, then capsule block over
    # all rows with Mat3 inertia.  Compacted rows lose that layout.
    split_solve = (split_mixed and not cfg.terrain_rows
                   and not cfg.solver_rows)
    if split_solve:
        ns_b = cfg.n_sphere_rows
        C_t = t_width if n_tris > 0 else 0
        rows_a = lambda g: torch.cat(
            [g[0:K, :ns_b], g[2 * K:2 * K + C_t, :ns_b]], dim=0)
        rows_b = lambda g: g[:, ns_b:]

    # ---- constraint precompute ----
    n_pair_rows = None
    pt0 = None
    if fused:
        # gather-free precompute: pair-row partner fields rode the
        # narrowphase gather, terrain rows have the static body as partner
        n_pair_rows = n_slots * K
        bv = BodyView(x=state.x + state.delta, v=state.v, omega=state.omega,
                      restitution=state.restitution, friction=state.friction,
                      inv_mass=state.inv_mass, inv_moment=state.inv_moment)
        rc = build_row_constraints_iso_fused(
            bv, cnt_prev, pf, partner_rows, man_rows, cfg.dt,
            world.terrain_center, n_pair_rows, bias_max=cfg.bias_max)
        sv_in = (state.v, state.omega, state.inv_mass)
        solver_inertia = state.inv_moment.xx
    else:
        # mass splitting: every contact of body i is in column i; the
        # static terrain row (index n) counts 1
        counts = torch.clamp(torch.cat([
            torch.sum(rc_valid, dim=0).to(torch.float32),
            torch.ones((1,), dtype=torch.float32, device=dev)]), min=1.0)
        sv_in = (bodies_ext.v, bodies_ext.omega, bodies_ext.inv_mass)
        if iso_mode:
            rc, pt0 = build_row_constraints_iso(
                bodies_ext, partner_rows, man_rows, cfg.dt, counts=counts,
                bias_max=cfg.bias_max)
            solver_inertia = bodies_ext.inv_moment.xx
        elif split_solve:
            # per-block precompute: the slot-1 rows of sphere columns are
            # never built at all
            rc = None
            rc_a = build_row_constraints(
                bodies_ext, rows_a(partner_rows), tree_map(rows_a, man_rows),
                cfg.dt, counts=counts, bias_max=cfg.bias_max)
            rc_b = build_row_constraints(
                bodies_ext, rows_b(partner_rows), tree_map(rows_b, man_rows),
                cfg.dt, counts=counts, col_offset=ns_b,
                bias_max=cfg.bias_max)
            solver_inertia = bodies_ext.inv_moment
        else:
            rc = build_row_constraints(bodies_ext, partner_rows, man_rows,
                                       cfg.dt, counts=counts,
                                       bias_max=cfg.bias_max)
            solver_inertia = bodies_ext.inv_moment

    if tracing.ON:
        tracing.stamp("constraints", dev, rebuild)
    if cfg.profile_stage == "constraints":
        if rc is None:
            return world, {"probe": torch.sum(rc_a.bias)
                           + torch.sum(rc_b.normal_mass)}
        return world, {"probe": torch.sum(rc.bias)
                       + torch.sum(rc.normal_mass)}

    # ---- warm matching (JAX hybrid: lax.cond on the same `need`) ----
    warm = None
    matched = None
    if cfg.warm_start and world.warm is not None:
        search = (cfg.warm_match == "search"
                  or (cfg.warm_match == "hybrid" and rebuild))
        wn, wt1, wt2, matched = _match_warm(world.warm, partner_rows,
                                            key2_rows, n, n_tris, search)
        if cfg.warm_gamma != 1.0:
            # applied once at match time, before the block partition
            g = cfg.warm_gamma
            wn, wt1, wt2 = wn * g, wt1 * g, wt2 * g
        warm = (wn, wt1, wt2)
    if tracing.ON:
        tracing.stamp("warm", dev, rebuild)
    if cfg.profile_stage == "warm":
        probe = _isum(rc_valid)
        if warm is not None:
            probe = torch.sum(warm[0]) + torch.sum(warm[1]) + probe
        return world, {"probe": probe}

    # ---- solve ----
    use_pk = (cfg.pallas_solver and fused and not cfg.two_phase
              and cfg.friction_mode == "textbook")
    if split_solve:
        iso_arr = bodies_ext.inv_moment.xx
        warm_a = warm_b = None
        if warm is not None:
            warm_a = tuple(rows_a(w) for w in warm)
            warm_b = tuple(rows_b(w) for w in warm)

        def run_solve(it, inner):
            # spheres first, then capsules from the state the sphere block
            # solved: a two-colour Gauss-Seidel
            S1, acc_a = solve_rows(
                rc_a, sv_in[0], sv_in[1], sv_in[2], iso_arr, it,
                cfg.friction_mode, cfg.two_phase, inner, warm=warm_a,
                return_acc=True, return_state=True)
            if tracing.ON:
                tracing.stamp("solve_spheres", dev, rebuild)
            S2, acc_b = solve_rows(
                rc_b, sv_in[0], sv_in[1], sv_in[2], solver_inertia, it,
                cfg.friction_mode, cfg.two_phase, inner, warm=warm_b,
                return_acc=True, state0=S1, return_state=True,
                col_offset=ns_b)
            v2, o2 = unpack_body_state(S2)
            accs = []
            for k in range(3):
                a = torch.zeros(rc_valid.shape, dtype=torch.float32,
                                device=dev)
                a[:, ns_b:] = acc_b[k]
                a[0:K, :ns_b] = acc_a[k][0:K]
                if C_t:
                    a[2 * K:2 * K + C_t, :ns_b] = acc_a[k][K:K + C_t]
                accs.append(a)
            return v2, o2, tuple(accs)
    else:
        def run_solve(it, inner):
            # NOTE: pt0 is not passed to a warm solve: the warm pre-apply
            # moves partner velocities by full accumulated impulses, so a
            # pre-warm frozen term is too stale (see the JAX package)
            return solve_rows(
                rc, sv_in[0], sv_in[1], sv_in[2], solver_inertia, it,
                cfg.friction_mode, cfg.two_phase, inner, warm=warm,
                return_acc=True, n_gather_rows=n_pair_rows,
                pallas_inner=use_pk,
                partner_term0=None if cfg.warm_start else pt0)

    schedule = (cfg.solver_iters, cfg.solver_inner)
    if cfg.warm_start:
        if matched is not None:
            tail["warm_hit_frac"] = (
                torch.sum((matched & rc_valid).to(torch.float32))
                / torch.clamp(torch.sum(rc_valid.to(torch.float32)),
                              min=1.0))
        if cfg.adapt_schedule is not None and matched is not None:
            # JAX: lax.cond on the device; here a second host read (the
            # chunk stepper of driver.py clears adapt_schedule and picks
            # the schedule itself, two chunks late)
            thr, it2, in2 = cfg.adapt_schedule
            if float(tail["warm_hit_frac"]) >= thr:
                schedule = (int(it2), int(in2))
        v, omega, acc = run_solve(*schedule)
        new_warm = SolverWarm(partner=torch.where(rc_valid, partner_rows, -9),
                              key2=key2_rows, acc_n=acc[0], acc_t1=acc[1],
                              acc_t2=acc[2])
    else:
        v, omega, _ = run_solve(*schedule)
    if tracing.ON:
        # the split solve's capsule block closes its second interval
        tracing.stamp("solve_capsules" if split_solve else "solve", dev,
                      rebuild)
        if split_solve:
            tail["capsule_cols"] = ns_b
    if cfg.profile_stage == "solve":
        return world, {"probe": torch.sum(v.x) + torch.sum(omega.x)}
    return _finish(world, cfg, state, v, omega, rc_valid, tail, new_warm,
                   new_bp, streams)


def _finish(world: World, cfg: WorldConfig, state: RigidBodyState, v, omega,
            rc_valid, mv: dict, new_warm, new_bp, streams):
    """The step's tail on every branch: the solved velocities into the
    state, the metrics dict, and with ``streams`` the contact streams in
    the JAX package's flat layout."""
    n = state.n_bodies
    dev = state.x.x.device
    light = cfg.light_metrics
    # NOTE: ``delta`` keeps its pre-solve value, as in the JAX package
    vt = Vec3(*(c[:n] for c in v))
    ot = Vec3(*(c[:n] for c in omega))
    if light:
        dv_norm = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        dv = vt - state.v
        dv_norm = torch.sqrt(torch.sum(dv.x * dv.x + dv.y * dv.y
                                       + dv.z * dv.z))
    state = state._replace(v=vt, omega=ot)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    num_contacts = (zero_i if light
                    else torch.sum(rc_valid).to(torch.int32))
    if tracing.ON:
        tracing.count(dev, mv["pair_ok_t"], rc_valid)
        if "capsule_cols" in mv:
            tracing.count_capsule_rows(dev, rc_valid[:, mv["capsule_cols"]:])
    metrics = {
        "num_alive": zero_i if light else
        torch.sum(mv["alive"]).to(torch.int32),
        "broadphase_overflow": mv["overflow"],
        "broadphase_reach_excess": mv["reach_excess"],
        "broadphase_span_excess": mv["span_excess"],
        "terrain_reach_excess": mv["t_reach_excess"],
        "broadphase_rebuilt": mv["need"],
        "broadphase_cache_drift_excess": mv["bp_drift_excess"],
        "num_pairs": zero_i if light else
        torch.sum(mv["pair_ok_t"]).to(torch.int32),
        "num_contacts": num_contacts,
        "num_constraints": rc_valid.numel(),
        "solver_rows_dropped": mv["rows_dropped"],
        "warm_hit_frac": mv["warm_hit_frac"],
        "max_penetration": mv["max_pen"],
        "solver_dv_norm": dv_norm,
    }
    if streams:
        flat = lambda c: tree_map(lambda x: x.reshape(x.shape[0], -1), c)
        rows = lambda w: torch.arange(n, dtype=torch.int32, device=dev)[
            None, :].expand(w, n).reshape(-1)
        metrics["pair_contacts"] = dict(i=rows(streams["K"]),
                                        j=streams["cols2"].reshape(-1),
                                        contact=flat(streams["pc"]))
        if "tc" in streams:
            metrics["terrain_contacts"] = dict(
                i=rows(streams["t_width"]),
                tri=streams["t_tris"].reshape(-1),
                contact=flat(streams["tc"]))
    return world._replace(bodies=state, warm=new_warm, bp=new_bp), metrics


def make_step_fn(cfg: WorldConfig):
    """A step closure over a config (the JAX package jits it; here it is
    the eager step, so a new body count needs no recompile)."""
    return functools.partial(step, cfg=cfg)


# ---------------------------------------------------------------------------
# host-side world surgery (RigidBodyVec::add_body, physics.rs:200-218;
# Pool::push/remove, pool.rs:81-113).  Every function returns new tensors:
# the caller's world stays as it was.
# ---------------------------------------------------------------------------

def extend_world(world: World, new_bodies) -> World:
    """Append bodies to a world between steps (the body count changes; the
    warm and broadphase caches are left as they are).  Prefer
    :func:`with_capacity` + :func:`spawn_bodies`, which keep every shape."""
    dev = world.bodies.x.x.device
    cat = lambda a, b: torch.cat([a, torch.as_tensor(b).to(dev)], dim=0)
    return world._replace(bodies=tree_map(cat, world.bodies, new_bodies))


def remove_bodies(world: World, indices) -> World:
    """Remove bodies by index with compaction: surviving indices shift.
    Prefer :func:`kill_bodies` for stable indices (Pool::remove,
    pool.rs:100-113)."""
    keep = np.ones(world.bodies.n_bodies, bool)
    keep[np.asarray(indices, np.int64)] = False
    kidx = torch.as_tensor(np.nonzero(keep)[0],
                           device=world.bodies.x.x.device)
    take = lambda a: torch.index_select(a, 0, kidx)
    return world._replace(bodies=tree_map(take, world.bodies))


# ---------------------------------------------------------------------------
# capacity-padded worlds: O(1) add/remove that never change a shape (Pool
# semantics, pool.rs:37-113: stable indices, free-list reuse).  A dead row
# has shape_r <= 0: the grid builders skip it, the narrowphase cannot hit
# it, and it is parked far from any scene so the terrain culls drop it too.
# ---------------------------------------------------------------------------

def _dead_row_fields(rows):
    """The x position of dead body slots ``rows``: 1e5 + 100 * row, so
    no two dead rows share a place."""
    rows = np.asarray(rows, np.int64)
    return (1.0e5 + 100.0 * rows).astype(np.float32)


def _kill_rows(bodies: RigidBodyState, idx) -> RigidBodyState:
    """Rows ``idx`` marked dead: parked, at rest, massless, shape_r = -1."""
    idx_np = np.asarray(idx, np.int64)
    dev = bodies.x.x.device
    i = torch.as_tensor(idx_np, device=dev)

    def put(t, value):
        out = t.clone()
        out[i] = torch.as_tensor(value, dtype=t.dtype, device=dev)
        return out

    zero = lambda t: put(t, 0)
    return bodies._replace(
        x=Vec3(put(bodies.x.x, _dead_row_fields(idx_np)),
               put(bodies.x.y, 1.0e5), put(bodies.x.z, 1.0e5)),
        q=Quat(put(bodies.q.w, 1.0), zero(bodies.q.x), zero(bodies.q.y),
               zero(bodies.q.z)),
        v=tree_map(zero, bodies.v), omega=tree_map(zero, bodies.omega),
        force=tree_map(zero, bodies.force),
        torque=tree_map(zero, bodies.torque),
        delta=tree_map(zero, bodies.delta),
        restitution=zero(bodies.restitution),
        friction=zero(bodies.friction), inv_mass=zero(bodies.inv_mass),
        inv_moment_body=tree_map(zero, bodies.inv_moment_body),
        inv_moment=tree_map(zero, bodies.inv_moment),
        shape_type=zero(bodies.shape_type),
        shape_r=put(bodies.shape_r, -1.0),
        shape_half_h=zero(bodies.shape_half_h))


def _reset_warm(world: World) -> World:
    """Zero the warm-start state (slot surgery invalidates the row keys:
    a reused slot would warm a new body with a dead one's impulses)."""
    if world.warm is None:
        return world
    w = world.warm
    return world._replace(warm=SolverWarm(
        partner=torch.full_like(w.partner, -9),
        key2=torch.full_like(w.key2, -9),
        acc_n=torch.zeros_like(w.acc_n), acc_t1=torch.zeros_like(w.acc_t1),
        acc_t2=torch.zeros_like(w.acc_t2)))


def with_capacity(world: World, capacity: int) -> World:
    """Pad the body store with dead rows to a fixed ``capacity``, so that
    :func:`spawn_bodies` / :func:`kill_bodies` are mask edits that never
    change a shape.  Call it before ``init_warm`` (the caches are shaped
    by the body count)."""
    n = world.bodies.n_bodies
    if capacity < n:
        raise ValueError(f"capacity {capacity} < current bodies {n}")
    pad = capacity - n
    if pad == 0:
        return world
    bodies = tree_map(lambda g: torch.cat(
        [g, torch.zeros((pad,) + g.shape[1:], dtype=g.dtype,
                        device=g.device)], dim=0), world.bodies)
    bodies = _kill_rows(bodies, np.arange(n, capacity))
    if world.warm is not None:
        raise ValueError("call with_capacity BEFORE init_warm")
    return world._replace(bodies=bodies)


def free_slots(world: World):
    """Host-side indices (numpy) of the dead, spawnable rows."""
    return np.nonzero(world.bodies.shape_r.cpu().numpy() <= 0.0)[0]


def spawn_bodies(world: World, new_bodies: RigidBodyState):
    """Insert bodies into the first free slots (Pool::push, pool.rs:81-96:
    freed slots are reused; indices are stable).  Returns (world, the slot
    indices as a numpy array).  Resets the warm-start state."""
    free = free_slots(world)
    n_new = new_bodies.n_bodies
    if len(free) < n_new:
        raise ValueError(
            f"world has {len(free)} free slots, need {n_new} — "
            "re-create with a larger with_capacity")
    dev = world.bodies.x.x.device
    idx = torch.as_tensor(free[:n_new], device=dev)

    def put(dst, src):
        out = dst.clone()
        out[idx] = torch.as_tensor(src).to(device=dev, dtype=dst.dtype)
        return out

    merged = tree_map(put, world.bodies, new_bodies)
    return _reset_warm(world._replace(bodies=merged)), np.asarray(
        free[:n_new])


def kill_bodies(world: World, indices) -> World:
    """Remove bodies by marking their slots dead (Pool::remove,
    pool.rs:100-113): surviving indices are stable and nothing changes
    shape.  Resets the warm-start state."""
    return _reset_warm(world._replace(
        bodies=_kill_rows(world.bodies, indices)))


def num_alive(world: World) -> int:
    """The number of live bodies (Pool::len), read on the host."""
    return int(torch.sum(world.bodies.shape_r > 0.0))
