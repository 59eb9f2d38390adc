"""The port's spatially sharded (halo-exchange) step against mgf_tpu's, on
the same numpy worlds: mgf_tpu on conftest's virtual CPU devices, the port
on as many gloo ranks on the CPU (one thread each, spawned once per rank
count for the whole module).

Each test replays a test of tests/test_spatial.py with the port: its bars
hold the port's spatial step against the port's single-device step.
Beyond them the port is held to mgf_tpu's spatial step itself: exactly
the shard order, pads and boundaries, the halo and comm metrics of every
step, and (with a broadphase cache) each rank's halo membership and
step-1 candidate lists; per-row state within 1e-5 after one step and
within the JAX test's own tolerance (1e-4) after the last.
test_torch_spatial_drift.py replays the drift / re-shard test,
test_torch_spatial_stress.py and test_torch_spatial_cadence.py the
flagship configuration and its cache, test_torch_spatial_mixed.py the
mixed terrain pile.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from mgf_tpu.parallel import spatial as j_spatial  # noqa: E402
from mgf_tpu.scenes import balls_scene as j_balls_scene  # noqa: E402

from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402
from mgf_tpu_torch.broadphase import GridConfig  # noqa: E402
from mgf_tpu_torch.parallel import run_ranks, spatial  # noqa: E402
from mgf_tpu_torch.world import WorldConfig, step  # noqa: E402
import torch_rank_scenarios  # noqa: E402

STEP1_ATOL = 1e-5        # per-row x, v, omega after one step
FINAL_ATOL = 1e-4        # test_spatial.py's tolerance after 5-8 steps
EXACT_METRICS = ("halo_overflow", "spatial_stray", "comm_floats_per_step",
                 "broadphase_rebuilt", "broadphase_overflow")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_cfg(cfg):
    """A JAX WorldConfig as the port's (its GridConfigs too), so a rank
    process unpickles it without mgf_tpu."""
    grid = lambda g: None if g is None else GridConfig(*g)
    return WorldConfig(*cfg)._replace(grid=grid(cfg.grid),
                                      terrain_grid_cfg=grid(
                                          cfg.terrain_grid_cfg))


def port_world(j_world):
    """A JAX world as the port's types with numpy leaves."""
    return world_to_numpy(world_from_numpy(np_tree(j_world), "cpu"))


def cpu_mesh(n):
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"need {n} cpu devices")
    from jax.sharding import Mesh
    return Mesh(np.array(devs[:n]), ("b",))


def jax_spatial(spec, n_dev):
    """mgf_tpu's side of a spatial scenario of torch_rank_scenarios."""
    cfg, halo = spec["jcfg"], spec["halo"]
    mesh = cpu_mesh(n_dev)
    w, bounds = j_spatial.shard_world_spatial(
        spec["jworld"], mesh, cfg=cfg if cfg.warm_start else None)
    out = dict(bounds=bounds, shard0=np_tree(w.bodies), metrics=[],
               snaps={})
    make = lambda b: j_spatial.make_spatial_step(
        cfg, mesh, b, halo=halo, halo_width=spec.get("halo_width"))
    f = make(bounds)
    if cfg.bp_every > 1:
        w = j_spatial.init_spatial_bp_cache(w, mesh, cfg, halo=halo)
    for i in range(spec["steps"]):
        w, m = f(w)
        out["metrics"].append(np_tree(m))
        if i + 1 in spec.get("snaps", ()):
            out["snaps"][i + 1] = np_tree(dict(bodies=w.bodies, warm=w.warm,
                                               bp=w.bp))
        if spec.get("reshard") and int(m["spatial_stray"]) > 0:
            break
    if spec.get("reshard"):
        out["stray_step"] = len(out["metrics"])
        w, bounds = j_spatial.shard_world_spatial(w, mesh)
        out["bounds2"] = bounds
        f = make(bounds)
        for _ in range(spec["after"]):
            w, m = f(w)
            out["metrics"].append(np_tree(m))
    out["final"] = np_tree(dict(bodies=w.bodies, warm=w.warm, bp=w.bp))
    return out


def spatial_spec(j_world, j_cfg, **kw):
    """A scenario for both packages: the JAX world and config, and their
    port counterparts for the ranks."""
    return dict(kind="spatial", jworld=j_world, jcfg=j_cfg,
                world=port_world(j_world), cfg=port_cfg(j_cfg), **kw)


def run_port(specs, n_dev):
    """Every scenario on ``n_dev`` gloo CPU ranks; rank 0's results (the
    gathered snapshots and reduced metrics are the same on every rank)."""
    ship = [{k: v for k, v in s.items() if k not in ("jworld", "jcfg")}
            for s in specs]
    out = run_ranks(torch_rank_scenarios.run_specs, n_dev, "cpu", "gloo",
                    ship, timeout_s=300)
    for r in out[1:]:
        for a, b in zip(r, out[0]):
            for ma, mb in zip(a["metrics"], b["metrics"]):
                for k in ma:
                    np.testing.assert_array_equal(ma[k], mb[k])
    return out[0]


def body_rows(b):
    """x, v, omega of a bodies tree as one (N, 9) array."""
    return np.stack([np.asarray(c) for f in (b.x, b.v, b.omega)
                     for c in f], axis=-1)


def sorted_positions(b):
    """Positions sorted lexicographically, pad rows (x >= 9e4) dropped:
    the order-independent comparison of test_spatial.py."""
    arr = np.stack([np.asarray(c) for c in b.x], axis=-1)
    arr = arr[np.lexsort((arr[:, 2], arr[:, 1], arr[:, 0]))]
    return arr[arr[:, 0] < 9e4]


def hold_to_jax(j, t, final_atol=FINAL_ATOL, snap_atol=None):
    """The port's run of a scenario against mgf_tpu's: the exact streams
    and the stated tolerances.  ``snap_atol`` = (x, v and omega) holds
    every snapshot to those tolerances instead of step 1's 1e-5."""
    np.testing.assert_array_equal(t["bounds"], j["bounds"])
    lj = jax.tree_util.tree_leaves(j["shard0"])
    lt = jax.tree_util.tree_leaves(t["shard0"]["bodies"])
    assert len(lj) == len(lt) > 0
    for a, b in zip(lj, lt):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(t["metrics"]) == len(j["metrics"])
    for mj, mt in zip(j["metrics"], t["metrics"]):
        for k in EXACT_METRICS:
            assert int(mj[k]) == int(mt[k]), (k, mj[k], mt[k])
        assert int(mj["num_contacts"]) == int(mt["num_contacts"])
    if "stray_step" in j:
        assert t["stray_step"] == j["stray_step"]
        np.testing.assert_array_equal(t["bounds2"], j["bounds2"])
    for k, sj in j["snaps"].items():
        st = t["snaps"][k]
        rows_t, rows_j = body_rows(st["bodies"]), body_rows(sj["bodies"])
        if snap_atol is not None:
            np.testing.assert_allclose(rows_t[:, :3], rows_j[:, :3],
                                       atol=snap_atol[0], rtol=0)
            np.testing.assert_allclose(rows_t[:, 3:], rows_j[:, 3:],
                                       atol=snap_atol[1], rtol=0)
        elif k == 1:
            np.testing.assert_allclose(rows_t, rows_j, atol=STEP1_ATOL,
                                       rtol=0)
        hold_cache_and_warm(sj, st)
    np.testing.assert_allclose(body_rows(t["final"]["bodies"]),
                               body_rows(j["final"]["bodies"]),
                               atol=final_atol, rtol=0)
    hold_cache_and_warm(j["final"], t["final"])


def hold_cache_and_warm(sj, st):
    """Each rank's halo membership and candidate lists (the bp cache) and
    the warm rows' partner gids and keys, exactly; the cache's anchors,
    slacks and build radii within 1e-5."""
    if sj["bp"] is not None and np.asarray(sj["bp"].partner).ndim == 2:
        for f in ("partner", "ok", "overflow", "count", "sl_idx", "sl_ok",
                  "sr_idx", "sr_ok"):
            np.testing.assert_array_equal(getattr(st["bp"], f),
                                          np.asarray(getattr(sj["bp"], f)),
                                          err_msg=f)
        for f in ("anchor", "slack", "r_build"):
            for a, b in zip(jax.tree_util.tree_leaves(getattr(sj["bp"], f)),
                            jax.tree_util.tree_leaves(getattr(st["bp"], f))):
                np.testing.assert_allclose(b, np.asarray(a), atol=STEP1_ATOL,
                                           rtol=0)
    if sj["warm"] is not None and np.asarray(sj["warm"].partner).ndim == 2:
        for f in ("partner", "key2"):
            np.testing.assert_array_equal(getattr(st["warm"], f),
                                          np.asarray(getattr(sj["warm"], f)),
                                          err_msg=f)


def port_single(spec, steps):
    """The port's single-device run of a scenario's world (the reference
    of test_spatial.py's bars): (final world, last metrics)."""
    w = world_from_numpy(spec["world"], "cpu")
    cfg = spec["cfg"]
    if cfg.warm_start:
        from mgf_tpu_torch.world import init_warm
        w = init_warm(w, cfg)
    if cfg.bp_every > 1:
        from mgf_tpu_torch.world import init_bp_cache
        w = init_bp_cache(w, cfg)
    for _ in range(steps):
        w, m = step(w, cfg)
    return w, m


def _balls(num, dropped):
    world, cfg = j_balls_scene(num=num, with_dropped=dropped)
    return world, cfg._replace(two_phase=False)


@pytest.fixture(scope="module")
def runs():
    """Every scenario of this module on both packages."""
    w, c = _balls(4, True)
    spheres = spatial_spec(w, c, halo=32, steps=5, snaps=(1,))
    # the same scene with a cache (rebuilt on step 1), so that each rank's
    # halo membership and candidate lists are observable in both packages
    spheres_c = spatial_spec(w, c._replace(bp_every=2), halo=32, steps=1,
                             snaps=(1,))
    w, c = _balls(4, False)
    comm = spatial_spec(w, c, halo=4, steps=1)
    specs = dict(spheres=spheres, spheres_c=spheres_c, comm=comm)
    port = dict(zip(specs, run_port(list(specs.values()), 8)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jx = {k: jax_spatial(s, 8) for k, s in specs.items()}
    return specs, port, jx


def test_spatial_spheres_matches_single_device(runs):
    specs, port, jx = runs
    t = port["spheres"]
    ws, ms = port_single(specs["spheres"], 5)
    np.testing.assert_allclose(sorted_positions(t["final"]["bodies"]),
                               sorted_positions(world_to_numpy(ws.bodies)),
                               atol=1e-4)
    m = t["metrics"][-1]
    assert int(m["num_contacts"]) == int(ms["num_contacts"])
    assert int(m["spatial_stray"]) == 0 and int(m["halo_overflow"]) == 0
    hold_to_jax(jx["spheres"], t)


def test_spatial_spheres_halo_membership_and_candidates_match_jax(runs):
    """The cached form's step 1 exposes the halo membership and the local
    candidate lists of every rank: equal to mgf_tpu's."""
    _, port, jx = runs
    hold_to_jax(jx["spheres_c"], port["spheres_c"])
    bp = port["spheres_c"]["snaps"][1]["bp"]
    assert bp.sl_ok.sum() + bp.sr_ok.sum() > 0


def test_spatial_comm_scales_with_halo_not_n(runs):
    specs, port, jx = runs
    m = port["comm"]["metrics"][0]
    per_dev = int(m["comm_floats_per_step"]) // 8
    iters = specs["comm"]["cfg"].solver_iters
    # 2*H*16 shapes + 2*H counts + iters*2*H*8 state floats, H=4
    assert per_dev == 2 * 4 * 16 + 2 * 4 + iters * 2 * 4 * 8
    hold_to_jax(jx["comm"], port["comm"])


def test_spatial_cfg_field_coverage():
    """The port's registry is mgf_tpu's, covers the port's WorldConfig, and
    every flagged field warns or raises while the flagship config passes
    clean."""
    fields = set(WorldConfig._fields)
    assert spatial.HONORED_FIELDS == j_spatial.HONORED_FIELDS
    assert spatial.FLAGGED_FIELDS == j_spatial.FLAGGED_FIELDS
    assert fields == spatial.HONORED_FIELDS | spatial.FLAGGED_FIELDS
    assert not (spatial.HONORED_FIELDS & spatial.FLAGGED_FIELDS)
    base = WorldConfig(solver="rows")
    active = {"profile_stage": "pairs", "solver": "parallel",
              "bp_margin": 0.5, "pallas_narrowphase": True,
              "pallas_solver": True, "n_sphere_rows": 10, "use_grid": False}
    for field, value in active.items():
        cfg = base._replace(**{field: value})
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            try:
                spatial._check_cfg(cfg)
                flagged = len(rec) > 0
            except ValueError:
                flagged = True
        assert flagged, f"{field}={value} passed _check_cfg silently"
    from mgf_tpu_torch.scenes import stress_scene
    _, cfg = stress_scene(n_bodies=256, layers=3, device="cpu")
    cfg = cfg._replace(pallas_solver=False, n_sphere_rows=-1)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        spatial._check_cfg(cfg)
    assert not rec, [str(w.message) for w in rec]


def test_exchange_edges_receive_zeros():
    """ppermute semantics on 4 gloo ranks: each shift delivers the
    neighbour's rows, and a rank that receives from no one gets zeros
    (rank 0's left halo, rank 3's right halo), never a filled sentinel."""
    out = run_ranks(torch_rank_scenarios.exchange_edges, 4, "cpu", "gloo",
                    5, timeout_s=120)
    for r, o in enumerate(out):
        left = 0.0 if r == 0 else 10.0 * r
        right = 0.0 if r == 3 else float(r + 2)
        np.testing.assert_array_equal(o["from_left"], np.full((5, 16), left))
        np.testing.assert_array_equal(o["from_right"],
                                      np.full((5, 16), right))
        np.testing.assert_array_equal(o["right"], np.full((5, 16),
                                                          float(r)))
        np.testing.assert_array_equal(
            o["left"], np.full((5, 16), 0.0 if r == 3 else float(r + 2)))
        np.testing.assert_array_equal(o["gathered"][:, 0], [1, 2, 3, 4])
        assert float(o["psum"][0]) == 10.0 and float(o["pmax"][0]) == 4.0


def test_nccl_more_ranks_than_cards_raises_before_spawning():
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="one rank on each card"):
        run_ranks(torch_rank_scenarios.exchange_edges, cards + 1, "cuda",
                  "nccl", 1)
