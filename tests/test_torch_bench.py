"""bench_torch.py (the port's benchmark harness) against bench.py and
mgf_tpu on the same inputs, on the CPU at small sizes: a 1,200-body,
2-layer stress pile, 64 OBB pairs, 256 compound parts, 256 rays.

Importing ``bench`` points JAX's persistent compilation cache at the
repository's ``.jax_cache/`` (bench.py:25-32), which .gitignore lists.
bench.py's ``_time_op`` is replaced here by one that records its argument
sets, so bench.py's draws can be read without timing them.

Tolerances and their reasons:

* the GJK, compound and ray inputs: bit for bit (the same numpy draws and
  float32 roundings);
* ``time_steps`` against bench.py's on the same state and schedule, the
  nonces included: contacts within 1 % and the max penetration within
  0.01 (test_torch_world.py's multi-step guards), positions within
  test_torch_world.py's two-tier trajectory band (max 0.02, at most 1 %
  of them past 5e-3, median 1e-3): row sums in another order than XLA's
  compound over the steps;
* the p99 penetration of one ``collect_contacts`` step on one state:
  1e-6 (the narrowphase runs before any solve);
* the ray grid's overflow and the grid/dense mismatches: exact.
"""

import functools
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import bench  # noqa: E402
import bench_torch  # noqa: E402
from mgf_tpu.scenes import stress_scene as j_stress_scene  # noqa: E402
from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402
from mgf_tpu_torch.compound import compound_from_parts  # noqa: E402
from mgf_tpu_torch.ops import _build  # noqa: E402
from mgf_tpu_torch.world import WorldConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N_BODIES, LAYERS = 1200, 2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_port(jw):
    return world_from_numpy(_np_tree(jw), CPU)


def _pos(x):
    return np.stack([np.asarray(c) for c in x], -1)


@pytest.fixture
def recorded(monkeypatch):
    """bench.py's argument sets, recorded in place of timing them."""
    sets = []

    def record(f, argsets):
        sets.append(argsets)
        return 1.0
    monkeypatch.setattr(bench, "_time_op", record)
    return sets


@pytest.fixture(scope="module")
def piles():
    """mgf_tpu's pile through bench.time_steps: per-step mode from the
    scene (36 + 4 steps: the bottom layer lands at ~33), then chunk mode
    (chunk 4, 8 + 2 x 8 steps) from there; each with the port's run of
    the same schedule from the same state."""
    jw0, cfg = j_stress_scene(N_BODIES, layers=LAYERS)
    tcfg = WorldConfig(*cfg)
    runs = {}
    for mode, kw in (("per_step", dict(warmup=36, iters=4)),
                     ("chunk", dict(warmup=8, iters=8, windows=2,
                                    chunk=4))):
        tw0 = _to_port(jw0)
        _, _, jw, jm = bench.time_steps(jw0, cfg, **kw)
        _, _, tw, tm = bench_torch.time_steps(tw0, tcfg, **kw)
        runs[mode] = (jw0, (jw, _np_tree(jm)), (tw, world_to_numpy(tm)))
        jw0 = jw
    return cfg, tcfg, runs


def test_gjk_draws_match_bench(recorded):
    n, iters = 64, 3
    bench.bench_gjk_batch(n=n, iters=iters)
    (argsets,) = recorded
    rng = np.random.default_rng(0)
    for i, (ja, jb) in enumerate(argsets):
        arrays = bench_torch.bench_obb_arrays(n, rng, 1e-5 * i)
        for jbox, (c, q, r) in zip((ja, jb), arrays):
            for mine, theirs in ((c, jbox.c), (q, jbox.q), (r, jbox.r)):
                np.testing.assert_array_equal(mine, _pos(theirs))
    first = bench_torch.bench_obb_arrays(n)
    for a, b in zip(first, bench_torch.bench_obb_arrays(
            n, np.random.default_rng(0), 0.0)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_compound_draws_match_bench(recorded):
    parts, iters = 256, 3
    bench.bench_compound_batch(parts=parts, iters=iters)
    (argsets,) = recorded
    comp = compound_from_parts(bench_torch.bench_compound_parts(parts),
                               device=CPU)
    jcomp = _np_tree(argsets[0][0])
    for a, b in zip(jax.tree_util.tree_leaves(jcomp),
                    jax.tree_util.tree_leaves(_np_tree(world_to_numpy(
                        comp)))):
        np.testing.assert_array_equal(a, b)
    for i, (_, jv) in enumerate(argsets):
        np.testing.assert_array_equal(
            _pos(_np_tree(jv)),
            np.asarray([0.0, -3.0 - 1e-5 * i, 0.0], np.float32))


def test_ray_draws_and_counts_match_bench(recorded, piles):
    rays, iters = 256, 2
    _, _, runs = piles
    jw, _ = runs["chunk"][1]
    _, _, j_ovf, j_mism = bench.bench_raytrace(jw, rays=rays, iters=iters)
    argsets = recorded[0]
    tw = _to_port(jw)
    for (jp, jd), (p, d) in zip(argsets,
                                bench_torch.bench_rays(tw.bodies, rays,
                                                       iters)):
        np.testing.assert_array_equal(_pos(_np_tree(jp)), _pos(p))
        np.testing.assert_array_equal(_pos(_np_tree(jd)), _pos(d))
    _, _, ovf, mism = bench_torch.bench_raytrace(tw, rays=rays, iters=iters)
    assert (ovf, mism) == (j_ovf, j_mism)


@pytest.mark.parametrize("mode", ["per_step", "chunk"])
def test_time_steps_matches_bench(piles, mode):
    _, _, runs = piles
    _, (jw, jm), (tw, tm) = runs[mode]
    nj, nt = int(jm["num_contacts"]), int(tm["num_contacts"])
    assert nj > 0 and abs(nj - nt) <= 0.01 * nj, (nj, nt)
    assert abs(float(jm["max_penetration"])
               - float(tm["max_penetration"])) <= 0.01
    for m in (jm, tm):
        assert int(m["broadphase_overflow"]) == 0
    d = np.abs(_pos(_np_tree(jw.bodies.x)) - _pos(tw.bodies.x))
    assert d.max() < 0.02, d.max()
    assert (d > 5e-3).mean() < 0.01, (d > 5e-3).mean()
    assert np.median(d) < 1e-3, np.median(d)
    assert len(bench_torch.time_steps.last_rates) >= 1


def test_penetration_p99_matches_bench(piles):
    cfg, tcfg, runs = piles
    jw, _ = runs["chunk"][1]
    j_p99 = bench._penetration_p99(jw, cfg)
    t_p99 = bench_torch._penetration_p99(_to_port(jw), tcfg)
    assert j_p99 > 0.0
    assert abs(j_p99 - t_p99) <= 1e-6, (j_p99, t_p99)


def _bench_r05_keys():
    with open(os.path.join(ROOT, "BENCH_r05.json")) as fh:
        tail = json.load(fh)["tail"]
    dicts = [json.loads(line) for line in tail.splitlines()
             if line.startswith("{")]
    return set(dicts[0]), set(dicts[1])


def test_main_prints_bench_r05_keys(monkeypatch, capsys):
    """Every row of main() at tiny sizes: the secondary dict on stderr has
    exactly BENCH_r05.json's keys and the port's two graph keys, the
    headline is the last stdout line
    with ``vs_baseline`` null, the device line comes first."""
    monkeypatch.setattr(bench_torch, "SCHEDULE", dict(
        balls=(2, 2, 1, 0), capsules=(2, 2, 1, 0), terrain=(2, 2, 1, 0),
        cold20=(2, 2, 1, 0), mixed=(4, 4, 2, 2), stress=(8, 4, 2, 4)))
    monkeypatch.setattr(bench_torch, "N_TERRAIN", 300)
    monkeypatch.setattr(bench_torch, "STRESS_EAGER_STEPS", 4)
    monkeypatch.setattr(bench_torch, "N_GJK_PAIRS", 16)
    monkeypatch.setattr(bench_torch, "N_COMPOUND_PARTS", 64)
    monkeypatch.setattr(bench_torch, "N_RAYS", 64)
    for name in ("bench_gjk_batch", "bench_raytrace"):
        monkeypatch.setattr(bench_torch, name, functools.partial(
            getattr(bench_torch, name), iters=2))
    assert bench_torch.main(["--device", "cpu", "--bodies", "600"]) == 0
    out, err = capsys.readouterr()
    out, err = out.strip().splitlines(), err.strip().splitlines()
    secondary, headline = json.loads(err[-1]), json.loads(out[-1])
    sec_keys, head_keys = _bench_r05_keys()
    # BENCH_r05.json's keys and the two of the port's graph replays
    assert set(secondary) == sec_keys | {"stress_captured",
                                         "stress_eager_steps_per_sec"}
    # on the CPU the chunks run eagerly: no graph
    assert secondary["stress_captured"] is False
    assert secondary["stress_eager_steps_per_sec"] > 0.0
    assert head_keys <= set(headline) and headline["vs_baseline"] is None
    assert headline["metric"] == ("physics steps/sec at 600 spheres "
                                  "(stress scene)")
    assert out[0] == "cpu"
    assert err[-2].startswith("launches by row ")
    launches = json.loads(err[-2][len("launches by row "):])
    assert set(launches) == {"balls", "capsules", "terrain", "gjk",
                             "compound", "cold20", "mixed", "stress",
                             "stress_rebuild_cycle", "raytrace"}
    # on the CPU the wrappers run their plain versions: no launch
    assert all(v == 0 for row in launches.values() for v in row.values())
    assert (secondary["stress_broadphase_overflow"],
            secondary["raytrace_grid_overflow"],
            secondary["raytrace_grid_mismatch"]) == (0, 0, 0)


def test_cold_cache_builds_into_a_fresh_directory(monkeypatch, capsys):
    """--cold-cache points the kernel build at a fresh temporary directory
    for the run and restores the build directory after it."""
    before = _build.build_dir()
    seen = []

    def fake_run(args, dev):
        seen.append((_build.build_dir(), _build._library_path(
            "solver_sweep").parent))
        return {}, {}, {}
    monkeypatch.setattr(bench_torch, "run", fake_run)
    assert bench_torch.main(["--cold-cache", "--device", "cpu"]) == 0
    (during, lib_dir), = seen
    assert during == lib_dir != before
    assert str(during).startswith(tempfile.gettempdir())
    assert not during.exists()
    assert _build.build_dir() == before
    capsys.readouterr()


def test_cuda_device_without_a_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench_torch.main([])
    assert exc.value.code not in (0, None)
