"""The level schedule of the sequential Gauss-Seidel solve
(``ops.sequential_solve.sequential_schedule``) and the level plain version
(``sequential_solve_levels_reference``), held on the CPU against the serial
plain version ``sequential_solve_reference``, the oracle: one valid point
at a time in list order, every body row written.

Two updates that share no dynamic body commute exactly, and a static row
(inverse mass and inverse inertia 0) never changes, so solving the levels
in turn must give the serial result BIT FOR BIT: every comparison here is
``torch.equal`` and, where no static row starts at -0, equality of the
int32 views (the sign of every zero too).  No tolerance.

The lists: random ones made with numpy from a seed at the card tests'
shapes (points, bodies), a chain on one dynamic body (depth = the valid
points), a list with no shared body (depth 1), one whose every partner is
the static row (depth 1; the static row unchanged), an all-invalid list,
and the constraint list of the 126-body ``balls_scene(5)`` landing step,
built by the port on the CPU.  Each in both friction modes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mgf_tpu_torch.ops import sequential_solve as seq  # noqa: E402

SWEEPS = 3


def _bodies(M, rng):
    """(M, 16) body rows: random v and omega, inverse mass in [0.5, 1.5],
    a random SPD inverse inertia; the last row static (+0 everywhere)."""
    q = np.linalg.qr(rng.standard_normal((M, 3, 3)))[0]
    inertia = np.einsum("mij,mj,mkj->mik", q, rng.uniform(0.5, 2.0, (M, 3)),
                        q).reshape(M, 9)
    bodies = np.concatenate([rng.standard_normal((M, 6)),
                             rng.uniform(0.5, 1.5, (M, 1)), inertia], axis=1)
    bodies[-1] = 0.0
    return bodies


def _points(C, rng):
    """(C, 20) point rows with unit normals and tangents."""
    n = rng.standard_normal((C, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t1 = np.cross(n, [1.0, 0.1, -0.2])
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(n, t1)
    return np.concatenate([rng.standard_normal((C, 6)) * 0.4, n, t1, t2,
                           rng.uniform(0.3, 0.8, (C, 1)),
                           rng.uniform(0.0, 1.0, (C, 1)),
                           rng.uniform(0.2, 0.6, (C, 3))], axis=1)


def _tensors(pts, a, b, valid, bodies):
    t = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x).astype(dt))
    return dict(pts=t(pts, np.float32), a=t(a, np.int32), b=t(b, np.int32),
                valid=t(valid, np.bool_), bodies=t(bodies, np.float32))


def random_list(C, M, seed=0):
    """As tests/test_torch_ops_cuda.py's card lists: C points over M bodies
    (the last static), every seventh invalid, a != b."""
    rng = np.random.default_rng(seed)
    pts = _points(C, rng)
    a = rng.integers(0, M - 1, C)
    b = (a + rng.integers(1, M, C)) % M
    return _tensors(pts, a, b, np.arange(C) % 7 != 3, _bodies(M, rng))


def chain_list(C=160, M=40, seed=1):
    """Every point on dynamic body 0 (a or b by turns), partners random,
    the static row among them: the depth is the number of valid points."""
    rng = np.random.default_rng(seed)
    other = rng.integers(1, M, C)
    a = np.where(np.arange(C) % 2 == 0, 0, other)
    b = np.where(np.arange(C) % 2 == 0, other, 0)
    return _tensors(_points(C, rng), a, b, np.arange(C) % 5 != 2,
                    _bodies(M, rng))


def disjoint_list(C=300, seed=2):
    """Point k on bodies 2k and 2k + 1: no body shared, depth 1."""
    rng = np.random.default_rng(seed)
    a = 2 * np.arange(C)
    return _tensors(_points(C, rng), a, a + 1, np.ones(C, bool),
                    _bodies(2 * C + 1, rng))


def static_partner_list(C=300, seed=3):
    """Point k on dynamic body k, its partner the static row (a or b by
    turns): depth 1, and the static row must come out as it went in."""
    rng = np.random.default_rng(seed)
    k, static = np.arange(C), np.full(C, C)
    a = np.where(k % 2 == 0, k, static)
    b = np.where(k % 2 == 0, static, k)
    return _tensors(_points(C, rng), a, b, np.ones(C, bool),
                    _bodies(C + 1, rng))


def invalid_list(C=500, M=60, seed=4):
    out = random_list(C, M, seed)
    out["valid"] = torch.zeros_like(out["valid"])
    return out


@pytest.fixture(scope="module")
def landing():
    """The constraint list of one sequential step at the 126-body
    balls_scene(5) landing: the port steps the demo 141 steps on the
    parallel flat solver on the CPU (the block hits the floor), then one
    sequential step records its solve's inputs (the world's static terrain
    row among the bodies)."""
    from mgf_tpu_torch import world as tworld
    from mgf_tpu_torch.scenes import balls_scene

    world, cfg = balls_scene(5, device="cpu")
    par = cfg._replace(solver="parallel")
    for _ in range(141):
        world, _ = tworld.step(world, par)
    rec = seq.capture_inputs(
        lambda: tworld.step(world, cfg._replace(solver="sequential")))[0]
    return dict(pts=rec["pts"], a=rec["a"], b=rec["b"], valid=rec["valid"],
                bodies=rec["bodies"], iters=rec["iters"])


LISTS = {
    "random_1000x50": lambda: random_list(1000, 50),
    "random_257x9": lambda: random_list(257, 9),
    "random_1x2": lambda: random_list(1, 2),
    "random_9000x3000": lambda: random_list(9000, 3000),
    "random_600x6000": lambda: random_list(600, 6000),
    "chain": chain_list,
    "disjoint": disjoint_list,
    "static_partner": static_partner_list,
    "all_invalid": invalid_list,
}


def _solve(fn, inp, iters, mgf):
    return fn(inp["pts"], inp["a"], inp["b"], inp["valid"], inp["bodies"],
              iters, mgf)


def _bit_equal(x, y):
    return torch.equal(x, y) and torch.equal(x.view(torch.int32),
                                             y.view(torch.int32))


def _levels_vs_serial(inp, iters, mgf):
    serial = _solve(seq.sequential_solve_reference, inp, iters, mgf)
    levels = _solve(seq.sequential_solve_levels_reference, inp, iters, mgf)
    assert levels.shape == serial.shape == (inp["bodies"].shape[0], 6)
    # no static row of these lists starts at -0, so the int32 views too
    assert not (seq.static_rows(inp["bodies"])[:, None]
                & (inp["bodies"][:, :6].view(torch.int32)
                   == torch.tensor(-0.0).view(torch.int32))).any()
    assert _bit_equal(levels, serial), \
        float((levels - serial).abs().max())
    # the static rows come out as they went in
    static = seq.static_rows(inp["bodies"])
    assert _bit_equal(levels[static], inp["bodies"][static, :6])
    return levels


@pytest.mark.parametrize("mgf", [False, True], ids=["textbook", "mgf"])
@pytest.mark.parametrize("name", list(LISTS))
def test_levels_equal_serial(name, mgf):
    inp = LISTS[name]()
    out = _levels_vs_serial(inp, SWEEPS, mgf)
    if int(inp["valid"].sum()) > 10:        # the solve moved the bodies
        assert float((out - inp["bodies"][:, :6]).abs().max()) > 1e-3
    elif not inp["valid"].any():
        assert _bit_equal(out, inp["bodies"][:, :6])


@pytest.mark.parametrize("mgf", [False, True], ids=["textbook", "mgf"])
def test_landing_levels_equal_serial(landing, mgf):
    """The demo's own list: 20 sweeps as the step runs them."""
    n_valid = int(landing["valid"].sum())
    assert 50 < n_valid < landing["valid"].numel()
    assert int(seq.static_rows(landing["bodies"]).sum()) >= 1
    out = _levels_vs_serial(landing, landing["iters"], mgf)
    # the solve moved the landing bodies
    assert float((out[:, :3] - landing["bodies"][:, :3]).abs().max()) > 0.1


def _check_schedule(inp, level):
    """The rule's invariants, from each dynamic body's points in list
    order: levels strictly increase along every body, no level holds two
    points of one body, and each level is the least the rule allows (1 +
    the last level on either dynamic body)."""
    valid = inp["valid"]
    static = seq.static_rows(inp["bodies"]).tolist()
    assert torch.equal(level[~valid], torch.zeros_like(level[~valid]))
    last, seen = {}, set()
    for i in torch.nonzero(valid).flatten().tolist():
        lv = int(level[i])
        dyn = {x for x in (int(inp["a"][i]), int(inp["b"][i]))
               if not static[x]}
        assert lv == 1 + max([last.get(x, 0) for x in dyn], default=0)
        for x in dyn:
            assert (x, lv) not in seen
            seen.add((x, lv))
            last[x] = lv
    return last


@pytest.mark.parametrize("name", list(LISTS) + ["landing"])
def test_schedule_invariants(name, request):
    inp = (request.getfixturevalue("landing") if name == "landing"
           else LISTS[name]())
    level = seq.sequential_schedule(inp["a"], inp["b"], inp["valid"],
                                    inp["bodies"])
    assert level.shape == inp["valid"].shape and level.dtype == torch.int64
    _check_schedule(inp, level)
    n_valid, depth = int(inp["valid"].sum()), int(level.max())
    expect = {"chain": n_valid, "disjoint": 1, "static_partner": 1,
              "all_invalid": 0}
    if name in expect:
        assert depth == expect[name]
    # the pipelined schedule: the rule run on over the sweeps, its depth
    # between one sweep's and the sweeps' sum
    piped = int(seq.sequential_schedule(inp["a"], inp["b"], inp["valid"],
                                        inp["bodies"], sweeps=SWEEPS).max())
    assert depth <= piped <= SWEEPS * depth
    if name in ("chain", "disjoint", "static_partner"):
        assert piped == SWEEPS * depth


def test_cpu_solve_runs_the_level_version(monkeypatch):
    """sequential_solve on CPU tensors runs the level plain version (and
    launches nothing)."""
    inp = random_list(257, 9)
    calls = []
    levels = seq.sequential_solve_levels_reference

    def record(*args):
        calls.append(args)
        return levels(*args)

    monkeypatch.setattr(seq, "sequential_solve_levels_reference", record)
    before = seq.LAUNCHES
    out = _solve(seq.sequential_solve, inp, SWEEPS, False)
    assert len(calls) == 1 and seq.LAUNCHES == before
    assert _bit_equal(out, _solve(seq.sequential_solve_reference, inp,
                                  SWEEPS, False))
