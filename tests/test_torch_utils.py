"""The port's utils (mgf_tpu_torch.utils) against mgf_tpu.utils:
tests/test_utils.py's three tests replayed on both packages, the
checkpoint file read across the packages both ways, the debug mode's
non-finite check, and StepTimer on the CPU."""

import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mgf_tpu import utils as jutils  # noqa: E402
from mgf_tpu.scenes import stress_scene as j_stress_scene  # noqa: E402
from mgf_tpu.utils import slots as jslots  # noqa: E402

from mgf_tpu_torch import utils as tutils  # noqa: E402
from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402
from mgf_tpu_torch.math3d import Vec3  # noqa: E402
from mgf_tpu_torch.utils import slots as tslots  # noqa: E402

CPU = "cpu"


def test_utils_exports_match():
    public = lambda m: sorted(n for n in dir(m) if not n.startswith("_")
                              and n not in ("annotations",))
    assert (set(public(jutils)) - {"checkpoint", "metrics", "slots"}
            == set(public(tutils)) - {"checkpoint", "metrics", "slots"})


def _slot_script(mod, arr, f32):
    """tests/test_utils.py::test_slot_table_insert_remove's sequence;
    returns the (valid, values) after every operation and the overflow."""
    t = mod.SlotTable(values=arr(np.zeros((4,), np.float32)),
                      valid=arr(np.zeros((4,), bool)))
    out = []
    snap = lambda t: out.append((np.asarray(t.valid).tolist(),
                                 np.asarray(t.values).tolist()))
    for v in (1.0, 2.0, 3.0):
        t = mod.slot_insert(t, f32(v))
        snap(t)
    t = mod.slot_remove(t, 1)
    snap(t)
    for v in (9.0, 5.0, 6.0):
        t = mod.slot_insert(t, f32(v))
        snap(t)
    return out, int(mod.slot_overflow(t, wanted=6))


def test_slot_table_insert_remove():
    """Pool semantics (pool.rs:81-113): freed slots are reused, other
    indices are stable, inserts into a full table are dropped and
    counted; every intermediate table equals mgf_tpu's."""
    j_out, j_over = _slot_script(jslots, jnp.asarray, jnp.float32)
    t_out, t_over = _slot_script(
        tslots, torch.as_tensor,
        lambda v: torch.tensor(v, dtype=torch.float32))
    assert t_out == j_out and t_over == j_over == 2
    assert t_out[2][0] == [True, True, True, False]
    assert t_out[3][0] == [True, False, True, False]
    assert t_out[4] == ([True, True, True, False], [1.0, 9.0, 3.0, 0.0])


def test_slot_table_tree_values_and_enable():
    """values as a NamedTuple tree with a trailing axis, and a disabled
    insert, as JAX's tree_map does them."""
    from mgf_tpu.math3d import Vec3 as JVec3
    res = []
    for mod, vec, arr in ((jslots, JVec3, jnp.asarray),
                          (tslots, Vec3, torch.as_tensor)):
        z = np.zeros((3, 2), np.float32)
        t = mod.slot_table(vec(arr(z), arr(z), arr(z)),
                           arr(np.zeros((3, 2), bool)))
        t = mod.slot_insert(t, vec(arr(np.float32(1.0)),
                                   arr(np.float32(2.0)),
                                   arr(np.float32(3.0))))
        t = mod.slot_insert(t, vec(arr(np.float32(4.0)),
                                   arr(np.float32(5.0)),
                                   arr(np.float32(6.0))),
                            enable=arr(np.asarray([True, False])))
        res.append([np.asarray(x).tolist() for x in (t.valid, *t.values)])
    assert res[0] == res[1]
    assert res[1][0] == [[True, True], [True, False], [False, False]]


def test_metrics_log():
    for mod, mk in ((jutils, lambda a, b: {"a": jnp.float32(a),
                                           "b": jnp.int32(b)}),
                    (tutils, lambda a, b: {
                        "a": torch.tensor(a, dtype=torch.float32),
                        "b": torch.tensor(b, dtype=torch.int32)})):
        log = mod.MetricsLog()
        log.append(mk(1.0, 2))
        log.append(mk(3.0, 4))
        s = log.summary()
        assert s["a"] == 2.0 and s["b"] == 3.0
        assert type(log.rows[0]["b"]) is int


def test_debug_validate_world():
    """tests/test_utils.py::test_debug_validate_world on the port, with
    each check's verdict equal to mgf_tpu's on the same world."""
    from mgf_tpu.physics import SceneBuilder as JBuilder
    from mgf_tpu.scenes import balls_scene as j_balls_scene
    from mgf_tpu.utils.debug import check_step_metrics as j_check
    from mgf_tpu.utils.debug import validate_world as j_validate
    from mgf_tpu.world import extend_world as j_extend
    from mgf_tpu.world import init_warm as j_init_warm
    from mgf_tpu.world import make_step_fn as j_make_step_fn
    from mgf_tpu_torch.physics import SceneBuilder
    from mgf_tpu_torch.scenes import balls_scene
    from mgf_tpu_torch.utils.debug import check_step_metrics, validate_world
    from mgf_tpu_torch.world import extend_world, init_warm, make_step_fn

    jw, jcfg = j_balls_scene(num=3, with_dropped=False)
    w, cfg = balls_scene(num=3, with_dropped=False, device=CPU)
    assert tuple(cfg) == tuple(jcfg)
    validate_world(w, cfg)                      # clean world passes
    w2, m = make_step_fn(cfg)(w)
    validate_world(w2, cfg)
    check_step_metrics(m)                       # healthy step passes
    jw2, jm = j_make_step_fn(jcfg)(jw)
    j_validate(jw2, jcfg)
    j_check(jm)
    np.testing.assert_allclose(w2.bodies.x.y.numpy(),
                               np.asarray(jw2.bodies.x.y), atol=1e-6)

    def raises(fn, *args, match):
        with pytest.raises(ValueError, match=match) as e:
            fn(*args)
        return str(e.value)

    # a corrupted position: the same message in both packages
    bad = w._replace(bodies=w.bodies._replace(x=w.bodies.x._replace(
        y=w.bodies.x.y.clone().index_fill_(0, torch.tensor([0]),
                                           float("nan")))))
    jbad = jw._replace(bodies=jw.bodies._replace(
        x=jw.bodies.x._replace(y=jw.bodies.x.y.at[0].set(jnp.nan))))
    assert (raises(validate_world, bad, cfg, match="non-finite")
            == raises(j_validate, jbad, jcfg, match="non-finite"))

    # stale warm state after a body-count change
    wcfg = cfg._replace(warm_start=True)
    b = SceneBuilder()
    b.add_sphere((50.0, 0.0, 0.0), 0.5, 1.0, 0.0, 0.5)
    grown = extend_world(init_warm(w, wcfg), b.build(CPU))
    jb = JBuilder()
    jb.add_sphere((50.0, 0.0, 0.0), 0.5, 1.0, 0.0, 0.5)
    jgrown = j_extend(j_init_warm(jw, jcfg._replace(warm_start=True)),
                      jb.build())
    assert (raises(validate_world, grown, wcfg, match="init_warm")
            == raises(j_validate, jgrown, jcfg._replace(warm_start=True),
                      match="init_warm"))

    # degraded metrics
    m_bad = dict(m)
    m_bad["broadphase_overflow"] = torch.tensor(7, dtype=torch.int32)
    jm_bad = dict(jm)
    jm_bad["broadphase_overflow"] = jnp.int32(7)
    assert (raises(check_step_metrics, m_bad, match="overflow")
            == raises(j_check, jm_bad, match="overflow"))


@pytest.fixture(scope="module")
def pile_pair():
    """mgf_tpu's stress_scene(200) (warm and broadphase caches attached)
    after 3 steps, and the same state in the port."""
    from mgf_tpu.world import step as j_step
    jw, cfg = j_stress_scene(200)
    f = jax.jit(functools.partial(j_step, cfg=cfg._replace(
        pallas_solver=False)))
    for _ in range(3):
        jw, _ = f(jw)
    return jw, world_from_numpy(jax.tree_util.tree_map(np.asarray, jw), CPU)


def _assert_leaves_equal(a, b):
    la = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, a))
    lb = jax.tree_util.tree_leaves(world_to_numpy(b))
    assert len(la) == len(lb) > 40
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_checkpoint_round_trip_both_ways(pile_pair, tmp_path):
    """save_world / load_world: the port reads mgf_tpu's file and mgf_tpu
    reads the port's, every leaf bit-equal with its dtype (bool, int32,
    float32); the keys are the JAX field paths; None fields have none."""
    jw, tw = pile_pair
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port")
    jutils.save_world(pj, jw)
    tutils.save_world(pt, tw)                  # .npz appended, as numpy
    keys_j = set(np.load(pj).files)
    keys_t = set(np.load(pt + ".npz").files)
    assert keys_j == keys_t
    assert {"bodies/x/x", "bp/count", "warm/acc_n",
            "terrain_center/x"} <= keys_t
    assert not any(k.startswith("terrain_grid") for k in keys_t)
    assert np.load(pt + ".npz")["bp/ok"].dtype == bool
    # the port reads mgf_tpu's file, and its own
    _assert_leaves_equal(jw, tutils.load_world(pj, tw))
    _assert_leaves_equal(jw, tutils.load_world(pt, tw))
    # mgf_tpu reads the port's file
    back = jutils.load_world(pt + ".npz", jw)
    _assert_leaves_equal(back, tw)
    with pytest.raises(ValueError, match="orbax"):
        tutils.save_world(str(tmp_path / "x"), tw, use_orbax=True)


def test_debug_mode_raises_on_non_finite(pile_pair):
    """With the debug mode on, a NaN entering the step surfaces as a
    FloatingPointError naming the state field; off, the step runs."""
    from mgf_tpu_torch.utils.debug import (disable_debug_mode,
                                           enable_debug_mode)
    from mgf_tpu_torch.world import WorldConfig, step
    from mgf_tpu_torch import world as tworld
    _, tw = pile_pair
    cfg = WorldConfig(*j_stress_scene(200)[1])._replace(adapt_schedule=None)
    v = tw.bodies.v
    bad = tw._replace(bodies=tw.bodies._replace(v=v._replace(
        x=v.x.clone().index_fill_(0, torch.tensor([7]), float("nan")))))
    w_ok, _ = step(bad, cfg)                    # off: no check
    assert not bool(torch.isfinite(w_ok.bodies.v.x).all())
    enable_debug_mode()
    try:
        assert tworld.DEBUG_NANS
        step(tw, cfg)                           # a healthy step passes
        with pytest.raises(FloatingPointError, match=r"bodies/v/x"):
            step(bad, cfg)
    finally:
        disable_debug_mode()
    assert not tworld.DEBUG_NANS


def test_step_timer_cpu(pile_pair, tmp_path):
    """StepTimer on the CPU: sync is a no-op for CPU tensors, the time per
    step is positive, and trace_dir writes a chrome trace."""
    from mgf_tpu_torch.world import WorldConfig, make_step_fn
    _, tw = pile_pair
    f = make_step_fn(WorldConfig(*j_stress_scene(200)[1])._replace(
        adapt_schedule=None))
    trace = str(tmp_path / "trace")
    with tutils.StepTimer(trace_dir=trace) as t:
        w = tw
        for _ in range(2):
            w, m = f(w)
        t.sync((w, m))
    assert t.ms_per_step(2) > 0.0
    with open(os.path.join(trace, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
