"""What ``correct`` is decided by: each number against its limit, and a
number with no limit (or missing) never passing."""

import pytest

from physbench.harness import compare, manifest

CONF = manifest.config("stress_spheres_100k")
LIMITS = {"v_gap_median": 0.35, "v_gap_max": 20, "x_gap_max": "logged",
          "contact_rows_mismatch": 340, "momentum_gap": 0.044}
SOUND = dict(scene_mismatch=0, step_count_gap=0, v_gap_median=0.01,
             v_gap_max=2.0, x_gap_max=0.3, contact_rows_mismatch=2,
             momentum_gap=1e-5, overflow_max=0, drift_excess_max=0.0,
             pairs_missed_free_row=0, penetration_max=0.2, escaped=0,
             nonfinite=0, lower_precision_leaves=0)


def _judge(numbers, limits=LIMITS, complete=True):
    return compare.judge(numbers, limits, CONF, 100_000, complete=complete)


def test_a_sound_run_passes_and_a_logged_number_is_not_compared():
    ok, rows = _judge(dict(SOUND, x_gap_max=1e9))
    assert ok, rows
    assert "x_gap_max" not in {k for k, _, _ in rows}


@pytest.mark.parametrize("name, value", [
    ("overflow_max", 1), ("drift_excess_max", 1e-3),
    ("pairs_missed_free_row", 1), ("penetration_max", 0.6), ("escaped", 1),
    ("nonfinite", 3), ("lower_precision_leaves", 1), ("scene_mismatch", 1),
    ("step_count_gap", 64), ("v_gap_max", 21.0), ("momentum_gap", 0.5)])
def test_each_number_over_its_limit_fails(name, value):
    ok, rows = _judge(dict(SOUND, **{name: value}))
    assert not ok
    assert (name, value) in {(k, v) for k, v, _ in rows}


@pytest.mark.parametrize("name", ["overflow_max", "drift_excess_max",
                                  "pairs_missed_free_row", "v_gap_max"])
def test_a_missing_number_fails_a_complete_judgement(name):
    numbers = dict(SOUND)
    del numbers[name]
    assert not _judge(numbers)[0]
    assert _judge(numbers, complete=False)[0]


def test_a_followed_number_the_limits_file_does_not_name_fails():
    limits = dict(LIMITS)
    del limits["v_gap_max"]
    assert not _judge(SOUND, limits)[0]


def test_the_overflow_limit_is_the_stated_share_of_the_bodies():
    conf = dict(CONF, guarantees=dict(CONF["guarantees"],
                                      bucket_overflow_max_share=0.0005))
    lim = compare.guarantee_limits(conf, 100_000)
    assert lim["overflow_max"] == 50
    assert compare.judge(dict(SOUND, overflow_max=50), LIMITS, conf,
                         100_000, complete=True)[0]
    assert not compare.judge(dict(SOUND, overflow_max=51), LIMITS, conf,
                             100_000, complete=True)[0]


def test_a_guarantee_no_number_checks_is_refused():
    conf = dict(CONF, guarantees=dict(CONF["guarantees"], recall=0.99))
    with pytest.raises(KeyError):
        compare.guarantee_limits(conf, 100_000)
