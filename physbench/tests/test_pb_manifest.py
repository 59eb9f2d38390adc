"""The benchmark's manifest and the files it names, found by name."""

import json
import re

import pytest

from physbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest.manifest()
CELLS = [w["name"] for w in M["workloads"]]
METRICS = M["end_to_end"] + M["per_layer"]


def test_manifest_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units_use_allowed_characters(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for k in entry.get("reduced", []):
        assert NAME.match(k)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique():
    for group in (M["configs"], M["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_are_found_by_name(cell):
    c = manifest.cell(cell)
    conf = manifest.config(c["config"])
    traffic = manifest.traffic(c["traffic"])
    limits = manifest.limits(cell)
    assert conf["name"] == c["config"] and traffic["name"] == c["traffic"]
    from physbench.harness.compare import EXACT, FOLLOWED
    # every followed number has a limit, or the reason it is only logged
    assert set(limits) == set(FOLLOWED) - set(EXACT)
    assert all(isinstance(v, (int, float)) or (isinstance(v, str) and v)
               for v in limits.values())
    assert {"v_gap_median", "contact_rows_mismatch",
            "momentum_gap"} <= {k for k, v in limits.items()
                                if not isinstance(v, str)}
    names = {e["name"] for e in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]


@pytest.mark.parametrize("entry", M["per_layer"], ids=lambda e: e["name"])
def test_metric_reader_matches_manifest(entry):
    mod = manifest.metric(entry["name"])
    assert mod.LAYER == entry["layer"]
    assert mod.UNIT == entry["unit"]
    assert mod.SOURCE == entry["source"]
    assert mod.MOVES == entry["moves"]
    assert callable(mod.read)
    # a reader that finds nothing to read returns nothing, never 0
    assert mod.read(dict(steps=0, window_s=0.0, frame_ms=None,
                         replays=None, rebuilds=None, capture_s=None,
                         trace=None, k1=None)) is None
    moved = next(e for e in M["end_to_end"] if e["name"] == entry["moves"])
    for w in entry.get("workloads", CELLS):
        assert "workloads" not in moved or w in moved["workloads"]


def test_config_files_state_the_manifest_entries():
    for c in M["configs"]:
        conf = manifest.config(c["name"])
        assert c["file"] == f"physbench/configs/{c['name']}.json"
        assert conf["source"] == c["source"]
        assert conf["precision"] == "float32"


CONFIG_FILES = sorted(p.stem for p in
                      (manifest.BENCH_DIR / "configs").glob("*.json"))


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_every_stated_guarantee_is_checked(name):
    """Each configuration file states every guarantee a number checks, and
    no guarantee that no number checks."""
    from physbench.harness.compare import GUARANTEES, guarantee_limits
    conf = manifest.config(name)
    assert set(conf["guarantees"]) == set(GUARANTEES)
    limits = guarantee_limits(conf, 100_000)
    assert set(limits) == {num for num, _ in GUARANTEES.values()}
    assert all(isinstance(v, (int, float)) for v in limits.values())


def test_an_unknown_name_is_refused():
    with pytest.raises(FileNotFoundError):
        manifest.traffic("no-such-mix")
    with pytest.raises(ValueError):
        manifest.config("../configs/x")


def test_the_files_engine_changes_reach_the_program():
    """A configuration's ``engine_set`` is applied to the builder's
    settings, and the result has to equal its ``engine`` block."""
    from physbench.harness import system
    from physbench.tests.test_pb_faults import _small
    _, conf, _, _ = _small("spheres100k-settled-chunk64")
    _, cfg = system.build_world(conf, 5, "cpu")
    assert cfg.grid.bucket_cap == conf["engine"]["grid"]["bucket_cap"] == 16
    with pytest.raises(RuntimeError, match="bucket_cap"):
        system.build_world(dict(conf, engine_set={}), 5, "cpu")
