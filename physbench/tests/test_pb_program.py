"""The per-layer metrics read from the program's own tracing
(``mgf_tpu_torch.tracing``): each reader, the harness's access to the
record, and a ``--trace 1`` run on the CPU whose stamped steps come after
everything the other readers see.  Every check here holds whatever
readers of the program's tracing the manifest has: a copy of the
benchmark with a reader of a raw interval added as a file and an entry
passes them unchanged."""

import json
import shutil
import types

import pytest
import torch

from physbench import run
from physbench.harness import manifest, system
from physbench.tests import test_pb_manifest
from physbench.tests.test_pb_faults import _small

M = manifest.manifest()
TRACING = "mgf_tpu_torch.tracing"
SUMMARY = "mgf_tpu_torch.tracing.summary: "
# the summary keys the benchmark's first readers of the tracing read
FIRST = {"broadphase", "narrowphase", "constraints", "solver", "commit",
         "rebuild_step", "need_wait", "need_gap", "idle_pct",
         "hot_schedule_pct", "pairs_tested_per_step",
         "contacts_per_pair_pct"}
EMPTY = dict(steps=0, window_s=0.0, frame_ms=None, replays=None,
             rebuilds=None, capture_s=None, trace=None, k1=None)
CELL = "spheres100k-settled-frame"
TRACE_STEPS = 4


def _tracing_entries(m):
    """The per-layer entries of manifest ``m`` whose readers read the
    program's tracing."""
    return [e for e in m["per_layer"]
            if manifest.metric(e["name"]).READS.startswith(TRACING)]


def _summary_key(entry):
    """The ``tracing.summary`` key that ``entry``'s reader reads, or None
    where it reads the raw record."""
    reads = manifest.metric(entry["name"]).READS
    return reads[len(SUMMARY):] if reads.startswith(SUMMARY) else None


def _check_reader(entry, keys):
    """A reader of the program's tracing reads nothing without a record; a
    reader of a summary key reads its own key out of a summary that holds
    a distinct number for each of ``keys``, and nothing where that key is
    None."""
    mod = manifest.metric(entry["name"])
    assert mod.read(EMPTY) is None
    assert mod.read(dict(EMPTY, program=None)) is None
    key = _summary_key(entry)
    if key is None:
        return
    summary = {k: 1.5 + i for i, k in enumerate(sorted(keys))}
    prog = dict(record={}, summary=summary)
    assert mod.read(dict(EMPTY, program=prog)) == summary[key]
    summary[key] = None
    assert mod.read(dict(EMPTY, program=prog)) is None


def _summary_keys(m):
    return {_summary_key(e) for e in _tracing_entries(m)} - {None}


def _check_manifest(m):
    """Every check of this file that needs no run, on manifest ``m``."""
    keys = _summary_keys(m)
    assert keys >= FIRST
    for e in _tracing_entries(m):
        _check_reader(e, keys)


def test_the_first_program_metrics_are_in_the_manifest():
    assert _summary_keys(M) >= FIRST


@pytest.mark.parametrize("entry", _tracing_entries(M),
                         ids=lambda e: e["name"])
def test_program_reader_reads_its_summary_key(entry):
    _check_reader(entry, _summary_keys(M))


def test_k5_reader():
    mod = manifest.metric("k5_roofline_pct")
    ctx = dict(EMPTY, k5=dict(time_s=2e-5, launches=64, bound_s=7.5e-6))
    assert mod.read(ctx) == pytest.approx(37.5)
    assert mod.read(EMPTY) is None
    assert mod.read(dict(EMPTY, k5=dict(time_s=0.0, launches=0,
                                        bound_s=0.0))) is None


def test_k5_bound_by_hand():
    from physbench.harness import roofline
    # 1,000 bodies, 10 faces, 3 candidates: 8 floats in a body, 3 x (16
    # floats + a byte + an int32) out, the deepest penetration, the mesh
    # (9 floats a face and the centre's 3) once
    full = 32_000 + 3 * 69_000 + 4_000 + 4 * 93
    ops = 1_000 * (15 + 18 * 10 + 444 * 3)
    assert roofline.k5_work(1_000, 10, 3, True) == (full, ops)
    assert roofline.k5_work(1_000, 10, 3, False) == (full - 4_000, ops)
    # bytes bound it: 243,372 B over 3.35 TB/s against 1.53 MFLOP at 67
    assert roofline.k5_bound_s(1_000, 10, 3, True) == pytest.approx(
        full / 3.35e12)
    # PERF.md's kernel table: 7.25 / 7.13 us on the settled 100k pile
    assert roofline.k5_bound_s(100_000, 10, 3, True) * 1e6 == \
        pytest.approx(7.25, abs=0.01)
    assert roofline.k5_bound_s(100_000, 10, 3, False) * 1e6 == \
        pytest.approx(7.13, abs=0.01)


class _Clock:
    """``time.perf_counter`` that advances a fixed tick a call, so that two
    runs make the same window."""

    def __init__(self, tick=0.1):
        self.t, self.tick = 0.0, tick

    def perf_counter(self):
        self.t += self.tick
        return self.t


RAW_READER = '''
LAYER = "step (world.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "steps_per_s"
READS = "mgf_tpu_torch.tracing.record: the interval integrate"


def read(ctx):
    prog = ctx.get("program")
    if not prog or not prog["record"]["steps"]:
        return None
    rec = prog["record"]
    return 1e-6 * rec["intervals"]["integrate"]["ns"] / rec["steps"]
'''
RAW = dict(name="integrate_ms_per_step", unit="ms", better="lower",
           source="program_span", layer="step (world.py)",
           moves="steps_per_s")


@pytest.fixture(scope="module")
def bench_copy(tmp_path_factory):
    """A copy of the benchmark (``BENCHMARK.json`` and the files it names
    under ``physbench/``) with a reader of a raw interval of the program's
    record added as a file and an entry."""
    root = tmp_path_factory.mktemp("copy")
    bench = root / "physbench"
    for kind in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(manifest.BENCH_DIR / kind, bench / kind)
    (bench / "metrics" / f"{RAW['name']}.py").write_text(RAW_READER)
    m = manifest.manifest()
    m["per_layer"].append(RAW)
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


def _point_at(mp, root):
    mp.setattr(manifest, "ROOT", root)
    mp.setattr(manifest, "BENCH_DIR", root / "physbench")


def test_a_record_reader_added_to_a_copy_passes_these_checks(
        bench_copy, monkeypatch):
    _point_at(monkeypatch, bench_copy)
    m = manifest.manifest()
    assert RAW in m["per_layer"]
    assert RAW in _tracing_entries(m) and _summary_key(RAW) is None
    _check_manifest(m)
    for e in m["per_layer"]:
        test_pb_manifest.test_names_and_units_use_allowed_characters(e)
        test_pb_manifest.test_metric_reader_matches_manifest(e)


def _traced_run(stamped=True):
    cell, conf, traffic, limits = _small(CELL)
    traffic["trace_steps"] = TRACE_STEPS
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(run, "time", types.SimpleNamespace(
            perf_counter=_Clock().perf_counter))
        real = run._stamped if stamped else (lambda *a: None)

        def spy(*a):
            got["program"] = real(*a)
            return got["program"]
        mp.setattr(run, "_stamped", spy)
        torch.manual_seed(0)
        res = run.run_cell(cell, conf, traffic, limits, 2 ** 33 + 7, 3.0,
                           True, torch.device("cpu"), 0.0,
                           log=lambda msg: None)
    return res, got.get("program")


@pytest.fixture(scope="module")
def runs(bench_copy):
    """A ``--trace 1`` run of the frame cell on the CPU from the copy, the
    same run with its stamped steps skipped, and the copy's readers of the
    program's tracing, each with the summary key it reads (None: the raw
    record)."""
    with pytest.MonkeyPatch.context() as mp:
        _point_at(mp, bench_copy)
        readers = {e["name"]: _summary_key(e)
                   for e in _tracing_entries(manifest.manifest())}
        stamped = _traced_run()
        skipped = _traced_run(stamped=False)
    return stamped, skipped, readers


def test_traced_run_fills_the_program_record(runs):
    from mgf_tpu_torch import tracing
    (res, prog), _, readers = runs
    assert res["correct"], res["checks"]
    assert not tracing.ON
    assert prog is not None
    rec = prog["record"]
    assert rec["steps"] == 4 * TRACE_STEPS
    assert sum(rec["schedules"].values()) == 4 * TRACE_STEPS
    assert rec["counters"]["pairs_tested"] > 0
    for name, key in readers.items():
        if key is None:
            continue
        want = prog["summary"][key]
        if want is None:        # no rebuild among the stamped steps
            assert name not in res["metrics"]
        else:
            assert res["metrics"][name]["value"] == want


def test_a_raw_interval_reader_is_a_file_and_an_entry(runs):
    (res, prog), _, readers = runs
    assert readers[RAW["name"]] is None
    rec = prog["record"]
    assert res["metrics"][RAW["name"]]["value"] == pytest.approx(
        1e-6 * rec["intervals"]["integrate"]["ns"] / rec["steps"])
    assert res["metrics"][RAW["name"]]["value"] > 0


def test_stamped_steps_come_after_every_other_reading(runs):
    """Every per-layer reading that does not come from the program's
    tracing equals that of the same run with the stamped steps skipped;
    the program's own are left out there."""
    (res, _), (res_skip, prog_skip), readers = runs
    assert prog_skip is None
    other = {k: v for k, v in res["metrics"].items() if k not in readers}
    assert other == res_skip["metrics"]
    assert other
    assert res["checks"] == res_skip["checks"]


def test_an_untraced_run_never_turns_the_program_tracing_on(monkeypatch):
    from mgf_tpu_torch import tracing

    def refuse(*a, **k):
        raise AssertionError("the program's tracing was touched")
    monkeypatch.setattr(system, "program_tracing", refuse)
    monkeypatch.setattr(system, "program_record", refuse)
    monkeypatch.setattr(tracing, "enable", refuse)
    cell, conf, traffic, limits = _small(CELL)
    res = run.run_cell(cell, conf, traffic, limits, 2 ** 33 + 7, 2.5, False,
                       torch.device("cpu"), 0.0, log=lambda msg: None)
    assert res["correct"], res["checks"]
    assert not tracing.ON
    assert set(res["metrics"]) == {e["name"] for e in cell["end_to_end"]}
