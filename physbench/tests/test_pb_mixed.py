"""The mixed pile's configuration and its readers: the file states what
``stress_scene(mixed=True)`` builds, with no ``engine_set``, so that a
program whose mixed pile is another engine (its cell table's cap, its
solver settings) is refused by ``system.build_world`` before it settles;
and each reader of the split solve's stamps and counter reads its own key
of ``tracing.summary``."""

import copy

import pytest

from physbench.harness import manifest, system

CONFIG = "mixed_pile_100k"
CELL = "mixed100k-settled-chunk16"
READERS = {"sphere_block_solve_ms_per_step": "sphere_block_solve",
           "capsule_block_solve_ms_per_step": "capsule_block_solve",
           "capsule_rows_per_step": "capsule_rows_per_step"}
EMPTY = dict(steps=0, window_s=0.0, frame_ms=None, replays=None,
             rebuilds=None, capture_s=None, trace=None, k1=None)


def _summary_keys():
    from mgf_tpu_torch import tracing
    return sorted(tracing.summary(tracing.record()))


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_its_own_key(name):
    keys = _summary_keys()
    assert READERS[name] in keys
    summary = {k: 2.5 + i for i, k in enumerate(keys)}
    mod = manifest.metric(name)
    got = mod.read(dict(EMPTY, program=dict(record={}, summary=summary)))
    assert got == summary[READERS[name]]
    # a program without the stamp or the counter: nothing, and no raise
    del summary[READERS[name]]
    assert mod.read(dict(EMPTY, program=dict(record={},
                                             summary=summary))) is None
    assert mod.read(EMPTY) is None


def test_readers_are_the_cells_per_layer_metrics():
    cell = manifest.cell(CELL)
    assert {e["name"] for e in cell["per_layer"]} == set(READERS)
    assert all(e["workloads"] == [CELL] for e in cell["per_layer"])


def test_engine_block_is_what_the_program_builds():
    conf = manifest.config(CONFIG)
    assert "engine_set" not in conf
    world, cfg = system.build_world(conf, 2 ** 40 + 3, "cpu")
    assert system._plain(cfg) == conf["engine"]
    assert world.bodies.n_bodies == conf["scene"]["n_bodies"]
    assert cfg.n_sphere_rows == int((world.bodies.shape_type == 0).sum())


def test_another_cap_is_refused_before_the_settle():
    conf = copy.deepcopy(manifest.config(CONFIG))
    conf["engine"]["grid"]["bucket_cap"] = 14
    with pytest.raises(RuntimeError, match="grid"):
        system.build_world(conf, 2 ** 40 + 3, "cpu")


def test_guarantees_are_the_flagships():
    mixed = manifest.config(CONFIG)["guarantees"]
    assert mixed == manifest.config("stress_spheres_100k")["guarantees"]
    assert mixed["bucket_overflow_max_share"] == 0.0
    assert mixed["pairs_missed_free_row_max_share"] == 0.0
    assert mixed["max_penetration"] == 0.5
