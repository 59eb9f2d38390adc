"""Find a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root, and under ``physbench/`` one file per configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``), cell's
comparison limits (``limits/<cell>.json``) and per-layer metric
(``metrics/<name>.py``).  Adding a cell or a metric adds files; nothing
here changes."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _load_json(ROOT / "BENCHMARK.json")


def _named(kind: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} has characters a name may "
                         "not have")
    path = BENCH_DIR / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def config(name: str) -> dict:
    return _load_json(_named("configs", name, ".json"))


def traffic(name: str) -> dict:
    return _load_json(_named("traffic", name, ".json"))


def limits(cell: str) -> dict:
    return _load_json(_named("limits", cell, ".json"))


def metric(name: str):
    """The reader module of per-layer metric ``name``: it declares
    ``LAYER``, ``UNIT``, ``SOURCE``, ``MOVES`` and ``READS`` and defines
    ``read(ctx)``, which returns a number or None (nothing to read)."""
    path = _named("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"physbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str) -> dict:
    """The workload entry of ``BENCHMARK.json`` named ``name``, with the
    end-to-end and per-layer metrics it reports (those without a
    ``workloads`` list are reported everywhere)."""
    m = manifest()
    found = [w for w in m["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    here = lambda e: "workloads" not in e or name in e["workloads"]
    return dict(found[0],
                end_to_end=[e for e in m["end_to_end"] if here(e)],
                per_layer=[e for e in m["per_layer"] if here(e)])
