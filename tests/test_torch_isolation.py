"""mgf_tpu_torch, chip_smoke.py, bench_torch.py,
scripts/torch_profile_step.py, scripts/k4_phases.py,
scripts/torch_mixed_settle.py and the torch demos (demos/balls_torch.py,
demos/capsules_torch.py) import neither jax nor mgf_tpu (the machine with
the card has no JAX), and importing them initialises no CUDA context and
(mgf_tpu_torch.parallel) starts no process group.
The package is walked module by module, so a new module is covered
without being named here."""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import mgf_tpu_torch
names = ["mgf_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(mgf_tpu_torch.__path__,
                                          "mgf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import torch
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "mgf_tpu" or m.startswith("mgf_tpu."))
print(json.dumps([names, bad, torch.cuda.is_initialized(),
                  torch.distributed.is_initialized()]))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names, bad, cuda_init, group_init = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert bad == [], bad
    assert cuda_init is False
    assert group_init is False
    assert len(names) >= 32
    assert {"mgf_tpu_torch.gjk", "mgf_tpu_torch.queries",
            "mgf_tpu_torch.entry", "mgf_tpu_torch.utils",
            "mgf_tpu_torch.utils.checkpoint", "mgf_tpu_torch.utils.debug",
            "mgf_tpu_torch.utils.metrics", "mgf_tpu_torch.utils.slots",
            "mgf_tpu_torch.graphs", "mgf_tpu_torch.ops.launches",
            "mgf_tpu_torch.parallel", "mgf_tpu_torch.parallel.comm",
            "mgf_tpu_torch.parallel.sharded",
            "mgf_tpu_torch.parallel.spatial"} <= set(names)


_SMOKE_PROBE = """
import json, sys
import {module} as chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "mgf_tpu" or m.startswith("mgf_tpu."))
import torch
print(json.dumps([bad, torch.cuda.is_initialized(),
                  callable(chip_smoke.main)]))
"""


def _probe_script(module, where):
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, where)]))
    out = subprocess.run([sys.executable, "-c",
                          _SMOKE_PROBE.format(module=module)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    bad, cuda_init, has_main = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert bad == [], bad
    assert cuda_init is False and has_main


def test_chip_smoke_imports_no_jax():
    _probe_script("chip_smoke", "")


def test_bench_torch_imports_no_jax():
    _probe_script("bench_torch", "")


def test_mixed_settle_script_imports_no_jax():
    _probe_script("torch_mixed_settle", "scripts")


def test_profile_script_imports_no_jax():
    _probe_script("torch_profile_step", "scripts")


def test_k4_phases_script_imports_no_jax():
    _probe_script("k4_phases", "scripts")


@pytest.mark.parametrize("demo", ["balls_torch", "capsules_torch"])
def test_torch_demos_import_no_jax(demo):
    _probe_script(demo, "demos")
