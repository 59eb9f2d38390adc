"""mgf_tpu_torch, chip_smoke.py and scripts/torch_profile_step.py import
neither jax nor mgf_tpu (the machine with the card has no JAX), and
importing them initialises no CUDA context.  The package is walked module
by module, so a new module is covered without being named here."""

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
print(json.dumps([len(names), bad, torch.cuda.is_initialized()]))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad, cuda_init = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == [], bad
    assert cuda_init is False
    assert n_modules >= 20


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


def test_profile_script_imports_no_jax():
    _probe_script("torch_profile_step", "scripts")
