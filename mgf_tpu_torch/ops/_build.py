"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``.cu`` file under ``ops/csrc/`` compiles, at first use, into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC [<the source's own flags>] -o <lib> <source>

(``SOURCE_FLAGS``: ``sphere_terrain.cu`` adds ``--fmad=false``, so that no
multiply is contracted into an add it does not write as one.)

The library lands in ``build/mgf_tpu_torch/`` at the repository root (or in
the directory given to :func:`set_build_dir`), in a file named after a hash
of the source, so an edited source rebuilds and an unchanged one loads the
existing library.  :func:`build_all`
starts one nvcc per source at once and waits for all of them.  A missing
nvcc or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mgf_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
SOURCE_FLAGS = {"sphere_terrain": ["--fmad=false"]}

_loaded = {}
BUILD_SECONDS = {}   # source name -> seconds spent in nvcc this process


def sources():
    """The names of the package's CUDA sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels of mgf_tpu_torch cannot be built")


def build_dir() -> Path:
    """The directory the libraries are built into and loaded from."""
    return _BUILD_DIR


def set_build_dir(path) -> None:
    """Build into and load from ``path`` from now on (``bench_torch.py
    --cold-cache`` gives a fresh temporary directory, so that the first
    launch of each kernel includes nvcc).  Libraries this process has
    loaded already stay loaded."""
    global _BUILD_DIR
    _BUILD_DIR = Path(path)


def _flags(name: str):
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, [])


def _library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives (keyed by the
    source's hash and the compiler flags)."""
    src = (_CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(_flags(name)).encode()
    digest = hashlib.sha256(src + flags).hexdigest()
    return _BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=None):
    """Compile every missing library of ``names`` (default: all sources),
    one nvcc process per source, all started together.  Returns the wall
    seconds the builds took (0.0 when nothing needed building)."""
    todo = [n for n in (names or sources())
            if not _library_path(n).exists()]
    if not todo:
        return 0.0
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *_flags(name), "-o", tmp, str(_CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, tmp, proc in procs:
        _, err = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed building {name}.cu "
                          f"(exit {proc.returncode}):\n{err}")
        else:
            os.replace(tmp, _library_path(name))   # atomic
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it
    (once per process)."""
    if name not in _loaded:
        build_all([name])
        _loaded[name] = ctypes.CDLL(str(_library_path(name)))
    return _loaded[name]
