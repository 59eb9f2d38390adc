"""Smoke run of mgf_tpu_torch on one NVIDIA GPU: build the kernel, check it,
drive the flagship path, and check what comes out.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

1. the device: torch's name for it and nvidia-smi's name and power limit;
2. build kernel K1 (ops/csrc/solver_sweep.cu) with nvcc, timed;
3. K1 against its plain PyTorch version at the flagship shapes (R=12 rows,
   N=100,000 bodies, 4 and 6 inner sweeps, warm accumulators), with both
   times from CUDA events; tolerance atol 2e-4 / rtol 1e-4 on the state and
   on the accumulators of valid rows;
4. the main path: stress_scene(100_000) stepped 256 steps by
   AdaptiveChunkStepper(chunk=16, light=True), with the physics guards
   checked and K1's launch count held to the solver's outer iterations;
5. kernel path against plain path end to end: an 8,000-body pile stepped
   40 steps on the card, copied to the CPU, then one more step on each;
6. a JSON line of per-kernel results, then the result line.

Needs a CUDA card; it exits non-zero without one, and imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL = dict(atol=2e-4, rtol=1e-4)
N_MAIN = 100_000      # the flagship pile
N_E2E = 8_000         # the end-to-end kernel-vs-plain pile


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _flagship_rows(R, N, dev, seed=0):
    """A random self-consistent row system as in
    tests/test_solver_sweep.py (unit normals, orthonormal tangents, masses
    in [0.2, 1]), with the effective masses divided by each column's count
    of valid rows — the mass splitting the flagship's constraint build
    applies, without which 12 Jacobi rows per body overshoot and amplify
    rounding noise sweep after sweep."""
    rng = np.random.default_rng(seed)
    nrm = rng.standard_normal((3, R, N))
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    helper = np.broadcast_to(np.asarray([1.0, 0.1, -0.2])[:, None, None],
                             nrm.shape)
    t1 = np.cross(nrm, helper, axis=0)
    t1 /= np.linalg.norm(t1, axis=0, keepdims=True)
    t2 = np.cross(nrm, t1, axis=0)
    valid = rng.uniform(size=(1, R, N)) < 0.7
    count = np.maximum(valid.sum(axis=1, keepdims=True), 1)
    fields = np.concatenate([
        nrm, t1, t2, rng.standard_normal((3, R, N)) * 0.4,
        rng.uniform(0.2, 0.8, (1, R, N)), rng.uniform(-0.5, 1.5, (1, R, N)),
        rng.uniform(0.2, 1.0, (3, R, N)) / count, valid], axis=0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    S = np.zeros((8, N))
    S[:6] = rng.standard_normal((6, N))
    S[3:6] *= 0.3
    return (t(S), t(fields), t(rng.standard_normal((3, R, N)) * 0.5),
            t(np.stack([rng.uniform(0.5, 1.5, N), rng.uniform(0.5, 2.0, N)])),
            t(rng.uniform(0.0, 0.3, (3, R, N)))), t(valid[0]).bool()


def _time_ms(fn, reps=20):
    for _ in range(3):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def phase_kernel(ss, dev):
    args, valid = _flagship_rows(12, 100_000, dev)
    out = {}
    for inner in (4, 6):
        s_k, a_k = ss.inner_sweeps(*args, inner)
        s_p, a_p = ss.inner_sweeps_reference(*args, inner)
        torch.cuda.synchronize()
        err_s = float((s_k - s_p).abs().max())
        err_a = float((a_k - a_p).abs()[:, valid].max())
        torch.testing.assert_close(s_k, s_p, **TOL)
        torch.testing.assert_close(a_k[:, valid], a_p[:, valid], **TOL)
        ms = _time_ms(lambda: ss.inner_sweeps(*args, inner))
        plain_ms = _time_ms(lambda: ss.inner_sweeps_reference(*args, inner))
        out[inner] = dict(err=max(err_s, err_a), ms=ms, plain_ms=plain_ms)
        print(f"[3] K1 R=12 N=100000 inner={inner}: max_abs_err state "
              f"{err_s:.3g} acc {err_a:.3g} (atol 2e-4, rtol 1e-4); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    return out


def phase_main_path(ss, dev):
    from mgf_tpu_torch.driver import AdaptiveChunkStepper
    from mgf_tpu_torch.scenes import stress_scene
    world, cfg = stress_scene(N_MAIN, device=dev)
    chunk, n_chunks = 16, 16
    st = AdaptiveChunkStepper(cfg, chunk=chunk, light=True)
    it2 = int(cfg.adapt_schedule[1])
    expected = 0
    chunk_s, last, rebuilds = [], None, 0
    overflow, drift = 0, 0.0
    torch.cuda.synchronize()
    ss.LAUNCHES = 0
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        world, m = st.step_chunk(world)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        expected += chunk * (it2 if st.hot_on else cfg.solver_iters)
        rebuilds += int(m["broadphase_rebuilt"].sum())
        overflow = max(overflow, int(m["broadphase_overflow"].max()))
        drift = max(drift, float(m["broadphase_cache_drift_excess"].max()))
        last = {k: v[-1] for k, v in m.items()}
    launches = ss.LAUNCHES
    b = world.bodies
    finite = all(bool(torch.isfinite(c).all())
                 for c in (*b.x, *b.v, *b.omega))
    steps = chunk * n_chunks
    sps_all = steps / sum(chunk_s)
    sps_late = chunk * (n_chunks - 2) / sum(chunk_s[2:])
    contacts = int(last["num_contacts"])
    pen = float(last["max_penetration"])
    hit = float(last["warm_hit_frac"])
    print(f"[4] main path stress_scene({N_MAIN}) {steps} steps, chunk "
          f"{chunk}: {sps_late:.2f} steps/s (chunks 3-{n_chunks}; "
          f"{sps_all:.2f} incl. first two), contacts {contacts}, max "
          f"penetration {pen:.4f}, rebuilds {rebuilds}, warm_hit_frac "
          f"{hit:.4f}, overflow {overflow}, drift excess {drift}, K1 "
          f"launches {launches} (expected {expected})", flush=True)
    check(finite, "non-finite x, v or omega")
    check(overflow == 0, f"broadphase overflow {overflow}")
    check(drift == 0.0, f"broadphase drift excess {drift}")
    check(contacts > 0, "no contacts")
    check(pen < 0.5, f"max penetration {pen}")
    check(launches == expected and launches > 0,
          f"K1 launches {launches} != solver outer iterations {expected}")
    return launches


def phase_end_to_end(dev):
    from mgf_tpu_torch import world_from_numpy, world_to_numpy
    from mgf_tpu_torch.scenes import stress_scene
    from mgf_tpu_torch.world import step
    world, cfg = stress_scene(N_E2E, device=dev)
    for _ in range(40):
        world, _ = step(world, cfg)
    one = cfg._replace(adapt_schedule=None)
    w_cpu = world_from_numpy(world_to_numpy(world), "cpu")
    w_g, m_g = step(world, one)
    w_c, m_c = step(w_cpu, one)
    n_g, n_c = int(m_g["num_contacts"]), int(m_c["num_contacts"])
    err = max(float((a.cpu() - b).abs().max())
              for f in ("v", "omega")
              for a, b in zip(getattr(w_g.bodies, f), getattr(w_c.bodies, f)))
    print(f"[5] {N_E2E}-body pile after 40 card steps, one more step: contacts "
          f"card {n_g} / cpu {n_c}; max |dv|,|domega| {err:.3g} "
          f"(atol 1e-3)", flush=True)
    check(n_c > 0 and abs(n_g - n_c) <= 0.001 * n_c,
          f"contact counts {n_g} vs {n_c}")
    check(err <= 1e-3, f"v/omega differ by {err}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    from mgf_tpu_torch.ops import solver_sweep as ss
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[1] device {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(smi, flush=True)
    t0 = time.perf_counter()
    nvcc_s = ss.build()
    print(f"[2] K1 built in {nvcc_s:.2f} s of nvcc (load total "
          f"{time.perf_counter() - t0:.2f} s)", flush=True)
    k1 = phase_kernel(ss, dev)
    launches = phase_main_path(ss, dev)
    phase_end_to_end(dev)
    print(json.dumps({"kernels": [{
        "name": "solver_sweep.inner_sweeps",
        "route": "cuda",
        "source": "mgf_tpu_torch/ops/csrc/solver_sweep.cu",
        "replaces": "mgf_tpu/ops/solver_sweep.py:113",
        "launches": launches,
        "max_abs_err": max(v["err"] for v in k1.values()),
        "ms": k1[6]["ms"],
        "plain_ms": k1[6]["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
