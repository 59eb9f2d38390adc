"""The port's demos and entry point against mgf_tpu's.

* ``demos/balls_torch.py --num 3 --steps 5 --device cpu --save --render``
  against ``demos/balls.py`` run the same way under JAX_PLATFORMS=cpu:
  the saved trajectories within the world tests' 1e-6 on positions, and
  the two rendered frames (the same renderer, demos/render.py) differ in
  at most 1 % of their pixels;
* ``demos/capsules_torch.py`` runs on the CPU and renders its frame;
* ``mgf_tpu_torch.entry.entry(device="cpu")`` against
  ``__graft_entry__.entry()``: the same scene, and one step's metrics
  equal (counts exactly, floats within 1e-5).
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _demo(script, tmp, *args, jax_cpu=False):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    if jax_cpu:
        env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, os.path.join(ROOT, "demos", script),
                          *args], cwd=tmp, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _ppm(path):
    with open(path, "rb") as fh:
        data = fh.read()
    head = b"P6\n640 480\n255\n"
    assert data.startswith(head)
    return np.frombuffer(data[len(head):], np.uint8).reshape(480, 640, 3)


def test_balls_demo_matches_jax(tmp_path):
    args = ("--num", "3", "--steps", "5", "--save", "traj.npz", "--render",
            "frame.ppm")
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    tdir.mkdir()
    jdir.mkdir()
    t_out = _demo("balls_torch.py", tdir, *args, "--device", "cpu")
    j_out = _demo("balls.py", jdir, *args, jax_cpu=True)
    assert "balls: 28 spheres" in t_out and "device=cpu" in t_out
    # the same closing line: the y range of the last frame
    done = lambda s: [ln for ln in s.splitlines() if ln.startswith("done:")]
    assert done(t_out) == done(j_out)
    xt = np.load(tdir / "traj.npz")["x"]
    xj = np.load(jdir / "traj.npz")["x"]
    assert xt.shape == xj.shape == (5, 28, 3) and xt.dtype == xj.dtype
    np.testing.assert_allclose(xt, xj, atol=1e-6, rtol=0)
    ft, fj = _ppm(tdir / "frame.ppm"), _ppm(jdir / "frame.ppm")
    differ = (ft != fj).any(axis=-1).mean()
    assert differ <= 0.01, differ
    assert (ft != ft[0, 0]).any()               # something was drawn


def test_capsules_demo_renders(tmp_path):
    out = _demo("capsules_torch.py", tmp_path, "--num", "2", "--steps", "3",
                "--render", "frame.ppm", "--device", "cpu")
    assert "capsules: 8 capsules" in out
    frame = _ppm(tmp_path / "frame.ppm")
    bg = frame[0, 0]
    # the capsules' colour (96, 160, 224), shaded, is on the frame
    drawn = (frame != bg).any(axis=-1)
    assert drawn.mean() > 0.001
    assert (frame[..., 2] > frame[..., 0])[drawn].any()


def test_entry_matches_graft_entry():
    import jax
    import __graft_entry__ as graft
    from mgf_tpu_torch import world_to_numpy
    from mgf_tpu_torch.entry import entry
    from mgf_tpu_torch.world import CUDA
    import inspect
    assert inspect.signature(entry).parameters["device"].default == CUDA
    jfn, (jw,) = graft.entry()
    tfn, (tw,) = entry(device="cpu")
    assert tw.bodies.n_bodies == jw.bodies.n_bodies == 217
    assert tw.bodies.x.x.device.type == "cpu"
    assert isinstance(tfn, functools.partial)
    jl = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jw))
    tl = jax.tree_util.tree_leaves(world_to_numpy(tw))
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)
    _, jm = jax.jit(jfn)(jw)
    _, tm = tfn(tw)
    jm = jax.tree_util.tree_map(np.asarray, jm)
    tm = world_to_numpy(tm)
    assert set(jm) == set(tm)
    for k in jm:
        assert np.isfinite(tm[k]).all(), k
        if np.issubdtype(jm[k].dtype, np.integer) or jm[k].dtype == bool:
            assert int(jm[k]) == int(tm[k]), k
        else:
            np.testing.assert_allclose(tm[k], jm[k], atol=1e-5, err_msg=k)
