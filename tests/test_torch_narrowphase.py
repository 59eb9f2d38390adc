"""Kernel K2's plain PyTorch version (mgf_tpu_torch.ops.narrowphase) against
mgf_tpu's Pallas ``sphere_contact_pairs``, run as tests/test_ops_native.py
runs it on the CPU: in interpret mode, with P a multiple of the 4096-pair
tile so that the Pallas path (not its jnp fallback) is taken.

Inputs are numpy-seeded random (8, P) blocks (as test_ops_native.py:9-15)
plus hand-set rows for each branch of the kernel.  Gates are the JAX
package's own kernel-vs-jnp tolerances (test_ops_native.py:28-35): valid
exactly, t and n within atol 1e-4, witness points within 1e-3 (rsqrt is
approximate on both sides, in different ways).

Also K3's plain version (``inner_sweeps_blockmajor``) against mgf_tpu's
Pallas ``inner_sweeps`` in interpret mode on the same data laid out by
blocks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mgf_tpu.ops import solver_sweep as jss  # noqa: E402
from mgf_tpu.ops.narrowphase import (  # noqa: E402
    sphere_contact_pairs as j_pairs,
)

from mgf_tpu_torch.collision import (  # noqa: E402
    contact_moving_moving, contact_sphere_moving_sphere,
)
from mgf_tpu_torch.geom import Sphere  # noqa: E402
from mgf_tpu_torch.math3d import Vec3  # noqa: E402
from mgf_tpu_torch.ops import narrowphase as tnp  # noqa: E402
from mgf_tpu_torch.ops import solver_sweep as tss  # noqa: E402

P = 8192   # two Pallas tiles


def edge_rows():
    """One (8,) column pair per branch of the kernel: coincident centres
    with v = 0 and with v != 0, overlap, a sweep hit at t in [0, 1], a
    miss (disc < 0), a separating pair, a hit beyond t = 1."""
    col = lambda x, d, r: np.asarray([*x, *d, r, 0.0], np.float32)
    a0 = col((0, 0, 0), (0, 0, 0), 0.5)
    rows = [
        (a0, col((0, 0, 0), (0, 0, 0), 0.5)),             # coincident, v=0
        (a0, col((0, 0, 0), (0.3, -0.1, 0.2), 0.5)),      # coincident, v!=0
        (a0, col((0.6, 0.2, 0), (0, 0, 0), 0.5)),         # overlap
        (a0, col((2.0, 0, 0), (-1.5, 0, 0), 0.5)),        # hit, t = 2/3
        (a0, col((2.0, 3.0, 0), (-1.5, 0, 0), 0.5)),      # miss, disc < 0
        (a0, col((2.0, 0, 0), (1.0, 0.5, 0), 0.5)),       # separating
        (a0, col((5.0, 0, 0), (-1.0, 0, 0), 0.5)),        # hit at t = 4
        (col((1, 1, 1), (0.2, 0, 0), 0.3),
         col((1.5, 1.4, 1), (-0.4, -0.3, 0.1), 0.4)),     # both moving
    ]
    return np.stack([a for a, _ in rows], 1), np.stack([b for _, b in rows], 1)


def pair_blocks(p=P, seed=0):
    """Random blocks (normal, |r| + 0.1) with the edge rows up front."""
    rng = np.random.default_rng(seed)
    ga = rng.standard_normal((8, p)).astype(np.float32)
    gb = rng.standard_normal((8, p)).astype(np.float32)
    ga[6] = np.abs(ga[6]) + 0.1
    gb[6] = np.abs(gb[6]) + 0.1
    ea, eb = edge_rows()
    ga[:, :ea.shape[1]] = ea
    gb[:, :eb.shape[1]] = eb
    return ga, gb


def _np_contact(c):
    return {k: np.stack([np.asarray(x) for x in getattr(c, k)])
            if k in "abn" else np.asarray(getattr(c, k))
            for k in ("a", "b", "n", "t", "valid")}


def _assert_gate(cj, ct):
    """test_ops_native.py's gate: valid exact; t and n atol 1e-4 and the
    witness points atol 1e-3 on valid contacts."""
    np.testing.assert_array_equal(cj["valid"], ct["valid"])
    m = cj["valid"]
    np.testing.assert_allclose(cj["t"][m], ct["t"][m], atol=1e-4, rtol=0)
    np.testing.assert_allclose(cj["n"][:, m], ct["n"][:, m], atol=1e-4,
                               rtol=0)
    for k in ("a", "b"):
        np.testing.assert_allclose(cj[k][:, m], ct[k][:, m], atol=1e-3,
                                   rtol=0)


def test_plain_matches_jax_pallas():
    ga, gb = pair_blocks()
    cj = _np_contact(j_pairs(jnp.asarray(ga), jnp.asarray(gb),
                             use_pallas=True))
    ct = _np_contact(tnp.sphere_contact_pairs_reference(
        torch.as_tensor(ga), torch.as_tensor(gb)))
    _assert_gate(cj, ct)
    # every branch is exercised: 0.1 < valid fraction < 0.9, both t = 0
    # overlaps and t > 0 sweep hits
    assert 0.1 < cj["valid"].mean() < 0.9
    assert (cj["t"][cj["valid"]] > 0).any()
    assert (cj["t"][cj["valid"]] == 0).any()
    # the hand-set rows: coincident with v = 0 invalid, with v != 0 valid;
    # overlap valid at t = 0; hit at t = 2/3; miss, separating and t > 1
    # invalid
    np.testing.assert_array_equal(
        ct["valid"][:8], [False, True, True, True, False, False, False, True])
    np.testing.assert_allclose(ct["t"][3], 2.0 / 3.0, atol=1e-6)


def test_plain_matches_port_collision():
    """The same function as the port's branch-free collision path (the
    fused branch's contact test), at the same gate."""
    ga, gb = (torch.as_tensor(x) for x in pair_blocks(4096, seed=3))
    sa = Sphere(c=Vec3(ga[0], ga[1], ga[2]), r=ga[6])
    sb = Sphere(c=Vec3(gb[0], gb[1], gb[2]), r=gb[6])
    cj = _np_contact(contact_moving_moving(
        contact_sphere_moving_sphere, sa, Vec3(ga[3], ga[4], ga[5]), sb,
        Vec3(gb[3], gb[4], gb[5])))
    _assert_gate(cj, _np_contact(tnp.sphere_contact_pairs_reference(ga, gb)))


def test_wrapper_runs_plain_on_cpu_and_checks_inputs():
    ga, gb = (torch.as_tensor(x) for x in pair_blocks(1000, seed=1))
    before = tnp.LAUNCHES
    c = tnp.sphere_contact_pairs(ga, gb)          # ragged P: no padding
    assert tnp.LAUNCHES == before                 # no kernel on the CPU
    ref = tnp.sphere_contact_pairs_reference(ga, gb)
    for x, y in zip([*c.a, *c.b, *c.n, c.t, c.valid],
                    [*ref.a, *ref.b, *ref.n, ref.t, ref.valid]):
        assert torch.equal(x, y)
    assert c.t.shape == (1000,) and c.valid.dtype == torch.bool
    with pytest.raises(ValueError):
        tnp.sphere_contact_pairs(ga[:7], gb[:7])
    with pytest.raises(ValueError):
        tnp.sphere_contact_pairs(ga, gb[:, :999])
    with pytest.raises(TypeError):
        tnp.sphere_contact_pairs(ga.double(), gb.double())
    with pytest.raises(ValueError):
        tnp.sphere_contact_pairs(ga.T.contiguous().T, gb)


def _sweep_inputs(R, N, seed=0):
    """A random row system with mass-split effective masses (as
    test_torch_ops_cuda.py) in the (C, R, N) layout."""
    rng = np.random.default_rng(seed)
    nrm = rng.standard_normal((3, R, N))
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    t1 = np.cross(nrm, np.asarray([1.0, 0.1, -0.2])[:, None, None] + 0 * nrm,
                  axis=0)
    t1 /= np.linalg.norm(t1, axis=0, keepdims=True)
    t2 = np.cross(nrm, t1, axis=0)
    valid = rng.uniform(size=(1, R, N)) < 0.7
    count = np.maximum(valid.sum(axis=1, keepdims=True), 1)
    fields = np.concatenate([
        nrm, t1, t2, rng.standard_normal((3, R, N)) * 0.4,
        rng.uniform(0.2, 0.8, (1, R, N)), rng.uniform(-0.5, 1.5, (1, R, N)),
        rng.uniform(0.2, 1.0, (3, R, N)) / count, valid], axis=0)
    f = lambda a: np.asarray(a, np.float32)
    return (f(rng.standard_normal((8, N))), f(fields),
            f(rng.standard_normal((3, R, N)) * 0.5),
            f(rng.uniform(0.5, 1.5, (2, N))),
            f(rng.uniform(0.0, 0.3, (3, R, N)))), valid[0]


def _blocks(x, block):
    """(C, [R,] N) -> (N // block, C, [R,] block)."""
    nb = x.shape[-1] // block
    return np.ascontiguousarray(np.moveaxis(
        x.reshape(*x.shape[:-1], nb, block), -2, 0))


def _cols(x):
    """(nb, C, [R,] block) -> (C, [R,] nb * block)."""
    return np.moveaxis(x, 0, -2).reshape(*x.shape[1:-1], -1)


@pytest.mark.parametrize("block,inner", [(512, 1), (256, 3)])
def test_blockmajor_plain_matches_jax_pallas(block, inner):
    """K3's plain version on block-major tensors against the Pallas
    inner_sweeps (interpret mode) on the same data in the (C, R, N)
    layout; tolerance atol 2e-4 / rtol 1e-4 (test_solver_sweep.py) on the
    state and on the accumulators of valid rows."""
    (S, fields, term, self_p, acc), valid = _sweep_inputs(5, 1024)
    sj, aj = jss.inner_sweeps(*(jnp.asarray(x) for x in
                                (S, fields, term, self_p, acc)), inner)
    blk = [torch.as_tensor(_blocks(x, block))
           for x in (S, fields, term, self_p, acc)]
    before = tss.BLOCKMAJOR_LAUNCHES
    st, at = tss.inner_sweeps_blockmajor(*blk, inner)
    assert tss.BLOCKMAJOR_LAUNCHES == before
    assert st.shape == blk[0].shape and at.shape == blk[4].shape
    np.testing.assert_allclose(np.asarray(sj), _cols(st.numpy()),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(aj)[:, valid],
                               _cols(at.numpy())[:, valid], atol=2e-4,
                               rtol=1e-4)
    # the (C, R, N) sweeps are the case block = N of the same function
    s1, a1 = tss.inner_sweeps(*(torch.as_tensor(x) for x in
                                (S, fields, term, self_p, acc)), inner)
    np.testing.assert_array_equal(s1.numpy(), _cols(st.numpy()))
    np.testing.assert_array_equal(a1.numpy(), _cols(at.numpy()))
    with pytest.raises(ValueError):
        tss.inner_sweeps_blockmajor(blk[0], blk[1][:, :, :4], *blk[2:],
                                    inner)
