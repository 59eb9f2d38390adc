"""The frozen roofline arithmetic of kernel K1."""

import pytest

from physbench.harness import roofline


def test_k1_bound_at_the_flagship_shape():
    # PERF.md's kernel table: 136.8 MB at R = 12, N = 100k, bytes-bound,
    # 0.0408 ms over 3.35 TB/s
    n_bytes, n_ops = roofline.k1_work(12, 100_000, 6, 9)
    assert n_bytes == 136_800_000
    assert n_bytes / roofline.HBM_BYTES_PER_S > n_ops / roofline.F32_OPS_PER_S
    assert roofline.k1_bound_s(12, 100_000, 6, 9) * 1e3 == pytest.approx(
        0.0408, abs=5e-5)


def test_bound_takes_the_larger_side():
    assert roofline.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 67e12) == pytest.approx(1.0)
