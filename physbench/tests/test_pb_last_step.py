"""``compare.last_step`` on a hand-built state: a contact row that the
program holds and the reference does not is counted once, by
``contact_rows_mismatch``, and not a second time by ``momentum_gap``."""

import pytest
import torch

from physbench.harness import compare
from physbench.reference import step as ref

DT = 1.0 / 60.0
ENG = dict(shape_mode="spheres", dt=DT, max_pairs=2, terrain_cand=2)


def _state():
    """Four spheres of radius 0.5 on a floor at y = 0, two touching pairs
    (0-1 side by side, 3 on 2), falling by 0.01 this step; the program's
    rows, impulses and velocities exactly the reference's.  Float64, so
    that the one-step balance holds to rounding."""
    f = dict(dtype=torch.float64)
    x = torch.tensor([[0.0, 0.49, 0.0], [0.98, 0.49, 0.0],
                      [5.0, 0.49, 0.0], [5.0, 1.47, 0.0]], **f)
    n = x.shape[0]
    delta = torch.tensor([[0.0, -0.01, 0.0]], **f).expand(n, 3).clone()
    big = 20.0
    tri = lambda *p: torch.tensor(p, **f)
    terrain = dict(a=tri([-big, 0, -big], [big, 0, big]),
                   b=tri([-big, 0, big], [big, 0, -big]),
                   c=tri([big, 0, big], [-big, 0, -big]),
                   center=torch.zeros(3, **f))
    partner = torch.tensor([[1, 0], [0, 0], [3, 0], [2, 0]])
    ok = torch.tensor([[True, False], [True, False], [True, False],
                       [True, False]])
    s = dict(x=x, delta=delta, r=torch.full((n,), 0.5, **f),
             half_h=torch.zeros(n, **f), q=torch.tensor(
                 [[1.0, 0, 0, 0]], **f).expand(n, 4).clone(),
             shape_type=torch.zeros(n, dtype=torch.int64),
             inv_mass=torch.ones(n, **f),
             bp=dict(partner=partner, ok=ok), terrain=terrain)
    rows = ref.contact_rows(s, ENG)
    valid = rows["valid"]
    gen = torch.Generator().manual_seed(3)
    acc = lambda: torch.where(valid, torch.rand(valid.shape, generator=gen,
                                                **f), 0.0)
    s["warm"] = dict(partner=torch.where(valid, rows["partner"], -9),
                     key2=rows["key"], acc_n=acc(), acc_t1=acc(),
                     acc_t2=acc())
    w = s["warm"]
    imp = (rows["normal"] * w["acc_n"][..., None]
           + rows["t1"] * w["acc_t1"][..., None]
           + rows["t2"] * w["acc_t2"][..., None])
    s["v"] = delta / DT - imp.sum(0) * s["inv_mass"][:, None]
    return s, rows


def test_the_hand_built_state_is_consistent():
    s, rows = _state()
    assert int(rows["valid"].sum()) >= 6       # 4 pair rows, floor rows
    got = compare.last_step(s, ENG)
    assert got["contact_rows_mismatch"] == 0
    assert got["momentum_gap"] < 1e-9


def _one_row_more(s, rows):
    """Body 2 holds a contact in a row where the reference finds none,
    with an impulse along a frame of the program's own."""
    k = int((~rows["valid"][:, 2]).nonzero()[0])
    w = s["warm"]
    w["partner"][k, 2] = 0
    w["key2"][k, 2] = 0
    w["acc_n"][k, 2] = 2.0
    s["v"][2] -= 2.0 * torch.tensor([0.6, 0.8, 0.0], dtype=s["v"].dtype)
    return s


def test_a_mismatched_row_is_counted_once():
    s, rows = _state()
    s = _one_row_more(s, rows)
    got = compare.last_step(s, ENG)
    assert got["contact_rows_mismatch"] == 1
    assert got["momentum_gap"] < 1e-9


@pytest.mark.parametrize("mismatch", [False, True])
def test_a_kick_on_a_body_with_agreeing_rows_still_reads(mismatch):
    s, rows = _state()
    if mismatch:
        s = _one_row_more(s, rows)
    s["v"][0, 0] += 0.5
    got = compare.last_step(s, ENG)
    assert got["contact_rows_mismatch"] == int(mismatch)
    assert got["momentum_gap"] >= 0.5 - 1e-9
