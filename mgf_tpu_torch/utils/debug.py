"""Debug mode: non-finite guards, world validation, and step invariant
checks (counterpart of ``mgf_tpu.utils.debug``).

* :func:`enable_debug_mode` takes the place of JAX's NaN checker: after
  every ``world.step`` the output state and metrics are checked, and the
  first non-finite one raises ``FloatingPointError`` naming its field
  (JAX's checker names the operation that produced the NaN).  Off, it
  costs the step one Python bool.
* :func:`validate_world`: host-side invariants of a World (finite state,
  unit quaternions, positive radii, sane inverse masses, the warm state's
  shape).  The ``World::step`` misuse analog.
* :func:`check_step_metrics` raises on the silent-degradation signals
  (broadphase overflow, span and reach violations) that turn into wrong
  physics if ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from mgf_tpu_torch import world as _world
from mgf_tpu_torch.utils.checkpoint import _flatten_with_paths


def enable_debug_mode(nan_checks: bool = True):
    """Check every step's output for non-finite values."""
    if nan_checks:
        _world.DEBUG_NANS = True


def disable_debug_mode():
    _world.DEBUG_NANS = False


def _metric_leaves(metrics, prefix="metrics"):
    out = []
    for k, v in metrics.items():
        if isinstance(v, dict):
            out += _metric_leaves(v, f"{prefix}/{k}")
        elif isinstance(v, tuple):
            out += [(f"{prefix}/{k}/{p}", t)
                    for p, t in _flatten_with_paths(v)]
        else:
            out.append((f"{prefix}/{k}", v))
    return out


def check_finite(world, metrics):
    """Raise ``FloatingPointError`` naming the first floating tensor of
    ``world`` or ``metrics`` that holds a NaN or an infinity (one device
    read for all of them)."""
    named = [(k, t) for k, t in (_flatten_with_paths(world)
                                 + _metric_leaves(metrics))
             if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not named:
        return
    bad = torch.stack([~torch.isfinite(t).all() for _, t in named]).cpu()
    if bool(bad.any()):
        name = named[int(torch.nonzero(bad)[0, 0])][0]
        raise FloatingPointError(
            f"non-finite value in {name} after world.step (debug mode)")


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def validate_world(world, cfg=None):
    """Host-side invariant checks; raises ValueError with every violation
    found.  Cheap enough to call between steps in a debug loop."""
    b = world.bodies
    errs = []

    def finite(name, *arrays):
        for a in arrays:
            if not np.isfinite(_np(a)).all():
                errs.append(f"{name}: non-finite values")
                return

    finite("x", b.x.x, b.x.y, b.x.z)
    finite("v", b.v.x, b.v.y, b.v.z)
    finite("omega", b.omega.x, b.omega.y, b.omega.z)
    finite("q", b.q.w, b.q.x, b.q.y, b.q.z)
    qn = np.sqrt(_np(b.q.w) ** 2 + _np(b.q.x) ** 2 + _np(b.q.y) ** 2
                 + _np(b.q.z) ** 2)
    if np.abs(qn - 1.0).max(initial=0.0) > 1e-3:
        errs.append(f"q: not unit (max |1-|q|| = {np.abs(qn-1).max():.2e})")
    if (_np(b.shape_r) <= 0.0).any():
        errs.append("shape_r: non-positive radius (geom.rs:300 analog)")
    if (_np(b.inv_mass) < 0.0).any():
        errs.append("inv_mass: negative")
    if (_np(b.shape_half_h) < 0.0).any():
        errs.append("shape_half_h: negative")
    if world.warm is not None:
        n = b.n_bodies
        if world.warm.acc_n.shape[1] != n:
            errs.append(
                f"warm state N {world.warm.acc_n.shape[1]} != bodies {n} "
                "(re-run init_warm after changing the body count)")
        if cfg is not None:
            r = _world.solver_row_count(cfg, world.terrain.a.x.shape[0])
            if world.warm.acc_n.shape[0] != r:
                errs.append(
                    f"warm state rows {world.warm.acc_n.shape[0]} != "
                    f"solver_row_count {r} (config changed?)")
    if errs:
        raise ValueError("world validation failed:\n  " + "\n  ".join(errs))


def check_step_metrics(metrics, max_penetration: float = 1.0):
    """Raise on silent-degradation signals in a step's metrics dict."""
    errs = []
    g = lambda k: float(_np(metrics[k])) if k in metrics else 0.0
    if g("broadphase_overflow") > 0:
        errs.append(f"broadphase bucket overflow "
                    f"{int(g('broadphase_overflow'))} bodies dropped "
                    "(raise GridConfig.bucket_cap)")
    if g("broadphase_span_excess") > 0:
        errs.append("scene span exceeds grid modulus (dim*cell) — occupied "
                    "cells alias; raise GridConfig.dim")
    if g("broadphase_reach_excess") > 0.0:
        errs.append(f"pair reach exceeds the candidate window guarantee by "
                    f"{g('broadphase_reach_excess'):.3f} (fast movers may "
                    "miss pairs; grow cell_size or lower fatten)")
    if g("terrain_reach_excess") > 0.0:
        errs.append(f"body reach exceeds the terrain grid window guarantee "
                    f"by {g('terrain_reach_excess'):.3f} (terrain contacts "
                    "may be missed; grow terrain_grid_cfg.cell_size)")
    if g("max_penetration") > max_penetration:
        errs.append(f"max penetration {g('max_penetration'):.3f} > "
                    f"{max_penetration} (solver not converging; add sweeps "
                    "or enable warm_start)")
    if errs:
        raise ValueError("step degradation detected:\n  "
                         + "\n  ".join(errs))
