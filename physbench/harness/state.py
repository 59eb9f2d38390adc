"""The program's world as the reference's state: a dict of (N, 3) tensors.

This is the one place where the harness reads the program's state for the
reference.  It copies the tensors (the program keeps the originals) and
converts them to the reference's layout and dtype; it computes nothing.
"""

from __future__ import annotations

import torch


def _v3(v, dtype):
    return torch.stack([v.x, v.y, v.z], -1).to(dtype)


def _m3(m, dtype):
    rows = (("xx", "xy", "xz"), ("yx", "yy", "yz"), ("zx", "zy", "zz"))
    return torch.stack([torch.stack([getattr(m, k) for k in r], -1)
                        for r in rows], -2).to(dtype)


def state_from_world(world, dtype=torch.float32, device=None):
    """The reference state of a program ``World`` (bodies, terrain, the
    broadphase cache and the warm-start rows), as copies in ``dtype`` on
    ``device`` (default: the world's)."""
    b = world.bodies
    dev = b.x.x.device if device is None else device
    f = lambda t: t.to(dev, dtype, copy=True)
    v3 = lambda v: _v3(v, dtype).to(dev)
    bp, warm = world.bp, world.warm
    t = world.terrain
    return dict(
        x=v3(b.x), delta=v3(b.delta), v=v3(b.v), omega=v3(b.omega),
        force=v3(b.force), torque=v3(b.torque),
        q=torch.stack([b.q.w, b.q.x, b.q.y, b.q.z], -1).to(dev, dtype),
        inv_mass=f(b.inv_mass), restitution=f(b.restitution),
        friction=f(b.friction), r=f(b.shape_r), half_h=f(b.shape_half_h),
        shape_type=b.shape_type.to(dev, torch.int64, copy=True),
        inv_moment_body=_m3(b.inv_moment_body, dtype).to(dev),
        inv_moment=_m3(b.inv_moment, dtype).to(dev),
        bp=dict(partner=bp.partner.to(dev, torch.int64, copy=True),
                ok=bp.ok.to(dev, copy=True),
                anchor=v3(bp.anchor), count=int(bp.count),
                slack=f(bp.slack), r_build=f(bp.r_build)),
        warm=dict(partner=warm.partner.to(dev, torch.int64, copy=True),
                  key2=warm.key2.to(dev, torch.int64, copy=True),
                  acc_n=f(warm.acc_n), acc_t1=f(warm.acc_t1),
                  acc_t2=f(warm.acc_t2)),
        terrain=dict(a=v3(t.a), b=v3(t.b), c=v3(t.c),
                     center=torch.stack([world.terrain_center.x,
                                         world.terrain_center.y,
                                         world.terrain_center.z]).to(
                                             dev, dtype)))
