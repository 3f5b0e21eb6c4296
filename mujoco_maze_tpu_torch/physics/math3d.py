"""Quaternion / rotation / spatial-vector helpers on batched torch tensors.

Port of ``mujoco_maze_tpu.physics.math3d``.  Every function acts on the
trailing axes and broadcasts over any leading batch axes.

Conventions: quaternions are (w, x, y, z) like MuJoCo; spatial motion
vectors are ``[ω; v]`` in world axes about a reference point (the JAX
package takes the world origin, the port's engine the root body's
origin); spatial force vectors are ``[m; f]``.
"""

from __future__ import annotations

import torch


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q."""
    qv = q[..., 1:]
    w = q[..., 0:1]
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + w * t + torch.linalg.cross(qv, t)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        dim=-2,
    )


def mat_vec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` for ``m (..., n, k)`` and ``v (..., k)``."""
    return (m @ v[..., None])[..., 0]


# -- spatial algebra ([ω; v] motion, [m; f] force, about one point) --------

def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """v ×ₘ m for motion vectors (Featherstone crm)."""
    w, vl = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    cross = torch.linalg.cross
    return torch.cat([cross(w, mw), cross(w, ml) + cross(vl, mw)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """v ×* f for force vectors (Featherstone crf)."""
    w, vl = v[..., :3], v[..., 3:]
    fm, fl = f[..., :3], f[..., 3:]
    cross = torch.linalg.cross
    return torch.cat([cross(w, fm) + cross(vl, fl), cross(w, fl)], dim=-1)


def make_spatial_inertia(mass: torch.Tensor, com: torch.Tensor,
                         inertia_c: torch.Tensor) -> torch.Tensor:
    """Dense 6x6 spatial inertia about the reference point.

    ``mass (...)``, ``com (..., 3)`` CoM relative to the reference point,
    ``inertia_c (..., 3, 3)`` rotational inertia about the CoM in world
    axes.  KE = ½ sᵀ I s for s = [ω; v] about the reference point.
    """
    cx = skew(com)
    m = mass[..., None, None]
    Io = inertia_c + m * (cx @ cx.transpose(-1, -2))
    eye = torch.eye(3, dtype=Io.dtype, device=Io.device).expand_as(Io)
    top = torch.cat([Io, m * cx], dim=-1)
    bot = torch.cat([m * cx.transpose(-1, -2), m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)
