"""Batched 2-D segment-collision ops (port of ``mujoco_maze_tpu.ops.segments``).

The reference's manual collision stack (mujoco-maze
`maze_env_utils.py:84-206` + `maze_env.py:448-473`): wall faces are a
fixed-size ``(W, 2)`` pair of endpoint tables with a validity mask, and
detection/resolution is elementwise work over a ``(B, W)`` grid plus one
argmin over the wall axis.  Where the JAX package wrote a single-env
function under ``vmap``, these take the batch first: points ``(B, 2)``,
velocities ``(B, 2)`` or ``(B, 3)``.

These functions are also the plain version of the CUDA step kernel
(``csrc/point_lane.cu``), which repeats their arithmetic operation by
operation.  Three rules keep the two equal to the bit: a division by a
constant is a multiplication by its float32 reciprocal, sums of a few
terms are written out in a fixed order, and per-wall contributions are
summed in wall order (``_sum_in_wall_order``), as the kernel's loop does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# Movement shorter than this is treated as "did not move" (parity:
# maze_env_utils.py:189 `move.norm <= 1e-8`).
MIN_MOVE = 1e-8


class Walls(NamedTuple):
    """Padded wall-segment soup on one device.

    p1, p2: (W, 2) float32 endpoints; mask: (W,) bool validity of each slot.
    Padded slots are degenerate zero segments with ``mask=False``.
    """

    p1: torch.Tensor
    p2: torch.Tensor
    mask: torch.Tensor


class CollisionResult(NamedTuple):
    hit: torch.Tensor         # (B,) bool — any wall crossed
    point: torch.Tensor       # (B, 2) nearest intersection (valid iff hit)
    reflection: torch.Tensor  # (B, 2) new endpoint mirrored across that wall


def _wall_frame(walls: Walls):
    """Endpoint and direction columns ``(1, W)`` plus the safe squared norm."""
    p1x, p1y = walls.p1[None, :, 0], walls.p1[None, :, 1]
    p2x, p2y = walls.p2[None, :, 0], walls.p2[None, :, 1]
    v1x, v1y = p2x - p1x, p2y - p1y
    nrm2 = v1x * v1x + v1y * v1y
    safe_n = torch.where(nrm2 == 0.0, torch.ones_like(nrm2), nrm2)
    return p1x, p1y, p2x, p2y, v1x, v1y, safe_n


def _sum_in_wall_order(x: torch.Tensor) -> torch.Tensor:
    """Sum ``(B, W)`` over walls left to right from 0, as the kernel's
    accumulator does (``torch.sum`` reduces in another order, which can
    differ in the last bit when three or more walls contribute)."""
    acc = torch.zeros_like(x[:, 0])
    for w in range(x.shape[1]):
        acc = acc + x[:, w]
    return acc


def detect(walls: Walls, old: torch.Tensor, new: torch.Tensor) -> CollisionResult:
    """Nearest wall crossing of each movement segment old→new.

    Port of ``CollisionDetector.detect`` (maze_env_utils.py:186-206): double
    orientation test per wall, cross-point via the cross-ratio, nearest hit
    by the first argmin of the distance from ``old``.
    """
    ox, oy = old[:, 0:1], old[:, 1:2]
    nx, ny = new[:, 0:1], new[:, 1:2]
    dx, dy = nx - ox, ny - oy                                   # (B, 1)
    moved = dx * dx + dy * dy > MIN_MOVE * MIN_MOVE
    p1x, p1y, p2x, p2y, v1x, v1y, safe_n = _wall_frame(walls)
    # wall._intersect(move): movement endpoints straddle the wall's line
    c_old = v1x * (oy - p1y) - v1y * (ox - p1x)                 # (B, W)
    c_new = v1x * (ny - p1y) - v1y * (nx - p1x)
    s1 = c_old * c_new <= 0.0
    # move._intersect(wall): wall endpoints straddle the movement's line
    cw1 = dx * (p1y - oy) - dy * (p1x - ox)
    cw2 = dx * (p2y - oy) - dy * (p2x - ox)
    s2 = cw1 * cw2 <= 0.0
    # cross point: old + (cross(v1, p2 - old) / cross(v1, d)) * d
    a = v1x * dy - v1y * dx
    b = v1x * (p2y - oy) - v1y * (p2x - ox)
    safe_a = torch.where(a == 0.0, torch.ones_like(a), a)
    t = b / safe_a
    px = ox + t * dx
    py = oy + t * dy
    hit = s1 & s2 & walls.mask & moved & (a != 0.0)
    # reflection of `new` across the wall carrier line
    scale = ((nx - p1x) * v1x + (ny - p1y) * v1y) / safe_n
    rx = 2.0 * (p1x + scale * v1x) - nx
    ry = 2.0 * (p1y + scale * v1y) - ny
    ex, ey = px - ox, py - oy
    dist2 = torch.where(hit, ex * ex + ey * ey, torch.full_like(ex, float("inf")))
    idx = torch.argmin(dist2, dim=1, keepdim=True)  # first minimum wins ties

    def pick(z):
        return torch.gather(z, 1, idx)[:, 0]

    return CollisionResult(
        hit=hit.any(dim=1),
        point=torch.stack([pick(px), pick(py)], dim=1),
        reflection=torch.stack([pick(rx), pick(ry)], dim=1),
    )


def resolve(walls: Walls, old: torch.Tensor, new: torch.Tensor,
            restitution: float) -> torch.Tensor:
    """Manual collision resolution with restitution + give-up fallback.

    Parity: `maze_env.py:457-464` — if old→new crosses a wall, slide to
    ``point + restitution * (reflection - point)``; if that position *also*
    crosses a wall from ``old``, give up and stay at ``old``.  Both
    detections always run (lockstep batch semantics).
    """
    c1 = detect(walls, old, new)
    bounced = c1.point + restitution * (c1.reflection - c1.point)
    c2 = detect(walls, old, bounced)
    corrected = torch.where(c2.hit[:, None], old, bounced)
    return torch.where(c1.hit[:, None], corrected, new)


def impedance_eject(walls: Walls, p: torch.Tensor, v: torch.Tensor,
                    margin: float, lam: float, dt: float, mu: float,
                    old: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-step contact-impedance velocity response at a wall overlap.

    The critically damped one-step map of the JAX package's
    ``segments.impedance_eject``::

        vn' = exp(-lam*dt) * (vn - lam*(vn - lam*pen)*dt)

    clamped to ``vn' >= vn``, with Coulomb-limited tangential slip
    ``|dvt| <= mu * dvn``.  ``old`` (the pre-move position) orients the
    signed distance, so a step that crosses a face reads deep penetration
    with an outward normal.  Returns the ``(B, 2)`` velocity delta summed
    over walls.
    """
    p1x, p1y, _, _, v1x, v1y, safe_n = _wall_frame(walls)
    qx, qy = p[:, 0:1], p[:, 1:2]
    t = torch.clamp(((qx - p1x) * v1x + (qy - p1y) * v1y) / safe_n, 0.0, 1.0)
    cx = p1x + t * v1x
    cy = p1y + t * v1y
    dx, dy = qx - cx, qy - cy
    dist = torch.sqrt(dx * dx + dy * dy + 1e-12)
    if old is not None:
        side = torch.sign((old[:, 0:1] - cx) * dx + (old[:, 1:2] - cy) * dy)
        side = torch.where(side == 0.0, torch.ones_like(side), side)
        dist = dist * side                                       # signed
    pen = torch.clamp(margin - dist, min=0.0) * walls.mask
    active = pen > 0.0
    adist = torch.abs(dist)
    nx, ny = dx / adist, dy / adist                              # outward n
    if old is not None:
        nx, ny = nx * side, ny * side
    vx, vy = v[:, 0:1], v[:, 1:2]
    vn = vx * nx + vy * ny
    decay = float(np.exp(-lam * dt))
    vn2 = decay * (vn - lam * (vn - lam * pen) * dt)
    zero = torch.zeros_like(vn)
    dvn = torch.where(active, torch.clamp(vn2 - vn, min=0.0), zero)
    tx, ty = -ny, nx
    vt = vx * tx + vy * ty
    dvt = -torch.sign(vt) * torch.minimum(torch.abs(vt), mu * dvn)
    dvt = torch.where(active, dvt, zero)
    return torch.stack([_sum_in_wall_order(dvn * nx + dvt * tx),
                        _sum_in_wall_order(dvn * ny + dvt * ty)], dim=1)


def tip_impedance_eject(walls: Walls, center: torch.Tensor, tip: torch.Tensor,
                        v3: torch.Tensor, theta: torch.Tensor, inflate: float,
                        lam: float, dt: float, m: float, a: float,
                        i_prime: float,
                        old: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact 3-dof impedance response for one off-center contact point.

    The arrow-box tip of the point robot pressing into a wall: segments are
    the RADIUS-inflated faces, so the physical face lies ``inflate`` beyond
    them; the tip penetrates by ``pen = -(s_d + inflate)``.  The dof
    response uses the closed-form inverse of the body mass matrix
    ``M = [[m, 0, -a sinθ], [0, m, a cosθ], [-a sinθ, a cosθ, I]]`` (see the
    JAX package's docstring).  Returns the ``(B, 3)`` qvel delta summed over
    walls.
    """
    if old is None:
        old = center
    p1x, p1y, _, _, v1x, v1y, safe_n = _wall_frame(walls)
    tx, ty = tip[:, 0:1], tip[:, 1:2]
    tt = torch.clamp(((tx - p1x) * v1x + (ty - p1y) * v1y) / safe_n, 0.0, 1.0)
    cx = p1x + tt * v1x
    cy = p1y + tt * v1y
    # outward normal: from the wall toward the pre-move position's side
    dcx, dcy = old[:, 0:1] - cx, old[:, 1:2] - cy
    dcn = torch.sqrt(dcx * dcx + dcy * dcy + 1e-12)
    nx, ny = dcx / dcn, dcy / dcn
    s_d = (tx - cx) * nx + (ty - cy) * ny
    pen = torch.clamp(-(s_d + inflate), min=0.0)
    pen = torch.where(walls.mask, pen, torch.zeros_like(pen))
    active = pen > 0.0
    rrx = tx - center[:, 0:1]
    rry = ty - center[:, 1:2]
    rxn = rrx * ny - rry * nx
    ux, uy = -torch.sin(theta)[:, None], torch.cos(theta)[:, None]
    un = nx * ux + ny * uy
    inv_m = 1.0 / m
    inv_ip = 1.0 / i_prime
    g = rxn - (a / m) * un
    A = inv_m + (g * g) * inv_ip
    vn = nx * v3[:, 0:1] + ny * v3[:, 1:2] + rxn * v3[:, 2:3]
    decay = float(np.exp(-lam * dt))
    vn2 = decay * (vn - lam * (vn - lam * pen) * dt)
    dvn = torch.where(active, torch.clamp(vn2 - vn, min=0.0),
                      torch.zeros_like(vn))
    f = dvn / A
    coef = a / (m * i_prime)
    dvx = f * (nx * inv_m - ux * coef * g)
    dvy = f * (ny * inv_m - uy * coef * g)
    dvr = f * g * inv_ip
    return torch.stack([_sum_in_wall_order(dvx), _sum_in_wall_order(dvy),
                        _sum_in_wall_order(dvr)], dim=1)


def pad_walls(segments: np.ndarray, max_walls: int, device=None) -> Walls:
    """Pad an ``(n, 2, 2)`` numpy segment soup to a fixed-size ``Walls``."""
    n = len(segments)
    if n > max_walls:
        raise ValueError(f"{n} wall segments exceed capacity {max_walls}")
    p1 = np.zeros((max_walls, 2), dtype=np.float32)
    p2 = np.zeros((max_walls, 2), dtype=np.float32)
    mask = np.zeros((max_walls,), dtype=bool)
    if n:
        p1[:n] = segments[:, 0]
        p2[:n] = segments[:, 1]
        mask[:n] = True
    return Walls(p1=torch.as_tensor(p1, device=device),
                 p2=torch.as_tensor(p2, device=device),
                 mask=torch.as_tensor(mask, device=device))
