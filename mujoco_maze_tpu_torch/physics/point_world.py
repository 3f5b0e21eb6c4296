"""The Point robot's object worlds: their data (numpy), and the exact
mj_step replica of the float64 fidelity path (batched PyTorch).

The data builders are those of ``mujoco_maze_tpu.physics.point_world``:

* :class:`PointWorldParams`: the robot's contact geometry and the contact
  constants of the world (``params_for_world``);
* :class:`WallBoxes`: the static boxes (BLOCK cells and elevated
  platforms);
* :class:`BallWorld` and :class:`BlockWorld`: the hinge balls and the
  movable blocks (falling blocks with their z slide and joint limits).

They give float32 arrays for the float32 path, whose object solve is
``ops/object_lanes.py``, and float64 arrays for the fidelity path.

The replica (JAX :199-643, :684-1053, :1135-1172, :1532) is MuJoCo's
``mj_step`` on the Point's planar system, stage by stage: the smooth
dynamics with the slide-hinge coupling of the arrow box; the sphere-box
and arrow-box contacts (separating axes and reference-face clipping) with
the bit-exact floor-contact switch; the pyramidal rows with MuJoCo's
impedance, reference accelerations and regularizer; the primal Newton
solve (10 Newton steps, 14 bisection steps of the line search); RK4.
``forward_world`` / ``rk4_step_world`` add the hinge balls and the x/y
blocks to the same solve.  Each function takes a batch ``(B, ...)``
where the JAX one took one env under ``vmap``.  Every sine and cosine goes
through :func:`.exact_trig.sincos` (libm's values, on which the floor
switch depends to the last bit); the 3x3 to 9x9 solves are
``torch.linalg`` (LAPACK on the CPU), which may differ from XLA's in the
last bits: PERF.md counts the line-search branches that this moves.

Copied, not imported, because importing any ``mujoco_maze_tpu`` module
imports JAX.  The JAX package's monolithic float32 object solve over these
tables (``object_forward``, ``rk4_object_step``) has no twin in the port:
``ops/object_lanes.py`` is the port's one object solve.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .exact_trig import sincos

F32 = np.float32


class WallBoxes(NamedTuple):
    """Static wall boxes (the maze's BLOCK cells and platforms), padded to
    at least one row, with a mask of the real ones."""

    c: np.ndarray     # (W, 3) centers
    h: np.ndarray     # (W, 3) half extents
    mask: np.ndarray  # (W,) 1.0 for real walls


@dataclasses.dataclass(frozen=True)
class PointWorldParams:
    """Constants derived from the Point model (point.xml, density 100) and
    the world builder's contact defaults (maze_env.py:102-112): sphere
    r = 0.5 at z = 0.5, arrow box half (0.5, 0.1, 0.1) at body offset
    (0.6, 0, 0.5), slide friction mu = 1, solimp the element-wise mean of
    the two geoms' (hardened to (.995, .995, .01) when movable blocks
    exist)."""

    dt: float = 0.02
    m_sphere: float = 100.0 * (4.0 / 3.0) * math.pi * 0.125
    m_box: float = 4.0
    arm: float = 4.0 * 0.6                    # a = m_box * offset
    inertia: float = (0.4 * 100.0 * (4.0 / 3.0) * math.pi * 0.125 * 0.25
                      + 4.0 * (1.0 + 0.04) / 12.0 + 4.0 * 0.36)
    sphere_r: float = 0.5
    sphere_z: float = 0.5
    arrow_off: float = 0.6
    arrow_half_l: float = 0.5
    arrow_half_w: float = 0.1
    arrow_z_lo: float = 0.4
    arrow_z_hi: float = 0.6
    mu: float = 1.0
    zeta: float = 1.0                          # solref dampratio
    tc: float = 0.04                           # max(solref_tc=0.02, 2*dt)
    dmin: float = 0.9
    dmax: float = 0.97
    width: float = 0.001
    f_dmin: float = 0.9
    f_dmax: float = 0.97
    f_width: float = 0.001
    newton_iters: int = 10
    ls_iters: int = 14
    max_contacts: int = 6

    @property
    def m(self) -> float:
        return self.m_sphere + self.m_box

    @property
    def r_scale(self) -> float:
        """R = r_scale * (1-d)/d  (pyramidal, both worlds' mu = 1)."""
        return 2.0 * (1.0 + self.mu * self.mu) * self.invw_t

    @property
    def invw_t(self) -> float:
        """MuJoCo ``body_invweight0`` (translational) of the robot body: the
        mean diagonal of the com-point translational inverse inertia at
        qpos0 (the z row is 0)."""
        m, a, i = self.m, self.arm, self.inertia
        det = m * i - a * a
        r = a / m
        a_yy = i / det - 2.0 * r * a / det + r * r * m / det
        return (1.0 / m + a_yy) / 3.0


def params_for_world(any_blocks: bool, dt: float = 0.02,
                     torso_z: float = 0.0) -> PointWorldParams:
    """Contact constants of a Point world (maze_env.py:108-112 hardening).

    ``torso_z``: the torso body's z offset, 0.75 + height_offset in
    elevated worlds (maze_env.py:105-107), 0 otherwise; the robot geoms
    ride the torso, so their contact heights shift with it."""
    kw = dict(dt=dt, sphere_z=0.5 + torso_z, arrow_z_lo=0.4 + torso_z,
              arrow_z_hi=0.6 + torso_z)
    if not any_blocks:
        return PointWorldParams(**kw)
    # default class solimp -> (.995, .995, .01); robot geoms keep (.9, .99)
    return PointWorldParams(
        dmin=(0.9 + 0.995) / 2, dmax=(0.99 + 0.995) / 2,
        width=(0.001 + 0.01) / 2,
        f_dmin=(0.9 + 0.995) / 2, f_dmax=(0.99 + 0.995) / 2,
        f_width=(0.001 + 0.01) / 2,
        **kw,
    )


def wall_boxes_from_structure(ms, dtype=F32) -> WallBoxes:
    """Static wall boxes of a maze (BLOCK cells, then elevated platforms)."""
    pos = np.concatenate([np.asarray(ms.block_pos).reshape(-1, 3),
                          np.asarray(ms.platform_pos).reshape(-1, 3)], 0)
    half = np.concatenate([np.asarray(ms.block_size).reshape(-1, 3),
                           np.asarray(ms.platform_size).reshape(-1, 3)], 0)
    n = max(len(pos), 1)
    c = np.zeros((n, 3))
    h = np.ones((n, 3)) * -1.0
    mask = np.zeros((n,))
    if len(pos):
        c[: len(pos)] = pos
        h[: len(pos)] = half
        mask[: len(pos)] = 1.0
    return WallBoxes(c=c.astype(dtype), h=h.astype(dtype),
                     mask=mask.astype(dtype))


class BallWorld(NamedTuple):
    """The hinge-type object balls (maze_env.py:489-536): per ball a body
    at ``body_pos`` with slide-x/slide-y/hinge-z joints and a sphere geom
    of radius ``r`` at (0, 0, r), mass 1e-4 r^3."""

    r: np.ndarray         # (nb,) radii
    mass: np.ndarray      # (nb,)
    inertia: np.ndarray   # (nb,) spin inertia about the hinge (2/5 m r^2)
    body_pos: np.ndarray  # (nb, 2) body origins (cell centers)

    @property
    def nb(self) -> int:
        return self.r.shape[0]


def ball_world_from_structure(ms, dtype=F32) -> BallWorld:
    pos = np.asarray([ob.pos for ob in ms.object_balls], np.float64)
    r = np.asarray([ob.size for ob in ms.object_balls], np.float64)
    mass = 1e-4 * r ** 3
    return BallWorld(r=r.astype(dtype), mass=mass.astype(dtype),
                     inertia=(0.4 * mass * r * r).astype(dtype),
                     body_pos=pos.reshape(-1, 2).astype(dtype))


class BlockWorld(NamedTuple):
    """The movable blocks (maze_env.py:563-648): axis-aligned boxes on
    slide joints, mass 2e-4 (push blocks, unlimited x/y slides) or 1e-3
    (falling blocks: limited x/y slides of +-size_scaling and a z slide
    limited to (-height_offset, 0), in ``lim``)."""

    half: np.ndarray          # (nb, 3) half extents
    mass: np.ndarray          # (nb,)
    body_pos: np.ndarray      # (nb, 3) body origins
    has_x: Tuple[bool, ...]
    has_y: Tuple[bool, ...]
    has_z: Tuple[bool, ...]
    # per block None, or ((xlo, xhi) | None, (ylo, yhi) | None,
    # (zlo, zhi) | None) joint-coordinate limits
    lim: Tuple

    @property
    def nb(self) -> int:
        return self.half.shape[0]


def block_world_from_structure(ms, dtype=F32,
                               allow_z: bool = False) -> Optional[BlockWorld]:
    """The block world of a maze, or None without movable blocks, with a
    spin block, or with a z (falling) block unless ``allow_z``: the
    float32 object solve models z blocks, the float64 replica leaves them
    to the quasi-static push (JAX :1093)."""
    specs = list(ms.movable_blocks)
    if not specs:
        return None
    for b in specs:
        if b.spin or (b.move_z and not allow_z):
            return None
    lims = []
    for b in specs:
        if b.falling:
            lims.append((
                (-float(b.xy_range), float(b.xy_range)) if b.move_x else None,
                (-float(b.xy_range), float(b.xy_range)) if b.move_y else None,
                (float(b.z_range[0]), float(b.z_range[1]))
                if b.move_z else None,
            ))
        else:
            lims.append(None)
    return BlockWorld(
        half=np.asarray([b.size for b in specs], np.float64).reshape(-1, 3).astype(dtype),
        mass=np.asarray([b.mass for b in specs], np.float64).astype(dtype),
        body_pos=np.asarray([b.pos for b in specs], np.float64).reshape(-1, 3).astype(dtype),
        has_x=tuple(bool(b.move_x) for b in specs),
        has_y=tuple(bool(b.move_y) for b in specs),
        has_z=tuple(bool(b.move_z) for b in specs),
        lim=tuple(lims),
    )


# ---------------------------------------------------------------------------
# the exact mj_step replica (float64), batched over envs
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _const(values: tuple, device: torch.device) -> torch.Tensor:
    """A float64 constant table on ``device``, copied there once."""
    return torch.tensor(values, dtype=torch.float64, device=device)


def boxes_on(boxes: WallBoxes, device) -> WallBoxes:
    """``boxes`` as float64 tensors on ``device``."""
    return WallBoxes(*(torch.as_tensor(np.asarray(a, np.float64),
                                       device=device) for a in boxes))


def _impedance(pen, dmin, dmax, width):
    """MuJoCo's solimp sigmoid (power 2, midpoint 0.5; JAX :199)."""
    x = torch.clamp(pen / width, 0.0, 1.0)
    y = torch.where(x < 0.5, 2.0 * x * x, 1.0 - 2.0 * (1.0 - x) * (1.0 - x))
    return dmin + y * (dmax - dmin)


class _Contacts(NamedTuple):
    """Candidate contacts ``(B, C, ...)`` (JAX :209)."""

    pos: torch.Tensor     # (B, C, 2) xy contact position (lever arms)
    n: torch.Tensor       # (B, C, 2) xy of the separation normal
    nz: torch.Tensor      # (B, C) z component of the normal
    pen: torch.Tensor     # (B, C) penetration (> 0 when touching)
    active: torch.Tensor  # (B, C) bool
    zmult: torch.Tensor   # (B, C) row multiplicity
    floor: torch.Tensor   # (B, C) 1.0 for the floor contact (f_* solimp)


def _cat(parts: List[_Contacts]) -> _Contacts:
    return _Contacts(*(torch.cat(f, dim=1) for f in zip(*parts)))


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _sign1(x):
    """``sign(where(x == 0, 1, x))``."""
    return torch.sign(torch.where(x == 0.0, torch.ones_like(x), x))


_FACE_N = ((-1.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, -1.0, 0.0),
           (0.0, 1.0, 0.0), (0.0, 0.0, -1.0), (0.0, 0.0, 1.0))


def _sphere_vs_boxes_r(boxes: WallBoxes, xy, radius, z_c) -> _Contacts:
    """Sphere of ``radius`` with its centre at ``(xy, z_c)`` vs boxes
    (``c``, ``h`` of shape ``(W, 3)`` or ``(B, W, 3)``): MuJoCo's shallow
    closest-point case and its deep nearest-face case, the z faces
    competing (JAX :221 and :1135)."""
    cx, cy = xy[:, 0:1], xy[:, 1:2]
    cz = torch.zeros_like(cx) + z_c
    lo = boxes.c - boxes.h
    hi = boxes.c + boxes.h
    qx = _clip(cx, lo[..., 0], hi[..., 0])
    qy = _clip(cy, lo[..., 1], hi[..., 1])
    qz = _clip(cz, lo[..., 2], hi[..., 2])
    dx, dy, dz = cx - qx, cy - qy, cz - qz
    d2 = dx * dx + dy * dy + dz * dz
    outside = d2 > 1e-24
    dist_out = torch.sqrt(torch.clamp(d2, min=1e-24))
    pen_out = radius - dist_out
    nox, noy, noz = dx / dist_out, dy / dist_out, dz / dist_out
    t_out = radius + (dist_out - radius) * 0.5
    px_out, py_out = cx - nox * t_out, cy - noy * t_out
    depths = torch.stack([cx - lo[..., 0], hi[..., 0] - cx,
                          cy - lo[..., 1], hi[..., 1] - cy,
                          cz - lo[..., 2], hi[..., 2] - cz], -1)
    face = torch.argmin(depths, -1)
    fdepth = depths.min(-1).values
    n_in = _const(_FACE_N, xy.device)[face]
    pen_in = fdepth + radius
    t_in = radius - pen_in * 0.5
    px_in = cx - n_in[..., 0] * t_in
    py_in = cy - n_in[..., 1] * t_in
    pen = torch.where(outside, pen_out, pen_in)
    nx = torch.where(outside, nox, n_in[..., 0])
    ny = torch.where(outside, noy, n_in[..., 1])
    nz = torch.where(outside, noz, n_in[..., 2])
    pos = torch.stack([torch.where(outside, px_out, px_in),
                       torch.where(outside, py_out, py_in)], -1)
    active = (pen > 0.0) & (boxes.mask > 0.0)
    return _Contacts(pos=pos, n=torch.stack([nx, ny], -1), nz=nz, pen=pen,
                     active=active, zmult=torch.ones_like(pen),
                     floor=torch.zeros_like(pen))


def _sphere_vs_boxes(p: PointWorldParams, boxes: WallBoxes, xy) -> _Contacts:
    """The robot's body sphere vs boxes (JAX :221)."""
    return _sphere_vs_boxes_r(boxes, xy, p.sphere_r, p.sphere_z)


def _dot2(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _gather(x, idx):
    """``take_along_axis`` over dim 2 of a ``(B, W, 4[, 2])`` tensor."""
    if x.dim() == idx.dim():
        return torch.gather(x, 2, idx)
    return torch.gather(x, 2, idx[..., None].expand(*idx.shape, x.shape[-1]))


_CORNER_SIGNS = ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0))


def _arrow_vs_boxes(p: PointWorldParams, boxes: WallBoxes, xy, ct,
                    st) -> _Contacts:
    """The arrow box (heading ``(ct, st)``) vs boxes: 5-axis separating
    axes and MuJoCo's reference-face contact generation, 2 points per box
    where a wall or arrow axis wins (z-duplicated, zmult 2), the arrow's
    footprint corners inside the box where the z axis wins (JAX :265)."""
    dev = xy.device
    B = xy.shape[0]
    u = torch.stack([ct, st], -1)                    # (B, 2)
    v = torch.stack([-st, ct], -1)
    ac = xy + u * p.arrow_off
    hl, hw = p.arrow_half_l, p.arrow_half_w
    az_c = 0.5 * (p.arrow_z_lo + p.arrow_z_hi)
    az_h = 0.5 * (p.arrow_z_hi - p.arrow_z_lo)
    W = max(boxes.c.shape[-2], boxes.h.shape[-2])
    bc = boxes.c[..., :2].expand(B, W, 2)
    bh = boxes.h[..., :2].expand(B, W, 2)
    uu, vv = u[:, None, :], v[:, None, :]            # (B, 1, 2)
    d = ac[:, None, :] - bc                          # (B, W, 2)
    ov_wx = (bh[..., 0] + hl * torch.abs(uu[..., 0]) + hw * torch.abs(vv[..., 0])
             - torch.abs(d[..., 0]))
    ov_wy = (bh[..., 1] + hl * torch.abs(uu[..., 1]) + hw * torch.abs(vv[..., 1])
             - torch.abs(d[..., 1]))
    du = _dot2(d, uu)
    dv = _dot2(d, vv)
    ov_u = (hl + bh[..., 0] * torch.abs(uu[..., 0])
            + bh[..., 1] * torch.abs(uu[..., 1]) - torch.abs(du))
    ov_v = (hw + bh[..., 0] * torch.abs(vv[..., 0])
            + bh[..., 1] * torch.abs(vv[..., 1]) - torch.abs(dv))
    ov_z = (boxes.h[..., 2] + az_h - torch.abs(az_c - boxes.c[..., 2])
            ).expand(B, W)
    ovs = torch.stack([ov_wx, ov_wy, ov_u, ov_v, ov_z], -1)    # (B, W, 5)
    overlap_all = (ovs > 0.0).all(-1) & (boxes.mask > 0.0)
    axis = torch.argmin(ovs, -1)
    z_wins = axis == 4
    sgn_wx, sgn_wy = _sign1(d[..., 0]), _sign1(d[..., 1])
    sgn_u, sgn_v = _sign1(du), _sign1(dv)
    normals = torch.stack([
        torch.stack([1.0 * sgn_wx, 0.0 * sgn_wx], -1),
        torch.stack([0.0 * sgn_wy, 1.0 * sgn_wy], -1),
        uu * sgn_u[..., None],
        vv * sgn_v[..., None],
    ], 2)                                                      # (B, W, 4, 2)
    axy = torch.clamp(axis, max=3)
    n = _gather(normals, axy[..., None])[:, :, 0]              # (B, W, 2)
    signs = _const(_CORNER_SIGNS, dev)                         # (4, 2)
    corners = (ac[:, None, :] + signs[None, :, :1] * u[:, None, :] * hl
               + signs[None, :, 1:] * v[:, None, :] * hw)      # (B, 4, 2)
    corners = corners[:, None].expand(B, W, 4, 2)
    face_off = _dot2(bc, n) + (bh[..., 0] * torch.abs(n[..., 0])
                               + bh[..., 1] * torch.abs(n[..., 1]))
    corner_s = _dot2(corners, n[:, :, None, :])
    corner_pen = face_off[..., None] - corner_s               # (B, W, 4)
    ex = torch.stack([bh[..., 0] * 1.0, bh[..., 0] * 0.0], -1)  # bh_x * ex
    ey = torch.stack([bh[..., 1] * 0.0, bh[..., 1] * 1.0], -1)  # bh_y * ey
    wall_corners = (bc[:, :, None, :] + signs[None, None, :, :1] * ex[:, :, None, :]
                    + signs[None, None, :, 1:] * ey[:, :, None, :])
    half_along = (hl * torch.abs(_dot2(n, uu))
                  + hw * torch.abs(_dot2(n, vv)))
    a_face_off = _dot2(ac[:, None, :], n) - half_along
    wall_pen = _dot2(wall_corners, n[:, :, None, :]) - a_face_off[..., None]
    is_wall_axis = axis < 2
    pens = torch.where(is_wall_axis[..., None], corner_pen, wall_pen)
    pts = torch.where(is_wall_axis[..., None, None], corners, wall_corners)
    # incident-edge corners (MuJoCo box-box)
    cu = _dot2(n, uu)
    cv = _dot2(n, vv)
    su_i = -_sign1(cu)
    sv_i = -_sign1(cv)
    i01 = _const((0.0, 1.0), dev).long()
    i23 = _const((2.0, 3.0), dev).long()
    i02 = _const((0.0, 2.0), dev).long()
    i13 = _const((1.0, 3.0), dev).long()
    iu = torch.where(su_i[..., None] > 0, i01, i23)
    iv = torch.where(sv_i[..., None] > 0, i02, i13)
    inc_wall = torch.where((torch.abs(cu) >= torch.abs(cv))[..., None], iu, iv)
    sx_i = _sign1(n[..., 0])
    sy_i = _sign1(n[..., 1])
    ix = torch.where(sx_i[..., None] > 0, i01, i23)
    iy = torch.where(sy_i[..., None] > 0, i02, i13)
    inc_arrow = torch.where(
        (torch.abs(n[..., 0]) >= torch.abs(n[..., 1]))[..., None], ix, iy)
    top2 = torch.where(is_wall_axis[..., None], inc_wall, inc_arrow)
    pen2 = _gather(pens, top2)                                 # (B, W, 2)
    pt2 = _gather(pts, top2)                                   # (B, W, 2, 2)
    t = torch.stack([-n[..., 1], n[..., 0]], -1)
    ref_c = torch.where(is_wall_axis[..., None], bc, ac[:, None, :])
    ref_ht = torch.where(
        is_wall_axis,
        bh[..., 0] * torch.abs(t[..., 0]) + bh[..., 1] * torch.abs(t[..., 1]),
        hl * torch.abs(_dot2(t, uu)) + hw * torch.abs(_dot2(t, vv)))
    s = _dot2(pt2 - ref_c[:, :, None, :], t[:, :, None, :])   # (B, W, 2)
    s_cl = _clip(s, -ref_ht[..., None], ref_ht[..., None])
    edge = pt2[:, :, 1] - pt2[:, :, 0]
    edge_s = _dot2(edge, t)
    edge_pen = pen2[..., 1] - pen2[..., 0]
    slope = torch.where(torch.abs(edge_s) > 1e-9, edge_pen / edge_s,
                        torch.zeros_like(edge_s))
    pen_cl = pen2 + (s_cl - s) * slope[..., None]
    pt_cl = pt2 + (s_cl - s)[..., None] * t[:, :, None, :]
    pos_sgn = torch.where(is_wall_axis, torch.full_like(half_along, 0.5),
                          torch.full_like(half_along, -0.5))
    pos = pt_cl + n[:, :, None, :] * (pen_cl * pos_sgn[..., None])[..., None]
    was_clipped = torch.abs(s_cl - s) > 1e-12
    h_ref = torch.where(
        is_wall_axis,
        bh[..., 0] * torch.abs(n[..., 0]) + bh[..., 1] * torch.abs(n[..., 1]),
        half_along)
    c1 = 0.02 * h_ref
    c2 = c1 / 1.01
    depmax = torch.where(pen_cl > 0.0, pen_cl,
                         torch.full_like(pen_cl, -math.inf)).max(-1).values
    thresh = torch.where(depmax <= c1, torch.zeros_like(c2), c2)
    keep_corner = pen_cl > thresh[..., None]
    keep_clip = (pen_cl > 0.0) & ((depmax[..., None] - pen_cl)
                                  <= 2.0 * h_ref[..., None])
    keep = torch.where(was_clipped, keep_clip, keep_corner)
    active_xy = overlap_all[..., None] & keep & (~z_wins[..., None])
    zero2 = torch.zeros_like(pen_cl)
    xy_con = _Contacts(
        pos=pos.reshape(B, 2 * W, 2),
        n=n[:, :, None, :].expand(B, W, 2, 2).reshape(B, 2 * W, 2),
        nz=zero2.reshape(B, 2 * W), pen=pen_cl.reshape(B, 2 * W),
        active=active_xy.reshape(B, 2 * W),
        zmult=(zero2 + 2.0).reshape(B, 2 * W), floor=zero2.reshape(B, 2 * W))
    in_foot = ((torch.abs(corners[..., 0] - bc[..., None, 0]) <= bh[..., None, 0])
               & (torch.abs(corners[..., 1] - bc[..., None, 1])
                  <= bh[..., None, 1]))                        # (B, W, 4)
    cz = boxes.c[..., 2]
    nz_sgn = torch.sign(torch.where(az_c == cz, torch.full_like(cz, -1.0),
                                    az_c - cz)).expand(B, W)
    active_z = overlap_all[..., None] & z_wins[..., None] & in_foot
    zero4 = torch.zeros((B, W, 4), dtype=xy.dtype, device=dev)
    z_con = _Contacts(
        pos=corners.reshape(B, 4 * W, 2),
        n=torch.zeros((B, 4 * W, 2), dtype=xy.dtype, device=dev),
        nz=(zero4 + nz_sgn[..., None]).reshape(B, 4 * W),
        pen=(zero4 + ov_z[..., None]).reshape(B, 4 * W),
        active=active_z.reshape(B, 4 * W),
        zmult=(zero4 + 1.0).reshape(B, 4 * W),
        floor=zero4.reshape(B, 4 * W))
    return _cat([xy_con, z_con])


def _floor_switch(c_half, s_half):
    """MuJoCo's bit-exact inclusion predicate of a z = const contact (JAX
    :727): ``dist = fl(0.5 * fl(fl(c*c) + fl(s*s))) - 0.5``, active iff it
    rounds below 0; ``c, s`` the cosine and sine of half the hinge angle.
    Returns ``(active, -dist)``."""
    m22 = c_half * c_half + s_half * s_half
    dist = 0.5 * m22 - 0.5
    return dist < 0.0, -dist


def _floor_contact(xy, c_half, s_half) -> _Contacts:
    """The robot sphere's floor contact: pure friction rows (JAX :452)."""
    active, pen = _floor_switch(c_half, s_half)
    one = torch.ones_like(pen)
    return _Contacts(
        pos=xy[:, None, :], n=torch.zeros_like(xy)[:, None, :],
        nz=one[:, None], pen=pen[:, None], active=active[:, None],
        zmult=one[:, None], floor=one[:, None])


def _gather_contacts(p: PointWorldParams, boxes: WallBoxes, xy, ct, st,
                     c_half, s_half) -> _Contacts:
    """The robot's candidates: sphere and arrow vs the walls, the top
    ``max_contacts`` by penetration among the active ones (a stable sort:
    ties, the inactive ones at -inf among them, keep their order), then
    the floor (JAX :471)."""
    cand = _cat([_sphere_vs_boxes(p, boxes, xy),
                 _arrow_vs_boxes(p, boxes, xy, ct, st)])
    score = torch.where(cand.active, cand.pen,
                        torch.full_like(cand.pen, -math.inf))
    k = min(p.max_contacts, score.shape[1])
    idx = torch.argsort(-score, dim=1, stable=True)[:, :k]
    top = _Contacts(*(torch.gather(f, 1, idx) if f.dim() == 2 else
                      torch.gather(f, 1, idx[..., None].expand(-1, -1, 2))
                      for f in cand))
    return _cat([top, _floor_contact(xy, c_half, s_half)])


def _make_frame(n2, nz):
    """MuJoCo ``mju_makeFrame`` tangents of the contact normals (JAX
    :492): ``(n3, t1, t2)``, each ``(..., 3)``."""
    ny = n2[..., 1]
    near_y = torch.abs(ny) > 0.99995
    t1x_a = -n2[..., 0] * ny
    t1y_a = 1.0 - ny * ny
    t1z_a = -nz * ny
    nrm_a = torch.sqrt(t1x_a * t1x_a + t1y_a * t1y_a + t1z_a * t1z_a + 1e-30)
    zero, one = torch.zeros_like(ny), torch.ones_like(ny)
    t1 = torch.where(near_y[..., None], torch.stack([zero, zero, one], -1),
                     torch.stack([t1x_a / nrm_a, t1y_a / nrm_a,
                                  t1z_a / nrm_a], -1))
    n3 = torch.stack([n2[..., 0], ny, nz], -1)
    t2 = torch.stack([n3[..., 1] * t1[..., 2] - n3[..., 2] * t1[..., 1],
                      n3[..., 2] * t1[..., 0] - n3[..., 0] * t1[..., 2],
                      n3[..., 0] * t1[..., 1] - n3[..., 1] * t1[..., 0]], -1)
    return n3, t1, t2


def _body_jac3(d3, pos_xy, origin_xy):
    """``(..., 3)`` Jacobian of direction ``d3`` at ``pos_xy`` for a planar
    slide-slide-hinge body hinged at ``origin_xy`` (JAX :718)."""
    r = pos_xy - origin_xy
    return torch.stack([d3[..., 0], d3[..., 1],
                        -r[..., 1] * d3[..., 0] + r[..., 0] * d3[..., 1]], -1)


class _Rows(NamedTuple):
    J: torch.Tensor      # (B, R, nd)
    aref: torch.Tensor   # (B, R)
    rinv: torch.Tensor   # (B, R)


def _pyramid_rows(p, jn, jt1, jt2, pen, v, active, zmult, dmin, dmax, width,
                  invw, mu) -> _Rows:
    """Pyramid rows ``J_n -+ mu J_t`` (4 per contact) of per-contact
    Jacobians ``(B, K, nd)``, with MuJoCo's impedance, reference
    acceleration and regularizer (JAX :684)."""
    J = torch.stack([jn - mu * jt1, jn + mu * jt1,
                     jn - mu * jt2, jn + mu * jt2], 2)         # (B, K, 4, nd)
    d_imp = _impedance(pen, dmin, dmax, width)
    k = d_imp / (dmax * dmax * p.tc * p.tc * p.zeta * p.zeta)
    b = 2.0 / (dmax * p.tc)
    vrow = (J @ v[:, None, :, None])[..., 0]                   # (B, K, 4)
    if torch.is_tensor(b):
        b = b[..., None]
    aref = -b * vrow + (k * pen)[..., None]
    r_scale = 2.0 * (1.0 + mu * mu) * invw
    rinv = (d_imp / (1.0 - d_imp)) / r_scale * zmult
    rinv = torch.where(active, rinv, torch.zeros_like(rinv))
    B_, K = pen.shape
    return _Rows(J=J.reshape(B_, 4 * K, J.shape[-1]),
                 aref=aref.reshape(B_, 4 * K),
                 rinv=rinv[..., None].expand(B_, K, 4).reshape(B_, 4 * K))


def _mass_matrix(p: PointWorldParams, s, c):
    """``(B, 3, 3)`` M of the robot at heading ``(c, s)`` (JAX :551)."""
    a = p.arm
    m = torch.full_like(s, p.m)
    zero = torch.zeros_like(s)
    return torch.stack([
        torch.stack([m, zero, -a * s], -1),
        torch.stack([zero, m, a * c], -1),
        torch.stack([-a * s, a * c, torch.full_like(s, p.inertia)], -1),
    ], 1)


def _matvec(A, x):
    return (A @ x[..., None])[..., 0]


def _qacc_smooth(p: PointWorldParams, w, c, s, minv):
    """``M^-1`` times the centrifugal bias (JAX :561)."""
    bias = torch.stack([p.arm * w * w * c, p.arm * w * w * s,
                        torch.zeros_like(w)], -1)
    return _matvec(minv, bias)


def _solve_newton(p: PointWorldParams, M, a0, J, aref, rinv,
                  solve=torch.linalg.solve, branches=None):
    """MuJoCo's primal Newton on its convex piecewise-quadratic cost, the
    raw (unpreconditioned) solve of the float64 path (JAX :568):
    ``newton_iters`` steps, each with a bisection line search of
    ``ls_iters`` steps on the cost's monotone derivative.  ``solve`` takes
    the Newton direction; ``branches``, a list where given, receives each
    line-search decision ``(B,)`` bool in order (for measuring how the
    solve's last bits move them)."""
    Jt = J.transpose(1, 2)

    def weights(x):
        jar = _matvec(J, x) - aref
        wrow = torch.where((jar < 0.0) & (rinv > 0.0), rinv,
                           torch.zeros_like(rinv))
        return jar, wrow

    def phi_prime(x, pdir, jp, t):
        xt = x + t[:, None] * pdir
        jar, wrow = weights(xt)
        return ((pdir * _matvec(M, xt - a0)).sum(-1)
                + (jp * (wrow * jar)).sum(-1))

    x = a0
    for _ in range(p.newton_iters):
        jar, wrow = weights(x)
        grad = _matvec(M, x - a0) + _matvec(Jt, wrow * jar)
        H = M + (Jt * wrow[:, None, :]) @ J
        pdir = -solve(H, grad)
        jp = _matvec(J, pdir)
        lo = torch.zeros_like(x[:, 0])
        hi = torch.full_like(lo, 2.0)
        far = phi_prime(x, pdir, jp, hi) < 0.0
        hi = torch.where(far, torch.full_like(hi, 4.0), hi)
        if branches is not None:
            branches.append(far)
        for _ in range(p.ls_iters):
            mid = 0.5 * (lo + hi)
            dneg = phi_prime(x, pdir, jp, mid) < 0.0
            if branches is not None:
                branches.append(dneg)
            lo = torch.where(dneg, mid, lo)
            hi = torch.where(dneg, hi, mid)
        t = 0.5 * (lo + hi)
        x = x + t[:, None] * pdir
    return x


def _rows_from_contacts(p: PointWorldParams, con: _Contacts, xy, v,
                        pad=lambda j: j) -> _Rows:
    """The robot's pyramid rows of its candidates ``con`` (JAX :523), the
    floor contact with its own solimp; ``pad`` widens each Jacobian to
    the world's dofs."""
    n3, t1, t2 = _make_frame(con.n, con.nz)
    xy1 = xy[:, None, :]
    is_f = con.floor > 0.0

    def pick(f_val, val):
        return torch.where(is_f, torch.full_like(con.pen, f_val),
                           torch.full_like(con.pen, val))

    return _pyramid_rows(
        p, pad(_body_jac3(n3, con.pos, xy1)), pad(_body_jac3(t1, con.pos, xy1)),
        pad(_body_jac3(t2, con.pos, xy1)), con.pen, v, con.active, con.zmult,
        pick(p.f_dmin, p.dmin), pick(p.f_dmax, p.dmax),
        pick(p.f_width, p.width), p.invw_t, p.mu)


def forward(p: PointWorldParams, boxes: WallBoxes, q, v):
    """qacc(q, v) of the robot alone: the smooth dynamics and the contact
    solve (one mj_forward; JAX :616)."""
    th = q[:, 2]
    s, c = sincos(th)
    s_half, c_half = sincos(0.5 * th)
    M = _mass_matrix(p, s, c)
    a0 = _qacc_smooth(p, v[:, 2], c, s, torch.linalg.inv(M))
    con = _gather_contacts(p, boxes, q[:, :2], c, s, c_half, s_half)
    rows = _rows_from_contacts(p, con, q[:, :2], v)
    qacc = _solve_newton(p, M, a0, rows.J, rows.aref, rows.rinv)
    return torch.where((rows.rinv > 0.0).any(-1, keepdim=True), qacc, a0)


def _rk4(fwd, q, v, dt):
    """The RK4 tableau of mj_step (A = [1/2, 1/2, 1], B = [1/6, 1/3, 1/3,
    1/6]; JAX :629)."""
    A = (0.5, 0.5, 1.0)
    Bw = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
    vs = [v]
    accs = [fwd(q, v)]
    for a in A:
        qi = q + a * dt * vs[-1]
        vi = v + a * dt * accs[-1]
        vs.append(vi)
        accs.append(fwd(qi, vi))
    qs = Bw[0] * vs[0]
    vsum = Bw[0] * accs[0]
    for b, vi, ai in zip(Bw[1:], vs[1:4], accs[1:]):
        qs = qs + b * vi
        vsum = vsum + b * ai
    return q + dt * qs, v + dt * vsum


def rk4_step(p: PointWorldParams, boxes: WallBoxes, q, v):
    """One mj_step of the robot alone, ``q, v (B, 3)`` (JAX :629)."""
    return _rk4(lambda qi, vi: forward(p, boxes, qi, vi), q, v, p.dt)


def _aabb_vs_boxes(center3, half3, boxes: WallBoxes) -> _Contacts:
    """An axis-aligned moving box (``center3 (B, 3)``, ``half3`` three
    floats) vs boxes: parallel faces along the least xy overlap, two points
    at the ends of the tangential overlap, z-duplicated (zmult 2; JAX
    :1008)."""
    c = boxes.c
    d = center3[:, None, :2] - c[..., :2]
    ox = boxes.h[..., 0] + half3[0] - torch.abs(d[..., 0])
    oy = boxes.h[..., 1] + half3[1] - torch.abs(d[..., 1])
    oz = boxes.h[..., 2] + half3[2] - torch.abs(center3[:, None, 2] - c[..., 2])
    use_x = ox <= oy
    pen = torch.where(use_x, ox, oy)
    sgn = torch.where(use_x, _sign1(d[..., 0]), _sign1(d[..., 1]))
    zero = torch.zeros_like(sgn)
    n2 = torch.where(use_x[..., None], torch.stack([sgn, zero], -1),
                     torch.stack([zero, sgn], -1))
    cx, cy = center3[:, None, 0], center3[:, None, 1]
    half_n = torch.where(use_x, torch.full_like(pen, half3[0]),
                         torch.full_like(pen, half3[1]))
    ctr_n = torch.where(use_x, cx, cy)
    face_blk = ctr_n * sgn - half_n
    pos_n = (face_blk + pen * 0.5) * sgn
    half_t = torch.where(use_x, torch.full_like(pen, half3[1]),
                         torch.full_like(pen, half3[0]))
    ctr_t = torch.where(use_x, cy, cx)
    w_t = torch.where(use_x, boxes.h[..., 1], boxes.h[..., 0])
    wc_t = torch.where(use_x, c[..., 1], c[..., 0])
    t_lo = torch.maximum(ctr_t - half_t, wc_t - w_t)
    t_hi = torch.minimum(ctr_t + half_t, wc_t + w_t)

    def mk(t):
        return torch.where(use_x[..., None], torch.stack([pos_n, t], -1),
                           torch.stack([t, pos_n], -1))

    active = (pen > 0.0) & (oz > 0.0) & (t_hi > t_lo) & (boxes.mask > 0.0)
    pen2 = torch.cat([pen, pen], 1)
    return _Contacts(pos=torch.cat([mk(t_lo), mk(t_hi)], 1),
                     n=torch.cat([n2, n2], 1), nz=torch.zeros_like(pen2),
                     pen=pen2, active=torch.cat([active, active], 1),
                     zmult=torch.zeros_like(pen2) + 2.0,
                     floor=torch.zeros_like(pen2))


def _one_box(center3, half3) -> WallBoxes:
    """A moving box as a one-box ``WallBoxes`` of per-env centres."""
    h = _const(tuple(float(x) for x in half3), center3.device)
    return WallBoxes(c=center3[:, None, :], h=h[None, :],
                     mask=_const((1.0,), center3.device))


def forward_world(p: PointWorldParams, boxes: WallBoxes, balls, q, v,
                  blocks=None):
    """qacc of the composed world, ``q, v (B, nd)``: the robot (3 dofs), the
    hinge balls (x, y, rot each) and the x/y blocks (their slides), all in
    one contact solve (JAX :738).  Rows: the robot vs the walls and its
    floor switch; per ball, vs the walls, its floor switch, the robot's
    sphere, the arrow and the earlier balls; per block, the robot's sphere,
    the arrow, the walls, the earlier blocks and the balls."""
    dev, dtype = q.device, q.dtype
    Bn = q.shape[0]
    nb = balls.nb if balls is not None else 0
    nk = blocks.nb if blocks is not None else 0
    off = 3 + 3 * nb
    blk_cols = []
    for k in range(nk):
        cols = {}
        if blocks.has_x[k]:
            cols["x"], off = off, off + 1
        if blocks.has_y[k]:
            cols["y"], off = off, off + 1
        blk_cols.append(cols)
    nd = off
    th = q[:, 2]
    xy = q[:, :2]
    s, c = sincos(th)
    s_half, c_half = sincos(0.5 * th)
    M3 = _mass_matrix(p, s, c)
    diag = [0.0] * nd
    for i in range(nb):
        o = 3 + 3 * i
        diag[o:o + 3] = [float(balls.mass[i]), float(balls.mass[i]),
                         float(balls.inertia[i])]
    for k in range(nk):
        for col in blk_cols[k].values():
            diag[col] = float(blocks.mass[k])
    M = torch.diag_embed(_const(tuple(diag), dev)).expand(Bn, nd, nd).clone()
    M[:, :3, :3] = M3
    a0 = torch.zeros((Bn, nd), dtype=dtype, device=dev)
    a0[:, :3] = _qacc_smooth(p, v[:, 2], c, s, torch.linalg.inv(M3))

    def put(j3, o):
        out = torch.zeros((*j3.shape[:-1], nd), dtype=dtype, device=dev)
        out[..., o:o + 3] = j3
        return out

    invw_r = p.invw_t
    rows = [_rows_from_contacts(
        p, _gather_contacts(p, boxes, xy, c, s, c_half, s_half), xy, v,
        lambda j: put(j, 0))]
    bb_dmin, bb_dmax, bb_width = 0.9, 0.99, 0.001
    ctrs = []
    for i in range(nb):
        o = 3 + 3 * i
        ctr = torch.stack([float(balls.body_pos[i, 0]) + q[:, o],
                           float(balls.body_pos[i, 1]) + q[:, o + 1]], -1)
        ctrs.append(ctr)
        r_b = float(balls.r[i])
        invw_b = 2.0 / (3.0 * float(balls.mass[i]))
        c1 = ctr[:, None, :]
        # the ball vs the walls
        bw = _sphere_vs_boxes_r(boxes, ctr, r_b, r_b)
        f = _make_frame(bw.n, bw.nz)
        rows.append(_pyramid_rows(
            p, *(put(_body_jac3(d, bw.pos, c1), o) for d in f),
            bw.pen, v, bw.active, bw.zmult, p.dmin, p.dmax, p.width, invw_b,
            p.mu))
        # its floor switch: pure friction rows at zero lever
        bs_half, bc_half = sincos(0.5 * q[:, o + 2])
        fact, fpen = _floor_switch(bc_half, bs_half)
        frame = [_const(d, dev).expand(Bn, 1, 3) for d in
                 ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (-1.0, 0.0, 0.0))]
        rows.append(_pyramid_rows(
            p, *(put(_body_jac3(d, c1, c1), o) for d in frame),
            fpen[:, None], v, fact[:, None],
            torch.ones((Bn, 1), dtype=dtype, device=dev),
            p.f_dmin, p.f_dmax, p.f_width, invw_b, p.mu))
        # the robot's body sphere vs the ball (centres at sphere_z and r_b)
        d3 = torch.stack([ctr[:, 0] - xy[:, 0], ctr[:, 1] - xy[:, 1],
                          torch.zeros_like(th) + (r_b - p.sphere_z)], -1)
        dist3 = torch.sqrt(d3[:, 0] * d3[:, 0] + d3[:, 1] * d3[:, 1]
                           + d3[:, 2] * d3[:, 2] + 1e-30)
        nrm = d3 / dist3[:, None]
        pen_rb = (p.sphere_r + r_b) - dist3
        t_mid = p.sphere_r + (dist3 - p.sphere_r - r_b) * 0.5
        pos_rb = (xy + nrm[:, :2] * t_mid[:, None])[:, None, :]
        f = _make_frame(nrm[:, None, :2], nrm[:, None, 2])
        rows.append(_pyramid_rows(
            p, *(put(_body_jac3(d, pos_rb, c1), o)
                 - put(_body_jac3(d, pos_rb, xy[:, None, :]), 0) for d in f),
            pen_rb[:, None], v, (pen_rb > 0.0)[:, None],
            torch.ones((Bn, 1), dtype=dtype, device=dev),
            bb_dmin, bb_dmax, bb_width, invw_r + invw_b, p.mu))
        # the arrow box vs the ball, in the arrow's frame
        u = torch.stack([c, s], -1)
        w_ax = torch.stack([-s, c], -1)
        ac = xy + u * p.arrow_off
        rel = ctr - ac
        bx, by = _dot2(rel, u), _dot2(rel, w_ax)
        bz = r_b - 0.5 * (p.arrow_z_lo + p.arrow_z_hi)
        hx, hy = p.arrow_half_l, p.arrow_half_w
        hz = 0.5 * (p.arrow_z_hi - p.arrow_z_lo)
        cx = torch.clamp(bx, -hx, hx)
        cy = torch.clamp(by, -hy, hy)
        cz = min(max(bz, -hz), hz)
        ddx, ddy, ddz = bx - cx, by - cy, bz - cz
        dd2 = ddx * ddx + ddy * ddy + ddz * ddz
        dl = torch.sqrt(torch.clamp(dd2, min=1e-30))
        pen_ab = r_b - dl
        nf0, nf1, nf2 = ddx / dl, ddy / dl, ddz / dl
        n_world = torch.stack([nf0 * u[:, 0] + nf1 * w_ax[:, 0],
                               nf0 * u[:, 1] + nf1 * w_ax[:, 1], nf2], -1)
        t_ab = r_b + (dl - r_b) * 0.5
        pos_ab = (ctr - n_world[:, :2] * t_ab[:, None])[:, None, :]
        f = _make_frame(n_world[:, None, :2], n_world[:, None, 2])
        rows.append(_pyramid_rows(
            p, *(put(_body_jac3(d, pos_ab, c1), o)
                 - put(_body_jac3(d, pos_ab, xy[:, None, :]), 0) for d in f),
            pen_ab[:, None], v, (pen_ab > 0.0)[:, None],
            torch.ones((Bn, 1), dtype=dtype, device=dev),
            bb_dmin, bb_dmax, bb_width, invw_r + invw_b, p.mu))
        # the ball vs the earlier balls
        for jp in range(i):
            o2 = 3 + 3 * jp
            ctr2 = ctrs[jp]
            r2 = float(balls.r[jp])
            d3b = torch.stack([ctr[:, 0] - ctr2[:, 0], ctr[:, 1] - ctr2[:, 1],
                               torch.zeros_like(th) + (r_b - r2)], -1)
            distb = torch.sqrt(d3b[:, 0] * d3b[:, 0] + d3b[:, 1] * d3b[:, 1]
                               + d3b[:, 2] * d3b[:, 2] + 1e-30)
            nb3 = d3b / distb[:, None]
            pen_bb = (r_b + r2) - distb
            pos_bb = (ctr2 + nb3[:, :2] * (r2 + (distb - r2 - r_b) * 0.5)[:, None]
                      )[:, None, :]
            f = _make_frame(nb3[:, None, :2], nb3[:, None, 2])
            invw_b2 = 2.0 / (3.0 * float(balls.mass[jp]))
            rows.append(_pyramid_rows(
                p, *(put(_body_jac3(d, pos_bb, c1), o)
                     - put(_body_jac3(d, pos_bb, ctr2[:, None, :]), o2)
                     for d in f),
                pen_bb[:, None], v, (pen_bb > 0.0)[:, None],
                torch.ones((Bn, 1), dtype=dtype, device=dev),
                bb_dmin, bb_dmax, bb_width, invw_b + invw_b2, p.mu))

    # the x/y blocks: both geoms of a block-wall pair carry the hardened
    # default class (maze_env.py:108-112)
    blw_dmin, blw_dmax, blw_width = 0.995, 0.995, 0.01
    blk_ctr = []
    for k in range(nk):
        cols = blk_cols[k]
        zero = torch.zeros_like(th)
        blk_ctr.append(torch.stack([
            float(blocks.body_pos[k, 0]) + (q[:, cols["x"]] if "x" in cols else zero),
            float(blocks.body_pos[k, 1]) + (q[:, cols["y"]] if "y" in cols else zero),
            float(blocks.body_pos[k, 2]) + zero], -1))

    def blk_jac(k, d3):
        out = torch.zeros((*d3.shape[:-1], nd), dtype=dtype, device=dev)
        if "x" in blk_cols[k]:
            out[..., blk_cols[k]["x"]] = d3[..., 0]
        if "y" in blk_cols[k]:
            out[..., blk_cols[k]["y"]] = d3[..., 1]
        return out

    for k in range(nk):
        ctr3 = blk_ctr[k]
        half = tuple(float(x) for x in blocks.half[k])
        one_box = _one_box(ctr3, half)
        invw_k = 1.0 / float(blocks.mass[k])
        xy1 = xy[:, None, :]
        # the robot's body sphere vs the block
        sb = _sphere_vs_boxes_r(one_box, xy, p.sphere_r, p.sphere_z)
        rows.append(_pyramid_rows(
            p, *(put(_body_jac3(d, sb.pos, xy1), 0) - blk_jac(k, d)
                 for d in _make_frame(sb.n, sb.nz)),
            sb.pen, v, sb.active, sb.zmult, p.dmin, p.dmax, p.width,
            invw_r + invw_k, p.mu))
        # the arrow vs the block
        ab = _arrow_vs_boxes(p, one_box, xy, c, s)
        rows.append(_pyramid_rows(
            p, *(put(_body_jac3(d, ab.pos, xy1), 0) - blk_jac(k, d)
                 for d in _make_frame(ab.n, ab.nz)),
            ab.pen, v, ab.active, ab.zmult, p.dmin, p.dmax, p.width,
            invw_r + invw_k, p.mu))
        # the block vs the static walls
        bwc = _aabb_vs_boxes(ctr3, half, boxes)
        rows.append(_pyramid_rows(
            p, *(blk_jac(k, d) for d in _make_frame(bwc.n, bwc.nz)),
            bwc.pen, v, bwc.active, bwc.zmult, blw_dmin, blw_dmax, blw_width,
            invw_k, p.mu))
        # the block vs the earlier blocks
        for kp in range(k):
            other = _one_box(blk_ctr[kp], tuple(float(x) for x in blocks.half[kp]))
            bb = _aabb_vs_boxes(ctr3, half, other)
            rows.append(_pyramid_rows(
                p, *(blk_jac(k, d) - blk_jac(kp, d)
                     for d in _make_frame(bb.n, bb.nz)),
                bb.pen, v, bb.active, bb.zmult, blw_dmin, blw_dmax, blw_width,
                invw_k + 1.0 / float(blocks.mass[kp]), p.mu))
        # the balls vs the block
        for i in range(nb):
            o = 3 + 3 * i
            r_i = float(balls.r[i])
            blb = _sphere_vs_boxes_r(one_box, ctrs[i], r_i, r_i)
            rows.append(_pyramid_rows(
                p, *(put(_body_jac3(d, blb.pos, ctrs[i][:, None, :]), o)
                     - blk_jac(k, d) for d in _make_frame(blb.n, blb.nz)),
                blb.pen, v, blb.active, blb.zmult, p.dmin, p.dmax, p.width,
                2.0 / (3.0 * float(balls.mass[i])) + invw_k, p.mu))

    J = torch.cat([r.J for r in rows], 1)
    aref = torch.cat([r.aref for r in rows], 1)
    rinv = torch.cat([r.rinv for r in rows], 1)
    qacc = _solve_newton(p, M, a0, J, aref, rinv)
    return torch.where((rinv > 0.0).any(-1, keepdim=True), qacc, a0)


def rk4_step_world(p: PointWorldParams, boxes: WallBoxes, balls, q, v,
                   blocks=None):
    """One mj_step of the composed robot + balls + blocks world (JAX
    :1532)."""
    return _rk4(lambda qi, vi: forward_world(p, boxes, balls, qi, vi, blocks),
                q, v, p.dt)
