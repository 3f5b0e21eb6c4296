"""The reduced object solve of the Point object worlds, in PyTorch.

Port of ``mujoco_maze_tpu/ops/object_lanes.py``: the robot-prescribed
object dynamics of the float32 path.  The objects (hinge balls of mass
1e-4 r^3, blocks of 2e-4 or 1e-3) are near-massless, so the robot is
kinematic: its pose advances at its own velocity through the four stages
of an RK4 step, and only the object dofs (nd = 2-6) are solved for.  Each
forward evaluation builds the impedance pyramid rows of every candidate
contact

* ball: vs the wall boxes, floor friction (always active on this path),
  robot sphere (tilted 3D normal), arrow box, earlier balls;
* block: robot sphere, arrow box (5-axis SAT with the incident-edge clip,
  and the z-winner rows at the arrow's corners), the walls it can reach
  (parallel-face AABB; with a z slide the 3-axis SAT), earlier blocks,
  balls, and for a falling block the floor and its slide limits;

``aref = -b (J v) + k(pen) pen``, ``rinv = d / (1 - d) / R_scale``, and
runs a primal Newton (6 steps, each an nd x nd Cholesky and a 10-step
bisection line search) on the object accelerations.

Where the JAX code has a "lane scalar", this module has a ``(B,)`` tensor
(``(W, B)`` where the walls are taken all at once); the ``(R, ...)`` row
stack becomes ``(R, B)``.  Every float32 constant is folded in Python
double and rounded once, as the JAX code's ``F(...)`` does (``F`` below
returns the Python float of the float32 value, which PyTorch takes
exactly).  The rows come in a fixed order, the candidate order of
``csrc/point_objects.cuh``: the balls' (walls, floor, robot, arrow,
earlier balls), then each block's (robot sphere, arrow a, arrow b, the
four z-winner corners, per reachable wall [its z row,] the two face
points, earlier blocks, balls, floor, limits).

This one implementation is the port's object solve: the step's object
physics on the CPU, and the plain version of the CUDA kernels' object
part on the card.  The JAX package holds it to its monolith
(``physics/point_world.rk4_object_step``) at q 2e-5, v 2e-3; the port's
tests hold it to that monolith the same way.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..physics import point_world as pw


def F(x) -> float:
    """``x`` rounded once to float32, as a Python float."""
    return float(np.float32(x))


class BallL(NamedTuple):
    body_pos: tuple      # (bx, by)
    r: float
    mass: float
    inertia: float
    dof: int             # ordinal of this ball's x dof in the object vector


class BlockL(NamedTuple):
    body_pos: tuple      # (bx, by, bz)
    half: tuple          # (hx, hy, hz)
    mass: float
    dof_x: int           # ordinal in the object vector, -1 if absent
    dof_y: int
    wall_idx: tuple      # indices of the walls within the block's reach
    dof_z: int = -1      # the falling block's z slide
    # ((xlo, xhi) | None, (ylo, yhi) | None, (zlo, zhi) | None), or None
    lim: tuple = None


class ObjectLanesSpec(NamedTuple):
    """The constants of the reduced object solve (field names as in the
    JAX package's ``ObjectLanesSpec``)."""

    wb_c: np.ndarray       # (W, 3) float32 wall box centers
    wb_h: np.ndarray       # (W, 3) half extents
    balls: tuple           # BallL
    blocks: tuple          # BlockL
    nd: int                # object dof count
    masses: tuple          # (nd,) per-dof mass
    sphere_r: float
    sphere_z: float
    invw_r: float
    arrow_off: float
    arrow_half_l: float
    arrow_half_w: float
    arrow_z_lo: float
    arrow_z_hi: float
    dt: float
    mu: float
    tc: float
    zeta: float
    dmin: float
    dmax: float
    width: float
    f_dmin: float
    f_dmax: float
    f_width: float
    newton_iters: int
    ls_iters: int


BB_DMIN, BB_DMAX, BB_WIDTH = 0.9, 0.99, 0.001          # object-pair solimp
BLW_DMIN, BLW_DMAX, BLW_WIDTH = 0.995, 0.995, 0.01     # block-wall solimp
LIM_DMIN, LIM_DMAX, LIM_WIDTH = 0.9, 0.95, 0.001       # slide-limit solimp
FLOOR_PEN = 2.0 ** -54
LIM_MARGIN = 0.01      # the reference's slide-joint margin, maze_env.py:615-648
GRAVITY_Z = -9.81      # projects only onto the falling blocks' z slides


def object_world(ms, robot) -> Optional[tuple]:
    """``(params, walls, balls, blocks)`` of a Point world with hinge balls
    or movable blocks (JAX envs/env.py:164-191, float32 branch), or None
    when it has neither, or a spin block (which the solve does not
    model)."""
    balls = (pw.ball_world_from_structure(ms)
             if ms.object_balls and robot.OBJBALL_TYPE == "hinge" else None)
    blocks = pw.block_world_from_structure(ms)
    if balls is None and blocks is None:
        return None
    params = pw.params_for_world(
        any_blocks=bool(ms.movable_blocks), dt=robot.timestep,
        torso_z=(0.75 + ms.height_offset) if ms.elevated else 0.0)
    return params, pw.wall_boxes_from_structure(ms), balls, blocks


def spec_from_env(spec) -> Optional[ObjectLanesSpec]:
    """The solve's constants of a port :class:`MazeEnvSpec`, or None when
    the env has no object world.  Each block keeps only the walls whose xy
    footprint can meet it within its travel limits."""
    ow = getattr(spec, "object_world", None)
    if ow is None:
        return None
    p, boxes, balls, blocks = ow
    mask = boxes.mask > 0
    wb_c = boxes.c.astype(np.float64)[mask]
    wb_h = boxes.h.astype(np.float64)[mask]
    dof = 0
    balls_l: List[BallL] = []
    masses: List[float] = []
    if balls is not None:
        for i in range(balls.nb):
            m = float(balls.mass[i])
            balls_l.append(BallL(
                body_pos=tuple(float(x) for x in balls.body_pos[i]),
                r=float(balls.r[i]), mass=m,
                inertia=float(balls.inertia[i]), dof=dof))
            masses += [m, m, float(balls.inertia[i])]
            dof += 3
    blocks_l: List[BlockL] = []
    if blocks is not None:
        half = blocks.half.astype(np.float64)
        for k in range(blocks.nb):
            dx = dy = dz = -1
            if blocks.has_x[k]:
                dx, dof = dof, dof + 1
                masses.append(float(blocks.mass[k]))
            if blocks.has_y[k]:
                dy, dof = dof, dof + 1
                masses.append(float(blocks.mass[k]))
            if blocks.has_z[k]:
                dz, dof = dof, dof + 1
                masses.append(float(blocks.mass[k]))
            rt = spec.block_runtimes[k]
            lo = rt.xy_lo.astype(np.float64) - half[k][:2]
            hi = rt.xy_hi.astype(np.float64) + half[k][:2]
            reach = tuple(
                w for w in range(wb_c.shape[0])
                if (wb_c[w, 0] - wb_h[w, 0] <= hi[0] + 1e-9
                    and wb_c[w, 0] + wb_h[w, 0] >= lo[0] - 1e-9
                    and wb_c[w, 1] - wb_h[w, 1] <= hi[1] + 1e-9
                    and wb_c[w, 1] + wb_h[w, 1] >= lo[1] - 1e-9))
            blocks_l.append(BlockL(
                body_pos=tuple(float(x) for x in blocks.body_pos[k]),
                half=tuple(float(x) for x in half[k]),
                mass=float(blocks.mass[k]), dof_x=dx, dof_y=dy, dof_z=dz,
                wall_idx=reach, lim=blocks.lim[k]))
    return ObjectLanesSpec(
        wb_c=wb_c.astype(np.float32), wb_h=wb_h.astype(np.float32),
        balls=tuple(balls_l), blocks=tuple(blocks_l), nd=dof,
        masses=tuple(masses),
        sphere_r=float(p.sphere_r), sphere_z=float(p.sphere_z),
        invw_r=float(p.invw_t), arrow_off=float(p.arrow_off),
        arrow_half_l=float(p.arrow_half_l),
        arrow_half_w=float(p.arrow_half_w),
        arrow_z_lo=float(p.arrow_z_lo), arrow_z_hi=float(p.arrow_z_hi),
        dt=float(p.dt), mu=float(p.mu), tc=float(p.tc), zeta=float(p.zeta),
        dmin=float(p.dmin), dmax=float(p.dmax), width=float(p.width),
        f_dmin=float(p.f_dmin), f_dmax=float(p.f_dmax),
        f_width=float(p.f_width),
        # the JAX package's production counts: (6, 10), measured equal to
        # its (10, 14) oracle counts at 2.4e-6 on its object-world tables
        newton_iters=6, ls_iters=10)


# ---------------------------------------------------------------------------
# contact classes: the float32 constants of one (solimp, invweight) pair
# ---------------------------------------------------------------------------
def R(x) -> float:
    """The float32 reciprocal of ``F(x)``, rounded once in float32 (what
    a division by the constant becomes here and in the kernel)."""
    return float(np.float32(1.0) / np.float32(x))


class Imp(NamedTuple):
    """float32 constants of one contact class: ``d = dmin + y(pen *
    inv_width) * dd``, ``k = d * inv_kden``, ``aref = -b (J v) + k pen``,
    ``rinv = d / (1 - d) * inv_rscale``.  The JAX code divides by width,
    kden and rscale; here (and in the kernel) each division by a constant
    is a product with its float32 reciprocal, which PyTorch computes alike
    on the CPU and on the card (its CUDA division by a Python scalar is
    such a product, its CPU one a division)."""

    dmin: float
    dd: float
    inv_width: float
    inv_kden: float
    b: float
    inv_rscale: float


def contact_imp(ks: ObjectLanesSpec, dmin, dmax, width, invw) -> Imp:
    """A pyramid contact's class: ``R = (1-d)/d 2 (1 + mu^2) invw``."""
    return Imp(F(dmin), F(dmax - dmin), R(width),
               R(dmax * dmax * ks.tc * ks.tc * ks.zeta * ks.zeta),
               F(2.0 / (dmax * ks.tc)),
               R(2.0 * (1.0 + ks.mu * ks.mu) * invw))


def limit_imp(ks: ObjectLanesSpec, invw) -> Imp:
    """A slide limit's class (frictionless): ``R = (1-d)/d invw``."""
    dmax = LIM_DMAX
    return Imp(F(LIM_DMIN), F(dmax - LIM_DMIN), R(LIM_WIDTH),
               R(dmax * dmax * ks.tc * ks.tc * ks.zeta * ks.zeta),
               F(2.0 / (dmax * ks.tc)), R(invw))


def ball_invw(bl: BallL) -> float:
    return 2.0 / (3.0 * bl.mass)


def ball_imps(ks: ObjectLanesSpec, bl: BallL) -> dict:
    """The classes of one ball's contacts (walls, floor, robot and arrow)."""
    ib = ball_invw(bl)
    return {
        "wall": contact_imp(ks, ks.dmin, ks.dmax, ks.width, ib),
        "floor": contact_imp(ks, ks.f_dmin, ks.f_dmax, ks.f_width, ib),
        "robot": contact_imp(ks, BB_DMIN, BB_DMAX, BB_WIDTH, ks.invw_r + ib),
    }


def block_imps(ks: ObjectLanesSpec, bk: BlockL) -> dict:
    """The classes of one block's contacts: robot sphere and arrow; walls,
    the floor and the z rows; each earlier block (``pair``, in order);
    each ball (``ball``, in order); its slide limits."""
    ik = 1.0 / bk.mass
    pairs = []
    for bp in ks.blocks:
        if bp is bk:
            break
        pairs.append(contact_imp(ks, BLW_DMIN, BLW_DMAX, BLW_WIDTH,
                                 1.0 / bk.mass + 1.0 / bp.mass))
    return {
        "robot": contact_imp(ks, ks.dmin, ks.dmax, ks.width, ks.invw_r + ik),
        "wall": contact_imp(ks, BLW_DMIN, BLW_DMAX, BLW_WIDTH, ik),
        "pair": pairs,
        "ball": [contact_imp(ks, ks.dmin, ks.dmax, ks.width,
                             ball_invw(bl) + ik) for bl in ks.balls],
        "limit": limit_imp(ks, ik),
    }


# ---------------------------------------------------------------------------
# lane helpers
# ---------------------------------------------------------------------------
def _full(val, like):
    """``val`` (a tensor or a Python float) at the shape of ``like``."""
    if isinstance(val, torch.Tensor):
        return torch.broadcast_to(val, like.shape)
    return torch.full_like(like, val)


def _sign1(x):
    """sign(x) with 0 -> 1."""
    return torch.where(x == 0.0, 1.0, torch.sign(x))


def _imp(pen, c: Imp):
    x = torch.clamp(pen * c.inv_width, 0.0, 1.0)
    y = torch.where(x < 0.5, 2.0 * x * x, 1.0 - 2.0 * (1.0 - x) * (1.0 - x))
    return c.dmin + y * c.dd


def _make_frame(nx, ny, nz):
    """mju_makeFrame tangents of the normal (nx, ny, nz)."""
    near_y = torch.abs(ny) > F(0.99995)
    t1x_a = -nx * ny
    t1y_a = 1.0 - ny * ny
    t1z_a = -nz * ny
    nrm = torch.sqrt(t1x_a * t1x_a + t1y_a * t1y_a + t1z_a * t1z_a + F(1e-30))
    t1 = (torch.where(near_y, 0.0, t1x_a / nrm),
          torch.where(near_y, 0.0, t1y_a / nrm),
          torch.where(near_y, 1.0, t1z_a / nrm))
    t2 = (ny * t1[2] - nz * t1[1],
          nz * t1[0] - nx * t1[2],
          nx * t1[1] - ny * t1[0])
    return (nx, ny, nz), t1, t2


def _jac3(d3, px, py, ox, oy):
    """Jacobian (x, y, rot) of direction d3 at (px, py) for a
    slide-slide-hinge body whose hinge passes through (ox, oy)."""
    rx, ry = px - ox, py - oy
    return (d3[0], d3[1], -ry * d3[0] + rx * d3[1])


def _sphere_box(cx, cy, cz, bx, by, bz, hx, hy, hz, radius):
    """Sphere at (cx, cy, cz) vs a box: (pen, nx, ny, nz, posx, posy);
    the shallow closest-point case, else the nearest of the six faces."""
    r = F(radius)
    lox, hix = bx - hx, bx + hx
    loy, hiy = by - hy, by + hy
    loz, hiz = bz - hz, bz + hz
    qx = torch.minimum(torch.maximum(cx, lox), hix)
    qy = torch.minimum(torch.maximum(cy, loy), hiy)
    qz = torch.minimum(torch.maximum(cz, loz), hiz)
    dx, dy, dz = cx - qx, cy - qy, cz - qz
    d2 = dx * dx + dy * dy + dz * dz
    outside = d2 > F(1e-24)
    dist = torch.sqrt(torch.clamp(d2, min=F(1e-24)))
    pen_out = r - dist
    inv = 1.0 / dist
    no = (dx * inv, dy * inv, dz * inv)
    t_out = r + (dist - r) * 0.5
    pos_out = (cx - no[0] * t_out, cy - no[1] * t_out)
    d0, d1 = cx - lox, hix - cx
    d2y, d3y = cy - loy, hiy - cy
    d4, d5 = cz - loz, hiz - cz
    fdepth = torch.minimum(torch.minimum(torch.minimum(d0, d1),
                                         torch.minimum(d2y, d3y)),
                           torch.minimum(d4, d5))
    e0, e1, e2, e3 = d0 == fdepth, d1 == fdepth, d2y == fdepth, d3y == fdepth
    nin_x = torch.where(e0, -1.0, torch.where(e1, 1.0, 0.0))
    nin_y = torch.where(e0 | e1, 0.0,
                        torch.where(e2, -1.0, torch.where(e3, 1.0, 0.0)))
    nin_z = torch.where(e0 | e1 | e2 | e3, 0.0,
                        torch.where(d4 == fdepth, -1.0, 1.0))
    pen_in = fdepth + r
    t_in = r - pen_in * 0.5
    pos_in = (cx - nin_x * t_in, cy - nin_y * t_in)
    return (torch.where(outside, pen_out, pen_in),
            torch.where(outside, no[0], nin_x),
            torch.where(outside, no[1], nin_y),
            torch.where(outside, no[2], nin_z),
            torch.where(outside, pos_out[0], pos_in[0]),
            torch.where(outside, pos_out[1], pos_in[1]))


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------
class _Group(NamedTuple):
    """Rows of one kind of contact: J (nd entries, None where structurally
    zero), aref and rinv, each ``(..., n, B)`` with ``n`` rows a contact."""

    J: tuple
    aref: torch.Tensor
    rinv: torch.Tensor


def _contact(ks, jn, jt1, jt2, vb_n, vb_t1, vb_t2, v, pen, active, zmult,
             c: Imp) -> _Group:
    """The 4 pyramid rows of one contact (or of one contact per leading
    index of ``pen``): ``jn/jt1/jt2`` the nd object-column Jacobians of
    the normal and the tangents (Python 0.0 where structurally zero),
    ``vb_*`` the robot's part of each direction's J v (0.0 for contacts
    between objects), ``v`` the object velocities."""
    mu = F(ks.mu)
    d = _imp(pen, c)
    k = d * c.inv_kden
    vn, vt1, vt2 = vb_n, vb_t1, vb_t2
    for i in range(ks.nd):
        if not isinstance(jn[i], float):
            vn = vn + jn[i] * v[i]
        if not isinstance(jt1[i], float):
            vt1 = vt1 + jt1[i] * v[i]
        if not isinstance(jt2[i], float):
            vt2 = vt2 + jt2[i] * v[i]
    kp = k * pen
    rinv = (d / (1.0 - d)) * c.inv_rscale * zmult
    rinv = torch.where(active, rinv, 0.0)
    J, aref = [], []
    for i in range(ks.nd):
        if isinstance(jn[i], float) and isinstance(jt1[i], float) \
                and isinstance(jt2[i], float):
            J.append(None)
            continue
        rows = []
        for s, jt in ((-1.0, jt1), (1.0, jt1), (-1.0, jt2), (1.0, jt2)):
            rows.append(_full(jn[i] + (s * mu) * jt[i], pen))
        J.append(torch.stack(rows, dim=-2))
    for s, vt in ((-1.0, vt1), (1.0, vt1), (-1.0, vt2), (1.0, vt2)):
        aref.append(_full(-c.b * (vn + (s * mu) * vt) + kp, pen))
    return _Group(tuple(J), torch.stack(aref, dim=-2),
                  torch.stack([rinv] * 4, dim=-2))


def _limit(ks, dof, sgn, pen, v, c: Imp) -> _Group:
    """One frictionless unilateral row (a slide limit)."""
    d = _imp(pen, c)
    k = d * c.inv_kden
    s = F(sgn)
    J = tuple(torch.full_like(pen, s)[None] if i == dof else None
              for i in range(ks.nd))
    aref = -c.b * (s * v[dof]) + k * pen
    rinv = torch.where(pen > 0.0, (d / (1.0 - d)) * c.inv_rscale, 0.0)
    return _Group(J, aref[None], rinv[None])


def _interleave(groups: List[_Group]) -> _Group:
    """Contact-major order of several groups over the same leading index
    (the walls): for each wall, the first group's rows, then the next's."""
    nd = len(groups[0].J)
    J = []
    for i in range(nd):
        ents = [g.J[i] for g in groups]
        if all(e is None for e in ents):
            J.append(None)
            continue
        ref = next(e for e in ents if e is not None)
        J.append(torch.stack([torch.zeros_like(ref) if e is None else e
                              for e in ents], dim=-3))
    return _Group(tuple(J), torch.stack([g.aref for g in groups], dim=-3),
                  torch.stack([g.rinv for g in groups], dim=-3))


def _zeros_j(ks):
    return [0.0] * ks.nd


def _ball_rows(ks, rows, bi: BallL, rq, rv, q, v, centers):
    """All contact rows of one ball: walls, floor, robot, arrow, balls."""
    o = bi.dof
    cx, cy = centers[id(bi)]
    r_b = bi.r
    imp = ball_imps(ks, bi)
    one = torch.ones_like(cx)
    zero = torch.zeros_like(cx)

    def ball_jac(d3, px, py):
        j = _zeros_j(ks)
        j[o], j[o + 1], j[o + 2] = _jac3(d3, px, py, cx, cy)
        return j

    # vs the wall boxes, all at once: (W, B)
    wc = torch.as_tensor(ks.wb_c, device=cx.device)[:, :, None]
    wh = torch.as_tensor(ks.wb_h, device=cx.device)[:, :, None]
    pen, nx, ny, nz, px, py = _sphere_box(
        cx, cy, F(r_b) * one, wc[:, 0], wc[:, 1], wc[:, 2],
        wh[:, 0], wh[:, 1], wh[:, 2], r_b)
    n3, t1, t2 = _make_frame(nx, ny, nz)
    rows.append(_contact(ks, ball_jac(n3, px, py), ball_jac(t1, px, py),
                         ball_jac(t2, px, py), 0.0, 0.0, 0.0, v, pen,
                         pen > 0.0, 1.0, imp["wall"]))

    # floor friction, always active on this path
    fpen = F(FLOOR_PEN) * one
    rows.append(_contact(ks, ball_jac((zero, zero, one), cx, cy),
                         ball_jac((zero, one, zero), cx, cy),
                         ball_jac((-one, zero, zero), cx, cy), 0.0, 0.0, 0.0,
                         v, fpen, one > 0.0, 1.0, imp["floor"]))

    # robot body sphere vs ball (3D tilted normal); row = ball - robot
    x, y, th = rq
    vx, vy, vth = rv
    dxr, dyr = cx - x, cy - y
    dzr = F(r_b - ks.sphere_z) * one
    dist3 = torch.sqrt(dxr * dxr + dyr * dyr + dzr * dzr + F(1e-30))
    inv3 = 1.0 / dist3
    nx, ny, nz = dxr * inv3, dyr * inv3, dzr * inv3
    pen_rb = F(ks.sphere_r + r_b) - dist3
    t_mid = F(ks.sphere_r) + (dist3 - F(ks.sphere_r + r_b)) * 0.5
    posx, posy = x + nx * t_mid, y + ny * t_mid
    n3, t1, t2 = _make_frame(nx, ny, nz)

    def rob_dot(d3, px, py):
        jx, jy, jr = _jac3(d3, px, py, x, y)
        return -(jx * vx + jy * vy + jr * vth)

    rows.append(_contact(
        ks, ball_jac(n3, posx, posy), ball_jac(t1, posx, posy),
        ball_jac(t2, posx, posy), rob_dot(n3, posx, posy),
        rob_dot(t1, posx, posy), rob_dot(t2, posx, posy), v, pen_rb,
        pen_rb > 0.0, 1.0, imp["robot"]))

    # arrow box vs ball (sphere vs rotated box, in the arrow's frame)
    ct, st = torch.cos(th), torch.sin(th)
    acx = x + ct * F(ks.arrow_off)
    acy = y + st * F(ks.arrow_off)
    relx, rely = cx - acx, cy - acy
    bxa = relx * ct + rely * st
    bya = -relx * st + rely * ct
    bza = F(r_b - 0.5 * (ks.arrow_z_lo + ks.arrow_z_hi)) * one
    hx, hy = F(ks.arrow_half_l), F(ks.arrow_half_w)
    hz = F(0.5 * (ks.arrow_z_hi - ks.arrow_z_lo))
    ddx = bxa - torch.clamp(bxa, -hx, hx)
    ddy = bya - torch.clamp(bya, -hy, hy)
    ddz = bza - torch.clamp(bza, -hz, hz)
    dl = torch.sqrt(torch.clamp(ddx * ddx + ddy * ddy + ddz * ddz,
                                min=F(1e-30)))
    pen_ab = F(r_b) - dl
    nfx, nfy, nfz = ddx / dl, ddy / dl, ddz / dl
    nwx = nfx * ct - nfy * st
    nwy = nfx * st + nfy * ct
    t_ab = F(r_b) + (dl - F(r_b)) * 0.5
    pax, pay = cx - nwx * t_ab, cy - nwy * t_ab
    an3, at1, at2 = _make_frame(nwx, nwy, nfz)
    rows.append(_contact(
        ks, ball_jac(an3, pax, pay), ball_jac(at1, pax, pay),
        ball_jac(at2, pax, pay), rob_dot(an3, pax, pay),
        rob_dot(at1, pax, pay), rob_dot(at2, pax, pay), v, pen_ab,
        pen_ab > 0.0, 1.0, imp["robot"]))

    # vs earlier balls
    for bj in ks.balls:
        if bj.dof >= bi.dof:
            continue
        o2 = bj.dof
        c2x, c2y = centers[id(bj)]
        d3bx, d3by = cx - c2x, cy - c2y
        d3bz = F(r_b - bj.r) * one
        distb = torch.sqrt(d3bx * d3bx + d3by * d3by + d3bz * d3bz + F(1e-30))
        invb = 1.0 / distb
        nbx, nby, nbz = d3bx * invb, d3by * invb, d3bz * invb
        pen_bb = F(r_b + bj.r) - distb
        tb = F(bj.r) + (distb - F(bj.r + r_b)) * 0.5
        pbx, pby = c2x + nbx * tb, c2y + nby * tb
        bn, bt1, bt2 = _make_frame(nbx, nby, nbz)

        def pair_jac(d3):
            j = _zeros_j(ks)
            j[o], j[o + 1], j[o + 2] = _jac3(d3, pbx, pby, cx, cy)
            jj = _jac3(d3, pbx, pby, c2x, c2y)
            for a in range(3):
                j[o2 + a] = j[o2 + a] - jj[a]
            return j

        rows.append(_contact(
            ks, pair_jac(bn), pair_jac(bt1), pair_jac(bt2), 0.0, 0.0, 0.0,
            v, pen_bb, pen_bb > 0.0, 1.0,
            contact_imp(ks, BB_DMIN, BB_DMAX, BB_WIDTH,
                        ball_invw(bi) + ball_invw(bj))))


def _block_jac(ks, bk: BlockL, d3x, d3y, d3z=None):
    j = _zeros_j(ks)
    if bk.dof_x >= 0:
        j[bk.dof_x] = d3x
    if bk.dof_y >= 0:
        j[bk.dof_y] = d3y
    if bk.dof_z >= 0 and d3z is not None:
        j[bk.dof_z] = d3z
    return j


def _neg_jac(ks, bk, d3):
    return _block_jac(ks, bk, -d3[0], -d3[1], -d3[2])


def _block_rows(ks, rows, bk: BlockL, rq, rv, q, v, centers):
    """Rows of one block: robot sphere, arrow, walls, earlier blocks,
    balls, floor and slide limits."""
    x, y, th = rq
    vx, vy, vth = rv
    cx, cy, cz = centers[id(bk)]
    hx, hy, hz = F(bk.half[0]), F(bk.half[1]), F(bk.half[2])
    imp = block_imps(ks, bk)
    one = torch.ones_like(cx)
    zero = torch.zeros_like(cx)

    # robot body sphere vs block (row = robot - block)
    pen, nx, ny, nz, px, py = _sphere_box(
        x, y, F(ks.sphere_z) * one, cx, cy, cz, hx, hy, hz, ks.sphere_r)
    n3, t1, t2 = _make_frame(nx, ny, nz)

    def rob_dot(d3, px, py):
        jx, jy, jr = _jac3(d3, px, py, x, y)
        return jx * vx + jy * vy + jr * vth

    rows.append(_contact(
        ks, _neg_jac(ks, bk, n3), _neg_jac(ks, bk, t1), _neg_jac(ks, bk, t2),
        rob_dot(n3, px, py), rob_dot(t1, px, py), rob_dot(t2, px, py), v,
        pen, pen > 0.0, 1.0, imp["robot"]))

    _arrow_block_rows(ks, rows, bk, rq, rv, v, cx, cy, cz, imp["robot"])

    # vs the walls within reach, all at once: (Wk, B), per wall [z,] p1, p2
    if bk.wall_idx:
        sel = list(bk.wall_idx)
        wc = torch.as_tensor(ks.wb_c[sel], device=cx.device)[:, :, None]
        wh = torch.as_tensor(ks.wb_h[sel], device=cx.device)[:, :, None]
        rows.append(_aabb_wall_rows(ks, bk, v, cx, cy, cz, wc[:, 0], wc[:, 1],
                                    wc[:, 2], wh[:, 0], wh[:, 1], wh[:, 2],
                                    imp["wall"]))

    # vs earlier blocks (two-sided Jacobian), two face points each
    for bp, c_pair in zip(ks.blocks, imp["pair"]):
        c2x, c2y, c2z = centers[id(bp)]
        active, nx, ny, pen = _aabb_face_contacts(
            cx, cy, cz, hx, hy, hz, c2x, c2y, c2z,
            F(bp.half[0]), F(bp.half[1]), F(bp.half[2]))
        n3, t1, t2 = _make_frame(nx, ny, torch.zeros_like(nx))

        def pj(d3, bp=bp):
            j = _block_jac(ks, bk, d3[0], d3[1], d3[2])
            for dof, comp in zip((bp.dof_x, bp.dof_y, bp.dof_z), d3):
                if dof >= 0:
                    j[dof] = j[dof] - comp
            return j

        g = _contact(ks, pj(n3), pj(t1), pj(t2), 0.0, 0.0, 0.0, v, pen,
                     active, 2.0, c_pair)
        rows.append(_interleave([g, g]))

    # balls vs block (sphere-box; row = ball - block)
    for bl, c_ball in zip(ks.balls, imp["ball"]):
        o = bl.dof
        bcx, bcy = centers[id(bl)]
        pen, nx, ny, nz, px, py = _sphere_box(
            bcx, bcy, F(bl.r) * one, cx, cy, cz, hx, hy, hz, bl.r)
        n3, t1, t2 = _make_frame(nx, ny, nz)

        def mixed_jac(d3, px=px, py=py, bcx=bcx, bcy=bcy, o=o):
            j = _neg_jac(ks, bk, d3)
            ji = _jac3(d3, px, py, bcx, bcy)
            for a in range(3):
                j[o + a] = j[o + a] + ji[a]
            return j

        rows.append(_contact(ks, mixed_jac(n3), mixed_jac(t1), mixed_jac(t2),
                             0.0, 0.0, 0.0, v, pen, pen > 0.0, 1.0, c_ball))

    # a falling block: the z = 0 floor plane, inside the Newton solve
    if bk.dof_z >= 0:
        pen_f = -(cz - hz)
        fn3, ft1, ft2 = _make_frame(zero, zero, one)
        rows.append(_contact(
            ks, _block_jac(ks, bk, *fn3), _block_jac(ks, bk, *ft1),
            _block_jac(ks, bk, *ft2), 0.0, 0.0, 0.0, v, pen_f, pen_f > 0.0,
            1.0, imp["wall"]))
    if bk.lim is not None:
        margin = F(LIM_MARGIN)
        for dof, lim_ax in zip((bk.dof_x, bk.dof_y, bk.dof_z), bk.lim):
            if dof < 0 or lim_ax is None:
                continue
            lo, hi = lim_ax
            for sgn, pen_l in ((1.0, (F(lo) + margin) - q[dof]),
                               (-1.0, q[dof] - (F(hi) - margin))):
                rows.append(_limit(ks, dof, sgn, pen_l, v, imp["limit"]))


def _aabb_face_contacts(cx, cy, cz, hx, hy, hz, wx, wy, wz, whx, why, whz):
    """Parallel-face AABB vs AABB in xy: (active, nx, ny, pen).  Both face
    points share these (the jacobians of a translating box do not depend
    on the point), so a caller adds the contact twice."""
    dx_, dy_ = cx - wx, cy - wy
    ox = whx + hx - torch.abs(dx_)
    oy = why + hy - torch.abs(dy_)
    oz = whz + hz - torch.abs(cz - wz)
    use_x = ox <= oy
    pen = torch.where(use_x, ox, oy)
    sgn = torch.where(use_x, _sign1(dx_), _sign1(dy_))
    nx = torch.where(use_x, sgn, 0.0 * sgn)
    ny = torch.where(use_x, 0.0 * sgn, sgn)
    half_t = torch.where(use_x, hy, hx)
    ctr_t = torch.where(use_x, cy, cx)
    w_t = torch.where(use_x, why, whx)
    wc_t = torch.where(use_x, wy, wx)
    t_lo = torch.maximum(ctr_t - half_t, wc_t - w_t)
    t_hi = torch.minimum(ctr_t + half_t, wc_t + w_t)
    active = (pen > 0.0) & (oz > 0.0) & (t_hi > t_lo)
    return active, nx, ny, pen


def _aabb_wall_rows(ks, bk: BlockL, v, cx, cy, cz, wx, wy, wz,
                    whx, why, whz, c: Imp) -> _Group:
    hx, hy, hz = F(bk.half[0]), F(bk.half[1]), F(bk.half[2])
    active, nx, ny, pen = _aabb_face_contacts(cx, cy, cz, hx, hy, hz,
                                              wx, wy, wz, whx, why, whz)
    zero = torch.zeros_like(pen)
    groups = []
    if bk.dof_z >= 0:
        # 3-axis SAT: where the z overlap is the least (the falling block
        # perched on, or popping out of, its platform) the xy rows yield
        # to a +-z parallel-face row of multiplicity 4
        ox = whx + hx - torch.abs(cx - wx)
        oy = why + hy - torch.abs(cy - wy)
        dz_ = cz - wz
        oz = whz + hz - torch.abs(dz_)
        overlap = (ox > 0.0) & (oy > 0.0) & (oz > 0.0)
        z_wins = (oz <= ox) & (oz <= oy)
        active = active & ~z_wins
        zn3, zt1, zt2 = _make_frame(zero, zero, _sign1(dz_))
        groups.append(_contact(
            ks, _block_jac(ks, bk, *zn3), _block_jac(ks, bk, *zt1),
            _block_jac(ks, bk, *zt2), 0.0, 0.0, 0.0, v, oz, overlap & z_wins,
            4.0, c))
    n3, t1, t2 = _make_frame(nx, ny, torch.zeros_like(nx))
    g = _contact(ks, _block_jac(ks, bk, *n3), _block_jac(ks, bk, *t1),
                 _block_jac(ks, bk, *t2), 0.0, 0.0, 0.0, v, pen, active, 2.0,
                 c)
    return _interleave(groups + [g, g])


def _pick(vals, sel):
    out = torch.zeros_like(vals[0])
    for i in range(4):
        out = torch.where(sel == i, vals[i], out)
    return out


def _arrow_block_rows(ks, rows, bk: BlockL, rq, rv, v, cx, cy, cz, c: Imp):
    """Arrow box vs one block: 5-axis SAT and the incident-edge clip, and
    where the z overlap is the least, pure friction rows at the arrow's
    footprint corners inside the block (with the normal on a z slide)."""
    x, y, th = rq
    vx, vy, vth = rv
    one = torch.ones_like(cx)
    ct, st = torch.cos(th), torch.sin(th)
    ux, uy = ct, st
    wxv, wyv = -st, ct
    acx = x + ux * F(ks.arrow_off)
    acy = y + uy * F(ks.arrow_off)
    hl, hw = F(ks.arrow_half_l), F(ks.arrow_half_w)
    az_c = 0.5 * (ks.arrow_z_lo + ks.arrow_z_hi)
    az_h = 0.5 * (ks.arrow_z_hi - ks.arrow_z_lo)
    bhx, bhy = F(bk.half[0]), F(bk.half[1])
    ov_z = F(bk.half[2] + az_h) - torch.abs(F(az_c) - cz)
    dx_, dy_ = acx - cx, acy - cy
    ov_wx = bhx + hl * torch.abs(ux) + hw * torch.abs(wxv) - torch.abs(dx_)
    ov_wy = bhy + hl * torch.abs(uy) + hw * torch.abs(wyv) - torch.abs(dy_)
    du = dx_ * ux + dy_ * uy
    dv = dx_ * wxv + dy_ * wyv
    ov_u = hl + bhx * torch.abs(ux) + bhy * torch.abs(uy) - torch.abs(du)
    ov_v = hw + bhx * torch.abs(wxv) + bhy * torch.abs(wyv) - torch.abs(dv)
    overlap = ((ov_wx > 0.0) & (ov_wy > 0.0) & (ov_u > 0.0) & (ov_v > 0.0)
               & (ov_z > 0.0))
    min_all = torch.minimum(torch.minimum(ov_wx, ov_wy),
                            torch.minimum(ov_u, ov_v))
    z_wins = ov_z < min_all
    is_wx = ov_wx == min_all
    is_wy = (~is_wx) & (ov_wy == min_all)
    is_u = (~is_wx) & (~is_wy) & (ov_u == min_all)
    is_v = (~is_wx) & (~is_wy) & (~is_u)
    sgn_u, sgn_v = _sign1(du), _sign1(dv)
    zero_s = 0.0 * one
    nx = (torch.where(is_wx, _sign1(dx_), zero_s)
          + torch.where(is_wy, zero_s, zero_s)
          + torch.where(is_u, ux * sgn_u, zero_s)
          + torch.where(is_v, wxv * sgn_v, zero_s))
    ny = (torch.where(is_wy, _sign1(dy_), zero_s)
          + torch.where(is_u, uy * sgn_u, zero_s)
          + torch.where(is_v, wyv * sgn_v, zero_s))
    is_wall_axis = is_wx | is_wy

    # arrow corners (+,+), (+,-), (-,+), (-,-) over (u, v)
    cxs, cys = [], []
    for su in (1.0, -1.0):
        for sv in (1.0, -1.0):
            cxs.append(acx + su * ux * hl + sv * wxv * hw)
            cys.append(acy + su * uy * hl + sv * wyv * hw)
    face_off = cx * nx + cy * ny + bhx * torch.abs(nx) + bhy * torch.abs(ny)
    corner_pen = [face_off - (cxs[i] * nx + cys[i] * ny) for i in range(4)]
    wcx = [cx + sx * bhx for sx in (1.0, 1.0, -1.0, -1.0)]
    wcy = [cy + sy * bhy for sy in (1.0, -1.0, 1.0, -1.0)]
    half_along = hl * torch.abs(nx * ux + ny * uy) + hw * torch.abs(
        nx * wxv + ny * wyv)
    a_face_off = acx * nx + acy * ny - half_along
    wall_pen = [(wcx[i] * nx + wcy[i] * ny) - a_face_off for i in range(4)]
    pens = [torch.where(is_wall_axis, corner_pen[i], wall_pen[i])
            for i in range(4)]
    ptx = [torch.where(is_wall_axis, cxs[i], wcx[i]) for i in range(4)]
    pty = [torch.where(is_wall_axis, cys[i], wcy[i]) for i in range(4)]

    # the incident edge: two corner indices of four
    cu = nx * ux + ny * uy
    cv = nx * wxv + ny * wyv
    su_i, sv_i = -_sign1(cu), -_sign1(cv)
    use_u = torch.abs(cu) >= torch.abs(cv)
    sel_wall_a = torch.where(use_u, torch.where(su_i > 0, 0, 2),
                             torch.where(sv_i > 0, 0, 1))
    sel_wall_b = torch.where(use_u, torch.where(su_i > 0, 1, 3),
                             torch.where(sv_i > 0, 2, 3))
    sxn, syn = _sign1(nx), _sign1(ny)
    use_x = torch.abs(nx) >= torch.abs(ny)
    sel_arr_a = torch.where(use_x, torch.where(sxn > 0, 0, 2),
                            torch.where(syn > 0, 0, 1))
    sel_arr_b = torch.where(use_x, torch.where(sxn > 0, 1, 3),
                            torch.where(syn > 0, 2, 3))
    sel_a = torch.where(is_wall_axis, sel_wall_a, sel_arr_a)
    sel_b = torch.where(is_wall_axis, sel_wall_b, sel_arr_b)
    pen_a, pen_b = _pick(pens, sel_a), _pick(pens, sel_b)
    pax_, pay_ = _pick(ptx, sel_a), _pick(pty, sel_a)
    pbx_, pby_ = _pick(ptx, sel_b), _pick(pty, sel_b)

    # tangential clip against the reference face's extent
    tx, ty = -ny, nx
    ref_cx = torch.where(is_wall_axis, cx, acx)
    ref_cy = torch.where(is_wall_axis, cy, acy)
    ref_ht = torch.where(
        is_wall_axis, bhx * torch.abs(tx) + bhy * torch.abs(ty),
        hl * torch.abs(tx * ux + ty * uy) + hw * torch.abs(tx * wxv + ty * wyv))
    s_a = (pax_ - ref_cx) * tx + (pay_ - ref_cy) * ty
    s_b = (pbx_ - ref_cx) * tx + (pby_ - ref_cy) * ty
    s_a_cl = torch.minimum(torch.maximum(s_a, -ref_ht), ref_ht)
    s_b_cl = torch.minimum(torch.maximum(s_b, -ref_ht), ref_ht)
    edge_s = (pbx_ - pax_) * tx + (pby_ - pay_) * ty
    slope = torch.where(torch.abs(edge_s) > F(1e-9),
                        (pen_b - pen_a) / edge_s, zero_s)
    pen_a_cl = pen_a + (s_a_cl - s_a) * slope
    pen_b_cl = pen_b + (s_b_cl - s_b) * slope

    # which points are kept (point_world._arrow_vs_boxes)
    was_cl_a = torch.abs(s_a_cl - s_a) > F(1e-12)
    was_cl_b = torch.abs(s_b_cl - s_b) > F(1e-12)
    h_ref = torch.where(is_wall_axis,
                        bhx * torch.abs(nx) + bhy * torch.abs(ny), half_along)
    c1 = F(0.02) * h_ref
    c2 = c1 * R(1.01)
    ninf = torch.full_like(pen_a_cl, -torch.inf)
    depmax = torch.maximum(torch.where(pen_a_cl > 0, pen_a_cl, ninf),
                           torch.where(pen_b_cl > 0, pen_b_cl, ninf))
    thresh = torch.where(depmax <= c1, zero_s, c2)
    clip_a = (pen_a_cl > 0.0) & ((depmax - pen_a_cl) <= 2.0 * h_ref)
    clip_b = (pen_b_cl > 0.0) & ((depmax - pen_b_cl) <= 2.0 * h_ref)
    keep_a = (was_cl_a & clip_a) | ((~was_cl_a) & (pen_a_cl > thresh))
    keep_b = (was_cl_b & clip_b) | ((~was_cl_b) & (pen_b_cl > thresh))

    # the contact points' positions: the clipped points, moved half the
    # depth along n (the sign by the reference side)
    pos_sgn = torch.where(is_wall_axis, 0.5, -0.5)
    pax_f = pax_ + (s_a_cl - s_a) * tx + nx * pen_a_cl * pos_sgn
    pay_f = pay_ + (s_a_cl - s_a) * ty + ny * pen_a_cl * pos_sgn
    pbx_f = pbx_ + (s_b_cl - s_b) * tx + nx * pen_b_cl * pos_sgn
    pby_f = pby_ + (s_b_cl - s_b) * ty + ny * pen_b_cl * pos_sgn

    n3, t1, t2 = _make_frame(nx, ny, torch.zeros_like(nx))
    for pen_c, keep, px_c, py_c in ((pen_a_cl, keep_a, pax_f, pay_f),
                                    (pen_b_cl, keep_b, pbx_f, pby_f)):
        def rob_dot(d3):
            jx, jy, jr = _jac3(d3, px_c, py_c, x, y)
            return jx * vx + jy * vy + jr * vth

        rows.append(_contact(
            ks, _neg_jac(ks, bk, n3), _neg_jac(ks, bk, t1),
            _neg_jac(ks, bk, t2), rob_dot(n3), rob_dot(t1), rob_dot(t2), v,
            pen_c, overlap & keep & (~z_wins), 2.0, c))

    # the z-winner rows at the arrow's footprint corners inside the block
    nz_sgn = torch.where(F(az_c) <= cz, -1.0, 1.0)
    zero = torch.zeros_like(one)
    zn3 = (zero, zero, nz_sgn)
    zt1 = (zero, one, zero)
    zt2 = (-nz_sgn, zero, zero)
    for ci in range(4):
        in_foot = ((torch.abs(cxs[ci] - cx) <= bhx)
                   & (torch.abs(cys[ci] - cy) <= bhy))

        def rob_dot_z(d3, ci=ci):
            jx, jy, jr = _jac3(d3, cxs[ci], cys[ci], x, y)
            return jx * vx + jy * vy + jr * vth

        rows.append(_contact(
            ks, _neg_jac(ks, bk, zn3), _neg_jac(ks, bk, zt1),
            _neg_jac(ks, bk, zt2), rob_dot_z(zn3), rob_dot_z(zt1),
            rob_dot_z(zt2), v, ov_z, overlap & z_wins & in_foot, 1.0, c))


# ---------------------------------------------------------------------------
# Newton solve
# ---------------------------------------------------------------------------
def _stack_rows(ks, groups: List[_Group]):
    """The groups' rows as ``(R, B)`` tensors: J (nd of them), aref, rinv."""
    B = groups[0].aref.shape[-1]
    Jm = []
    for i in range(ks.nd):
        parts = []
        for g in groups:
            n = g.aref.reshape(-1, B).shape[0]
            parts.append(g.aref.new_zeros((n, B)) if g.J[i] is None
                         else g.J[i].reshape(-1, B))
        Jm.append(torch.cat(parts))
    aref = torch.cat([g.aref.reshape(-1, B) for g in groups])
    rinv = torch.cat([g.rinv.reshape(-1, B) for g in groups])
    return Jm, aref, rinv


def _chol_solve(H, g, nd):
    """x = H^{-1} g for an SPD H given as nested lists of (B,) tensors."""
    L = [[None] * nd for _ in range(nd)]
    for j in range(nd):
        s = H[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=F(1e-30)))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, nd):
            s = H[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * nd
    for i in range(nd):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * nd
    for i in reversed(range(nd)):
        s = y[i]
        for k in range(i + 1, nd):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _seq_sum(x):
    """Sum over the leading axis, one row after the other (the kernel's
    order)."""
    if x.shape[0] == 0:
        return torch.zeros_like(x[0:1].sum(dim=0))
    s = x[0]
    for k in range(1, x.shape[0]):
        s = s + x[k]
    return s


def _solve_newton(ks, Jm, aref, rinv, v0, a0):
    """Primal Newton over the stacked ``(R, B)`` rows: minimise
    ``(x - a0)^T M (x - a0) / 2 + sum_r rinv_r [J_r x - aref_r]_-^2 / 2``
    over the object accelerations ``x``.

    The JAX code sums the rows with one reduction each.  Here each env's
    active rows (rinv > 0) are first gathered in row order, and every sum
    over rows runs one row after the other, as the kernel sums its list
    of active rows: an inactive row adds exactly 0, so the two add the
    same terms in the same order and agree to the bit.  The loops run over
    the batch's largest active count, not over all R candidates."""
    nd = ks.nd
    M = [F(m) for m in ks.masses]
    a0 = [F(a) for a in a0]
    x = [torch.zeros_like(v0[0]) for _ in range(nd)]
    active = rinv > 0.0
    K = int(active.sum(dim=0).max()) if active.numel() else 0
    order = torch.argsort((~active).to(torch.int8), dim=0, stable=True)[:K]
    J = torch.stack([torch.gather(j, 0, order) for j in Jm])   # (nd, K, B)
    aref = torch.gather(aref, 0, order)
    rinv = torch.gather(rinv, 0, order)
    upper = [(i, j) for i in range(nd) for j in range(i, nd)]
    ii = torch.tensor([i for i, _ in upper], device=J.device)
    jj = torch.tensor([j for _, j in upper], device=J.device)

    def jdot(vec):
        s = J[0] * vec[0]
        for i in range(1, nd):
            s = s + J[i] * vec[i]
        return s

    for _ in range(ks.newton_iters):
        jar0 = jdot(x) - aref
        w = torch.where(jar0 < 0.0, rinv, 0.0)
        wj = w * jar0
        # gradient terms J_i w (J x - aref), Hessian terms (J_i w) J_j
        sums = _seq_sum(torch.cat([J * wj, (J[ii] * w) * J[jj]]).transpose(0, 1))
        grad = [M[i] * (x[i] - a0[i]) + sums[i] for i in range(nd)]
        H = [[None] * nd for _ in range(nd)]
        for n, (i, j) in enumerate(upper):
            H[i][j] = sums[nd + n] + M[i] if i == j else sums[nd + n]
            H[j][i] = H[i][j]
        p = [-pi for pi in _chol_solve(H, grad, nd)]
        # bisection line search on the monotone derivative
        jp = jdot(p)
        pMx = torch.zeros_like(x[0])
        pMp = torch.zeros_like(x[0])
        for i in range(nd):
            pMx = pMx + p[i] * M[i] * (x[i] - a0[i])
            pMp = pMp + p[i] * M[i] * p[i]

        def phi_prime(t):
            jart = jar0 + t * jp
            wt = torch.where(jart < 0.0, rinv, 0.0)
            return pMx + t * pMp + _seq_sum(jp * (wt * jart))

        lo = torch.zeros_like(x[0])
        hi = torch.full_like(x[0], 2.0)
        hi = torch.where(phi_prime(hi) < 0.0, 4.0, hi)
        for _ in range(ks.ls_iters):
            mid = 0.5 * (lo + hi)
            dneg = phi_prime(mid) < 0.0
            lo = torch.where(dneg, mid, lo)
            hi = torch.where(dneg, hi, mid)
        t = 0.5 * (lo + hi)
        x = [x[i] + t * p[i] for i in range(nd)]
    return x


def object_rows(ks: ObjectLanesSpec, rq, rv, q, v):
    """The candidate rows of one forward evaluation, ``(R, B)`` each: J
    (nd tensors), aref, rinv (0 where inactive)."""
    groups: List[_Group] = []
    centers = {}
    for bl in ks.balls:
        centers[id(bl)] = (F(bl.body_pos[0]) + q[bl.dof],
                           F(bl.body_pos[1]) + q[bl.dof + 1])
    zero = torch.zeros_like(q[0])
    for bk in ks.blocks:
        centers[id(bk)] = tuple(
            F(bk.body_pos[a]) + (q[d] if d >= 0 else zero)
            for a, d in enumerate((bk.dof_x, bk.dof_y, bk.dof_z)))
    for bl in ks.balls:
        _ball_rows(ks, groups, bl, rq, rv, q, v, centers)
    for bk in ks.blocks:
        _block_rows(ks, groups, bk, rq, rv, q, v, centers)
    return _stack_rows(ks, groups)


def gravity(ks: ObjectLanesSpec) -> tuple:
    """The unconstrained object accelerations: gravity on the z slides."""
    a0 = [0.0] * ks.nd
    for bk in ks.blocks:
        if bk.dof_z >= 0:
            a0[bk.dof_z] = GRAVITY_Z
    return tuple(a0)


def object_forward_lanes(ks: ObjectLanesSpec, rq, rv, q, v, active=None):
    """The ``nd`` object accelerations, ``(B,)`` each; ``rq``/``rv`` the
    robot's (x, y, th) pose and velocity.  ``active``, a list, receives
    the ``(R, B)`` bool mask of the active rows."""
    Jm, aref, rinv = object_rows(ks, rq, rv, q, v)
    if active is not None:
        active.append(rinv > 0.0)
    return _solve_newton(ks, Jm, aref, rinv, v, gravity(ks))


def object_step_lanes(ks: ObjectLanesSpec, rq, rv, q, v, active=None):
    """One RK4 env step of the object dofs, the robot kinematic through
    the stages (its pose advances at ``rv``).  ``q``, ``v``: nd ``(B,)``
    tensors each; returns the stepped pair.  ``active``, a list, receives
    the four evaluations' active-row masks."""
    h = F(ks.dt)
    bw = [F(b) for b in (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)]
    nd = ks.nd
    vs = [v]
    accs = [object_forward_lanes(ks, rq, rv, q, v, active)]
    for a in (0.5, 0.5, 1.0):
        ah = F(np.float32(a) * np.float32(h))
        qi = tuple(q[i] + ah * vs[-1][i] for i in range(nd))
        vi = tuple(v[i] + ah * accs[-1][i] for i in range(nd))
        rqi = tuple(rq[k] + ah * rv[k] for k in range(3))
        vs.append(vi)
        accs.append(object_forward_lanes(ks, rqi, rv, qi, vi, active))

    def rk4_sum(terms, i):
        s = bw[0] * terms[0][i]
        for b, tm in zip(bw[1:], terms[1:]):
            s = s + b * tm[i]
        return s

    qf = tuple(q[i] + h * rk4_sum(vs, i) for i in range(nd))
    vf = tuple(v[i] + h * rk4_sum(accs, i) for i in range(nd))
    return qf, vf


def row_count(ks: ObjectLanesSpec) -> int:
    """R: the candidate rows of one forward evaluation."""
    return len(row_names(ks))


def row_names(ks: ObjectLanesSpec) -> list:
    """A name for each of the R candidate rows, in row order (what a bit of
    the step kernel's trace stands for)."""
    edges = ("-t1", "+t1", "-t2", "+t2")
    names = []

    def contact(name):
        names.extend(f"{name} {e}" for e in edges)

    for i, bl in enumerate(ks.balls):
        for w in range(ks.wb_c.shape[0]):
            contact(f"ball {i} vs wall {w}")
        contact(f"ball {i} vs floor")
        contact(f"ball {i} vs robot sphere")
        contact(f"ball {i} vs arrow")
        for j, bj in enumerate(ks.balls):
            if bj.dof < bl.dof:
                contact(f"ball {i} vs ball {j}")
    for k, bk in enumerate(ks.blocks):
        contact(f"block {k} vs robot sphere")
        contact(f"block {k} vs arrow point a")
        contact(f"block {k} vs arrow point b")
        for c in range(4):
            contact(f"block {k} vs arrow corner {c} (z wins)")
        for w in bk.wall_idx:
            if bk.dof_z >= 0:
                contact(f"block {k} vs wall {w} (z face)")
            contact(f"block {k} vs wall {w} (face point 1)")
            contact(f"block {k} vs wall {w} (face point 2)")
        for j in range(k):
            contact(f"block {k} vs block {j} (face point 1)")
            contact(f"block {k} vs block {j} (face point 2)")
        for i in range(len(ks.balls)):
            contact(f"block {k} vs ball {i}")
        if bk.dof_z >= 0:
            contact(f"block {k} vs floor")
        if bk.lim is not None:
            for axis, d, lim in zip("xyz", (bk.dof_x, bk.dof_y, bk.dof_z),
                                    bk.lim):
                if d >= 0 and lim is not None:
                    names += [f"block {k} {axis} slide lower limit",
                              f"block {k} {axis} slide upper limit"]
    return names
