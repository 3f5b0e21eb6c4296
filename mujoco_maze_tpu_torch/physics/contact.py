"""Collision detection + contact forces on batched torch tensors.

Port of ``mujoco_maze_tpu.physics.contact`` for robots in static worlds:

* the static enumeration of candidate contacts (:class:`ContactSet`,
  :func:`build_contact_set`) is a numpy copy of the JAX package's: every
  dynamic geom lowers to a fixed set of **test spheres** (sphere → itself;
  capsule → 3 samples along its axis; box → its corners with radius 0);
  every static world geom is an axis-aligned box or the floor plane;
* :func:`contact_qfrc` detects spheres vs the floor plane and vs the
  static boxes (the two nearest boxes per sphere) and solves MuJoCo's
  impedance dynamics per contact with projected Jacobi on the regularised
  Delassus matrix, batch-first.

Sphere-sphere pairs, movable boxes and object balls (the Ant object
worlds) wait for ROADMAP queue 1 item 11; a contact set that has them is
refused.  ``falling_support_force`` (AntFall) waits with them.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from . import engine as _engine
from .model import (
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_PLANE,
    GEOM_SPHERE,
    Geom,
    RigidModel,
    _quat_to_mat_np,
)

CAPSULE_SAMPLES = 3
# solver works on at most this many deepest candidates (plenty: a robot
# touches ~10-20 surfaces at once)
MAX_ACTIVE_CONTACTS = 256


class ContactSet(NamedTuple):
    """Static (trace-time) description of all candidate contacts."""

    # test spheres over dynamic geoms
    sph_body: np.ndarray       # (S,) body index
    sph_local: np.ndarray      # (S, 3) offset in body frame
    sph_radius: np.ndarray     # (S,)
    sph_solref: np.ndarray     # (S, 2)
    sph_solimp: np.ndarray     # (S, 3)
    sph_friction: np.ndarray   # (S,)
    sph_margin: np.ndarray     # (S,) geom margin (combined per contact)
    sph_vs_static: np.ndarray  # (S,) bool — collides with world geoms
    # static world: axis-aligned boxes
    box_center: np.ndarray     # (B, 3)
    box_half: np.ndarray       # (B, 3)
    box_margin: np.ndarray     # (B,)
    has_floor: bool
    floor_z: float
    floor_margin: float
    # dynamic sphere-sphere candidate pairs
    pair_i: np.ndarray         # (P,)
    pair_j: np.ndarray         # (P,)
    # dynamic (moving) boxes + sphere-vs-dynbox candidate pairs
    dbox_body: np.ndarray      # (D,)
    dbox_local: np.ndarray     # (D, 3) geom offset in body frame
    dbox_half: np.ndarray      # (D, 3)
    dbox_solref: np.ndarray    # (D, 2)
    dbox_solimp: np.ndarray    # (D, 3)
    dbox_friction: np.ndarray  # (D,)
    dbox_margin: np.ndarray    # (D,)
    qpair_s: np.ndarray        # (Q,) sphere index
    qpair_b: np.ndarray        # (Q,) dyn box index


def _geom_test_spheres(g: Geom):
    """[(local_pos, radius)] test-sphere decomposition of a dynamic geom."""
    R = _quat_to_mat_np(np.asarray(g.quat))
    p = np.asarray(g.pos, dtype=np.float64)
    if g.gtype == GEOM_SPHERE:
        return [(p, g.size[0])]
    if g.gtype == GEOM_CAPSULE:
        r, hl = g.size[0], g.size[1]
        axis = R[:, 2]
        return [
            (p + axis * (hl * t), r)
            for t in np.linspace(-1.0, 1.0, CAPSULE_SAMPLES)
        ]
    if g.gtype == GEOM_BOX:
        out = []
        hx, hy, hz = g.size
        for sx in (-1.0, 1.0):
            for sy in (-1.0, 1.0):
                for sz in (-1.0, 1.0):
                    out.append((p + R @ np.array([sx * hx, sy * hy, sz * hz]), 0.0))
        return out
    raise NotImplementedError(f"dynamic geom type {g.gtype}")


def build_contact_set(model: RigidModel, extra_margin: float = 0.0) -> ContactSet:
    """Static enumeration of candidate contacts.

    Pairs follow MuJoCo's contype/conaffinity masks with the default
    parent-child exclusion for dynamic-dynamic pairs.
    """
    sph_body: List[int] = []
    sph_local: List[np.ndarray] = []
    sph_radius: List[float] = []
    sph_solref: List[Tuple[float, float]] = []
    sph_solimp: List[Tuple[float, float, float]] = []
    sph_friction: List[float] = []
    sph_margin: List[float] = []
    sph_vs_static: List[bool] = []
    geom_sphere_ids: List[Tuple[int, Geom, List[int]]] = []

    statics = model.static_geoms or []
    any_static = any(g.gtype in (GEOM_BOX, GEOM_PLANE) for g in statics)

    def collidable(g1: Geom, g2: Geom) -> bool:
        return bool((g1.contype & g2.conaffinity) or (g2.contype & g1.conaffinity))

    dbox_body: List[int] = []
    dbox_local: List[np.ndarray] = []
    dbox_half: List[np.ndarray] = []
    dbox_solref: List[Tuple[float, float]] = []
    dbox_solimp: List[Tuple[float, float, float]] = []
    dbox_friction: List[float] = []
    dbox_margin: List[float] = []
    dyn_boxes: List[Tuple[int, Geom, int]] = []

    for body, g in model.geoms:
        if g.contype == 0 and g.conaffinity == 0:
            continue
        if g.gtype == GEOM_BOX:
            # Moving boxes (maze blocks) collide with robot spheres only:
            # their slide-joint limits already encode block-vs-wall and
            # block-vs-chasm-floor constraints, and support on platforms is
            # a dedicated impedance (envs/env.py) — static contacts on the
            # box would be all degenerate corner-on-face cases.
            dyn_boxes.append((body, g, len(dbox_body)))
            dbox_body.append(body)
            dbox_local.append(np.asarray(g.pos, dtype=np.float64))
            dbox_half.append(np.asarray(g.size, dtype=np.float64))
            dbox_solref.append(tuple(g.solref))
            dbox_solimp.append(tuple(g.solimp))
            dbox_friction.append(g.friction[0])
            dbox_margin.append(g.margin)
            continue
        ids = []
        vs_static = any_static and any(collidable(g, sg) for sg in statics)
        for local, r in _geom_test_spheres(g):
            ids.append(len(sph_body))
            sph_body.append(body)
            sph_local.append(local)
            sph_radius.append(r)
            sph_solref.append(tuple(g.solref))
            sph_solimp.append(tuple(g.solimp))
            sph_friction.append(g.friction[0])
            sph_margin.append(g.margin + extra_margin)
            sph_vs_static.append(vs_static)
        geom_sphere_ids.append((body, g, ids))

    # dynamic-dynamic pairs: different bodies, not ancestor-related
    parent = model.body_parent

    def related(a: int, b: int) -> bool:
        x = a
        while x >= 0:
            if x == b:
                return True
            x = int(parent[x])
        x = b
        while x >= 0:
            if x == a:
                return True
            x = int(parent[x])
        return False

    pair_i: List[int] = []
    pair_j: List[int] = []
    for a in range(len(geom_sphere_ids)):
        b1, g1, ids1 = geom_sphere_ids[a]
        for b in range(a + 1, len(geom_sphere_ids)):
            b2, g2, ids2 = geom_sphere_ids[b]
            if b1 == b2 or related(b1, b2):
                continue
            if not collidable(g1, g2):
                continue
            for i in ids1:
                for j in ids2:
                    pair_i.append(i)
                    pair_j.append(j)
    qpair_s: List[int] = []
    qpair_b: List[int] = []
    for b1, g1, ids1 in geom_sphere_ids:
        for b2, g2, d_idx in dyn_boxes:
            if b1 == b2 or related(b1, b2):
                continue
            if not collidable(g1, g2):
                continue
            for i in ids1:
                qpair_s.append(i)
                qpair_b.append(d_idx)

    boxes_c, boxes_h, boxes_m = [], [], []
    has_floor, floor_z, floor_margin = False, 0.0, 0.0
    for sg in statics:
        if sg.gtype == GEOM_PLANE:
            has_floor = True
            floor_z = sg.pos[2]
            floor_margin = sg.margin
        elif sg.gtype == GEOM_BOX:
            boxes_c.append(np.asarray(sg.pos, dtype=np.float64))
            boxes_h.append(np.asarray(sg.size, dtype=np.float64))
            boxes_m.append(sg.margin)

    return ContactSet(
        sph_body=np.asarray(sph_body, dtype=np.int32),
        sph_local=np.asarray(sph_local, dtype=np.float64).reshape(-1, 3),
        sph_radius=np.asarray(sph_radius, dtype=np.float64),
        sph_solref=np.asarray(sph_solref, dtype=np.float64).reshape(-1, 2),
        sph_solimp=np.asarray(sph_solimp, dtype=np.float64).reshape(-1, 3),
        sph_friction=np.asarray(sph_friction, dtype=np.float64),
        sph_margin=np.asarray(sph_margin, dtype=np.float64),
        sph_vs_static=np.asarray(sph_vs_static, dtype=bool),
        box_center=(
            np.asarray(boxes_c, dtype=np.float64).reshape(-1, 3)
            if boxes_c
            else np.zeros((0, 3))
        ),
        box_half=(
            np.asarray(boxes_h, dtype=np.float64).reshape(-1, 3)
            if boxes_h
            else np.zeros((0, 3))
        ),
        box_margin=np.asarray(boxes_m, dtype=np.float64),
        has_floor=has_floor,
        floor_z=floor_z,
        floor_margin=floor_margin,
        pair_i=np.asarray(pair_i, dtype=np.int32),
        pair_j=np.asarray(pair_j, dtype=np.int32),
        dbox_body=np.asarray(dbox_body, dtype=np.int32),
        dbox_local=np.asarray(dbox_local, dtype=np.float64).reshape(-1, 3),
        dbox_half=np.asarray(dbox_half, dtype=np.float64).reshape(-1, 3),
        dbox_solref=np.asarray(dbox_solref, dtype=np.float64).reshape(-1, 2),
        dbox_solimp=np.asarray(dbox_solimp, dtype=np.float64).reshape(-1, 3),
        dbox_friction=np.asarray(dbox_friction, dtype=np.float64),
        dbox_margin=np.asarray(dbox_margin, dtype=np.float64),
        qpair_s=np.asarray(qpair_s, dtype=np.int32),
        qpair_b=np.asarray(qpair_b, dtype=np.int32),
    )


# Projected-Jacobi sweep count of the contact solve (the JAX package's
# default, ``contact.py`` CONTACT_SOLVER_ITERS); the CUDA kernel runs the
# same count.
CONTACT_SOLVER_ITERS = 4


def _min_exit_normal(local: torch.Tensor, bh: torch.Tensor):
    """Branch-free min-exit-axis normal for a point inside a box: returns
    ``(n_in (..., 3), pen_in (...))``.  The x axis wins ties, then y."""
    exit_d = bh - torch.abs(local)
    ex, ey, ez = exit_d[..., 0], exit_d[..., 1], exit_d[..., 2]
    m = torch.minimum(torch.minimum(ex, ey), ez)
    is_x = ex <= torch.minimum(ey, ez)
    is_y = (~is_x) & (ey <= ez)
    is_z = (~is_x) & (~is_y)
    one = torch.ones_like(local)
    sgn = torch.where(local >= 0, one, -one)
    zero = torch.zeros_like(ex)
    n_in = torch.stack([torch.where(is_x, sgn[..., 0], zero),
                        torch.where(is_y, sgn[..., 1], zero),
                        torch.where(is_z, sgn[..., 2], zero)], dim=-1)
    return n_in, -m


def _check_supported(cs: ContactSet) -> None:
    if len(cs.pair_i) or len(cs.qpair_s):
        raise NotImplementedError(
            "sphere-sphere pairs and movable boxes (the Ant object worlds) "
            "are not ported yet (ROADMAP queue 1 item 11)")
    n = (int(np.sum(cs.sph_vs_static))
         * (int(cs.has_floor) + min(len(cs.box_center), 2)))
    if n > MAX_ACTIVE_CONTACTS:
        raise NotImplementedError(
            f"{n} candidate contacts: the top-{MAX_ACTIVE_CONTACTS} selection "
            "of the JAX package is not ported yet (ROADMAP queue 1 item 11)")


class _Consts(NamedTuple):
    """A contact set's arrays as tensors on one device, over the test
    spheres that meet the world, and per candidate contact in the order
    [floor; nearest box; second box] (see ``_consts``)."""

    sph_body: torch.Tensor     # (s,) long
    local: torch.Tensor        # (s, 3)
    radius: torch.Tensor       # (s,)
    margin: torch.Tensor       # (s,)
    floor_margin: torch.Tensor  # (s,) sphere + floor margin
    box_center: torch.Tensor   # (nbox, 3)
    box_half: torch.Tensor     # (nbox, 3)
    box_margin: torch.Tensor   # (nbox,)
    sign_mask: torch.Tensor    # (C, nv) 1 on the dofs that move the sphere
    mu: torch.Tensor           # (C,)
    d0: torch.Tensor           # (C,) solimp
    dmax: torch.Tensor
    width: torch.Tensor
    tc: torch.Tensor           # (C,) solref time constant, >= 2 dt
    dampr: torch.Tensor        # (C,) solref damping ratio
    axes: torch.Tensor         # (3, 3) the unit vectors x, y, z


_CONSTS: dict = {}


def _consts(model: RigidModel, cs: ContactSet, chain_mask: np.ndarray,
            ref: torch.Tensor) -> _Consts:
    """Built once per (contact set, dtype, device) and cached: a host-to-
    device copy per array per forward evaluation would cost more than the
    contact arithmetic.  The cache keeps the contact set alive, so its id
    is not reused."""
    key = (id(cs), ref.dtype, ref.device)
    if key not in _CONSTS:
        def c(x):
            return torch.as_tensor(np.asarray(x), dtype=ref.dtype,
                                   device=ref.device)

        idx = np.nonzero(cs.sph_vs_static)[0]
        groups = int(cs.has_floor) + min(len(cs.box_center), 2)
        sph = np.tile(idx, groups)
        b1 = cs.sph_body[sph]
        sim, srf = cs.sph_solimp[sph], cs.sph_solref[sph]
        _CONSTS[key] = (cs, _Consts(
            sph_body=torch.as_tensor(cs.sph_body[idx], dtype=torch.long,
                                     device=ref.device),
            local=c(cs.sph_local[idx]), radius=c(cs.sph_radius[idx]),
            margin=c(cs.sph_margin[idx]),
            floor_margin=c(cs.sph_margin[idx] + cs.floor_margin),
            box_center=c(cs.box_center), box_half=c(cs.box_half),
            box_margin=c(cs.box_margin),
            sign_mask=c(np.asarray(chain_mask, np.float64).T[b1]),
            mu=c(cs.sph_friction[sph]),
            d0=c(sim[:, 0]), dmax=c(sim[:, 1]), width=c(sim[:, 2]),
            tc=torch.clamp(c(srf[:, 0]), min=2.0 * model.timestep),
            dampr=c(srf[:, 1]), axes=c(np.eye(3)),
        ))
    return _CONSTS[key][1]


def contact_qfrc(model: RigidModel, cs: ContactSet, kd, qvel: torch.Tensor,
                 qacc0: torch.Tensor, Minv: torch.Tensor,
                 chain_mask: np.ndarray) -> torch.Tensor:
    """Total generalized contact force ``(B, nv)`` over all candidate
    contacts of a robot in a static world."""
    _check_supported(cs)
    _engine._check_precision(qvel)
    B, nv = qvel.shape
    if not np.any(cs.sph_vs_static) or not (cs.has_floor or len(cs.box_center)):
        return torch.zeros_like(qvel)
    K = _consts(model, cs, chain_mask, qvel)
    body_R = torch.stack(kd.fkr.body_rot, dim=1)[:, K.sph_body]  # (B, s, 3, 3)
    body_p = torch.stack(kd.fkr.body_pos, dim=1)[:, K.sph_body]  # (B, s, 3)
    c = body_p + _engine.mat_vec(body_R, K.local)               # (B, s, 3)
    r = K.radius
    s_ = c.shape[1]

    # candidate contacts: [floor; nearest box; second box], each over the
    # spheres that meet the world
    dists, poss, normals, margins = [], [], [], []
    # -- spheres vs floor plane ------------------------------------------
    if cs.has_floor:
        dists.append(c[..., 2] - cs.floor_z - r)
        poss.append(torch.cat([c[..., :2], (c[..., 2] - r)[..., None]], -1))
        normals.append(K.axes[2].expand(B, s_, 3))
        margins.append(K.floor_margin.expand(B, s_))
    # -- spheres vs static AABBs: the two nearest per sphere --------------
    nbox = len(cs.box_center)
    if nbox > 0:
        bc, bh = K.box_center, K.box_half
        local = c[:, :, None, :] - bc                           # (B, s, nb, 3)
        clamped = torch.maximum(torch.minimum(local, bh), -bh)
        delta = local - clamped
        d_out = torch.sqrt(torch.sum(delta * delta, dim=-1) + 1e-12)
        outside = d_out > 1e-6
        n_out = delta / d_out[..., None]
        n_in, pen_in = _min_exit_normal(local, bh)
        dist = torch.where(outside, d_out - r[:, None], pen_in - r[:, None])
        n = torch.where(outside[..., None], n_out, n_in)
        surf = torch.where(outside[..., None], clamped,
                           local - n_in * pen_in[..., None])
        pos = bc + surf
        # rank by the margin-adjusted distance; the first of equal keys
        # wins, as the JAX package's strict-< insertion chain
        eff = dist - K.box_margin
        first = torch.argmin(eff, dim=-1, keepdim=True)         # (B, s, 1)
        picks = [first]
        if nbox > 1:
            eff2 = eff.scatter(-1, first, float("inf"))
            picks.append(torch.argmin(eff2, dim=-1, keepdim=True))
        for k in picks:
            k3 = k[..., None].expand(B, s_, 1, 3)
            dists.append(torch.gather(dist, -1, k)[..., 0])
            poss.append(torch.gather(pos, 2, k3)[:, :, 0])
            normals.append(torch.gather(n, 2, k3)[:, :, 0])
            margins.append(K.margin + K.box_margin[k[..., 0]])

    dist = torch.cat(dists, dim=1)                              # (B, C)
    pos = torch.cat(poss, dim=1)                                # (B, C, 3)
    normal = torch.cat(normals, dim=1)
    margin = torch.cat(margins, dim=1)
    sign_mask, mu = K.sign_mask, K.mu
    d0, dmax, width, tc, dampr = K.d0, K.dmax, K.width, K.tc, K.dampr

    # tangent frames
    use_x = (torch.abs(normal[..., 0]) < 0.5)[..., None]
    refv = torch.where(use_x, K.axes[0], K.axes[1])
    cross = torch.linalg.cross
    t1 = cross(normal, refv)
    t1 = t1 / torch.sqrt(torch.sum(t1 * t1, dim=-1, keepdim=True) + 1e-12)
    t2 = cross(normal, t1)

    cdof_T = kd.cdof.transpose(-1, -2)                          # (B, 6, nv)

    rel = pos - kd.origin[:, None]     # about the engine's reference point

    def jrows(direction):
        F = torch.cat([cross(rel, direction), direction], dim=-1)  # (B, C, 6)
        return (F @ cdof_T) * sign_mask                         # (B, C, nv)

    Jn, Jt1, Jt2 = jrows(normal), jrows(t1), jrows(t2)

    # impedance constants per contact (tc carries MuJoCo's >= 2*timestep
    # stability clamp)
    b_imp = 2.0 / (dmax * tc)
    active = dist < margin
    r = dist - margin
    imp = d0 + (dmax - d0) * torch.clamp(-r / width, 0.0, 1.0)
    k_imp = imp / (dmax * dmax * tc * tc * dampr * dampr)

    def mv(m, x):
        return _engine.mat_vec(m, x)

    # stacked constraint rows [normals; tangent1; tangent2] → (B, 3C, nv)
    J = torch.cat([Jn, Jt1, Jt2], dim=1)
    aref = torch.cat([-b_imp * mv(Jn, qvel) - k_imp * r,
                      -b_imp * mv(Jt1, qvel),
                      -b_imp * mv(Jt2, qvel)], dim=1)
    a0 = mv(J, qacc0)
    JM = J @ Minv
    A_diag = torch.sum(JM * J, dim=-1)
    imp3 = imp.repeat(1, 3)
    # MuJoCo regularization: R_ii = (1-d)/d * A_ii
    Rreg = (1.0 - imp3) / torch.clamp(imp3, min=1e-6) * A_diag
    denom = A_diag + Rreg + 1e-9
    C = Jn.shape[1]
    zero = torch.zeros_like(dist)

    def project(f):
        f_n = torch.where(active, torch.clamp(f[:, :C], min=0.0), zero)
        ft1, ft2 = f[:, C:2 * C], f[:, 2 * C:]
        ft_norm = torch.sqrt(ft1 ** 2 + ft2 ** 2 + 1e-12)
        scale = torch.clamp(mu * f_n / ft_norm, max=1.0)
        return torch.cat([f_n, torch.where(active, ft1 * scale, zero),
                          torch.where(active, ft2 * scale, zero)], dim=1)

    # projected Jacobi on (A + R) f = aref − a0: parallel over all rows,
    # cone projection each sweep
    omega = 0.6
    J_T = J.transpose(-1, -2)
    f = project((aref - a0) / denom)
    for _ in range(CONTACT_SOLVER_ITERS):
        a_f = mv(J, mv(Minv, mv(J_T, f)))
        resid = aref - a0 - a_f - Rreg * f
        f = project(f + omega * resid / denom)
    return mv(J_T, f)
