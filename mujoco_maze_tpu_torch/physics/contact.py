"""Collision detection + contact forces on batched torch tensors.

Port of ``mujoco_maze_tpu.physics.contact`` for robots in worlds of
static boxes, movable (slide-jointed) boxes and free object balls:

* the static enumeration of candidate contacts (:class:`ContactSet`,
  :func:`build_contact_set`) is a numpy copy of the JAX package's: every
  dynamic geom lowers to a fixed set of **test spheres** (sphere → itself;
  capsule → 3 samples along its axis; box → its corners with radius 0);
  every static world geom is an axis-aligned box or the floor plane; two
  test spheres of unrelated bodies (a robot's and an object ball's) meet
  in a sphere-sphere pair, and a movable box meets the robot's spheres in
  sphere-vs-moving-box pairs;
* :func:`contact_qfrc` detects spheres vs the floor plane, vs the static
  boxes (the two nearest boxes per sphere), vs each other in the pairs and
  vs every movable box, and solves MuJoCo's impedance dynamics per
  contact with projected Jacobi on the regularised Delassus matrix,
  batch-first;
* :func:`falling_support_force` is the closed-form coupled platform
  support and z limit of a falling block (the Fall worlds).
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


def candidate_count(cs: ContactSet) -> int:
    """Candidate contacts of a contact set: floor and the two nearest
    static boxes per sphere that meets the world, every sphere-sphere
    pair and every sphere-vs-moving-box pair."""
    return (int(np.sum(cs.sph_vs_static))
            * (int(cs.has_floor) + min(len(cs.box_center), 2))
            + len(cs.pair_i) + len(cs.qpair_s))


def _check_supported(cs: ContactSet) -> None:
    n = candidate_count(cs)
    if n > MAX_ACTIVE_CONTACTS:
        raise NotImplementedError(
            f"{n} candidate contacts: the top-{MAX_ACTIVE_CONTACTS} selection "
            "of the JAX package is not ported yet (ROADMAP queue 1 item 11)")


class _Consts(NamedTuple):
    """A contact set's arrays as tensors on one device, over the test
    spheres that meet the world, and per candidate contact in the JAX
    package's order [floor; nearest box; second box; sphere-sphere pairs;
    sphere-vs-moving-box pairs] (see ``_consts``)."""

    sph_body_all: torch.Tensor  # (S,) long, every test sphere
    local_all: torch.Tensor    # (S, 3)
    static_idx: torch.Tensor   # (s,) long: the spheres that meet the world
    sph_body: torch.Tensor     # (s,) long
    local: torch.Tensor        # (s, 3)
    radius: torch.Tensor       # (s,)
    margin: torch.Tensor       # (s,)
    floor_margin: torch.Tensor  # (s,) sphere + floor margin
    box_center: torch.Tensor   # (nbox, 3)
    box_half: torch.Tensor     # (nbox, 3)
    box_margin: torch.Tensor   # (nbox,)
    p_i: torch.Tensor          # (P,) long: the pairs' first spheres
    p_j: torch.Tensor          # (P,) long: their second spheres
    p_rj: torch.Tensor         # (P,) the second sphere's radius
    p_rsum: torch.Tensor       # (P,) the two radii's sum
    p_margin: torch.Tensor     # (P,) the two spheres' margins summed
    q_sph: torch.Tensor        # (Q,) long: the sphere of each moving-box pair
    q_radius: torch.Tensor     # (Q,)
    q_body: torch.Tensor       # (Q,) long: the box's body
    q_local: torch.Tensor      # (Q, 3) box offset in its body frame
    q_half: torch.Tensor       # (Q, 3)
    q_margin: torch.Tensor     # (Q,) sphere + box margin
    sign_mask: torch.Tensor    # (C, nv) 1 on the dofs that move the sphere,
                               # -1 on those that move a pair's second
                               # sphere or box
    mu: torch.Tensor           # (C,)
    d0: torch.Tensor           # (C,) solimp
    dmax: torch.Tensor
    width: torch.Tensor
    tc: torch.Tensor           # (C,) solref time constant, >= 2 dt
    dampr: torch.Tensor        # (C,) solref damping ratio
    axes: torch.Tensor         # (3, 3) the unit vectors x, y, z
    trees: tuple               # per kinematic tree with dofs: its root body
                               # and its dofs, (long), in dof order
    tree_order: torch.Tensor   # (nv,) long: the dofs' places in the trees'
                               # concatenation


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

        def index(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=ref.device)

        idx = np.nonzero(cs.sph_vs_static)[0]
        groups = int(cs.has_floor) + min(len(cs.box_center), 2)
        if not np.any(cs.sph_vs_static):
            groups = 0
        sph = np.tile(idx, groups)
        pi, pj = cs.pair_i, cs.pair_j
        qs, qb = cs.qpair_s, cs.qpair_b
        cm = np.asarray(chain_mask, np.float64).T     # (nb, nv)
        roots = _engine.tree_roots(model)
        dof_root = [roots[b] for b in _engine.get_masks(model)[0]]
        trees = [(r, [d for d in range(model.nv) if dof_root[d] == r])
                 for r in sorted(set(dof_root))]
        order = np.argsort(np.concatenate([d for _, d in trees]))
        # pair mixing of the sphere-sphere and moving-box rows (JAX
        # contact.py:438-441, 474-477)
        sim = np.concatenate([cs.sph_solimp[sph],
                              (cs.sph_solimp[pi] + cs.sph_solimp[pj]) / 2,
                              (cs.sph_solimp[qs] + cs.dbox_solimp[qb]) / 2])
        srf = np.concatenate([cs.sph_solref[sph],
                              (cs.sph_solref[pi] + cs.sph_solref[pj]) / 2,
                              (cs.sph_solref[qs] + cs.dbox_solref[qb]) / 2])
        mu = np.concatenate([cs.sph_friction[sph],
                             np.maximum(cs.sph_friction[pi],
                                        cs.sph_friction[pj]),
                             np.maximum(cs.sph_friction[qs],
                                        cs.dbox_friction[qb])])
        sign = np.concatenate([cm[cs.sph_body[sph]],
                               cm[cs.sph_body[pi]] - cm[cs.sph_body[pj]],
                               cm[cs.sph_body[qs]] - cm[cs.dbox_body[qb]]])
        _CONSTS[key] = (cs, _Consts(
            sph_body_all=index(cs.sph_body), local_all=c(cs.sph_local),
            static_idx=index(idx), sph_body=index(cs.sph_body[idx]),
            local=c(cs.sph_local[idx]), radius=c(cs.sph_radius[idx]),
            margin=c(cs.sph_margin[idx]),
            floor_margin=c(cs.sph_margin[idx] + cs.floor_margin),
            box_center=c(cs.box_center), box_half=c(cs.box_half),
            box_margin=c(cs.box_margin),
            p_i=index(pi), p_j=index(pj), p_rj=c(cs.sph_radius[pj]),
            p_rsum=c(cs.sph_radius[pi]) + c(cs.sph_radius[pj]),
            p_margin=c(cs.sph_margin[pi] + cs.sph_margin[pj]),
            q_sph=index(qs), q_radius=c(cs.sph_radius[qs]),
            q_body=index(cs.dbox_body[qb]), q_local=c(cs.dbox_local[qb]),
            q_half=c(cs.dbox_half[qb]),
            q_margin=c(cs.sph_margin[qs] + cs.dbox_margin[qb]),
            sign_mask=c(sign), mu=c(mu),
            d0=c(sim[:, 0]), dmax=c(sim[:, 1]), width=c(sim[:, 2]),
            tc=torch.clamp(c(srf[:, 0]), min=2.0 * model.timestep),
            dampr=c(srf[:, 1]), axes=c(np.eye(3)),
            trees=tuple((r, index(d)) for r, d in trees),
            tree_order=index(order),
        ))
    return _CONSTS[key][1]


def _has_candidates(cs: ContactSet) -> bool:
    statics = np.any(cs.sph_vs_static) and (cs.has_floor or len(cs.box_center))
    return bool(statics or len(cs.pair_i) or len(cs.qpair_s))


def _detect(cs: ContactSet, K: _Consts, kd):
    """Every candidate contact's ``(dist (B, C), pos (B, C, 3), normal
    (B, C, 3), margin (B, C), inside (B, C))``, in the order [floor;
    nearest box; second box] over the spheres that meet the world, then
    the sphere-sphere pairs and the sphere-vs-moving-box pairs in the
    contact set's order; ``inside``: the sphere's centre lies in its box
    (never, for a sphere-sphere pair)."""
    statics = np.any(cs.sph_vs_static) and (cs.has_floor or len(cs.box_center))
    B = kd.origin.shape[0]
    R_all = torch.stack(kd.fkr.body_rot, dim=1)                 # (B, nb, 3, 3)
    p_all = torch.stack(kd.fkr.body_pos, dim=1)                 # (B, nb, 3)
    c_all = (p_all[:, K.sph_body_all]
             + _engine.mat_vec(R_all[:, K.sph_body_all], K.local_all))
    c = c_all[:, K.static_idx]                                  # (B, s, 3)
    r = K.radius
    s_ = c.shape[1]

    # candidate contacts: [floor; nearest box; second box], each over the
    # spheres that meet the world
    dists, poss, normals, margins, insides = [], [], [], [], []
    # -- spheres vs floor plane ------------------------------------------
    if cs.has_floor and statics:
        insides.append(torch.zeros_like(c[..., 2], dtype=torch.bool))
        dists.append(c[..., 2] - cs.floor_z - r)
        poss.append(torch.cat([c[..., :2], (c[..., 2] - r)[..., None]], -1))
        normals.append(K.axes[2].expand(B, s_, 3))
        margins.append(K.floor_margin.expand(B, s_))
    # -- spheres vs static AABBs: the two nearest per sphere --------------
    nbox = len(cs.box_center) if statics else 0
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
            insides.append(~torch.gather(outside, -1, k)[..., 0])
            dists.append(torch.gather(dist, -1, k)[..., 0])
            poss.append(torch.gather(pos, 2, k3)[:, :, 0])
            normals.append(torch.gather(n, 2, k3)[:, :, 0])
            margins.append(K.margin + K.box_margin[k[..., 0]])
    # -- sphere-sphere pairs: the normal along the centre line, from the
    # second sphere to the first, the point midway through the overlap
    # (JAX contact.py:423-443) ----------------------------------------------
    if len(cs.pair_i):
        ci, cj = c_all[:, K.p_i], c_all[:, K.p_j]                # (B, P, 3)
        d = ci - cj
        dn = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
        n = d / dn[..., None]
        dist = dn - K.p_rsum
        insides.append(torch.zeros_like(dist, dtype=torch.bool))
        dists.append(dist)
        poss.append(cj + n * (K.p_rj + dist * 0.5)[..., None])
        normals.append(n)
        margins.append(K.p_margin.expand(B, -1))
    # -- spheres vs moving boxes, every pair, in the box frame -------------
    if len(cs.qpair_s):
        cq = c_all[:, K.q_sph]                                  # (B, Q, 3)
        Rb = R_all[:, K.q_body]                                 # (B, Q, 3, 3)
        bcq = p_all[:, K.q_body] + _engine.mat_vec(Rb, K.q_local)
        RbT = Rb.transpose(-1, -2)
        local = _engine.mat_vec(RbT, cq - bcq)
        bh = K.q_half
        clamped = torch.maximum(torch.minimum(local, bh), -bh)
        delta = local - clamped
        d_out = torch.sqrt(torch.sum(delta * delta, dim=-1) + 1e-12)
        outside = d_out > 1e-6
        n_out = delta / d_out[..., None]
        n_in, pen_in = _min_exit_normal(local, bh)
        insides.append(~outside)
        dists.append(torch.where(outside, d_out - K.q_radius,
                                 pen_in - K.q_radius))
        n_local = torch.where(outside[..., None], n_out, n_in)
        surf = torch.where(outside[..., None], clamped,
                           local - n_in * pen_in[..., None])
        normals.append(_engine.mat_vec(Rb, n_local))
        poss.append(bcq + _engine.mat_vec(Rb, surf))
        margins.append(K.q_margin.expand(B, -1))

    return (torch.cat(dists, dim=1), torch.cat(poss, dim=1),
            torch.cat(normals, dim=1), torch.cat(margins, dim=1),
            torch.cat(insides, dim=1))


def active_candidates(model: RigidModel, cs: ContactSet, kd,
                      chain_mask: np.ndarray) -> torch.Tensor:
    """``(B, C)`` bool: the candidate contacts (``_detect``'s order) that
    are active, dist < margin.  For checks: the solve adds force on these
    only."""
    ref = kd.origin
    if not _has_candidates(cs):
        return torch.zeros((ref.shape[0], 0), dtype=torch.bool,
                           device=ref.device)
    dist, _, _, margin, _ = _detect(cs, _consts(model, cs, chain_mask, ref),
                                    kd)
    return dist < margin


def contact_qfrc(model: RigidModel, cs: ContactSet, kd, qvel: torch.Tensor,
                 qacc0: torch.Tensor, Minv: torch.Tensor,
                 chain_mask: np.ndarray) -> torch.Tensor:
    """Total generalized contact force ``(B, nv)`` over all candidate
    contacts of a robot in a world of static and moving boxes."""
    _check_supported(cs)
    _engine._check_precision(qvel)
    B, nv = qvel.shape
    if not _has_candidates(cs):
        return torch.zeros_like(qvel)
    K = _consts(model, cs, chain_mask, qvel)
    dist, pos, normal, margin, _ = _detect(cs, K, kd)
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
    # the moment arm about each tree's reference point, for its columns
    rels = [(pos - kd.body_origin[:, root, None], dofs)
            for root, dofs in K.trees]

    def jrows(direction):
        J = torch.cat([torch.cat([cross(rel, direction), direction], dim=-1)
                       @ cdof_T[:, :, dofs] for rel, dofs in rels], dim=-1)
        return J[..., K.tree_order] * sign_mask                 # (B, C, nv)

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


def falling_support_force(z, bottom, s, vz, a0, w, tc: float, mu: float = 1.0,
                          lim_margin: float = 0.01):
    """Coupled platform-support + upper-z-limit impedance force of a falling
    (z-slide) block (JAX contact.py:627-680), elementwise over ``(B,)``
    tensors.

    The reference block is built overlapping its own elevated platform;
    box-box contact pops it on top, where it perches with its (-h, 0) z
    limit softly violated by ~h: an equilibrium between the saturated
    platform contact (solimp .995/.995/.01, 4 face corners x 4 pyramid
    facets) and the saturated soft limit (solimp .9/.95/.001).  Pushed past
    the platform's edge the support target drops to the floor plane and
    the block falls flush (the Fall bridge).

    The two rows share one diagonal dof, so the coupled solve is closed
    form with a unilateral case analysis (``falling_support_case``).
    ``z``: the z slide's value; ``bottom``: the box's bottom height;
    ``s``: the support target (the highest overlapped platform top, else
    0); ``w``: the dof's inverse weight (1/mass); ``a0``: the smooth z
    acceleration.  Returns the net generalized force on the z dof.
    """
    return _support_solve(z, bottom, s, vz, a0, w, tc, mu, lim_margin)[0]


def falling_support_case(z, bottom, s, vz, a0, w, tc: float, mu: float = 1.0,
                         lim_margin: float = 0.01) -> torch.Tensor:
    """Which rows ``falling_support_force`` solves, elementwise: 0 neither,
    1 the platform row alone, 2 the limit alone, 3 both (for checks)."""
    return _support_solve(z, bottom, s, vz, a0, w, tc, mu, lim_margin)[1]


def _support_solve(z, bottom, s, vz, a0, w, tc, mu, lim_margin):
    d_c = 0.995
    k_c = d_c / (0.995 * 0.995 * tc * tc)
    b_c = 2.0 / (0.995 * tc)
    pen_c = s - bottom
    aref_c = -b_c * vz + k_c * pen_c
    R_c = ((1.0 - d_c) / d_c) * (2.0 * (1.0 + mu * mu)) * w / 16.0
    act_c = pen_c > 0.0
    pen_l = z + lim_margin
    x = torch.clamp(pen_l / 0.001, 0.0, 1.0)
    y = torch.where(x < 0.5, 2.0 * x * x, 1.0 - 2.0 * (1.0 - x) * (1.0 - x))
    d_l = 0.9 + y * 0.05
    k_l = d_l / (0.95 * 0.95 * tc * tc)
    b_l = 2.0 / (0.95 * tc)
    aref_l = b_l * vz + k_l * pen_l
    R_l = ((1.0 - d_l) / d_l) * w
    act_l = pen_l > 0.0
    qa_both = ((a0 + w * aref_c / R_c - w * aref_l / R_l)
               / (1.0 + w / R_c + w / R_l))
    qa_c = (a0 + w * aref_c / R_c) / (1.0 + w / R_c)
    qa_l = (a0 - w * aref_l / R_l) / (1.0 + w / R_l)
    fc_both = (aref_c - qa_both) / R_c
    fl_both = (aref_l + qa_both) / R_l
    fc_only = (aref_c - qa_c) / R_c
    fl_only = (aref_l + qa_l) / R_l
    use_c = act_c & (fc_only > 0.0)
    use_l = act_l & (fl_only > 0.0)
    both = use_c & use_l & (fc_both > 0.0) & (fl_both > 0.0)
    zero = torch.zeros_like(fc_only)
    force = torch.where(
        both, fc_both - fl_both,
        torch.where(use_c, torch.clamp(fc_only, min=0.0),
                    torch.where(use_l, -torch.clamp(fl_only, min=0.0), zero)))
    case = torch.where(both, 3, torch.where(use_c, 1, torch.where(use_l, 2, 0)))
    return force, case
