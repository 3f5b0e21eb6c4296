"""Forward dynamics engine: FK → CRBA → RNEA → passive → RK4, batch-first.

Port of ``mujoco_maze_tpu.physics.engine``.  Where the JAX engine is
written per env and vectorised with ``vmap``, every function here takes
batched tensors: ``qpos (B, nq)``, ``qvel (B, nv)``, ``ctrl (B, nu)``.
The loops over bodies and joints run over the static
:class:`~.model.RigidModel` in Python; each iteration acts on the whole
batch.  This is the plain PyTorch path of the Ant: the step kernel
(``csrc/ant_lane.cuh``) is held against it.

Conventions: spatial motion vectors ``[ω; v]`` in world axes; qvel of
free joints is (linear world, angular body-frame) matching MuJoCo's
convention; quaternions (w, x, y, z).

The spatial reference points.  The JAX engine takes spatial vectors about
the world origin; this one takes each kinematic tree's about the origin of
its root body (``KinDyn.body_origin``: the robot's torso, a block's or a
free ball's own origin), per env.  M, the bias and every generalized force
are the same for any reference point, but about a far point the float32
products cancel terms of order m r² (r the tree's distance from it: up to
~35 from the world origin in the Ant mazes, or the roller and the ball of
a SmallBilliard world ~10^3 apart after the roller has left the maze)
down to entries of order 1, so the rounding grows with r²; about its own
root each tree stays at its own size.  M is block diagonal over the
trees, so no product mixes two trees' points; a contact's Jacobian takes
the moment arm about each tree's point for that tree's columns.  The
CUDA kernels work about the roots too.

Float32 products must run in full float32: the CRB/RNE products cancel
large anchor terms down to small mass-matrix entries.  PyTorch's float32
matmul is full precision unless TF32 is switched on
(``torch.backends.cuda.matmul.allow_tf32``), and the engine refuses to run
on a CUDA tensor with it on.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .linalg import spd_inverse
from .math3d import (force_cross, make_spatial_inertia, mat_vec,
                     motion_cross, quat_mul, quat_to_mat, skew)
from .model import BALL, FREE, HINGE, SLIDE, RigidModel, _quat_to_mat_np

_NV = {FREE: 6, BALL: 3, SLIDE: 1, HINGE: 1}


def _check_precision(x: torch.Tensor) -> None:
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the engine needs full-precision float32 products; switch TF32 "
            "off (torch.backends.cuda.matmul.allow_tf32 = False, "
            "torch.set_float32_matmul_precision('highest'))")


def _joints_by_body(model: RigidModel) -> Dict[int, List[int]]:
    out: Dict[int, List[int]] = {}
    for j in range(model.njnt):
        out.setdefault(int(model.jnt_body[j]), []).append(j)
    return out


def _const(x, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=ref.dtype, device=ref.device)


class _Consts(NamedTuple):
    """The model's arrays as tensors on one device, built once per
    (dtype, device) and kept on the model: a step of the Ant runs 20
    forward evaluations, and a host-to-device copy per constant per
    evaluation would cost more than the arithmetic."""

    eye3: torch.Tensor          # (3, 3)
    R_off: torch.Tensor         # (nb, 3, 3) body frame in its parent
    body_pos: torch.Tensor      # (nb, 3)
    body_com: torch.Tensor      # (nb, 3)
    body_mass: torch.Tensor     # (nb,)
    body_inertia: torch.Tensor  # (nb, 3, 3)
    jnt_axis: torch.Tensor      # (nj, 3)
    jnt_pos: torch.Tensor       # (nj, 3)
    subtree: torch.Tensor       # (nb, nb)
    dof_body: torch.Tensor      # (nv,) long
    dof_anc: torch.Tensor       # (nv, nv) bool
    armature: torch.Tensor      # (nv, nv) diagonal
    damping: torch.Tensor       # (nv,)
    a0: torch.Tensor            # (6,) fictitious base acceleration [0; -g]
    lim_qadr: torch.Tensor      # (L,) long: qpos address of each limited
    lim_vadr: torch.Tensor      # (L,) long: dof of each  hinge or slide
    lim_lo: torch.Tensor        # (L,)
    lim_hi: torch.Tensor        # (L,)


def _consts(model: RigidModel, ref: torch.Tensor) -> _Consts:
    cache = model.__dict__.setdefault("_torch_consts", {})
    key = (ref.dtype, ref.device)
    if key not in cache:
        dof_body, _, dof_anc, subtree = get_masks(model)
        lim = [j for j in range(model.njnt) if model.jnt_limited[j]
               and int(model.jnt_type[j]) in (HINGE, SLIDE)]

        def c(x):
            return _const(x, ref)

        def index(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=ref.device)

        cache[key] = _Consts(
            eye3=torch.eye(3, dtype=ref.dtype, device=ref.device),
            R_off=c([_quat_to_mat_np(q) for q in model.body_quat]),
            body_pos=c(model.body_pos), body_com=c(model.body_com),
            body_mass=c(model.body_mass), body_inertia=c(model.body_inertia),
            jnt_axis=c(model.jnt_axis), jnt_pos=c(model.jnt_pos),
            subtree=c(subtree),
            dof_body=torch.as_tensor(dof_body, dtype=torch.long,
                                     device=ref.device),
            dof_anc=torch.as_tensor(dof_anc, device=ref.device),
            armature=torch.diag(c(model.dof_armature)),
            damping=c(model.dof_damping),
            a0=torch.cat([c(np.zeros(3)), -c(model.gravity)]),
            lim_qadr=index(model.jnt_qposadr[lim]),
            lim_vadr=index(model.jnt_dofadr[lim]),
            lim_lo=c(model.jnt_range[lim, 0].reshape(-1)),
            lim_hi=c(model.jnt_range[lim, 1].reshape(-1)),
        )
    return cache[key]


class FkResult(NamedTuple):
    body_rot: List[torch.Tensor]    # per body (B, 3, 3) world rotation
    body_pos: List[torch.Tensor]    # per body (B, 3) world frame origin
    body_com: List[torch.Tensor]    # per body (B, 3) world CoM
    jnt_axis_w: List[torch.Tensor]  # per joint: (B, 3) world axis, or the
                                    # (B, 3, 3) basis of a FREE / BALL joint
    jnt_anchor_w: List[torch.Tensor]  # per joint (B, 3) world anchor


def fk(model: RigidModel, qpos: torch.Tensor) -> FkResult:
    """Forward kinematics; joints applied in declaration order per body.

    A joint's world axis/anchor is captured at its place in the sequence,
    not at the body's final pose, as MuJoCo does.
    """
    B = qpos.shape[0]
    rots: List[torch.Tensor] = []
    poss: List[torch.Tensor] = []
    coms: List[torch.Tensor] = []
    jaxis: List[torch.Tensor] = [None] * model.njnt
    janchor: List[torch.Tensor] = [None] * model.njnt
    jnt_by_body = _joints_by_body(model)
    C = _consts(model, qpos)
    eye = C.eye3.expand(B, 3, 3)

    for i in range(model.nbody):
        p = int(model.body_parent[i])
        if p < 0:
            R_par, p_par = eye, torch.zeros(B, 3, dtype=qpos.dtype,
                                            device=qpos.device)
        else:
            R_par, p_par = rots[p], poss[p]
        R = R_par @ C.R_off[i]
        pos = p_par + mat_vec(R_par, C.body_pos[i].expand(B, 3))
        for j in jnt_by_body.get(i, []):
            jt = int(model.jnt_type[j])
            qadr = int(model.jnt_qposadr[j])
            axis = C.jnt_axis[j].expand(B, 3)
            jpos = C.jnt_pos[j].expand(B, 3)
            if jt == FREE:
                pos = qpos[:, qadr:qadr + 3]
                R = quat_to_mat(qpos[:, qadr + 3:qadr + 7])
                jaxis[j] = R            # rotational basis = body axes
                janchor[j] = pos
            elif jt == BALL:
                Rj = quat_to_mat(qpos[:, qadr:qadr + 4])
                anchor = pos + mat_vec(R, jpos)
                R = R @ Rj
                pos = anchor - mat_vec(R, jpos)
                jaxis[j] = R            # post-rotation body axes
                janchor[j] = anchor
            elif jt == SLIDE:
                axis_w = mat_vec(R, axis)
                pos = pos + axis_w * qpos[:, qadr, None]
                jaxis[j] = axis_w
                janchor[j] = pos
            elif jt == HINGE:
                angle = qpos[:, qadr, None, None]
                axis_w = mat_vec(R, axis)
                K = skew(axis_w)
                Rj = eye + torch.sin(angle) * K + (1 - torch.cos(angle)) * (K @ K)
                anchor = pos + mat_vec(R, jpos)
                R = Rj @ R
                pos = anchor - mat_vec(R, jpos)
                jaxis[j] = axis_w
                janchor[j] = anchor
        rots.append(R)
        poss.append(pos)
        coms.append(pos + mat_vec(R, C.body_com[i].expand(B, 3)))
    return FkResult(rots, poss, coms, jaxis, janchor)


class KinDyn(NamedTuple):
    fkr: FkResult
    origin: torch.Tensor           # (B, 3) body 0's tree's reference point
    body_origin: torch.Tensor      # (B, nb, 3) each body's tree's reference
                                   # point, its root body's origin
    cdof: torch.Tensor             # (B, nv, 6) dof motion subspace about its
                                   # tree's point
    cdof_dot: torch.Tensor         # (B, nv, 6) time derivative of cdof
    cvel: List[torch.Tensor]       # per body (B, 6) spatial velocity
    cinr: torch.Tensor             # (B, nb, 6, 6) spatial inertia per body


def kin_dyn(model: RigidModel, qpos: torch.Tensor, qvel: torch.Tensor) -> KinDyn:
    B = qpos.shape[0]
    fkr = fk(model, qpos)
    cdof_rows: List[torch.Tensor] = [None] * model.nv
    cdofdot_rows: List[torch.Tensor] = [None] * model.nv
    cvel: List[torch.Tensor] = []
    zeros3 = torch.zeros(B, 3, dtype=qpos.dtype, device=qpos.device)
    zeros6 = torch.zeros(B, 6, dtype=qpos.dtype, device=qpos.device)
    cross = torch.linalg.cross
    jnt_by_body = _joints_by_body(model)
    origins = [fkr.body_pos[r] for r in tree_roots(model)]

    for i in range(model.nbody):
        p = int(model.body_parent[i])
        v = cvel[p] if p >= 0 else zeros6
        for j in jnt_by_body.get(i, []):
            jt = int(model.jnt_type[j])
            vadr = int(model.jnt_dofadr[j])
            basis = fkr.jnt_axis_w[j]
            anchor = fkr.jnt_anchor_w[j] - origins[i]
            if jt == FREE:
                # linear dofs: world axes; angular dofs: body-frame axes
                # rotating with the body (MuJoCo free-joint qvel convention)
                for k in range(3):
                    e = _consts(model, qpos).eye3[k].expand(B, 3)
                    cdof_rows[vadr + k] = torch.cat([zeros3, e], dim=1)
                    cdofdot_rows[vadr + k] = zeros6
                    v = v + cdof_rows[vadr + k] * qvel[:, vadr + k, None]
                for k in range(3):
                    a_w = basis[:, :, k]
                    cdof_rows[vadr + 3 + k] = torch.cat([a_w, cross(anchor, a_w)], 1)
                    v = v + cdof_rows[vadr + 3 + k] * qvel[:, vadr + 3 + k, None]
                # angular axes are body-fixed: ṡ uses the body's FULL
                # velocity (they rotate with every dof of this joint)
                for k in range(3):
                    cdofdot_rows[vadr + 3 + k] = motion_cross(
                        v, cdof_rows[vadr + 3 + k])
            elif jt == BALL:
                for k in range(3):
                    a_w = basis[:, :, k]
                    cdof_rows[vadr + k] = torch.cat([a_w, cross(anchor, a_w)], 1)
                    v = v + cdof_rows[vadr + k] * qvel[:, vadr + k, None]
                for k in range(3):
                    cdofdot_rows[vadr + k] = motion_cross(v, cdof_rows[vadr + k])
            elif jt == SLIDE:
                cdof_rows[vadr] = torch.cat([zeros3, basis], dim=1)
                cdofdot_rows[vadr] = motion_cross(v, cdof_rows[vadr])
                v = v + cdof_rows[vadr] * qvel[:, vadr, None]
            elif jt == HINGE:
                cdof_rows[vadr] = torch.cat([basis, cross(anchor, basis)], 1)
                cdofdot_rows[vadr] = motion_cross(v, cdof_rows[vadr])
                v = v + cdof_rows[vadr] * qvel[:, vadr, None]
        cvel.append(v)

    cdof = torch.stack(cdof_rows, dim=1)
    cdof_dot = torch.stack(cdofdot_rows, dim=1)
    C = _consts(model, qpos)
    R = torch.stack(fkr.body_rot, dim=1)                         # (B, nb, 3, 3)
    Ic = R @ C.body_inertia @ R.transpose(-1, -2)
    body_origin = torch.stack(origins, dim=1)
    cinr = make_spatial_inertia(
        C.body_mass.expand(B, model.nbody),
        torch.stack(fkr.body_com, dim=1) - body_origin, Ic)
    return KinDyn(fkr, origins[0], body_origin, cdof, cdof_dot, cvel, cinr)


def tree_roots(model: RigidModel) -> List[int]:
    """Per body, the root body of its kinematic tree."""
    roots: List[int] = []
    for i in range(model.nbody):
        p = int(model.body_parent[i])
        roots.append(i if p < 0 else roots[p])
    return roots


def _subtree_lists(model: RigidModel):
    """For each body, the list of its descendants (incl. itself)."""
    children: Dict[int, List[int]] = {i: [] for i in range(model.nbody)}
    for i in range(model.nbody):
        p = int(model.body_parent[i])
        if p >= 0:
            children[p].append(i)
    sub: Dict[int, List[int]] = {}

    def visit(i):
        acc = [i]
        for c in children[i]:
            acc.extend(visit(c))
        sub[i] = acc
        return acc

    for i in range(model.nbody):
        if int(model.body_parent[i]) < 0:
            visit(i)
    return sub


def _dofs_of_body_chain(model: RigidModel):
    """For each body, dofs on the path from the root to that body."""
    jnt_by_body = _joints_by_body(model)
    chain: Dict[int, List[int]] = {}
    for i in range(model.nbody):
        p = int(model.body_parent[i])
        dofs = list(chain[p]) if p >= 0 else []
        for j in jnt_by_body.get(i, []):
            va = int(model.jnt_dofadr[j])
            dofs.extend(range(va, va + _NV[int(model.jnt_type[j])]))
        chain[i] = dofs
    return chain


def _ancestor_masks(model: RigidModel):
    """Static masks: dof→body, chain mask (nv, nb) [dof on root-path of a
    body], dof-ancestor mask (nv, nv), and the subtree matrix (nb, nb)."""
    chain = _dofs_of_body_chain(model)
    dof_body = np.zeros(model.nv, dtype=np.int32)
    for j in range(model.njnt):
        va = int(model.jnt_dofadr[j])
        for k in range(_NV[int(model.jnt_type[j])]):
            dof_body[va + k] = int(model.jnt_body[j])
    chain_mask = np.zeros((model.nv, model.nbody), dtype=bool)
    for b in range(model.nbody):
        for d in chain[b]:
            chain_mask[d, b] = True
    dof_anc = np.zeros((model.nv, model.nv), dtype=bool)
    for a in range(model.nv):
        for b in chain[int(dof_body[a])]:
            dof_anc[a, b] = True
    subtree = np.zeros((model.nbody, model.nbody), dtype=np.float64)
    sub = _subtree_lists(model)
    for i in range(model.nbody):
        for j_ in sub[i]:
            subtree[i, j_] = 1.0
    return dof_body, chain_mask, dof_anc, subtree


def get_masks(model: RigidModel):
    if not hasattr(model, "_masks"):
        model._masks = _ancestor_masks(model)
    return model._masks


def crb_mass_matrix(model: RigidModel, kd: KinDyn) -> torch.Tensor:
    """Composite-rigid-body mass matrix ``(B, nv, nv)`` (+armature):
    F_a = I^C_{body(a)} s_a for all dofs at once, then M = F sᵀ restricted
    to the static ancestor mask."""
    cdof = kd.cdof
    _check_precision(cdof)
    C = _consts(model, cdof)
    crb = torch.einsum("ib,nbyz->niyz", C.subtree, kd.cinr)
    crb_per_dof = crb[:, C.dof_body]
    F = (crb_per_dof @ cdof[..., None])[..., 0]                  # (B, nv, 6)
    Mfull = F @ cdof.transpose(-1, -2)                            # (B, nv, nv)
    M = torch.where(C.dof_anc, Mfull,
                    torch.where(C.dof_anc.T, Mfull.transpose(-1, -2),
                                torch.zeros((), dtype=cdof.dtype, device=cdof.device)))
    return M + C.armature


def rne_bias(model: RigidModel, kd: KinDyn, qvel: torch.Tensor) -> torch.Tensor:
    """qfrc_bias ``(B, nv)``: C(q, v)·v + gravity, via world-frame RNE with
    qacc = 0 (gravity enters as the fictitious base acceleration)."""
    _check_precision(qvel)
    B = qvel.shape[0]
    C = _consts(model, qvel)
    a0 = C.a0.expand(B, 6)
    jnt_by_body = _joints_by_body(model)
    cacc: List[torch.Tensor] = []
    for i in range(model.nbody):
        p = int(model.body_parent[i])
        a = cacc[p] if p >= 0 else a0
        for j in jnt_by_body.get(i, []):
            va = int(model.jnt_dofadr[j])
            for k in range(_NV[int(model.jnt_type[j])]):
                a = a + kd.cdof_dot[:, va + k] * qvel[:, va + k, None]
        cacc.append(a)
    cacc_s = torch.stack(cacc, dim=1)                             # (B, nb, 6)
    cvel_s = torch.stack(kd.cvel, dim=1)
    cfrc = (mat_vec(kd.cinr, cacc_s)
            + force_cross(cvel_s, mat_vec(kd.cinr, cvel_s)))      # (B, nb, 6)
    fsub = C.subtree @ cfrc                                       # (B, nb, 6)
    fsub_per_dof = fsub[:, C.dof_body]
    return (kd.cdof * fsub_per_dof).sum(-1)


def fluid_force(model: RigidModel, kd: KinDyn, qvel: torch.Tensor) -> torch.Tensor:
    """MuJoCo's inertia-box fluid model, ``(B, nv)``: viscous and quadratic
    density drag (JAX ``engine.fluid_force``); zero for models without
    viscosity and fluid density (the Ant).

    Per body: its velocities in the body frame at the CoM, the drag on the
    equivalent box of its diagonal inertia, rotated back to world axes and
    mapped to the dofs on its root path as a spatial force about its
    tree's reference point (``kd.body_origin``)."""
    if model.viscosity == 0.0 and model.fluid_density == 0.0:
        return torch.zeros_like(qvel)
    cross = torch.linalg.cross
    B = qvel.shape[0]
    zeros6 = torch.zeros(B, 6, dtype=qvel.dtype, device=qvel.device)
    visc, rho = float(model.viscosity), float(model.fluid_density)
    fs = []
    for i in range(model.nbody):
        if model.body_mass[i] <= 0:
            fs.append(zeros6)
            continue
        R = kd.fkr.body_rot[i]
        Rt = R.transpose(-1, -2)
        com = kd.fkr.body_com[i] - kd.body_origin[:, i]
        w_w = kd.cvel[i][:, :3]
        v_w = kd.cvel[i][:, 3:] + cross(w_w, com)   # linear velocity at the CoM
        w_b, v_b = mat_vec(Rt, w_w), mat_vec(Rt, v_w)
        box = 2.0 * np.asarray(model.body_fluid_box[i], np.float64)  # full sides
        force = torch.zeros_like(v_b)
        torque = torch.zeros_like(w_b)
        if visc > 0:
            diam = float(np.mean(box))
            force = force - 3.0 * np.pi * diam * visc * v_b
            torque = torque - np.pi * diam ** 3 * visc * w_b
        if rho > 0:
            kf = [0.5 * rho * box[(k + 1) % 3] * box[(k + 2) % 3]
                  for k in range(3)]
            kt = [rho * box[k] * (box[(k + 1) % 3] ** 4 + box[(k + 2) % 3] ** 4)
                  / 64.0 for k in range(3)]
            force = force - torch.as_tensor(kf, dtype=qvel.dtype,
                                            device=qvel.device) * v_b.abs() * v_b
            torque = torque - torch.as_tensor(kt, dtype=qvel.dtype,
                                              device=qvel.device) * w_b.abs() * w_b
        f_w, t_w = mat_vec(R, force), mat_vec(R, torque)
        fs.append(torch.cat([t_w + cross(com, f_w), f_w], dim=1))
    _, chain_mask, _, _ = get_masks(model)
    proj = kd.cdof @ torch.stack(fs, dim=1).transpose(-1, -2)    # (B, nv, nb)
    return (proj * _const(chain_mask.astype(np.float64), qvel)).sum(-1)


def dof_effective_mass(model: RigidModel, qpos0: np.ndarray) -> np.ndarray:
    """1 / (M⁻¹)_jj at the reference pose — the per-dof effective inertia
    (diagonal Delassus approximation).  M is built in float32 on the CPU,
    as the JAX package builds it, and inverted in float64 numpy."""
    q = torch.as_tensor(np.asarray(qpos0, np.float32))[None]
    kd = kin_dyn(model, q, torch.zeros(1, model.nv))
    M = crb_mass_matrix(model, kd)[0].numpy().astype(np.float64)
    Minv = np.linalg.inv(M)
    return 1.0 / np.maximum(np.diag(Minv), 1e-12)


def prepare(model: RigidModel) -> RigidModel:
    """Host-side precomputation (effective masses), once after
    ``build_model``."""
    model._dof_meff = dof_effective_mass(model, model.qpos0)
    return model


def limit_force(model: RigidModel, qpos: torch.Tensor, qvel: torch.Tensor,
                qacc0: torch.Tensor, minv_diag: torch.Tensor) -> torch.Tensor:
    """Joint-limit constraint forces ``(B, nv)`` (diagonal Delassus
    approximation of MuJoCo's impedance dynamics; default solref (0.02, 1)
    and solimp (0.9, 0.95, 0.001)): f = m_eff·d·(aref − a0), pushing inward
    only."""
    qfrc = torch.zeros_like(qvel)
    C = _consts(model, qpos)
    if not len(C.lim_vadr):
        return qfrc
    # MuJoCo clamps solref timeconst to >= 2*timestep for stability
    tc = max(0.02, 2.0 * model.timestep)
    d0, dmax, width = 0.9, 0.95, 0.001
    b = 2.0 / (dmax * tc)
    # all limited joints at once, (B, L); each has its own dof
    q = qpos[:, C.lim_qadr]
    v = qvel[:, C.lim_vadr]
    a0 = qacc0[:, C.lim_vadr]
    m_eff = 1.0 / torch.clamp(minv_diag[:, C.lim_vadr], min=1e-12)
    total = torch.zeros_like(q)
    # upper limit: outward direction +1, then the lower: -1
    for sign, viol in ((1.0, torch.clamp(q - C.lim_hi, min=0.0)),
                       (-1.0, torch.clamp(C.lim_lo - q, min=0.0))):
        active = viol > 0
        d = d0 + (dmax - d0) * torch.clamp(viol / width, 0.0, 1.0)
        k = d / (dmax * dmax * tc * tc)
        aref_out = -b * (sign * v) - k * viol
        f_out = torch.clamp(m_eff * d * (aref_out - sign * a0), max=0.0)
        total = total + torch.where(active, sign * f_out, torch.zeros_like(f_out))
    qfrc[:, C.lim_vadr] = total
    return qfrc


def actuator_force(model: RigidModel, ctrl: torch.Tensor) -> torch.Tensor:
    qfrc = torch.zeros(ctrl.shape[0], model.nv, dtype=ctrl.dtype,
                       device=ctrl.device)
    for u in range(model.nu):
        lo, hi = (float(x) for x in model.act_ctrlrange[u])
        c = torch.clamp(ctrl[:, u], lo, hi)
        d = int(model.act_dofadr[u])
        qfrc[:, d] = qfrc[:, d] + float(model.act_gear[u]) * c
    return qfrc


def forward(model: RigidModel, qpos: torch.Tensor, qvel: torch.Tensor,
            ctrl: torch.Tensor, extra_qfrc=None) -> torch.Tensor:
    """qacc = M⁻¹ (τ - bias + passive + constraints), ``(B, nv)``.

    Two passes as in MuJoCo: the smooth (unconstrained) acceleration qacc0
    feeds the constraint impedances (joint limits here; contacts enter
    through ``extra_qfrc(kd, qacc0, Minv, qvel)``)."""
    kd = kin_dyn(model, qpos, qvel)
    M = crb_mass_matrix(model, kd)
    bias = rne_bias(model, kd, qvel)
    tau = actuator_force(model, ctrl)
    tau = tau + fluid_force(model, kd, qvel)
    tau = tau - _consts(model, qpos).damping * qvel
    Minv = spd_inverse(M)
    qacc0 = mat_vec(Minv, tau - bias)
    minv_diag = torch.diagonal(Minv, dim1=-2, dim2=-1)
    f_con = limit_force(model, qpos, qvel, qacc0, minv_diag)
    if extra_qfrc is not None:
        f_con = f_con + extra_qfrc(kd, qacc0, Minv, qvel)
    return mat_vec(Minv, tau + f_con - bias)


def _quat_exp_step(quat: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """quat ∘ exp(w·dt/2), renormalised (body-frame angular velocity)."""
    angle = torch.sqrt(torch.sum(w * w, dim=1, keepdim=True) + 1e-18)
    axis = w / angle
    half = angle * dt * 0.5
    dq = torch.cat([torch.cos(half), axis * torch.sin(half)], dim=1)
    newq = quat_mul(quat, dq)
    return newq / torch.sqrt(torch.sum(newq * newq, dim=1, keepdim=True))


def integrate_pos(model: RigidModel, qpos: torch.Tensor, qvel: torch.Tensor,
                  dt) -> torch.Tensor:
    """qpos ⊞ qvel·dt (``dt`` a float) with quaternion handling."""
    cols = list(qpos.unbind(dim=1))
    for j in range(model.njnt):
        jt = int(model.jnt_type[j])
        qadr = int(model.jnt_qposadr[j])
        vadr = int(model.jnt_dofadr[j])
        if jt == FREE:
            lin = qpos[:, qadr:qadr + 3] + qvel[:, vadr:vadr + 3] * dt
            quat = _quat_exp_step(qpos[:, qadr + 3:qadr + 7],
                                  qvel[:, vadr + 3:vadr + 6], dt)
            cols[qadr:qadr + 7] = list(torch.cat([lin, quat], 1).unbind(1))
        elif jt == BALL:
            quat = _quat_exp_step(qpos[:, qadr:qadr + 4],
                                  qvel[:, vadr:vadr + 3], dt)
            cols[qadr:qadr + 4] = list(quat.unbind(1))
        else:
            cols[qadr] = qpos[:, qadr] + qvel[:, vadr] * dt
    return torch.stack(cols, dim=1)


def rk4_step(model: RigidModel, qpos: torch.Tensor, qvel: torch.Tensor,
             ctrl: torch.Tensor, extra_qfrc=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One RK4 step of size ``model.timestep`` (MuJoCo's RK4 tableau), the
    four stages in the order of the JAX engine's ``lax.scan``, with the
    step sizes rounded to the state's dtype as the JAX engine rounds them."""
    rnd = np.float32 if qpos.dtype == torch.float32 else np.float64
    h = float(rnd(model.timestep))
    zero_v = torch.zeros_like(qvel)
    prev_v, prev_a, acc_v, acc_a = qvel, zero_v, zero_v, zero_v
    for hs, w in ((0.0, 1.0), (h / 2, 2.0), (h / 2, 2.0), (h, 1.0)):
        hs = float(rnd(hs))
        q_s = integrate_pos(model, qpos, prev_v, hs)
        v_s = qvel + prev_a * hs
        a_s = forward(model, q_s, v_s, ctrl, extra_qfrc)
        prev_v, prev_a = v_s, a_s
        acc_v = acc_v + w * v_s
        acc_a = acc_a + w * a_s
    qpos_out = integrate_pos(model, qpos, acc_v / 6.0, h)
    qvel_out = qvel + (acc_a / 6.0) * h
    return qpos_out, qvel_out
