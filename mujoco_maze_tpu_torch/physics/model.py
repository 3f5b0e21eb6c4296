"""Static rigid-body model description + builder (host side, numpy).

Copy of ``mujoco_maze_tpu.physics.model`` (numpy only; copied, not
imported, because importing any ``mujoco_maze_tpu`` module imports JAX).
Robots and world objects are declared programmatically (no XML
round-trip) and lowered to flat numpy arrays that the batched torch
engine (:mod:`.engine`) walks.  Inertias follow MuJoCo's
``inertiafromgeom`` path: computed from geom shapes and densities.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

# joint types
FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3
# geom types
GEOM_SPHERE, GEOM_CAPSULE, GEOM_BOX, GEOM_PLANE = 0, 1, 2, 3


def _quat_to_mat_np(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _mat_to_quat_np(m):
    t = np.trace(m)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(1e-12, 1.0 + m[i, i] - m[j, j] - m[k, k])) * 2
    q = np.empty(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def _axis_to_quat(axis):
    """Quaternion rotating +z onto ``axis``."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    z = np.array([0.0, 0.0, 1.0])
    c = float(np.dot(z, axis))
    if c > 1 - 1e-12:
        return np.array([1.0, 0, 0, 0])
    if c < -1 + 1e-12:
        return np.array([0.0, 1.0, 0, 0])
    v = np.cross(z, axis)
    s = math.sqrt((1 + c) * 2)
    return np.concatenate([[s / 2], v / s])


@dataclass
class Geom:
    gtype: int
    size: Tuple[float, ...]            # sphere: (r,), capsule: (r, half_len),
                                       # box: (hx, hy, hz), plane: ()
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    quat: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    density: float = 1000.0
    mass: Optional[float] = None       # overrides density when set
    friction: Tuple[float, float, float] = (1.0, 0.005, 0.0001)
    contype: int = 1
    conaffinity: int = 1
    solref: Tuple[float, float] = (0.02, 1.0)
    solimp: Tuple[float, float, float] = (0.9, 0.95, 0.001)
    margin: float = 0.0
    name: str = ""

    @staticmethod
    def capsule_fromto(p1, p2, r, **kw) -> "Geom":
        p1 = np.asarray(p1, dtype=np.float64)
        p2 = np.asarray(p2, dtype=np.float64)
        center = 0.5 * (p1 + p2)
        d = p2 - p1
        hl = float(np.linalg.norm(d)) / 2
        quat = _axis_to_quat(d)
        return Geom(
            gtype=GEOM_CAPSULE, size=(r, hl), pos=tuple(center),
            quat=tuple(quat), **kw,
        )

    def mass_com_inertia(self):
        """(mass, com(3) in geom frame origin, inertia 3x3 about com in geom
        frame).  MuJoCo inertiafromgeom semantics."""
        t = self.gtype
        if t == GEOM_SPHERE:
            r = self.size[0]
            vol = 4.0 / 3.0 * math.pi * r**3
            m = self.mass if self.mass is not None else self.density * vol
            i = 0.4 * m * r * r
            I = np.diag([i, i, i])
        elif t == GEOM_CAPSULE:
            r, hl = self.size[0], self.size[1]
            vc = math.pi * r * r * (2 * hl)        # cylinder
            vs = 4.0 / 3.0 * math.pi * r**3        # two hemispheres
            vol = vc + vs
            m = self.mass if self.mass is not None else self.density * vol
            mc = m * vc / vol
            ms = m * vs / vol
            # cylinder about its com, axis z
            izz_c = 0.5 * mc * r * r
            ixx_c = mc * (3 * r * r + 4 * hl * hl) / 12.0
            # two hemispheres: sphere about own com + parallel-axis to caps
            izz_s = 0.4 * ms * r * r
            # hemisphere com offset from cap center: 3r/8; cap at ±hl
            d = hl + 3.0 * r / 8.0
            ixx_s = 0.4 * ms * r * r - ms * (3.0 * r / 8.0) ** 2 + ms * d * d
            I = np.diag([ixx_c + ixx_s, ixx_c + ixx_s, izz_c + izz_s])
        elif t == GEOM_BOX:
            hx, hy, hz = self.size
            vol = 8.0 * hx * hy * hz
            m = self.mass if self.mass is not None else self.density * vol
            I = (
                np.diag(
                    [hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy]
                ) * m / 3.0
            )
        else:  # plane: massless, static
            return 0.0, np.zeros(3), np.zeros((3, 3))
        R = _quat_to_mat_np(np.asarray(self.quat))
        return float(m), np.asarray(self.pos, dtype=np.float64), R @ I @ R.T


@dataclass
class Joint:
    jtype: int
    axis: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    armature: float = 0.0
    damping: float = 0.0
    limited: bool = False
    range: Tuple[float, float] = (0.0, 0.0)
    stiffness: float = 0.0
    name: str = ""


@dataclass
class Body:
    name: str
    parent: int                       # index into bodies; -1 = world
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    quat: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    joints: List[Joint] = field(default_factory=list)
    geoms: List[Geom] = field(default_factory=list)


@dataclass
class Actuator:
    joint_name: str
    gear: float = 1.0
    ctrlrange: Tuple[float, float] = (-1.0, 1.0)


@dataclass
class RigidModel:
    """Flat model arrays (host side); consumed by physics.engine."""

    # bodies (world excluded; index 0 = first real body)
    nbody: int
    body_parent: np.ndarray            # (nb,) -1 for world
    body_pos: np.ndarray               # (nb, 3)
    body_quat: np.ndarray              # (nb, 4)
    body_mass: np.ndarray              # (nb,)
    body_com: np.ndarray               # (nb, 3) com in body frame
    body_inertia: np.ndarray           # (nb, 3, 3) about com, body frame
    # joints, flattened in tree order
    njnt: int
    jnt_type: np.ndarray               # (nj,)
    jnt_body: np.ndarray               # (nj,)
    jnt_axis: np.ndarray               # (nj, 3)
    jnt_pos: np.ndarray                # (nj, 3)
    jnt_qposadr: np.ndarray            # (nj,)
    jnt_dofadr: np.ndarray             # (nj,)
    jnt_limited: np.ndarray            # (nj,) bool
    jnt_range: np.ndarray              # (nj, 2)
    # per-dof
    nq: int
    nv: int
    dof_armature: np.ndarray           # (nv,)
    dof_damping: np.ndarray            # (nv,)
    # actuators
    nu: int
    act_dofadr: np.ndarray             # (nu,)
    act_gear: np.ndarray               # (nu,)
    act_ctrlrange: np.ndarray          # (nu, 2)
    # geoms (for fluid + contacts)
    geoms: List[Tuple[int, Geom]]      # (body_index, geom)
    # static world geoms (body = world): fixed world pose
    static_geoms: List[Geom] = None
    # options
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    timestep: float = 0.01
    viscosity: float = 0.0
    fluid_density: float = 0.0
    # init state
    qpos0: np.ndarray = None
    # fluid model per-body equivalent box (semi-axes), precomputed
    body_fluid_box: np.ndarray = None  # (nb, 3)

def build_model(
    bodies: List[Body],
    actuators: List[Actuator],
    gravity=(0.0, 0.0, -9.81),
    timestep: float = 0.01,
    viscosity: float = 0.0,
    fluid_density: float = 0.0,
    static_geoms: Optional[List[Geom]] = None,
) -> RigidModel:
    nb = len(bodies)
    body_parent = np.array([b.parent for b in bodies], dtype=np.int32)
    body_pos = np.array([b.pos for b in bodies], dtype=np.float64)
    body_quat = np.array([b.quat for b in bodies], dtype=np.float64)

    body_mass = np.zeros(nb)
    body_com = np.zeros((nb, 3))
    body_inertia = np.zeros((nb, 3, 3))
    geoms: List[Tuple[int, Geom]] = []
    for i, b in enumerate(bodies):
        total_m, msum = 0.0, np.zeros(3)
        for g in b.geoms:
            m, com, _ = g.mass_com_inertia()
            total_m += m
            msum += m * com
            geoms.append((i, g))
        com = msum / total_m if total_m > 0 else np.zeros(3)
        I = np.zeros((3, 3))
        for g in b.geoms:
            m, gcom, gI = g.mass_com_inertia()
            d = gcom - com
            I += gI + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
        body_mass[i] = total_m
        body_com[i] = com
        body_inertia[i] = I

    jnt_type, jnt_body, jnt_axis, jnt_pos = [], [], [], []
    jnt_limited, jnt_range = [], []
    jnt_qposadr, jnt_dofadr = [], []
    dof_armature, dof_damping = [], []
    jnt_names = {}
    q_adr = v_adr = 0
    for i, b in enumerate(bodies):
        for j in b.joints:
            jnt_names[j.name] = len(jnt_type)
            jnt_type.append(j.jtype)
            jnt_body.append(i)
            jnt_axis.append(np.asarray(j.axis) / np.linalg.norm(j.axis))
            jnt_pos.append(j.pos)
            jnt_limited.append(j.limited)
            jnt_range.append(j.range)
            jnt_qposadr.append(q_adr)
            jnt_dofadr.append(v_adr)
            nqj, nvj = {FREE: (7, 6), BALL: (4, 3), SLIDE: (1, 1), HINGE: (1, 1)}[
                j.jtype
            ]
            q_adr += nqj
            v_adr += nvj
            for _ in range(nvj):
                dof_armature.append(j.armature)
                dof_damping.append(j.damping)

    act_dofadr, act_gear, act_ctrlrange = [], [], []
    for a in actuators:
        jid = jnt_names[a.joint_name]
        act_dofadr.append(jnt_dofadr[jid])
        act_gear.append(a.gear)
        act_ctrlrange.append(a.ctrlrange)

    qpos0 = np.zeros(q_adr)
    for jid, t in enumerate(jnt_type):
        if t == FREE:
            # free-joint reference = the body's world position (MuJoCo qpos0)
            qpos0[jnt_qposadr[jid] : jnt_qposadr[jid] + 3] = body_pos[
                jnt_body[jid]
            ]
            qpos0[jnt_qposadr[jid] + 3] = 1.0  # identity quat
        elif t == BALL:
            qpos0[jnt_qposadr[jid]] = 1.0

    # fluid equivalent-inertia boxes (MuJoCo inertia-box model): semi-axes
    # from the principal inertia: a_i = sqrt(1.5 (I_j + I_k − I_i) / m)
    body_fluid_box = np.zeros((nb, 3))
    for i in range(nb):
        m = body_mass[i]
        if m <= 0:
            continue
        evals = np.linalg.eigvalsh(body_inertia[i])
        # principal order approximates body axes for our simple models; use
        # diagonal entries in body frame instead (boxes aligned to frame)
        d = np.diag(body_inertia[i])
        for k in range(3):
            j, l = (k + 1) % 3, (k + 2) % 3
            body_fluid_box[i, k] = math.sqrt(
                max(1e-12, 1.5 * (d[j] + d[l] - d[k]) / m)
            )

    return RigidModel(
        nbody=nb,
        body_parent=body_parent,
        body_pos=body_pos,
        body_quat=body_quat,
        body_mass=body_mass,
        body_com=body_com,
        body_inertia=body_inertia,
        njnt=len(jnt_type),
        jnt_type=np.asarray(jnt_type, dtype=np.int32),
        jnt_body=np.asarray(jnt_body, dtype=np.int32),
        jnt_axis=np.asarray(jnt_axis, dtype=np.float64),
        jnt_pos=np.asarray(jnt_pos, dtype=np.float64),
        jnt_qposadr=np.asarray(jnt_qposadr, dtype=np.int32),
        jnt_dofadr=np.asarray(jnt_dofadr, dtype=np.int32),
        jnt_limited=np.asarray(jnt_limited, dtype=bool),
        jnt_range=np.asarray(jnt_range, dtype=np.float64),
        nq=q_adr,
        nv=v_adr,
        dof_armature=np.asarray(dof_armature, dtype=np.float64),
        dof_damping=np.asarray(dof_damping, dtype=np.float64),
        nu=len(act_dofadr),
        act_dofadr=np.asarray(act_dofadr, dtype=np.int32),
        act_gear=np.asarray(act_gear, dtype=np.float64),
        act_ctrlrange=np.asarray(act_ctrlrange, dtype=np.float64),
        geoms=geoms,
        static_geoms=list(static_geoms or []),
        gravity=gravity,
        timestep=timestep,
        viscosity=viscosity,
        fluid_density=fluid_density,
        qpos0=qpos0,
        body_fluid_box=body_fluid_box,
    )
