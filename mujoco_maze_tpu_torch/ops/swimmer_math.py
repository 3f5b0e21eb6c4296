"""Closed-form planar dynamics of the Swimmer (3 links) and the Reacher (2),
batched: the plain PyTorch version of the swimmer kernels' physics.

Port of ``mujoco_maze_tpu.ops.swimmer_math``: the generic engine
(:mod:`..physics.engine`) specialised to the planar chain slide x, slide
y, hinge θ, then one hinge per further link — mass matrix, velocity-product
bias, MuJoCo's inertia-box fluid drag, gear actuators and the impedance
joint limits, solved by a Cholesky factor reused for the limit
impedances.  Coordinates ``q = (x, y, θ, φ2[, φ3])``; link angles
``a1 = θ``, ``a2 = a1 + φ2``, ``a3 = a2 + φ3``; geometry of
``assets/swimmer.xml``: torso CoM +1.0 x̂ and the next link's attachment
+0.5 x̂, the middle link's CoM −0.5 x̂ and attachment −1.0 x̂, the back
link's CoM −0.5 x̂ (link frames).

Arithmetic.  Every function takes ``q (B, n)``, ``v (B, n)`` and
``ctrl (B, n - 3)`` and does, per env, the float32 operations of
``csrc/swimmer_lane.cu`` in the same order, so that kernel and plain
version agree to the bit on the card:

* no reductions (``sum``, matmul): sums of a few terms are written out
  left to right, and a Jacobian column that is a constant 1 or 0 takes
  part in the products (``x * 1``, ``x * 0`` and ``x + 0`` are exact);
* a division by a constant is a product with its reciprocal (PyTorch's
  CUDA division by a Python scalar is one), passed to the kernel as the
  same float32;
* the triangular solves are right-looking (each solved unknown is
  subtracted from the rows still to solve), the same order in both.

The JAX package's closed form folds its constants at trace time and
divides where this one multiplies, so the two agree to rounding, not to
the bit (the tests hold them to 1e-9 in float64).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

# link geometry (assets/swimmer.xml, reacher.xml): the CoM of each link and
# the attachment of the next one, along the link's own x axis
COM = (1.0, -0.5, -0.5)
ATTACH = (0.5, -1.0)
# joint-limit impedance (engine.limit_force): solref (0.02, 1) with
# MuJoCo's 2 dt clamp, solimp (0.9, 0.95, 0.001)
LIMIT_D0, LIMIT_DMAX, LIMIT_WIDTH = 0.9, 0.95, 0.001


class SwimmerDyn(NamedTuple):
    """Constants of one swimmer-family model (names as in the JAX
    package's ``SwimmerKernelSpec``, plus the derived constants that the
    kernel receives in ``SwimmerParams``)."""

    mass: float          # per link (identical links)
    inertia_z: float     # Izz about the CoM
    armature: float
    viscosity: float
    density: float
    box: np.ndarray      # (3,) full sides of the equivalent inertia box
    gear: float
    limit_lo: float      # φ range (symmetric)
    limit_hi: float
    timestep: float
    n_act: int           # 2 = swimmer, 1 = reacher
    n_links: int         # 3 = swimmer, 2 = reacher
    # fluid drag: f = kv_f v - (kq_f |v|) v per body axis, the torque alike
    kv_f: float
    kv_t: float
    kq_fx: float
    kq_fy: float
    kq_t: float
    lim_b: float         # 2 / (dmax tc)
    lim_inv_kden: float  # 1 / (dmax² tc²)


def spec_from_model(model) -> SwimmerDyn:
    """Lower a Swimmer or Reacher :class:`~..physics.model.RigidModel` to
    the closed form's constants; raises on another geometry."""
    n_links = int(model.nbody)
    if n_links not in (2, 3) or model.nu != n_links - 1:
        raise ValueError("the closed form takes the 2- or 3-link swimmer chain")
    for b in range(n_links):
        if not np.allclose(model.body_com[b], (COM[b], 0.0, 0.0)) or (
                b and not np.allclose(model.body_pos[b], (ATTACH[b - 1], 0, 0))):
            raise ValueError("the closed form takes the swimmer.xml geometry")
        if (model.body_mass[b] != model.body_mass[0]
                or model.body_inertia[b][2, 2] != model.body_inertia[0][2, 2]):
            raise ValueError("the closed form takes identical links")
    lo, hi = (float(x) for x in model.jnt_range[3])
    box = 2.0 * np.asarray(model.body_fluid_box[0], np.float64)
    Lx, Ly, Lz = (float(b) for b in box)
    diam = float(np.mean(box))
    visc, rho = float(model.viscosity), float(model.fluid_density)
    tc = max(0.02, 2.0 * float(model.timestep))
    return SwimmerDyn(
        mass=float(model.body_mass[0]),
        inertia_z=float(model.body_inertia[0][2, 2]),
        armature=float(model.dof_armature[0]),
        viscosity=visc, density=rho, box=box,
        gear=float(model.act_gear[0]),
        limit_lo=lo, limit_hi=hi,
        timestep=float(model.timestep),
        n_act=int(model.nu), n_links=n_links,
        kv_f=-3.0 * np.pi * diam * visc,
        kv_t=-np.pi * diam ** 3 * visc,
        kq_fx=0.5 * rho * Ly * Lz,
        kq_fy=0.5 * rho * Lz * Lx,
        kq_t=rho * Lz * (Lx ** 4 + Ly ** 4) / 64.0,
        lim_b=2.0 / (LIMIT_DMAX * tc),
        lim_inv_kden=1.0 / (LIMIT_DMAX * LIMIT_DMAX * tc * tc),
    )


# ---------------------------------------------------------------------------
# Cholesky factor and solves (right-looking; L kept by columns)
# ---------------------------------------------------------------------------
def chol_factor(M: torch.Tensor) -> List[torch.Tensor]:
    """Cholesky factor of the SPD ``M (B, n, n)`` as its columns:
    ``cols[j] (B, n - j)`` holds ``L[j:, j]``.  The diagonal is
    ``sqrt(max(s, 1e-12))`` (JAX ``_chol_factor``)."""
    n = M.shape[-1]
    cols: List[torch.Tensor] = []
    for j in range(n):
        s = M[:, j:, j]
        for k in range(j):
            lk = cols[k][:, j - k:]                 # L[j:, k]
            s = s - lk * lk[:, :1]
        d = torch.sqrt(torch.clamp(s[:, :1], min=1e-12))
        cols.append(torch.cat([d, s[:, 1:] / d], dim=1))
    return cols


def chol_solve(cols: List[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    """``x`` with ``L Lᵀ x = b (B, n)``: forward then backward
    substitution, each solved unknown subtracted from the rows still to
    solve (the kernel's order)."""
    n = b.shape[1]
    y = []
    rest = b
    for k in range(n):
        yk = rest[:, :1] / cols[k][:, :1]
        y.append(yk)
        rest = rest[:, 1:] - cols[k][:, 1:] * yk
    # backward: x_k meets row k of L left of the diagonal, L[k, :k]
    x: List[torch.Tensor] = [None] * n
    rest = torch.cat(y, dim=1)
    for k in reversed(range(n)):
        x[k] = rest[:, k:k + 1] / cols[k][:, :1]
        if k:
            row = torch.cat([cols[i][:, k - i:k - i + 1] for i in range(k)], 1)
            rest = rest[:, :k] - row * x[k]
    return torch.cat(x, dim=1)


def minv_diag(cols: List[torch.Tensor], dof: int) -> torch.Tensor:
    """``(M⁻¹)[dof, dof] (B,)`` from the factor: ``‖L⁻¹ e_dof‖²``, the
    forward substitution starting at row ``dof`` (JAX ``forward_swimmer``)."""
    n = len(cols)
    y = {dof: 1.0 / cols[dof][:, 0]}
    for i in range(dof + 1, n):
        s = cols[dof][:, i - dof] * y[dof]
        for k in range(dof + 1, i):
            s = s + cols[k][:, i - k] * y[k]
        y[i] = -s / cols[i][:, 0]
    out = y[dof] * y[dof]
    for i in range(dof + 1, n):
        out = out + y[i] * y[i]
    return out


# ---------------------------------------------------------------------------
# forward dynamics and RK4
# ---------------------------------------------------------------------------
def _jacobians(q: torch.Tensor, n_links: int):
    """Per link, the CoM Jacobian's x and y rows ``(B, L, n)``, and the
    links' cosines and sines ``(B, L)`` with the attachment and CoM
    vectors they give."""
    B, n = q.shape
    th = q[:, 2]
    angles = [th]
    for k in range(1, n_links):
        angles.append(angles[-1] + q[:, 2 + k])
    A = torch.stack(angles, dim=1)
    c, s = torch.cos(A), torch.sin(A)
    com = [(COM[k] * c[:, k], COM[k] * s[:, k]) for k in range(n_links)]
    att = [(ATTACH[k] * c[:, k], ATTACH[k] * s[:, k]) for k in range(n_links - 1)]
    one = torch.ones_like(th)
    zero = torch.zeros_like(th)
    jx, jy = [], []
    for k in range(n_links):
        rx, ry = [one, zero], [zero, one]
        for i in range(n_links):
            if i > k:
                rx.append(zero)
                ry.append(zero)
                continue
            # perp of the lever from joint i to the CoM of link k, summed
            # left to right: att[i] + ... + att[k-1] + com[k]
            px, py = None, None
            for m in range(i, k):
                px = att[m][0] if px is None else px + att[m][0]
                py = att[m][1] if py is None else py + att[m][1]
            px = com[k][0] if px is None else px + com[k][0]
            py = com[k][1] if py is None else py + com[k][1]
            rx.append(-py)
            ry.append(px)
        jx.append(torch.stack(rx, dim=1))
        jy.append(torch.stack(ry, dim=1))
    return torch.stack(jx, dim=1), torch.stack(jy, dim=1), c, s, com, att


@functools.lru_cache(maxsize=None)
def _masks(n_links: int, inertia_z: float, armature: float,
           dtype: torch.dtype, device: torch.device):
    """The constant tables of one model on one device, made once: which
    coordinates turn each link ``G (L, n)``, ``Iz g_i g_j (L, n, n)`` and
    the armature's diagonal ``(n, n)``."""
    n = 2 + n_links
    g = np.zeros((n_links, n))
    for k in range(n_links):
        g[k, 2:3 + k] = 1.0

    def c(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return (c(g), c(inertia_z * g[:, :, None] * g[:, None, :]),
            c(armature * np.eye(n)))


def forward_swimmer(ks: SwimmerDyn, q: torch.Tensor, v: torch.Tensor,
                    ctrl: torch.Tensor) -> torch.Tensor:
    """qacc ``(B, n)`` of the swimmer (n = 5) or the reacher (n = 4)."""
    n, L = q.shape[1], ks.n_links
    if n != 2 + L or ctrl.shape[1] != ks.n_act:
        raise ValueError(f"q must have {2 + L} columns and ctrl {ks.n_act}")
    Jx, Jy, c, s, com, att = _jacobians(q, L)
    G, iz_gg, arm = _masks(L, ks.inertia_z, ks.armature, q.dtype, q.device)

    # mass matrix: Σ_k m (Jx_i Jx_j + Jy_i Jy_j) + Iz g_i g_j, + armature
    M = torch.zeros(q.shape[0], n, n, dtype=q.dtype, device=q.device)
    for k in range(L):
        dot = (Jx[:, k, :, None] * Jx[:, k, None, :]
               + Jy[:, k, :, None] * Jy[:, k, None, :])
        M = M + (ks.mass * dot + iz_gg[k])
    M = M + arm

    # angular velocities and the CoMs' velocity-product accelerations
    w = [v[:, 2]]
    for k in range(1, L):
        w.append(w[-1] + v[:, 2 + k])
    nw2 = [(-wk) * wk for wk in w]
    bias = torch.zeros_like(q)
    for k in range(L):
        ax, ay = None, None
        for m in range(k):
            tx, ty = nw2[m] * att[m][0], nw2[m] * att[m][1]
            ax = tx if ax is None else ax + tx
            ay = ty if ay is None else ay + ty
        tx, ty = nw2[k] * com[k][0], nw2[k] * com[k][1]
        ax = tx if ax is None else ax + tx
        ay = ty if ay is None else ay + ty
        bias = bias + ks.mass * (Jx[:, k] * ax[:, None] + Jy[:, k] * ay[:, None])

    # fluid drag on each link's inertia box (engine.fluid_force in the plane)
    vwx = Jx[:, :, 0] * v[:, :1]
    vwy = Jy[:, :, 0] * v[:, :1]
    for i in range(1, n):
        vwx = vwx + Jx[:, :, i] * v[:, i:i + 1]
        vwy = vwy + Jy[:, :, i] * v[:, i:i + 1]
    W = torch.stack(w, dim=1)
    vbx = c * vwx + s * vwy
    vby = (-s) * vwx + c * vwy
    fbx = ks.kv_f * vbx
    fby = ks.kv_f * vby
    tz = ks.kv_t * W
    if ks.density > 0:
        fbx = fbx - (ks.kq_fx * vbx.abs()) * vbx
        fby = fby - (ks.kq_fy * vby.abs()) * vby
        tz = tz - (ks.kq_t * W.abs()) * W
    fwx = c * fbx - s * fby
    fwy = s * fbx + c * fby
    tau = torch.zeros_like(q)
    for k in range(L):
        tau = (tau + Jx[:, k] * fwx[:, k:k + 1]) + Jy[:, k] * fwy[:, k:k + 1]
        tau = tau + G[k] * tz[:, k:k + 1]
    # gear actuators on φ2[, φ3]
    act = ks.gear * torch.clamp(ctrl, -1.0, 1.0)
    tau = tau + torch.cat([torch.zeros_like(q[:, :3]), act], dim=1)

    cols = chol_factor(M)
    qacc0 = chol_solve(cols, tau - bias)

    # joint limits of φ2[, φ3]: impedance on the unconstrained acceleration
    minv = torch.stack([minv_diag(cols, 3 + d) for d in range(ks.n_act)], 1)
    qq, qv, a0 = q[:, 3:], v[:, 3:], qacc0[:, 3:]
    m_eff = 1.0 / torch.clamp(minv, min=1e-12)
    f_lim = torch.zeros_like(qq)
    for sign, viol in ((1.0, torch.clamp(qq - ks.limit_hi, min=0.0)),
                       (-1.0, torch.clamp(ks.limit_lo - qq, min=0.0))):
        d = LIMIT_D0 + (LIMIT_DMAX - LIMIT_D0) * torch.clamp(
            viol * (1.0 / LIMIT_WIDTH), 0.0, 1.0)
        k_imp = d * ks.lim_inv_kden
        aref = (-ks.lim_b) * (sign * qv) - k_imp * viol
        f_out = torch.clamp((m_eff * d) * (aref - sign * a0), max=0.0)
        f_lim = f_lim + torch.where(viol > 0, sign * f_out,
                                    torch.zeros_like(f_out))
    rhs = (tau + torch.cat([torch.zeros_like(q[:, :3]), f_lim], dim=1)) - bias
    return chol_solve(cols, rhs)


def rk4_step_swimmer(ks: SwimmerDyn, q: torch.Tensor, v: torch.Tensor,
                     ctrl: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One RK4 step of size ``ks.timestep`` (MuJoCo's tableau, the
    engine's), on the robot coordinates only."""
    h = ks.timestep
    h2 = h / 2
    a1 = forward_swimmer(ks, q, v, ctrl)
    q2, v2 = q + h2 * v, v + h2 * a1
    a2 = forward_swimmer(ks, q2, v2, ctrl)
    q3, v3 = q + h2 * v2, v + h2 * a2
    a3 = forward_swimmer(ks, q3, v3, ctrl)
    q4, v4 = q + h * v3, v + h * a3
    a4 = forward_swimmer(ks, q4, v4, ctrl)
    v_avg = (((v + 2.0 * v2) + 2.0 * v3) + v4) * (1.0 / 6.0)
    a_avg = (((a1 + 2.0 * a2) + 2.0 * a3) + a4) * (1.0 / 6.0)
    return q + h * v_avg, v + h * a_avg
