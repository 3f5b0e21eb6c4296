"""Small SPD linear algebra for batched mass matrices.

Port of ``mujoco_maze_tpu.physics.linalg``: the same column Cholesky with
the same ``max(·, 1e-12)`` pivot clamp (so a near-singular matrix gives a
finite inverse, as on the JAX side), and forward/back substitution
against the identity.  The loops run over the static size ``n``; each
iteration acts on the whole batch.
"""

from __future__ import annotations

import torch


def cholesky_unrolled(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor ``L`` of SPD ``M (..., n, n)``."""
    n = M.shape[-1]
    L = torch.zeros_like(M)
    for j in range(n):
        s = M[..., j:, j]
        if j:
            s = s - (L[..., j:, :j] @ L[..., j, :j, None])[..., 0]
        d = torch.sqrt(torch.clamp(s[..., 0], min=1e-12))
        L[..., j:, j] = s / d[..., None]
    return L


def cho_solve_unrolled(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` given ``A = L Lᵀ``; ``b (..., n, m)``."""
    n = L.shape[-1]
    y = torch.zeros_like(b)
    for i in range(n):
        acc = b[..., i, :]
        if i:
            acc = acc - (L[..., i, None, :i] @ y[..., :i, :])[..., 0, :]
        y[..., i, :] = acc / L[..., i, i, None]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        acc = y[..., i, :]
        if i < n - 1:
            acc = acc - (L[..., i + 1:, i, None].transpose(-1, -2)
                         @ x[..., i + 1:, :])[..., 0, :]
        x[..., i, :] = acc / L[..., i, i, None]
    return x


def spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Inverse of SPD ``M (..., n, n)`` via the Cholesky factor."""
    L = cholesky_unrolled(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand_as(M)
    return cho_solve_unrolled(L, eye.clone())
