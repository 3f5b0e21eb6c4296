"""Philox4x32-10 in int64 torch arithmetic: the rollout kernels' generator.

The CUDA rollout kernels (``csrc/philox.cuh``) draw counter ``(env, step,
block, 0)`` under key ``(seed, 0)``; these functions compute the same
32-bit words on any device, so a rollout kernel and its plain version can
be compared on one seed.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``a * b`` for a 32-bit constant ``a``
    and int64 ``b`` in [0, 2^32), without overflowing int64."""
    p_lo = a * (b & 0xFFFF)                 # < 2^48
    p_hi = a * (b >> 16)                    # < 2^48
    low_sum = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (low_sum >> 32), low_sum & _MASK32


def philox4x32(counter, key: Tuple[int, int]):
    """Philox4x32-10 (Salmon et al., SC'11) on four int64 counter words
    (tensors or ints, values in [0, 2^32)); returns four int64 tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_words(env_index: torch.Tensor, step: int, seed: int,
                 blocks: Iterable[int]) -> List[torch.Tensor]:
    """The words of the given blocks of ``(env, step)``, four per block in
    block order, each an int64 tensor shaped like ``env_index``."""
    key = (seed & _MASK32, 0)
    zero = torch.zeros_like(env_index)
    words: List[torch.Tensor] = []
    for b in blocks:
        words += philox4x32((env_index, zero + step, zero + b, zero), key)
    return words


def uniform24(bits: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """U(lo, hi) in float32 from the top 24 of 32 random bits
    (``lane_env.py:40`` of the JAX package)."""
    u = (bits >> 8).to(torch.float32) * (2.0 ** -24)
    width = float(np.float32(hi) - np.float32(lo))
    return lo + u * width


def normal_box_muller(bits1: torch.Tensor, bits2: torch.Tensor) -> torch.Tensor:
    """N(0, 1) in float32 from two words by Box-Muller, as the JAX
    package's ``lane_env.normal`` (:44): u1 ~ U(1e-7, 1), u2 ~ U(0, 1),
    sqrt(-2 log u1) cos(2 pi u2)."""
    u1 = uniform24(bits1, 1e-7, 1.0)
    u2 = uniform24(bits2, 0.0, 1.0)
    two_pi = float(np.float32(2.0 * np.pi))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)
