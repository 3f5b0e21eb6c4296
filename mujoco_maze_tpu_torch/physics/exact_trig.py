"""libm's sine and cosine of float64 tensors, to the bit, in PyTorch.

The float64 Point fidelity path (``physics/point_world.py``) replicates
MuJoCo's ``mj_step`` to the bit on most steps, and one switch in it is a
knife edge on the last bit of a cosine: the floor contact is active iff
``fl(0.5 * fl(fl(c*c) + fl(s*s))) - 0.5 < 0`` with ``c, s`` the cosine and
sine of half the hinge angle (JAX ``physics/point_world.py:47-57``).  MuJoCo
and the JAX package (XLA calls libm for float64 ``cos``/``sin``) get glibc's
values there.  PyTorch's float64 ``cos``/``sin`` differ from glibc's on
about 0.2 % of arguments, and so does a correctly rounded sine: glibc's
``sin``/``cos`` (sysdeps/ieee754/dbl-64/s_sin.c, since glibc 2.28) are
accurate to ~0.52 ulp, not correctly rounded, and round the other way on
about 0.14 % of arguments.

So the float64 path takes every sine and cosine through :func:`sincos`,
which repeats glibc's algorithm operation by operation: the split of the
range at 2^-26, 0.855469 and 2.426265; the reduction by pi/2 in four parts
(``reduce_sincos``); the Taylor polynomial below 0.126 (``TAYLOR_SIN``);
the table of sines and cosines at i/128 (``__sincostab``, in
:mod:`._sincostab`) with its short polynomials (``do_sin``, ``do_cos``).  It
follows the x86-64 build that runs on a CPU with FMA (the ``__sin_fma`` /
``__cos_fma`` variants that glibc's dispatch selects there): where that
build fuses a product into an addition, this module does too, in an exact
product (Dekker's splitting) added with one rounding.  Every other
operation is one IEEE float64 addition, subtraction or multiplication of
PyTorch, so the CPU and the card give the same bits.  It covers |x| below
105414350 (glibc's reduction in three parts); the Point path's angles stay
within a few hundred radians.

Float32 tensors take ``torch.sin``/``torch.cos``: the float32 path and its
CUDA kernels use those (``sinf``/``cosf`` on the card).
"""

from __future__ import annotations

import struct
from typing import Tuple

import torch

from ._sincostab import SINCOSTAB_HEX


def _h(s: str) -> float:
    return float.fromhex(s)


# glibc's constants (sysdeps/ieee754/dbl-64/usncs.h, s_sin.c)
_S1, _S2 = _h("-0x1.5555555555555p-3"), _h("0x1.1111111110ecep-7")
_S3, _S4 = _h("-0x1.a01a019db08b8p-13"), _h("0x1.71de27b9a7ed9p-19")
_S5 = _h("-0x1.addffc2fcdf59p-26")
_SN3, _SN5 = -1.66666666666664880952546298448555e-01, 8.33333214285722277379541354343671e-03
_CS2, _CS4 = 4.99999999999999999999950396842453e-01, -4.16666666666664434524222570944589e-02
_CS6 = 1.38888874007937613028114285595617e-03
_BIG = 52776558133248.0                         # 1.5 * 2^45: rounds to 1/128
_HP0, _HP1 = _h("0x1.921fb54442d18p+0"), _h("0x1.1a62633145c07p-54")
_MP1, _MP2 = _h("0x1.921fb58000000p+0"), _h("-0x1.dde973c000000p-27")
_PP3, _PP4 = _h("-0x1.cb3b398000000p-55"), _h("-0x1.d747f23e32ed7p-83")
_HPINV, _TOINT = _h("0x1.45f306dc9c883p-1"), 6755399441055744.0
_TAYLOR_MAX = 0.126
_SPLIT = 134217729.0                            # 2^27 + 1
_TABLE = [struct.unpack("<d", bytes.fromhex(SINCOSTAB_HEX[i:i + 16]))[0]
          for i in range(0, len(SINCOSTAB_HEX), 16)]
_TABLES = {}


def _table(dev: torch.device) -> torch.Tensor:
    if dev not in _TABLES:
        _TABLES[dev] = torch.tensor(_TABLE, dtype=torch.float64,
                                    device=dev).reshape(-1, 4)
    return _TABLES[dev]


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def _fma(a, b, c):
    """``a * b + c`` rounded once (the exact product, then a two-sum; the
    last addition rounds the sum of the two small parts first, which can
    differ from one rounding only at a tie of ~2^-106 relative)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = (((ah * bh - p) + ah * bl) + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def _lookup(u, tab):
    """``sn, ssn, cs, ccs`` of the table entry that ``u = big + |x|``
    rounded ``|x|`` to (``SINCOS_TABLE_LOOKUP``)."""
    i = ((u - _BIG) * 128.0).clamp(0.0, tab.shape[0] - 1).to(torch.int64)
    row = tab[i]
    return row[..., 0], row[..., 1], row[..., 2], row[..., 3]


def _do_sin(x, dx, tab):
    """glibc ``do_sin(x, dx)``, the table branch (|x| >= 0.126)."""
    dx = torch.where(x <= 0, -dx, dx)
    ax = x.abs()
    u = _BIG + ax
    xr = ax - (u - _BIG)
    xx = xr * xr
    s = xr + _fma(xr * xx, _fma(xx, _SN5, _SN3), dx)
    c = _fma(xr, dx, xx * _fma(xx, _fma(xx, _CS6, _CS4), _CS2))
    sn, ssn, cs, ccs = _lookup(u, tab)
    cor = _fma(s, cs, _fma(-sn, c, _fma(s, ccs, ssn)))
    return torch.copysign(sn + cor, x)


def _taylor_sin(x, dx):
    """glibc ``TAYLOR_SIN(x*x, x, dx)`` (|x| < 0.126)."""
    xx = x * x
    p = _fma(xx, _fma(xx, _fma(xx, _fma(xx, _S5, _S4), _S3), _S2), _S1)
    t = _fma(xx, _fma(p, x, -(0.5 * dx)), dx)
    return x + t


def _do_cos(x, dx, tab):
    """glibc ``do_cos(x, dx)``."""
    dx = torch.where(x < 0, -dx, dx)
    ax = x.abs()
    u = _BIG + ax
    xr = (ax - (u - _BIG)) + dx
    xx = xr * xr
    s = _fma(xr * xx, _fma(xx, _SN5, _SN3), xr)
    c = xx * _fma(xx, _fma(xx, _CS6, _CS4), _CS2)
    sn, ssn, cs, ccs = _lookup(u, tab)
    cor = _fma(-s, sn, _fma(-c, cs, _fma(-s, ssn, ccs)))
    return cs + cor


def _sin_of(a, da, tab):
    """``do_sin(a, da)`` with its Taylor branch below 0.126."""
    return torch.where(a.abs() < _TAYLOR_MAX, _taylor_sin(a, da),
                       _do_sin(a, da, tab))


def _reduce(x):
    """glibc ``reduce_sincos``: ``(a, da, n)`` with x = n pi/2 + a + da."""
    t = _fma(x, _HPINV, _TOINT)
    xn = t - _TOINT
    n = torch.remainder(xn, 4.0)
    y = _fma(-xn, _MP2, _fma(-xn, _MP1, x))
    t2 = _fma(-xn, _PP3, y)
    db = _fma(-_PP3, xn, y - t2)
    b = _fma(-xn, _PP4, t2)
    db = db + _fma(-xn, _PP4, t2 - b)
    return b, db, n


def _sincos_f64(x, tab):
    """glibc's ``__sin`` and ``__cos`` of ``x``, evaluated together: each
    range picks the argument ``(a, da)`` and the kernel (``do_sin`` with
    its Taylor branch, or ``do_cos``) that glibc picks for it, the two
    functions' arguments go through the kernels as one batch, and the
    signs are put back as glibc puts them."""
    ax = x.abs()
    zero = torch.zeros_like(x)
    near = ax < 0.85546875
    mid = ax < _MID_MAX
    b, db, n = _reduce(x)                  # |x| >= 2.426265 (do_sincos)
    y = _HP0 - ax                          # 0.855469 <= |x| < 2.426265
    ya = y + _HP1
    yda = (y - ya) + _HP1
    nc = torch.remainder(n + 1.0, 4.0)     # cos x = sin of quadrant n + 1
    sin_a = torch.where(near, x, torch.where(mid, y, b))
    sin_da = torch.where(near, zero, torch.where(mid, zero + _HP1, db))
    sin_k = torch.where(near, False, torch.where(mid, True,
                                                 torch.remainder(n, 2.0) == 1))
    cos_a = torch.where(near, x, torch.where(mid, ya, b))
    cos_da = torch.where(near, zero, torch.where(mid, yda, db))
    cos_k = torch.where(near, True, torch.where(mid, False,
                                                torch.remainder(nc, 2.0) == 1))
    a = torch.cat([sin_a, cos_a])
    da = torch.cat([sin_da, cos_da])
    r = torch.where(torch.cat([sin_k, cos_k]), _do_cos(a, da, tab),
                    _sin_of(a, da, tab))
    rs, rc = r[:x.shape[0]], r[x.shape[0]:]
    far_s = torch.where(n >= 2, -rs, rs)
    sin_x = torch.where(ax < 2.0 ** -26, x, torch.where(
        near, rs, torch.where(mid, torch.copysign(rs, x), far_s)))
    far_c = torch.where(nc >= 2, -rc, rc)
    cos_x = torch.where(ax < 2.0 ** -27, zero + 1.0, torch.where(
        mid, rc, far_c))
    return sin_x, cos_x


# the upper end of the middle range: high word 0x400368fd, low word 0
_MID_MAX = struct.unpack("<d", struct.pack("<Q", 0x400368FD << 32))[0]


def sincos(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sin x, cos x)``: for float64 glibc's values to the bit (|x| below
    105414350); for any other dtype ``torch.sin``/``torch.cos``."""
    if x.dtype != torch.float64:
        return torch.sin(x), torch.cos(x)
    shape = x.shape
    s, c = _sincos_f64(x.reshape(-1), _table(x.device))
    return s.reshape(shape), c.reshape(shape)
