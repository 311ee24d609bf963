"""float32 arithmetic that rounds where the reference rounds.

XLA compiles the JAX package's fused elementwise code with fused
multiply-add contraction: ``a*b + c`` is rounded once, not twice.  PyTorch
rounds after each operation.  The helpers here compute the product and
the sum in float64 and round once to float32.  The product of two float32
values is exact in float64, so the result is the correctly rounded fused
multiply-add except when the float64 sum lands exactly on a float32 tie
(about one operation in 2**29).

A sum of products ``p0 + p1 + ... `` is contracted by XLA with the LEFT
product of the first addition fused: ``fma(a0, b0, a1*b1)``, then
``fma(ai, bi, acc)`` for each further term.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

Operand = Union[torch.Tensor, float]


def f32(value: float) -> float:
    """A Python float rounded to the nearest float32 (a weak-typed constant)."""
    return float(np.float32(value))


def _hex_f32(*words: str) -> Tuple[float, ...]:
    return tuple(f32(float.fromhex(w)) for w in words)


# XLA's CPU log (Eigen's ``plog_float``, the Cephes polynomial), its
# constants as the float32 values in its code
_LOG_P = _hex_f32("0x1.2043760000000p-4", "-0x1.d7a3700000000p-4", "0x1.de4a340000000p-4",
                  "-0x1.fcba9e0000000p-4", "0x1.23d37e0000000p-3", "-0x1.555ca00000000p-3",
                  "0x1.999d580000000p-3", "-0x1.fffff80000000p-3", "0x1.5555540000000p-2")
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRT_HALF = f32(float.fromhex("0x1.6a09e60000000p-1"))


def log(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` as XLA computes it on the CPU, bit for bit: x = m·2**e
    with m in [√½, √2), a degree-8 polynomial in m - 1 with XLA's fused
    multiply-adds, e·ln 2 added as two parts; subnormal inputs flushed to
    zero (−inf), negative ones NaN.  PyTorch's ``log`` differs from it in
    the last bit on some inputs."""
    x = x.float()
    x = torch.where(x.abs() < _TINY, torch.zeros_like(x), x)
    bits = torch.clamp(x, min=_TINY).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)  # mantissa in [0.5, 1)
    small = m < _SQRT_HALF
    e = e - small.float()
    r = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    r2 = r * r
    r3 = r2 * r
    y = fma(fma(r, _LOG_P[0], _LOG_P[1]), r, _LOG_P[2])
    y1 = fma(fma(r, _LOG_P[3], _LOG_P[4]), r, _LOG_P[5])
    y2 = fma(fma(r, _LOG_P[6], _LOG_P[7]), r, _LOG_P[8])
    y = fma(fma(fma(y, r3, y1), r3, y2), r3, e * f32(_LOG_Q1))
    out = fma(_LOG_Q2, e, fma(-0.5, r2, r) + y)
    out = torch.where(x < 0, torch.full_like(out, float("nan")), out)
    out = torch.where(x == 0, torch.full_like(out, -float("inf")), out)
    return torch.where(torch.isposinf(x) | torch.isnan(x), x, out)


def log10(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log10``: XLA's natural log times float32(1/ln 10)."""
    return log(x) * f32(1.0 / np.log(10.0))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as XLA computes ``jnp.sqrt``
    on the CPU; PyTorch's vectorised CPU ``sqrt`` is off by one ulp on
    about one input in 150.  The float64 root rounds correctly to float32."""
    return torch.sqrt(x.double()).float()


# XLA's CPU exp (the Cephes polynomial it emits for float32), its constants
# as the float32 values in its code
_EXP_LO, _EXP_HI = -87.8, 88.8
_EXP_LOG2E = 1.4426950216293335
_EXP_C1, _EXP_C2 = 0.693359375, -2.1219444170128554e-4
_EXP_P = (1.9875691214110702e-4, 1.398199936375022e-3, 8.333452045917511e-3,
          4.166579619050026e-2, 0.1666666567325592, 0.5)
_TINY = float(np.finfo(np.float32).tiny)


def exp(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` as XLA computes it on the CPU, bit for bit: the argument
    split into n·ln 2 + r (n = floor(x·log2 e + ½), clamped to ±127), a
    degree-6 polynomial in r with XLA's fused multiply-adds, scaled by 2**n,
    and results below the smallest normal float32 flushed to zero as XLA's
    CPU code flushes them.  PyTorch's ``exp`` differs from it in the last
    bit on about one input in ten."""
    x = torch.clamp(x.float(), f32(_EXP_LO), f32(_EXP_HI))
    n = torch.clamp(torch.floor(fma(x, _EXP_LOG2E, 0.5)), -127.0, 127.0)
    r = fma(-_EXP_C1, n, x)
    r = fma(-_EXP_C2, n, r)
    z = fma(r, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        z = fma(z, r, p)
    z = 1.0 + fma(z, r * r, r)
    y = z * ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(y < _TINY, torch.zeros_like(y), y)


# glibc's float cosine (sysdeps/ieee754/flt-32/s_cosf.c and sincosf_data.c,
# in glibc since 2.28), which XLA's CPU code calls for ``jnp.cos``: the
# reduction constants and the cosine and sine polynomials, in double
_COS_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")  # 2/π · 2**24
_COS_HPI = float.fromhex("0x1.921FB54442D18p0")  # π/2
# π/2 split so that n·hi is exact for |n| < 2**7: x - n·π/2 as glibc's
# FMA build of ``cosf`` (the one x86-64 runs) rounds it, once
_COS_HPI_HI = float.fromhex("0x1.921FB54442C00p0")
_COS_HPI_LO = _COS_HPI - _COS_HPI_HI
_COS_C = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5", "-0x1.6c087e89a359dp-10",
    "0x1.99343027bf8c3p-16"))
_SIN_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"))


def _top12(x: torch.Tensor) -> torch.Tensor:
    return (x.abs().view(torch.int32) >> 20) & 0x7FF


_TOP12_PIO4 = int((np.float32(np.pi / 4).view(np.int32) >> 20) & 0x7FF)
_TOP12_TINY = int((np.float32(2.0 ** -12).view(np.int32) >> 20) & 0x7FF)


def _cos_poly(x2: torch.Tensor, sign: Operand) -> torch.Tensor:
    x4 = x2 * x2
    c2 = _COS_C[3] * sign + x2 * (_COS_C[4] * sign)
    c1 = _COS_C[0] * sign + x2 * (_COS_C[1] * sign)
    c = c1 + x4 * (_COS_C[2] * sign)
    return c + (x4 * x2) * c2


def _sin_poly(x: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    x3 = x * x2
    s1 = _SIN_S[1] + x2 * _SIN_S[2]
    return (x + x3 * _SIN_S[0]) + (x3 * x2) * s1


def cos(y: torch.Tensor) -> torch.Tensor:
    """``jnp.cos`` as XLA computes it on the CPU, bit for bit: glibc's
    ``cosf``.  In double: below |y| ≈ π/4 (glibc compares the top 12 bits)
    the cosine polynomial; otherwise n = round(y·2/π) by glibc's integer
    trick, y - n·π/2, and the sine or cosine polynomial with the
    quadrant's signs; one rounding to float32 at the end.  Held to
    ``jax.jit(jnp.cos)`` for |y| < 120, where glibc takes this path; NaN
    stays NaN.  Every step is an IEEE float64 add or multiply, so the card
    rounds it as the CPU does (glibc's FMA build of ``cosf`` gives the same
    float32 results on the sampled ranges)."""
    y = y.float()
    x = y.double()
    top = _top12(y)
    n = ((x * _COS_HPI_INV).to(torch.int32) + 0x800000) >> 24
    r = (x - n.double() * _COS_HPI_HI) - n.double() * _COS_HPI_LO
    quadrant = n & 3
    sign = torch.where((quadrant == 1) | (quadrant == 2), -1.0, 1.0).double()
    table = torch.where((n & 2) != 0, -1.0, 1.0).double()
    reduced = torch.where((n & 1) == 0, _cos_poly(r * r, table), _sin_poly(r * sign, r * r))
    small = top < _TOP12_PIO4
    out = torch.where(small, _cos_poly(x * x, 1.0), reduced).float()
    out = torch.where(small & (top < _TOP12_TINY), torch.ones_like(out), out)
    return torch.where(torch.isnan(y), y, out)


def _f32_bits(*words: int) -> Tuple[float, ...]:
    return tuple(float(v) for v in np.array(words, np.uint32).view(np.float32))


# glibc's float arctangent (fdlibm's s_atanf.c and e_atan2f.c, float
# arithmetic), which XLA's CPU code calls for ``jnp.arctan2``
_ATAN_HI = _f32_bits(0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA)
_ATAN_LO = _f32_bits(0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168)
_ATAN_T = _f32_bits(0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E, 0xBD9D8795,
                    0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221, 0x3C8569D7)
_PI, _PI_LO, _PI_O_2 = _f32_bits(0x40490FDB, 0xB3BBBD2E, 0x3FC90FDB)


def _atan_abs(x: torch.Tensor) -> torch.Tensor:
    """fdlibm's ``atanf`` of a finite x ≥ 0: one of five argument
    reductions by the bits of x, the odd and even halves of the aT
    polynomial, and atan(c) as a hi/lo pair."""
    ix = x.view(torch.int32)
    one = torch.ones_like(x)
    band = ((ix >= 0x3EE00000).int() + (ix >= 0x3F300000).int() + (ix >= 0x3F980000).int()
            + (ix >= 0x401C0000).int())  # 0: |x| < 7/16, then atan(0.5|1|1.5|inf) bands
    xr = torch.where(band == 0, x, -one / x)
    xr = torch.where(band == 1, (2.0 * x - one) / (2.0 + x), xr)
    xr = torch.where(band == 2, (x - one) / (x + one), xr)
    xr = torch.where(band == 3, (x - 1.5) / (one + 1.5 * x), xr)
    z = xr * xr
    w = z * z
    s1 = torch.full_like(w, _ATAN_T[10])
    for k in (8, 6, 4, 2, 0):
        s1 = _ATAN_T[k] + w * s1
    s2 = torch.full_like(w, _ATAN_T[9])
    for k in (7, 5, 3, 1):
        s2 = _ATAN_T[k] + w * s2
    poly = xr * (z * s1 + w * s2)
    hi = lo = torch.zeros_like(x)
    for i in range(4):
        hi = torch.where(band == i + 1, _ATAN_HI[i], hi)
        lo = torch.where(band == i + 1, _ATAN_LO[i], lo)
    out = torch.where(band == 0, xr - poly, hi - ((poly - lo) - xr))
    return torch.where(ix >= 0x4C000000, f32(_ATAN_HI[3] + _ATAN_LO[3]), out)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jnp.arctan2`` as XLA computes it on the CPU, bit for bit: glibc's
    ``atan2f`` (fdlibm), in float32 adds, multiplies and divides, which
    the card rounds as the CPU does.  For finite arguments; NaN gives NaN."""
    y, x = y.float(), x.float()
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    k = (iy - ix) >> 23
    z = _atan_abs((y / x).abs())
    z = torch.where(k > 60, f32(_PI_O_2 + f32(0.5 * _PI_LO)), z)
    z = torch.where((hx < 0) & (k < -60), 0.0, z)
    quadrant = ((hy >> 31) & 1) | ((hx >> 30) & 2)  # 2·sign(x) + sign(y)
    out = torch.where(quadrant == 0, z, -z)
    out = torch.where(quadrant == 2, _PI - (z - _PI_LO), out)
    out = torch.where(quadrant == 3, (z - _PI_LO) - _PI, out)
    at_one = _atan_abs(y.abs())  # x == 1.0 returns atanf(y)
    out = torch.where(hx == 0x3F800000, torch.where(hy < 0, -at_one, at_one), out)
    y_zero = iy == 0
    out = torch.where(y_zero, torch.where(quadrant < 2, y, torch.where(quadrant == 2, _PI, -_PI)),
                      out)
    out = torch.where((ix == 0) & ~y_zero, torch.where(hy < 0, -_PI_O_2, _PI_O_2), out)
    return torch.where(torch.isnan(x) | torch.isnan(y), x + y, out)


def acos(x: torch.Tensor) -> torch.Tensor:
    """``jnp.arccos`` as XLA lowers it: ``atan2(sqrt((1 - x)(1 + x)), x)``."""
    x = x.float()
    one = torch.ones_like(x)
    return atan2(sqrt((one - x) * (one + x)), x)


def _wide(x: Operand):
    return x.double() if isinstance(x, torch.Tensor) else float(x)


def fma(a: Operand, b: Operand, c: Operand) -> torch.Tensor:
    """``a*b + c`` rounded once to float32."""
    out = _wide(a) * _wide(b) + _wide(c)
    return out.float()


def sum_of_products(pairs: Sequence[Tuple[Operand, Operand]]) -> torch.Tensor:
    """``a0*b0 + a1*b1 + ...`` with XLA's contraction order."""
    (a0, b0), rest = pairs[0], pairs[1:]
    if not rest:
        return a0 * b0
    (a1, b1), rest = rest[0], rest[1:]
    acc = fma(a0, b0, a1 * b1)
    for a, b in rest:
        acc = fma(a, b, acc)
    return acc


def reduce_sum_of_squares(diff: torch.Tensor) -> torch.Tensor:
    """``sum(diff * diff, axis=-1)`` as XLA's reduction loop rounds it: the
    accumulator starts at ``x0*x0`` and takes ``fma(xk, xk, acc)``."""
    acc = diff[..., 0] * diff[..., 0]
    for k in range(1, diff.shape[-1]):
        acc = fma(diff[..., k], diff[..., k], acc)
    return acc


def row_sum_of_squares(x: torch.Tensor) -> torch.Tensor:
    """``sum(x * x, axis=-1)`` over a short minor axis of a 2-D array as XLA
    rounds it there: every square rounded, then added left to right."""
    acc = x[..., 0] * x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k] * x[..., k]
    return acc


def contract(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...k,kp->...p", x, w)`` rounded as XLA's CPU dot rounds it:
    four partial sums over k mod 4, each the first product followed by
    fused multiply-adds in k order, combined as (s0 + s1) + (s2 + s3).
    The four lanes run side by side; zero padding of k to a multiple of 4
    leaves every lane's sum unchanged."""
    k = x.shape[-1]
    pad = -k % 4
    x4 = torch.nn.functional.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, 4)
    w4 = torch.nn.functional.pad(w, (0, 0, 0, pad)).reshape(-1, 4, w.shape[-1])
    acc = x4[..., 0, :, None] * w4[0]
    for i in range(1, w4.shape[0]):
        acc = fma(x4[..., i, :, None], w4[i], acc)
    return (acc[..., 0, :] + acc[..., 1, :]) + (acc[..., 2, :] + acc[..., 3, :])


REDUCE_WINDOW = 32  # XLA's CPU tree-reduction window


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """``sum(x, axis=-1)`` as XLA's CPU code rounds a long reduction: it
    sums windows of 32 consecutive elements left to right, then reduces
    the window sums the same way until at most 32 remain, which it adds
    left to right."""
    m = x.shape[-1]
    if m > REDUCE_WINDOW:
        n_win = -(-m // REDUCE_WINDOW)
        padded = torch.nn.functional.pad(x, (0, n_win * REDUCE_WINDOW - m))
        x = padded.reshape(*x.shape[:-1], n_win, REDUCE_WINDOW)
        acc = x[..., 0]
        for k in range(1, REDUCE_WINDOW):
            acc = acc + x[..., k]
        return tree_sum(acc)
    acc = x[..., 0]
    for k in range(1, m):
        acc = acc + x[..., k]
    return acc


def _window_sums_2d(x: torch.Tensor) -> torch.Tensor:
    """One level of XLA's CPU tree reduction over the last two axes: each
    32 x 32 window (zero padded at the ends) summed one element at a time
    in row-major order."""
    w = REDUCE_WINDOW
    x = torch.nn.functional.pad(x, (0, -x.shape[-1] % w, 0, -x.shape[-2] % w))
    acc = x[..., 0::w, 0::w]
    for i in range(w):
        for j in range(w):
            if i or j:
                acc = acc + x[..., i::w, j::w]
    return acc


def tree_sum_2d(x: torch.Tensor) -> torch.Tensor:
    """``sum`` over the last two axes as XLA's CPU code rounds it: windows
    of 32 x 32 (:func:`_window_sums_2d`) while either axis is longer than
    32, then what remains one element at a time in row-major order."""
    while x.shape[-2] > REDUCE_WINDOW or x.shape[-1] > REDUCE_WINDOW:
        x = _window_sums_2d(x)
    flat = x.reshape(*x.shape[:-2], -1)
    acc = flat[..., 0]
    for k in range(1, flat.shape[-1]):
        acc = acc + flat[..., k]
    return acc
