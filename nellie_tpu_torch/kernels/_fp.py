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


def log10(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log10``: the natural log times float32(1/ln 10)."""
    return torch.log(x) * f32(1.0 / np.log(10.0))


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


_REDUCE_WINDOW = 32  # XLA's CPU tree-reduction window


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """``sum(x, axis=-1)`` as XLA's CPU code rounds a long reduction: it
    sums windows of 32 consecutive elements left to right, then reduces
    the window sums the same way until at most 32 remain, which it adds
    left to right."""
    m = x.shape[-1]
    if m > _REDUCE_WINDOW:
        n_win = -(-m // _REDUCE_WINDOW)
        padded = torch.nn.functional.pad(x, (0, n_win * _REDUCE_WINDOW - m))
        x = padded.reshape(*x.shape[:-1], n_win, _REDUCE_WINDOW)
        acc = x[..., 0]
        for k in range(1, _REDUCE_WINDOW):
            acc = acc + x[..., k]
        return tree_sum(acc)
    acc = x[..., 0]
    for k in range(1, m):
        acc = acc + x[..., k]
    return acc
