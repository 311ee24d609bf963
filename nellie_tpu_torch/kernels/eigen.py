"""Closed-form eigenvalues of symmetric 2x2 and 3x3 matrices, elementwise.

Port of ``nellie_tpu/kernels/eigen.py``: ``eigvalsh2`` is the quadratic
formula, ``eigvalsh3`` the trigonometric (Cardano) method on the scaled
matrix; no LAPACK, eigenvalues sorted by |λ| ascending.  Divisions by
constants are multiplications by the float32 reciprocal, as XLA compiles
them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from nellie_tpu_torch.kernels._fp import acos, cos, f32, fma, sqrt, sum_of_products

_TWO_PI_3 = 2.0943951023931953  # 2π/3


def eigvalsh2(hxx, hxy, hyy) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues of [[hxx, hxy], [hxy, hyy]], sorted by |λ| ascending.

    The discriminant fuses its first square into the sum, as XLA does, and
    the square root is correctly rounded (:func:`_fp.sqrt`)."""
    trace = hxx + hyy
    diff = hxx - hyy
    delta = sqrt(fma(diff, diff, 4.0 * hxy * hxy))
    l1 = 0.5 * (trace - delta)
    l2 = 0.5 * (trace + delta)
    swap = l1.abs() > l2.abs()
    return torch.where(swap, l2, l1), torch.where(swap, l1, l2)


def eigvalsh3(hxx, hxy, hxz, hyy, hyz, hzz) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eigenvalues of [[hxx,hxy,hxz],[hxy,hyy,hyz],[hxz,hyz,hzz]], sorted by
    |λ| ascending."""
    scale = torch.maximum(
        torch.maximum(torch.maximum(hxx.abs(), hyy.abs()), torch.maximum(hzz.abs(), hxy.abs())),
        torch.maximum(hxz.abs(), hyz.abs()),
    )
    pos = scale > 0
    s = torch.where(pos, 1.0 / torch.where(pos, scale, torch.ones_like(scale)),
                    torch.ones_like(scale))
    a, b, c = hxx * s, hyy * s, hzz * s
    d, e, f = hxy * s, hxz * s, hyz * s

    trace = a + b + c
    third = f32(1.0 / 3.0)
    q = trace * third
    p1 = sum_of_products([(d, d), (e, e), (f, f)])
    # each a - q takes the product trace·(1/3) into a fused multiply-add
    am, bm, cm = (fma(-trace, third, x) for x in (a, b, c))
    p2 = sum_of_products([(am, am), (bm, bm), (cm, cm)]) + 2.0 * p1
    p = sqrt(torch.clamp(p2, min=0.0) * f32(1.0 / 6.0))
    p_safe = torch.where(p > 0, p, torch.ones_like(p))

    b00, b11, b22 = am / p_safe, bm / p_safe, cm / p_safe
    b01, b02, b12 = d / p_safe, e / p_safe, f / p_safe
    minor0 = sum_of_products([(b11, b22), (-b12, b12)])
    minor1 = sum_of_products([(b01, b22), (-b12, b02)])
    minor2 = sum_of_products([(b01, b12), (-b11, b02)])
    det_b = fma(b02, minor2, fma(b00, minor0, -(b01 * minor1)))
    r = torch.clamp(det_b * 0.5, -1.0, 1.0)
    phi = acos(r) * f32(1.0 / 3.0)

    two_p = 2.0 * p
    e1 = fma(two_p, cos(phi), q)
    e3 = fma(two_p, cos(phi + f32(_TWO_PI_3)), q)
    e2 = (trace - e1) - e3  # XLA folds 3·(trace/3) back into the trace

    degenerate = p == 0
    e1 = torch.where(degenerate, q, e1)
    e2 = torch.where(degenerate, q, e2)
    e3 = torch.where(degenerate, q, e3)

    inv_s = torch.where(pos, scale, torch.ones_like(scale))
    l1, l2, l3 = e3 * inv_s, e2 * inv_s, e1 * inv_s

    def _swap_if(cond, x, y):
        return torch.where(cond, y, x), torch.where(cond, x, y)

    l1, l2 = _swap_if(l1.abs() > l2.abs(), l1, l2)
    l2, l3 = _swap_if(l2.abs() > l3.abs(), l2, l3)
    l1, l2 = _swap_if(l1.abs() > l2.abs(), l1, l2)
    return l1, l2, l3
