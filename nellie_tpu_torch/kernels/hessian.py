"""Gradients and Hessian stencils with physical spacing.

Port of ``nellie_tpu/kernels/hessian.py``: ``np.gradient`` semantics
(central differences inside, one-sided at the edges) divided by the voxel
spacing, giving the unique Hessian components and the Frobenius norm
normalised by the largest absolute component.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from nellie_tpu_torch.kernels._fp import f32, fma, sqrt, sum_of_products


def gradient(f: torch.Tensor, spacing: float, axis: int) -> torch.Tensor:
    n = f.shape[axis]
    if n < 2:
        return torch.zeros_like(f)
    inv = 1.0 / float(spacing)
    interior = (f.narrow(axis, 2, n - 2) - f.narrow(axis, 0, n - 2)) * f32(0.5 * inv)
    first = (f.narrow(axis, 1, 1) - f.narrow(axis, 0, 1)) * f32(inv)
    last = (f.narrow(axis, n - 1, 1) - f.narrow(axis, n - 2, 1)) * f32(inv)
    return torch.cat([first, interior, last], dim=axis)


def _second_gradient(f: torch.Tensor, spacing: float, axis: int) -> torch.Tensor:
    """``gradient(gradient(f))`` along one axis as XLA rounds the 3D
    ``hyy`` and ``hzz``: it fuses the inner gradient's edge values into
    the outer gradient, whose two edge differences then take their left
    product into a fused multiply-add.

    At frame shapes where XLA fuses the whole inner gradient (a last axis
    of 128, for one), its interior differences are fused too and the
    port's last bits differ there; the parity inputs and the windows of
    the low-memory Filter are not such shapes."""
    g = gradient(f, spacing, axis)
    out = gradient(g, spacing, axis)
    n = f.shape[axis]
    if n < 3:
        return out
    inv = f32(1.0 / float(spacing))
    half = f32(0.5 / float(spacing))
    first = fma(f.narrow(axis, 2, 1) - f.narrow(axis, 0, 1), half, -g.narrow(axis, 0, 1)) * inv
    last = fma(f.narrow(axis, n - 1, 1) - f.narrow(axis, n - 2, 1), inv,
               -g.narrow(axis, n - 2, 1)) * inv
    return torch.cat([first, out.narrow(axis, 1, n - 2), last], dim=axis)


def hessian_components(
    image: torch.Tensor, spacing: Sequence[float]
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Unique second derivatives (2D: hxx, hxy, hyy; 3D: hxx, hxy, hxz,
    hyy, hyz, hzz; axis 0 = 'x') and the Frobenius norm over the largest
    |component|."""
    spacing = tuple(float(s) for s in spacing)
    if image.ndim == 2:
        g0 = gradient(image, spacing[0], 0)
        g1 = gradient(image, spacing[1], 1)
        h = {
            "hxx": gradient(g0, spacing[0], 0),
            "hxy": gradient(g0, spacing[1], 1),
            "hyy": gradient(g1, spacing[1], 1),
        }
        # XLA's order and a correctly rounded root, so that the 2D
        # Frobenius mask, hence im_preprocessed, follows the reference's
        frob = sqrt(sum_of_products([(h["hxx"], h["hxx"]), (h["hyy"], h["hyy"])])
                    + 2.0 * (h["hxy"] * h["hxy"]))
    elif image.ndim == 3:
        g0 = gradient(image, spacing[0], 0)
        g1 = gradient(image, spacing[1], 1)
        h = {
            "hxx": gradient(g0, spacing[0], 0),
            "hxy": gradient(g0, spacing[1], 1),
            "hxz": gradient(g0, spacing[2], 2),
            "hyy": _second_gradient(image, spacing[1], 1),
            "hyz": gradient(g1, spacing[2], 2),
            "hzz": _second_gradient(image, spacing[2], 2),
        }
        off = sum_of_products([(h["hxy"], h["hxy"]), (h["hxz"], h["hxz"]), (h["hyz"], h["hyz"])])
        diag = sum_of_products([(h["hxx"], h["hxx"]), (h["hyy"], h["hyy"]), (h["hzz"], h["hzz"])])
        frob = sqrt(diag + 2.0 * off)
    else:
        raise ValueError(f"unsupported number of dimensions: {image.ndim}")

    max_abs = torch.zeros((), dtype=image.dtype, device=image.device)
    for comp in h.values():
        max_abs = torch.maximum(max_abs, comp.abs().max())
    max_abs = torch.where(max_abs > 0, max_abs, torch.ones_like(max_abs))
    return h, frob / max_abs
