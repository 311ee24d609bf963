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


# XLA's CPU compiler does not fuse a concatenation along the minor-most
# axis whose length is at least this many elements into its consumers
# ("Concatenate fusion is inefficient" in its fusion log).
_XLA_MINOR_CONCAT_LIMIT = 128


def _fuses_inner_gradient(f: torch.Tensor, axis: int, minor_extent=None) -> bool:
    """Whether XLA fuses the whole inner gradient into the outer one, as
    it compiles the reference's Frangi scale body (2D and 3D).

    Two of its fusion rules decide it: the inner gradient's edge-shifted
    copies are minor-axis concatenations of n - 1 elements, fusible only
    below the limit; and while the Hessian components' own concatenations
    (n elements) are fusible too, they enter the same consumer first and
    its code duplication is then too high to take the inner gradient in.
    So only a minor axis of exactly the limit fuses it:
    ``scripts/xla_fusion_probe.py`` finds it at a last axis of 128 alone
    among 2 to 520 (Z, Y = 12, 48), and at 128 for every Z and Y it tried
    (1 to 256), in 2D as in 3D.  ``minor_extent``: the whole frame's
    last-axis width, when ``f`` is a block of it (the rule is the frame's)."""
    n = f.shape[axis] if minor_extent is None else int(minor_extent)
    return axis == f.ndim - 1 and n - 1 < _XLA_MINOR_CONCAT_LIMIT <= n


def _second_gradient(f: torch.Tensor, spacing: float, axis: int,
                     minor_extent=None) -> torch.Tensor:
    """``gradient(gradient(f))`` along one axis as XLA rounds the 2D
    ``hyy`` and the 3D ``hyy`` and ``hzz``: it fuses the inner gradient's
    edge values into the outer gradient, whose two edge differences then
    take their left product into a fused multiply-add.  Where it fuses
    the whole inner gradient (:func:`_fuses_inner_gradient`), every
    interior difference takes its left product into one as well."""
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
    interior = out.narrow(axis, 1, n - 2)
    if _fuses_inner_gradient(f, axis, minor_extent) and n > 3:
        # g[i + 1] = diff[i + 1] * coefficient, contracted into g[i + 1] - g[i - 1]
        diff = torch.cat([f.narrow(axis, 3, n - 3) - f.narrow(axis, 1, n - 3),
                          f.narrow(axis, n - 1, 1) - f.narrow(axis, n - 2, 1)], dim=axis)
        coef = torch.full_like(diff, half)
        coef.narrow(axis, n - 3, 1).fill_(inv)
        interior = fma(diff, coef, -g.narrow(axis, 0, n - 2)) * half
    return torch.cat([first, interior, last], dim=axis)


def hessian_components(
    image: torch.Tensor, spacing: Sequence[float]
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Unique second derivatives (2D: hxx, hxy, hyy; 3D: hxx, hxy, hxz,
    hyy, hyz, hzz; axis 0 = 'x') and the Frobenius norm over the largest
    |component|."""
    h, frob = hessian_unnormalized(image, spacing)
    return h, frob / nonzero_or_one(largest_component(h))


def largest_component(h: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The largest |value| over the Hessian components (0-d tensor)."""
    return torch.stack([comp.abs().max() for comp in h.values()]).max()


def nonzero_or_one(max_abs: torch.Tensor) -> torch.Tensor:
    return torch.where(max_abs > 0, max_abs, torch.ones_like(max_abs))


def hessian_unnormalized(
    image: torch.Tensor, spacing: Sequence[float], minor_extent=None
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The components and the Frobenius norm before its division by the
    largest |component|; ``minor_extent`` as for :func:`_fuses_inner_gradient`."""
    spacing = tuple(float(s) for s in spacing)
    if image.ndim == 2:
        g0 = gradient(image, spacing[0], 0)
        g1 = gradient(image, spacing[1], 1)
        h = {
            "hxx": gradient(g0, spacing[0], 0),
            "hxy": gradient(g0, spacing[1], 1),
            "hyy": _second_gradient(image, spacing[1], 1, minor_extent),
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
            "hyy": _second_gradient(image, spacing[1], 1, minor_extent),
            "hyz": gradient(g1, spacing[2], 2),
            "hzz": _second_gradient(image, spacing[2], 2, minor_extent),
        }
        off = sum_of_products([(h["hxy"], h["hxy"]), (h["hxz"], h["hxz"]), (h["hyz"], h["hyz"])])
        diag = sum_of_products([(h["hxx"], h["hxx"]), (h["hyy"], h["hyy"]), (h["hzz"], h["hzz"])])
        frob = sqrt(diag + 2.0 * off)
    else:
        raise ValueError(f"unsupported number of dimensions: {image.ndim}")
    return h, frob
