"""Gradients and Hessian stencils with physical spacing.

Port of ``nellie_tpu/kernels/hessian.py``: ``np.gradient`` semantics
(central differences inside, one-sided at the edges) divided by the voxel
spacing, giving the unique Hessian components and the Frobenius norm
normalised by the largest absolute component.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from nellie_tpu_torch.kernels._fp import f32, flush, fma, sqrt


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
_XLA_SMALL_FRAME = 32  # a frame no longer than this along every axis


def _fuses_inner_gradient(f: torch.Tensor, axis: int, frame_shape=None,
                          masked: bool = True) -> bool:
    """Whether XLA fuses the whole inner gradient into the outer one, as
    it compiles the reference's Frangi scale body (2D and 3D).

    Two of its fusion rules decide it: the inner gradient's edge-shifted
    copies are minor-axis concatenations of n - 1 elements, fusible only
    below the limit; and while the Hessian components' own concatenations
    (n elements) are fusible too, they enter the same consumer first and
    its code duplication is then too high to take the inner gradient in.
    So with the Frobenius mask (``masked``) only a minor axis of exactly
    the limit fuses it: ``scripts/xla_fusion_probe.py`` finds it at a last
    axis of 128 alone among 2 to 520 (Z, Y = 12, 48), and at 128 for every
    Z and Y it tried (1 to 256), in 2D as in 3D.  Without the mask
    (``vesselness_frame(..., apply_mask=False)``) no Frobenius norm reads
    the components, so every axis fuses it but a minor one of more than
    the limit (``scripts/xla_unmasked_probe.py``); and so does the masked
    program of a small frame, every axis of which is at most
    ``_XLA_SMALL_FRAME`` long (``scripts/xla_unmasked_probe.py`` prints both
    programs: masked, 9x20x30, 30x20x30 and 32x32x32 fuse it on every axis,
    9x20x33, 9x33x30 and 33x32x32 on none; 2D alike).
    ``frame_shape``: the whole frame's shape, when ``f`` is a block of it
    (the rule is the frame's)."""
    shape = tuple(f.shape) if frame_shape is None else tuple(int(v) for v in frame_shape)
    n = shape[axis]
    if not masked or max(shape) <= _XLA_SMALL_FRAME:
        return axis != f.ndim - 1 or n - 1 < _XLA_MINOR_CONCAT_LIMIT
    return axis == f.ndim - 1 and n - 1 < _XLA_MINOR_CONCAT_LIMIT <= n


def fused_axes(f: torch.Tensor, frame_shape=None, masked: bool = True):
    """Per axis, whether its diagonal component fuses the whole inner
    gradient (:func:`_fuses_inner_gradient`); every axis's edge
    differences are contracted either way (:func:`_second_gradient`)."""
    return [_fuses_inner_gradient(f, axis, frame_shape, masked) for axis in range(f.ndim)]


def _second_gradient(f: torch.Tensor, spacing: float, axis: int,
                     frame_shape=None, masked: bool = True) -> torch.Tensor:
    """``gradient(gradient(f))`` along one axis as XLA rounds every
    diagonal component (``hxx``, ``hyy``, ``hzz``): it fuses the inner
    gradient's edge values into the outer gradient, whose two edge
    differences then take their left product into a fused multiply-add.
    Where it fuses the whole inner gradient (:func:`_fuses_inner_gradient`),
    every interior difference takes its left product into one as well."""
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
    if _fuses_inner_gradient(f, axis, frame_shape, masked) and n > 3:
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


def _flushed_sum_of_squares(comps):
    """``c0² + c1² + ...`` in XLA's contraction order (``sum_of_products``),
    each result flushed to zero where it is subnormal."""
    if len(comps) == 1:
        return flush(comps[0] * comps[0])
    acc = flush(fma(comps[0], comps[0], flush(comps[1] * comps[1])))
    for c in comps[2:]:
        acc = flush(fma(c, c, acc))
    return acc


def frobenius_norm(h: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The Hessian's unnormalised Frobenius norm: the diagonal's and the
    off-diagonal's sums of squares in XLA's order, the latter doubled, and
    a correctly rounded root, so that the Frobenius mask, hence
    im_preprocessed, follows the reference's.  The squares of a dim
    frame's components reach the subnormal range, which XLA's CPU code
    flushes to zero (``tests/test_torch_subnormals.py``): so does this."""
    if "hzz" in h:
        diag = _flushed_sum_of_squares([h["hxx"], h["hyy"], h["hzz"]])
        off = _flushed_sum_of_squares([h["hxy"], h["hxz"], h["hyz"]])
    else:
        diag = _flushed_sum_of_squares([h["hxx"], h["hyy"]])
        off = _flushed_sum_of_squares([h["hxy"]])
    return sqrt(flush(diag + 2.0 * off))


def hessian_unnormalized(
    image: torch.Tensor, spacing: Sequence[float], frame_shape=None, masked: bool = True
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The components and the Frobenius norm before its division by the
    largest |component|; ``frame_shape`` as for :func:`_fuses_inner_gradient`.
    ``masked``: the components as the program with the Frobenius mask
    rounds them (the Filter's); without it XLA fuses the whole inner
    gradient of every diagonal component but along a minor axis of more
    than 128 (:func:`_fuses_inner_gradient`)."""
    spacing = tuple(float(s) for s in spacing)
    if image.ndim == 2:
        g0 = gradient(image, spacing[0], 0)
        h = {
            "hxx": _second_gradient(image, spacing[0], 0, frame_shape, masked),
            "hxy": gradient(g0, spacing[1], 1),
            "hyy": _second_gradient(image, spacing[1], 1, frame_shape, masked),
        }
        frob = frobenius_norm(h)
    elif image.ndim == 3:
        g0 = gradient(image, spacing[0], 0)
        g1 = gradient(image, spacing[1], 1)
        h = {
            "hxx": _second_gradient(image, spacing[0], 0, frame_shape, masked),
            "hxy": gradient(g0, spacing[1], 1),
            "hxz": gradient(g0, spacing[2], 2),
            "hyy": _second_gradient(image, spacing[1], 1, frame_shape, masked),
            "hyz": gradient(g1, spacing[2], 2),
            "hzz": _second_gradient(image, spacing[2], 2, frame_shape, masked),
        }
        frob = frobenius_norm(h)
    else:
        raise ValueError(f"unsupported number of dimensions: {image.ndim}")
    return h, frob
