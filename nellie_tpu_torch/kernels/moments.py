"""Batched image moments, Hu invariants and ROI statistics.

Port of ``nellie_tpu/kernels/moments.py``: raw moments as two
contractions, central moments by the binomial transform, η normalisation,
the first six Hu invariants, and masked mean/variance of nonzero voxels.

Third-order central moments cancel most of their digits in float32, so
the raw moments are summed in the order XLA's CPU dot sums the
reference's einsums, and the binomial transform fuses its multiply-adds
where XLA does: the Hu features then follow the reference's roundings
instead of amplifying a different summation order's.
"""
from __future__ import annotations

from math import comb

import torch

from nellie_tpu_torch.kernels._fp import contract, fma, log10
from nellie_tpu_torch.kernels._fp import pow as pow_f32


def raw_moments(images: torch.Tensor, order: int = 3) -> torch.Tensor:
    """M[n, p, q] with p the column (x) power and q the row (y) power."""
    _, h, w = images.shape
    k = order + 1
    powers = torch.arange(k, dtype=torch.float32, device=images.device)
    row_pow = torch.arange(h, dtype=torch.float32, device=images.device)[:, None] ** powers[None, :]
    col_pow = torch.arange(w, dtype=torch.float32, device=images.device)[:, None] ** powers[None, :]
    tmp = contract(images, col_pow)                   # (N, H, K)
    return contract(tmp.transpose(1, 2), row_pow)     # (N, K, K)


_VOXEL_BLOCK = 4096  # voxels per block of widened terms in masked_mean_variance

# (p, q) of the central moments whose first addition XLA's CPU code fuses
# with its right product (the left one elsewhere); read off its output.
# XLA fuses the same expressions differently in different programs: the
# tracker's feature program (``hu_tracking._frame_features_fused``) maps
# its chunks of markers with ``lax.map``, which XLA inlines for one chunk
# and compiles as a loop body for more, and in the loop body μ30 fuses its
# left product.  ``looped`` below selects that program.
_FUSE_RIGHT = frozenset({(0, 3), (1, 2), (1, 3), (2, 1), (2, 3), (3, 0), (3, 1)})
_FUSE_RIGHT_LOOPED = _FUSE_RIGHT - {(3, 0)}


def _sum_terms(terms, fuse_right):
    """``t0 + t1 + ...`` for terms ``(factor, value)`` meaning
    ``factor * value`` (``factor`` None for a bare value), with XLA's fused
    multiply-adds: every later product is fused into the running sum."""
    def product(t):
        return t[1] if t[0] is None else t[0] * t[1]

    if len(terms) == 1:
        return product(terms[0])
    (f0, v0), (f1, v1) = terms[0], terms[1]
    if f1 is not None and (f0 is None or fuse_right):
        acc = fma(f1, v1, product(terms[0]))
    elif f0 is not None:
        acc = fma(f0, v0, product(terms[1]))
    else:
        acc = v0 + v1
    for f, v in terms[2:]:
        acc = acc + v if f is None else fma(f, v, acc)
    return acc


def central_moments(m: torch.Tensor, looped: bool = False) -> torch.Tensor:
    k = m.shape[1]
    fuse_right = _FUSE_RIGHT_LOOPED if looped else _FUSE_RIGHT
    m00 = m[:, 0, 0] + 1e-12
    x_bar = m[:, 1, 0] / m00
    y_bar = m[:, 0, 1] / m00
    mu = torch.zeros_like(m)
    for p in range(k):
        for q in range(k):
            # XLA drops the factors equal to 1 and fuses a product into the
            # addition that consumes it
            terms = []
            for i in range(p + 1):
                for j in range(q + 1):
                    factor = None
                    for f, keep in ((float(comb(p, i) * comb(q, j)), comb(p, i) * comb(q, j) != 1),
                                    ((-x_bar) ** (p - i), p != i), ((-y_bar) ** (q - j), q != j)):
                        if keep:
                            factor = f if factor is None else factor * f
                    terms.append((factor, m[:, i, j]))
            mu[:, p, q] = _sum_terms(terms, (p, q) in fuse_right)
    return mu


def normalized_moments(images: torch.Tensor, looped: bool = False) -> torch.Tensor:
    """η moments up to order 3, shape (N, 4, 4)."""
    m = raw_moments(images, order=3)
    mu = central_moments(m, looped)
    # m00 ** ((i + j + 2) / 2) through XLA's CPU pow (glibc's powf; x and
    # x * x at 1 and 2), so that the denominators agree on every device
    m00 = m[:, 0, 0]
    powers = {e: pow_f32(m00, e / 2.0) for e in range(2, 9)}
    denom = torch.stack([torch.stack([powers[i + j + 2] for j in range(4)], dim=-1)
                         for i in range(4)], dim=-2) + 1e-12
    return mu / denom


def hu_moments(eta: torch.Tensor, projections: bool = False) -> torch.Tensor:
    """The first six Hu moments (the 7th is skipped for mirror invariance),
    with the multiply-adds XLA's CPU code fuses: a product used once is
    fused into the addition or subtraction that consumes it (read off
    ``jax.jit`` of the reference).  Where both products of an addition
    could fuse, the reference's 2D program fuses the left one and leaves
    h1 unfused; its program over the three projections of a 3D ROI
    (``projections``) fuses h1 and the right product of h4."""
    eta20, eta02, eta11 = eta[:, 2, 0], eta[:, 0, 2], eta[:, 1, 1]
    eta30, eta12, eta21, eta03 = eta[:, 3, 0], eta[:, 1, 2], eta[:, 2, 1], eta[:, 0, 3]
    a, b = eta30 + eta12, eta21 + eta03
    a2, b2 = a * a, b * b
    s1 = fma(-3.0, eta12, eta30)   # eta30 - 3 eta12
    s2 = fma(3.0, eta21, -eta03)   # 3 eta21 - eta03
    h0 = eta20 + eta02
    d = eta20 - eta02
    h2 = fma(s1, s1, s2 * s2)
    h3 = fma(a, a, b2)
    p1, t1 = s1 * a, fma(-3.0, b2, a2)
    p2, t2 = s2 * b, fma(3.0, a2, -b2)
    if projections:
        h1 = fma(d, d, 4 * eta11 ** 2)
        h4 = fma(p2, t2, p1 * t1)
    else:
        h1 = d * d + 4 * eta11 ** 2
        h4 = fma(p1, t1, p2 * t2)
    h5 = fma((4 * eta11) * a, b, d * fma(a, a, -b2))
    return torch.stack([h0, h1, h2, h3, h4, h5], dim=1)


def log_hu(hu: torch.Tensor) -> torch.Tensor:
    """Sign-stable log10 transform.  A subnormal Hu value counts as 0, as
    XLA's CPU code flushes subnormal results to zero: PyTorch keeps them,
    and -sign(h) * log10(tiny) would then give ±37.9 where the reference
    gives 0 (a Hu moment that cancels to within 1e-38)."""
    tiny = torch.finfo(hu.dtype).tiny
    hu = torch.where(hu.abs() < tiny, torch.zeros_like(hu), hu)
    abs_hu = torch.clamp(hu.abs(), min=tiny)
    out = -torch.sign(hu) * log10(abs_hu)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def hu_2d(images: torch.Tensor, looped: bool = False) -> torch.Tensor:
    return hu_moments(normalized_moments(images, looped))


def hu_3d(volumes: torch.Tensor, looped: bool = False) -> torch.Tensor:
    """(N, Z, Y, X) -> (N, 18): Hu of the three orthogonal max projections."""
    return torch.cat([hu_moments(normalized_moments(volumes.amax(dim=axis), looped),
                                 projections=True)
                      for axis in (1, 2, 3)], dim=1)


def masked_mean_variance(images: torch.Tensor) -> torch.Tensor:
    """[mean, variance] of the nonzero voxels of each image, (N, 2).

    The variance cancels most of its digits, so the sums are taken in the
    reference's order: XLA's CPU reduction adds the voxels one by one in
    raster order (the squares with fused multiply-adds).  Each step adds
    float64 terms into float32 sums, which rounds once as XLA does."""
    n = images.shape[0]
    flat = images.reshape(n, -1).float()
    count = (flat != 0).sum(dim=1)
    safe = torch.where(count == 0, torch.ones_like(count), count).float()
    sums = torch.zeros(n, 2, dtype=torch.float32, device=images.device)
    for start in range(0, flat.shape[1], _VOXEL_BLOCK):
        wide = flat[:, start:start + _VOXEL_BLOCK].T.double()
        terms = torch.stack([wide, wide * wide], dim=2)   # (voxels, N, 2)
        for k in range(terms.shape[0]):
            sums.add_(terms[k])
    total, total_sq = sums[:, 0], sums[:, 1]
    mean = total / safe
    var = (total_sq - total ** 2 / safe) / safe
    zero = count == 0
    mean = torch.where(zero, torch.zeros_like(mean), mean)
    var = torch.where(zero, torch.zeros_like(var), var)
    return torch.stack([mean, var], dim=1)
