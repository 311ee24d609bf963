"""The 1-D correlation of the Filter's Gaussian cascade and of the LoG: the
port's plain versions against the JAX package's, bit for bit on the CPU,
and ``kernel_model`` (``csrc/gauss_axis.cu``'s loop: the tap list, the
reflected index, the multiply-add chain) against the plain versions, so that the kernel's arithmetic is held on the CPU too (the
kernel itself, on the card: ``tests/test_torch_gauss_axis_cuda.py``).

The LoG is held where its taps are shorter than the axis, with the sigmas
of ``test_torch_segmentation.test_filters_bitwise`` and others; where its
reflected taps reach past the axis's extent, in
``tests/test_torch_log_programs.py``.  Jitted alone in 3D,
``gaussian_laplace`` at a sigma of exactly 1 along an axis (0.4, 1, 1 or
1, 2, 2) shares the order-0 and order-2 centre products of one input in
XLA's last fusion, which never contracts them (``filters.log_program``):
those sigmas are cases too, and ``kernel_model`` reads a centre tap from
another tensor as the kernel does for that program.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import torch_port_data as D  # noqa: F401 — puts the repo on the path
from torch_port_data import one_torch_thread  # noqa: F401 — autouse
from nellie_tpu.kernels import filters as j_filters
from nellie_tpu_torch.kernels import filters, frangi

PARAMS = {3: frangi.FrangiParams(sigmas=(0.625, 0.8333, 1.0417, 1.25), spacing=(0.5, 0.2, 0.2),
                                 z_ratio=2.5),
          2: frangi.FrangiParams(sigmas=(0.5, 0.75, 1.0), spacing=(0.1, 0.1))}
SHAPES = [(12, 48, 48), (5, 16, 128), (64, 128), (3, 200)]
LOG_SHAPES = [(12, 48, 48), (24, 32, 128), (64, 128)]  # every tap radius below the extent
LOG_TAPS = [(1.0, 0), (1.0, 2), (2.5, 2), (0.3, 0)]


def kernel_model(x, taps, axis, round_half=False, shared=None, centre=None):
    """``csrc/gauss_axis.cu`` in torch: each output reads tap k at the
    reflected index i + offset_k (numpy's "symmetric") and sums
    fma(x0, w0, x1 * w1), then fma(xk, wk, acc), rounding once a step; at
    the positions where ``shared`` (``filters.shared_products``' table)
    flags a tap, its product is rounded and added (for the first add the
    other product is contracted, or neither); the tap at offset 0 reads
    ``centre`` where given; optionally rounded through float16."""
    from nellie_tpu_torch.kernels._fp import fma_plain

    n = x.shape[axis]
    i = torch.arange(n, device=x.device)

    def at(offset):
        if offset == 0 and centre is not None:
            return centre
        m = torch.remainder(i + offset, 2 * n)
        return torch.index_select(x, axis, torch.where(m < n, m, 2 * n - 1 - m))

    def flag(k):  # tap k's flags broadcast along the axis
        col = torch.zeros(n, dtype=torch.bool) if shared is None else \
            torch.from_numpy(np.ascontiguousarray(shared[:, k]))
        return col.reshape([n if a == axis else 1 for a in range(x.ndim)])

    (o0, w0), rest = taps[0], taps[1:]
    if not rest:
        acc = at(o0) * w0
    else:
        (o1, w1) = rest[0]
        p0, p1 = at(o0) * w0, at(o1) * w1
        acc = torch.where(flag(0) & flag(1), p0 + p1,
                          torch.where(flag(0), fma_plain(at(o1), w1, p0),
                                      fma_plain(at(o0), w0, p1)))
        for k, (o, w) in enumerate(rest[1:], start=2):
            acc = torch.where(flag(k), acc + at(o) * w, fma_plain(at(o), w, acc))
    return acc.half().float() if round_half else acc


def assert_bitwise(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    differ = got.view(np.int32) != want.view(np.int32)
    assert int(differ.sum()) == 0, f"{int(differ.sum())} of {got.size} differ"


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def frame(request):
    return chip_smoke.filter_frame(request.param, seed=len(request.param))


@pytest.mark.parametrize("carry", ["float32", "float16"])
def test_cascade_correlation_bitwise(frame, carry):
    """Each scale's padded taps along each axis, the result in the carry
    type (the JAX cascade's ``.astype(carry)``)."""
    dtype = {"float32": jnp.float32, "float16": jnp.float16}[carry]
    for axis in range(frame.ndim):
        for w in frangi._delta_kernels(PARAMS[frame.ndim], frame.ndim)[axis]:
            want = jax.jit(lambda x: j_filters.correlate1d_traced(x, w, axis).astype(dtype)
                           .astype(jnp.float32))(frame)
            got = filters.correlate1d_traced(torch.from_numpy(frame), w, axis,
                                             frangi.CARRY_DTYPES[carry])
            assert_bitwise(got.numpy(), want)


@pytest.mark.parametrize("shape", LOG_SHAPES)
def test_log_correlation_bitwise(shape):
    frame = chip_smoke.filter_frame(shape, seed=len(shape))
    for axis in range(frame.ndim):
        for sigma, order in LOG_TAPS:
            w = filters.gaussian_kernel1d(sigma, 4.0, order=order)
            want = jax.jit(lambda x: j_filters._correlate1d(x, w, axis))(frame)
            assert_bitwise(filters._correlate1d(torch.from_numpy(frame), w, axis).numpy(), want)


@pytest.mark.parametrize("shape,sigma", [((12, 48, 48), (0.7, 1.6, 1.3)),
                                         ((24, 32, 128), (0.5, 1.25, 1.25)),
                                         ((64, 128), (1.0, 1.0)), ((64, 128), (0.5, 0.5)),
                                         ((12, 48, 48), (0.4, 1.0, 1.0)),
                                         ((12, 48, 48), (1.0, 2.0, 2.0)),
                                         ((12, 48, 48), (1.0, 1.0, 1.0)),
                                         ((10, 40, 56), (0.5, 1.0, 2.0)),
                                         ((64, 128), (2.0, 1.0))])
def test_gaussian_laplace_bitwise(shape, sigma):
    frame = chip_smoke.filter_frame(shape, seed=len(shape))
    want = jax.jit(lambda x: j_filters.gaussian_laplace(x, sigma))(frame)
    assert_bitwise(filters.gaussian_laplace(torch.from_numpy(frame), sigma).numpy(), want)


@pytest.mark.parametrize("round_half", [False, True])
def test_kernel_model_equals_plain(frame, round_half):
    """The kernel's loop, in torch, on the taps its wrapper passes."""
    x = torch.from_numpy(frame)
    for axis in range(x.ndim):
        for w in frangi._delta_kernels(PARAMS[x.ndim], x.ndim)[axis]:
            want = filters.correlate1d_traced_plain(x, w, axis)
            want = want.half().float() if round_half else want
            got = kernel_model(x, filters.traced_taps(w), axis, round_half)
            assert_bitwise(got.numpy(), want.numpy())
        for sigma, order in LOG_TAPS:
            w = filters.gaussian_kernel1d(sigma, 4.0, order=order)
            taps = filters.nonzero_taps(w)
            got = kernel_model(x, taps, axis,
                               shared=filters.shared_products(x.shape[axis], taps,
                                                              axis == x.ndim - 1))
            assert_bitwise(got.numpy(), filters._correlate1d_plain(x, w, axis).numpy())


def test_kernel_model_reads_the_centre():
    """The LoG program's passes (``filters.log_program``): taps flagged at
    every position and a centre read from another tensor, in the kernel's
    loop, equal ``_correlate1d_plain`` with the same flags and centre."""
    x = torch.from_numpy(chip_smoke.filter_frame((6, 20, 24), seed=4))
    other = torch.from_numpy(chip_smoke.filter_frame((6, 20, 24), seed=5))
    for axis in range(3):
        for sigma, order in LOG_TAPS + [(1.0, 2)]:
            w = filters.gaussian_kernel1d(sigma, 4.0, order=order)
            taps = filters.nonzero_taps(w)
            flags = [o == 0 or k % 3 == 1 for k, (o, _) in enumerate(taps)]
            table = filters.shared_products(x.shape[axis], taps, axis == 2)
            table = np.broadcast_to(np.asarray(flags), (x.shape[axis], len(taps))) | (
                False if table is None else table)
            got = kernel_model(x, taps, axis, shared=table, centre=other)
            want = filters._correlate1d_plain(x, w, axis, flags, centre=other)
            assert_bitwise(got.numpy(), want.numpy())


def test_tap_lists():
    w = np.array([0.0, 0.25, 0.0, 0.5, 0.25], np.float64)
    assert filters.nonzero_taps(w) == [(-1, 0.25), (1, 0.5), (2, 0.25)]
    assert [o for o, _ in filters.traced_taps(w)] == [-2, -1, 0, 1, 2]
    assert filters.nonzero_taps(np.array([0.0])) == [(0, 0.0)]
    assert filters.nonzero_taps(np.zeros(3)) == []
    x = torch.arange(10.0).reshape(2, 5)
    assert torch.equal(filters._correlate1d(x, np.zeros(3), 1), torch.zeros_like(x))
    with pytest.raises(ValueError):
        filters.correlate1d_traced(x.to("meta"), w, 1)
