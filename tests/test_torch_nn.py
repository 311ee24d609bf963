"""Nearest-neighbour argmin of the PyTorch port against the JAX package.

The JAX side is ``pallas_nn.nearest_neighbors`` and ``nn_argmin_xla``, the
paths through which the JAX package's own tests reach its Pallas kernel on
the CPU.  The port side is ``nn_argmin_plain`` (what the port's wrapper runs
for CPU tensors) and its ``nearest_neighbors`` host loop.

Tie rule: indices must be equal, except where the two candidates' float64
squared distances differ by at most 1e-6 * (|q|^2 + |r|^2) — float32
cancellation in (|q|^2 + |r|^2) - 2 q.r is of that order.  Distances agree
to 1e-5 relative.
"""
import numpy as np
import pytest
import torch

from nellie_tpu.kernels import pallas_nn
from nellie_tpu_torch.kernels import nn

TIE_REL = 1e-6


def _assert_same_nn(q, r, idx_a, idx_b):
    q = np.asarray(q, np.float64)
    r = np.asarray(r, np.float64)
    idx_a = np.asarray(idx_a, np.int64)
    idx_b = np.asarray(idx_b, np.int64)
    differ = idx_a != idx_b
    if not differ.any():
        return
    da = ((q - r[idx_a]) ** 2).sum(1)
    db = ((q - r[idx_b]) ** 2).sum(1)
    scale = (q * q).sum(1) + np.maximum((r[idx_a] ** 2).sum(1), (r[idx_b] ** 2).sum(1))
    unexcused = differ & (np.abs(da - db) > TIE_REL * scale)
    assert not unexcused.any(), f"{int(unexcused.sum())} index mismatches beyond a near-tie"


def _pad8(a):
    out = np.zeros((a.shape[0], 8), np.float32)
    out[:, :a.shape[1]] = a
    return out


def _xla_padded(q, r):
    """``nn_argmin_xla`` on inputs padded as the JAX host loop pads them (queries
    to 512 rows with zeros, references to 2048 rows at _FAR)."""
    q_pad = pallas_nn._pad_rows(_pad8(q), 512, 0.0)
    r_pad = pallas_nn._pad_rows(_pad8(r), 2048, pallas_nn._FAR)
    d2, idx = pallas_nn.nn_argmin_xla(q_pad, r_pad)
    return np.asarray(d2)[:q.shape[0]], np.asarray(idx)[:q.shape[0]]


@pytest.mark.parametrize("qn,mn", [(1, 1), (37, 5), (300, 700), (513, 2049), (1000, 3)])
def test_plain_matches_xla_on_ragged_shapes(qn, mn):
    rng = np.random.default_rng(qn * 7919 + mn)
    q = (rng.random((qn, 3)) * 50).astype(np.float32)
    r = (rng.random((mn, 3)) * 50).astype(np.float32)
    d2_j, idx_j = _xla_padded(q, r)
    d2_p, idx_p = nn.nn_argmin_plain(torch.from_numpy(q), torch.from_numpy(r))
    assert d2_p.dtype == torch.float32 and idx_p.dtype == torch.int32
    _assert_same_nn(q, r, idx_j, idx_p.numpy())
    np.testing.assert_allclose(np.sqrt(np.maximum(d2_p.numpy(), 0)),
                               np.sqrt(np.maximum(d2_j, 0)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("qn,mn,m_chunk", [(300, 700, 1 << 18), (100, 5000, 1024),
                                           (64, (1 << 18) + 100, 1 << 18)])
def test_nearest_neighbors_matches_jax(qn, mn, m_chunk):
    rng = np.random.default_rng(mn)
    q = (rng.random((qn, 3)) * 20).astype(np.float32)
    r = (rng.random((mn, 3)) * 20).astype(np.float32)
    d_j, i_j = pallas_nn.nearest_neighbors(q, r, m_chunk=m_chunk)
    d_p, i_p = nn.nearest_neighbors(q, r, m_chunk=m_chunk, device="cpu")
    assert i_p.dtype == np.int64 and d_p.shape == (qn,)
    _assert_same_nn(q, r, i_j, i_p)
    np.testing.assert_allclose(d_p, d_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("qn,mn", [(0, 5), (5, 0), (0, 0)])
def test_empty_inputs(qn, mn):
    q = np.zeros((qn, 3), np.float32)
    r = np.zeros((mn, 3), np.float32)
    d_j, i_j = pallas_nn.nearest_neighbors(q, r)
    d_p, i_p = nn.nearest_neighbors(q, r, device="cpu")
    assert d_p.shape == d_j.shape == (0,) and i_p.shape == i_j.shape == (0,)
    d2, idx = nn.nn_argmin(torch.from_numpy(q), torch.from_numpy(r))
    assert d2.shape == (qn,) and idx.shape == (qn,)


def test_far_pad_rows_never_win():
    """The JAX kernel's pad rows (refs at _FAR, queries at _FAR/2) give the
    same answers on the real rows as the port's unpadded inputs."""
    rng = np.random.default_rng(3)
    q = (rng.random((200, 3)) * 30).astype(np.float32)
    r = (rng.random((450, 3)) * 30).astype(np.float32)
    q_pad = np.full((512, 8), pallas_nn._FAR / 2, np.float32)
    q_pad[:200] = _pad8(q)
    r_pad = np.full((2048, 8), pallas_nn._FAR, np.float32)
    r_pad[:450] = _pad8(r)
    _, idx_j = (np.asarray(a) for a in pallas_nn.nn_argmin_xla(q_pad, r_pad))
    assert (idx_j[:200] < 450).all()
    _, idx_p = nn.nn_argmin(torch.from_numpy(q), torch.from_numpy(r))
    _assert_same_nn(q, r, idx_j[:200], idx_p.numpy())


def test_exact_ties_on_grid_go_to_lowest_index():
    g = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"), -1).reshape(-1, 3)
    r = (g * np.array([0.5, 0.25, 0.25])).astype(np.float32)
    rng = np.random.default_rng(0)
    q = (rng.integers(0, 11, (500, 3)) / 2.0 * np.array([0.5, 0.25, 0.25])).astype(np.float32)
    d64 = ((q[:, None, :].astype(np.float64) - r[None]) ** 2).sum(-1)
    first = np.argmin(d64, axis=1)
    n_ties = int(((d64 == d64.min(1, keepdims=True)).sum(1) > 1).sum())
    assert n_ties > 100
    _, idx_p = nn.nn_argmin(torch.from_numpy(q), torch.from_numpy(r))
    _, idx_j = pallas_nn.nearest_neighbors(q, r)
    np.testing.assert_array_equal(idx_p.numpy(), first)
    np.testing.assert_array_equal(idx_j, first)


def test_cpu_tensor_never_builds_the_kernel():
    before = nn.NN_KERNEL.launches
    nn.nn_argmin(torch.rand(10, 3), torch.rand(20, 3))
    assert nn.NN_KERNEL.launches == before
    assert nn.NN_KERNEL._lib is None
