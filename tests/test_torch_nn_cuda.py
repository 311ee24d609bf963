"""The hand-written CUDA nearest-neighbour kernel against its plain version.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_nn_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)  Tie rule of
the random cases as in ``chip_smoke.py``: an index may differ only where
the two candidates' float64 squared distances differ by at most
1e-6 * (|q|^2 + |r|^2).  The bitwise cases hold the kernel's d2 to
``nn_argmin_plain`` on CPU copies of the inputs bit for bit, with equal
indices: that is the output contract the port's parity rests on.
"""
import numpy as np
import pytest
import torch

from nellie_tpu_torch.kernels import nn

TIE_REL = 1e-6
# the two callers' shapes on the smoke run's main path (Q, M)
HIERARCHY_SHAPE = (1573, 31247)
REASSIGN_SHAPE = (47353, 51389)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _unexcused(q, r, idx_a, idx_b):
    q64, r64 = q.double(), r.double()
    ia, ib = idx_a.long(), idx_b.long()
    da = ((q64 - r64[ia]) ** 2).sum(1)
    db = ((q64 - r64[ib]) ** 2).sum(1)
    scale = (q64 ** 2).sum(1) + torch.maximum((r64[ia] ** 2).sum(1), (r64[ib] ** 2).sum(1))
    return int(((ia != ib) & ((da - db).abs() > TIE_REL * scale)).sum())


def _voxels(n_q, n_r, seed, d=3):
    """Voxel-grid references and jittered queries in microns, as the
    reassigner and the Hierarchy give them."""
    rng = np.random.default_rng(seed)
    scale = np.array([0.5, 0.2, 0.2, 0.3, 0.4, 0.25, 0.1, 0.6][:d])
    extent = np.array([64, 256, 256, 32, 16, 16, 8, 8][:d])
    r = (np.floor(rng.random((n_r, d)) * extent) * scale).astype(np.float32)
    q = ((rng.random((n_q, d)) * extent + rng.normal(0, 1, (n_q, d))) * scale).astype(np.float32)
    return q, r


def _assert_bitwise(q_np, r_np, dev):
    """Kernel on the card vs the plain version on CPU copies: d2 bit for
    bit, indices equal."""
    q, r = torch.from_numpy(q_np), torch.from_numpy(r_np)
    before = nn.NN_KERNEL.launches
    d2_k, idx_k = nn.nn_argmin(q.to(dev), r.to(dev))
    torch.cuda.synchronize()
    assert nn.NN_KERNEL.launches == before + 1
    d2_p, idx_p = nn.nn_argmin_plain(q, r)
    assert torch.equal(d2_k.cpu().view(torch.int32), d2_p.view(torch.int32))
    assert torch.equal(idx_k.cpu(), idx_p)
    return d2_p, idx_p


@pytest.mark.gpu
@pytest.mark.parametrize("qn,mn,d", [(1, 1, 3), (37, 5, 3), (513, 2049, 3), (1000, 3001, 2),
                                     (700, 900, 8), (20000, 20000, 3)])
def test_kernel_matches_plain(cuda, qn, mn, d):
    gen = torch.Generator(device=cuda).manual_seed(qn + mn + d)
    q = torch.rand(qn, d, generator=gen, device=cuda) * 40
    r = torch.rand(mn, d, generator=gen, device=cuda) * 40
    before = nn.NN_KERNEL.launches
    d2_k, idx_k = nn.nn_argmin(q, r)
    torch.cuda.synchronize()
    assert nn.NN_KERNEL.launches == before + 1
    d2_p, idx_p = nn.nn_argmin_plain(q, r)
    assert _unexcused(q, r, idx_k, idx_p) == 0
    scale = (q.double() ** 2).sum(1) + (r.double()[idx_p.long()] ** 2).sum(1)
    assert bool(((d2_k.double() - d2_p.double()).abs() <= TIE_REL * scale).all())


@pytest.mark.gpu
@pytest.mark.parametrize("qn,mn", [(20000, 20000), HIERARCHY_SHAPE, REASSIGN_SHAPE])
def test_kernel_bitwise_equals_plain_on_cpu(cuda, qn, mn):
    _assert_bitwise(*_voxels(qn, mn, seed=qn), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("d", range(1, 9))
def test_kernel_bitwise_every_width(cuda, d):
    _assert_bitwise(*_voxels(3000, 7001, seed=d, d=d), cuda)


@pytest.mark.gpu
def test_kernel_one_query_many_references(cuda):
    _assert_bitwise(*_voxels(1, 1_000_000, seed=1), cuda)


@pytest.mark.gpu
def test_duplicates_in_other_splits_give_lowest_index(cuda):
    """Each reference appears three times, a third of the set apart, so the
    copies lie in different splits; the first copy must win."""
    q, base = _voxels(5000, 20000, seed=7)
    r = np.concatenate([base, base, base])
    assert nn.launch_plan(len(q), len(r)).split_len < len(base)
    _, idx = _assert_bitwise(q, r, cuda)
    assert int(idx.max()) < len(base)


@pytest.mark.gpu
def test_cancellation_to_nonpositive_d2(cuda):
    """Queries equal to references far from the origin: (|q|^2 + |r|^2) and
    2 q.r cancel, and the rounded d2 comes out zero or negative."""
    rng = np.random.default_rng(11)
    r = (rng.random((30000, 3)) * 2000 + 3000).astype(np.float32)
    q = np.concatenate([r[rng.choice(len(r), 4000, replace=False)],
                        (rng.random((1000, 3)) * 2000 + 3000).astype(np.float32)])
    d2, _ = _assert_bitwise(q, r, cuda)
    assert int((d2[:4000] < 0).sum()) > 0 and int((d2[:4000] == 0).sum()) > 0


@pytest.mark.gpu
def test_kernel_exact_ties_go_to_lowest_index(cuda):
    g = torch.stack(torch.meshgrid(*[torch.arange(12, device=cuda)] * 3, indexing="ij"), -1)
    r = g.reshape(-1, 3).float()
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randint(0, 22, (4000, 3), generator=gen, device=cuda).float() / 2.0
    _, idx = nn.nn_argmin(q, r)
    d64 = ((q.double()[:, None, :] - r.double()[None]) ** 2).sum(-1)
    assert torch.equal(idx.long(), torch.argmin(d64, dim=1))


@pytest.mark.gpu
def test_kernel_rejects_bad_inputs(cuda):
    with pytest.raises(TypeError):
        nn.nn_argmin(torch.zeros(4, 3, dtype=torch.float64, device=cuda),
                     torch.zeros(4, 3, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        nn.nn_argmin(torch.zeros(4, 9, device=cuda), torch.zeros(4, 9, device=cuda))


@pytest.mark.gpu
def test_library_constants_match_the_plan(cuda):
    info = nn.NN_KERNEL.info(3)
    assert (info["qpt"], info["r_tile"], info["max_threads"]) == (nn.QPT, nn.R_TILE,
                                                                   nn.MAX_THREADS)
    assert info["resident_warps"] >= 4 and info["local_bytes"] == 0
