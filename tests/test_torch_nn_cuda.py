"""The hand-written CUDA nearest-neighbour kernel against its plain version.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_nn_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)  Tie rule as
in ``chip_smoke.py``: an index may differ only where the two candidates'
float64 squared distances differ by at most 1e-6 * (|q|^2 + |r|^2).
"""
import pytest
import torch

from nellie_tpu_torch.kernels import nn

TIE_REL = 1e-6


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
