"""The hand-written CUDA multiply-add chain against its plain version.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_fma_chain_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)  A chain on
float32 CUDA tensors is one launch of ``kernels/csrc/fma_f32.cu``'s
``fma_chain`` and equals ``_fp.run_steps`` (``fma_plain`` and float32
products and sums) on the card and on CPU copies bit for bit, NaN where NaN:
the log and exp polynomials, ``sum_of_products``, ``reduce_sum_of_squares``
and ``contract`` on ``chip_smoke.fma_operands`` and special values, views at
offsets that break the 16-byte alignment, broadcast and transposed sources,
numbers and 0-dim tensors, and every length up to 16 steps.  The single
``fma_f32`` call's contiguous path (float4) is held at lengths off a
multiple of four, at misaligned views and with 0-dim operands read once.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import _fp
from nellie_tpu_torch.kernels._fp import ADD, FMA, MUL, R0, R1, R2, R3

SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -3e-39, 1.17e-38, 3e38, -1.0,
                    0.5, 2.0, 7.25, 1e-30], np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    assert chip_smoke.same_bits(got.cpu().numpy(), want.cpu().numpy()).all()


def _cpu(steps):
    return [(d, op, *(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
            for d, op, *args in steps]


def _check(steps, launches=1):
    before = _fp.FMA_CHAIN_KERNEL.launches
    single = _fp.FMA_KERNEL.launches
    got = _fp.chain(steps)
    torch.cuda.synchronize()
    assert _fp.FMA_CHAIN_KERNEL.launches == before + launches
    assert _fp.FMA_KERNEL.launches == single and got.device.type == "cuda"
    _same(got, _fp.run_steps(steps))
    _same(got, _fp.run_steps(_cpu(steps)))
    return got


def _operands(cuda, n=1 << 20, seed=0):
    return [torch.from_numpy(x).to(cuda) for x in chip_smoke.fma_operands(n, seed=seed)]


def _special(cuda):
    g = np.stack(np.meshgrid(SPECIAL, SPECIAL, SPECIAL, indexing="ij")).reshape(3, -1)
    return [torch.from_numpy(np.ascontiguousarray(x)).to(cuda) for x in g]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["operands", "special"])
def test_polynomials(cuda, kind):
    a, b, c = _operands(cuda) if kind == "operands" else _special(cuda)
    e = torch.round(torch.nan_to_num(b, nan=3.0, posinf=60.0, neginf=-60.0).clamp(-60, 60))
    _check(_fp._log_polynomial(a, e))
    _check(_fp._exp_polynomial(a, e))


@pytest.mark.gpu
def test_log_and_exp_whole(cuda):
    """``_fp.log`` is one chain launch, ``_fp.exp`` one chain and one
    ``fma_f32`` launch; both equal their CPU runs."""
    x = torch.cat(_operands(cuda, 1 << 18, seed=4) + [torch.from_numpy(SPECIAL).to(cuda)])
    for fn, chains, singles in ((_fp.log, 1, 0), (_fp.exp, 1, 1)):
        for arg in (x, x.clamp(-100, 100), x / 1e30):
            c0, s0 = _fp.FMA_CHAIN_KERNEL.launches, _fp.FMA_KERNEL.launches
            got = fn(arg)
            assert (_fp.FMA_CHAIN_KERNEL.launches - c0, _fp.FMA_KERNEL.launches - s0) == (
                chains, singles)
            _same(got, fn(arg.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("n_pairs", [2, 3, 5, 9])
def test_sum_of_products(cuda, n_pairs):
    a, b, c = _operands(cuda, seed=n_pairs)
    pairs = [((a, b, c)[i % 3] + i, (c, a, b)[i % 3] * 0.5) for i in range(n_pairs)]
    before = _fp.FMA_CHAIN_KERNEL.launches
    got = _fp.sum_of_products(pairs)
    # eight tensors a chain at most: every pair here brings two
    assert _fp.FMA_CHAIN_KERNEL.launches - before == {2: 1, 3: 1, 5: 2, 9: 3}[n_pairs]
    _same(got, _fp.sum_of_products([tuple(x.cpu() for x in p) for p in pairs]))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2, 3, 20])
def test_reduce_sum_of_squares(cuda, d):
    a, b, c = _operands(cuda, 1 << 16, seed=d)
    diff = torch.stack([(a, b, c)[k % 3] * (1.0 + k) for k in range(d)], dim=-1)
    diff = diff[:diff.shape[0] // 256 * 256]
    for x in (diff, diff[1:], diff.reshape(256, -1, d).transpose(0, 1)):
        _same(_fp.reduce_sum_of_squares(x), _fp.reduce_sum_of_squares(x.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [3, 4, 13, 70])
def test_contract(cuda, k):
    a, b, c = _operands(cuda, 1 << 16, seed=k)
    x = torch.stack([(a, b, c)[i % 3][i:i + 6000] for i in range(k)], -1).reshape(20, 300, k)
    w = torch.stack([(c, a, b)[i % 3][i * 7:i * 7 + 4] for i in range(k)], 0)
    for xx in (x, x.transpose(0, 1)):
        _same(_fp.contract(xx, w), _fp.contract(xx.cpu(), w.cpu()))


@pytest.mark.gpu
def test_views_broadcast_numbers(cuda):
    a, b, c = _operands(cuda, 1 << 18, seed=9)
    m = a[:240_000].reshape(400, 600)
    _check([(R0, FMA, m, b[:600], 0.25), (R1, MUL, m[:, :1], R0), (R1, ADD, R1, c[:600]),
            (R0, FMA, R1, R0, m)])
    # offsets of one element break the 16-byte alignment of every load
    _check([(R0, MUL, a[1:100_001], a[2:100_002]), (R0, FMA, a[3:100_003], b[5:100_005], R0)])
    _check([(R0, MUL, m[:, 0:50], m[:, 1:51]), (R0, FMA, m[:, 2:52], m[:, 3:53], R0),
            (R2, ADD, m.t()[:50].t(), R0), (R3, FMA, -1.5, R2, R0), (R0, ADD, R3, R3)])
    _check([(R0, FMA, a, torch.tensor(2.0), torch.tensor(0.5, device=cuda)),
            (R1, ADD, 1.0, R0)])
    for n in (1, 3, 5, 4097):
        _check([(R0, FMA, a[:n], b[:n], c[:n])])


@pytest.mark.gpu
@pytest.mark.parametrize("length", [1, 2, 7, 16])
def test_lengths(cuda, length):
    a, b, c = _operands(cuda, 1 << 16, seed=length)
    steps = [(R0, MUL, a, b)] + [(reg, FMA, (a, b, c)[i % 3], R0 if i % 2 else 3.0, c)
                                 for i, reg in zip(range(length - 1), [R0, R1] * 8)]
    steps = steps[:length]
    _check(steps)


@pytest.mark.gpu
def test_single_call_contiguous_path(cuda):
    a, b, c = _operands(cuda, 1 << 16, seed=11)
    for n in (1, 2, 5, 4099, a.numel()):
        two = torch.tensor(2.0, device=cuda)
        for args in ((a[:n], b[:n], c[:n]), (a[:n], 2.0, c[:n]), (0.5, b[:n], 1.0),
                     (a[1:n + 1], b[:n], c[3:n + 3]), (a[:n], two, c[:n]),
                     (two, b[:n], torch.tensor(-0.5, device=cuda)), (two, two, 1.0)):
            if args[0] is not None and any(isinstance(x, torch.Tensor) and x.numel() != n
                                           for x in args):
                continue
            before = _fp.FMA_KERNEL.launches
            got = _fp.fma(*args)
            assert _fp.FMA_KERNEL.launches == before + 1
            _same(got, _fp.fma_plain(*args))
