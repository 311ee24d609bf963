"""The port's fused multiply-add (``kernels/_fp.py::fma``) rounds once, as
XLA's contracted ``a*b + c`` does.

On CPU tensors ``fma`` runs ``fma_plain``: the product exact in float64,
the sum rounded to odd, then once to float32.  It is held to
``chip_smoke.fma_exact`` (round-to-odd in numpy), to exact rational
rounding (``fractions.Fraction``) and to ``jax.jit(lambda a, b, c: a * b +
c)`` on the CPU, on ``chip_smoke.fma_operands`` (phase 17's operands: mixed
signs and scales, cancellations, subnormal results, infinities, NaN and
products on a float32 midpoint nudged off it).  XLA's CPU code flushes
subnormal inputs and results to zero, where the port (and the card's
``fmaf``) keeps them, so the comparison with JAX leaves out operands and
results below the smallest normal float32.

On a CUDA tensor ``fma`` launches ``kernels/csrc/fma_f32.cu``; it cannot
run here, so the dispatch is checked with a stand-in, and
``tests/test_torch_fp_fma_cuda.py`` holds the kernel to ``fma_plain`` on
the card.
"""
import os
import re
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels import _cuda, _fp
from torch_port_data import one_torch_thread  # noqa: F401 — autouse

TINY = np.float32(np.finfo(np.float32).tiny)
MAX = np.finfo(np.float32).max


@pytest.fixture(scope="module")
def operands():
    return chip_smoke.fma_operands(50_000, seed=1)


@pytest.fixture(scope="module")
def port(operands):
    return _fp.fma(*(torch.from_numpy(x) for x in operands)).numpy()


def _exact(a, b, c):
    return Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))


def _round_exact(value):
    """The float32 nearest a finite nonzero rational, ties to even."""
    nearest = np.float32(float(value))
    candidates = [nearest, np.nextafter(nearest, np.float32(np.inf)),
                  np.nextafter(nearest, np.float32(-np.inf))]
    return min(candidates, key=lambda v: (abs(Fraction(float(v)) - value),
                                          int(np.float32(v).view(np.int32)) & 1))


def test_the_double_rounding_case_rounds_as_jitted_jax():
    """a = b = 1 + 2**-12, c = 2**-60: a*b = 1 + 2**-11 + 2**-24 lies on a
    float32 midpoint and c lifts it just above.  In float64 the sum rounds
    back onto the midpoint, which float32 rounds to even (0x1.002p+0);
    rounded once it is 0x1.002002p+0, as XLA's contracted code gives."""
    a = np.float32(1 + 2 ** -12)
    c = np.float32(2 ** -60)
    got = _fp.fma(torch.tensor(a), torch.tensor(a), torch.tensor(c))
    assert float(got).hex() == "0x1.0020020000000p+0"
    assert float(jax.jit(lambda x, y, z: x * y + z)(a, a, c)).hex() == float(got).hex()
    summed = jax.jit(lambda x, y, z: jnp.sum(x * y + z))(np.full(1, a), np.full(1, a),
                                                          np.full(1, c))
    assert float(summed) == float(got) != float(chip_smoke.fma_rounded_twice(a, a, c))


def test_the_flow_interpolation_case_rounds_once():
    """a*b + c = 1 + 2**-23 + 2**-24 - 2**-60, just under a float32
    midpoint: rounded once it is 1 + 2**-23, rounded twice 1 + 2**-22."""
    hard = (np.float32(2 ** -24 * (1 + 2 ** -18)), np.float32(1 - 2 ** -18),
            np.float32(1 + 2 ** -23))
    got = _fp.fma(*(torch.tensor(x) for x in hard))
    assert float(got) == 1 + 2 ** -23
    assert chip_smoke.fma_rounded_twice(*hard) == np.float32(1 + 2 ** -22)


def test_equals_round_to_odd_in_numpy(operands, port):
    assert port.dtype == np.float32 and port.shape == operands[0].shape
    assert chip_smoke.same_bits(port, chip_smoke.fma_exact(*operands)).all()


def test_equals_exact_rational_rounding(operands, port):
    """Every finite result below float32's largest value, on a seeded sample
    and on every operand that rounding twice gets wrong, equals the
    correctly rounded exact value; an exact zero is +0 unless both the
    product and c are -0."""
    a, b, c = operands
    twice = chip_smoke.fma_rounded_twice(a, b, c)
    rng = np.random.default_rng(2)
    wrong = np.flatnonzero(~chip_smoke.same_bits(twice, port) & np.isfinite(twice))
    assert len(wrong) > 100
    picks = np.concatenate([rng.choice(len(a), 3000, replace=False), wrong[:1000]])
    checked = 0
    for i in picks:
        if not np.isfinite([a[i], b[i], c[i]]).all():
            continue
        value = _exact(a[i], b[i], c[i])
        if abs(value) > Fraction(float(MAX)):
            assert np.isinf(port[i])
        elif value == 0:
            negative = np.signbit(a[i]) != np.signbit(b[i]) and np.signbit(c[i])
            assert port[i] == 0 and np.signbit(port[i]) == negative, (a[i], b[i], c[i])
        else:
            assert port[i] == _round_exact(value), (a[i], b[i], c[i])
            checked += 1
    assert checked > 3000


def test_equals_jitted_jax_at_normal_values(operands, port):
    """Bit for bit with XLA's contracted multiply-add wherever no operand,
    product or result lies below the smallest normal float32 (XLA's CPU
    code flushes those to zero); NaN where it is NaN."""
    a, b, c = operands
    want = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    with np.errstate(all="ignore"):
        product = a.astype(np.float64) * b.astype(np.float64)
        exact = product + c.astype(np.float64)

    def normal(x):
        x = np.abs(x)
        return (x == 0) | (x >= TINY) | np.isnan(x)

    keep = normal(a) & normal(b) & normal(c) & normal(product) & normal(exact) & normal(port)
    assert keep.sum() > 0.7 * len(a)
    assert chip_smoke.same_bits(port[keep], want[keep]).all()


@pytest.mark.parametrize("a,b,c,want", [
    (np.inf, 0.0, 1.0, np.nan), (np.inf, 2.0, -np.inf, np.nan), (np.nan, 1.0, 1.0, np.nan),
    (np.inf, -2.0, 1.0, -np.inf), (3e38, 3e38, -np.inf, -np.inf), (3e38, 3e38, 0.0, np.inf),
    (-0.0, 1.0, -0.0, -0.0), (0.0, -1.0, 0.0, 0.0), (1.5, 2.0, -3.0, 0.0),
    (2 ** -75, 2 ** -75, 0.0, 2 ** -150 * 0), (2 ** -75, 2 ** -74, 0.0, 2 ** -149),
    (2 ** -149, 0.5, 2 ** -149, 2 ** -148)])
def test_special_values(a, b, c, want):
    got = float(_fp.fma(torch.tensor(np.float32(a)), torch.tensor(np.float32(b)),
                        torch.tensor(np.float32(c))))
    want = np.float32(want)
    assert chip_smoke.same_bits(np.float32(got), want), (a, b, c, got)
    assert float(chip_smoke.fma_exact(a, b, c)) == got or np.isnan(got)


def test_views_numbers_and_broadcasting(operands):
    """Narrowed views along every axis, Python numbers (rounded to float32
    as XLA rounds a weak-typed constant), 0-dim and float16 tensors, and
    broadcasting give the values of the same operands made whole."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((5, 6, 7)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((6, 1)).astype(np.float32))
    for axis in range(3):
        a, c = x.narrow(axis, 1, 3), x.narrow(axis, 0, 3)
        want = chip_smoke.fma_exact(a.numpy(), 0.1, c.numpy())
        assert chip_smoke.same_bits(_fp.fma(a, 0.1, c).numpy(), want).all()
        assert chip_smoke.same_bits(_fp.fma(0.1, a, c).numpy(), want).all()
    got = _fp.fma(x, y, torch.tensor(np.float32(0.3)))
    assert got.shape == (5, 6, 7) and got.dtype == torch.float32
    assert chip_smoke.same_bits(got.numpy(), chip_smoke.fma_exact(x.numpy(), y.numpy(),
                                                                  0.3)).all()
    half = x.half()
    assert chip_smoke.same_bits(_fp.fma(half, half, 1.0).numpy(),
                                chip_smoke.fma_exact(half.float().numpy(),
                                                     half.float().numpy(), 1.0)).all()
    assert float(_fp.fma(2.0, 3.0, 1.0)) == 7.0


def test_sum_of_products_goes_through_the_repaired_fma(operands):
    a, b, c = (torch.from_numpy(x[:1000]) for x in operands)
    got = _fp.sum_of_products([(a, b), (c, c)]).numpy()
    want = chip_smoke.fma_exact(a.numpy(), b.numpy(), c.numpy() * c.numpy())
    assert chip_smoke.same_bits(got, want).all()


@pytest.mark.parametrize("shape,strides,sizes,merged", [
    ((4, 5, 6), [(30, 6, 1), (30, 6, 1)], [120], [[1], [1]]),
    ((4, 5, 6), [(35, 7, 1), (30, 6, 1)], [20, 6], [[7, 1], [6, 1]]),
    ((4, 5, 6), [(0, 0, 0), (30, 6, 1)], [120], [[0], [1]]),
    ((4, 1, 6), [(6, 6, 1), (0, 0, 1)], [4, 6], [[6, 1], [0, 1]]),
    ((1, 1), [(1, 1), (1, 1)], [1], [[0], [0]])])
def test_merge_axes(shape, strides, sizes, merged):
    """The kernel's layout: size-1 axes dropped, an axis merged into the one
    before where every operand steps across both as across one."""
    assert _fp._merge_axes(shape, strides) == (sizes, merged)


# ---------------------------------------------------------------------------
# dispatch and build
# ---------------------------------------------------------------------------

class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to follow the dispatch."""

    @property
    def device(self):
        return torch.device("cuda")


def test_cpu_tensors_take_the_plain_version():
    before = _fp.FMA_KERNEL.launches
    x = torch.ones(4)
    assert torch.equal(_fp.fma(x, 2.0, x), _fp.fma_plain(x, 2.0, x))
    assert _fp.FMA_KERNEL.launches == before and _fp.FMA_KERNEL._lib is None


def test_cuda_tensor_launches_the_kernel(monkeypatch):
    """An operand on a CUDA device goes to the kernel object, never to the
    plain version; any other device raises."""
    seen = []
    monkeypatch.setattr(_fp, "FMA_KERNEL", lambda a, b, c: seen.append((a, b, c)) or "kernel")
    monkeypatch.setattr(_fp, "fma_plain", None)
    cuda = torch.zeros(3).as_subclass(_OnCuda)
    assert _fp.fma(cuda, 2.0, 1.0) == "kernel" and _fp.fma(1.0, 2.0, cuda) == "kernel"
    assert len(seen) == 2
    with pytest.raises(ValueError, match="unsupported devices"):
        _fp.fma(torch.zeros(3, device="meta"), 1.0, 1.0)


def test_cuda_entry_point_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        resolve_device("cuda")


def test_kernel_rejects_operands_it_cannot_take():
    kernel = _fp._FmaKernel()
    cuda = torch.zeros(3).as_subclass(_OnCuda)
    with pytest.raises(TypeError, match="floating-point"):
        kernel(cuda, torch.zeros(3, dtype=torch.int32).as_subclass(_OnCuda), 1.0)
    with pytest.raises(ValueError, match="operands on"):
        kernel(cuda, torch.zeros(3), 1.0)


def test_build_command_targets_sm90a_from_the_repo():
    kernel = _fp._FmaKernel()
    args = kernel.compile_args("out.so")
    assert "arch=compute_90a,code=sm_90a" in args
    assert not any(re.search(r"fast.?math|ftz=true|use_fast_math", a) for a in args)
    src = kernel.source_path
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.exists(src) and os.path.commonpath([src, root]) == root
    assert src in args and os.path.dirname(kernel.library_path()) == _cuda.BUILD_DIR
    with open(src) as f:
        text = f.read()
    assert set(re.findall(r"#include\s*[<\"]([^>\"]+)", text)) <= {"cuda_runtime.h", "stdint.h"}
    assert "__fmaf_rn" in text
