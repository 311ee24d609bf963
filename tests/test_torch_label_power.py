"""Label's threshold power ``10 ** t`` against the JAX package's, bit for
bit on the CPU.

The reference computes ``jnp.minimum(10.0 ** tri, 10.0 ** ots)`` of its
log10-domain triangle and Otsu thresholds inside its jitted program, where
XLA's CPU code calls glibc's ``powf``.  The port computes both powers with
``_fp.pow`` (glibc's ``powf`` in float64 torch) on a 0-dim exponent as the
stage does and on whole tensors; ``torch.pow`` is not ``powf`` on whole CPU
tensors (and on the card it is CUDA's ``powf``:
``tests/test_torch_label_power_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_data as D  # noqa: F401 — puts the repo on the path
from torch_port_data import one_torch_thread  # noqa: F401 — autouse
from nellie_tpu.stages import labelling as j_labelling
from nellie_tpu_torch.kernels import _fp
from nellie_tpu_torch.stages import labelling

N = 120_000


def exponents(n=N, seed=0):
    """n float32 exponents in [-6, 6], with the integers and 0 among them."""
    t = np.random.default_rng(seed).uniform(-6.0, 6.0, n).astype(np.float32)
    t[:13] = np.arange(-6, 7)
    return t


def reference_power(t):
    return np.asarray(jax.jit(lambda x: 10.0 ** x)(t))


def assert_same_bits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    differ = got.view(np.int32) != want.view(np.int32)
    assert int(differ.sum()) == 0, f"{int(differ.sum())} of {got.size} differ"


def test_power_of_ten_bitwise_on_a_tensor():
    t = exponents()
    got = _fp.pow(torch.tensor(10.0), torch.from_numpy(t))
    assert_same_bits(got.numpy(), reference_power(t))
    assert not np.array_equal(torch.pow(torch.tensor(10.0), torch.from_numpy(t)).numpy(),
                              reference_power(t))


def test_power_of_ten_bitwise_on_0dim_exponents():
    """As the stage calls it: a 0-dim exponent, jitted JAX on a scalar."""
    t = exponents(2_000, seed=1)
    power = jax.jit(lambda x: 10.0 ** x)
    got = [float(_fp.pow(torch.tensor(10.0), torch.tensor(v))) for v in t]
    want = [np.asarray(power(np.float32(v))) for v in t]
    assert_same_bits(np.array(got, np.float32), np.array(want, np.float32))


def test_number_and_tensor_exponents_agree():
    """The tensor exponent takes the same path as a number (the tracker's
    Hu normalisation passes numbers)."""
    x = torch.from_numpy(np.random.default_rng(2).uniform(0.0, 1e4, 5_000).astype(np.float32))
    for y in (0.5, 1.0, 1.5, 2.0, 2.5, -1.0, 3.0):
        assert_same_bits(_fp.pow(x, torch.tensor(y)).numpy(), _fp.pow(x, y).numpy())
        assert_same_bits(_fp.pow(-x, torch.tensor(y)).numpy(), _fp.pow(-x, y).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frangi_threshold_bitwise(seed):
    """The stage's threshold kernel on a vesselness-like sample."""
    rng = np.random.default_rng(seed)
    flat = np.where(rng.random(40_000) < 0.3, rng.lognormal(-4.0, 1.5, 40_000), 0.0)
    flat = flat.astype(np.float32)
    want, ok = j_labelling._frangi_threshold_kernel(jnp.asarray(flat), None, 0.0, 256, 1)
    got, got_ok = labelling._frangi_threshold_kernel(torch.from_numpy(flat), None, 0.0, 256, 1)
    assert bool(ok) == got_ok
    assert_same_bits(got.numpy(), np.asarray(want))
