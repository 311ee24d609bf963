"""The port's masked percentile against the JAX package.

``frangi.masked_percentile_plain`` (the CPU path of
``masked_percentile_forms``, and the body that ``csrc/masked_percentile.cu``
is held to on the card) takes the order statistics of the reference's sort
and its arithmetic in both single-rounding forms of the last step,
A = fma(s[lo], 1 - frac, s[hi] frac) and B = fma(s[hi], frac,
s[lo] (1 - frac)), bit for bit (NaN where NaN), on
``chip_smoke.PERCENTILE_CASES`` at q in {0, 1, 50, 100}: the callers'
positive sample, signed values, ties, one masked value, none, +inf among
the masked values, every value masked.  The reference's ``masked_percentile``
jitted alone takes B, bit for bit, and so does the port's
``masked_percentile`` by default (the Filter's opening takes each form in
its own fusions: ``tests/test_torch_finalize_contraction.py``).  And the Filter's
finalize, whose two predicates stay on the frame's device, equals the
reference's on a frame with signal, one with nothing positive and one of
zeros.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu.kernels import frangi as j_frangi
from nellie_tpu_torch.kernels import _fp, frangi
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


@pytest.fixture(scope="module")
def reference():
    return jax.jit(j_frangi.masked_percentile, static_argnums=2)


@pytest.fixture(scope="module")
def reference_sort():
    return jax.jit(lambda v, m: jnp.sort(jnp.where(m, v, jnp.inf)))


def contractions(sorted_values, n, q):
    """The two single-rounding forms of s[lo] (1 - frac) + s[hi] frac on
    the reference's sorted values: the port's, fma(s[lo], 1 - frac,
    s[hi] frac), and the other, fma(s[hi], frac, s[lo] (1 - frac))."""
    pos = np.float32(q / 100.0) * np.float32(max(n - 1, 0))
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    frac = np.float32(pos - np.float32(lo))
    one = np.float32(1.0) - frac
    s_lo, s_hi = (torch.tensor(np.float32(sorted_values[k])) for k in (lo, hi))
    f, o = torch.tensor(frac), torch.tensor(one)
    return (_fp.fma(s_lo, o, s_hi * f).numpy(), _fp.fma(s_hi, f, s_lo * o).numpy())


@pytest.mark.parametrize("name", chip_smoke.PERCENTILE_CASES)
def test_cases_against_reference(name, reference, reference_sort):
    """The order statistics are the reference sort's and the arithmetic its
    own in both contractions; the reference's function jitted alone is
    form B."""
    values, mask = chip_smoke.percentile_inputs(name, seed=len(name))
    s = np.asarray(reference_sort(jnp.asarray(values), jnp.asarray(mask)))
    n = int(mask.sum())
    for q in chip_smoke.PERCENTILE_QS:
        want = np.asarray(reference(jnp.asarray(values), jnp.asarray(mask), q))
        got = frangi.masked_percentile_plain(torch.from_numpy(values), torch.from_numpy(mask), q)
        assert got.dtype == torch.float32 and got.shape == (2,)
        form_a, form_b = contractions(s, n, q) if n else (np.float32(0.0), np.float32(0.0))
        assert chip_smoke.same_bits(got[0].numpy(), form_a), (name, q, got, float(form_a))
        assert chip_smoke.same_bits(got[1].numpy(), form_b), (name, q, got, float(form_b))
        assert chip_smoke.same_bits(want, form_b), (name, q, float(want), float(form_b))
        again = frangi.masked_percentile(torch.from_numpy(values), torch.from_numpy(mask), q)
        assert chip_smoke.same_bits(again.numpy(), got[1].numpy())
        forms = frangi.masked_percentile_forms(torch.from_numpy(values), torch.from_numpy(mask), q)
        assert chip_smoke.same_bits(forms.numpy(), got.numpy()).all()
    if name in ("positive sample", "ties", "one value", "empty", "+inf"):
        # the callers' samples: the reference's function bit for bit
        for q in chip_smoke.PERCENTILE_QS:
            want = np.asarray(reference(jnp.asarray(values), jnp.asarray(mask), q))
            got = frangi.masked_percentile_plain(torch.from_numpy(values), torch.from_numpy(mask),
                                                 q)
            assert chip_smoke.same_bits(got[1].numpy(), want), (name, q)
    if name == "empty":
        assert got.tolist() == [0.0, 0.0]


def test_strided_sample_of_a_frame(reference):
    """The Filter's call: a strided sample of a 3D frame and its positive
    mask."""
    frame = chip_smoke.make_frame((12, 48, 48)) - 110.0
    sample = torch.from_numpy(frame)[::2, ::3, ::2]
    want = np.asarray(reference(jnp.asarray(sample.numpy()), jnp.asarray(sample.numpy() > 0), 1.0))
    got = frangi.masked_percentile_plain(sample, sample > 0, 1.0)
    assert chip_smoke.same_bits(got[1].numpy(), want)


@pytest.mark.parametrize("kind", ["signal", "nothing positive", "zeros"])
def test_finalize_against_reference(kind):
    frame = chip_smoke.make_frame((8, 40, 40), seed=4) - 120.0
    if kind == "nothing positive":
        frame = -np.abs(frame)
    elif kind == "zeros":
        frame = np.zeros_like(frame)
    want = np.asarray(j_frangi.finalize_frame(jnp.asarray(frame), 5000))
    got = frangi.finalize_frame(torch.from_numpy(frame), 5000).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        frangi.mask_volume(torch.from_numpy(frame), 5000).numpy().view(np.int32),
        np.asarray(j_frangi.mask_volume(jnp.asarray(frame), 5000)).view(np.int32))
