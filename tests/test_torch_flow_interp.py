"""The port's flow interpolation against the JAX package, bit for bit, and
the interpolation kernel's order of operations on the CPU.

Inputs are ``chip_smoke.interp_inputs`` (the card check's phase 17
inputs) at M < 32, 32 < M <= 1024 and M > 1024 flow rows, d = 2 and 3,
with queries on an anchor (distance 0), with no anchor in the radius and
NaN.  The port's ``_interp_tile_body`` and ``_interp_all_kernel`` (on a
CPU tensor, the plain body) equal JAX's ``_interp_tile_body`` as the JAX
stages run it (flow rows padded to ``_bucket(M)``, under
``_interp_all_kernel``) in every bit (NaN where it is NaN).

The CUDA kernel (``kernels/csrc/flow_interp.cu``) cannot run here, so its
two paths are modelled in numpy: ``chip_smoke.interp_model`` (one pass
over every pair listing the rows in the radius; the weight sum over the
list, its level accumulators moved across the skipped windows; the dot
over the list in four lanes, a zero lane's sign from per-lane counts of
negative-signed vector components) and ``chip_smoke.interp_model_three_pass``
(a query whose list overflows: every row in order).  Both round each
fused multiply-add once, as the kernel and the plain body's ``_fp.fma``
do, and both equal the plain body bit for bit, with no allowance.  On the
card, ``tests/test_torch_flow_interp_cuda.py`` holds the kernel itself to
the plain body.
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
from nellie_tpu.stages import flow_interpolation as j_fi
from nellie_tpu_torch.kernels import _cuda, _fp
from nellie_tpu_torch.stages import flow_interpolation as fi
from torch_port_data import one_torch_thread  # noqa: F401 — autouse

N_Q = 96
CASES = [(n_m, d) for d in (2, 3) for n_m in (20, 700, 1500)]


@pytest.fixture(scope="module", params=CASES, ids=[f"M{m}-d{d}" for m, d in CASES])
def case(request):
    n_m, d = request.param
    inputs = chip_smoke.interp_inputs(N_Q, n_m, d, seed=n_m + d)
    plain = fi._interp_all_kernel(*[torch.from_numpy(a) for a in inputs[:4]], inputs[4])
    return inputs, plain.numpy()


def _jax_stages(query, anchors, vectors, costs, max_distance):
    """JAX's ``_interp_tile_body`` as its stages run it (``FlowInterpolator``,
    the reassigner): under ``_interp_all_kernel``'s ``lax.map`` over tiles of
    8192 queries, with the flow rows padded at the end to ``_bucket(M)``
    (a power of two, at least 64) and marked invalid."""
    n, d = query.shape
    m = anchors.shape[0]
    mb, nb = j_fi._bucket(m), j_fi._bucket(n, j_fi._INTERP_TILE)

    def pad(a, rows):
        out = np.zeros((rows,) + a.shape[1:], a.dtype)
        out[:len(a)] = a
        return jnp.asarray(out)

    res = j_fi._interp_all_kernel(pad(query, nb), pad(np.ones(n, bool), nb), pad(anchors, mb),
                                  pad(np.ones(m, bool), mb), pad(vectors, mb), pad(costs, mb),
                                  jnp.float32(max_distance))
    return np.asarray(res)[:n]


def test_plain_body_equals_jax_bit_for_bit(case):
    inputs, plain = case
    assert plain.dtype == np.float32 and plain.shape == inputs[0].shape
    assert chip_smoke.same_bits(plain, _jax_stages(*inputs)).all()


def test_inputs_cover_zero_distance_empty_radius_and_nan(case):
    (query, *_), plain = case
    k = N_Q // 8
    assert np.isfinite(plain[:k]).all()          # on an anchor
    assert np.isnan(plain[k:3 * k]).all()        # empty radius, then NaN queries
    assert np.isnan(query[2 * k:3 * k]).all()
    assert np.isfinite(plain[3 * k:]).any()


def test_tile_body_and_tile_loop_agree(case):
    inputs, plain = case
    tensors = [torch.from_numpy(a) for a in inputs[:4]]
    tile = fi._interp_tile_body(*tensors, inputs[4]).numpy()
    assert chip_smoke.same_bits(tile, plain).all()


def test_kernel_model_equals_plain_body(case):
    """The kernel's list path (sums and dot over the rows in the radius,
    skipped windows and zero lanes accounted for) equals the plain body."""
    inputs, plain = case
    model = chip_smoke.interp_model(*inputs)
    assert chip_smoke.same_bits(model, plain).all()


def test_kernel_model_with_exact_fma_differs_only_by_double_rounding(case):
    """The kernel's three-pass path (every row in order) with exact fused
    multiply-adds equals the plain body bit for bit: with ``_fp.fma``
    rounding once, no row differs by a double rounding any more."""
    inputs, plain = case
    exact = chip_smoke.interp_model_three_pass(*inputs)
    assert chip_smoke.same_bits(exact, plain).all()


def _plain(query, anchors, vectors, costs, max_distance):
    return fi._interp_all_kernel(*[torch.from_numpy(a) for a in (query, anchors, vectors,
                                                                 costs)], max_distance).numpy()


@pytest.mark.parametrize("d", [2, 3])
def test_overflowing_lists_take_the_three_pass_path(d):
    """A radius of 3 puts more than ``INTERP_LIST_LEN`` rows inside for
    most queries: the model takes the three-pass path for them and the list
    path for the rest, and equals the plain body."""
    q, f, v, c, _ = chip_smoke.interp_inputs(64, 1500, d, seed=d)
    overflow = chip_smoke.interp_overflows(q, f, 3.0)
    assert 16 < overflow < 64
    assert chip_smoke.same_bits(chip_smoke.interp_model(q, f, v, c, 3.0),
                                _plain(q, f, v, c, 3.0)).all()


@pytest.mark.parametrize("n_m", [4391, chip_smoke.INTERP_TILED_ROWS])
def test_tables_below_and_above_shared_memory(n_m):
    """M at the 2D main path's 4,391 rows (the table held in shared memory)
    and above what shared memory holds (streamed through tiles)."""
    q, f, v, c, r = chip_smoke.interp_inputs(24, n_m, 2, seed=n_m)
    assert chip_smoke.same_bits(chip_smoke.interp_model(q, f, v, c, r),
                                _plain(q, f, v, c, r)).all()


def test_list_sum_crosses_skipped_windows():
    """Rows in the radius 33, 1,100 and 30,000 rows apart (M = 40,000: three
    window levels): the list path moves its level accumulators across
    every window boundary between them, as the three-pass path adds +0
    row by row."""
    rng = np.random.default_rng(8)
    n_m = 40_000
    anchors = np.full((n_m, 2), 50.0, np.float32) + rng.random((n_m, 2)).astype(np.float32)
    listed = [3, 36, 40, 1140, 1141, 2300, 9000, 31000, 31033, 39999]
    anchors[listed] = (rng.random((len(listed), 2)) * 0.5).astype(np.float32)
    vectors = rng.integers(-2, 3, (n_m, 2)).astype(np.float32)
    costs = (rng.random(n_m) * 40 + 0.5).astype(np.float32)
    query = (rng.random((6, 2)) * 0.2).astype(np.float32)
    assert chip_smoke.interp_overflows(query, anchors, 1.0) == 0
    got = chip_smoke.interp_model(query, anchors, vectors, costs, 1.0)
    assert np.isfinite(got).all()
    assert chip_smoke.same_bits(got, _plain(query, anchors, vectors, costs, 1.0)).all()


def test_model_sums_weights_in_xla_tree_order():
    """M = 40,000 rows: three window levels.  The model's level
    accumulators give ``_fp.tree_sum``'s bits where a plain left-to-right
    sum does not."""
    rng = np.random.default_rng(7)
    n_m = 40_000
    anchors = np.zeros((n_m, 2), np.float32)
    costs = (rng.random(n_m) * 40 + 0.5).astype(np.float32)
    vectors = np.ones((n_m, 2), np.float32)
    query = np.zeros((1, 2), np.float32)  # distance 0 to every row: w = cost - min + 1
    assert fi.tree_levels(n_m) == 3
    w = (-costs - (-costs).min()).astype(np.float32) + np.float32(1)
    total = _fp.tree_sum(torch.from_numpy(w)[None]).numpy()[0]
    sequential = np.float32(0)
    for x in w:
        sequential = np.float32(sequential + x)
    assert total != sequential
    got = chip_smoke.interp_model(query, anchors, vectors, costs, 1.0)
    plain = fi._interp_all_kernel(torch.from_numpy(query), torch.from_numpy(anchors),
                                  torch.from_numpy(vectors), torch.from_numpy(costs), 1.0)
    assert chip_smoke.same_bits(got, plain.numpy()).all()


@pytest.mark.parametrize("n_m,negative_zero", [(8, True), (6, False)])
def test_zero_lane_keeps_its_sign(n_m, negative_zero):
    """Component 0 of every vector inside the radius is -0 and negative
    outside it: every lane's products are -0, so the result is -0, unless
    M is padded to a multiple of 4 with zero rows (+0 * +0 + -0 = +0).  The
    model, with either fused multiply-add, keeps the plain body's signs."""
    anchors = np.array([[0, 0], [0, 0.2], [5, 5], [6, 6], [0, 0.4], [7, 7], [8, 8], [9, 9]],
                       np.float32)[:n_m]
    vectors = np.array([[-0.0, 1], [-0.0, 1], [-2, 1], [-3, 1], [-0.0, 2], [-1, 1], [-4, 1],
                        [-5, 1]], np.float32)[:n_m]
    costs = np.ones(n_m, np.float32)
    query = np.array([[0, 0.1], [0, 0.3]], np.float32)
    plain = fi._interp_all_kernel(*[torch.from_numpy(a) for a in (query, anchors, vectors,
                                                                  costs)], 0.5).numpy()
    assert (plain[:, 0] == 0).all() and np.signbit(plain[:, 0]).all() == negative_zero
    for model in (chip_smoke.interp_model, chip_smoke.interp_model_three_pass):
        assert chip_smoke.same_bits(model(query, anchors, vectors, costs, 0.5), plain).all()


@pytest.mark.parametrize("outside,want", [(-1.0, "-0"), (2.0, "+0"), (-0.0, "-0"),
                                          (np.inf, "nan"), (np.nan, "nan")])
def test_a_lane_skipped_rows_decide(outside, want):
    """Every in-radius vector's component 0 is -0; the rows outside the
    radius are negative except one, whose component is ``outside``: a
    zero lane stays -0 only when every row it skipped is negative-signed,
    and is NaN where one of them is not finite (+0 * inf)."""
    anchors = np.array([[0, 0], [0, 0.2], [5, 5], [6, 6], [0, 0.4], [7, 7], [8, 8], [9, 9]],
                       np.float32)
    vectors = np.array([[-0.0, 1], [-0.0, 1], [-2, 1], [-3, 1], [-0.0, 2], [-1, 1], [-4, 1],
                        [-5, 1]], np.float32)
    vectors[6, 0] = outside
    costs = np.ones(8, np.float32)
    query = np.array([[0, 0.1], [0, 0.3]], np.float32)
    plain = _plain(query, anchors, vectors, costs, 0.5)
    first = plain[:, 0]
    if want == "nan":
        assert np.isnan(first).all()
    else:
        assert (first == 0).all() and np.signbit(first).all() == (want == "-0")
    for model in (chip_smoke.interp_model, chip_smoke.interp_model_three_pass):
        assert chip_smoke.same_bits(model(query, anchors, vectors, costs, 0.5), plain).all()


def test_exact_fma_rounds_once():
    """Where float64-then-float32 rounds twice, ``fma_exact`` gives the
    correctly rounded value (checked with exact rational arithmetic)."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal(200_000).astype(np.float32)
    b = rng.standard_normal(200_000).astype(np.float32)
    c = (rng.standard_normal(200_000) * 1e-3).astype(np.float32)
    exact = chip_smoke.fma_exact(a, b, c)
    twice = chip_smoke.fma_rounded_twice(a, b, c)
    # a case built to double-round: a*b + c = 1 + 2**-23 + 2**-24 - 2**-60, just
    # under a float32 midpoint; float64 rounds it onto the midpoint, which
    # float32 then rounds up, away from the correctly rounded 1 + 2**-23
    hard = (np.float32(2 ** -24 * (1 + 2 ** -18)), np.float32(1 - 2 ** -18),
            np.float32(1 + 2 ** -23))
    assert chip_smoke.fma_rounded_twice(*hard) == np.float32(1 + 2 ** -22)
    assert chip_smoke.fma_exact(*hard) == np.float32(1 + 2 ** -23)
    for x, y, z in [hard] + list(zip(a[:2000], b[:2000], c[:2000])):
        value = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        nearest = np.float32(float(value))
        candidates = [nearest, np.nextafter(nearest, np.float32(np.inf)),
                      np.nextafter(nearest, np.float32(-np.inf))]
        best = min(candidates, key=lambda v: (abs(Fraction(float(v)) - value),
                                              int(np.float32(v).view(np.int32)) & 1))
        assert chip_smoke.fma_exact(x, y, z) == best, (x, y, z)
    assert (exact != twice).sum() < 10


@pytest.mark.parametrize("max_distance", [0.5, 1.0, 0.7071068, 3.3, 0.0, 1e-20])
def test_radius_threshold_is_the_plain_bodys_radius_test(max_distance):
    r = np.float32(max_distance)
    t = np.float32(fi.radius_threshold(max_distance))
    assert np.sqrt(t) <= r < np.sqrt(np.nextafter(t, np.float32(np.inf)))
    rng = np.random.default_rng(3)
    s = (np.float64(r) ** 2 * rng.uniform(0.999, 1.001, 100_000)).astype(np.float32)
    np.testing.assert_array_equal(s <= t, np.sqrt(s) <= r)


def test_radius_threshold_edges():
    assert fi.radius_threshold(float("nan")) == float("-inf")
    assert fi.radius_threshold(-1.0) == float("-inf")
    assert fi.radius_threshold(float("inf")) == float("inf")


@pytest.mark.parametrize("n_rows,levels", [(1, 0), (32, 0), (33, 1), (1024, 1), (1025, 2),
                                           (32768, 2), (32769, 3)])
def test_tree_levels(n_rows, levels):
    assert fi.tree_levels(n_rows) == levels


def test_tree_sum_is_xlas_sum_over_the_bucketed_rows():
    """The JAX stages sum the weights of ``_bucket(M)`` rows (a power of two
    of at least 64, zeros after the M real ones), whose windows of 32 need
    no padding at any level; ``_fp.tree_sum`` over the M real rows, padded
    at the end, is that sum in every bit, at M that are and are not
    multiples of 32, with one, two and three window levels."""
    rng = np.random.default_rng(0)
    total = jax.jit(lambda w: jnp.sum(w, axis=1))
    for n_m in (20, 33, 100, 700, 1025, 3000, 40000):
        w = (rng.random((96, n_m)) * 10 + 1).astype(np.float32)
        w[rng.random(w.shape) < 0.5] = 0
        bucketed = np.zeros((96, j_fi._bucket(n_m)), np.float32)
        bucketed[:, :n_m] = w
        got = _fp.tree_sum(torch.from_numpy(w)).numpy()
        np.testing.assert_array_equal(got, np.asarray(total(bucketed)), err_msg=str(n_m))


# ---------------------------------------------------------------------------
# dispatch and build
# ---------------------------------------------------------------------------

def test_cpu_tensor_takes_the_plain_body():
    kernel = fi.FLOW_INTERP_KERNEL
    before = kernel.launches
    inputs = chip_smoke.interp_inputs(16, 40, 3)
    fi._interp_all_kernel(*[torch.from_numpy(a) for a in inputs[:4]], inputs[4])
    assert kernel.launches == before and kernel._lib is None


def test_cuda_tensor_launches_the_kernel(monkeypatch):
    seen = []

    class Cuda:
        device = torch.device("cuda")

    monkeypatch.setattr(fi, "FLOW_INTERP_KERNEL", lambda *args: seen.append(args) or "kernel")
    monkeypatch.setattr(fi, "_interp_all_plain", None)
    assert fi._interp_all_kernel(Cuda(), 1, 2, 3, 0.5) == "kernel" and len(seen) == 1
    with pytest.raises(ValueError, match="unsupported device"):
        fi._interp_all_kernel(torch.zeros(2, 3, device="meta"), None, None, None, 0.5)


def test_cuda_entry_point_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        fi.FlowInterpolator(None, device="cuda")


def test_kernel_checks_its_inputs():
    kernel = fi._FlowInterpKernel()
    q = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="d = 2 or 3"):
        kernel(torch.zeros(4, 4), torch.zeros(5, 4), torch.zeros(5, 4), torch.zeros(5), 0.5)
    with pytest.raises(ValueError, match="d = 2 or 3"):
        kernel(q, torch.zeros(5, 3), torch.zeros(5, 2), torch.zeros(5), 0.5)
    with pytest.raises(TypeError, match="float32"):
        kernel(q.double(), torch.zeros(5, 3), torch.zeros(5, 3), torch.zeros(5), 0.5)


def test_build_command_is_sm90a_without_contraction_or_fast_math():
    kernel = fi._FlowInterpKernel()
    args = kernel.compile_args("out.so")
    assert "arch=compute_90a,code=sm_90a" in args and "-fmad=false" in args
    assert not any(re.search(r"fast.?math|ftz=true|prec-(div|sqrt)=false", a) for a in args)
    src = kernel.source_path
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.exists(src) and os.path.commonpath([src, root]) == root
    with open(src) as f:
        text = f.read()
    includes = re.findall(r"#include\s*[<\"]([^>\"]+)", text)
    assert set(includes) <= {"cuda_runtime.h", "math_constants.h", "stdint.h"}, includes
    assert os.path.dirname(kernel.library_path()) == _cuda.BUILD_DIR
