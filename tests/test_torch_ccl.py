"""The port's connected components against the JAX package and scipy, and
the union-find kernel's contract on the CPU.

The masks are ``chip_smoke.ccl_masks`` and ``chip_smoke.serpentine`` (the
card check's phase 17 masks) at small 3D and 2D shapes.  ``union_find_roots`` (on a CPU tensor, the
plain body), ``label``, ``fill_holes`` and ``remove_small_components`` are
held to ``nellie_tpu.kernels.ccl`` and to ``scipy.ndimage``, exactly.

The CUDA kernel (``kernels/csrc/ccl_union_find.cu``) cannot run here, so
its merge is emulated in numpy: the unions of every foreground voxel with
its backward neighbours, run as interleaved "threads" in a seeded random
order, each a find of both roots and an ``atomicMin`` of the larger root
toward the smaller with a retry when it lost a race.  The flattened
roots equal the plain body's: the minimum-index root does not depend on
the order in which the atomics resolve.  On the card,
``tests/test_torch_ccl_cuda.py`` holds the kernel itself to the plain body.
"""
import os
import re
from collections import deque

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax.numpy as jnp

import chip_smoke
from nellie_tpu.kernels import ccl as j_ccl
from nellie_tpu_torch.kernels import _cuda, ccl, nn
from nellie_tpu_torch.kernels.ccl import CCL_KERNEL, union_find_roots
from torch_port_data import one_torch_thread  # noqa: F401 — autouse

SHAPES = {"3D": (6, 10, 12), "2D": (16, 20)}
CASES = sorted(chip_smoke.ccl_masks(SHAPES["2D"])) + ["serpentine"]
MIN_SIZE = 3


@pytest.fixture(scope="module")
def masks():
    return {dim: dict(chip_smoke.ccl_masks(shape, seed=3), serpentine=chip_smoke.serpentine(shape))
            for dim, shape in SHAPES.items()}


def _structure(ndim, connectivity):
    return (np.ones((3,) * ndim, int) if connectivity == "full"
            else ndi.generate_binary_structure(ndim, 1))


@pytest.mark.parametrize("connectivity", ["full", "faces"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_union_find_roots_match_jax_and_scipy(masks, dim, case, connectivity):
    mask = masks[dim][case]
    got = union_find_roots(torch.from_numpy(mask), connectivity)
    assert got.dtype == torch.int64 and got.shape == (mask.size,)
    want = np.asarray(j_ccl.union_find_roots(jnp.asarray(mask), connectivity=connectivity))
    want = want.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), chip_smoke.scipy_roots(mask, connectivity)[0])


@pytest.mark.parametrize("connectivity", ["full", "faces"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_label_matches_scipy_and_jax(masks, dim, case, connectivity):
    mask = masks[dim][case]
    got, n_got = ccl.label(torch.from_numpy(mask), connectivity)
    want, n_want = ndi.label(mask, structure=_structure(mask.ndim, connectivity))
    assert n_got == n_want
    np.testing.assert_array_equal(got.numpy(), want)
    j_lab, j_n = j_ccl.label(jnp.asarray(mask), connectivity=connectivity)
    assert int(j_n) == n_got
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_lab))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_fill_holes_matches_scipy_and_jax(masks, dim, case):
    mask = masks[dim][case]
    got = ccl.fill_holes(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, ndi.binary_fill_holes(mask))
    np.testing.assert_array_equal(got, np.asarray(j_ccl.fill_holes(jnp.asarray(mask))))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_remove_small_components_matches_scipy_and_jax(masks, dim, case):
    mask = masks[dim][case]
    got = ccl.remove_small_components(torch.from_numpy(mask), MIN_SIZE).numpy()
    lab, _ = ndi.label(mask, structure=_structure(mask.ndim, "full"))
    sizes = np.bincount(lab.reshape(-1))
    np.testing.assert_array_equal(got, mask & (sizes[lab] >= MIN_SIZE))
    want = j_ccl.remove_small_components(jnp.asarray(mask), MIN_SIZE)
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# the kernel's merge, emulated
# ---------------------------------------------------------------------------

def backward_offsets(connectivity):
    """The kernel's stencil: the (dz, dy, dx) before (0, 0, 0) in raster
    order, 13 of 26 or 3 of 6."""
    if connectivity == "faces":
        return [(-1, 0, 0), (0, -1, 0), (0, 0, -1)]
    return [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if (dz, dy, dx) < (0, 0, 0)]


def merge_pairs(mask, connectivity):
    """(voxel, neighbour) linear indices of every union the merge kernel
    makes: each foreground voxel with each foreground backward neighbour
    (a 2D mask is a 3D one of depth 1, as in the kernel)."""
    vol = mask.reshape((1,) * (3 - mask.ndim) + mask.shape)
    shape = np.array(vol.shape)
    coords = np.argwhere(vol)
    pairs = []
    for off in backward_offsets(connectivity):
        nb = coords + off
        ok = ((nb >= 0) & (nb < shape)).all(axis=1)
        ok[ok] = vol[tuple(nb[ok].T)]
        pairs.append(np.stack([np.ravel_multi_index(coords[ok].T, vol.shape),
                               np.ravel_multi_index(nb[ok].T, vol.shape)], axis=1))
    return np.concatenate(pairs) if pairs else np.zeros((0, 2), np.int64)


def _unite(parent, a, b, stats):
    """The kernel's ``unite`` as a generator that yields after every read
    and after the atomicMin, so that unions interleave."""
    while True:
        for side in (0, 1):
            x = (a, b)[side]
            while True:
                p = parent[x]
                yield
                if p == x:
                    break
                x = p
            a, b = (x, b) if side == 0 else (a, x)
        if a == b:
            return
        hi, lo = max(a, b), min(a, b)
        old = parent[hi]
        parent[hi] = min(old, lo)
        yield
        if old == hi:
            return
        stats["retries"] += 1
        a, b = old, lo


def emulate_kernel(mask, connectivity, seed, threads=16):
    """init, the merge's unions in a seeded random order on ``threads``
    interleaved threads, flatten: the kernel's int64 roots."""
    flat = mask.reshape(-1)
    n = flat.size
    parent = np.where(flat, np.arange(n), n)
    pairs = merge_pairs(mask, connectivity)
    rng = np.random.default_rng(seed)
    pending = deque(pairs[rng.permutation(len(pairs))].tolist())
    running, stats = [], {"retries": 0}
    while pending or running:
        while pending and len(running) < threads:
            running.append(_unite(parent, *pending.popleft(), stats))
        k = int(rng.integers(len(running)))
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)
    roots = np.full(n, n, np.int64)
    for i in np.flatnonzero(flat):
        r = i
        while parent[r] != r:
            r = parent[r]
        roots[i] = r
    return roots, stats["retries"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("connectivity", ["full", "faces"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_merge_in_random_order_equals_plain_body(masks, dim, case, connectivity, seed):
    mask = masks[dim][case]
    roots, _ = emulate_kernel(mask, connectivity, seed)
    np.testing.assert_array_equal(
        roots, union_find_roots(torch.from_numpy(mask), connectivity).numpy())


def test_emulated_races_take_the_retry_path(masks):
    """The interleaving is real: unions lose atomicMin races and retry, and
    the roots still equal the plain body's."""
    mask = masks["3D"]["foreground"]
    roots, retries = emulate_kernel(mask, "full", seed=0, threads=64)
    assert retries > 0
    assert (roots == 0).all()


@pytest.mark.parametrize("connectivity,count", [("full", 13), ("faces", 3)])
def test_backward_stencil_is_half_the_neighbourhood(connectivity, count):
    offsets = backward_offsets(connectivity)
    assert len(offsets) == len(set(offsets)) == count
    full = {tuple(o) for o in offsets} | {tuple(-np.array(o)) for o in offsets}
    assert len(full) == 2 * count and (0, 0, 0) not in full


# ---------------------------------------------------------------------------
# dispatch and build
# ---------------------------------------------------------------------------

def test_cpu_tensor_takes_the_plain_body():
    before = CCL_KERNEL.launches
    mask = torch.from_numpy(chip_smoke.ccl_masks((5, 7, 9))["random 25%"])
    np.testing.assert_array_equal(union_find_roots(mask).numpy(),
                                  ccl.union_find_roots_plain(mask).numpy())
    assert CCL_KERNEL.launches == before and CCL_KERNEL._lib is None


def test_cuda_tensor_launches_the_kernel(monkeypatch):
    """A CUDA tensor goes to the kernel object, never to the plain body;
    any other device raises."""
    seen = []

    class Cuda:
        device = torch.device("cuda")

    monkeypatch.setattr(ccl, "CCL_KERNEL", lambda mask, conn: seen.append(conn) or "kernel")
    monkeypatch.setattr(ccl, "union_find_roots_plain", None)
    assert ccl.union_find_roots(Cuda(), "faces") == "kernel" and seen == ["faces"]
    with pytest.raises(ValueError, match="unsupported device"):
        ccl.union_find_roots(torch.zeros(3, device="meta"))


def test_cuda_entry_point_without_a_gpu_raises():
    from nellie_tpu_torch.kernels.frangi import FrangiParams
    from nellie_tpu_torch.pipeline import capacity

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        capacity.segment_volume(np.zeros((4, 8, 8), np.uint16),
                                FrangiParams(sigmas=(1.0,), spacing=(1.0, 1.0, 1.0)),
                                device="cuda")


def test_kernel_rejects_what_it_cannot_index():
    with pytest.raises(ValueError, match="int32"):
        ccl._CCLKernel()(torch.zeros(2 ** 31, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="connectivity"):
        ccl._CCLKernel()(torch.zeros(4, dtype=torch.bool), "edges")


@pytest.mark.parametrize("kernel_class", [ccl._CCLKernel, nn._NNKernel])
def test_build_command_targets_sm90a_from_the_repo(kernel_class):
    kernel = kernel_class()
    args = kernel.compile_args("out.so")
    assert "arch=compute_90a,code=sm_90a" in args
    assert not any("fast_math" in a or "fast-math" in a for a in args)
    src = kernel.source_path
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.exists(src) and os.path.commonpath([src, root]) == root
    assert src in args and os.path.dirname(kernel.library_path()) == _cuda.BUILD_DIR
    with open(src) as f:
        includes = re.findall(r"#include\s*[<\"]([^>\"]+)", f.read())
    assert set(includes) <= {"cuda_runtime.h", "math_constants.h", "stdint.h"}, includes


def test_no_nvcc_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda, "DEFAULT_NVCC", os.path.join(os.sep, "nonexistent", "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ccl._CCLKernel().build()
