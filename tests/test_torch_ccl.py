"""The port's connected components against the JAX package and scipy, and
the union-find kernel's contract on the CPU.

The masks are ``chip_smoke.ccl_masks`` and ``chip_smoke.serpentine`` (the
card check's phase 17 masks) at small 3D and 2D shapes.  ``union_find_roots`` (on a CPU tensor, the
plain body), ``label``, ``fill_holes`` and ``remove_small_components`` are
held to ``nellie_tpu.kernels.ccl`` and to ``scipy.ndimage``, exactly.

The CUDA kernel (``kernels/csrc/ccl_union_find.cu``) cannot run here, so
its three phases are emulated in numpy (``emulate_kernel``): per 32-voxel-wide
tile, runs along x from the row bits and the run-start unions between the
tile's rows; then the unions across tiles; each union a find of both roots
and an ``atomicMin`` of the larger root toward the smaller with a retry
when it lost a race, run as interleaved "threads" in a seeded random order,
with path halving across tiles.  The flattened roots equal the plain
body's on 1D, 2D and 3D shapes off every tile multiple: the minimum-index
root does not depend on the order in which the atomics resolve.  On the card,
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
# the kernel's phases, emulated
# ---------------------------------------------------------------------------

# shapes off every tile multiple, several 32-voxel words a row, 1D to 3D
MODEL_SHAPES = {"3D": (6, 11, 70), "2D": (37, 70), "1D": (100,)}
WORD = 32


def backward_offsets(connectivity):
    """The kernel's stencil: the (dz, dy, dx) before (0, 0, 0) in raster
    order, 13 of 26 or 3 of 6."""
    if connectivity == "faces":
        return [(-1, 0, 0), (0, -1, 0), (0, 0, -1)]
    return [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if (dz, dy, dx) < (0, 0, 0)]


def neighbour_rows(connectivity):
    """The backward neighbour rows (dz, dy) of the stencil, with the dx
    each takes; the voxel before in the same row is (0, 0, -1)."""
    rows = {}
    for dz, dy, dx in backward_offsets(connectivity):
        if (dz, dy) != (0, 0):
            rows.setdefault((dz, dy), []).append(dx)
    return sorted(rows.items())


def tile_shape(depth):
    """(TY, TZ): 32 x 8 x 4 tiles in 3D, 32 x 32 in 2D and 1D."""
    return (8, 4) if depth > 1 else (32, 1)


def row_bits(vol):
    """(D, H, words) Python ints: bit l of word xt is voxel xt * 32 + l."""
    d, h, w = vol.shape
    words = -(-w // WORD)
    padded = np.zeros((d, h, words * WORD), bool)
    padded[..., :w] = vol
    weights = [1 << l for l in range(WORD)]
    return [[[sum(wt for wt, on in zip(weights, padded[z, y, xt * WORD:(xt + 1) * WORD]) if on)
              for xt in range(words)] for y in range(h)] for z in range(d)]


def run_starts(word):
    return word & ~(word << 1) & 0xFFFFFFFF


def touching_pairs(a, b, full):
    """(l, u) of the kernel's one union for each pair of touching runs of
    row words a and b: faces at the first column where they overlap; full
    at a's run start (u the same column, else the one before), or before
    b's run start where a's run began earlier."""
    a_start, b_start = run_starts(a), run_starts(b)
    pairs = []
    for l in range(WORD):
        if not (a >> l) & 1:
            continue
        if (a_start >> l) & 1 and (b >> l) & 1:
            pairs.append((l, l))
        elif not full and (b_start >> l) & 1:
            pairs.append((l, l))
        if full and (a_start >> l) & 1 and not (b >> l) & 1 and l > 0 and (b >> (l - 1)) & 1:
            pairs.append((l, l - 1))
        if full and l < WORD - 1 and (b_start >> (l + 1)) & 1:
            pairs.append((l, l + 1))
    return pairs


def _find(parent, x, halving):
    """find as a generator that yields after every read and store; with
    ``halving`` each voxel passed is pointed at its grandparent."""
    p = parent[x]
    yield
    while p != x:
        if halving:
            gp = parent[p]
            yield
            if gp == p:
                return p
            parent[x] = gp
            yield
            x = gp
        else:
            x = p
        p = parent[x]
        yield
    return x


def _unite(parent, a, b, stats, halving):
    """The kernel's unite: both roots, an atomicMin of the larger toward
    the smaller, and a retry from what a lost race returns."""
    while True:
        a = yield from _find(parent, a, halving)
        b = yield from _find(parent, b, halving)
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


def interleave(parent, pairs, rng, threads, stats, halving):
    """Run the unions of ``pairs`` on ``threads`` interleaved threads, in a
    random order of pairs and of steps."""
    pending = deque(pairs[i] for i in rng.permutation(len(pairs)))
    running = []
    while pending or running:
        while pending and len(running) < threads:
            running.append(_unite(parent, *pending.popleft(), stats, halving))
        k = int(rng.integers(len(running)))
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)


def emulate_kernel(mask, connectivity, seed, threads=16):
    """``ccl_union_find.cu``'s three phases in numpy: (int64 roots, number
    of unions that lost a race and retried).

    local: per tile, each voxel linked to the first voxel of its run (from
    the row's bits), one union per pair of touching runs of the tile's rows
    in shared memory (local indices, no compression), then each foreground
    voxel's parent the global index of its local root; border: the same
    unions with rows of other tiles, the diagonals across words and the
    voxel before the word, interleaved over the whole volume with path
    halving; flatten: each root found without stores."""
    vol = mask.reshape((1,) * (3 - mask.ndim) + mask.shape)
    d, h, w = vol.shape
    n, words = vol.size, -(-w // WORD)
    ty, tz = tile_shape(d)
    bits = row_bits(vol)
    rows = neighbour_rows(connectivity)
    full = connectivity == "full"
    rng = np.random.default_rng(seed)
    stats = {"retries": 0}
    parent = [n] * n  # background is never written or read

    for z0 in range(0, d, tz):
        for y0 in range(0, h, ty):
            for xt in range(words):
                def word(lz, ly):
                    z, y = z0 + lz, y0 + ly
                    return bits[z][y][xt] if z < d and y < h else 0

                local = list(range(WORD * ty * tz))
                fg = []
                for lz in range(tz):
                    for ly in range(ty):
                        a = word(lz, ly)
                        for l in range(WORD):
                            if (a >> l) & 1:
                                start = l
                                while start > 0 and (a >> (start - 1)) & 1:
                                    start -= 1
                                local[(lz * ty + ly) * WORD + l] = (lz * ty + ly) * WORD + start
                                fg.append((lz, ly, l))
                pairs = []
                for (dz, dy), _ in rows:
                    for lz in range(tz):
                        for ly in range(ty):
                            nz, ny = lz + dz, ly + dy
                            if 0 <= nz < tz and 0 <= ny < ty:
                                pairs += [((lz * ty + ly) * WORD + l, (nz * ty + ny) * WORD + u)
                                          for l, u in touching_pairs(word(lz, ly), word(nz, ny),
                                                                     full)]
                interleave(local, pairs, rng, threads, stats, halving=False)
                for lz, ly, l in fg:
                    r = (lz * ty + ly) * WORD + l
                    while local[r] != r:
                        r = local[r]
                    rz, ry = divmod(r // WORD, ty)
                    g = ((z0 + lz) * h + y0 + ly) * w + xt * WORD + l
                    parent[g] = ((z0 + rz) * h + y0 + ry) * w + xt * WORD + r % WORD

    pairs = []
    for z in range(d):
        for y in range(h):
            for xt in range(words):
                a = bits[z][y][xt]
                if not a:
                    continue
                base = (z * h + y) * w + xt * WORD
                if xt > 0 and a & 1 and bits[z][y][xt - 1] >> 31:
                    pairs.append((base, base - 1))
                for (dz, dy), _ in rows:
                    nz, ny = z + dz, y + dy
                    if not (0 <= nz and 0 <= ny < h):
                        continue
                    nbase = (nz * h + ny) * w + xt * WORD
                    if nz // tz != z // tz or ny // ty != y // ty:
                        pairs += [(base + l, nbase + u)
                                  for l, u in touching_pairs(a, bits[nz][ny][xt], full)]
                    if full:  # the diagonals into the words before and after
                        if xt > 0 and a & 1 and bits[nz][ny][xt - 1] >> 31:
                            pairs.append((base, nbase - 1))
                        if xt + 1 < words and a >> 31 and bits[nz][ny][xt + 1] & 1:
                            pairs.append((base + WORD - 1, nbase + WORD))
    interleave(parent, pairs, rng, threads, stats, halving=True)

    roots = np.full(n, n, np.int64)
    for i in np.flatnonzero(vol.reshape(-1)):
        r = parent[i]
        while parent[r] != r:
            r = parent[r]
        roots[i] = r
    return roots, stats["retries"]


@pytest.fixture(scope="module")
def model_masks():
    return {dim: dict(chip_smoke.ccl_masks(shape, seed=4),
                      serpentine=chip_smoke.serpentine(shape) if len(shape) > 1
                      else np.ones(shape, bool))
            for dim, shape in MODEL_SHAPES.items()}


@pytest.fixture(scope="module")
def plain_roots(model_masks):
    cache = {}

    def get(dim, case, connectivity):
        key = (dim, case, connectivity)
        if key not in cache:
            cache[key] = union_find_roots(torch.from_numpy(model_masks[dim][case]),
                                          connectivity).numpy()
        return cache[key]
    return get


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("connectivity", ["full", "faces"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dim", sorted(MODEL_SHAPES))
def test_merge_in_random_order_equals_plain_body(model_masks, plain_roots, dim, case,
                                                 connectivity, seed):
    roots, _ = emulate_kernel(model_masks[dim][case], connectivity, seed)
    np.testing.assert_array_equal(roots, plain_roots(dim, case, connectivity))


def test_emulated_races_take_the_retry_path(model_masks):
    """The interleaving is real: unions lose atomicMin races and retry, and
    the roots still equal the plain body's."""
    mask = model_masks["3D"]["foreground"]
    roots, retries = emulate_kernel(mask, "full", seed=0, threads=64)
    assert retries > 0
    assert (roots == 0).all()


@pytest.mark.parametrize("connectivity", ["full", "faces"])
def test_runs_cross_words_and_tiles(connectivity):
    """Runs that span several words and tiles and join only through the
    border unions: each row a run across the whole width, rows joined at
    one end only, alternating sides, as in a serpentine."""
    mask = chip_smoke.serpentine((5, 9, 70))
    assert len(row_bits(mask)[0][0]) == 3
    roots, _ = emulate_kernel(mask, connectivity, seed=5, threads=32)
    np.testing.assert_array_equal(roots, chip_smoke.scipy_roots(mask, connectivity)[0])


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


@pytest.mark.parametrize("kernel_class", [ccl._CCLKernel, ccl._MergeKernel, nn._NNKernel])
def test_build_command_targets_sm90a_from_the_repo(kernel_class):
    """sm_90a, no fast math, the source in the repo, and only the CUDA
    runtime's headers, directly or through a header of ``csrc/`` (the
    union-find's ``union_find.cuh``): no PyTorch header."""
    kernel = kernel_class()
    args = kernel.compile_args("out.so")
    assert "arch=compute_90a,code=sm_90a" in args
    assert not any("fast_math" in a or "fast-math" in a for a in args)
    src = kernel.source_path
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.exists(src) and os.path.commonpath([src, root]) == root
    assert src in args and os.path.dirname(kernel.library_path()) == _cuda.BUILD_DIR
    for path in [src, *kernel.headers()]:
        with open(path) as f:
            includes = re.findall(r"#include\s*[<\"]([^>\"]+)", f.read())
        local = {os.path.basename(h) for h in kernel.headers()}
        assert set(includes) <= {"cuda_runtime.h", "math_constants.h", "stdint.h"} | local, \
            includes


def test_no_nvcc_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda, "DEFAULT_NVCC", os.path.join(os.sep, "nonexistent", "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ccl._CCLKernel().build()
