"""The hand-written CUDA nearest seed against its plain body.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_nearest_seed_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
``edt.nearest_seed`` on a CUDA tensor launches ``kernels/csrc/nearest_seed.cu``
once (no ``fma_f32``; one CUDA kernel and no host read, as
``chip_smoke.seed_work`` and the kernel's ``last_stats`` say) and equals ``nearest_seed_plain`` with labels exact
and distances bit for bit, on the card and on CPU copies: 2D and 3D,
anisotropic sampling, with and without objects, ``max_radius_px`` set and
unset, seeds in object 0, ties on a lattice, 1-D volumes, the main paths'
frame shapes (64x256x256 and 1024x1024; a voxel a thread), more
voxels to run than the grid has threads (several slots a thread), and a
volume past 2**29 voxels; seeds of another type than int32 raise.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import _fp, edt

SAMPLING = {3: (0.5, 0.2, 0.2), 2: (0.5, 0.2), 1: (0.3,)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(seeds_np, objects_np, sampling, radius, dev, against_cpu=True):
    seeds = torch.from_numpy(seeds_np).to(dev)
    objects = None if objects_np is None else torch.from_numpy(objects_np).to(dev)
    kernel = edt.NEAREST_SEED_KERNEL
    before, kernels, fma = kernel.launches, kernel.kernel_launches, _fp.FMA_KERNEL.launches
    labels, dist = edt.nearest_seed(seeds, objects, sampling, radius)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and _fp.FMA_KERNEL.launches == fma
    assert kernel.kernel_launches == kernels + chip_smoke.seed_work(seeds, objects, radius)[1]
    assert kernel.last_stats["cuda_kernels"] == 1 and kernel.last_stats["host_reads"] == 0
    assert labels.dtype == seeds.dtype and dist.dtype == torch.float32
    for where in [dev] + (["cpu"] if against_cpu else []):
        want = edt.nearest_seed_plain(seeds.to(where), None if objects is None
                                      else objects.to(where), sampling, radius)
        assert torch.equal(labels.cpu(), want[0].cpu())
        assert chip_smoke.same_bits(dist.cpu().numpy(), want[1].cpu().numpy()).all()
    return labels, dist


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [None, 3])
@pytest.mark.parametrize("shape", [(10, 24, 28), (40, 44), (7, 33, 65), (300,)])
def test_small(cuda, shape, radius):
    seeds, objects = chip_smoke.seed_inputs(shape, seed=len(shape))
    sampling = SAMPLING[len(shape)]
    for objs in (objects, None):
        _check(seeds, objs, sampling, radius, cuda)
    in_zero = np.where((objects == 0) & (np.random.default_rng(1).random(shape) < 0.002), 9,
                       seeds).astype(np.int32)
    _check(in_zero, objects, sampling, radius, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(6, 20, 22), (30, 31), (1, 1, 1), (50,)])
def test_no_seeds_and_every_voxel_a_seed(cuda, shape):
    objects = np.ones(shape, np.int32)
    for seeds in (np.zeros(shape, np.int32), np.arange(1, objects.size + 1,
                                                       dtype=np.int32).reshape(shape)):
        for objs in (objects, None):
            _check(seeds, objs, SAMPLING[len(shape)], None, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(9, 25, 25), (41, 41)])
def test_ties(cuda, shape):
    seeds = np.zeros(shape, np.int32)
    seeds[tuple(slice(1, None, 4) for _ in shape)] = 1
    seeds[seeds > 0] = np.arange(1, int(seeds.sum()) + 1) % 7 + 1
    _check(seeds, np.ones(shape, np.int32), (1.0,) * len(shape), None, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 256, 256), (1024, 1024), (300000,)])
def test_several_slots_a_thread(cuda, shape):
    """More voxels run than the grid has threads: every voxel without
    objects, every voxel of one object, and a seed in object 0 (the passes
    read their slots again each pass)."""
    seeds, objects = chip_smoke.seed_inputs(shape, seed=4, seed_fraction=0.002)
    sampling = SAMPLING[len(shape)]
    _check(seeds, None, sampling, None, cuda, against_cpu=False)
    _check(seeds, np.ones(shape, np.int32), sampling, None, cuda, against_cpu=False)
    in_zero = np.where((objects == 0) & (np.random.default_rng(2).random(shape) < 1e-4), 9,
                       seeds).astype(np.int32)
    _check(in_zero, objects, sampling, None, cuda, against_cpu=False)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 256, 256), (1024, 1024)])
def test_main_path_shapes(cuda, shape):
    seeds, objects = chip_smoke.seed_inputs(shape, seed=3, seed_fraction=0.002)
    labels, _ = _check(seeds, objects, SAMPLING[len(shape)], None, cuda, against_cpu=False)
    assert int((labels > 0).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("with_objects", [True, False])
def test_past_a_quarter_of_the_int32_range(cuda, with_objects):
    """A volume of 2049x512x512 voxels, past 2**29 (the list, the map and
    the two states then pass 2**31 int32 words of scratch), with seeds near
    its far end, held to the plain body on a crop around them.  With
    ``max_radius_px`` 2 the steps are (2, 1, 1); a step's 9 offsets of one
    sign along an axis carry a seed at most 9 steps that way, 36 voxels in
    all, and the crop reaches 40 past the seeds (or the volume's edge), so
    the voxels outside it never hold a seed and the crop's result is the
    volume's.  With objects (a box inside the crop, object 0 around it) the
    list is compacted; without, every voxel runs (several slots a
    thread)."""
    shape = (2049, 512, 512)
    crop = (slice(1995, 2049), slice(70, 170), slice(70, 170))
    rng = np.random.default_rng(6)
    seeds_crop = np.zeros((54, 100, 100), np.int32)
    seeds_crop[44:, 40:60, 40:60] = np.where(rng.random((10, 20, 20)) < 0.05,
                                             rng.integers(1, 9, (10, 20, 20)), 0)
    seeds = torch.zeros(shape, dtype=torch.int32, device=cuda)
    seeds[crop] = torch.from_numpy(seeds_crop).to(cuda)
    objects = None
    if with_objects:
        objects_crop = np.zeros((54, 100, 100), np.int32)
        objects_crop[39:, 35:65, 35:65] = 1
        objects = torch.zeros(shape, dtype=torch.int32, device=cuda)
        objects[crop] = torch.from_numpy(objects_crop).to(cuda)
    assert seeds.numel() > 2 ** 29
    sampling = SAMPLING[3]
    labels, dist = edt.nearest_seed(seeds, objects, sampling, 2)
    want = edt.nearest_seed_plain(seeds[crop], None if objects is None else objects[crop],
                                  sampling, 2)
    assert torch.equal(labels[crop], want[0])
    assert chip_smoke.same_bits(dist[crop].cpu().numpy(), want[1].cpu().numpy()).all()
    assert int(labels.count_nonzero()) == int(want[0].count_nonzero()) > 0
    assert int(torch.isfinite(dist).sum()) == int(torch.isfinite(want[1]).sum())


@pytest.mark.gpu
def test_int32_seeds_only(cuda):
    """The kernel reads and returns seed values as int32: other types raise
    on the card (the plain body takes any)."""
    for dtype in (torch.int64, torch.float32, torch.uint8):
        with pytest.raises(TypeError):
            edt.nearest_seed(torch.ones((4, 5), dtype=dtype, device=cuda))
