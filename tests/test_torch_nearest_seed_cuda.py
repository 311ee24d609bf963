"""The hand-written CUDA nearest seed against its plain body.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_nearest_seed_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
``edt.nearest_seed`` on a CUDA tensor launches ``kernels/csrc/nearest_seed.cu``
once (no ``fma_f32``; the CUDA kernels counted as ``chip_smoke.seed_work``
says) and equals ``nearest_seed_plain`` with labels exact
and distances bit for bit, on the card and on CPU copies: 2D and 3D,
anisotropic sampling, with and without objects, ``max_radius_px`` set and
unset, seeds in object 0, ties on a lattice, and the main paths' frame
shapes (64x256x256 and 1024x1024).
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
@pytest.mark.parametrize("shape", [(6, 20, 22), (30, 31), (1, 1, 1)])
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
@pytest.mark.parametrize("shape", [(64, 256, 256), (1024, 1024)])
def test_main_path_shapes(cuda, shape):
    seeds, objects = chip_smoke.seed_inputs(shape, seed=3, seed_fraction=0.002)
    labels, _ = _check(seeds, objects, SAMPLING[len(shape)], None, cuda, against_cpu=False)
    assert int((labels > 0).sum()) > 0
