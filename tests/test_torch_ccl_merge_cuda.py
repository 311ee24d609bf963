"""The hand-written cross-cell merge kernel against its plain body.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_ccl_merge_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
``ccl.merge_cell_roots`` on a CUDA tensor launches ``csrc/ccl_merge.cu``
(one wrapper call, a merge and a flatten, no host read) and equals
``merge_cell_roots_plain`` bit for bit on the card and on CPU copies:
``chip_smoke.merge_masks`` on their fine grids, a 256^3 blob volume (at
that size the default grid is one cell, so it is cut 2 x 2 x 2 by
``_ccl_grid``'s own rule at 2^21 voxels a cell) and the 90,000 isolated
voxels that widen the labels to int32.  The chunked strategy's passes on
the card equal the CPU's: the labels, hole filling, and the global area
filter that the 1024^3 run does not take.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import ccl
from nellie_tpu_torch.kernels.frangi import FrangiParams
from nellie_tpu_torch.pipeline import capacity

CASES = [(ndim, name) for ndim in (3, 2) for name in ("blobs", "lattice", "shell", "diagonal",
                                                      "empty")]
CONNECTIVITY = [("full", False), ("faces", False), ("faces", True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(roots, bounds, connectivity, against_cpu=True):
    kernel = ccl.MERGE_KERNEL
    calls, launched = kernel.launches, kernel.kernel_launches
    got = ccl.merge_cell_roots(roots.clone(), bounds, connectivity)
    torch.cuda.synchronize()
    assert (kernel.launches - calls, kernel.kernel_launches - launched) == (1, 2)
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got, ccl.merge_cell_roots_plain(roots.clone(), bounds, connectivity))
    if against_cpu:
        assert torch.equal(got.cpu(),
                           ccl.merge_cell_roots_plain(roots.cpu(), bounds, connectivity))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("connectivity,invert", CONNECTIVITY, ids=["full", "faces", "inverted"])
@pytest.mark.parametrize("ndim,name", CASES, ids=[f"{d}D-{n}" for d, n in CASES])
def test_kernel_equals_plain_body(cuda, ndim, name, connectivity, invert):
    mask = torch.from_numpy(chip_smoke.merge_masks(ndim)[name]).to(cuda)
    bounds = chip_smoke.merge_grid(tuple(mask.shape), chip_smoke.MERGE_CELLS[ndim])
    _check(chip_smoke.cell_roots(mask, bounds, connectivity, invert), bounds, connectivity)


@pytest.mark.gpu
@pytest.mark.parametrize("connectivity,invert", CONNECTIVITY, ids=["full", "faces", "inverted"])
def test_blob_volume_256(cuda, connectivity, invert):
    from scipy import ndimage

    shape = (256, 256, 256)
    noise = ndimage.gaussian_filter(np.random.default_rng(5).normal(size=shape).astype(np.float32),
                                    2.0)
    mask = torch.from_numpy(noise > 0.8 * noise.std()).to(cuda)
    bounds = capacity._ccl_grid(shape, max_vox=1 << 21)
    assert len(ccl.internal_planes(bounds)) == 3
    roots = chip_smoke.cell_roots(mask, bounds, connectivity, invert)
    got = _check(roots, bounds, connectivity)
    assert int((got != roots).sum()) > 0  # pieces were joined


@pytest.mark.gpu
def test_widening_case(cuda):
    """90,000 isolated voxels on a 3 x 3 grid: nothing joins, and the labels
    widen to int32, equal on the card and on the CPU."""
    mask = np.zeros((600, 600), bool)
    mask[::2, ::2] = True
    bounds = chip_smoke.merge_grid(mask.shape, 3)
    for conn in ("full", "faces"):
        roots = chip_smoke.cell_roots(torch.from_numpy(mask).to(cuda), bounds, conn)
        assert torch.equal(_check(roots, bounds, conn), roots)
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = capacity._label_chunked(torch.from_numpy(mask).to(dev), mask.shape, bounds,
                                           capacity._Phases(torch.device(dev)))
    assert out["cuda"][0].dtype == np.int32 and out["cuda"][1] == 90_000
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    assert out["cuda"][1:] == out["cpu"][1:]


@pytest.mark.gpu
def test_no_host_read(cuda):
    """A merge only queues work: with 50 ms of work queued on the card the
    call returns long before it ends."""
    mask = torch.from_numpy(chip_smoke.merge_masks(3)["blobs"]).to(cuda)
    bounds = chip_smoke.merge_grid(tuple(mask.shape), 3)
    roots = chip_smoke.cell_roots(mask, bounds, "full")
    work = roots.clone()
    assert chip_smoke.host_wait_ms(
        lambda: ccl.merge_cell_roots(work.copy_(roots), bounds)) < chip_smoke.QUEUED_MS / 2


@pytest.mark.gpu
@pytest.mark.parametrize("emit,min_area", [("labels", 4), ("mask", 4), ("labels", 40)],
                         ids=["labels", "mask", "global-area-filter"])
def test_chunked_strategy_card_equals_cpu(cuda, monkeypatch, emit, min_area):
    monkeypatch.setattr(capacity, "_ccl_grid", lambda shape, **_: chip_smoke.merge_grid(shape, 3))
    params = FrangiParams(sigmas=(0.75, 0.95), spacing=(0.5, 0.2, 0.2), z_ratio=2.5)
    vol = chip_smoke.capacity_tube()
    out = {dev: capacity.segment_volume(vol, params, min_area=min_area, emit=emit,
                                        max_chunk_voxels=16 * 64 * 64, strategy="chunked",
                                        device=dev) for dev in ("cuda", "cpu")}
    chip_smoke.same_capacity_result(f"chunked {emit} {min_area}", out["cuda"], out["cpu"])
    assert out["cuda"]["bytes_up"] == vol.nbytes
    assert "merge" in out["cuda"]["seconds"] and "host_merge" not in out["cuda"]["seconds"]
