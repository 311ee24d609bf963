"""The hand-written CUDA union-find kernel against its plain body.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_ccl_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)  The masks
are ``chip_smoke.ccl_masks`` (phase 17's) at main-path shapes and at shapes
off the kernel's 32 x 8 x 4 and 32 x 32 tiles, a dense background at faces
connectivity (what ``fill_holes`` gives it), runs that cross warps and
tiles, and a capacity cell of 2**26 voxels;
``union_find_roots`` on a CUDA tensor launches the kernel once and equals
``union_find_roots_plain`` on the card and on CPU copies exactly.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import ccl

SHAPES = [(64, 256, 256), (1024, 1024), (7, 33, 65), (5, 37, 100), (1, 1, 5), (130,)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(mask_np, connectivity, dev):
    mask = torch.from_numpy(mask_np).to(dev)
    before = ccl.CCL_KERNEL.launches
    got = ccl.union_find_roots(mask, connectivity)
    torch.cuda.synchronize()
    assert ccl.CCL_KERNEL.launches == before + 1
    assert got.dtype == torch.int64 and got.device.type == "cuda"
    assert torch.equal(got, ccl.union_find_roots_plain(mask, connectivity))
    if mask.numel() <= 1 << 16:
        assert torch.equal(got.cpu(), ccl.union_find_roots_plain(mask.cpu(), connectivity))


@pytest.mark.gpu
@pytest.mark.parametrize("connectivity", ["full", "faces"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_equals_plain_body(cuda, shape, connectivity):
    for mask in chip_smoke.ccl_masks(shape, seed=len(shape)).values():
        _check(mask, connectivity, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("connectivity", ["full", "faces"])
def test_serpentine(cuda, connectivity):
    """The one-voxel path: against the plain body where its propagation
    rounds allow, against scipy's roots at the main-path shapes."""
    for shape in chip_smoke.SERPENTINE_SHAPES:
        _check(chip_smoke.serpentine(shape), connectivity, cuda)
    for shape in SHAPES[:2]:
        mask = chip_smoke.serpentine(shape)
        got = ccl.union_find_roots(torch.from_numpy(mask).to(cuda), connectivity)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      chip_smoke.scipy_roots(mask, connectivity)[0])


@pytest.mark.gpu
def test_label_fill_holes_and_area_filter_on_the_card(cuda):
    """The three callers through the kernel equal their CPU results."""
    mask_np = chip_smoke.ccl_masks((24, 64, 64), seed=5)["random 25%"]
    mask = torch.from_numpy(mask_np)
    lab_g, n_g = ccl.label(mask.to(cuda))
    lab_c, n_c = ccl.label(mask)
    assert n_g == n_c and torch.equal(lab_g.cpu(), lab_c)
    assert torch.equal(ccl.fill_holes(mask.to(cuda)).cpu(), ccl.fill_holes(mask))
    assert torch.equal(ccl.remove_small_components(mask.to(cuda), 5).cpu(),
                       ccl.remove_small_components(mask, 5))


@pytest.mark.gpu
def test_capacity_window_at_low_foreground(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    mask = torch.rand(chip_smoke.CAPACITY_WINDOW, generator=gen, device=cuda) < 0.001
    for connectivity in ("full", "faces"):
        got = ccl.union_find_roots(mask, connectivity)
        assert torch.equal(got, ccl.union_find_roots_plain(mask, connectivity))


@pytest.mark.gpu
def test_kernel_launches_on_another_stream_and_from_threads(cuda):
    from concurrent.futures import ThreadPoolExecutor

    masks = [torch.from_numpy(chip_smoke.ccl_masks((16, 48, 48), seed=s)["random 25%"]).to(cuda)
             for s in range(8)]
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        got = ccl.union_find_roots(masks[0])
    stream.synchronize()
    assert torch.equal(got, ccl.union_find_roots_plain(masks[0]))
    before = ccl.CCL_KERNEL.launches
    with ThreadPoolExecutor(8) as ex:
        roots = list(ex.map(ccl.union_find_roots, masks))
    torch.cuda.synchronize()
    assert ccl.CCL_KERNEL.launches == before + 8
    for mask, r in zip(masks, roots):
        assert torch.equal(r, ccl.union_find_roots_plain(mask))


@pytest.mark.gpu
def test_kernel_rejects_more_axes_than_three(cuda):
    with pytest.raises(ValueError, match="1 to 3 axes"):
        ccl.union_find_roots(torch.ones((2, 2, 2, 2), dtype=torch.bool, device=cuda))
    assert ccl.union_find_roots(torch.zeros(0, dtype=torch.bool, device=cuda)).numel() == 0
    np.testing.assert_array_equal(
        ccl.union_find_roots(torch.tensor([True, False, True], device=cuda)).cpu().numpy(),
        [0, 3, 2])


@pytest.mark.gpu
@pytest.mark.parametrize("connectivity", ["full", "faces"])
def test_dense_background(cuda, connectivity):
    """``fill_holes`` runs the kernel on the background: 98.8 % of the
    voxels, one component with holes."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    for shape in ((64, 256, 256), (1024, 1024), (9, 35, 70)):
        mask = ~(torch.rand(shape, generator=gen, device=cuda) < 0.012)
        got = ccl.union_find_roots(mask, connectivity)
        assert torch.equal(got, ccl.union_find_roots_plain(mask, connectivity))


@pytest.mark.gpu
@pytest.mark.parametrize("connectivity", ["full", "faces"])
def test_runs_cross_warps_and_tiles(cuda, connectivity):
    """Whole rows joined at alternate ends (a serpentine 100 voxels wide,
    four words a row) and rows of runs that start in one word and end in
    the next: joined only through the border unions."""
    for shape in ((9, 37, 100), (45, 100)):
        mask = chip_smoke.serpentine(shape)
        got = ccl.union_find_roots(torch.from_numpy(mask).to(cuda), connectivity)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      chip_smoke.scipy_roots(mask, connectivity)[0])
    runs = np.zeros((6, 20, 130), bool)
    runs[:, ::2, 20:50] = True
    runs[:, 1::2, 60:100] = True
    runs[::2, :, 49:61] = True
    _check(runs, connectivity, cuda)


@pytest.mark.gpu
def test_capacity_cell_of_two_to_the_26_voxels(cuda):
    """A 256 x 512 x 512 cell, the largest capacity gives the kernel
    (``capacity._CCL_CELL_MAX_VOX``): its foreground at 0.1 % (a label
    cell) and its background (a fill-holes cell)."""
    from nellie_tpu_torch.pipeline import capacity

    shape = (256, 512, 512)
    assert np.prod(shape) == capacity._CCL_CELL_MAX_VOX
    gen = torch.Generator(device=cuda).manual_seed(26)
    mask = torch.rand(shape, generator=gen, device=cuda) < 0.001
    assert torch.equal(ccl.union_find_roots(mask, "full"),
                       ccl.union_find_roots_plain(mask, "full"))
    assert torch.equal(ccl.union_find_roots(~mask, "faces"),
                       ccl.union_find_roots_plain(~mask, "faces"))
