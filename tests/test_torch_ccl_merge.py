"""The cross-cell merge of capacity's chunked strategy on the CPU.

``ccl.merge_cell_roots_plain`` (the plain body of ``csrc/ccl_merge.cu``)
against the host union-find it replaced (``mesh.cells._HostUnionFind``
over ``plane_pair_edges``, the numpy listing of the root pairs that
capacity used, kept here; one union a root pair of every boundary's two
planes) and against scipy's labelling: every member voxel's final root is
its component's minimum raveled index.  The masks are
``chip_smoke.merge_masks`` (phase 17's): blobs, a lattice through every
cell, a shell whose hole crosses a boundary along every axis, pieces that
touch only across a diagonal of a boundary, and nothing, on 3 x 3 x 3 and
4 x 4 grids, at both connectivities and inverted as hole filling takes
them.  The chunked strategy itself is in
``tests/test_torch_capacity_chunked.py``; the kernel in
``tests/test_torch_ccl_merge_cuda.py``.
"""
import itertools

import numpy as np
import pytest
import torch

import chip_smoke
from torch_port_data import one_torch_thread  # noqa: F401 — autouse
from nellie_tpu_torch.kernels import ccl
from nellie_tpu_torch.mesh import cells
from nellie_tpu_torch.pipeline import capacity

CASES = [(ndim, name) for ndim in (3, 2) for name in ("blobs", "lattice", "shell", "diagonal",
                                                      "empty")]
CONNECTIVITY = [("full", False), ("faces", False), ("faces", True)]


def plane_pair_edges(left, right, connectivity):
    """Root pairs adjacent across a boundary between two numpy planes:
    aligned voxels for 'faces', all 3^ndim in-plane shifts for 'full'."""
    nd = left.ndim
    shifts = ([(0,) * nd] if connectivity == "faces"
              else list(itertools.product((-1, 0, 1), repeat=nd)))
    pa, pb = [], []
    for off in shifts:
        lsl, rsl = [], []
        for o in off:
            if o > 0:
                lsl.append(slice(None, -o))
                rsl.append(slice(o, None))
            elif o < 0:
                lsl.append(slice(-o, None))
                rsl.append(slice(None, o))
            else:
                lsl.append(slice(None))
                rsl.append(slice(None))
        lv = left[tuple(lsl)].reshape(-1)
        rv = right[tuple(rsl)].reshape(-1)
        sel = (lv >= 0) & (rv >= 0) & (lv != rv)
        pa.append(lv[sel])
        pb.append(rv[sel])
    return np.concatenate(pa), np.concatenate(pb)


def host_merge(roots, bounds, connectivity):
    """Each member's merged root by the host union-find over every
    boundary's root pairs; -1 elsewhere."""
    r = roots.numpy()
    uf = cells._HostUnionFind()
    for axis, pos in ccl.internal_planes(bounds):
        uf.union_pairs(*plane_pair_edges(np.take(r, pos - 1, axis=axis),
                                         np.take(r, pos, axis=axis), connectivity))
    out = r.copy()
    flat = out.reshape(-1)
    member = flat >= 0
    flat[member] = [uf.find(int(x)) for x in flat[member]]
    return out


def scipy_merged(mask, connectivity):
    """Each member's component minimum raveled index by scipy; -1 elsewhere."""
    roots, _ = chip_smoke.scipy_roots(mask, connectivity)
    return np.where(mask.reshape(-1), roots, -1).reshape(mask.shape)


@pytest.mark.parametrize("connectivity,invert", CONNECTIVITY, ids=["full", "faces", "inverted"])
@pytest.mark.parametrize("ndim,name", CASES, ids=[f"{d}D-{n}" for d, n in CASES])
def test_plain_equals_host_union_find_and_scipy(ndim, name, connectivity, invert):
    mask = chip_smoke.merge_masks(ndim)[name]
    bounds = chip_smoke.merge_grid(mask.shape, chip_smoke.MERGE_CELLS[ndim])
    roots = chip_smoke.cell_roots(torch.from_numpy(mask), bounds, connectivity, invert)
    want = host_merge(roots, bounds, connectivity)
    got = ccl.merge_cell_roots_plain(roots, bounds, connectivity)
    assert got.dtype == torch.int32 and got.shape == mask.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), scipy_merged(~mask if invert else mask,
                                                            connectivity))


@pytest.mark.parametrize("connectivity", ("full", "faces"))
@pytest.mark.parametrize("ndim,name", CASES, ids=[f"{d}D-{n}" for d, n in CASES])
def test_plane_pairs_equal_the_numpy_listing(ndim, name, connectivity):
    """``ccl.plane_pairs`` (the plain body's and the mesh's listing) gives
    the numpy listing's pairs in the same order at every boundary."""
    mask = chip_smoke.merge_masks(ndim)[name]
    bounds = chip_smoke.merge_grid(mask.shape, chip_smoke.MERGE_CELLS[ndim])
    roots = chip_smoke.cell_roots(torch.from_numpy(mask), bounds, connectivity)
    for axis, pos in ccl.internal_planes(bounds):
        left, right = roots.select(axis, pos - 1), roots.select(axis, pos)
        got = ccl.plane_pairs(left, right, connectivity)
        want = plane_pair_edges(left.numpy(), right.numpy(), connectivity)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("ndim", (3, 2))
def test_diagonal_pieces_join_under_full_only(ndim):
    """Pieces touching only across a diagonal of a boundary: one component
    a pair under full connectivity, two under faces."""
    mask = chip_smoke.merge_masks(ndim)["diagonal"]
    bounds = chip_smoke.merge_grid(mask.shape, chip_smoke.MERGE_CELLS[ndim])
    count = {}
    for conn in ("full", "faces"):
        roots = chip_smoke.cell_roots(torch.from_numpy(mask), bounds, conn)
        assert len(torch.unique(roots[roots >= 0])) == mask.sum()  # one piece a voxel
        merged = ccl.merge_cell_roots(roots, bounds, conn)
        count[conn] = len(torch.unique(merged[merged >= 0]))
    assert count == {"full": mask.sum() // 2, "faces": mask.sum()}


@pytest.mark.parametrize("ndim,name", CASES, ids=[f"{d}D-{n}" for d, n in CASES])
def test_global_area_filter_equals_whole_volume(ndim, name):
    """Capacity's global area filter (sizes summed by the component roots'
    ranks over the merged roots) keeps what the whole volume's filter keeps,
    at a size that drops some components and keeps others."""
    mask = torch.from_numpy(chip_smoke.merge_masks(ndim)[name])
    bounds = chip_smoke.merge_grid(tuple(mask.shape), chip_smoke.MERGE_CELLS[ndim])
    want = ccl.remove_small_components(mask, 40)
    got = mask.clone()
    capacity._remove_small_chunked(got, tuple(mask.shape), bounds, 40,
                                   capacity._Phases(torch.device("cpu")))
    assert torch.equal(got, want)


def test_lattice_is_one_component_through_every_cell():
    mask = chip_smoke.merge_masks(3)["lattice"]
    bounds = chip_smoke.merge_grid(mask.shape, chip_smoke.MERGE_CELLS[3])
    roots = chip_smoke.cell_roots(torch.from_numpy(mask), bounds, "faces")
    assert len(torch.unique(roots[roots >= 0])) == 27  # one piece a cell
    merged = ccl.merge_cell_roots(roots, bounds, "faces")
    assert torch.unique(merged[merged >= 0]).tolist() == [int(np.flatnonzero(mask)[0])]


def test_dispatcher_and_wrapper():
    """A CPU tensor takes the plain body in place; one cell merges nothing;
    the kernel's wrapper refuses what its C entry point cannot take before
    it builds anything; other devices raise."""
    mask = chip_smoke.merge_masks(3)["blobs"]
    bounds = chip_smoke.merge_grid(mask.shape, 3)
    roots = chip_smoke.cell_roots(torch.from_numpy(mask), bounds, "full")
    want = ccl.merge_cell_roots_plain(roots.clone(), bounds)
    assert ccl.merge_cell_roots(roots, bounds) is roots and torch.equal(roots, want)
    one_cell = [(0, d) for d in mask.shape]
    assert ccl.internal_planes(one_cell) == []
    again = roots.clone()
    assert torch.equal(ccl.merge_cell_roots(again, one_cell), roots)
    assert ccl.internal_planes(bounds) == [(0, 7), (0, 13), (1, 13), (1, 27), (2, 16), (2, 32)]
    kernel = ccl._MergeKernel()
    with pytest.raises(ValueError, match="int32"):
        kernel(roots.long(), bounds)
    with pytest.raises(ValueError, match="connectivity"):
        kernel(roots, bounds, "edges")
    with pytest.raises(ValueError, match="16-byte"):
        kernel(roots.reshape(-1)[1:], [(0, 5, roots.numel() - 1)])
    assert kernel._lib is None and kernel.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        ccl.merge_cell_roots(roots.to("meta"), bounds)


def test_chunked_strategy_merges_through_the_dispatcher(monkeypatch):
    """Each global pass of the chunked strategy merges its roots through
    ``ccl.merge_cell_roots`` once: hole filling with faces connectivity on
    the background, the label pass with full; nothing of the host
    union-find is left in the capacity module."""
    made = []
    original = ccl.merge_cell_roots

    def recording(roots, bounds, connectivity="full"):
        made.append((connectivity, int((roots >= 0).sum())))
        return original(roots, bounds, connectivity)

    monkeypatch.setattr(ccl, "merge_cell_roots", recording)
    monkeypatch.setattr(capacity, "_ccl_grid", lambda shape, **_: chip_smoke.merge_grid(shape, 3))
    vol = chip_smoke.capacity_tube()
    params = capacity.frangi_k.FrangiParams(sigmas=(0.75, 0.95), spacing=(0.5, 0.2, 0.2),
                                            z_ratio=2.5)
    out = capacity.segment_volume(vol, params, min_area=4, emit="sparse_labels",
                                  max_chunk_voxels=16 * 64 * 64, strategy="chunked",
                                  device="cpu")
    assert [c for c, _ in made] == ["faces", "full"]
    assert made[0][1] > vol.size // 2 and made[1][1] == out["fg_count"] > 0
    for name in ("_HostUnionFind", "_plane_pair_edges", "_merge_cells", "_sorted_table"):
        assert not hasattr(capacity, name)
