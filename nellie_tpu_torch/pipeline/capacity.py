"""Segmentation of one large volume held on the device (the capacity path).

Port of ``nellie_tpu/pipeline/capacity.py`` (BASELINE config #4, a 1024³
lightsheet volume on one card).  The raw volume goes to the device once;
halo windows of it are sliced there, and each window's vesselness core is
written into one preallocated ``vessel_dtype`` buffer (float16 by
default).  Then the finalize and Label steps run on that buffer: the
1st percentile of a strided sample and its opening mask, the log-domain
min(triangle, Otsu) threshold, hole filling (3D), the area filter, the 3ⁿ
smoothing > 0.5 and connected components.  Two strategies:

* **monolith** (``_segment_from_vessel``): every step over the whole
  volume at once.
* **chunked** (``_segment_chunked``): every global step split into grid
  cells of at most 2²⁶ voxels.  Each cell's components carry the *global*
  minimum raveled index of their piece (``_cell_roots``, int32 roots for
  the whole volume: 4.3 GB at 1024³), a union-find forest indexed by
  voxel.  The hand kernel ``ccl_merge.cu`` (``ccl.merge_cell_roots``)
  unites the pieces adjacent across the cells' boundary planes with
  ``atomicMin`` and flattens the forest on the card, so ranking the merged
  minima gives scipy's numbering, the monolith's labels exactly.  Hole
  filling and the global area filter use the same roots, flagged or
  summed by root id on the device; the opening mask, the windowed area
  filter and the smoothing run in halo windows.

Three emits: ``labels`` (uint16), ``sparse_labels`` (the foreground
support bit-packed, least significant bit first, plus the compacted uint16
values; assembled on the host) and ``mask`` (bit-packed, most significant
bit first along the last axis).  Past 65,535 components the chunked
strategy gives int32 labels, and the monolith re-runs itself through it.
``bytes_up`` and ``bytes_down`` count what crossed between host and
device: the volume and the product (the monolith's as the reference
counts them; the chunked strategy moves nothing else).

A third strategy, **mesh** (``_segment_mesh``, ``capacity.py:833-933``),
runs the monolith over a device mesh: the whole volume split along its
first axis that divides the mesh's z extent, the Frangi cascade unwindowed
on halo blocks, every statistic over the whole volume and the connectivity
joined across shards (:mod:`nellie_tpu_torch.mesh`).  Its labels equal the
monolith's when the monolith's vesselness runs as one window
(``max_chunk_voxels`` at least the volume); a windowed monolith's
statistics are per window and differ near window borders.  It keeps the
reference's logged routes: to the chunked strategy when no axis divides
or past 65,535 components, and to dense labels past the sparse capacity.

Where the raw volume would not fit on the card beside the working set,
decided before the window loop from ``torch.cuda.mem_get_info``, each
window is uploaded from the host instead (the result is the same;
``raw_resident`` in the result says which way ran).  ``seconds`` holds the
device-synchronised time of each phase.
"""
from __future__ import annotations

import itertools
import time
from contextlib import contextmanager

import numpy as np
import torch

from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels import ccl
from nellie_tpu_torch.kernels import frangi as frangi_k
from nellie_tpu_torch.kernels.filters import binary_opening, uniform_filter
from nellie_tpu_torch.stages.labelling import _frangi_threshold_kernel
from nellie_tpu_torch.utils.chunking import (
    compute_chunk_shape,
    crop_core,
    iter_uniform_windows,
    uniform_window_shapes,
)
from nellie_tpu_torch.utils.logger import logger
from nellie_tpu_torch.utils.transfer import SPARSE_CAP_DIV, packbits

# grid cells of the chunked strategy: at most this extent per axis and
# this many voxels (one cell's CCL temporaries about 0.5 GB each)
_CCL_CELL_MAX_DIM = 512
_CCL_CELL_MAX_VOX = 1 << 26
# min_area - 1 <= this: the area filter runs in exact halo windows;
# above it, as a global pass over roots and sizes
_WINDOWED_REMOVE_MAX_HALO = 32
# voxels a step of the flat passes over the merged roots (int64 temporaries
# of 128 MiB)
_FLAT_CHUNK = 1 << 24
# float32 temporaries of one window's Frangi cascade, in window volumes
_WINDOW_WORKING_SET = 32


class _Phases:
    """Device-synchronised seconds per phase, summed over its entries
    (``device``: one device or a list of them)."""

    def __init__(self, device):
        self.devices = [device] if isinstance(device, torch.device) else list(device)
        self.seconds = {}

    @contextmanager
    def __call__(self, name):
        self._sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - start

    def _sync(self):
        for dev in set(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def _box(origin, shape):
    return tuple(slice(o, o + s) for o, s in zip(origin, shape))


def _core_box(ext, offset, core_shape):
    return _box([e.start + o for e, o in zip(ext, offset)], core_shape)


def _raw_fits(volume_nbytes, ext_shape, dev) -> bool:
    """Whether the raw volume can stay on the device beside one window's
    working set (always on the CPU)."""
    if dev.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(dev)
    return volume_nbytes + _WINDOW_WORKING_SET * 4 * int(np.prod(ext_shape)) <= free


def _accumulate_vesselness(volume, params, shape, max_chunk_voxels, vessel_dtype, dev):
    """The windowed Frangi cascade into one ``vessel_dtype`` volume on the
    device.  Returns (vessel, bytes_up, n_windows, raw_resident)."""
    sigma_vec = params.sigma_vec(max(params.sigmas))
    halo = tuple(int(np.ceil(params.truncate * float(s))) for s in sigma_vec)
    chunk_shape = compute_chunk_shape(shape, max_chunk_voxels)
    core_shape, ext_shape = uniform_window_shapes(shape, chunk_shape, halo)
    vessel = torch.zeros(shape, dtype=vessel_dtype, device=dev)
    resident = _raw_fits(volume.nbytes, ext_shape, dev)
    if resident:
        logger.info("capacity: the raw volume (%.2f GB) stays on %s; windows are sliced there",
                    volume.nbytes / 1e9, dev)
        raw = torch.from_numpy(np.ascontiguousarray(volume)).to(dev)
        bytes_up = volume.nbytes
    else:
        logger.warning("capacity: the raw volume (%.2f GB) does not fit on %s beside the "
                       "working set; uploading each window from the host", volume.nbytes / 1e9,
                       dev)
        bytes_up = 0
    n_windows = 0
    for owned, ext, offset, local in iter_uniform_windows(shape, chunk_shape, halo):
        n_windows += 1
        if resident:
            window = raw[ext]
        else:
            host = np.ascontiguousarray(volume[ext])
            bytes_up += host.nbytes
            window = torch.from_numpy(host).to(dev)
        v, _ = frangi_k.vesselness_frame(window, params)
        # the whole core, in window order (a later window's core wins)
        vessel[_core_box(ext, offset, core_shape)] = crop_core(v, offset, core_shape).to(
            vessel_dtype)
    return vessel, bytes_up, n_windows, resident


def _threshold(sample, m1o_sample, nbins):
    """The Label threshold over the opening-masked sample (+inf when no
    sample value is positive)."""
    thr, ok = _frangi_threshold_kernel(torch.where(m1o_sample, sample, 0.0), None, 0.0, nbins, 1)
    return thr if ok else torch.tensor(float("inf"), device=sample.device)


def _pack_mask_bits(mask):
    """(uint8 bytes, most significant bit first along the last axis;
    foreground count)."""
    m8 = mask.reshape(mask.shape[:-1] + (-1, 8)).to(torch.uint8)
    weights = torch.tensor([1 << (7 - k) for k in range(8)], dtype=torch.uint8,
                           device=mask.device)
    return (m8 * weights).sum(dim=-1, dtype=torch.uint8), int(mask.sum())


def _segment_from_vessel(vessel, min_area, fill, step, nbins, emit):
    """Finalize and Label over the whole vesselness volume.  The threshold
    histograms read strided samples, and ``vessel * mask > thr`` is taken
    as ``(vessel > thr) & mask`` (equal for thr > 0)."""
    sample = vessel.reshape(-1)[::step].float()
    pct = frangi_k.masked_percentile_forms(sample, sample > 0, 1.0)
    m1o = frangi_k.opening_mask(vessel, pct)
    thr = _threshold(sample, m1o.reshape(-1)[::step], nbins)
    mask = (vessel > thr.to(vessel.dtype)) & m1o
    if fill:
        mask = ccl.fill_holes(mask)
    mask = ccl.remove_small_components(mask, min_area)
    mask = uniform_filter(mask.float(), 3) > 0.5
    if emit == "mask":
        return _pack_mask_bits(mask)
    labels, n = ccl.label(mask)
    if emit == "sparse_labels":
        flat_fg = mask.reshape(-1)
        size = flat_fg.numel()
        cap = size // SPARSE_CAP_DIV
        idx = torch.nonzero(flat_fg).reshape(-1)[:cap]
        idx = torch.cat([idx, idx.new_full((cap - idx.numel(),), size - 1)])
        vals = labels.reshape(-1)[idx].to(torch.int16)  # the uint16 bits
        return (packbits(flat_fg), vals, int(flat_fg.sum())), n
    return labels.to(torch.int16), n


def _assemble_sparse_labels(packed, vals, shape):
    """Dense uint16 labels from the sparse emit; (labels, bytes_down)."""
    packed = packed.cpu().numpy()
    vals = vals.cpu().numpy().view(np.uint16)
    bytes_down = packed.nbytes + vals.nbytes
    idx = np.flatnonzero(np.unpackbits(packed, bitorder="little"))
    labels = np.zeros(int(np.prod(shape)), np.uint16)
    labels[idx] = vals[: len(idx)]
    return labels.reshape(shape), bytes_down


# ---------------------------------------------------------------------------
# chunked strategy: per-cell CCL, merged across the cells on the device
# ---------------------------------------------------------------------------

def _ccl_grid(shape, max_dim=_CCL_CELL_MAX_DIM, max_vox=_CCL_CELL_MAX_VOX):
    """Cut positions per axis of a grid whose cells have at most
    ``max_dim`` voxels per axis and ``max_vox`` in all."""
    counts = [max(1, -(-d // max_dim)) for d in shape]

    def cell(cs):
        return tuple(-(-d // k) for d, k in zip(shape, cs))

    while int(np.prod(cell(counts))) > max_vox:
        counts[int(np.argmax(cell(counts)))] += 1
    return [tuple(int(round(d * i / k)) for i in range(k + 1)) for d, k in zip(shape, counts)]


def _iter_cells(bounds):
    for idx in itertools.product(*(range(len(b) - 1) for b in bounds)):
        origin = tuple(b[i] for b, i in zip(bounds, idx))
        cshape = tuple(b[i + 1] - b[i] for b, i in zip(bounds, idx))
        yield origin, cshape


def _vol_strides(vol_shape):
    return tuple(int(np.prod(vol_shape[i + 1:])) for i in range(len(vol_shape)))


def _local_to_global_flat(flat_local, origin, chunk_shape, vol_shape):
    """Cell-local raveled indices -> volume raveled indices."""
    strides = _vol_strides(vol_shape)
    rem = flat_local
    g = torch.zeros_like(flat_local)
    for ax in range(len(chunk_shape) - 1, 0, -1):
        g = g + (rem % chunk_shape[ax] + origin[ax]) * strides[ax]
        rem = rem // chunk_shape[ax]
    return g + (rem + origin[0]) * strides[0]


def _cell_roots(roots, mask, origin, cshape, vol_shape, invert, connectivity):
    """One cell's components written into the volume's int32 ``roots``:
    each voxel gets its piece's global minimum raveled index, -1 where it
    does not take part."""
    box = _box(origin, cshape)
    m = ~mask[box] if invert else mask[box]
    n_local = int(np.prod(cshape))
    local = ccl.union_find_roots(m, connectivity)
    g = _local_to_global_flat(local, origin, cshape, vol_shape)
    roots[box] = torch.where(local < n_local, g, -1).reshape(cshape).to(torch.int32)


def _merged_roots(mask, shape, bounds, phases, invert, connectivity):
    """The int32 roots of the volume's components (of ``~mask`` with
    ``invert``): each cell's pieces, then the merge across the cells'
    boundaries on the device (``ccl.merge_cell_roots``).  Every member
    holds its component's minimum raveled index, -1 elsewhere."""
    roots = torch.empty(shape, dtype=torch.int32, device=mask.device)
    with phases("cell_roots"):
        for origin, cshape in _iter_cells(bounds):
            _cell_roots(roots, mask, origin, cshape, shape, invert, connectivity)
    with phases("merge"):
        ccl.merge_cell_roots(roots, bounds, connectivity)
    return roots


def _flat_chunks(n):
    """[start, stop) of the steps of a flat pass (its temporaries at most
    ``_FLAT_CHUNK`` entries)."""
    for start in range(0, n, _FLAT_CHUNK):
        yield start, min(n, start + _FLAT_CHUNK)


def _root_index(roots, n):
    """int64 indices of a table by root id: the root, or ``n`` where the
    voxel takes no part."""
    return torch.where(roots >= 0, roots.long(), n)


def _fill_holes_chunked(mask, shape, bounds, phases):
    """scipy ``binary_fill_holes``, in place: background components that do
    not reach the volume's border become foreground.  The merged roots of
    the border faces' background voxels are flagged by root id, and every
    other background voxel is filled."""
    roots = _merged_roots(mask, shape, bounds, phases, invert=True, connectivity="faces")
    n = roots.numel()
    reached = torch.zeros(n + 1, dtype=torch.bool, device=mask.device)
    reached[n] = True  # not background: never filled
    for axis in range(len(shape)):
        for pos in (0, shape[axis] - 1):
            reached[_root_index(roots.select(axis, pos).reshape(-1), n)] = True
    flat, out = roots.view(-1), mask.view(-1)
    for start, stop in _flat_chunks(n):
        out[start:stop] |= ~reached[_root_index(flat[start:stop], n)]


def _remove_small_chunked(mask, shape, bounds, min_size, phases):
    """The area filter as a global pass, in place: each merged component's
    size summed on the device into a table of one entry a component (by
    its root's rank, :func:`_component_roots`), then its voxels dropped
    where the size is below ``min_size``."""
    roots = _merged_roots(mask, shape, bounds, phases, invert=False, connectivity="full")
    flat, out = roots.view(-1), mask.view(-1)
    component_roots, (n_components,) = _component_roots(flat)
    if n_components == 0:
        return
    sizes = torch.zeros(n_components, dtype=torch.int32, device=mask.device)
    for start, stop in _flat_chunks(flat.numel()):
        r = flat[start:stop]
        r = r[r >= 0]  # members only: the others would all add at one entry
        sizes.index_add_(0, torch.searchsorted(component_roots, r, out_int32=True),
                         torch.ones_like(r))
    for start, stop in _flat_chunks(flat.numel()):
        # a non-member (-1) ranks 0: it is background, so what it reads is moot
        rank = torch.searchsorted(component_roots, flat[start:stop], out_int32=True)
        out[start:stop] &= sizes[rank] >= min_size


def _count(flags):
    """How many entries of the flat bool ``flags`` are set, as a 0-dim
    int64 on the device, summed a chunk at a time (a sum over the whole
    volume would first make an int64 copy of it)."""
    total = torch.zeros((), dtype=torch.int64, device=flags.device)
    for start, stop in _flat_chunks(flags.numel()):
        total += flags[start:stop].sum()
    return total


def _listed(flags, count):
    """The int32 positions where the flat bool ``flags`` is set, in raster
    order: each chunk's set positions scattered to their running ranks, the
    unset ones to a spare last entry.  ``count`` is known, so nothing is
    read from the device, and the temporaries are a chunk's
    (``torch.nonzero`` over the whole volume would hold an int64 entry a
    voxel)."""
    dev = flags.device
    out = torch.empty(count + 1, dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.int64, device=dev)
    for start, stop in _flat_chunks(flags.numel()):
        f = flags[start:stop]
        rank = torch.cumsum(f, 0) + done
        out.scatter_(0, torch.where(f, rank - 1, count),
                     torch.arange(start, stop, dtype=torch.int32, device=dev))
        done = rank[-1]
    return out[:count]


def _component_roots(flat, *also_counted):
    """The merged components' roots (the members that are their own root)
    of the flat merged roots, in raster order as int32 on the device, and
    their count with those of the flat bool volumes ``also_counted``, read
    from the device together (one host read).  A root's rank in the list
    plus one is scipy's label of its component."""
    n = flat.numel()
    is_root = torch.empty(n, dtype=torch.bool, device=flat.device)
    ramp = torch.arange(min(n, _FLAT_CHUNK), dtype=torch.int32, device=flat.device)
    for start, stop in _flat_chunks(n):
        torch.eq(flat[start:stop] - start, ramp[:stop - start], out=is_root[start:stop])
    del ramp
    counts = torch.stack([_count(f) for f in (is_root, *also_counted)]).tolist()
    return _listed(is_root, counts[0]), counts


def _label_chunked(mask, shape, bounds, phases):
    """scipy-numbered labels of the merged components, uint16 or int32 past
    65,535: each member's label is its root's rank among the component
    roots plus one (:func:`_component_roots`, which also reads the
    foreground's count).  The host receives the foreground's int32 indices
    and labels, scattered into a zeroed array.  Returns (labels,
    n_components, fg_count, bytes_down)."""
    roots = _merged_roots(mask, shape, bounds, phases, invert=False, connectivity="full")
    flat, fg = roots.view(-1), mask.view(-1)
    component_roots, (n_labels, fg_count) = _component_roots(flat, fg)
    dtype, host_dtype = ((torch.int16, np.uint16) if n_labels <= 0xFFFF
                         else (torch.int32, np.int32))
    idx = _listed(fg, fg_count)
    vals = torch.empty(fg_count, dtype=dtype, device=mask.device)
    for start, stop in _flat_chunks(fg_count):
        rank = torch.searchsorted(component_roots, flat[idx[start:stop].long()], out_int32=True)
        vals[start:stop] = rank + 1
    del roots, flat, component_roots
    with phases("assembly"):  # the product's copy down into its host array
        idx, vals = idx.cpu().numpy(), vals.cpu().numpy().view(host_dtype)
        labels = np.zeros(int(np.prod(shape)), host_dtype)
        labels[idx] = vals
    return labels.reshape(shape), n_labels, fg_count, idx.nbytes + vals.nbytes


def _windowed(shape, halo):
    """The halo windows of the chunked strategy's stencil passes."""
    win_shape = compute_chunk_shape(shape, _CCL_CELL_MAX_VOX)
    core_shape, _ = uniform_window_shapes(shape, win_shape, halo)
    for _, ext, offset, _ in iter_uniform_windows(shape, win_shape, halo):
        yield ext, offset, core_shape


def _segment_chunked(volume, params, min_area, emit, max_chunk_voxels, vessel_dtype,
                     threshold_sampling_pixels, histogram_nbins, dev):
    """The chunked strategy; see the module docstring."""
    shape = volume.shape
    if int(np.prod(shape)) >= 2 ** 31:
        raise ValueError("chunked capacity path supports < 2^31 voxels")
    nd = len(shape)
    phases = _Phases(dev)
    with phases("vesselness"):
        vessel, bytes_up, n_windows, resident = _accumulate_vesselness(
            volume, params, shape, max_chunk_voxels, vessel_dtype, dev)

    with phases("thresholds"):
        step = max(int(np.prod(shape)) // max(1, threshold_sampling_pixels), 1)
        sample = vessel.reshape(-1)[::step].float()
        pct = frangi_k.masked_percentile(sample, sample > 0, 1.0).to(vessel.dtype)
        m1o = torch.zeros(shape, dtype=torch.bool, device=dev)
        for ext, offset, core_shape in _windowed(shape, (2,) * nd):
            m1o[_core_box(ext, offset, core_shape)] = crop_core(
                binary_opening(vessel[ext] > pct), offset, core_shape)
        thr = _threshold(sample, m1o.reshape(-1)[::step], histogram_nbins)
        mask = (vessel > thr.to(vessel.dtype)) & m1o
        del vessel, m1o, sample

    bounds = _ccl_grid(shape)
    if nd == 3:
        with phases("fill_holes"):
            _fill_holes_chunked(mask, shape, bounds, phases)

    if min_area > 1:
        with phases("area_filter"):
            if min_area - 1 <= _WINDOWED_REMOVE_MAX_HALO:
                # with a halo of min_area - 1 a component that leaves the
                # window has at least min_area voxels in it, so each window
                # decides its core exactly; removals only ever take whole
                # small components, so the in-place order does not matter
                for ext, offset, core_shape in _windowed(shape, (min_area - 1,) * nd):
                    kept = ccl.remove_small_components(mask[ext], min_area)
                    mask[_core_box(ext, offset, core_shape)] = crop_core(kept, offset, core_shape)
            else:
                _remove_small_chunked(mask, shape, bounds, min_area, phases)

    with phases("smoothing"):
        smoothed = torch.empty_like(mask)
        for ext, offset, core_shape in _windowed(shape, (1,) * nd):
            sm = uniform_filter(mask[ext].float(), 3) > 0.5
            smoothed[_core_box(ext, offset, core_shape)] = crop_core(sm, offset, core_shape)
        mask = smoothed

    result = {"strategy": "chunked", "bytes_up": bytes_up, "raw_resident": resident,
              "seconds": phases.seconds}
    if emit == "mask":
        packed, fg_count = _pack_mask_bits(mask)
        packed = packed.cpu().numpy()
        result.update(mask_packed=packed, fg_count=fg_count, emit="mask",
                      bytes_down=packed.nbytes)
        logger.info("capacity segment (chunked): %d windows, %.2f GB up, %.2f GB down",
                    n_windows, bytes_up / 1e9, result["bytes_down"] / 1e9)
        return result

    with phases("label"):
        labels, n_labels, fg_count, bytes_down = _label_chunked(mask, shape, bounds, phases)
    if n_labels > 0xFFFF:
        logger.info("capacity segment: %d components exceed uint16; labels widened to int32",
                    n_labels)
    result.update(labels=labels, n_labels=n_labels, fg_count=fg_count, label_overflow=False,
                  emit="sparse_labels", bytes_down=bytes_down)
    logger.info("capacity segment (chunked): %d windows, %.2f GB up, %.2f GB down",
                n_windows, bytes_up / 1e9, result["bytes_down"] / 1e9)
    return result


# ---------------------------------------------------------------------------
# mesh strategy: the monolith over a device mesh
# ---------------------------------------------------------------------------

def _segment_mesh(volume, params, min_area, emit, mesh, max_chunk_voxels, vessel_dtype,
                  threshold_sampling_pixels, histogram_nbins):
    """The monolith (``_segment_from_vessel``) on a volume split over the
    mesh's z group; see the module docstring."""
    from nellie_tpu_torch.mesh import sharded as msh

    shape = volume.shape
    plan = msh.frame_sharding(mesh, shape)
    rest = dict(max_chunk_voxels=max_chunk_voxels, vessel_dtype=vessel_dtype,
                threshold_sampling_pixels=threshold_sampling_pixels,
                histogram_nbins=histogram_nbins)
    if plan.axis is None:
        logger.warning("capacity segment (mesh): no axis of %s divides the mesh z extent %d; "
                       "falling back to the single-device chunked strategy", shape,
                       mesh.shape["z"])
        return _segment_chunked(volume, params, min_area, emit, dev=plan.devices[0], **rest)
    phases = _Phases(plan.devices)
    with phases("vesselness"):
        raw = msh.scatter(volume, plan, torch.float32)
        vessel, _ = msh.vesselness_shards(raw, plan, params)
        vessel = [v.to(vessel_dtype) for v in vessel]
        del raw
    with phases("segment"):
        step = max(int(np.prod(shape)) // max(1, threshold_sampling_pixels), 1)
        sample = msh.gather_flat_strided(vessel, plan, step).float()
        pct = frangi_k.masked_percentile_forms(sample, sample > 0, 1.0)
        m1o = msh.halo_map(lambda v: frangi_k.opening_mask(v, pct.to(v.device)), vessel, plan, 2)
        thr = _threshold(sample, msh.gather_flat_strided(m1o, plan, step), histogram_nbins)
        mask = [(v > thr.to(v.device).to(v.dtype)) & m for v, m in zip(vessel, m1o)]
        del vessel, m1o
        mask = msh.clean_mask(mask, plan, min_area, volume.ndim == 3)
        labels, count = (None, 0) if emit == "mask" else msh.cells.label(mask, plan)
    result = {"strategy": "mesh", "n_devices": int(mesh.devices.size), "bytes_up": volume.nbytes,
              "raw_resident": True, "seconds": phases.seconds}
    if emit == "mask":
        host = msh.gather(mask, plan, torch.device("cpu")).numpy()
        packed = np.packbits(host, axis=-1)
        result.update(mask_packed=packed, fg_count=int(host.sum()), emit="mask",
                      bytes_down=packed.nbytes)
        return result
    if count > 0xFFFF:
        logger.warning("capacity segment (mesh): %d components exceed the uint16 emit; "
                       "re-running through the single-device chunked strategy", count)
        return _segment_chunked(volume, params, min_area, emit, dev=plan.devices[0], **rest)
    host = msh.gather(labels, plan, torch.device("cpu")).numpy().astype(np.uint16)
    fg_count = int(np.count_nonzero(host))
    if emit == "sparse_labels":
        cap = int(np.prod(shape)) // SPARSE_CAP_DIV
        if fg_count > cap:
            logger.warning("capacity segment (mesh): %d foreground voxels exceed the sparse "
                           "capacity %d; falling back to dense labels", fg_count, cap)
            emit = "labels"
    bytes_down = (host.nbytes if emit == "labels"
                  else -(-host.size // 8) + 2 * (int(np.prod(shape)) // SPARSE_CAP_DIV))
    result.update(labels=host, n_labels=count, fg_count=fg_count, label_overflow=False,
                  emit=emit, bytes_down=bytes_down)
    logger.info("capacity segment (mesh, %d shards): %.2f GB up, %.2f GB down", plan.n,
                volume.nbytes / 1e9, bytes_down / 1e9)
    return result


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def segment_path(filepath, emit: str = "sparse_labels", min_area: int = 4, output_dir=None,
                 write_labels: bool = True, device="cuda", **kwargs):
    """Segment the one 2D or 3D volume of an image file (a singleton T axis
    is dropped) and, with ``write_labels``, write its int32
    ``im_instance_label`` artifact through the port's ``ImInfo``.  Extra
    keyword arguments go to :func:`segment_volume` (``sigmas`` to the
    Frangi parameters)."""
    from nellie_tpu_torch.io import FileInfo, ImInfo

    fi = FileInfo(str(filepath), output_dir=output_dir)
    fi.find_metadata()
    fi.load_metadata()
    im_info = ImInfo(fi)
    volume = np.asarray(im_info.get_memmap(im_info.im_path))
    while volume.ndim > 3 and volume.shape[0] == 1:
        volume = volume[0]
    if volume.ndim not in (2, 3):
        raise ValueError(f"capacity path expects one 2D/3D volume, got shape {volume.shape}; "
                         "use pipeline.run for time series")
    res = im_info.dim_res
    spacing = ((res["Y"], res["X"]) if volume.ndim == 2 else (res["Z"], res["Y"], res["X"]))
    params = frangi_k.FrangiParams(
        sigmas=tuple(kwargs.pop("sigmas", (0.75, 1.1, 1.6))), spacing=spacing,
        z_ratio=1.0 if volume.ndim == 2 else (res["Z"] / res["X"] or 1.0))
    out = segment_volume(volume, params, min_area=min_area, emit=emit, device=device, **kwargs)
    if out.get("label_overflow"):
        raise RuntimeError(f"{out['n_labels']} components exceed the capacity path's uint16 "
                           "label emit; run the standard Filter+Label pipeline")
    if write_labels and "labels" in out:
        im_info.allocate_memory(
            im_info.pipeline_paths["im_instance_label"], dtype="int32",
            data=out["labels"].astype(np.int32), description="instance segmentation (capacity path)")
        out["im_info"] = im_info
    return out


def segment_volume(volume: np.ndarray, params: frangi_k.FrangiParams, min_area: int = 4,
                   emit: str = "labels", max_chunk_voxels: int = int(3.2e7),
                   vessel_dtype=torch.float16, threshold_sampling_pixels: int = 1_000_000,
                   histogram_nbins: int = 256, strategy: str = "auto",
                   monolith_max_voxels: int = int(4.0e7), mesh=None, device="cuda"):
    """Segment one large (Z, Y, X) or (Y, X) volume on ``device``.

    Returns a dict: the product (``labels``, uint16 or int32 past 65,535
    components, or the bit-packed ``mask_packed``), ``n_labels``,
    ``fg_count`` where the reference gives it, ``strategy``, ``emit`` (what
    produced the result), ``bytes_up``/``bytes_down``, ``raw_resident`` and
    the phase ``seconds``.  ``strategy``: ``"monolith"``, ``"chunked"`` or
    ``"auto"`` (chunked above ``monolith_max_voxels``).  The last axis must
    be a multiple of 8 for ``emit="mask"``.  ``mesh``: a
    :class:`nellie_tpu_torch.mesh.Mesh` of more than one device runs the
    mesh strategy instead (``strategy`` and ``device`` are then unused)."""
    if strategy not in ("auto", "monolith", "chunked"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if mesh is not None and mesh.devices.size > 1:
        return _segment_mesh(np.asarray(volume), params, min_area, emit, mesh,
                             max_chunk_voxels, vessel_dtype, threshold_sampling_pixels,
                             histogram_nbins)
    dev = resolve_device(device)
    volume = np.asarray(volume)
    shape = volume.shape
    rest = dict(max_chunk_voxels=max_chunk_voxels, vessel_dtype=vessel_dtype,
                threshold_sampling_pixels=threshold_sampling_pixels,
                histogram_nbins=histogram_nbins)
    if strategy == "chunked" or (strategy == "auto" and int(np.prod(shape)) > monolith_max_voxels):
        return _segment_chunked(volume, params, min_area, emit, dev=dev, **rest)

    phases = _Phases(dev)
    with phases("vesselness"):
        vessel, bytes_up, n_windows, resident = _accumulate_vesselness(
            volume, params, shape, max_chunk_voxels, vessel_dtype, dev)
    with phases("segment"):
        step = max(int(np.prod(shape)) // max(1, threshold_sampling_pixels), 1)
        out, count = _segment_from_vessel(vessel, min_area, volume.ndim == 3, step,
                                          histogram_nbins, emit)
        del vessel
    result = {"strategy": "monolith", "bytes_up": bytes_up, "raw_resident": resident,
              "seconds": phases.seconds}
    if emit != "mask" and count > 0xFFFF:
        # a uint16 emit cannot hold the labels: the chunked strategy
        # assembles int32 labels on the host (one more upload)
        logger.warning("capacity segment: %d components exceed the monolith's uint16 emit; "
                       "re-running through the chunked strategy", count)
        return _segment_chunked(volume, params, min_area, emit, dev=dev, **rest)
    if emit == "sparse_labels":
        packed, vals, fg_count = out
        cap = int(np.prod(shape)) // SPARSE_CAP_DIV
        if fg_count > cap:
            logger.warning("capacity segment: %d foreground voxels exceed the sparse capacity "
                           "%d; falling back to dense labels", fg_count, cap)
            return segment_volume(volume, params, min_area=min_area, emit="labels",
                                  strategy="monolith", device=dev, **rest)
        labels, bytes_down = _assemble_sparse_labels(packed, vals, shape)
        result.update(labels=labels, n_labels=count, fg_count=fg_count, label_overflow=False,
                      emit="sparse_labels", bytes_down=bytes_down)
    elif emit == "mask":
        packed = out.cpu().numpy()
        result.update(mask_packed=packed, fg_count=count, emit="mask", bytes_down=packed.nbytes)
    else:
        labels = out.cpu().numpy().view(np.uint16)
        result.update(labels=labels, n_labels=count, label_overflow=False, emit="labels",
                      bytes_down=labels.nbytes)
    logger.info("capacity segment: %d windows, %.2f GB up, %.2f GB down", n_windows,
                bytes_up / 1e9, result["bytes_down"] / 1e9)
    return result
