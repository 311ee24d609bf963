"""Multi-file data parallelism: the mesh's t rows take frames drawn from a
whole batch of files.

Port of ``nellie_tpu/pipeline/batch.py``.  When every file of the batch
has the same shape, axes and resolutions (``_compatible``), Filter, Label,
Network and Markers run over the combined (file, t) frame stream in
groups of the mesh's t extent (:mod:`nellie_tpu_torch.mesh.sharded`'s
batched kernels: frame i of a group on t row i, Filter and Label split
over the row's z group).  Tracking, the reassigner and the Hierarchy,
sequential in t within a file, run file-parallel: file i on the mesh's
device i mod n, from a thread pool.  Every file's artifacts equal its own
``run()``'s.
"""
from __future__ import annotations

import time

import numpy as np

from nellie_tpu_torch.io import ImInfo
from nellie_tpu_torch.stages.filtering import Filter
from nellie_tpu_torch.stages.hierarchical import Hierarchy
from nellie_tpu_torch.stages.hu_tracking import HuMomentTracking
from nellie_tpu_torch.stages.labelling import Label
from nellie_tpu_torch.stages.mocap_marking import Markers
from nellie_tpu_torch.stages.networking import Network
from nellie_tpu_torch.stages.voxel_reassignment import VoxelReassigner
from nellie_tpu_torch.utils.logger import logger


def _compatible(im_infos) -> bool:
    first = im_infos[0]
    key = (tuple(first.shape), first.axes,
           tuple(sorted((k, v) for k, v in first.dim_res.items() if v)))
    return all(
        (tuple(im.shape), im.axes,
         tuple(sorted((k, v) for k, v in im.dim_res.items() if v))) == key
        for im in im_infos[1:])


def _frame_stream(stage_objs):
    """(stage index, t) pairs across all files, file-major."""
    for i, s in enumerate(stage_objs):
        for t in range(s.num_t):
            yield i, t


def _groups(stage_objs, tb):
    work = list(_frame_stream(stage_objs))
    for start in range(0, len(work), tb):
        yield work[start:start + tb]


def _segment_files_batched(im_infos, mesh, filter_kwargs, label_kwargs):
    """Filter, then Label, across files, frames grouped over the t rows."""
    from nellie_tpu_torch.mesh.sharded import batched_filter_kernel, batched_label_kernel

    tb = int(mesh.shape["t"])
    dev = mesh.flat()[0]
    filters = [Filter(im, device=dev, mesh=mesh, **filter_kwargs) for im in im_infos]
    for f in filters:
        f.low_memory = False
        f._get_t()
        f._allocate_memory()
        f._set_default_sigmas()
    f0 = filters[0]
    for group in _groups(filters, tb):
        out = batched_filter_kernel([np.asarray(filters[i].im_memmap[t]) for i, t in group],
                                    f0._params, True, f0.max_threshold_samples, f0.remove_edges,
                                    mesh)
        for (i, t), frame in zip(group, out):
            filters[i]._write_frame(t, frame)

    labels = [Label(im, device=dev, mesh=mesh, **label_kwargs) for im in im_infos]
    for lb in labels:
        lb._set_low_memory(False)
        lb._get_t()
        lb._allocate_memory()
    l0 = labels[0]
    use_intensity = l0.otsu_thresh_intensity or l0.threshold is not None
    fill = not im_infos[0].no_z
    for group in _groups(labels, tb):
        it_b, ft_b = [], []
        for i, t in group:
            it, ft = labels[i]._compute_frame_thresholds(labels[i].im_memmap[t],
                                                         labels[i].frangi_memmap[t])
            it_b.append(0.0 if it is None else it)
            ft_b.append(ft)
        out = batched_label_kernel(
            [np.asarray(labels[i].frangi_memmap[t]) for i, t in group],
            [np.asarray(labels[i].im_memmap[t]) for i, t in group],
            it_b, ft_b, [ft is not None for ft in ft_b], l0.min_area_pixels, fill,
            use_intensity, mesh)
        for (i, t), lab in zip(group, out):
            labels[i]._write_frame(t, lab.cpu().numpy())


def _network_markers_files_batched(im_infos, mesh):
    """Network, then Markers, across files, each frame whole on its t row's
    first device."""
    from nellie_tpu_torch.mesh.sharded import batched_markers_kernel, batched_network_kernel

    tb = int(mesh.shape["t"])
    dev = mesh.flat()[0]
    networks = [Network(im, device=dev) for im in im_infos]
    for nw in networks:
        nw._get_t()
        nw._allocate_memory()
    for group in _groups(networks, tb):
        out = batched_network_kernel(
            [np.asarray(networks[i].label_memmap[t], np.int32) for i, t in group],
            [np.asarray(networks[i].im_frangi_memmap[t], np.float32) for i, t in group],
            networks[0], mesh)
        for (i, t), arts in zip(group, out):
            networks[i]._write_frame(t, *arts)

    markers = [Markers(im, device=dev) for im in im_infos]
    for mk in markers:
        mk.low_memory = False
        mk._allocate_memory()
        mk._set_default_sigmas()
    for group in _groups(markers, tb):
        out = batched_markers_kernel(
            [np.asarray(markers[i].im_memmap[t]) for i, t in group],
            [np.asarray(markers[i].label_memmap[t]) for i, t in group], markers[0], mesh)
        for (i, t), arts in zip(group, out):
            markers[i]._write_frame(t, *(a.cpu().numpy() for a in arts))


def _per_file_stages_parallel(im_infos, mesh, skip_nodes):
    """Tracking, the reassigner and the Hierarchy, file i on the mesh's
    device i mod n, from a thread pool (``batch.py:225-253``)."""
    from nellie_tpu_torch.mesh.sharded import thread_pool

    devs = mesh.flat()

    def one(i):
        im_info, dev = im_infos[i], devs[i % len(devs)]
        HuMomentTracking(im_info, device=dev).run()
        VoxelReassigner(im_info, device=dev).run()
        Hierarchy(im_info, skip_nodes=skip_nodes, device=dev).run()

    workers = max(1, min(len(devs), len(im_infos)))
    logger.info("Batch: stages 5-7 file-parallel over %d devices (%d files)", workers,
                len(im_infos))
    with thread_pool(workers, devs) as ex:
        list(ex.map(one, range(len(im_infos))))


def run_files(file_infos, mesh=None, remove_edges=False, otsu_thresh_intensity=False,
              threshold=None, device="cuda", low_memory=False, skip_nodes=False, timeit=False):
    """Run the pipeline over a batch of prepared :class:`FileInfo`s.

    With a mesh of t extent above 1, more than one file, no low-memory mode
    and files of one shape, axes and resolutions, the segmentation stages
    run over the whole (file, t) frame stream and the later stages
    file-parallel; otherwise each file goes through :func:`run` (with the
    mesh).  Returns the list of :class:`ImInfo`s.
    """
    from nellie_tpu_torch.pipeline.run import run

    im_infos = [ImInfo(fi) for fi in file_infos]
    batched = (mesh is not None and int(mesh.shape.get("t", 1)) > 1 and len(im_infos) > 1
               and not low_memory and _compatible(im_infos))
    if not batched:
        for fi in file_infos:
            run(fi, remove_edges=remove_edges, otsu_thresh_intensity=otsu_thresh_intensity,
                threshold=threshold, device=device, low_memory=low_memory,
                skip_nodes=skip_nodes, mesh=mesh, timeit=timeit)
        return im_infos

    logger.info("Batch: %d files data-parallel over %r", len(im_infos), mesh)
    timings = {}

    def timed(name, fn):
        start = time.perf_counter()
        fn()
        timings[name] = time.perf_counter() - start

    timed("segment (batched Filter+Label)", lambda: _segment_files_batched(
        im_infos, mesh, filter_kwargs={"remove_edges": remove_edges},
        label_kwargs={"otsu_thresh_intensity": otsu_thresh_intensity,
                      "threshold": threshold}))
    timed("network+markers (batched)", lambda: _network_markers_files_batched(im_infos, mesh))
    timed("stages 5-7 (file-parallel)", lambda: _per_file_stages_parallel(
        im_infos, mesh, skip_nodes))
    if timeit:
        for name, secs in timings.items():
            print(f"Nellie port batch: {name} took {secs:.4f} seconds")
        print(f"Nellie port batch: total took {sum(timings.values()):.4f} seconds")
    return im_infos
