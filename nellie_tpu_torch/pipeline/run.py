"""Main entry point of the port.

``run`` drives Filter -> Label -> Network -> Markers -> HuMomentTracking
-> VoxelReassigner -> Hierarchy as the JAX package's ``run`` does
(``nellie_tpu/pipeline/run.py:114-118``, ``:164-229``): by default the
first four stages run as the fused chain
(:mod:`nellie_tpu_torch.pipeline.fused`, timed as ``seg_fused``), which
leaves each frame's tensors on the device for tracking and the Hierarchy;
in low-memory mode, or with ``fused=False``, stage by stage through the
on-disk artifact store.  Either way the artifacts, the feature CSVs and
``adjacency_maps.pkl`` have the reference's names, dtypes and layout.

``run_path`` opens a file and runs it; the batch CLI
(:mod:`nellie_tpu_torch.pipeline.cli`) calls it per file.

Not ported: the compile warmer and the XLA compile cache, the fused
chain's "accelerator unavailable" retry, the mesh paths and the
mesh-batched multi-file runs (``pipeline/batch.py``); ``run`` therefore has
no ``mesh`` or ``warm_start`` argument.
"""
from __future__ import annotations

import time

import torch

from nellie_tpu_torch import config as cfg_mod
from nellie_tpu_torch.io import FileInfo, ImInfo
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.pipeline.fused import FusedSegmentation
from nellie_tpu_torch.stages.filtering import Filter
from nellie_tpu_torch.stages.hierarchical import Hierarchy
from nellie_tpu_torch.stages.hu_tracking import HuMomentTracking
from nellie_tpu_torch.stages.labelling import Label
from nellie_tpu_torch.stages.mocap_marking import Markers
from nellie_tpu_torch.stages.networking import Network
from nellie_tpu_torch.stages.voxel_reassignment import VoxelReassigner
from nellie_tpu_torch.utils import adaptive_run
from nellie_tpu_torch.utils.device_cache import frame_cache
from nellie_tpu_torch.utils.logger import logger

# config keys that change no artifact: the device (``run`` takes one for
# every stage), how often Label flushes, a GPU preference of the reference
# and three bounds that the JAX stages store but never read
_DROPPED = {
    "device", "flush_interval", "prefer_gpu", "max_dense_roi_voxels_cpu",
    "max_dense_roi_voxels_gpu", "max_query_points", "max_bruteforce_pairs",
}


def _port_kwargs(params: dict) -> dict:
    return {k: v for k, v in params.items() if k not in _DROPPED}


def params_from_config(cfg) -> dict:
    """Per-stage constructor kwargs of the port from a
    :class:`nellie_tpu_torch.config.SettingsConfig` (or its dict or JSON
    path), plus the ``remove_edges``, ``voxel_reassign`` and
    ``remove_intermediates`` toggles."""
    if isinstance(cfg, str):
        cfg = cfg_mod.SettingsConfig.load(cfg)
    elif isinstance(cfg, dict):
        cfg = cfg_mod.SettingsConfig.from_dict(cfg)
    f_kw = cfg_mod.preprocessing_params(cfg)
    f_kw["remove_edges"] = cfg.remove_edges
    h_kw = _port_kwargs(cfg_mod.feature_params(cfg))
    h_kw.pop("use_gpu")
    # feature_params names skip_nodes only when the config asks for node
    # analysis; otherwise the Hierarchy's own default (True) applies, as in
    # the JAX package's run()
    h_kw.setdefault("skip_nodes", True)
    return {
        "filter": _port_kwargs(f_kw),
        "label": _port_kwargs(cfg_mod.segmentation_label_params(cfg)),
        "network": _port_kwargs(cfg_mod.segmentation_network_params(cfg)),
        "markers": _port_kwargs(cfg_mod.mocap_params(cfg)),
        "tracking": _port_kwargs(cfg_mod.tracking_params(cfg)),
        "reassign": _port_kwargs(cfg_mod.reassign_params(cfg)),
        "hierarchy": h_kw,
        "voxel_reassign": cfg.voxel_reassign,
        "remove_intermediates": cfg.remove_intermediates,
    }


def run(file_info, remove_edges=False, otsu_thresh_intensity=False, threshold=None,
        timeit=False, device="cuda", skip_nodes=False, return_timings=False, config=None,
        low_memory=False, fused=True):
    """Run the seven stages on a prepared :class:`FileInfo`.

    ``device`` is ``"cuda"`` (raises without a GPU) or ``"cpu"``; nothing
    falls back from one to the other.  ``fused``: Filter, Label, Network
    and Markers run as one frame loop with the intermediates on the device
    (the artifacts are those of ``fused=False``, bit for bit); it is not
    used in low-memory mode, and running out of device memory in it falls
    back to the per-stage path on the same device.  ``low_memory``:
    Filter, Label, HuMomentTracking and Hierarchy start in their
    low-memory mode, as the JAX package's ``run`` passes it; every stage
    of the per-stage path also enters it on its own when a frame looks too
    large, or after running out of memory
    (:mod:`nellie_tpu_torch.utils.adaptive_run`).  ``config``: a
    ``SettingsConfig`` (or dict, or JSON path) driving every stage's
    kwargs, its per-stage ``*_low_memory`` flags included (Filter's,
    Label's, Network's or Markers' select the per-stage path); the
    convenience arguments above are then ignored.  Returns the
    :class:`ImInfo`, and the seconds by stage (``seg_fused`` for the fused
    chain) when ``return_timings``.
    """
    dev = resolve_device(device)
    im_info = ImInfo(file_info)
    if config is not None:
        kw = params_from_config(config)
    else:
        low = {"low_memory": bool(low_memory)}
        kw = {
            "filter": {"remove_edges": remove_edges, **low},
            "label": {"otsu_thresh_intensity": otsu_thresh_intensity, "threshold": threshold,
                      **low},
            "network": {}, "markers": {}, "tracking": dict(low), "reassign": {},
            "hierarchy": {"skip_nodes": skip_nodes, **low},
            "voxel_reassign": True, "remove_intermediates": False,
        }
    timings = {}

    def timed(name, stage):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        start = time.perf_counter()
        stage.run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings[name] = time.perf_counter() - start

    segmentation = ("filter", "label", "network", "markers")
    use_fused = fused and not any(kw[k].get("low_memory") for k in segmentation)
    if use_fused:
        seg = FusedSegmentation(
            im_info, device=dev, cache_frames=not im_info.no_t,
            filter_kwargs=kw["filter"], label_kwargs=kw["label"],
            network_kwargs=kw["network"], markers_kwargs=kw["markers"])
        try:
            timed("seg_fused", seg)
        except adaptive_run.OOM_ERRORS as exc:
            logger.warning("Fused segmentation ran out of memory (%r); running the stages one "
                           "by one on %s.", exc, dev)
            cache = frame_cache(im_info)
            if cache is not None:
                cache.clear()
            use_fused = False
    if not use_fused:
        timed("filter", Filter(im_info, device=dev, **kw["filter"]))
        timed("label", Label(im_info, device=dev, **kw["label"]))
        timed("network", Network(im_info, device=dev, **kw["network"]))
        timed("markers", Markers(im_info, device=dev, **kw["markers"]))
    timed("tracking", HuMomentTracking(im_info, device=dev, **kw["tracking"]))
    if kw["voxel_reassign"]:
        timed("reassign", VoxelReassigner(im_info, device=dev, **kw["reassign"]))
    timed("hierarchy", Hierarchy(im_info, device=dev, **kw["hierarchy"]))
    cache = frame_cache(im_info)
    if cache is not None:
        cache.clear()
    if kw["remove_intermediates"]:
        im_info.remove_intermediates()
    timings["total"] = sum(timings.values())
    if timeit:
        for name, seconds in timings.items():
            print(f"Nellie port: {name} took {seconds:.4f} seconds")
    if return_timings:
        return im_info, timings
    return im_info


def run_path(filepath, ch: int = 0, t_start: int = 0, t_end=None, output_dir=None,
             device="cuda", **kwargs):
    """Open ``filepath`` (metadata detected from the file, the channel and
    time range selected) and :func:`run` it on ``device``; raises
    ``ValueError`` when the metadata is incomplete."""
    file_info = FileInfo(filepath, output_dir=output_dir)
    file_info.find_metadata()
    file_info.load_metadata()
    if ch and "C" in (file_info.axes or ""):
        file_info.change_selected_channel(ch)
    if (t_start or t_end is not None) and "T" in (file_info.axes or ""):
        file_info.select_temporal_range(t_start, t_end)
    errors = file_info.get_validation_errors()
    if errors:
        raise ValueError(f"Metadata incomplete for {filepath}: {errors}. "
                         "Fix axes/resolutions via FileInfo before running.")
    return run(file_info, device=device, **kwargs)
