"""Main entry point of the port.

``run`` drives Filter -> Label -> Network -> Markers -> HuMomentTracking
-> VoxelReassigner -> Hierarchy through the on-disk artifact store, in the
order of the JAX package's per-stage branch
(``nellie_tpu/pipeline/run.py:202-229``), so artifacts, the feature CSVs
and ``adjacency_maps.pkl`` have the reference's names, dtypes and layout.

Not ported: the fused segmentation chain and its fallback
(``run.py:184-201``), the compile warmer and the XLA compile cache, the
mesh paths, the low-memory ladder, the CLI and batch runs.
"""
from __future__ import annotations

import time

import torch

from nellie_tpu_torch import config as cfg_mod
from nellie_tpu_torch.io import ImInfo
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.stages.filtering import Filter
from nellie_tpu_torch.stages.hierarchical import Hierarchy
from nellie_tpu_torch.stages.hu_tracking import HuMomentTracking
from nellie_tpu_torch.stages.labelling import Label
from nellie_tpu_torch.stages.mocap_marking import Markers
from nellie_tpu_torch.stages.networking import Network
from nellie_tpu_torch.stages.voxel_reassignment import VoxelReassigner

# config keys that only steer the JAX package's device choice, chunking,
# tiling or host fallbacks; the artifacts do not depend on them
_DROPPED = {
    "device", "max_chunk_voxels", "chunk_z", "flush_interval", "prefer_gpu", "mode",
    "max_dense_pairs", "max_dense_roi_voxels_cpu", "max_dense_roi_voxels_gpu",
    "max_refine_iterations", "max_query_points", "max_bruteforce_pairs",
}


def _port_kwargs(stage: str, params: dict) -> dict:
    if params.get("low_memory"):
        raise NotImplementedError(f"{stage}: low_memory=True is not ported")
    return {k: v for k, v in params.items() if k not in _DROPPED and k != "low_memory"}


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
    h_kw = _port_kwargs("Hierarchy", cfg_mod.feature_params(cfg))
    h_kw.pop("use_gpu")
    # feature_params names skip_nodes only when the config asks for node
    # analysis; otherwise the Hierarchy's own default (True) applies, as in
    # the JAX package's run()
    h_kw.setdefault("skip_nodes", True)
    return {
        "filter": _port_kwargs("Filter", f_kw),
        "label": _port_kwargs("Label", cfg_mod.segmentation_label_params(cfg)),
        "network": _port_kwargs("Network", cfg_mod.segmentation_network_params(cfg)),
        "markers": _port_kwargs("Markers", cfg_mod.mocap_params(cfg)),
        "tracking": _port_kwargs("HuMomentTracking", cfg_mod.tracking_params(cfg)),
        "reassign": _port_kwargs("VoxelReassigner", cfg_mod.reassign_params(cfg)),
        "hierarchy": h_kw,
        "voxel_reassign": cfg.voxel_reassign,
        "remove_intermediates": cfg.remove_intermediates,
    }


def run(file_info, remove_edges=False, otsu_thresh_intensity=False, threshold=None,
        timeit=False, device="cuda", skip_nodes=False, return_timings=False, config=None):
    """Run the seven stages on a prepared :class:`FileInfo`.

    ``device`` is ``"cuda"`` (raises without a GPU) or ``"cpu"``; nothing
    falls back from one to the other.  ``config``: a ``SettingsConfig``
    (or dict, or JSON path) driving every stage's kwargs; the convenience
    arguments above are then ignored.  Returns the :class:`ImInfo`, and
    the per-stage seconds when ``return_timings``.
    """
    dev = resolve_device(device)
    im_info = ImInfo(file_info)
    if config is not None:
        kw = params_from_config(config)
    else:
        kw = {
            "filter": {"remove_edges": remove_edges},
            "label": {"otsu_thresh_intensity": otsu_thresh_intensity, "threshold": threshold},
            "network": {}, "markers": {}, "tracking": {}, "reassign": {},
            "hierarchy": {"skip_nodes": skip_nodes},
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

    timed("filter", Filter(im_info, device=dev, **kw["filter"]))
    timed("label", Label(im_info, device=dev, **kw["label"]))
    timed("network", Network(im_info, device=dev, **kw["network"]))
    timed("markers", Markers(im_info, device=dev, **kw["markers"]))
    timed("tracking", HuMomentTracking(im_info, device=dev, **kw["tracking"]))
    if kw["voxel_reassign"]:
        timed("reassign", VoxelReassigner(im_info, device=dev, **kw["reassign"]))
    timed("hierarchy", Hierarchy(im_info, device=dev, **kw["hierarchy"]))
    if kw["remove_intermediates"]:
        im_info.remove_intermediates()
    timings["total"] = sum(timings.values())
    if timeit:
        for name, seconds in timings.items():
            print(f"Nellie port: {name} took {seconds:.4f} seconds")
    if return_timings:
        return im_info, timings
    return im_info
