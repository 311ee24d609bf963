"""Typed configuration of the pipeline: the port's copy of what
``nellie_tpu/plugin/config.py`` gives its ``run()``.

``SettingsConfig`` holds the Settings tree's values (the original Nellie's
``nellie_napari/nellie_settings.py``); the ``*_params`` functions turn it
into each stage's constructor kwargs, as in the JAX package.  Nothing of
the GUI.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional


@dataclass
class SettingsConfig:
    """Structured pipeline + visualisation settings (reference parity)."""

    # basic
    remove_edges: bool = False
    remove_intermediates: bool = False
    voxel_reassign: bool = True
    analyze_node_level: bool = False
    track_all_frames: bool = True
    subsample_voxels: bool = False
    skip_vox: int = 5

    # preprocessing (Filter)
    preprocessing_num_t: Optional[int] = None
    preprocessing_min_radius_um: float = 0.25
    preprocessing_max_radius_um: float = 1.0
    preprocessing_alpha_sq: float = 0.5
    preprocessing_beta_sq: float = 0.5
    preprocessing_frob_thresh: Optional[float] = None
    preprocessing_frob_thresh_division: int = 2
    preprocessing_device: str = "auto"
    preprocessing_low_memory: bool = False
    preprocessing_max_chunk_voxels: int = int(1e6)
    preprocessing_max_threshold_samples: int = int(1e6)
    # "float16" halves the Frangi cascade's HBM traffic (storage only;
    # math stays float32 — thresholded mask parity ~exact, response
    # values ~1e-3 relative). Default float32 keeps oracle exactness.
    preprocessing_carry_dtype: str = "float32"

    # segmentation (Label)
    segmentation_label_num_t: Optional[int] = None
    segmentation_label_threshold: Optional[float] = None
    segmentation_label_otsu_thresh_intensity: bool = False
    segmentation_label_chunk_z: Optional[int] = None
    segmentation_label_flush_interval: int = 1
    segmentation_label_min_radius_um: float = 0.25
    segmentation_label_threshold_sampling_pixels: int = 1_000_000
    segmentation_label_histogram_nbins: int = 256
    segmentation_label_device: str = "auto"
    segmentation_label_low_memory: bool = False
    segmentation_label_max_chunk_voxels: int = int(1e6)

    # segmentation (Network)
    segmentation_network_num_t: Optional[int] = None
    segmentation_network_min_radius_um: float = 0.20
    segmentation_network_max_radius_um: float = 1.0
    segmentation_network_device: str = "auto"
    segmentation_network_low_memory: bool = False
    segmentation_network_max_chunk_voxels: int = int(1e6)

    # mocap (Markers)
    mocap_num_t: Optional[int] = None
    mocap_min_radius_um: float = 0.20
    mocap_max_radius_um: float = 1.0
    mocap_use_im: str = "distance"
    mocap_num_sigma: int = 5
    mocap_prefer_gpu: bool = True
    mocap_peak_min_distance: int = 2
    mocap_device: str = "auto"
    mocap_low_memory: bool = False
    mocap_max_chunk_voxels: int = int(1e6)

    # tracking (HuMomentTracking)
    tracking_num_t: Optional[int] = None
    tracking_max_distance_um: float = 1.0
    tracking_device: str = "auto"
    tracking_mode: str = "auto"
    tracking_max_dense_pairs: int = int(1e7)
    tracking_max_dense_roi_voxels_cpu: int = int(5e7)
    tracking_max_dense_roi_voxels_gpu: int = int(2e7)
    tracking_low_memory: bool = False

    # reassign (VoxelReassigner)
    reassign_num_t: Optional[int] = None
    reassign_store_running_matches: bool = True
    reassign_max_refine_iterations: int = 3
    reassign_device: str = "auto"
    reassign_low_memory: bool = False
    reassign_max_query_points: int = int(1e6)
    reassign_max_bruteforce_pairs: int = int(4e7)

    # feature extraction (Hierarchy)
    feature_skip_nodes: Optional[bool] = None
    feature_use_gpu: bool = True
    feature_low_memory: bool = False
    feature_enable_motility: bool = True
    feature_enable_adjacency: bool = True
    feature_device: str = "auto"
    feature_node_chunk_size: Optional[int] = None
    feature_max_node_mask_elems: int = int(5e7)

    # -- serialisation ---------------------------------------------------------
    @classmethod
    def from_dict(cls, data: dict) -> "SettingsConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in fields})

    @classmethod
    def from_json(cls, text: str) -> "SettingsConfig":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str) -> "SettingsConfig":
        with open(path) as f:
            return cls.from_json(f.read())


def _prune_none(params: dict) -> dict:
    return {k: v for k, v in params.items() if v is not None}


def preprocessing_params(cfg: SettingsConfig) -> dict:
    return _prune_none({
        "num_t": cfg.preprocessing_num_t,
        "min_radius_um": cfg.preprocessing_min_radius_um,
        "max_radius_um": cfg.preprocessing_max_radius_um,
        "alpha_sq": cfg.preprocessing_alpha_sq,
        "beta_sq": cfg.preprocessing_beta_sq,
        "frob_thresh": cfg.preprocessing_frob_thresh,
        "frob_thresh_division": cfg.preprocessing_frob_thresh_division,
        "device": cfg.preprocessing_device,
        "low_memory": cfg.preprocessing_low_memory,
        "max_chunk_voxels": cfg.preprocessing_max_chunk_voxels,
        "max_threshold_samples": cfg.preprocessing_max_threshold_samples,
        "carry_dtype": cfg.preprocessing_carry_dtype,
    })


def segmentation_label_params(cfg: SettingsConfig) -> dict:
    return _prune_none({
        "num_t": cfg.segmentation_label_num_t,
        "threshold": cfg.segmentation_label_threshold,
        "otsu_thresh_intensity": cfg.segmentation_label_otsu_thresh_intensity,
        "chunk_z": cfg.segmentation_label_chunk_z,
        "flush_interval": cfg.segmentation_label_flush_interval,
        "min_radius_um": cfg.segmentation_label_min_radius_um,
        "threshold_sampling_pixels": cfg.segmentation_label_threshold_sampling_pixels,
        "histogram_nbins": cfg.segmentation_label_histogram_nbins,
        "device": cfg.segmentation_label_device,
        "low_memory": cfg.segmentation_label_low_memory,
        "max_chunk_voxels": cfg.segmentation_label_max_chunk_voxels,
    })


def segmentation_network_params(cfg: SettingsConfig) -> dict:
    return _prune_none({
        "num_t": cfg.segmentation_network_num_t,
        "min_radius_um": cfg.segmentation_network_min_radius_um,
        "max_radius_um": cfg.segmentation_network_max_radius_um,
        "device": cfg.segmentation_network_device,
        "low_memory": cfg.segmentation_network_low_memory,
        "max_chunk_voxels": cfg.segmentation_network_max_chunk_voxels,
    })


def mocap_params(cfg: SettingsConfig) -> dict:
    return _prune_none({
        "num_t": cfg.mocap_num_t,
        "min_radius_um": cfg.mocap_min_radius_um,
        "max_radius_um": cfg.mocap_max_radius_um,
        "use_im": cfg.mocap_use_im,
        "num_sigma": cfg.mocap_num_sigma,
        "prefer_gpu": cfg.mocap_prefer_gpu,
        "peak_min_distance": cfg.mocap_peak_min_distance,
        "device": cfg.mocap_device,
        "low_memory": cfg.mocap_low_memory,
        "max_chunk_voxels": cfg.mocap_max_chunk_voxels,
    })


def tracking_params(cfg: SettingsConfig) -> dict:
    return _prune_none({
        "num_t": cfg.tracking_num_t,
        "max_distance_um": cfg.tracking_max_distance_um,
        "device": cfg.tracking_device,
        "mode": cfg.tracking_mode,
        "max_dense_pairs": cfg.tracking_max_dense_pairs,
        "max_dense_roi_voxels_cpu": cfg.tracking_max_dense_roi_voxels_cpu,
        "max_dense_roi_voxels_gpu": cfg.tracking_max_dense_roi_voxels_gpu,
        "low_memory": cfg.tracking_low_memory,
    })


def reassign_params(cfg: SettingsConfig) -> dict:
    return _prune_none({
        "num_t": cfg.reassign_num_t,
        "store_running_matches": cfg.reassign_store_running_matches,
        "max_refine_iterations": cfg.reassign_max_refine_iterations,
        "device": cfg.reassign_device,
        "low_memory": cfg.reassign_low_memory,
        "max_query_points": cfg.reassign_max_query_points,
        "max_bruteforce_pairs": cfg.reassign_max_bruteforce_pairs,
    })


def feature_params(cfg: SettingsConfig) -> dict:
    params = {
        "use_gpu": cfg.feature_use_gpu,
        "low_memory": cfg.feature_low_memory,
        "enable_motility": cfg.feature_enable_motility,
        "enable_adjacency": cfg.feature_enable_adjacency,
        "device": cfg.feature_device,
        "max_node_mask_elems": cfg.feature_max_node_mask_elems,
    }
    if cfg.feature_skip_nodes is not None:
        params["skip_nodes"] = cfg.feature_skip_nodes
    elif cfg.analyze_node_level:
        params["skip_nodes"] = False
    if cfg.feature_node_chunk_size is not None:
        params["node_chunk_size"] = cfg.feature_node_chunk_size
    return params
