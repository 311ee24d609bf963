"""Shared inputs for the PyTorch-port parity tests (``test_torch_*.py``).

Every array is made with numpy from a seed.  The JAX side and the port
side each get their own copy of the input file, so their artifact
directories never collide.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from nellie_tpu.io import ome as ome_mod
from nellie_tpu.io import tiff as tifffile
from nellie_tpu.io.verifier import FileInfo, ImInfo

SHAPE = (3, 12, 48, 48)
DIM_RES = {"X": 0.2, "Y": 0.2, "Z": 0.5, "T": 1.0}

# artifact -> comparison: "exact" or a tolerance relative to the frame max
SEGMENTATION_ARTIFACTS = {
    "im_preprocessed": 1e-4,
    "im_instance_label": "exact",
    "im_skel": "exact",
    "im_pixel_class": "exact",
    "im_skel_relabelled": "exact",
    "im_marker": "exact",
    "im_distance": 1e-4,
    "im_border": "exact",
}


def tube_series(shape=SHAPE, seed=0) -> np.ndarray:
    """Two curved tubes (σ ≈ 2.6 voxels) drifting along Y, plus noise."""
    t_n, z_n, y_n, x_n = shape
    z, y, x = np.mgrid[0:z_n, 0:y_n, 0:x_n].astype(np.float64)
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(t_n):
        vol = 900.0 * np.exp(-(((z - z_n / 2) ** 2)
                               + (y - 0.3 * y_n - t - 5 * np.sin(x / 9.0)) ** 2)
                             / (2 * 2.6 ** 2))
        vol += 700.0 * np.exp(-(((z - z_n / 2 + 1) ** 2)
                                + (y - 0.7 * y_n - t + 4 * np.cos(x / 11.0)) ** 2)
                              / (2 * 2.8 ** 2))
        frames.append(np.clip(vol + rng.normal(100, 5, vol.shape), 0, None))
    return np.stack(frames).astype(np.uint16)


def write_input(directory, data: np.ndarray, dim_res=None) -> str:
    os.makedirs(directory, exist_ok=True)
    desc = ome_mod.build_ome_xml("TZYX", data.shape, "uint16", dim_res=dim_res or DIM_RES)
    path = os.path.join(str(directory), "tubes.ome.tif")
    tifffile.imwrite(path, data, description=desc)
    return path


def open_im_info(path: str) -> ImInfo:
    fi = FileInfo(path)
    fi.find_metadata()
    fi.load_metadata()
    return ImInfo(fi)


def file_info(path: str) -> FileInfo:
    fi = FileInfo(path)
    fi.find_metadata()
    fi.load_metadata()
    return fi


def two_copies(tmp_path, data=None):
    """(jax_im_info, port_im_info) over two copies of the same input."""
    data = tube_series() if data is None else data
    return (open_im_info(write_input(tmp_path / "jax", data)),
            open_im_info(write_input(tmp_path / "port", data)))


def copy_artifacts(src: ImInfo, dst: ImInfo, names) -> None:
    """Give ``dst`` the reference's artifacts ``names`` as its inputs."""
    for name in names:
        a, b = src.pipeline_paths[name], dst.pipeline_paths[name]
        dst._invalidate_memmap(b)
        shutil.copyfile(a, b)


def read(im_info: ImInfo, name: str) -> np.ndarray:
    path = im_info.pipeline_paths[name]
    if path.endswith(".npy"):
        return np.load(path, allow_pickle=True)
    im_info._invalidate_memmap(path)
    return np.array(im_info.get_memmap(path, read_mode="r"))


def assert_artifact_equal(ref: ImInfo, port: ImInfo, name: str, bar) -> None:
    a, b = read(ref, name), read(port, name)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if bar == "exact":
        bad = int(np.count_nonzero(a != b))
        assert bad == 0, f"{name}: {bad} of {a.size} voxels differ"
        return
    for t in range(a.shape[0]):
        scale = max(float(np.abs(a[t]).max()), 1e-30)
        err = float(np.abs(a[t].astype(np.float64) - b[t]).max()) / scale
        assert err <= bar, f"{name}[t={t}]: max error {err:.3g} of the frame max > {bar}"


# the Hierarchy's outputs: feature tables by level, and the adjacency pickle
FEATURE_TABLES = ("voxels", "nodes", "branches", "organelles", "image")
# every artifact the Hierarchy reads, besides the input image
HIERARCHY_INPUTS = list(SEGMENTATION_ARTIFACTS) + [
    "im_branch_label_reassigned", "im_obj_label_reassigned", "flow_vector_array"]
FEATURE_RTOL = FEATURE_ATOL = 1e-4  # tests/oracle/test_features_parity.py


def read_features(path):
    import pandas as pd

    return pd.read_csv(path)


def read_adjacency(path):
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)


def assert_features_equal(ref, got, context=""):
    """Same columns in the same order, the same rows, values within the
    features bar, NaN where the reference has NaN."""
    assert list(got.columns) == list(ref.columns), context
    assert len(got) == len(ref), (context, len(ref), len(got))
    for col in ref.columns:
        a = ref[col].to_numpy(float)
        b = got[col].to_numpy(float)
        np.testing.assert_array_equal(np.isnan(b), np.isnan(a), err_msg=f"{context} {col} NaN")
        ok = ~np.isnan(a)
        np.testing.assert_allclose(b[ok], a[ok], rtol=FEATURE_RTOL, atol=FEATURE_ATOL,
                                   err_msg=f"{context} {col}")


def assert_adjacency_equal(ref, got):
    assert list(got) == list(ref)
    for key in ref:
        assert len(got[key]) == len(ref[key]), key
        for a, b in zip(ref[key], got[key]):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=key)
