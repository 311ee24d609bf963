"""Shared inputs for the PyTorch-port parity tests (``test_torch_*.py``).

Every array is made with numpy from a seed.  The JAX side and the port
side each get their own copy of the input file, so their artifact
directories never collide.
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import pytest
import torch

from nellie_tpu.io import ome as ome_mod
from nellie_tpu.io import tiff as tifffile
from nellie_tpu.io.verifier import FileInfo, ImInfo

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for a test module that imports this
    fixture: tier-1 runs six workers on the machine's cores, where an op
    spread over several threads waits for all of them; the port's results
    do not depend on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPE = (3, 12, 48, 48)
DIM_RES = {"X": 0.2, "Y": 0.2, "Z": 0.5, "T": 1.0}
# the 2D time series (axes TYX) and the single-timepoint inputs (YX, ZYX)
SHAPE_2D = (3, 64, 64)
DIM_RES_2D = {"X": 0.1, "Y": 0.1, "Z": None, "T": 1.0}
DIM_RES_YX = {"X": 0.1, "Y": 0.1, "Z": None, "T": None}
DIM_RES_ZYX = {"X": 0.2, "Y": 0.2, "Z": 0.5, "T": None}

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


def tube_series_2d(shape=SHAPE_2D, seed=0) -> np.ndarray:
    """Two wavy filaments (σ ≈ 2 pixels) drifting apart along Y, plus noise."""
    t_n, y_n, x_n = shape
    y, x = np.mgrid[0:y_n, 0:x_n].astype(np.float64)
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(t_n):
        img = 700.0 * np.exp(-((y - 0.3 * y_n - t - 5 * np.sin(x / 8.0)) ** 2) / (2 * 2.0 ** 2))
        img += 500.0 * np.exp(-((y - 0.7 * y_n + t - 4 * np.cos(x / 7.0)) ** 2)
                              / (2 * 2.4 ** 2))
        frames.append(np.clip(img + rng.normal(80, 5, img.shape), 0, None))
    return np.stack(frames).astype(np.uint16)


# axes -> (input, physical pixel sizes) of the 2D and single-timepoint cases
INPUTS = {
    "TYX": (lambda: tube_series_2d(), DIM_RES_2D),
    "YX": (lambda: tube_series_2d()[0], DIM_RES_YX),
    "ZYX": (lambda: tube_series()[0], DIM_RES_ZYX),
}


def write_input(directory, data: np.ndarray, dim_res=None, axes="TZYX") -> str:
    os.makedirs(directory, exist_ok=True)
    desc = ome_mod.build_ome_xml(axes, data.shape, "uint16", dim_res=dim_res or DIM_RES)
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


# The branch-relative motility columns (rel_*) hang on each branch's
# reference voxel, its member of minimum |flow|.  On flow fields of equal
# unit steps that argmin is a near-tie broken by single ulps, so a
# last-bit difference upstream may move it; such branches are found,
# checked to be near-ties and excused from the rel_* comparison.
REL_COLUMNS = ("rel_linear_vel", "rel_angular_vel", "rel_linear_acc", "rel_angular_acc",
               "rel_directionality")
NEAR_TIE_FLOW = 1e-5  # relative |flow| gap of two reference-voxel candidates


def near_tie_branches(ref: ImInfo, port: ImInfo, spacing) -> dict:
    """{t: branch labels} whose reference voxel differs between the two
    runs, each asserted to be a near-tie of |flow| in the port's flow."""
    import torch

    from nellie_tpu_torch.kernels._fp import reduce_sum_of_squares, sqrt
    from nellie_tpu_torch.stages import hierarchical as hier
    from nellie_tpu_torch.stages.flow_interpolation import FlowInterpolator

    labels, branches = read(ref, "im_instance_label"), read(ref, "im_skel_relabelled")
    spacing = torch.tensor(spacing, dtype=torch.float32)
    flipped = {t: set() for t in range(labels.shape[0])}
    for forward in (True, False):
        interps = [FlowInterpolator(im_info, forward=forward, device="cpu")
                   for im_info in (ref, port)]
        for t in range(labels.shape[0]):
            coords = np.argwhere(labels[t] > 0).astype(np.float32)
            lbl = torch.from_numpy(branches[t][labels[t] > 0].astype(np.int64))
            vecs = [interp.interpolate_coord_dev(coords, t) for interp in interps]
            if vecs[0] is None:
                continue
            euc = [sqrt(reduce_sum_of_squares(v * spacing[None])) for v in vecs]
            idx = [hier._segment_argmin(e, lbl, int(lbl.max()) + 1) for e in euc]
            for b in torch.nonzero(idx[0] != idx[1]).flatten().tolist():
                a, c = euc[1][idx[0][b]], euc[1][idx[1][b]]
                assert abs(float(a - c)) <= NEAR_TIE_FLOW * float(c), (t, b, float(a), float(c))
                flipped[t].add(b)
    return flipped


def near_tie_rows(table, frame, flipped, labels, branches) -> np.ndarray:
    """Rows of ``frame`` (a features table) whose rel_* columns depend on a
    near-tie branch's reference voxel."""
    rows = np.zeros(len(frame), bool)
    for t, found in flipped.items():
        if not found:
            continue
        at_t = (frame["t"] == t).to_numpy()
        fg = labels[t] > 0
        if table == "voxels":
            hit = np.isin(branches[t][fg], list(found))
            rows[at_t] = hit[frame["label"].to_numpy()[at_t]]
        elif table == "branches":
            rows |= at_t & frame["label"].isin(found).to_numpy()
        elif table == "organelles":
            organelles = np.unique(labels[t][np.isin(branches[t], list(found)) & fg])
            rows |= at_t & frame["label"].isin(organelles).to_numpy()
        else:
            rows |= at_t
    return rows


def assert_features_equal_but_near_ties(ref: ImInfo, port: ImInfo, table: str, flipped) -> int:
    """The feature table ``table`` of both runs at the features bar, but
    for the rel_* columns of rows behind a near-tie branch; returns the
    number of rows so excused."""
    path = f"features_{table}"
    want = read_features(ref.pipeline_paths[path])
    got = read_features(port.pipeline_paths[path])
    assert len(want) > 0 and len(got) == len(want), (table, len(want), len(got))
    rows = near_tie_rows(table, want, flipped, read(ref, "im_instance_label"),
                         read(ref, "im_skel_relabelled"))
    assert_features_equal(want[~rows], got[~rows], table)
    others = [c for c in want.columns if not c.startswith(REL_COLUMNS)]
    assert_features_equal(want[rows][others], got[rows][others], table)
    return int(rows.sum())
