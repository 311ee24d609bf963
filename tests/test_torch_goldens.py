"""The port's ``run`` held to the golden constants of ``tests/test_goldens.py``.

The same seeded 2 x 12 x 48 x 48 input, written with the port's own file
layer, goes through ``nellie_tpu_torch.pipeline.run.run`` on the CPU (the
fused default); its outputs meet the goldens recorded for the JAX
package: object and skeleton counts exactly, the foreground, organelle
area, voxel rows and mean intensity at the original's tolerances.  No
JAX run is needed.
"""
import numpy as np
import pandas as pd
import pytest

from nellie_tpu_torch.io import FileInfo, ome, tiff
from nellie_tpu_torch.pipeline.run import run
from test_goldens import (
    GOLDEN_FG_TOTAL,
    GOLDEN_ORG_AREA,
    GOLDEN_VOX_INTENSITY,
    GOLDEN_VOX_ROWS,
)


@pytest.fixture(scope="module")
def golden_run(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("golden")
    shape = (2, 12, 48, 48)
    rng = np.random.default_rng(123)
    z, y, x = np.mgrid[0:shape[1], 0:shape[2], 0:shape[3]]
    frames = []
    for t in range(2):
        tube = 900.0 * np.exp(
            -(((z - 6) ** 2) * 0.25 + (y - 24 - t + 6 * np.sin(x / 9.0)) ** 2 / 2)
            / (2 * 2.2 ** 2))
        frames.append(np.clip(tube + rng.normal(100, 5, shape[1:]), 0, None))
    data = np.stack(frames).astype(np.uint16)
    desc = ome.build_ome_xml("TZYX", shape, "uint16",
                             dim_res={"X": 0.2, "Y": 0.2, "Z": 0.5, "T": 2.0})
    path = tmp_path / "golden.ome.tif"
    tiff.imwrite(str(path), data, description=desc)
    fi = FileInfo(str(path))
    fi.find_metadata()
    fi.load_metadata()
    return run(fi, device="cpu")


def memmap(im_info, name):
    return np.asarray(im_info.get_memmap(im_info.pipeline_paths[name]))


def test_golden_segmentation(golden_run):
    labels = memmap(golden_run, "im_instance_label")
    n_per_frame = [len(np.unique(labels[t])) - 1 for t in range(2)]
    fg_per_frame = [(labels[t] > 0).sum() for t in range(2)]
    assert n_per_frame == [5, 5], n_per_frame
    assert sum(fg_per_frame) == pytest.approx(GOLDEN_FG_TOTAL, rel=0.1), fg_per_frame


def test_golden_skeleton(golden_run):
    skel = memmap(golden_run, "im_skel")
    assert [(skel[t] > 0).sum() for t in range(2)] == [23, 18]
    rel = memmap(golden_run, "im_skel_relabelled")
    labels = memmap(golden_run, "im_instance_label")
    assert (rel[labels > 0] > 0).all()


def test_golden_tracking(golden_run):
    flow = np.load(golden_run.pipeline_paths["flow_vector_array"])
    assert flow.shape[1] == 8
    assert flow.shape[0] == pytest.approx(20, abs=8), flow.shape
    assert np.median(flow[:, 5]) == pytest.approx(1, abs=1.0)


def test_golden_features(golden_run):
    org = pd.read_csv(golden_run.pipeline_paths["features_organelles"])
    assert len(org) == 10
    assert org["organelle_area_raw"].sum() == pytest.approx(GOLDEN_ORG_AREA, rel=0.15)
    vox = pd.read_csv(golden_run.pipeline_paths["features_voxels"])
    assert len(vox) == pytest.approx(GOLDEN_VOX_ROWS, rel=0.1)
    assert vox["intensity_raw"].mean() == pytest.approx(GOLDEN_VOX_INTENSITY, rel=0.2)
