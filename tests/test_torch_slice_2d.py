"""The whole port on 2D and single-timepoint inputs against the JAX package.

For each input the port's ``run(..., device="cpu")`` and the JAX stage
classes run one after the other, each on its own copy: a 3 x 64 x 64
``TYX`` series and its first frame as ``YX`` (X = Y = 0.1 µm), and the
first volume of ``torch_port_data.tube_series()`` as ``ZYX``.  Every
artifact is held to the per-stage bars, the feature CSVs at the features
bar with NaN where the reference has NaN (``z_raw`` in 2D), and the
adjacency edges exactly.  As in ``test_torch_slice.py``, the rel_* columns
are compared on every row: no branch's reference voxel (its member of
minimum |flow|) may differ between the runs.  Single-timepoint inputs
write no flow vectors, reassigned labels or voxel matches, on either side.
"""
import os

import numpy as np
import pytest

import torch_port_data as D
from nellie_tpu.stages.filtering import Filter as JFilter
from nellie_tpu.stages.hierarchical import Hierarchy as JHierarchy
from nellie_tpu.stages.hu_tracking import HuMomentTracking as JTracking
from nellie_tpu.stages.labelling import Label as JLabel
from nellie_tpu.stages.mocap_marking import Markers as JMarkers
from nellie_tpu.stages.networking import Network as JNetwork
from nellie_tpu.stages.voxel_reassignment import VoxelReassigner as JReassigner
from nellie_tpu_torch.pipeline.run import run

FLOW_COST_ATOL = 1e-4
TEMPORAL = ("flow_vector_array", "im_branch_label_reassigned", "im_obj_label_reassigned",
            "voxel_matches")


@pytest.fixture(scope="module", params=sorted(D.INPUTS))
def runs(request, tmp_path_factory):
    axes = request.param
    make, dim_res = D.INPUTS[axes]
    data = make()
    ref = D.open_im_info(D.write_input(tmp_path_factory.mktemp("jax"), data, dim_res, axes))
    for stage in (JFilter, JLabel, JNetwork, JMarkers, JTracking, JReassigner):
        stage(ref, device="cpu").run()
    JHierarchy(ref, skip_nodes=False, device="cpu").run()
    fi = D.file_info(D.write_input(tmp_path_factory.mktemp("port"), data, dim_res, axes))
    port = run(fi, device="cpu")
    spacing = [dim_res[a] for a in ("Z", "Y", "X") if dim_res[a] is not None]
    return axes, ref, port, spacing


@pytest.fixture(scope="module")
def near_ties(runs):
    _, ref, port, spacing = runs
    if ref.no_t:
        return {}
    return D.near_tie_branches(ref, port, spacing)


@pytest.mark.parametrize("name", sorted(D.SEGMENTATION_ARTIFACTS))
def test_segmentation_artifacts(runs, name):
    axes, ref, port, _ = runs
    D.assert_artifact_equal(ref, port, name, D.SEGMENTATION_ARTIFACTS[name])
    assert D.read(port, name).ndim == len(axes) + ("T" not in axes)


def test_temporal_artifacts(runs):
    """Flow rows (t, y, x, dy, dx, cost in 2D) exact but for the cost;
    reassigned labels and voxel matches exact.  None of them without T."""
    axes, ref, port, _ = runs
    if "T" not in axes:
        for name in TEMPORAL:
            assert not os.path.exists(ref.pipeline_paths[name]), name
            assert not os.path.exists(port.pipeline_paths[name]), name
        return
    a, b = D.read(ref, "flow_vector_array"), D.read(port, "flow_vector_array")
    d = len(axes) - 1
    assert a.shape == b.shape and a.shape[0] > 0 and a.shape[1] == 2 + 2 * d
    np.testing.assert_array_equal(b[:, :-1], a[:, :-1])
    np.testing.assert_allclose(b[:, -1], a[:, -1], rtol=0, atol=FLOW_COST_ATOL)
    for name in ("im_branch_label_reassigned", "im_obj_label_reassigned"):
        D.assert_artifact_equal(ref, port, name, "exact")
    assert (D.read(port, "im_obj_label_reassigned")[1:] > 0).sum() > 0
    want, got = D.read(ref, "voxel_matches"), D.read(port, "voxel_matches")
    assert len(want) == len(got) == a[:, 0].max() + 1
    for pair_want, pair_got in zip(want, got):
        for x, y in zip(pair_want, pair_got):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


@pytest.mark.parametrize("table", D.FEATURE_TABLES)
def test_feature_tables(runs, near_ties, table):
    axes, ref, port, _ = runs
    assert not any(near_ties.values()), near_ties
    assert D.assert_features_equal_but_near_ties(ref, port, table, near_ties) == 0
    got = D.read_features(port.pipeline_paths[f"features_{table}"])
    if table != "image":
        assert got["z_raw"].isna().all() == ("Z" not in axes), table


def test_adjacency(runs):
    axes, ref, port, _ = runs
    want = D.read_adjacency(ref.pipeline_paths["adjacency_maps"])
    assert len(want["v_n"]) == (3 if "T" in axes else 1)
    D.assert_adjacency_equal(want, D.read_adjacency(port.pipeline_paths["adjacency_maps"]))


def test_near_tie_branches_are_counted(runs, near_ties):
    """No branch-frame takes another reference voxel (5 of 22 on the TYX
    input did before the flow interpolation was made bitwise): the count
    is 0 over every frame's branches."""
    _, ref, _, _ = runs
    branches = D.read(ref, "im_skel_relabelled")
    total = 0
    for t, found in near_ties.items():
        labels = set(np.unique(branches[t][branches[t] > 0]).tolist())
        assert found <= labels, (t, found)
        total += len(labels)
    excused = sum(len(found) for found in near_ties.values())
    assert excused == 0, (excused, total, near_ties)
    assert total > 0 or not near_ties
