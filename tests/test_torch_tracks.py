"""The port's headless track API against the JAX package, on the CPU.

The port's segmentation and tracking run once on the 3 x 12 x 48 x 48
tube series; their artifacts are copied into a second tree opened with
the JAX package's ``ImInfo``, so that both sides read the same flow rows,
labels and markers.  ``interpolate_all_forward`` / ``interpolate_all_backward``,
``LabelTracks`` (one label and every label, from the first and from a
middle frame) and the ``flow_vector_viz`` formatters are then held to the
JAX functions: track ids, frames and properties equal, float64
coordinates equal.
"""
import numpy as np
import pytest

import torch_port_data as D
from nellie_tpu.stages import flow_vector_viz as j_viz
from nellie_tpu.stages.all_tracks_for_label import LabelTracks as JLabelTracks
from nellie_tpu.stages.flow_interpolation import interpolate_all_backward as j_backward
from nellie_tpu.stages.flow_interpolation import interpolate_all_forward as j_forward
from nellie_tpu_torch.io import FileInfo, ImInfo
from nellie_tpu_torch.pipeline.fused import FusedSegmentation
from nellie_tpu_torch.stages import flow_vector_viz as viz
from nellie_tpu_torch.stages.all_tracks_for_label import LabelTracks
from nellie_tpu_torch.stages.flow_interpolation import (
    interpolate_all_backward,
    interpolate_all_forward,
)
from nellie_tpu_torch.stages.hu_tracking import HuMomentTracking

ARTIFACTS = list(D.SEGMENTATION_ARTIFACTS) + ["flow_vector_array"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(JAX ImInfo, port ImInfo) over the same artifacts."""
    data = D.tube_series()
    fi = FileInfo(D.write_input(tmp_path_factory.mktemp("port"), data))
    fi.find_metadata()
    fi.load_metadata()
    port = ImInfo(fi)
    FusedSegmentation(port, device="cpu").run()
    HuMomentTracking(port, device="cpu").run()
    ref = D.open_im_info(D.write_input(tmp_path_factory.mktemp("jax"), data))
    D.copy_artifacts(port, ref, ARTIFACTS)
    return ref, port


def assert_tracks_equal(got, want):
    tracks, props = got
    ref_tracks, ref_props = want
    assert len(tracks) == len(ref_tracks) > 0
    got_arr = np.asarray(tracks, np.float64)
    want_arr = np.asarray(ref_tracks, np.float64)
    np.testing.assert_array_equal(got_arr[:, :2], want_arr[:, :2])  # ids and frames
    np.testing.assert_array_equal(got_arr[:, 2:], want_arr[:, 2:])  # coordinates
    assert props == ref_props


def marker_coords(ref, t, n=40):
    return np.argwhere(D.read(ref, "im_marker")[t] > 0)[:n].astype(float)


@pytest.mark.parametrize("start", [0, 1])
def test_interpolate_all_forward(trees, start):
    ref, port = trees
    coords = marker_coords(ref, start)
    want = j_forward(coords, start, 3, ref, min_track_num=7)
    got = interpolate_all_forward(coords, start, 3, port, min_track_num=7, device="cpu")
    assert_tracks_equal(got, want)


@pytest.mark.parametrize("start", [1, 2])
def test_interpolate_all_backward(trees, start):
    ref, port = trees
    coords = marker_coords(ref, start)
    want = j_backward(coords, start, 0, ref, min_track_num=3)
    got = interpolate_all_backward(coords, start, 0, port, min_track_num=3, device="cpu")
    assert_tracks_equal(got, want)


@pytest.mark.parametrize("label_num,start_frame", [(None, 0), (None, 1), (1, 0), (2, 1)])
def test_label_tracks(trees, label_num, start_frame):
    ref, port = trees
    j_stage = JLabelTracks(ref)
    j_stage.initialize()
    want = j_stage.run(label_num=label_num, start_frame=start_frame, skip_coords=3)
    got = LabelTracks(port, device="cpu").run(label_num=label_num, start_frame=start_frame,
                                              skip_coords=3)
    assert_tracks_equal(got, want)
    assert set(got[1]) == {"frame_num"}


def test_label_tracks_past_the_last_frame_and_of_a_missing_label(trees):
    _, port = trees
    stage = LabelTracks(port, device="cpu")
    assert stage.run(start_frame=3) == ([], {})
    assert stage.run(label_num=10_000) == ([], {})


@pytest.mark.parametrize("kwargs", [{}, dict(cost_threshold=0.5, stride=2, max_vectors=7)])
def test_flow_vectors_to_tracks(trees, kwargs):
    ref, port = trees
    want = j_viz.load_flow_vectors_as_tracks(ref, **kwargs)
    got = viz.load_flow_vectors_as_tracks(port, **kwargs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1]["cost"], want[1]["cost"])
    assert got[0].dtype == want[0].dtype == np.float32 and got[0].shape[1] == 5
    empty = viz.flow_vectors_to_tracks(np.zeros((0, 8), np.float32), no_z=True)
    assert empty[0].shape == (0, 4) and empty[1]["cost"].size == 0


@pytest.mark.parametrize("kwargs", [{}, dict(t_range=(1, 3), time_stride=1, point_stride=2,
                                             max_points=30)])
def test_mocap_markers_as_points(trees, kwargs):
    ref, port = trees
    want = j_viz.load_mocap_markers_as_points(ref, **kwargs)
    got = viz.load_mocap_markers_as_points(port, **kwargs)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and got.shape[0] > 0


def test_missing_flow_vectors_raise(tmp_path):
    fi = FileInfo(D.write_input(tmp_path, D.tube_series(shape=(2, 4, 8, 8))))
    fi.find_metadata()
    fi.load_metadata()
    with pytest.raises(FileNotFoundError):
        viz.load_flow_vector_array(ImInfo(fi))
