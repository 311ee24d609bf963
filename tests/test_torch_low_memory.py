"""The port's low-memory modes against the JAX package, on the CPU, and its
same-device ladder.

* A whole run with every stage in low-memory mode, from a
  ``SettingsConfig`` whose Label budget makes Z slabs (and whose node
  budget makes the Hierarchy aggregate nodes over small voxel chunks),
  against the JAX
  stages built from the same config: discrete artifacts exact,
  ``im_preprocessed`` and ``im_distance`` within 1e-4 of the frame max,
  flow costs within 1e-4, features at the features bar (rel_* near-ties
  counted, as in ``tests/test_torch_slice.py``).  Filter runs in windows
  of 12x24x24 core voxels, as a real low-memory frame does.
* ``run(low_memory=True)`` hands the flag to the stages the JAX package's
  ``run`` hands it to, and the ladder retries on the same device only.

The windowed Filter and Markers and Label's chunked-Z path are in
``tests/test_torch_low_memory_windows.py``, the row-tiled matcher in
``tests/test_torch_low_memory_tracking.py``.
"""
import numpy as np
import pytest
import torch

import torch_port_data as D
from torch_port_data import one_torch_thread  # noqa: F401 — autouse
from nellie_tpu.plugin import config as j_config
from nellie_tpu.stages.filtering import Filter as JFilter
from nellie_tpu.stages.hierarchical import Hierarchy as JHierarchy
from nellie_tpu.stages.hu_tracking import HuMomentTracking as JTracking
from nellie_tpu.stages.labelling import Label as JLabel
from nellie_tpu.stages.mocap_marking import Markers as JMarkers
from nellie_tpu.stages.networking import Network as JNetwork
from nellie_tpu.stages.voxel_reassignment import VoxelReassigner as JReassigner
from nellie_tpu_torch.config import SettingsConfig
from nellie_tpu_torch.pipeline import run as run_mod
from nellie_tpu_torch.pipeline.run import params_from_config, run
from nellie_tpu_torch.stages.filtering import Filter
from nellie_tpu_torch.stages.labelling import Label
from nellie_tpu_torch.utils import adaptive_run

COST_ATOL = 1e-4
NEAR_TIE_SHARE = 1e-3  # reassigned-label voxels allowed to differ (share of foreground)
LOW = dict(preprocessing_low_memory=True, preprocessing_max_chunk_voxels=12 * 24 * 24,
           segmentation_label_low_memory=True, segmentation_label_max_chunk_voxels=5 * 48 * 48,
           segmentation_network_low_memory=True, mocap_low_memory=True,
           mocap_max_chunk_voxels=12 * 24 * 24, tracking_low_memory=True,
           reassign_low_memory=True, feature_low_memory=True, analyze_node_level=True,
           feature_max_node_mask_elems=200_000)


def jax_stage_kwargs(fields):
    """Each JAX stage's kwargs from the JAX package's own config module."""
    cfg = j_config.SettingsConfig(**fields)
    f_kw = j_config.preprocessing_params(cfg)
    f_kw["remove_edges"] = cfg.remove_edges
    return [(JFilter, f_kw), (JLabel, j_config.segmentation_label_params(cfg)),
            (JNetwork, j_config.segmentation_network_params(cfg)),
            (JMarkers, j_config.mocap_params(cfg)),
            (JTracking, j_config.tracking_params(cfg)),
            (JReassigner, j_config.reassign_params(cfg)),
            (JHierarchy, j_config.feature_params(cfg))]


@pytest.fixture(scope="module")
def low_runs(tmp_path_factory):
    data = D.tube_series()
    ref = D.open_im_info(D.write_input(tmp_path_factory.mktemp("jax"), data))
    for stage, kwargs in jax_stage_kwargs(LOW):
        stage(ref, **kwargs).run()
    fi = D.file_info(D.write_input(tmp_path_factory.mktemp("port"), data))
    port = run(fi, device="cpu", config=SettingsConfig(**LOW))
    return ref, port


@pytest.mark.parametrize("name", sorted(D.SEGMENTATION_ARTIFACTS))
def test_low_memory_segmentation_artifacts(low_runs, name):
    ref, port = low_runs
    D.assert_artifact_equal(ref, port, name, D.SEGMENTATION_ARTIFACTS[name])


def test_low_memory_windows_differ_from_whole_frames(low_runs, tmp_path):
    """The config's Label budget really splits the frames: its slabs move
    the labels against a whole-frame Label."""
    ref, port = low_runs
    whole = D.open_im_info(D.write_input(tmp_path, D.tube_series()))
    D.copy_artifacts(ref, whole, ["im_preprocessed"])
    Label(whole, device="cpu").run()
    assert (D.read(whole, "im_instance_label") != D.read(port, "im_instance_label")).any()


def test_low_memory_flow_vectors(low_runs):
    ref, port = low_runs
    a, b = D.read(ref, "flow_vector_array"), D.read(port, "flow_vector_array")
    assert a.shape == b.shape and a.shape[0] > 0
    np.testing.assert_array_equal(b[:, :7], a[:, :7])
    np.testing.assert_allclose(b[:, 7], a[:, 7], rtol=0, atol=COST_ATOL)


@pytest.mark.parametrize("name", ["im_branch_label_reassigned", "im_obj_label_reassigned"])
def test_low_memory_reassigned_labels(low_runs, name):
    ref, port = low_runs
    a, b = D.read(ref, name), D.read(port, name)
    assert a.dtype == b.dtype == np.int32 and (b[1:] > 0).sum() > 0
    foreground = int((D.read(ref, "im_instance_label") > 0).sum())
    assert int((a != b).sum()) <= NEAR_TIE_SHARE * foreground


def test_low_memory_voxel_matches(low_runs):
    ref, port = low_runs
    a, b = D.read(ref, "voxel_matches"), D.read(port, "voxel_matches")
    assert len(a) == len(b) == 2
    for pair_ref, pair_got in zip(a, b):
        for x, y in zip(pair_ref, pair_got):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


@pytest.mark.parametrize("table", D.FEATURE_TABLES)
def test_low_memory_feature_tables(low_runs, table):
    ref, port = low_runs
    flipped = D.near_tie_branches(ref, port, [D.DIM_RES["Z"], D.DIM_RES["Y"], D.DIM_RES["X"]])
    D.assert_features_equal_but_near_ties(ref, port, table, flipped)


def test_low_memory_adjacency(low_runs):
    ref, port = low_runs
    D.assert_adjacency_equal(D.read_adjacency(ref.pipeline_paths["adjacency_maps"]),
                             D.read_adjacency(port.pipeline_paths["adjacency_maps"]))


def test_run_passes_low_memory_as_the_jax_run(tmp_path, monkeypatch):
    """``run(low_memory=True)`` starts Filter, Label, tracking and Hierarchy
    in low-memory mode, as the JAX package's ``run`` does; the config's
    per-stage flags reach every stage."""
    seen = {}
    original = adaptive_run.run_with_ladder

    def spy(stage_name, device, low_memory, im_info, attempt_fn):
        seen[stage_name] = (device, low_memory)
        return original(stage_name, device, low_memory, im_info, attempt_fn)

    monkeypatch.setattr(adaptive_run, "run_with_ladder", spy)
    data = D.tube_series(shape=(2, 8, 32, 32))
    run(D.file_info(D.write_input(tmp_path / "flag", data)), device="cpu", low_memory=True)
    assert {k: v[1] for k, v in seen.items()} == {
        "Filter": True, "Label": True, "Network": False, "Markers": False,
        "HuMomentTracking": True, "VoxelReassigner": False, "Hierarchy": True}
    assert {v[0] for v in seen.values()} == {torch.device("cpu")}
    kw = params_from_config(SettingsConfig(**LOW))
    assert all(kw[k]["low_memory"] for k in ("filter", "label", "network", "markers",
                                              "tracking", "reassign", "hierarchy"))
    assert kw["label"]["max_chunk_voxels"] == 5 * 48 * 48
    assert kw["tracking"]["mode"] == "auto" and kw["tracking"]["max_dense_pairs"] == int(1e7)
    assert kw["reassign"]["max_refine_iterations"] == 3
    assert not set(run_mod._DROPPED) & {k for v in kw.values() if isinstance(v, dict) for k in v}


class _Info:
    shape, axes, no_t = (2, 8, 16, 16), "TZYX", False


def test_ladder_retries_low_memory_on_the_same_device():
    attempts = []

    def attempt(dev, low):
        attempts.append((dev, low))
        if not low:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return "ok"

    # a stand-in for the caller's card: every rung stays on it, none is the CPU
    dev = torch.device("meta")
    assert adaptive_run.run_with_ladder("Test", dev, False, _Info(), attempt) == "ok"
    assert attempts == [(dev, False), (dev, True)]


def test_ladder_raises_an_oom_of_the_low_memory_rung():
    attempts = []

    def attempt(dev, low):
        attempts.append((dev, low))
        raise torch.OutOfMemoryError("CUDA out of memory")

    dev = torch.device("meta")
    with pytest.raises(torch.OutOfMemoryError):
        adaptive_run.run_with_ladder("Test", dev, False, _Info(), attempt)
    assert attempts == [(dev, False), (dev, True)]
    attempts.clear()

    def host_oom(dev, low):
        attempts.append((dev, low))
        raise MemoryError()

    with pytest.raises(MemoryError):
        adaptive_run.run_with_ladder("Test", dev, True, _Info(), host_oom)
    assert attempts == [(dev, True)]


def test_ladder_reraises_other_errors_and_estimates_memory(monkeypatch):
    def attempt(dev, low):
        raise ValueError("a real fault")

    with pytest.raises(ValueError, match="a real fault"):
        adaptive_run.run_with_ladder("Test", torch.device("cpu"), False, _Info(), attempt)
    info = _Info()
    info.shape = (1, 1024, 1024, 1024)
    monkeypatch.setattr(adaptive_run, "host_available_bytes", lambda: 20 * 2 ** 30)
    assert adaptive_run.should_use_low_memory(info, torch.device("cpu"))
    monkeypatch.setattr(adaptive_run, "host_available_bytes", lambda: 200 * 2 ** 30)
    assert not adaptive_run.should_use_low_memory(info, torch.device("cpu"))
    assert adaptive_run.mode_candidates(False) == [False, True]
    assert adaptive_run.mode_candidates(True) == [True]


def test_label_chunk_z_falls_through_in_2d(tmp_path):
    """A 2D frame has no Z to slab: ``chunk_z`` labels the whole frame."""
    data = D.tube_series_2d()
    path = D.write_input(tmp_path / "jax", data, D.DIM_RES_2D, axes="TYX")
    jax_info = D.open_im_info(path)
    JFilter(jax_info).run()
    whole, slabs = (D.open_im_info(D.write_input(tmp_path / k, data, D.DIM_RES_2D, axes="TYX"))
                    for k in ("whole", "slabs"))
    for im_info, kw in ((whole, {}), (slabs, {"chunk_z": 3, "low_memory": True})):
        D.copy_artifacts(jax_info, im_info, ["im_preprocessed"])
        stage = Label(im_info, device="cpu", **kw)
        assert stage.chunk_z is None
        stage.run()
    D.assert_artifact_equal(whole, slabs, "im_instance_label", "exact")


def test_stage_out_of_memory_moves_to_its_low_memory_mode(tmp_path, monkeypatch):
    """A whole-frame Filter that runs out of memory is retried on the same
    device in windows: the artifact of a low-memory run."""
    data = D.tube_series(shape=(2, 12, 48, 48))
    retried, direct = (D.open_im_info(D.write_input(tmp_path / k, data)) for k in ("a", "b"))

    def oom(self, t, mask=True):
        raise torch.OutOfMemoryError("CUDA out of memory")

    Filter(direct, device="cpu", low_memory=True, max_chunk_voxels=6912).run()
    monkeypatch.setattr(Filter, "_run_frame", oom)
    stage = Filter(retried, device="cpu", max_chunk_voxels=6912)
    stage.run()
    assert stage.low_memory
    D.assert_artifact_equal(direct, retried, "im_preprocessed", "exact")


def test_filter_halves_its_windows_on_out_of_memory(tmp_path, monkeypatch):
    """A window too large for the device halves the budget and retries
    (13,824 -> 6,912 -> 3,456 voxels): the artifact of a run with the last
    budget."""
    from nellie_tpu_torch.kernels import frangi

    data = D.tube_series(shape=(2, 12, 48, 48))
    halved, direct = (D.open_im_info(D.write_input(tmp_path / k, data)) for k in ("a", "b"))
    Filter(direct, device="cpu", low_memory=True, max_chunk_voxels=3456).run()
    original = frangi.vesselness_frame
    sizes = []

    def bounded(frame, params, apply_mask=True):
        sizes.append(frame.numel())
        if frame.numel() > 12 * 24 * 48:  # the windows of a 3,456-voxel budget
            raise torch.OutOfMemoryError("CUDA out of memory")
        return original(frame, params, apply_mask=apply_mask)

    monkeypatch.setattr(frangi, "vesselness_frame", bounded)
    Filter(halved, device="cpu", low_memory=True, max_chunk_voxels=13824).run()
    assert max(sizes) > 12 * 24 * 48 and sizes[-1] <= 12 * 24 * 48
    D.assert_artifact_equal(direct, halved, "im_preprocessed", "exact")
