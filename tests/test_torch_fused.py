"""The port's fused segmentation chain against its per-stage path, on the CPU.

* ``run(fi, device="cpu")`` takes the fused chain by default; every file
  it writes (the eight segmentation artifacts, the flow rows, the
  reassigned labels, the five feature CSVs and ``adjacency_maps.pkl``)
  equals ``run(fi, device="cpu", fused=False)``'s byte for byte, for
  ``TZYX``, ``TYX`` and ``ZYX`` inputs; tracking and the Hierarchy took
  their frames from the device cache in the fused run.
* ``FusedSegmentation`` with ``otsu_thresh_intensity``, ``threshold`` and
  ``remove_edges`` equals the four stages run one by one.
* The cache's budget and ``take``; the fall-back on running out of memory;
  a low-memory config takes the per-stage path.
"""
import filecmp
import os

import numpy as np
import pytest
import torch

import torch_port_data as D
from nellie_tpu_torch.config import SettingsConfig
from nellie_tpu_torch.pipeline.fused import FusedSegmentation
from nellie_tpu_torch.pipeline.run import run
from nellie_tpu_torch.stages.filtering import Filter
from nellie_tpu_torch.stages.labelling import Label
from nellie_tpu_torch.stages.mocap_marking import Markers
from nellie_tpu_torch.stages.networking import Network
from nellie_tpu_torch.utils import adaptive_run, device_cache
from nellie_tpu_torch.utils.device_cache import DeviceFrameCache

CASES = {
    "TZYX": (lambda: D.tube_series(shape=(2, 10, 32, 32)), D.DIM_RES),
    "TYX": (lambda: D.tube_series_2d(), D.DIM_RES_2D),
    "ZYX": (lambda: D.tube_series(shape=(1, 10, 32, 32))[0], D.DIM_RES_ZYX),
}


def write(directory, axes):
    make, dim_res = CASES[axes]
    return D.file_info(D.write_input(directory, make(), dim_res, axes=axes))


@pytest.fixture(scope="module")
def fused_and_staged(tmp_path_factory):
    """{axes: (fused ImInfo, per-stage ImInfo, fused timings, cache hits)}."""
    runs = {}
    original = DeviceFrameCache.take
    for axes in CASES:
        hits = []

        def take(self, key, t, hits=hits):
            got = original(self, key, t)
            hits.append((key, got is not None))
            return got

        DeviceFrameCache.take = take
        try:
            fused, timings = run(write(tmp_path_factory.mktemp("fused"), axes), device="cpu",
                                 return_timings=True, skip_nodes=True)
        finally:
            DeviceFrameCache.take = original
        staged = run(write(tmp_path_factory.mktemp("staged"), axes), device="cpu", fused=False,
                     skip_nodes=True)
        runs[axes] = (fused, staged, timings, hits)
    return runs


@pytest.mark.parametrize("axes", sorted(CASES))
def test_fused_run_writes_the_per_stage_files(fused_and_staged, axes):
    fused, staged, timings, _ = fused_and_staged[axes]
    assert list(timings) == ["seg_fused", "tracking", "reassign", "hierarchy", "total"]
    written = 0
    for key, path in fused.pipeline_paths.items():
        other = staged.pipeline_paths[key]
        assert os.path.exists(path) == os.path.exists(other), key
        if os.path.exists(path):
            assert filecmp.cmp(path, other, shallow=False), key
            written += 1
    assert written == (13 if axes == "ZYX" else 17)
    assert D.read(fused, "im_instance_label").max() > 0


@pytest.mark.parametrize("axes", ["TZYX", "TYX"])
def test_tracking_and_hierarchy_take_the_cached_frames(fused_and_staged, axes):
    """Every frame's raw image, vesselness and distance reach tracking from
    the cache and every skeleton the Hierarchy, and the run leaves the
    cache empty."""
    fused, _, _, hits = fused_and_staged[axes]
    n_t = fused.shape[0]
    assert sorted(hits) == sorted([(k, True) for k in ("im", "im_preprocessed", "im_distance",
                                                       "im_skel") for _ in range(n_t)])
    assert len(device_cache.frame_cache(fused)) == 0


@pytest.mark.parametrize("kwargs", [dict(otsu_thresh_intensity=True), dict(threshold=150.0),
                                    dict(remove_edges=True)])
def test_fused_chain_equals_the_four_stages(tmp_path, kwargs):
    """Each option through the chain and through the stages.  For
    ``remove_edges``, which clears a 15-row margin at the top and bottom
    of the vesselness, a third band between the two tubes of a taller
    frame keeps some signal."""
    data = D.tube_series(shape=(2, 10, 32, 32))
    if kwargs.get("remove_edges"):
        data = D.tube_series(shape=(2, 8, 128, 32))
        data[:, 2:7, 58:70, :] += 600
    fused, staged = (D.open_im_info(D.write_input(tmp_path / k, data))
                     for k in ("fused", "staged"))
    FusedSegmentation(fused, device="cpu", **kwargs).run()
    Filter(staged, device="cpu", remove_edges=kwargs.get("remove_edges", False)).run()
    Label(staged, device="cpu", otsu_thresh_intensity=kwargs.get("otsu_thresh_intensity", False),
          threshold=kwargs.get("threshold")).run()
    Network(staged, device="cpu").run()
    Markers(staged, device="cpu").run()
    for name in D.SEGMENTATION_ARTIFACTS:
        D.assert_artifact_equal(staged, fused, name, "exact")
    assert D.read(fused, "im_marker").sum() > 0


def test_fused_stage_fencing_times(tmp_path):
    seg = FusedSegmentation(D.open_im_info(D.write_input(
        tmp_path, D.tube_series(shape=(1, 10, 32, 32)))), device="cpu")
    times = seg.run(fence_stages=True)
    assert set(times) == {"filter", "label", "network", "markers"}
    assert all(v > 0 for v in times.values())
    assert seg.run() == {}


def test_cache_budget_and_take():
    cache = DeviceFrameCache(budget_bytes=100)
    a = torch.zeros(10, dtype=torch.float32)  # 40 bytes
    assert cache.put("im", 0, a) and cache.put("im", 1, a)
    assert cache.used == 80 and len(cache) == 2
    assert not cache.put("im", 2, a)  # over budget: dropped
    assert cache.get("im", 2) is None and cache.used == 80
    assert cache.put("im", 0, a)  # already held
    assert cache.get("im", 0) is a and len(cache) == 2
    assert cache.take("im", 0) is a and cache.take("im", 0) is None
    assert cache.used == 40 and cache.peak == 80
    assert cache.put("im_skel", 3, torch.zeros(5, dtype=torch.int64))
    assert cache.used == 80
    cache.clear()
    assert len(cache) == 0 and cache.used == 0 and cache.peak == 80
    assert device_cache.DEFAULT_BUDGET_BYTES == int(2.5e9)


def test_out_of_memory_falls_back_to_the_stages_on_the_same_device(
        tmp_path, monkeypatch, fused_and_staged):
    """The chain's out-of-memory error sends ``run`` through the four
    stages on the same device: the per-stage run's artifacts."""
    devices = []
    original = adaptive_run.run_with_ladder

    def spy(stage_name, device, low_memory, im_info, attempt_fn):
        devices.append(device)
        return original(stage_name, device, low_memory, im_info, attempt_fn)

    def oom(self, raw):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(adaptive_run, "run_with_ladder", spy)
    monkeypatch.setattr(FusedSegmentation, "_frame_filter", oom)
    im_info, timings = run(write(tmp_path, "TZYX"), device="cpu", return_timings=True,
                           skip_nodes=True)
    assert "seg_fused" not in timings and list(timings)[:4] == ["filter", "label", "network",
                                                                 "markers"]
    assert set(devices) == {torch.device("cpu")}
    staged = fused_and_staged["TZYX"][1]
    for name in D.SEGMENTATION_ARTIFACTS:
        D.assert_artifact_equal(staged, im_info, name, "exact")


@pytest.mark.parametrize("field", ["preprocessing_low_memory", "segmentation_label_low_memory",
                                   "segmentation_network_low_memory", "mocap_low_memory"])
def test_low_memory_config_takes_the_per_stage_path(tmp_path, monkeypatch, field):
    """``run`` starts the per-stage Filter, not the chain (stopped there)."""
    class Stop(Exception):
        pass

    def refuse(self, fence_stages=False):
        raise AssertionError("the fused chain ran")

    def stop(self):
        raise Stop

    monkeypatch.setattr(FusedSegmentation, "run", refuse)
    monkeypatch.setattr(Filter, "run", stop)
    data = D.tube_series(shape=(2, 8, 32, 32))
    with pytest.raises(Stop):
        run(D.file_info(D.write_input(tmp_path, data)), device="cpu",
            config=SettingsConfig(**{field: True}))


def test_uint16_frames_travel_as_their_bits(tmp_path):
    data = D.tube_series(shape=(1, 4, 16, 16))
    data[0, 0, 0, :3] = [0, 40000, 65535]
    seg = FusedSegmentation(D.open_im_info(D.write_input(tmp_path, data)), device="cpu")
    seg._setup()
    raw, done, _ = seg._upload(0)
    assert done is None and raw.dtype == torch.int16
    np.testing.assert_array_equal(seg._to_float(raw).numpy(), data[0].astype(np.float32))
