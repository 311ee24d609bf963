"""The port's napari plugin (``nellie_tpu_torch/plugin``) on the CPU.

Each test of ``tests/test_plugin_widgets.py`` again, on the port's
``NellieLoader`` with the pure-Python Qt/napari stand-ins of ``qt_stubs``
and the Settings tab's device set to ``"cpu"``; then what differs from
the JAX GUI: the full click-through writes the artifacts of
``run(fused=False, device="cpu")`` byte for byte, a ``"cuda"`` device
without a GPU ends in the Process tab's error status, every Settings
field round-trips (the float16 carry too), and the Analyze tab reads the
feature CSVs without pandas as pandas reads them.
"""
import filecmp
import os

import numpy as np
import pandas as pd
import pytest
import torch

import qt_stubs

qt_stubs.install()

from nellie_tpu.plugin import analysis_utils as j_analysis  # noqa: E402
from nellie_tpu_torch.config import SettingsConfig  # noqa: E402
from nellie_tpu_torch.io import FileInfo, ome, tiff  # noqa: E402
from nellie_tpu_torch.pipeline.run import run  # noqa: E402
from nellie_tpu_torch.plugin import analysis_utils  # noqa: E402
from nellie_tpu_torch.plugin.nellie_loader import NellieLoader  # noqa: E402


def _make_dataset(dirpath, shape=(2, 8, 32, 32), with_ome=True):
    z, y, x = np.mgrid[0:shape[1], 0:shape[2], 0:shape[3]]
    tube = 900.0 * np.exp(
        -(((z - shape[1] / 2) ** 2) + (y - shape[2] / 2 + 4 * np.sin(x / 6.0)) ** 2)
        / (2 * 2.6 ** 2))
    rng = np.random.default_rng(5)
    data = np.stack([np.clip(tube + rng.normal(100, 5, shape[1:]), 0, None)
                     for _ in range(shape[0])]).astype(np.uint16)
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, "cells.ome.tif")
    if with_ome:
        desc = ome.build_ome_xml("TZYX", shape, "uint16",
                                 dim_res={"X": 0.2, "Y": 0.2, "Z": 0.5, "T": 1.0})
        tiff.imwrite(path, data, description=desc)
    else:
        tiff.imwrite(path, data)
    return path


@pytest.fixture
def loader():
    viewer = qt_stubs.FakeViewer()
    nellie = NellieLoader(viewer)
    nellie.settings.device_combo.setCurrentText("cpu")
    return nellie, viewer


def test_loader_tabs_and_gating(loader):
    nellie, _ = loader
    assert nellie.count() == 6
    assert [nellie.tabText(i) for i in range(6)] == [
        "Home", "File validation", "Process", "Visualize", "Analyze", "Settings"]
    assert nellie.isTabEnabled(nellie.home_tab)
    assert nellie.isTabEnabled(nellie.file_select_tab)
    assert not nellie.isTabEnabled(nellie.processor_tab)
    assert not nellie.isTabEnabled(nellie.visualizer_tab)
    assert not nellie.isTabEnabled(nellie.analyzer_tab)
    # the installed version, with no network check
    assert "nellie_tpu_torch" in nellie.home.update_label.text()


def test_home_start_navigates_and_screenshot_binds(loader, tmp_path, monkeypatch):
    nellie, viewer = loader
    nellie.home.start_button.click()
    assert nellie.currentIndex() == nellie.file_select_tab
    assert "Ctrl-Shift-E" in viewer._keybinds
    monkeypatch.setenv("HOME", str(tmp_path))
    nellie.home.screenshot()
    assert (tmp_path / "nellie_screenshots").is_dir()
    assert nellie.home.logo_label.pixmap() is not None


def test_fileselect_sync_validate_and_axes_uniqueness(loader, tmp_path):
    nellie, _ = loader
    fs = nellie.file_select
    fs.initialize_single_file(_make_dataset(str(tmp_path)))
    assert fs.file_info is not None and fs.file_info.axes == "TZYX"
    assert [c.currentText() for c in fs.axes_combos] == ["T", "Z", "Y", "X"]
    assert "Ready" in fs.status_label.text()
    assert fs.confirm_button.isEnabled() and fs.process_button.isEnabled()
    fs.axes_combos[1].setCurrentText("T")
    assert [c.currentText() for c in fs.axes_combos].count("T") <= 1
    fs.axes_combos[1].setCurrentText("Z")
    assert fs._validate()


def test_fileselect_missing_metadata_blocks_then_repair(loader, tmp_path):
    nellie, _ = loader
    fs = nellie.file_select
    fs.initialize_single_file(_make_dataset(str(tmp_path), with_ome=False))
    assert fs.file_info.axes == "QYX"
    assert not fs.confirm_button.isEnabled()
    for combo, ax in zip(fs.axes_combos, ["Z", "Y", "X"]):
        combo.setCurrentText(ax)
    for dim, val in (("Z", "0.5"), ("Y", "0.2"), ("X", "0.2")):
        fs.dim_edits[dim].finish_editing(val)
    assert fs._validate(), fs.status_label.text()
    assert fs.confirm_button.isEnabled()


def test_fileselect_preview_adds_scaled_layer(loader, tmp_path):
    nellie, viewer = loader
    fs = nellie.file_select
    fs.initialize_single_file(_make_dataset(str(tmp_path)))
    fs.preview_button.click()
    assert len(viewer.layers) == 1 and viewer.layers[0].kind == "image"
    assert viewer.scale_bar.visible and viewer.scale_bar.unit == "µm"
    assert viewer.dims.ndisplay == 3


def test_process_enables_tabs_and_gates_buttons(loader, tmp_path):
    nellie, _ = loader
    fs = nellie.file_select
    fs.initialize_single_file(_make_dataset(str(tmp_path)))
    fs.process_button.click()
    assert nellie.isTabEnabled(nellie.processor_tab)
    assert nellie.isTabEnabled(nellie.visualizer_tab)
    assert nellie.currentIndex() == nellie.processor_tab
    assert nellie.im_info is not None and len(nellie.im_info_list) == 1
    proc = nellie.processor
    assert proc.step_buttons["preprocess"].isEnabled()
    assert not proc.step_buttons["segment"].isEnabled()
    assert not proc.step_buttons["features"].isEnabled()
    assert proc.run_all_button.isEnabled()
    vis = nellie.visualizer
    assert vis.buttons["raw"].isEnabled()
    assert not vis.buttons["im_preprocessed"].isEnabled()
    assert not vis.buttons["segmentation"].isEnabled()


def test_reset_button_rebuilds_tabs(loader, tmp_path):
    nellie, _ = loader
    fs = nellie.file_select
    fs.initialize_single_file(_make_dataset(str(tmp_path)))
    fs.process_button.click()
    old_processor = nellie.processor
    nellie.file_select.reset_button.click()
    assert nellie.im_info is None and nellie.im_info_list is None
    assert nellie.count() == 6
    assert nellie.processor is not old_processor
    assert not nellie.isTabEnabled(nellie.processor_tab)
    assert nellie.currentIndex() == nellie.home_tab


def test_settings_widgets_roundtrip_config(loader):
    nellie, _ = loader
    settings = nellie.settings
    assert settings.to_config() == SettingsConfig()
    changed = SettingsConfig(remove_edges=True)
    settings.apply_config(changed)
    assert settings.to_config().remove_edges
    settings.apply_config(SettingsConfig())
    assert settings.to_config() == SettingsConfig()
    sub_w, _ = settings._widgets["subsample_voxels"]
    skip_w, _ = settings._widgets["skip_vox"]
    sub_w.setChecked(True)
    assert skip_w.isEnabled()
    sub_w.setChecked(False)
    assert not skip_w.isEnabled()


def test_every_settings_field_round_trips(loader):
    """Every field of SettingsConfig set away from its default through the
    widgets comes back (the JAX GUI's Settings crash on
    ``preprocessing_carry_dtype`` is not inherited), and the devices are
    the port's."""
    settings = loader[0].settings
    changed = SettingsConfig(
        preprocessing_carry_dtype="float16", preprocessing_device="cpu",
        feature_device="cuda", tracking_mode="sparse", mocap_use_im="frangi",
        preprocessing_frob_thresh=0.25, segmentation_label_chunk_z=4,
        feature_skip_nodes=False, skip_vox=3, preprocessing_alpha_sq=0.75)
    settings.apply_config(changed)
    assert settings.to_config() == changed
    assert settings.device() == "cpu"
    assert settings.stage_device("preprocessing_device") == "cpu"
    assert settings.stage_device("feature_device") == "cuda"
    assert settings.stage_device("mocap_device") == "cpu"  # "auto": the tab's device
    assert [settings.device_combo.itemText(i) for i in range(settings.device_combo.count())] \
        == ["cuda", "cpu"]
    assert loader[0].processor._stage_kwargs()["filter"]["carry_dtype"] == "float16"


def test_cuda_without_a_gpu_ends_in_the_error_status(loader, tmp_path, monkeypatch):
    nellie, _ = loader
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nellie.settings.device_combo.setCurrentText("cuda")
    fs = nellie.file_select
    fs.initialize_single_file(_make_dataset(str(tmp_path)))
    fs.process_button.click()
    nellie.processor.run_all_button.click()
    status = nellie.processor.status_label.text()
    assert status.startswith("Status: ERROR in preprocessing") and "cuda" in status
    assert not os.path.exists(nellie.im_info.pipeline_paths["im_preprocessed"])
    assert nellie.processor.run_all_button.isEnabled()


def _artifacts(im_info):
    out = {}
    for root in (im_info.file_info.output_dir, im_info.file_info.nellie_necessities_dir):
        for name in os.listdir(root):
            path = os.path.join(root, name)
            if os.path.isfile(path):
                out[name] = path
    return out


def test_full_pipeline_clickthrough(loader, tmp_path):
    """Run Nellie through the widgets, then every visualizer layer and the
    analysis dropdowns; the artifacts equal ``run(fused=False,
    device="cpu")``'s with the same settings, byte for byte."""
    nellie, viewer = loader
    fs = nellie.file_select
    shape = (2, 8, 48, 48)
    fs.initialize_single_file(_make_dataset(str(tmp_path / "gui"), shape=shape))
    fs.process_button.click()
    proc = nellie.processor
    proc.run_all_button.click()
    assert proc.status_label.text() == "Status: finished feature extraction", \
        proc.status_label.text()
    im_info = nellie.im_info
    assert all(b.isEnabled() for b in proc.step_buttons.values())
    assert nellie.isTabEnabled(nellie.analyzer_tab)

    fi = FileInfo(_make_dataset(str(tmp_path / "run"), shape=shape))
    fi.find_metadata()
    fi.load_metadata()
    ref = run(fi, device="cpu", fused=False, config=nellie.settings.to_config())
    got, want = _artifacts(im_info), _artifacts(ref)
    assert sorted(got) == sorted(want)
    assert len(got) >= 15 and "features_organelles.csv" in " ".join(got)
    differ = [k for k in got if not filecmp.cmp(got[k], want[k], shallow=False)]
    assert not differ, differ

    vis = nellie.visualizer
    vis.post_init()
    for key in ("raw", "im_preprocessed", "segmentation", "im_marker", "reassigned", "flow"):
        assert vis.buttons[key].isEnabled(), key
        vis.buttons[key].click()
    assert len(viewer.layers) >= 6
    vis.check_3d_box.setChecked(True)
    assert viewer.dims.ndisplay == 3

    ana = nellie.analyzer
    ana.post_init()
    assert ana.feature_combo.count() > 0
    ana.level_combo.setCurrentText("branch")
    assert ana.feature_combo.count() > 0
    plotted = []
    for i in range(min(4, ana.feature_combo.count())):
        ana.feature_combo.setCurrentText(ana.feature_combo.itemText(i))
        ana.plot_button.click()
        plotted.append(ana.stats_label.text().startswith("mean="))
    assert any(plotted)
    ana.export_data()
    (exported,) = [f for f in os.listdir(im_info.graph_dir) if f.endswith(".csv")]
    col, vals = ana._current_values()
    np.testing.assert_array_equal(
        pd.read_csv(os.path.join(im_info.graph_dir, exported),
                    float_precision="round_trip")[col].to_numpy(), vals)


@pytest.fixture(scope="module")
def feature_run(tmp_path_factory):
    path = _make_dataset(str(tmp_path_factory.mktemp("features")), shape=(2, 8, 48, 48))
    fi = FileInfo(path)
    fi.find_metadata()
    fi.load_metadata()
    return run(fi, device="cpu", skip_nodes=False)


def test_tables_read_as_pandas_reads_them(feature_run, tmp_path):
    """Every column of every feature CSV, and a column of text and empty
    fields, equal ``pandas.to_numeric(read_csv(...), errors="coerce")``
    (with pandas' exact parser: Python's ``float`` is exact)."""
    for level, key in analysis_utils.LEVEL_TO_CSV.items():
        path = feature_run.pipeline_paths[key]
        table = analysis_utils.Table.read(path)
        frame = pd.read_csv(path, float_precision="round_trip")
        assert table.columns == list(frame.columns) and len(table) == len(frame)
        for col in frame.columns:
            np.testing.assert_array_equal(
                table[col], pd.to_numeric(frame[col], errors="coerce").to_numpy(float))
    odd = tmp_path / "odd.csv"
    odd.write_text("t,x\n0,1.5\n1,\n2,abc\n3,inf\n")
    np.testing.assert_array_equal(analysis_utils.Table.read(odd)["x"],
                                  pd.to_numeric(pd.read_csv(odd)["x"], errors="coerce"))


def test_hierarchy_lookup_equals_the_pandas_one(feature_run):
    """The click -> hierarchy rows of the port (tables) and of the JAX GUI
    (pandas frames) agree on every foreground voxel of a frame."""
    import pickle

    tables, frames = {}, {}
    for level, key in analysis_utils.LEVEL_TO_CSV.items():
        tables[level] = analysis_utils.Table.read(feature_run.pipeline_paths[key])
        frames[level] = pd.read_csv(feature_run.pipeline_paths[key],
                                    float_precision="round_trip")
    with open(feature_run.pipeline_paths["adjacency_maps"], "rb") as f:
        adjacency = pickle.load(f)
    labels = feature_run.get_memmap(feature_run.pipeline_paths["im_instance_label"])
    coords = [np.argwhere(np.asarray(labels[t]) > 0) for t in range(labels.shape[0])]
    hits = 0
    for t in range(labels.shape[0]):
        for c in coords[t][::7]:
            pos = (t, *c.tolist())
            got = analysis_utils.hierarchy_lookup(pos, coords, tables, adjacency, False)
            want = j_analysis.hierarchy_lookup(pos, coords, frames, adjacency, False)
            assert got == want
            hits += got is not None
    assert hits > 10
