"""Process tab: per-stage buttons and the "Run Nellie" chain.

The JAX package's ``plugin/nellie_processor.py`` (the original Nellie's
``nellie_napari/nellie_processor.py``) on the port's seven stages: each
step runs in a napari ``@thread_worker`` over the batch's files, steps
chain via ``next_step`` callbacks, buttons gate on artifact existence
(the filesystem is the resume frontier), and a QTimer ticks a status
display.  Every stage gets its kwargs from the Settings tree as the
port's ``run(config=...)`` does (:func:`params_from_config`) and an
explicit device from the Settings tab; a device the machine lacks fails
the step, which ends in the tab's error status.
"""
from __future__ import annotations

import os

from napari.qt.threading import thread_worker
from qtpy.QtCore import QTimer
from qtpy.QtWidgets import QHBoxLayout, QLabel, QPushButton, QVBoxLayout, QWidget

from nellie_tpu_torch.pipeline.run import params_from_config
from nellie_tpu_torch.stages.filtering import Filter
from nellie_tpu_torch.stages.hierarchical import Hierarchy
from nellie_tpu_torch.stages.hu_tracking import HuMomentTracking
from nellie_tpu_torch.stages.labelling import Label
from nellie_tpu_torch.stages.mocap_marking import Markers
from nellie_tpu_torch.stages.networking import Network
from nellie_tpu_torch.stages.voxel_reassignment import VoxelReassigner

# each stage's key in params_from_config -> its device field in the config
_DEVICE_FIELDS = {
    "filter": "preprocessing_device",
    "label": "segmentation_label_device",
    "network": "segmentation_network_device",
    "markers": "mocap_device",
    "tracking": "tracking_device",
    "reassign": "reassign_device",
    "hierarchy": "feature_device",
}


class NellieProcessor(QWidget):
    def __init__(self, napari_viewer, nellie, parent=None):
        super().__init__(parent)
        self.viewer = napari_viewer
        self.nellie = nellie
        self.initialized = False
        self._worker = None
        self._pipeline_active = False

        layout = QVBoxLayout()
        self.status_label = QLabel("Status: idle")
        layout.addWidget(self.status_label)

        self.run_all_button = QPushButton("Run Nellie")
        self.run_all_button.clicked.connect(self.run_nellie)
        layout.addWidget(self.run_all_button)

        self.step_buttons = {}
        for key, label, fn in (
            ("preprocess", "Preprocess (Frangi)", self.run_preprocessing),
            ("segment", "Segment (Label + Network)", self.run_segmentation),
            ("mocap", "Mocap markers", self.run_mocap),
            ("track", "Track (Hu moments)", self.run_tracking),
            ("reassign", "Reassign voxels", self.run_reassign),
            ("features", "Extract features", self.run_feature_export),
        ):
            row = QHBoxLayout()
            button = QPushButton(label)
            button.clicked.connect(fn)
            row.addWidget(button)
            self.step_buttons[key] = button
            layout.addLayout(row)

        self.open_dir_button = QPushButton("Open output directory")
        self.open_dir_button.clicked.connect(self.open_directory)
        layout.addWidget(self.open_dir_button)

        layout.addStretch()
        self.setLayout(layout)

        self._status_base = "idle"
        self._ticks = 0
        self.status_timer = QTimer(self)
        self.status_timer.timeout.connect(self.update_status)

    # -- gating ------------------------------------------------------------------
    def post_init(self):
        self.check_file_existence()

    def _exists(self, key):
        im_info = self.nellie.im_info
        return im_info is not None and os.path.exists(im_info.pipeline_paths[key])

    def check_file_existence(self):
        """Button gating by artifact existence (the resume frontier)."""
        im_info = self.nellie.im_info
        ready = im_info is not None
        self.step_buttons["preprocess"].setEnabled(ready)
        self.step_buttons["segment"].setEnabled(ready and self._exists("im_preprocessed"))
        self.step_buttons["mocap"].setEnabled(ready and self._exists("im_instance_label"))
        self.step_buttons["track"].setEnabled(ready and self._exists("im_marker"))
        self.step_buttons["reassign"].setEnabled(ready and self._exists("flow_vector_array"))
        self.step_buttons["features"].setEnabled(ready and self._exists("im_skel_relabelled"))
        self.run_all_button.setEnabled(ready)
        if ready and self._exists("features_organelles"):
            self.nellie.enable_analysis()

    # -- worker plumbing -----------------------------------------------------------
    def _start_worker(self, worker, status, next_step=None):
        self._worker = worker
        self._status_base = status
        self._ticks = 0
        self.status_timer.start(500)
        self.turn_off_buttons()

        failed = []

        def on_finished():
            self.status_timer.stop()
            if failed:  # a worker also finishes after it errored
                return
            self.status_label.setText(f"Status: finished {status}")
            self.check_file_existence()
            self.turn_on_buttons()
            if next_step is not None and self._pipeline_active:
                next_step()

        def on_errored(exc):
            failed.append(exc)
            self.status_timer.stop()
            self._pipeline_active = False
            self.status_label.setText(f"Status: ERROR in {status}: {exc}")
            self.turn_on_buttons()

        worker.finished.connect(on_finished)
        worker.errored.connect(on_errored)
        worker.start()

    def update_status(self):
        self._ticks += 1
        dots = "." * (self._ticks % 4)
        self.status_label.setText(f"Status: running {self._status_base}{dots}")

    def turn_off_buttons(self):
        for b in self.step_buttons.values():
            b.setEnabled(False)
        self.run_all_button.setEnabled(False)

    def turn_on_buttons(self):
        self.run_all_button.setEnabled(True)
        self.check_file_existence()

    # -- steps ------------------------------------------------------------------
    def _settings(self):
        return self.nellie.settings.to_config()

    def _stage_kwargs(self):
        """Each stage's kwargs from the Settings tree, with its device."""
        kw = params_from_config(self._settings())
        for stage, field in _DEVICE_FIELDS.items():
            kw[stage] = dict(kw[stage], device=self.nellie.settings.stage_device(field))
        return kw

    def _run_stages(self, stages, status, next_step=None, after_each=None):
        """Run ``stages`` ((class, key) pairs) over every file of the batch
        in one worker."""
        kw = self._stage_kwargs()
        im_info_list = self.nellie.im_info_list
        viewer = self.viewer

        @thread_worker
        def _run():
            for im_info in im_info_list:
                for cls, key in stages:
                    cls(im_info, viewer=viewer, **kw[key]).run()
                if after_each is not None:
                    after_each(im_info, kw)

        self._start_worker(_run(), status, next_step)

    def run_preprocessing(self, next_step=None):
        self._run_stages([(Filter, "filter")], "preprocessing", next_step)

    def run_segmentation(self, next_step=None):
        self._run_stages([(Label, "label"), (Network, "network")], "segmentation", next_step)

    def run_mocap(self, next_step=None):
        self._run_stages([(Markers, "markers")], "mocap marking", next_step)

    def run_tracking(self, next_step=None):
        self._run_stages([(HuMomentTracking, "tracking")], "tracking", next_step)

    def run_reassign(self, next_step=None):
        self._run_stages([(VoxelReassigner, "reassign")], "voxel reassignment", next_step)

    def run_feature_export(self, next_step=None):
        def remove_intermediates(im_info, kw):
            if kw["remove_intermediates"]:
                im_info.remove_intermediates()

        def post():
            self._pipeline_active = False
            self.nellie.enable_analysis()
            try:
                self.nellie.analyzer.rewrite_dropdown()
            except Exception:  # noqa: BLE001
                pass

        self._run_stages([(Hierarchy, "hierarchy")], "feature extraction", post,
                         after_each=remove_intermediates)

    def run_nellie(self):
        """Full pipeline chained via next_step callbacks."""
        self._pipeline_active = True
        cfg = self._settings()

        def after_tracking():
            if cfg.voxel_reassign:
                self.run_reassign(next_step=self.run_feature_export)
            else:
                self.run_feature_export()

        self.run_preprocessing(
            next_step=lambda: self.run_segmentation(
                next_step=lambda: self.run_mocap(
                    next_step=lambda: self.run_tracking(next_step=after_tracking))))

    def open_directory(self):
        im_info = self.nellie.im_info
        if im_info is None:
            return
        import subprocess
        import sys

        path = im_info.file_info.output_dir
        if sys.platform == "darwin":
            subprocess.Popen(["open", path])
        elif sys.platform.startswith("linux"):
            subprocess.Popen(["xdg-open", path])
        else:
            os.startfile(path)  # type: ignore[attr-defined]
