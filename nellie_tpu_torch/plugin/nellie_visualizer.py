"""Visualize tab: open artifacts as layers, view tracks.

The JAX package's ``plugin/nellie_visualizer.py`` on the port's track API
(``LabelTracks`` on the Settings tab's device, ``flow_vector_viz``).  As
in the original Nellie's ``nellie_napari/nellie_visualizer.py``: raw,
preprocessed, segmentation, mocap and reassigned layers with µm scale
and a 2D/3D toggle; every opener reuses its existing layer instead of
duplicating it; track visualisation follows the active labels layer and
napari's ``selected_label`` from the viewer's current timepoint, with
all-frame seeding only for reassigned (time-consistent) labels; buttons
gate on artifact existence.
"""
from __future__ import annotations

import os

import numpy as np
from qtpy.QtWidgets import QCheckBox, QLabel, QPushButton, QVBoxLayout, QWidget

from nellie_tpu_torch.plugin.visualizer_utils import collect_tracks_over_frames
from nellie_tpu_torch.stages.all_tracks_for_label import LabelTracks
from nellie_tpu_torch.stages.flow_vector_viz import load_flow_vectors_as_tracks
from nellie_tpu_torch.utils.logger import logger

# label-layer cache key -> pipeline path key
_LABEL_LAYERS = {
    "instance": "im_instance_label",
    "branches": "im_skel_relabelled",
    "reassigned_obj": "im_obj_label_reassigned",
    "reassigned_branch": "im_branch_label_reassigned",
}
_REASSIGNED_KEYS = ("reassigned_obj", "reassigned_branch")


class NellieVisualizer(QWidget):
    def __init__(self, napari_viewer, nellie, parent=None):
        super().__init__(parent)
        self.viewer = napari_viewer
        self.nellie = nellie
        self.initialized = False
        self._layers = {}    # cache key -> napari layer (reused on re-click)

        layout = QVBoxLayout()
        self.buttons = {}
        for key, label, fn in (
            ("raw", "Open raw image", self.open_raw),
            ("im_preprocessed", "Open preprocessed image", self.open_preprocess_image),
            ("segmentation", "Open segmentation images", self.open_segment_image),
            ("im_marker", "Open mocap marker image", self.open_mocap_image),
            ("reassigned", "Open reassigned labels images", self.open_reassign_image),
            ("flow", "Open flow vectors", self.open_flow_vectors),
        ):
            button = QPushButton(label)
            button.clicked.connect(fn)
            layout.addWidget(button)
            self.buttons[key] = button

        self.check_3d_box = QCheckBox("3D view")
        self.check_3d_box.stateChanged.connect(self.check_3d)
        layout.addWidget(self.check_3d_box)

        layout.addWidget(QLabel("Track visualization (select a labels layer + label)"))
        self.track_button = QPushButton("Visualize selected label's tracks")
        self.track_button.clicked.connect(self.on_track_selected)
        layout.addWidget(self.track_button)
        self.track_all_button = QPushButton("Visualize all frame labels' tracks")
        self.track_all_button.clicked.connect(self.track_all)
        layout.addWidget(self.track_all_button)

        layout.addStretch()
        self.setLayout(layout)

    def post_init(self):
        self.check_file_existence()

    # -- helpers --------------------------------------------------------------
    def _im_info(self):
        return self.nellie.im_info

    def _set_status(self, message, level="info"):
        getattr(logger, level if level != "error" else "error")(message)
        try:
            self.viewer.status = message
        except Exception:  # noqa: BLE001 — headless viewers may refuse
            pass

    def set_scale(self):
        im_info = self._im_info()
        if im_info.no_z:
            return (1, im_info.dim_res["Y"], im_info.dim_res["X"])
        return (1, im_info.dim_res["Z"], im_info.dim_res["Y"], im_info.dim_res["X"])

    def check_3d(self):
        self.viewer.dims.ndisplay = 3 if self.check_3d_box.isChecked() else 2

    def check_file_existence(self):
        im_info = self._im_info()
        if im_info is None:
            for b in self.buttons.values():
                b.setEnabled(False)
            self.track_button.setEnabled(False)
            self.track_all_button.setEnabled(False)
            return
        paths = im_info.pipeline_paths
        exists = lambda key: os.path.exists(paths[key])  # noqa: E731
        self.buttons["raw"].setEnabled(os.path.exists(im_info.im_path))
        self.buttons["im_preprocessed"].setEnabled(exists("im_preprocessed"))
        has_seg = exists("im_instance_label") and exists("im_skel_relabelled")
        self.buttons["segmentation"].setEnabled(has_seg)
        self.buttons["im_marker"].setEnabled(exists("im_marker"))
        has_reassign = (exists("im_obj_label_reassigned")
                        and exists("im_branch_label_reassigned"))
        self.buttons["reassigned"].setEnabled(has_reassign)
        has_flow = exists("flow_vector_array")
        self.buttons["flow"].setEnabled(has_flow)
        # tracking needs flow vectors plus at least one labels source
        track_ok = has_flow and (has_seg or has_reassign)
        self.track_button.setEnabled(track_ok)
        self.track_all_button.setEnabled(track_ok)

    def _reuse(self, key):
        layer = self._layers.get(key)
        if layer is not None and layer in self.viewer.layers:
            self.viewer.layers.selection.active = layer
            self._set_status(f"Activated existing {key} layer.")
            return True
        return False

    def _add_image(self, path, key, name, **kwargs):
        im_info = self._im_info()
        data = im_info.get_memmap(path)
        layer = self.viewer.add_image(np.asarray(data), name=name,
                                      scale=self.set_scale(), **kwargs)
        self._layers[key] = layer
        return layer

    def _add_labels(self, path, key, name, visible=True):
        im_info = self._im_info()
        data = im_info.get_memmap(path)
        layer = self.viewer.add_labels(np.asarray(data).astype(np.int32), name=name,
                                       scale=self.set_scale(), visible=visible)
        self._layers[key] = layer
        # clicking a labeled voxel shows its hierarchy rows in the Analyze tab
        try:
            self.nellie.analyzer.attach_click_lookup(layer)
        except Exception:  # noqa: BLE001 — analysis tab may not be live yet
            pass
        return layer

    # -- layer openers ------------------------------------------------------------
    def open_raw(self):
        if self._reuse("raw"):
            return
        layer = self._add_image(self._im_info().im_path, "raw", "raw",
                                colormap="gray", blending="translucent_no_depth")
        self.viewer.layers.selection.active = layer
        self._set_status("Loaded raw image.")

    def open_preprocess_image(self):
        if self._reuse("preprocessed"):
            return
        layer = self._add_image(self._im_info().pipeline_paths["im_preprocessed"],
                                "preprocessed", "preprocessed")
        self.viewer.layers.selection.active = layer
        self._set_status("Loaded preprocessed image.")

    def _layer_alive(self, key):
        layer = self._layers.get(key)
        return layer is not None and layer in self.viewer.layers

    def open_segment_image(self):
        """Open branch + organelle label layers together (branches hidden)."""
        # both layers must still be in the viewer for reuse: the user may
        # have deleted either one since (a stale cache key would skip the
        # re-add, or re-adding both would duplicate the survivor)
        if self._reuse("instance") and self._layer_alive("branches"):
            return
        paths = self._im_info().pipeline_paths
        if not self._layer_alive("branches"):
            self._add_labels(paths["im_skel_relabelled"], "branches",
                             "Labels: Branches", visible=False)
        if not self._layer_alive("instance"):
            layer = self._add_labels(paths["im_instance_label"], "instance",
                                     "Labels: Organelles")
        else:
            layer = self._layers["instance"]
        self.viewer.layers.selection.active = layer
        self._set_status("Loaded segmentation label images.")

    def open_mocap_image(self):
        if self._reuse("mocap"):
            return
        layer = self._add_image(self._im_info().pipeline_paths["im_marker"], "mocap",
                                "Mocap Markers", colormap="red",
                                blending="additive", contrast_limits=[0, 1])
        self.viewer.layers.selection.active = layer
        self._set_status("Loaded mocap marker image.")

    def open_reassign_image(self):
        """Open reassigned branch + organelle label layers (branches hidden)."""
        if self._reuse("reassigned_obj") and self._layer_alive("reassigned_branch"):
            return
        paths = self._im_info().pipeline_paths
        if not self._layer_alive("reassigned_branch"):
            self._add_labels(paths["im_branch_label_reassigned"], "reassigned_branch",
                             "Reassigned px: Branches", visible=False)
        if not self._layer_alive("reassigned_obj"):
            layer = self._add_labels(paths["im_obj_label_reassigned"], "reassigned_obj",
                                     "Reassigned px: Organelles")
        else:
            layer = self._layers["reassigned_obj"]
        self.viewer.layers.selection.active = layer
        self._set_status("Loaded reassigned label images.")

    def open_flow_vectors(self):
        im_info = self._im_info()
        tracks, props = load_flow_vectors_as_tracks(im_info)
        if len(tracks):
            self.viewer.add_tracks(tracks, properties=props, name="flow vectors",
                                   scale=self.set_scale()[1:])

    # -- tracks ---------------------------------------------------------------
    def _get_active_label_layer_and_path(self):
        """Map the viewer's active layer to its pipeline label path.

        Returns ``(layer, path, is_reassigned)``; ``(None, None, False)``
        when the active layer is not one of the four label layers.
        """
        active = self.viewer.layers.selection.active
        paths = self._im_info().pipeline_paths
        for key, path_key in _LABEL_LAYERS.items():
            layer = self._layers.get(key)
            if layer is not None and layer is active:
                return layer, paths[path_key], key in _REASSIGNED_KEYS
        return None, None, False

    def _track(self, label_num):
        im_info = self._im_info()
        if not os.path.exists(im_info.pipeline_paths["flow_vector_array"]):
            self._set_status("Flow vector array not found; tracking is not "
                             "available for this dataset.", level="warning")
            return
        layer, label_path, is_reassigned = self._get_active_label_layer_and_path()
        if layer is None:
            self._set_status("Active layer is not a recognized labels layer; "
                             "select a labels layer before tracking.",
                             level="warning")
            return
        if label_num == "selected":
            label_num = int(getattr(layer, "selected_label", 0))
            if label_num == 0:
                self._set_status("No label selected (label 0). Select a non-zero "
                                 "label to visualize its tracks.", level="warning")
                return

        cfg = self.nellie.settings.to_config()
        skip = cfg.skip_vox if cfg.subsample_voxels else 1
        # all-frame seeding only makes sense for time-consistent labels
        use_all_frames = cfg.track_all_frames and is_reassigned
        start_frame = int(self.viewer.dims.current_step[0])

        label_tracks = LabelTracks(im_info, label_im_path=label_path,
                                   device=self.nellie.settings.device())
        label_tracks.initialize()
        tracks, props = collect_tracks_over_frames(
            label_tracks, start_frame=start_frame, use_all_frames=use_all_frames,
            num_frames=im_info.shape[0], skip_coords=skip, label_num=label_num)
        if not tracks:
            self._set_status("No tracks found.", level="info")
            return
        name = f"Tracks: Label {label_num}" if label_num else "Tracks: All labels"
        self.viewer.add_tracks(tracks, properties=props, name=name,
                               scale=self.set_scale()[1:])
        self.viewer.layers.selection.active = layer
        self._set_status(f"Added {name.lower()}.")

    def on_track_selected(self):
        self._track("selected")

    def track_all(self):
        self._track(None)
