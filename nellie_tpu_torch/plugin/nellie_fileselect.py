"""File validation tab: metadata repair workflow.

The JAX package's ``plugin/nellie_fileselect.py`` on the port's file
layer (:mod:`nellie_tpu_torch.io`).  As in the original Nellie's
``nellie_napari/nellie_fileselect.py``, the metadata-repair workflow is a
core feature: select a file or folder, fix the axes string with
uniqueness-enforced combo boxes, enter missing T/Z/XY resolutions with
red/green validation, pick channel and frame range, then Confirm
(materialise the canonical OME-TIFF), Preview, or Process.
"""
from __future__ import annotations

import os

from qtpy.QtWidgets import (
    QComboBox,
    QFileDialog,
    QGridLayout,
    QGroupBox,
    QHBoxLayout,
    QLabel,
    QLineEdit,
    QPushButton,
    QSpinBox,
    QVBoxLayout,
    QWidget,
)

from nellie_tpu_torch.io import FileInfo, ImInfo
from nellie_tpu_torch.plugin.fileselect_utils import (
    INVALID,
    VALID,
    dim_validation_states,
    preview_display_args,
)

AXIS_OPTIONS = ["", "T", "Z", "C", "Y", "X"]

_DIM_STYLE = {
    VALID: "background-color: #2e7d32; color: white;",
    INVALID: "background-color: #c62828; color: white;",
}


class NellieFileSelect(QWidget):
    def __init__(self, napari_viewer, nellie, parent=None):
        super().__init__(parent)
        self.viewer = napari_viewer
        self.nellie = nellie

        self.filepath = None
        self.file_info: FileInfo | None = None
        self.batch_fileinfos: list[FileInfo] = []

        layout = QVBoxLayout()

        # file/folder pickers
        picker = QHBoxLayout()
        self.file_button = QPushButton("Select file")
        self.file_button.clicked.connect(self.select_filepath)
        self.folder_button = QPushButton("Select folder (batch)")
        self.folder_button.clicked.connect(self.select_folder)
        picker.addWidget(self.file_button)
        picker.addWidget(self.folder_button)
        layout.addLayout(picker)

        self.file_label = QLabel("No file selected")
        layout.addWidget(self.file_label)

        # axes editing
        self.axes_group = QGroupBox("Axes")
        self.axes_layout = QHBoxLayout()
        self.axes_combos: list[QComboBox] = []
        self.axes_group.setLayout(self.axes_layout)
        layout.addWidget(self.axes_group)

        # resolutions
        res_group = QGroupBox("Resolutions (µm / s)")
        res_layout = QGridLayout()
        self.dim_edits = {}
        for row, dim in enumerate(["T", "Z", "Y", "X"]):
            res_layout.addWidget(QLabel(dim), row, 0)
            edit = QLineEdit()
            edit.editingFinished.connect(lambda d=dim: self.on_dim_res_changed(d))
            self.dim_edits[dim] = edit
            res_layout.addWidget(edit, row, 1)
        res_group.setLayout(res_layout)
        layout.addWidget(res_group)

        # channel / temporal range
        sel_group = QGroupBox("Selection")
        sel_layout = QGridLayout()
        sel_layout.addWidget(QLabel("Channel"), 0, 0)
        self.ch_spin = QSpinBox()
        self.ch_spin.valueChanged.connect(self.on_channel_changed)
        sel_layout.addWidget(self.ch_spin, 0, 1)
        sel_layout.addWidget(QLabel("T start"), 1, 0)
        self.t_start_spin = QSpinBox()
        self.t_start_spin.valueChanged.connect(self.on_t_range_changed)
        sel_layout.addWidget(self.t_start_spin, 1, 1)
        sel_layout.addWidget(QLabel("T end"), 2, 0)
        self.t_end_spin = QSpinBox()
        self.t_end_spin.valueChanged.connect(self.on_t_range_changed)
        sel_layout.addWidget(self.t_end_spin, 2, 1)
        sel_group.setLayout(sel_layout)
        layout.addWidget(sel_group)

        self.status_label = QLabel("")
        layout.addWidget(self.status_label)

        # actions
        actions = QHBoxLayout()
        self.confirm_button = QPushButton("Confirm")
        self.confirm_button.clicked.connect(self.on_confirm)
        self.preview_button = QPushButton("Preview")
        self.preview_button.clicked.connect(self.on_preview)
        self.process_button = QPushButton("Process")
        self.process_button.clicked.connect(self.on_process)
        for b in (self.confirm_button, self.preview_button, self.process_button):
            b.setEnabled(False)
            actions.addWidget(b)
        # reference nellie_fileselect.py:111 — rebuilds every tab for a
        # fresh session
        self.reset_button = QPushButton("Reset")
        self.reset_button.clicked.connect(self.nellie.reset)
        actions.addWidget(self.reset_button)
        layout.addLayout(actions)

        layout.addStretch()
        self.setLayout(layout)

    # -- selection --------------------------------------------------------------
    def select_filepath(self):
        filepath, _ = QFileDialog.getOpenFileName(
            self, "Select microscopy file", "",
            "Images (*.tif *.tiff *.nd2);;All files (*)")
        if not filepath:
            return
        self.initialize_single_file(filepath)

    def select_folder(self):
        folder = QFileDialog.getExistingDirectory(self, "Select folder of TIFFs")
        if not folder:
            return
        self.initialize_folder(folder)

    def initialize_single_file(self, filepath):
        self.filepath = filepath
        self.batch_fileinfos = []
        self.file_label.setText(os.path.basename(filepath))
        self.file_info = FileInfo(filepath)
        try:
            self.file_info.find_metadata()
            self.file_info.load_metadata()
        except ValueError:
            pass
        self._sync_widgets()

    def initialize_folder(self, folder):
        files = sorted(
            os.path.join(folder, f) for f in os.listdir(folder)
            if f.lower().endswith((".tif", ".tiff")))
        if not files:
            self.status_label.setText("No TIFF files in folder.")
            return
        self.batch_fileinfos = []
        ref_axes = ref_shape = None
        for f in files:
            fi = FileInfo(f)
            try:
                fi.find_metadata()
                fi.load_metadata()
            except ValueError:
                pass
            if ref_axes is None:
                ref_axes, ref_shape = fi.axes, fi.shape
            elif fi.axes != ref_axes or fi.shape != ref_shape:
                self.status_label.setText(
                    "Batch requires identical axes and shapes across files.")
                self.batch_fileinfos = []
                return
            self.batch_fileinfos.append(fi)
        self.filepath = files[0]
        self.file_info = self.batch_fileinfos[0]
        self.file_label.setText(f"{len(files)} files (batch), first: {os.path.basename(files[0])}")
        self._sync_widgets()

    # -- widget <-> FileInfo sync -------------------------------------------------
    def _sync_widgets(self):
        fi = self.file_info
        if fi is None:
            return
        self._sync_axes_combos()
        for dim, edit in self.dim_edits.items():
            val = (fi.dim_res or {}).get(dim)
            edit.setText("" if val is None else str(val))
            enabled = fi.axes is not None and dim in fi.axes
            edit.setEnabled(enabled)
        if fi.axes and "C" in fi.axes and fi.shape is not None:
            self.ch_spin.setEnabled(True)
            self.ch_spin.setMaximum(fi.shape[fi.axes.index("C")] - 1)
        else:
            self.ch_spin.setEnabled(False)
        if fi.axes and "T" in fi.axes and fi.shape is not None:
            max_t = fi.shape[fi.axes.index("T")] - 1
            for spin in (self.t_start_spin, self.t_end_spin):
                spin.setEnabled(True)
                spin.setMaximum(max_t)
            self.t_end_spin.setValue(fi.t_end if fi.t_end is not None else max_t)
        else:
            self.t_start_spin.setEnabled(False)
            self.t_end_spin.setEnabled(False)
        self._validate()

    def _sync_axes_combos(self):
        fi = self.file_info
        for combo in self.axes_combos:
            combo.deleteLater()
        self.axes_combos = []
        if fi.shape is None:
            return
        axes = fi.axes or ""
        for i in range(len(fi.shape)):
            combo = QComboBox()
            combo.addItems(AXIS_OPTIONS)
            if i < len(axes):
                combo.setCurrentText(axes[i])
            combo.currentTextChanged.connect(self.on_axes_changed)
            self.axes_layout.addWidget(combo)
            self.axes_combos.append(combo)

    def on_axes_changed(self, *_):
        # enforce uniqueness: clear duplicate selections elsewhere
        seen = set()
        for combo in self.axes_combos:
            text = combo.currentText()
            if text and text in seen:
                combo.blockSignals(True)
                combo.setCurrentText("")
                combo.blockSignals(False)
            elif text:
                seen.add(text)
        new_axes = "".join(c.currentText() for c in self.axes_combos)
        try:
            self.file_info.change_axes(new_axes)
        except ValueError:
            pass
        self._validate()

    def on_dim_res_changed(self, dim):
        text = self.dim_edits[dim].text().strip()
        try:
            value = float(text) if text else None
        except ValueError:
            value = None
        if value is not None:
            try:
                self.file_info.change_dim_res(dim, value)
            except ValueError:
                pass
        self._validate()

    def on_channel_changed(self, value):
        try:
            self.file_info.change_selected_channel(int(value))
        except (ValueError, KeyError, IndexError):
            pass

    def on_t_range_changed(self, *_):
        try:
            self.file_info.select_temporal_range(
                self.t_start_spin.value(), self.t_end_spin.value())
        except (ValueError, KeyError, IndexError):
            pass

    def _validate(self):
        fi = self.file_info
        errors = fi.get_validation_errors() if fi is not None else ["No file"]
        ok = not errors
        # per-dim red/green styling (reference check_available_dims,
        # nellie_fileselect.py:715): required+known -> green, required+
        # missing -> red, not in axes -> neutral + disabled
        states = dim_validation_states(fi.axes if fi else None,
                                       fi.dim_res if fi else None)
        for dim, edit in self.dim_edits.items():
            state = states[dim]
            edit.setStyleSheet(_DIM_STYLE.get(state, ""))
            edit.setEnabled(state != "na")
        self.status_label.setText("Ready." if ok else "; ".join(errors))
        for b in (self.confirm_button, self.preview_button, self.process_button):
            b.setEnabled(ok)
        return ok

    # -- actions ----------------------------------------------------------------
    def on_confirm(self):
        if not self._validate():
            return
        for fi in self.batch_fileinfos or [self.file_info]:
            fi.save_ome_tiff()
        self.status_label.setText("Canonical OME-TIFF saved.")

    def on_preview(self):
        """Preview the canonical image with µm scale and 2D/3D view picked
        from the metadata (reference ``nellie_fileselect.py:1022``)."""
        if not self._validate():
            return
        fi = self.file_info
        # prefer the canonical OME copy when Confirm has produced it
        if fi.ome_output_path and os.path.exists(fi.ome_output_path):
            from nellie_tpu_torch.io import tiff as tiff_mod
            data = tiff_mod.memmap(fi.ome_output_path)
        else:
            data = fi.read_file()
        scale, ndisplay = preview_display_args(fi.axes, fi.shape, fi.dim_res)
        kwargs = dict(name=os.path.splitext(os.path.basename(self.filepath))[0],
                      blending="translucent_no_depth")
        if scale is not None:
            kwargs["scale"] = scale
        self.viewer.dims.ndisplay = ndisplay
        self.viewer.add_image(data, **kwargs)
        self.viewer.scale_bar.visible = True
        self.viewer.scale_bar.unit = "µm"

    def on_process(self):
        if not self._validate():
            return
        infos = [ImInfo(fi) for fi in (self.batch_fileinfos or [self.file_info])]
        if len(infos) == 1:
            self.nellie.go_process(im_info=infos[0])
        else:
            self.nellie.go_process(im_info_list=infos)
