"""Settings tab: the device, Basic and per-stage Advanced tabs over
SettingsConfig.

The JAX package's ``plugin/nellie_settings.py`` on the port's
:class:`nellie_tpu_torch.config.SettingsConfig`: the widget tree is built
from the dataclass, and ``to_config``/``apply_config`` round-trip every
field.  Every text field has its list of choices, the float16 Frangi carry
(``preprocessing_carry_dtype``) among them, so no field falls through to
an integer spin box.  Above the tabs, the device every stage runs on:
``"cuda"`` (the default) or ``"cpu"``.  A stage's ``*_device`` field may
name either instead; its ``"auto"`` (the config's default) means that
device, not a fallback to the CPU.
"""
from __future__ import annotations

import dataclasses
import typing

from qtpy.QtWidgets import (
    QCheckBox,
    QComboBox,
    QDoubleSpinBox,
    QFileDialog,
    QFormLayout,
    QHBoxLayout,
    QLabel,
    QPushButton,
    QScrollArea,
    QSpinBox,
    QTabWidget,
    QVBoxLayout,
    QWidget,
)

from nellie_tpu_torch.config import SettingsConfig

DEVICES = ["cuda", "cpu"]

_GROUPS = (
    ("Basic", ("remove_edges", "remove_intermediates", "voxel_reassign",
               "analyze_node_level", "track_all_frames", "subsample_voxels",
               "skip_vox")),
    ("Preprocess", "preprocessing_"),
    ("Label", "segmentation_label_"),
    ("Network", "segmentation_network_"),
    ("Mocap", "mocap_"),
    ("Track", "tracking_"),
    ("Reassign", "reassign_"),
    ("Features", "feature_"),
)

_STAGE_DEVICES = ["auto"] + DEVICES
_CHOICES = {
    "preprocessing_device": _STAGE_DEVICES,
    "segmentation_label_device": _STAGE_DEVICES,
    "segmentation_network_device": _STAGE_DEVICES,
    "mocap_device": _STAGE_DEVICES,
    "tracking_device": _STAGE_DEVICES,
    "reassign_device": _STAGE_DEVICES,
    "feature_device": _STAGE_DEVICES,
    "preprocessing_carry_dtype": ["float32", "float16"],
    "mocap_use_im": ["distance", "frangi"],
    "tracking_mode": ["auto", "dense", "sparse"],
}


def _is_optional(field_type) -> bool:
    return typing.get_origin(field_type) is typing.Union and type(None) in typing.get_args(field_type)


def _base_type(field_type):
    if _is_optional(field_type):
        args = [a for a in typing.get_args(field_type) if a is not type(None)]
        return args[0]
    return field_type


class Settings(QWidget):
    """Widget tree auto-generated from SettingsConfig fields."""

    def __init__(self, napari_viewer, nellie, parent=None):
        super().__init__(parent)
        self.viewer = napari_viewer
        self.nellie = nellie
        self._defaults = SettingsConfig()
        self._widgets = {}   # field -> (widget, override_checkbox_or_None)

        device_row = QHBoxLayout()
        device_row.addWidget(QLabel("Device"))
        self.device_combo = QComboBox()
        self.device_combo.addItems(DEVICES)
        self.device_combo.setCurrentText(DEVICES[0])
        device_row.addWidget(self.device_combo)

        tabs = QTabWidget()
        fields = {f.name: f for f in dataclasses.fields(SettingsConfig)}
        for title, selector in _GROUPS:
            page = QWidget()
            form = QFormLayout()
            names = (selector if isinstance(selector, tuple)
                     else [n for n in fields if n.startswith(selector)])
            for name in names:
                field = fields[name]
                widget_row = self._make_row(name, field)
                form.addRow(name.replace(selector if isinstance(selector, str) else "", "")
                            .replace("_", " ").strip(), widget_row)
            page.setLayout(form)
            scroll = QScrollArea()
            scroll.setWidget(page)
            scroll.setWidgetResizable(True)
            tabs.addTab(scroll, title)

        layout = QVBoxLayout()
        layout.addLayout(device_row)
        layout.addWidget(tabs)
        buttons = QHBoxLayout()
        save_btn = QPushButton("Save config...")
        save_btn.clicked.connect(self.save_config)
        load_btn = QPushButton("Load config...")
        load_btn.clicked.connect(self.load_config)
        reset_btn = QPushButton("Reset defaults")
        reset_btn.clicked.connect(lambda: self.apply_config(SettingsConfig()))
        for b in (save_btn, load_btn, reset_btn):
            buttons.addWidget(b)
        layout.addLayout(buttons)
        self.setLayout(layout)

        self.apply_config(self._defaults)

        # reference _update_skip_vox_enabled (nellie_settings.py:129-193):
        # the skip-N spinbox is only meaningful while subsampling is on
        sub_w, _ = self._widgets["subsample_voxels"]
        skip_w, _ = self._widgets["skip_vox"]
        sub_w.toggled.connect(skip_w.setEnabled)
        skip_w.setEnabled(sub_w.isChecked())

    # -- widget construction -----------------------------------------------------
    def _make_row(self, name, field):
        base = _base_type(field.type if not isinstance(field.type, str) else
                          self._resolve_type(field.type))
        optional = _is_optional(field.type) if not isinstance(field.type, str) else \
            field.type.startswith("Optional")
        default = getattr(self._defaults, name)

        container = QWidget()
        row = QHBoxLayout()
        row.setContentsMargins(0, 0, 0, 0)

        override = None
        if optional:
            # reference _make_optional_spinbox (nellie_settings.py:382):
            # value widget stays disabled until Override is checked
            override = QCheckBox("Override")
            override.setChecked(default is not None)
            row.addWidget(override)

        if name in _CHOICES or base is str:
            if name not in _CHOICES:
                raise KeyError(f"SettingsConfig.{name} is text and has no list of choices")
            widget = QComboBox()
            widget.addItems(_CHOICES[name])
            if default is not None:
                widget.setCurrentText(str(default))
        elif base is bool or isinstance(default, bool):
            widget = QCheckBox()
            widget.setChecked(bool(default))
        elif base is float or isinstance(default, float):
            widget = QDoubleSpinBox()
            widget.setDecimals(4)
            widget.setRange(-1e9, 1e9)
            widget.setValue(float(default) if default is not None else 0.0)
        else:
            widget = QSpinBox()
            widget.setRange(0, 2**31 - 1)
            widget.setValue(int(default) if default is not None else 0)

        if override is not None:
            widget.setEnabled(override.isChecked())
            override.toggled.connect(widget.setEnabled)

        row.addWidget(widget)
        container.setLayout(row)
        self._widgets[name] = (widget, override)
        return container

    @staticmethod
    def _resolve_type(annotation: str):
        if annotation.startswith("Optional["):
            inner = annotation[len("Optional[") : -1]
            return typing.Optional[{"int": int, "float": float, "bool": bool,
                                    "str": str}.get(inner, str)]
        return {"int": int, "float": float, "bool": bool, "str": str}.get(annotation, str)

    # -- config round trip ---------------------------------------------------------
    def _read_widget(self, name):
        widget, override = self._widgets[name]
        if override is not None and not override.isChecked():
            return None
        if isinstance(widget, QComboBox):
            return widget.currentText()
        if isinstance(widget, QCheckBox):
            return widget.isChecked()
        if isinstance(widget, QDoubleSpinBox):
            return float(widget.value())
        return int(widget.value())

    def _write_widget(self, name, value):
        widget, override = self._widgets[name]
        if override is not None:
            override.setChecked(value is not None)
        if value is None:
            return
        if isinstance(widget, QComboBox):
            widget.setCurrentText(str(value))
        elif isinstance(widget, QCheckBox):
            widget.setChecked(bool(value))
        elif isinstance(widget, QDoubleSpinBox):
            widget.setValue(float(value))
        else:
            widget.setValue(int(value))

    def to_config(self) -> SettingsConfig:
        return SettingsConfig(**{name: self._read_widget(name) for name in self._widgets})

    def apply_config(self, config: SettingsConfig):
        for name in self._widgets:
            self._write_widget(name, getattr(config, name))

    # -- persistence ---------------------------------------------------------------
    def save_config(self):
        path, _ = QFileDialog.getSaveFileName(self, "Save settings", "", "JSON (*.json)")
        if path:
            self.to_config().save(path)

    def load_config(self):
        path, _ = QFileDialog.getOpenFileName(self, "Load settings", "", "JSON (*.json)")
        if path:
            self.apply_config(SettingsConfig.load(path))

    # -- the port's devices and per-stage kwargs ------------------------------------
    def device(self) -> str:
        """The device every stage runs on unless its field names another."""
        return self.device_combo.currentText()

    def stage_device(self, field: str) -> str:
        """The device of the stage whose ``*_device`` field is ``field``."""
        value = self._read_widget(field)
        return self.device() if value == "auto" else value

    def get_preprocessing_params(self) -> dict:
        from nellie_tpu_torch import config as c

        return c.preprocessing_params(self.to_config())

    def get_segmentation_label_params(self) -> dict:
        from nellie_tpu_torch import config as c

        return c.segmentation_label_params(self.to_config())

    def get_segmentation_network_params(self) -> dict:
        from nellie_tpu_torch import config as c

        return c.segmentation_network_params(self.to_config())

    def get_mocap_params(self) -> dict:
        from nellie_tpu_torch import config as c

        return c.mocap_params(self.to_config())

    def get_tracking_params(self) -> dict:
        from nellie_tpu_torch import config as c

        return c.tracking_params(self.to_config())

    def get_reassign_params(self) -> dict:
        from nellie_tpu_torch import config as c

        return c.reassign_params(self.to_config())

    def get_feature_params(self) -> dict:
        from nellie_tpu_torch import config as c

        return c.feature_params(self.to_config())
