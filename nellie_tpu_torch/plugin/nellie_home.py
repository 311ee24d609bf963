"""Home tab: title, start button, screenshot capture.

The JAX package's ``plugin/nellie_home.py`` (the original Nellie's
``nellie_napari/nellie_home.py``: logo, title, start, and the Ctrl-Shift-E
screenshot keybinding writing to the run's screenshot directory).
"""
from __future__ import annotations

import datetime
import os

from qtpy.QtCore import Qt
from qtpy.QtWidgets import QLabel, QPushButton, QVBoxLayout, QWidget


class Home(QWidget):
    def __init__(self, napari_viewer, nellie, parent=None):
        super().__init__(parent)
        self.viewer = napari_viewer
        self.nellie = nellie

        layout = QVBoxLayout()

        # logo: QPixmap scaled with its aspect kept (the PNG is made by
        # scripts/make_logo.py)
        self.logo_label = QLabel(self)
        try:
            from qtpy.QtGui import QPixmap

            logo_path = os.path.join(os.path.dirname(__file__), "logo.png")
            pixmap = QPixmap(logo_path)
            if not pixmap.isNull():
                self.logo_label.setPixmap(
                    pixmap.scaled(300, 300, Qt.KeepAspectRatio))
        except Exception:  # noqa: BLE001 — logo is cosmetic, never fatal
            pass
        self.logo_label.setAlignment(Qt.AlignCenter)
        layout.addWidget(self.logo_label)

        title = QLabel("Nellie")
        title.setAlignment(Qt.AlignCenter)
        title.setStyleSheet("font-size: 28px; font-weight: bold;")
        layout.addWidget(title)

        subtitle = QLabel(
            "Automated organelle segmentation, tracking,\n"
            "and hierarchical feature extraction — PyTorch on CUDA."
        )
        subtitle.setAlignment(Qt.AlignCenter)
        layout.addWidget(subtitle)

        self.start_button = QPushButton("Start")
        self.start_button.clicked.connect(self.start)
        layout.addWidget(self.start_button)

        self.update_label = QLabel("")
        self.update_label.setAlignment(Qt.AlignCenter)
        layout.addWidget(self.update_label)

        self.screenshot_label = QLabel("Ctrl+Shift+E: save a screenshot of the viewer")
        self.screenshot_label.setAlignment(Qt.AlignCenter)
        layout.addWidget(self.screenshot_label)

        layout.addStretch()
        self.setLayout(layout)

        self.viewer.bind_key("Ctrl-Shift-E", self.screenshot, overwrite=True)

    def set_update_status(self, text: str):
        self.update_label.setText(text)

    def start(self):
        self.nellie.go_to_file_select()

    def screenshot(self, viewer=None):
        viewer = viewer or self.viewer
        im_info = getattr(self.nellie, "im_info", None)
        if im_info is not None:
            screenshot_dir = im_info.screenshot_dir
        else:
            screenshot_dir = os.path.join(os.path.expanduser("~"), "nellie_screenshots")
        os.makedirs(screenshot_dir, exist_ok=True)
        timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        path = os.path.join(screenshot_dir, f"nellie_screenshot_{timestamp}.png")
        screenshot = viewer.screenshot(canvas_only=True)
        try:
            from imageio import imwrite

            imwrite(path, screenshot)
            from napari.utils.notifications import show_info

            show_info(f"Screenshot saved to {path}")
        except Exception as exc:  # noqa: BLE001
            print(f"Failed to save screenshot: {exc}")
