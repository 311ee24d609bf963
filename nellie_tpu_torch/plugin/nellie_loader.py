"""NellieLoader: the tabbed host widget registered with napari.

The JAX package's ``plugin/nellie_loader.py`` (the original Nellie's
``nellie_napari/nellie_loader.py``): tabs Home / File validation / Process
/ Visualize / Analyze / Settings with a lazy ``post_init`` on tab change
and single-file or batch processing.  The Home tab shows the installed
version; nothing asks the network for a newer one.
"""
from __future__ import annotations

from qtpy.QtWidgets import QTabWidget

import nellie_tpu_torch
from nellie_tpu_torch.plugin.nellie_analysis import NellieAnalysis
from nellie_tpu_torch.plugin.nellie_fileselect import NellieFileSelect
from nellie_tpu_torch.plugin.nellie_home import Home
from nellie_tpu_torch.plugin.nellie_processor import NellieProcessor
from nellie_tpu_torch.plugin.nellie_settings import Settings
from nellie_tpu_torch.plugin.nellie_visualizer import NellieVisualizer


class NellieLoader(QTabWidget):
    def __init__(self, napari_viewer, parent=None):
        super().__init__(parent)
        self.viewer = napari_viewer

        self.im_info = None
        self.im_info_list = None

        self.home = Home(napari_viewer, self)
        self.file_select = NellieFileSelect(napari_viewer, self)
        self.processor = NellieProcessor(napari_viewer, self)
        self.visualizer = NellieVisualizer(napari_viewer, self)
        self.analyzer = NellieAnalysis(napari_viewer, self)
        self.settings = Settings(napari_viewer, self)

        self.add_tabs()
        self.currentChanged.connect(self.on_tab_change)

        try:
            from nellie_tpu_torch.plugin.discover_plugins import add_nellie_plugins_to_menu

            add_nellie_plugins_to_menu(self)
        except Exception as exc:  # noqa: BLE001
            print(f"Nellie plugin discovery failed: {exc}")

        self.home.set_update_status(f"nellie_tpu_torch {nellie_tpu_torch.__version__}")

    def add_tabs(self):
        self.home_tab = self.addTab(self.home, "Home")
        self.file_select_tab = self.addTab(self.file_select, "File validation")
        self.processor_tab = self.addTab(self.processor, "Process")
        self.visualizer_tab = self.addTab(self.visualizer, "Visualize")
        self.analyzer_tab = self.addTab(self.analyzer, "Analyze")
        self.settings_tab = self.addTab(self.settings, "Settings")

        self.setTabEnabled(self.processor_tab, False)
        self.setTabEnabled(self.visualizer_tab, False)
        self.setTabEnabled(self.analyzer_tab, False)

    def on_tab_change(self, index):
        widget = self.widget(index)
        post_init = getattr(widget, "post_init", None)
        if post_init is not None and not getattr(widget, "initialized", False):
            post_init()
            widget.initialized = True

    def go_to_file_select(self):
        self.setCurrentIndex(self.file_select_tab)

    def go_process(self, im_info=None, im_info_list=None):
        """Wire single-file or batch processing and enable the work tabs."""
        if im_info_list is not None:
            self.im_info_list = im_info_list
            self.im_info = im_info_list[0]
        elif im_info is not None:
            self.im_info = im_info
            self.im_info_list = [im_info]
        self.setTabEnabled(self.processor_tab, True)
        self.setTabEnabled(self.visualizer_tab, True)
        self.processor.post_init()
        self.processor.initialized = True
        self.visualizer.post_init()
        self.visualizer.initialized = True
        self.setCurrentIndex(self.processor_tab)

    def enable_analysis(self):
        self.setTabEnabled(self.analyzer_tab, True)

    def reset(self):
        """Start a fresh session: drop file state and rebuild every tab
        (reference ``nellie_loader.py:185-215`` — wired to the File tab's
        Reset button)."""
        self.im_info = None
        self.im_info_list = None
        while self.count():
            widget = self.widget(0)
            self.removeTab(0)
            if widget is not None:
                widget.deleteLater()
        self.home = Home(self.viewer, self)
        self.file_select = NellieFileSelect(self.viewer, self)
        self.processor = NellieProcessor(self.viewer, self)
        self.visualizer = NellieVisualizer(self.viewer, self)
        self.analyzer = NellieAnalysis(self.viewer, self)
        self.settings = Settings(self.viewer, self)
        self.add_tabs()
        self.setCurrentIndex(self.home_tab)
