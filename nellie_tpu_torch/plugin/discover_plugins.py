"""Third-party extension discovery via the ``nellie_tpu_torch.plugins``
entry-point group (the JAX package's ``plugin/discover_plugins.py``).

Extensions are callables taking the NellieLoader; they appear under a
"Nellie (PyTorch port) plugins" submenu of napari's Plugins menu.  The
original Nellie's ``nellie.plugins`` group is scanned too.
"""
from __future__ import annotations

from importlib.metadata import entry_points

PLUGIN_GROUPS = ("nellie_tpu_torch.plugins", "nellie.plugins")
MENU_TITLE = "Nellie (PyTorch port) plugins"


def discover_nellie_plugins() -> dict:
    plugins = {}
    try:
        available = entry_points()
        for group in PLUGIN_GROUPS:
            for ep in available.select(group=group):
                try:
                    plugins[ep.name] = ep.load()
                except Exception as exc:  # noqa: BLE001 - isolate bad plugins
                    print(f"Error loading Nellie plugin {ep.name}: {exc}")
    except Exception as exc:  # noqa: BLE001
        print(f"Error discovering Nellie plugins: {exc}")
    return plugins


def add_nellie_plugins_to_menu(nellie_loader):
    from qtpy.QtGui import QAction
    from qtpy.QtWidgets import QMenu

    plugins = discover_nellie_plugins()
    if not plugins:
        return

    window = nellie_loader.viewer.window._qt_window
    plugins_menu = next((a.menu() for a in window.menuBar().actions()
                         if a.text() == "&Plugins"), None)
    if plugins_menu is None:
        print("Plugins menu not found")
        return
    nellie_menu = next((a.menu() for a in plugins_menu.actions() if a.text() == MENU_TITLE),
                       None)
    if nellie_menu is None:
        nellie_menu = QMenu(MENU_TITLE, window)
        plugins_menu.addMenu(nellie_menu)
    for plugin_name, plugin_func in plugins.items():
        action = QAction(plugin_name, window)
        action.triggered.connect(lambda checked, func=plugin_func: func(nellie_loader))
        nellie_menu.addAction(action)
