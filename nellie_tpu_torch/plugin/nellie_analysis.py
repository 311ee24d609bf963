"""Analyze tab: feature histograms, exports, and feature->voxel overlays.

The JAX package's ``plugin/nellie_analysis.py`` (the original Nellie's
``nellie_napari/nellie_analysis.py``) without pandas: the five feature
CSVs are read into :class:`analysis_utils.Table`, whose columns are
float64 with NaN for a field that is not a number, as
``pandas.to_numeric(errors="coerce")`` gives.  Level, feature and
statistic dropdowns (suffix-split headers), histograms (log10 toggle,
mean±σ or median/IQR bands, optional per-timepoint filter), CSV and PNG
exports to the run's graph directory, and per-voxel overlays that pull
attribute values down the hierarchy through the adjacency maps.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
from qtpy.QtWidgets import (
    QCheckBox,
    QComboBox,
    QDoubleSpinBox,
    QHBoxLayout,
    QLabel,
    QPushButton,
    QSpinBox,
    QTableWidget,
    QTableWidgetItem,
    QVBoxLayout,
    QWidget,
)

from nellie_tpu_torch.plugin.analysis_utils import (  # noqa: F401
    LEVEL_TO_CSV,
    LEVELS,
    STAT_SUFFIXES,
    Table,
    hierarchy_lookup,
    split_feature_columns,
    write_column,
)

try:  # embedded in-tab canvas (reference nellie_analysis.py:85,314);
    # headless/Agg environments fall back to external figure windows
    from matplotlib.backends.backend_qtagg import FigureCanvasQTAgg
except Exception:  # noqa: BLE001
    FigureCanvasQTAgg = None


class NellieAnalysis(QWidget):
    def __init__(self, napari_viewer, nellie, parent=None):
        super().__init__(parent)
        self.viewer = napari_viewer
        self.nellie = nellie
        self.initialized = False

        self.dfs = {}
        self.adjacency = None

        layout = QVBoxLayout()

        row1 = QHBoxLayout()
        row1.addWidget(QLabel("Level"))
        self.level_combo = QComboBox()
        self.level_combo.addItems(LEVELS)
        self.level_combo.currentTextChanged.connect(self.on_level_change)
        row1.addWidget(self.level_combo)
        layout.addLayout(row1)

        row2 = QHBoxLayout()
        row2.addWidget(QLabel("Feature"))
        self.feature_combo = QComboBox()
        self.feature_combo.currentTextChanged.connect(self.on_feature_change)
        row2.addWidget(self.feature_combo)
        row2.addWidget(QLabel("Statistic"))
        self.stat_combo = QComboBox()
        self.stat_combo.currentTextChanged.connect(self._on_selection_change)
        row2.addWidget(self.stat_combo)
        layout.addLayout(row2)

        row3 = QHBoxLayout()
        self.log_box = QCheckBox("log10")
        # domain change: the linear-range spinboxes are meaningless in
        # log space, so replot with a fresh range (like a new selection)
        self.log_box.stateChanged.connect(self._on_match_t)
        row3.addWidget(self.log_box)
        self.median_box = QCheckBox("median/IQR (vs mean±σ)")
        self.median_box.stateChanged.connect(self._on_hist_option)
        row3.addWidget(self.median_box)
        self.match_t_box = QCheckBox("current frame only")
        self.match_t_box.stateChanged.connect(self._on_match_t)
        row3.addWidget(self.match_t_box)
        row3.addWidget(QLabel("bins"))
        self.bins_spin = QSpinBox()
        self.bins_spin.setRange(4, 1024)
        self.bins_spin.setValue(50)
        self.bins_spin.valueChanged.connect(self._on_hist_option)
        row3.addWidget(self.bins_spin)
        layout.addLayout(row3)

        # histogram range controls (reference nellie_analysis.py:743 —
        # min/max replot live, reset when the selection changes)
        row4 = QHBoxLayout()
        row4.addWidget(QLabel("hist min"))
        self.hist_min = QDoubleSpinBox()
        self.hist_min.setDecimals(4)
        self.hist_min.setRange(-1e12, 1e12)
        self.hist_min.valueChanged.connect(self._on_hist_option)
        row4.addWidget(self.hist_min)
        row4.addWidget(QLabel("hist max"))
        self.hist_max = QDoubleSpinBox()
        self.hist_max.setDecimals(4)
        self.hist_max.setRange(-1e12, 1e12)
        self.hist_max.valueChanged.connect(self._on_hist_option)
        row4.addWidget(self.hist_max)
        layout.addLayout(row4)

        self.plot_button = QPushButton("Plot histogram")
        # clicked passes `checked`; don't let it bind reset_range
        self.plot_button.clicked.connect(lambda *_: self.plot_data(True))
        layout.addWidget(self.plot_button)

        # in-tab histogram canvas (reference embeds a FigureCanvasQTAgg,
        # nellie_analysis.py:85,314); None in headless/test environments
        self.canvas = None
        if FigureCanvasQTAgg is not None:
            try:
                self.canvas = FigureCanvasQTAgg()
                self.canvas.figure.set_layout_engine("constrained")
                self.canvas.setMinimumHeight(240)
                layout.addWidget(self.canvas)
            except Exception:  # noqa: BLE001 — no Qt display
                self.canvas = None

        self.stats_label = QLabel("")
        layout.addWidget(self.stats_label)

        self.overlay_button = QPushButton("Overlay feature on voxels")
        self.overlay_button.clicked.connect(self.overlay)
        layout.addWidget(self.overlay_button)

        export_row = QHBoxLayout()
        self.export_csv_button = QPushButton("Export CSV")
        self.export_csv_button.clicked.connect(self.export_data)
        self.export_png_button = QPushButton("Save graph PNG")
        self.export_png_button.clicked.connect(self.save_graph)
        export_row.addWidget(self.export_csv_button)
        export_row.addWidget(self.export_png_button)
        layout.addLayout(export_row)

        # click -> hierarchy index table (reference nellie_analysis.py:759)
        self.click_match_table = QTableWidget()
        self.click_match_table.setMaximumHeight(80)
        self.click_match_table.setVisible(False)
        layout.addWidget(self.click_match_table)

        layout.addStretch()
        self.setLayout(layout)

        self._figure = None
        self._label_coords = None
        self._hist_guard = False  # suppress replot while resetting ranges

    # -- data loading -------------------------------------------------------------
    def post_init(self):
        self.get_csvs()
        self.rewrite_dropdown()
        # replot on frame change while "current frame only" is active
        # (reference nellie_analysis.py:1223)
        try:
            self.viewer.dims.events.current_step.connect(self._on_t_change)
        except Exception:  # noqa: BLE001 — viewer may be headless in tests
            pass

    # -- live replot wiring (reference nellie_analysis.py:743,1235,1247) --------
    def _on_hist_option(self, *_):
        if not self._hist_guard and self._figure is not None:
            self.plot_data(reset_range=False)

    def _on_match_t(self, *_):
        if not self._hist_guard:
            self.plot_data(reset_range=True)

    def _on_selection_change(self, *_):
        """New feature/statistic: replot with a fresh range (reference
        on_attr_selected, nellie_analysis.py:1379)."""
        if not self._hist_guard and self._figure is not None:
            self.plot_data(reset_range=True)

    def _on_t_change(self, *_):
        if self.match_t_box.isChecked():
            self.plot_data(reset_range=False)

    def _reset_hist_range(self, vals):
        self._hist_guard = True
        try:
            self.hist_min.setValue(float(np.nanmin(vals)))
            self.hist_max.setValue(float(np.nanmax(vals)))
        finally:
            self._hist_guard = False

    def _set_controls_enabled(self, ok: bool):
        for w in (self.hist_min, self.hist_max, self.bins_spin, self.log_box,
                  self.median_box):
            w.setEnabled(ok)
        df = self.dfs.get(self.level_combo.currentText())
        self.match_t_box.setEnabled(ok and df is not None and "t" in df.columns)

    def get_csvs(self):
        im_info = self.nellie.im_info
        if im_info is None:
            return
        self.dfs = {}
        self._label_coords = None
        for level, key in LEVEL_TO_CSV.items():
            path = im_info.pipeline_paths[key]
            if os.path.exists(path):
                try:
                    self.dfs[level] = Table.read(path)
                except (OSError, ValueError):
                    continue
        adj_path = im_info.pipeline_paths["adjacency_maps"]
        if os.path.exists(adj_path):
            with open(adj_path, "rb") as f:
                self.adjacency = pickle.load(f)

    def rewrite_dropdown(self):
        self.get_csvs()
        self.on_level_change(self.level_combo.currentText())

    def on_level_change(self, level):
        self.feature_combo.blockSignals(True)
        self.feature_combo.clear()
        df = self.dfs.get(level)
        if df is not None:
            self.feature_combo.addItems(sorted(split_feature_columns(df.columns)))
        self.feature_combo.blockSignals(False)
        self.on_feature_change(self.feature_combo.currentText())

    def on_feature_change(self, feature):
        self._hist_guard = True  # rebuilding the stat list fires its signal
        try:
            self.stat_combo.clear()
            df = self.dfs.get(self.level_combo.currentText())
            if df is None or not feature:
                return
            self.stat_combo.addItems(split_feature_columns(df.columns).get(feature, []))
        finally:
            self._hist_guard = False
        self._on_selection_change()

    # -- selection ---------------------------------------------------------------
    def _current_values(self):
        level = self.level_combo.currentText()
        feature = self.feature_combo.currentText()
        stat = self.stat_combo.currentText()
        df = self.dfs.get(level)
        if df is None or not feature or not stat:
            return None, None
        col = f"{feature}_{stat}"
        if col not in df.columns:
            return None, None
        data = df
        if self.match_t_box.isChecked() and "t" in df.columns:
            current_t = int(self.viewer.dims.current_step[0]) if self.viewer else 0
            data = df.rows(df["t"] == current_t)
        vals = data[col]
        vals = vals[np.isfinite(vals)]
        if self.log_box.isChecked():
            vals = vals[vals > 0]
            vals = np.log10(vals)
        return col, vals

    def get_stats(self, vals):
        if self.median_box.isChecked():
            center = np.median(vals)
            lo, hi = np.percentile(vals, [25, 75])
            return f"median={center:.4g}  IQR=[{lo:.4g}, {hi:.4g}]  n={vals.size}"
        mean = vals.mean()
        std = vals.std()
        return f"mean={mean:.4g}  σ={std:.4g}  n={vals.size}"

    # -- plotting -------------------------------------------------------------------
    def plot_data(self, reset_range: bool = True):
        col, vals = self._current_values()
        if vals is None or vals.size == 0:
            self.stats_label.setText("No data for selection.")
            self._set_controls_enabled(False)
            return
        self._set_controls_enabled(True)
        if reset_range or self.hist_min.value() >= self.hist_max.value():
            self._reset_hist_range(vals)
        lo_r, hi_r = self.hist_min.value(), self.hist_max.value()
        vals_in = vals[(vals >= lo_r) & (vals <= hi_r)]
        if vals_in.size == 0:
            self.stats_label.setText("No data in histogram range.")
            return
        if self.canvas is not None:
            fig = self.canvas.figure
            fig.clear()
            ax = fig.add_subplot(111)
        else:
            import matplotlib

            matplotlib.use("Agg", force=False)
            import matplotlib.pyplot as plt

            if self._figure is not None:  # pyplot keeps every figure alive
                plt.close(self._figure)
            fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist(vals_in, bins=self.bins_spin.value(), range=(lo_r, hi_r),
                color="#4a7aa7", edgecolor="black")
        ax.set_xlabel(col + (" (log10)" if self.log_box.isChecked() else ""))
        ax.set_ylabel("count")
        # labelled stat lines (reference draw_stats, nellie_analysis.py:1482)
        if self.median_box.isChecked():
            lo, hi = np.percentile(vals_in, [25, 75])
            ax.axvline(lo, color="r", linestyle="--", label="25th percentile")
            ax.axvline(np.median(vals_in), color="m", label="Median")
            ax.axvline(hi, color="r", linestyle="--", label="75th percentile")
        else:
            mean, std = vals_in.mean(), vals_in.std()
            ax.axvline(mean - std, color="b", linestyle="--", label="Mean - Std")
            ax.axvline(mean, color="c", label="Mean")
            ax.axvline(mean + std, color="b", linestyle="--", label="Mean + Std")
        ax.legend()
        self._figure = fig
        self.stats_label.setText(self.get_stats(vals_in))
        if self.canvas is not None:
            self.canvas.draw()
        else:
            try:
                fig.tight_layout()
                fig.show()
            except Exception:  # noqa: BLE001
                pass

    # -- exports ----------------------------------------------------------------
    def _graph_dir(self):
        im_info = self.nellie.im_info
        os.makedirs(im_info.graph_dir, exist_ok=True)
        return im_info.graph_dir

    def export_data(self):
        col, vals = self._current_values()
        if vals is None:
            return
        path = os.path.join(self._graph_dir(), f"{self.level_combo.currentText()}_{col}.csv")
        write_column(path, col, vals)
        self.stats_label.setText(f"Exported {path}")

    def save_graph(self):
        if self._figure is None:
            self.plot_data()
        if self._figure is None:
            return
        col, _ = self._current_values()
        path = os.path.join(self._graph_dir(), f"{self.level_combo.currentText()}_{col}.png")
        self._figure.savefig(path, dpi=150)
        self.stats_label.setText(f"Saved {path}")

    # -- click mapping -----------------------------------------------------------
    def _get_label_coords(self):
        """Per-frame foreground coords in voxel-CSV row (argwhere) order."""
        if self._label_coords is None:
            im_info = self.nellie.im_info
            label_memmap = im_info.get_memmap(im_info.pipeline_paths["im_instance_label"])
            self._label_coords = [np.argwhere(np.asarray(label_memmap[t]) > 0)
                                  for t in range(label_memmap.shape[0])]
        return self._label_coords

    def attach_click_lookup(self, layer):
        """Wire the click->hierarchy lookup onto a napari layer."""
        if self.get_index not in layer.mouse_drag_callbacks:
            layer.mouse_drag_callbacks.append(self.get_index)

    def get_index(self, layer, event):
        """Show the hierarchy rows (voxel/node/branch/organelle/image ids)
        for the clicked voxel (reference ``nellie_analysis.py:759``)."""
        im_info = self.nellie.im_info
        if im_info is None or not self.dfs:
            return
        try:
            coords = self._get_label_coords()
        except Exception:  # noqa: BLE001 — artifacts may not exist yet
            return
        hit = hierarchy_lookup(self.viewer.cursor.position, coords, self.dfs,
                               self.adjacency, im_info.no_z)
        if hit is None:
            return
        coord_str, headers, values = hit
        self.click_match_table.clear()
        self.click_match_table.setRowCount(1)
        self.click_match_table.setColumnCount(len(headers))
        self.click_match_table.setHorizontalHeaderLabels(headers)
        for i, val in enumerate(values):
            self.click_match_table.setItem(0, i, QTableWidgetItem(val))
        self.click_match_table.setVerticalHeaderLabels([coord_str])
        self.click_match_table.setVisible(True)

    # -- overlay ----------------------------------------------------------------
    def overlay(self):
        """Paint per-voxel values of the selected feature by pulling it down
        the hierarchy through the adjacency edge lists
        (reference nellie_analysis.py:955-1216)."""
        level = self.level_combo.currentText()
        feature = self.feature_combo.currentText()
        stat = self.stat_combo.currentText()
        df = self.dfs.get(level)
        im_info = self.nellie.im_info
        if df is None or self.adjacency is None or im_info is None:
            return
        col = f"{feature}_{stat}"
        label_memmap = im_info.get_memmap(im_info.pipeline_paths["im_instance_label"])
        shape = label_memmap.shape
        overlay_im = np.full(shape, np.nan, np.float32)

        edge_key = {"node": "v_n", "branch": "v_b", "organelle": "v_o"}.get(level)
        for t in range(shape[0]):
            coords = np.argwhere(np.asarray(label_memmap[t]) > 0)
            frame_df = df.rows(df["t"] == t) if "t" in df.columns else df
            vals = frame_df[col]
            if level == "voxel":
                n = min(len(coords), len(vals))
                overlay_im[t][tuple(coords[:n].T)] = vals[:n]
                continue
            if level == "image":
                overlay_im[t][tuple(coords.T)] = vals[0] if len(vals) else np.nan
                continue
            edges = self.adjacency[edge_key][t]
            if len(edges) == 0:
                continue
            vox_idx, member_idx = edges[:, 0], edges[:, 1]
            if level == "organelle":
                # member index is the component *label*; map to row
                labels_in_df = frame_df["label"]
                label_to_row = {int(l): i for i, l in enumerate(labels_in_df)}
                rows = np.array([label_to_row.get(int(m), -1) for m in member_idx])
            else:
                rows = member_idx
            ok = (rows >= 0) & (rows < len(vals)) & (vox_idx < len(coords))
            # nanmean over contributing features per voxel
            sums = np.zeros(len(coords))
            counts = np.zeros(len(coords))
            contrib = vals[rows[ok]]
            good = np.isfinite(contrib)
            np.add.at(sums, vox_idx[ok][good], contrib[good])
            np.add.at(counts, vox_idx[ok][good], 1)
            with np.errstate(invalid="ignore"):
                per_voxel = sums / counts
            overlay_im[t][tuple(coords.T)] = per_voxel

        finite = overlay_im[np.isfinite(overlay_im)]
        if finite.size == 0:
            self.stats_label.setText("Nothing to overlay.")
            return
        contrast = (float(np.nanmin(finite)), float(np.percentile(finite, 98)))
        layer = self.viewer.add_image(
            np.nan_to_num(overlay_im, nan=0.0), name=f"{level}:{col}",
            colormap="turbo", contrast_limits=contrast,
            scale=self.nellie.visualizer.set_scale(),
        )
        self.attach_click_lookup(layer)
