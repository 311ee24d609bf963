"""Qt-free helpers for the Analyze tab (testable headlessly).

The JAX package's ``plugin/analysis_utils.py`` without pandas: a feature
CSV is read with ``csv`` into a :class:`Table`, whose columns are float64
arrays in which a field that is empty or not a number is NaN, as
``pandas.to_numeric(errors="coerce")`` makes it.
"""
from __future__ import annotations

import csv

import numpy as np

LEVELS = ["voxel", "node", "branch", "organelle", "image"]
LEVEL_TO_CSV = {
    "voxel": "features_voxels",
    "node": "features_nodes",
    "branch": "features_branches",
    "organelle": "features_organelles",
    "image": "features_image",
}
STAT_SUFFIXES = ["raw", "mean", "std_dev", "min", "max", "sum"]


class Table:
    """The rows of a feature CSV: ``columns`` (its header), ``table[col]``
    (the column as float64, NaN where a field is empty or not a number),
    :meth:`rows` (the rows where a boolean mask holds) and :meth:`cell`
    (a field as written)."""

    def __init__(self, columns, fields):
        self.columns = list(columns)
        self._fields = fields  # (rows, columns) array of str
        self._numbers = {}

    @classmethod
    def read(cls, path) -> "Table":
        with open(path, newline="") as f:
            reader = csv.reader(f)
            columns = next(reader, [])
            rows = [r for r in reader if r]
        fields = np.array(rows, dtype=object).reshape(len(rows), len(columns))
        return cls(columns, fields)

    def __len__(self) -> int:
        return self._fields.shape[0]

    def __getitem__(self, column) -> np.ndarray:
        if column not in self._numbers:
            def number(text):
                try:
                    return float(text)
                except ValueError:
                    return np.nan

            j = self.columns.index(column)
            self._numbers[column] = np.array([number(v) for v in self._fields[:, j]],
                                             np.float64)
        return self._numbers[column]

    def rows(self, mask) -> "Table":
        return Table(self.columns, self._fields[np.asarray(mask, bool)])

    def cell(self, row: int, column: int) -> str:
        return str(self._fields[row, column])


def write_column(path, name, values) -> None:
    """A one-column CSV: ``name``, then each value as the shortest text
    that reads back to the same float64."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow([name])
        writer.writerows([repr(float(v))] for v in values)


def split_feature_columns(columns):
    """Header grammar: '<feature>_<stat>' -> {feature: [stats]}
    (the reference's suffix table, ``nellie_analysis.py:34-65,427``)."""
    features = {}
    for col in columns:
        if col in ("t", "label"):
            continue
        for suffix in STAT_SUFFIXES:
            if col.endswith("_" + suffix):
                feature = col[: -(len(suffix) + 1)]
                features.setdefault(feature, []).append(suffix)
                break
    return features


def hierarchy_lookup(pos, label_coords, dfs, adjacency, no_z):
    """Map a viewer cursor position to the hierarchy rows containing that
    voxel (the reference's click->index table, ``nellie_analysis.py:759``).

    pos: cursor position (t, [z,] y, x) in data coordinates.
    label_coords: per-frame (N, ndim) foreground coords in the voxel-CSV
        row order (argwhere order).
    dfs: {level: Table}; adjacency: {edge_key: [per-t (M, 2) edges]}.

    Returns ``(coord_str, headers, values)`` or ``None`` when the click
    missed the foreground / data isn't loaded.
    """
    if not label_coords:
        return None
    want = 3 if no_z else 4
    if len(pos) < want:
        return None
    ints = [int(round(float(p))) for p in pos[:want]]
    t, spatial = ints[0], ints[1:]
    if t < 0 or t >= len(label_coords):
        return None
    t_coords = label_coords[t]
    if t_coords is None or len(t_coords) == 0 or t_coords.shape[1] != len(spatial):
        return None
    match = np.nonzero((t_coords == np.asarray(spatial)).all(axis=1))[0]
    if len(match) == 0:
        return None
    matched_row = int(match[0])

    def _slice(level):
        df = dfs.get(level)
        if df is None:
            return None
        return df.rows(df["t"] == t) if "t" in df.columns else df

    headers, values = [], []
    vox_slice = _slice("voxel")
    if vox_slice is not None and 0 <= matched_row < len(vox_slice):
        headers.append("Voxel")
        values.append(vox_slice.cell(matched_row, 0))

    def _members(edge_key, level, by_label=False):
        if adjacency is None or edge_key not in adjacency:
            return None
        per_t = adjacency[edge_key]
        if t >= len(per_t):
            return None
        edges = np.asarray(per_t[t])
        if edges.size == 0:
            return None
        rows = edges[edges[:, 0] == matched_row, 1]
        if len(rows) == 0:
            return None
        sl = _slice(level)
        if sl is None:
            return None
        if by_label:
            # member index is the component *label*; map via the label col
            if "label" not in sl.columns:
                return None
            members = set(int(r) for r in rows)
            hits = [sl.cell(i, 0) for i, l in enumerate(sl["label"])
                    if np.isfinite(l) and int(l) in members]
            return ", ".join(hits) if hits else None
        ids = [sl.cell(int(r), 0) for r in rows if 0 <= int(r) < len(sl)]
        return ", ".join(ids) if ids else None

    for edge_key, level, title, by_label in (
            ("v_n", "node", "Nodes", False),
            ("v_b", "branch", "Branch", False),
            ("v_o", "organelle", "Organelle", True)):
        got = _members(edge_key, level, by_label)
        if got:
            headers.append(title)
            values.append(got)

    img_slice = _slice("image")
    if img_slice is not None and len(img_slice) > 0:
        headers.append("Image")
        values.append(img_slice.cell(0, 0))

    if not headers:
        return None
    coord_str = (f"(t={t}, y={spatial[0]}, x={spatial[1]})" if no_z
                 else f"(t={t}, z={spatial[0]}, y={spatial[1]}, x={spatial[2]})")
    return coord_str, headers, values
