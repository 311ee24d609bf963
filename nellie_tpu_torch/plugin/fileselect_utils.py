"""Qt-free helpers for the File validation tab (testable headlessly).

Mirrors the reference's per-dim validation semantics
(the original Nellie's ``nellie_napari/nellie_fileselect.py:715`` ``check_available_dims``):
a dimension present in the axes string is *required* — green when its
resolution is known, red when missing; a dimension absent from the axes
is neutral/disabled.
"""
from __future__ import annotations

VALID, INVALID, NOT_APPLICABLE = "valid", "invalid", "na"


def dim_validation_state(dim: str, axes: str | None, dim_res: dict | None) -> str:
    """Validation state for one resolution field."""
    axes = axes or ""
    dim_res = dim_res or {}
    if dim not in axes:
        return NOT_APPLICABLE
    return VALID if dim_res.get(dim) is not None else INVALID


def dim_validation_states(axes: str | None, dim_res: dict | None,
                          dims=("T", "Z", "Y", "X")) -> dict:
    return {d: dim_validation_state(d, axes, dim_res) for d in dims}


def preview_display_args(axes: str | None, shape, dim_res: dict | None):
    """(scale_tuple_or_None, ndisplay) for previewing the canonical image
    (reference ``nellie_fileselect.py:1022`` ``on_preview``): 3D view with
    µm scale when a real Z exists, else 2D."""
    axes = axes or ""
    dim_res = dim_res or {}
    has_z = ("Z" in axes and shape is not None
             and shape[axes.index("Z")] > 1)
    try:
        if has_z:
            return (float(dim_res["Z"]), float(dim_res["Y"]),
                    float(dim_res["X"])), 3
        return (float(dim_res["Y"]), float(dim_res["X"])), 2
    except (KeyError, TypeError, ValueError):
        return None, 3 if has_z else 2
