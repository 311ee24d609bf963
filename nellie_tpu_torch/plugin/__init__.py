"""napari plugin of the PyTorch port: the JAX package's GUI
(``nellie_tpu/plugin``) on the port's stages.

The same tabs, Home / File validation / Process / Visualize / Analyze /
Settings, and third-party extensions from the ``nellie_tpu_torch.plugins``
entry-point group.  What differs: the Process tab passes an explicit
device (``"cuda"`` by default, or ``"cpu"``) to every stage, and a
``"cuda"`` without a GPU ends in the tab's error status; the Analyze tab
reads the feature CSVs without pandas; every field of the Settings tree,
``preprocessing_carry_dtype`` included, has a widget; no tab reaches the
network.  Qt and napari are imported only when the loader is built.
"""


def _require_napari():
    try:
        import napari  # noqa: F401
        import qtpy  # noqa: F401
    except ImportError as exc:
        raise ImportError("The nellie_tpu_torch GUI needs napari and Qt "
                          "(pip install 'napari[all]').") from exc


def NellieLoader(*args, **kwargs):  # noqa: N802 - napari manifest entry point
    _require_napari()
    from nellie_tpu_torch.plugin.nellie_loader import NellieLoader as _Loader

    return _Loader(*args, **kwargs)
