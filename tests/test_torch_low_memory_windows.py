"""The port's windowed stages and its Label chunked-Z path against the JAX
package, on the CPU.

* Filter in several windows (3D and 2D), held to the JAX package's
  windows at the Filter bar; Markers in windows of a frame wide enough
  that the windows overlap.
* Label with ``chunk_z`` set from a config: the JAX package's labels
  exactly.
"""
import numpy as np
import pytest
from scipy import ndimage

import torch_port_data as D
from torch_port_data import one_torch_thread  # noqa: F401 — autouse
from nellie_tpu.stages.filtering import Filter as JFilter
from nellie_tpu.stages.labelling import Label as JLabel
from nellie_tpu.stages.mocap_marking import Markers as JMarkers
from nellie_tpu_torch.config import SettingsConfig
from nellie_tpu_torch.pipeline.run import params_from_config
from nellie_tpu_torch.stages.filtering import Filter
from nellie_tpu_torch.stages.labelling import Label
from nellie_tpu_torch.stages.mocap_marking import Markers


def write_artifacts(im_info, arrays):
    for name, arr in arrays.items():
        im_info.allocate_memory(im_info.pipeline_paths[name], dtype=arr.dtype.name, data=arr,
                                description=name)


@pytest.mark.parametrize("axes,remove_edges", [("TZYX", False), ("TYX", True)])
def test_filter_windows_equal_jax(tmp_path, axes, remove_edges):
    """Filter's windows and its float64 host finalize, within 1e-4 of the
    frame max of the JAX package's, and different from whole frames."""
    data, dim_res, budget = ((D.tube_series(), D.DIM_RES, 12 * 24 * 24) if axes == "TZYX"
                             else (D.tube_series_2d(shape=(2, 96, 64)), D.DIM_RES_2D, 32 * 32))
    ref, port, whole = (D.open_im_info(D.write_input(tmp_path / k, data, dim_res, axes=axes))
                        for k in ("jax", "port", "whole"))
    kw = dict(low_memory=True, max_chunk_voxels=budget, remove_edges=remove_edges)
    JFilter(ref, **kw).run()
    Filter(port, device="cpu", **kw).run()
    Filter(whole, device="cpu", remove_edges=remove_edges).run()
    D.assert_artifact_equal(ref, port, "im_preprocessed", 1e-4)
    got = D.read(port, "im_preprocessed")
    assert (got > 0).any()
    assert (D.read(whole, "im_preprocessed") != got).any()


def test_markers_in_overlapping_windows(tmp_path):
    """Markers windowed along a wide X axis: the JAX package's windows, and
    the whole frame's result."""
    data = D.tube_series(shape=(1, 12, 48, 256))
    labels, _ = ndimage.label(data > 500)
    arrays = {"im_instance_label": labels.astype(np.int32)}
    ref, port, whole = (D.open_im_info(D.write_input(tmp_path / k, data))
                        for k in ("jax", "port", "whole"))
    for im_info in (ref, port, whole):
        write_artifacts(im_info, arrays)
    budget = 12 * 48 * 64
    JMarkers(ref, low_memory=True, max_chunk_voxels=budget).run()
    Markers(port, device="cpu", low_memory=True, max_chunk_voxels=budget).run()
    Markers(whole, device="cpu").run()
    for name in ("im_marker", "im_distance", "im_border"):
        D.assert_artifact_equal(ref, port, name, "exact")
        D.assert_artifact_equal(whole, port, name, "exact")
    assert D.read(port, "im_marker").sum() > 0


def test_label_chunk_z_from_config(tmp_path):
    """``segmentation_label_chunk_z`` reaches Label, whose Z slabs give the
    JAX package's ``im_instance_label`` exactly."""
    jax_info, port_info = D.two_copies(tmp_path)
    JFilter(jax_info).run()
    D.copy_artifacts(jax_info, port_info, ["im_preprocessed"])
    JLabel(jax_info, chunk_z=5).run()
    Label(port_info, device="cpu", **params_from_config(
        SettingsConfig(segmentation_label_chunk_z=5))["label"]).run()
    D.assert_artifact_equal(jax_info, port_info, "im_instance_label", "exact")
    assert D.read(port_info, "im_instance_label").max() > 0
