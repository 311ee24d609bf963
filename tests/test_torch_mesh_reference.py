"""The port's fused chain over a mesh against the JAX package's, on the CPU.

The same 3D series goes through ``FusedSegmentation(mesh=)`` of both
packages on a 2 x 2 mesh (the JAX package's over four of its eight
virtual CPU devices, the port's over four logical CPU shards): the eight
segmentation artifacts at the bars of ``tests/test_mesh.py``
(``im_preprocessed`` within atol 1e-5, rtol 1e-3; labels exact as in
``test_mesh_t_batched_frames_match_sequential``; the other discrete
artifacts at IoU > 0.99 and ``im_distance`` within 1e-3 on the common
foreground, as in ``test_fused_mesh_shards_four_stages``).  The port's
mesh run equals its one-device run bit for bit
(``tests/test_torch_mesh.py``), and that run the JAX package's one-device
run (``tests/test_torch_fused.py``).  Marked slow, as
``tests/test_mesh.py`` marks the JAX package's own whole-chain mesh tests:
compiling the sharded chain takes about a minute of CPU.

    python -m pytest -m slow tests/test_torch_mesh_reference.py
"""
import numpy as np
import pytest

import torch_port_data as D
from nellie_tpu.mesh import make_mesh as j_make_mesh
from nellie_tpu.pipeline.fused import FusedSegmentation as JFusedSegmentation
from nellie_tpu_torch.mesh import make_mesh
from nellie_tpu_torch.pipeline.fused import FusedSegmentation


@pytest.mark.slow
def test_fused_mesh_matches_the_jax_mesh(tmp_path):
    ref, port = D.two_copies(tmp_path)
    JFusedSegmentation(ref, mesh=j_make_mesh(4, t_axis=2)).run()
    FusedSegmentation(port, mesh=make_mesh(devices=["cpu"] * 4, t_axis=2)).run()
    a = {k: D.read(ref, k) for k in D.SEGMENTATION_ARTIFACTS}
    b = {k: D.read(port, k) for k in D.SEGMENTATION_ARTIFACTS}
    np.testing.assert_allclose(b["im_preprocessed"], a["im_preprocessed"], atol=1e-5, rtol=1e-3)
    np.testing.assert_array_equal(b["im_instance_label"], a["im_instance_label"])
    for key in ("im_skel", "im_pixel_class", "im_skel_relabelled", "im_marker", "im_border"):
        fg_a, fg_b = a[key] > 0, b[key] > 0
        assert (fg_a & fg_b).sum() / max(1, (fg_a | fg_b).sum()) > 0.99, key
    both = (a["im_instance_label"] > 0) & (b["im_instance_label"] > 0)
    assert both.any()
    np.testing.assert_allclose(b["im_distance"][both], a["im_distance"][both], atol=1e-3)
