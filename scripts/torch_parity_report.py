"""Parity of the PyTorch port against the JAX package on the CPU, as numbers.

    python scripts/torch_parity_report.py [--port DIR]

Runs the JAX package and the port (``nellie_tpu_torch`` imported from
``DIR``, default this checkout, so that an older checkout can be
measured the same way) on the seeded inputs of ``tests/torch_port_data.py``
and prints one JSON object:

* ``im_preprocessed``: the 3D tube series through Filter, whole frames and
  12x24x24 low-memory windows: voxels that differ and the largest
  difference (absolute, and relative to the frame max);
* ``slice_flow_cost``: Filter -> tracking on the same series, the largest
  flow-cost difference (``None`` when the flow rows differ);
* ``sparse_flow_cost``: ``mode="sparse"`` tracking on 1,500 markers a frame
  (``tests/test_torch_low_memory.many_markers``), the same.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--port", default=str(REPO),
                        help="directory holding the nellie_tpu_torch to measure")
    args = parser.parse_args()
    sys.path[:0] = [args.port, str(REPO), str(REPO / "tests")]

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import torch_port_data as D
    from nellie_tpu.stages.filtering import Filter as JFilter
    from nellie_tpu.stages.hu_tracking import HuMomentTracking as JTracking
    from nellie_tpu.stages.labelling import Label as JLabel
    from nellie_tpu.stages.mocap_marking import Markers as JMarkers
    from nellie_tpu.stages.networking import Network as JNetwork
    from nellie_tpu_torch.stages.filtering import Filter
    from nellie_tpu_torch.stages.hu_tracking import HuMomentTracking
    from nellie_tpu_torch.stages.labelling import Label
    from nellie_tpu_torch.stages.mocap_marking import Markers
    from nellie_tpu_torch.stages.networking import Network
    from test_torch_low_memory import many_markers, write_artifacts

    root = Path(tempfile.mkdtemp(prefix="torch_parity_"))
    report = {"port": os.path.dirname(sys.modules["nellie_tpu_torch"].__file__)}

    def flow_cost(ref, port):
        a, b = D.read(ref, "flow_vector_array"), D.read(port, "flow_vector_array")
        if a.shape != b.shape or not np.array_equal(a[:, :-1], b[:, :-1]):
            return None
        return float(np.abs(a[:, -1] - b[:, -1]).max())

    report["im_preprocessed"] = {}
    for name, kw in (("whole frames", {}),
                     ("12x24x24 windows", dict(low_memory=True, max_chunk_voxels=12 * 24 * 24))):
        ref, port = D.two_copies(root / name.replace(" ", "_"))
        JFilter(ref, **kw).run()
        Filter(port, device="cpu", **kw).run()
        a, b = D.read(ref, "im_preprocessed"), D.read(port, "im_preprocessed")
        diff = np.abs(a.astype(np.float64) - b)
        report["im_preprocessed"][name] = {
            "voxels_differing": int((a != b).sum()), "voxels": int(a.size),
            "max_abs": float(diff.max()), "max_rel_to_frame_max": float(
                max(diff[t].max() / np.abs(a[t]).max() for t in range(a.shape[0])))}

    ref, port = D.two_copies(root / "slice")
    for j_stage, stage in ((JFilter, Filter), (JLabel, Label), (JNetwork, Network),
                           (JMarkers, Markers), (JTracking, HuMomentTracking)):
        j_stage(ref).run()
        stage(port, device="cpu").run()
    report["slice_flow_cost"] = flow_cost(ref, port)

    im, arrays = many_markers()
    arrays["im_instance_label"] = arrays["im_marker"].astype(np.int32)
    ref, port = D.two_copies(root / "sparse", im)
    for im_info in (ref, port):
        write_artifacts(im_info, arrays)
    JTracking(ref, mode="sparse").run()
    HuMomentTracking(port, device="cpu", mode="sparse").run()
    report["sparse_flow_cost"] = flow_cost(ref, port)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
