"""Parity of the PyTorch port against the JAX package on the CPU, as numbers.

    python scripts/torch_parity_report.py [--port DIR]

Runs the JAX package and the port (``nellie_tpu_torch`` imported from
``DIR``, default this checkout, so that an older checkout can be
measured the same way) on the seeded inputs of ``tests/torch_port_data.py``
and prints one JSON object:

* ``im_preprocessed``: the 3D tube series through Filter, whole frames and
  12x24x24 low-memory windows, whole frames 128 voxels wide (where XLA
  fuses the Hessian's inner gradient), and the 2D series, 64 and 128
  pixels wide: voxels that differ and the largest difference (absolute,
  and relative to the frame max);
* ``pair_stats``: the tracker's masked pair sums on tiles whose padded
  shape takes a second window level (2,048 x 128, 2,048 x 256,
  4,096 x 128): sums that differ, and the largest difference relative to
  the sum;
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
    inputs = {"whole frames": (None, {}),
              "12x24x24 windows": (None, dict(low_memory=True, max_chunk_voxels=12 * 24 * 24)),
              "whole frames 3x12x48x128": (D.tube_series((3, 12, 48, 128)), {}),
              "2D 3x64x64": (D.tube_series_2d(), {}),
              "2D 3x64x128": (D.tube_series_2d((3, 64, 128)), {})}
    for name, (data, kw) in inputs.items():
        ref, port = (D.open_im_info(D.write_input(root / name.replace(" ", "_") / side, data,
                                                  D.DIM_RES_2D, "TYX"))
                     for side in ("jax", "port")) if name.startswith("2D") else \
            D.two_copies(root / name.replace(" ", "_"), data)
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
    report["pair_stats"] = pair_stats_report()
    print(json.dumps(report))


def pair_stats_report():
    import inspect

    import numpy as np
    import torch

    from nellie_tpu.kernels import matching as j_matching
    from nellie_tpu_torch.kernels import matching
    from test_torch_parity_repairs import matcher_tiles, reference_tile

    takes_padding = "padded" in inspect.signature(matching.pair_stats).parameters
    out = {}
    for n_post, n_pre in ((1100, 70), (1100, 200), (2500, 70)):
        cp, cq, fp, fq = matcher_tiles(n_post=n_post, n_pre=n_pre)
        tile = reference_tile(cp, cq, fp, fq)
        _, sums, sumsqs = j_matching.pair_stats(*tile, np.float32(1.0))
        kw = {"padded": (len(tile[0]), len(tile[1]))} if takes_padding else {}
        _, got_s, got_q = matching.pair_stats(*(torch.from_numpy(a) for a in (cp, cq, fp, fq)),
                                              1.0, **kw)
        want = np.concatenate([np.asarray(sums), np.asarray(sumsqs)])
        got = np.concatenate([got_s.numpy(), got_q.numpy()])
        out[f"{len(tile[0])}x{len(tile[1])}"] = {
            "sums_differing": int((got != want).sum()), "sums": int(want.size),
            "max_rel": float((np.abs(got.astype(np.float64) - want) / np.abs(want)).max())}
    return out


if __name__ == "__main__":
    main()
