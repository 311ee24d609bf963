"""The Markers stage of both packages on the 3D main series, on the CPU.

    python scripts/markers_main_series.py [--frames 3]

Writes ``chip_smoke.py``'s 3D main series (``chip_smoke.write_series``: the
six-tube frame of 64 x 256 x 256 rolled 3 voxels along Y a timepoint) into a
temporary directory, runs the JAX package's Filter and Label on it (JAX on
the CPU), then on those labels the JAX package's Markers and the port's
(``device="cpu"``), and counts the voxels where ``im_marker``,
``im_distance`` and ``im_border`` differ, frame by frame, with the seconds
each Markers stage took.  The last line is one JSON object of the counts.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=3)
    args = parser.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    import chip_smoke
    import torch_port_data as D
    from nellie_tpu.stages.filtering import Filter as JFilter
    from nellie_tpu.stages.labelling import Label as JLabel
    from nellie_tpu.stages.mocap_marking import Markers as JMarkers
    from nellie_tpu_torch.stages.mocap_marking import Markers

    torch.set_num_threads(1)
    root = tempfile.mkdtemp(prefix="markers_main_")
    try:
        chip_smoke.write_series(root, (args.frames,) + chip_smoke.MAIN_SHAPE[1:])
        im_info = D.open_im_info(os.path.join(root, "series.ome.tif"))
        JFilter(im_info).run()
        JLabel(im_info).run()
        names = ("im_marker", "im_distance", "im_border")
        start = time.perf_counter()
        JMarkers(im_info).run()
        seconds = {"jax": time.perf_counter() - start}
        want = {name: D.read(im_info, name) for name in names}
        start = time.perf_counter()
        Markers(im_info, device="cpu").run()
        seconds["port"] = time.perf_counter() - start
        got = {name: D.read(im_info, name) for name in names}
        counts = {name: [int((np.asarray(w[t]) != np.asarray(g[t])).sum())
                         for t in range(args.frames)] for name, (w, g) in
                  ((n, (want[n], got[n])) for n in names)}
        markers = [int(np.asarray(want["im_marker"][t]).sum()) for t in range(args.frames)]
        print(f"3D main series, {args.frames} frames of {chip_smoke.MAIN_SHAPE[1:]}: the "
              f"reference's markers {markers}; voxels differing a frame: {counts}; Markers "
              f"seconds on the CPU: {seconds}", flush=True)
        print(json.dumps({"markers": markers, "differing": counts, "seconds": seconds}))
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
