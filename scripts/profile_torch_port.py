"""Profile stages of the PyTorch port on one NVIDIA GPU.

    python3 scripts/profile_torch_port.py [--shape 5 1024 1024]
        [--stages filter label network markers tracking reassign hierarchy]

Writes the main-path series of ``chip_smoke.py`` at ``--shape`` (T, Y, X
for the 2D movie, T, Z, Y, X for the 3D series), runs the seven stages
once on the card (kernel build and warm-up), then runs each named stage
again on its own under ``torch.profiler`` and prints, per stage: wall
seconds, the CUDA kernels' summed device time, the busy share (device
time over wall time), the number of CUDA kernels launched, the host
syncs, the aten ops with the most calls, and the same split for each
profiler range inside the stage: the flow interpolation
(``_interp_all_kernel``), the 3D thinning (``skeletonize_3d``), the
nearest seed (``nearest_seed``), the distance transform
(``distance_transform``), the histogram thresholds (``min_triangle_otsu``,
``otsu_threshold``, ``triangle_threshold``, ``triangle_and_otsu``), the percentile mask
(``masked_percentile_forms``) and the tracker's log-Hu features, pair sums,
pair costs and ROI statistics (``hu_features``, ``pair_stats``,
``pair_costs``, ``masked_mean_variance``), each with its calls, wall (host) seconds,
device seconds, kernel launches and host syncs (``cudaStreamSynchronize``
and the other synchronising runtime calls).  The profiler adds host time
of its own, so the wall seconds here are above ``run``'s.  Processing the
profiler's events takes most of the run: on an H100 the reassigner and
Hierarchy of the default 2D movie need about 15 minutes.  Exits non-zero
without CUDA.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the repo root is on the path from here on)


def _ranged(fn, name):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


STAGES = ("filter", "label", "network", "markers", "tracking", "reassign", "hierarchy")
RANGES = ("interp", "skeletonize_3d", "nearest_seed", "distance_transform", "min_triangle_otsu",
          "otsu_threshold", "triangle_threshold", "triangle_and_otsu",
          "masked_percentile_forms", "hu_features", "pair_stats", "pair_costs",
          "masked_mean_variance")


def _stage(name, im_info):
    from nellie_tpu_torch.stages.filtering import Filter
    from nellie_tpu_torch.stages.hierarchical import Hierarchy
    from nellie_tpu_torch.stages.hu_tracking import HuMomentTracking
    from nellie_tpu_torch.stages.labelling import Label
    from nellie_tpu_torch.stages.mocap_marking import Markers
    from nellie_tpu_torch.stages.networking import Network
    from nellie_tpu_torch.stages.voxel_reassignment import VoxelReassigner

    stages = {"filter": Filter, "label": Label, "network": Network, "markers": Markers,
              "tracking": HuMomentTracking, "reassign": VoxelReassigner}
    if name in stages:
        return stages[name](im_info, device="cuda")
    if name == "hierarchy":
        return Hierarchy(im_info, skip_nodes=False, device="cuda")
    raise ValueError(f"unknown stage {name!r}: use one of {', '.join(STAGES)}")


def _install_ranges():
    """Wrap the kernels that the ranges name, where their callers look
    them up."""
    from nellie_tpu_torch.kernels import edt, frangi, matching, moments, skeleton, thresholds
    from nellie_tpu_torch.stages import flow_interpolation, voxel_reassignment

    ranged = _ranged(flow_interpolation._interp_all_kernel, "interp")
    flow_interpolation._interp_all_kernel = ranged
    voxel_reassignment._interp_all_kernel = ranged
    skeleton.skeletonize_3d = _ranged(skeleton.skeletonize_3d, "skeletonize_3d")
    edt.nearest_seed = _ranged(edt.nearest_seed, "nearest_seed")
    edt.distance_transform = _ranged(edt.distance_transform, "distance_transform")
    for module, name in ((thresholds, "min_triangle_otsu"), (thresholds, "otsu_threshold"),
                         (thresholds, "triangle_threshold"), (thresholds, "triangle_and_otsu"),
                         (frangi, "masked_percentile_forms"), (moments, "hu_features"),
                         (matching, "pair_stats"), (matching, "pair_costs"),
                         (moments, "masked_mean_variance")):
        setattr(module, name, _ranged(getattr(module, name), name))


def _is_sync(event):
    return event.name.startswith("cuda") and event.name.endswith("Synchronize")


def _subtree(event):
    stack = [event]
    while stack:
        e = stack.pop()
        yield e
        stack.extend(e.cpu_children)


def range_split(events):
    """{range: (calls, host s, device s, launches, host syncs)} over the
    profiler's top-level events of each name in ``RANGES``."""
    split = {}
    for e in events:
        if (e.name not in RANGES or e.device_type != torch.autograd.DeviceType.CPU
                or (e.cpu_parent is not None and e.cpu_parent.name == e.name)):
            continue
        calls, host, device, launches, syncs = split.get(e.name, (0, 0.0, 0.0, 0, 0))
        inner = list(_subtree(e))
        split[e.name] = (calls + 1, host + e.cpu_time_total / 1e6,
                         device + sum(k.duration for x in inner for k in x.kernels) / 1e6,
                         launches + sum(len(x.kernels) for x in inner),
                         syncs + sum(1 for x in inner if _is_sync(x)))
    return split


def profile_stage(name, im_info, gpu):
    from torch.profiler import ProfilerActivity, profile

    stage = _stage(name, im_info)
    torch.cuda.synchronize()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stage.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - start
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e6
    syncs = sum(1 for e in events if _is_sync(e))
    print(f"profile {name}: wall {wall:.3f} s under the profiler, device busy {busy:.3f} s, "
          f"busy share {busy / wall:.3f}, CUDA kernels {len(kernels)}, host syncs {syncs} "
          f"[{gpu}]", flush=True)
    for key, (calls, host, device, launches, n_sync) in sorted(range_split(events).items()):
        print(f"  range {key}: {calls} calls, wall {host:.3f} s, device {device:.3f} s, "
              f"launches {launches}, host syncs {n_sync} [{gpu}]", flush=True)
    aten = sorted((e for e in prof.key_averages() if e.key.startswith("aten::")),
                  key=lambda e: -e.count)
    for e in aten[:8]:
        print(f"  {e.key}: {e.count} calls, host {e.cpu_time_total / 1e6:.3f} s", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", type=int, nargs="+", default=list(chip_smoke.MAIN_SHAPE_2D))
    parser.add_argument("--stages", nargs="+", default=list(STAGES), choices=STAGES)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: profiling needs an NVIDIA GPU")
    from nellie_tpu_torch.pipeline.run import run

    gpu = chip_smoke.gpu_line()
    print(gpu, flush=True)
    _install_ranges()
    with tempfile.TemporaryDirectory(prefix="nellie_port_profile_") as root:
        fi = chip_smoke.write_series(root, tuple(args.shape))
        im_info, timings = run(fi, device="cuda", return_timings=True)
        print("warm-up run: " + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
              + f" [{gpu}]", flush=True)
        for name in args.stages:
            profile_stage(name, im_info, gpu)


if __name__ == "__main__":
    main()
