"""Profile stages of the PyTorch port on one NVIDIA GPU.

    python3 scripts/profile_torch_port.py [--shape 5 1024 1024] [--stages reassign hierarchy]

Writes the main-path series of ``chip_smoke.py`` at ``--shape`` (T, Y, X
for the 2D movie, T, Z, Y, X for the 3D series), runs the seven stages
once on the card (kernel build and warm-up), then runs each named stage
again under ``torch.profiler`` and prints, per stage: wall seconds, the
CUDA kernels' summed device time, the busy share (device time over wall
time), the number of CUDA kernels launched, the host seconds inside the
flow interpolation (``_interp_all_kernel``, a profiler range), and the
aten ops with the most calls.  The profiler adds host time of its own,
so the wall seconds here are above ``run``'s.  Processing the
profiler's events takes most of the run: on an H100 the default 2D movie
needs about 15 minutes.  Exits non-zero without CUDA.
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


def _stage(name, im_info):
    from nellie_tpu_torch.stages.hierarchical import Hierarchy
    from nellie_tpu_torch.stages.voxel_reassignment import VoxelReassigner

    if name == "reassign":
        return VoxelReassigner(im_info, device="cuda")
    if name == "hierarchy":
        return Hierarchy(im_info, skip_nodes=False, device="cuda")
    raise ValueError(f"unknown stage {name!r}: use reassign or hierarchy")


def profile_stage(name, im_info, gpu):
    from torch.profiler import ProfilerActivity, profile

    stage = _stage(name, im_info)
    torch.cuda.synchronize()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stage.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - start
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e6
    averages = prof.key_averages()
    interp = sum(e.cpu_time_total for e in averages if e.key == "interp") / 1e6
    print(f"profile {name}: wall {wall:.3f} s under the profiler, device busy {busy:.3f} s, "
          f"busy share {busy / wall:.3f}, CUDA kernels {len(kernels)}, host time in the flow "
          f"interpolation {interp:.3f} s [{gpu}]", flush=True)
    aten = sorted((e for e in averages if e.key.startswith("aten::")), key=lambda e: -e.count)
    for e in aten[:8]:
        print(f"  {e.key}: {e.count} calls, host {e.cpu_time_total / 1e6:.3f} s", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", type=int, nargs="+", default=list(chip_smoke.MAIN_SHAPE_2D))
    parser.add_argument("--stages", nargs="+", default=["reassign", "hierarchy"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: profiling needs an NVIDIA GPU")
    from nellie_tpu_torch.pipeline.run import run
    from nellie_tpu_torch.stages import flow_interpolation, voxel_reassignment

    gpu = chip_smoke.gpu_line()
    print(gpu, flush=True)
    ranged = _ranged(flow_interpolation._interp_all_kernel, "interp")
    flow_interpolation._interp_all_kernel = ranged
    voxel_reassignment._interp_all_kernel = ranged
    with tempfile.TemporaryDirectory(prefix="nellie_port_profile_") as root:
        fi = chip_smoke.write_series(root, tuple(args.shape))
        im_info, timings = run(fi, device="cuda", return_timings=True)
        print("warm-up run: " + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
              + f" [{gpu}]", flush=True)
        for name in args.stages:
            profile_stage(name, im_info, gpu)


if __name__ == "__main__":
    main()
