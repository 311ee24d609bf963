"""Trace where the card's and the CPU's results part.

    python3 scripts/trace_card_vs_cpu.py

1. The flow costs, on the small 3D input of ``chip_smoke.py`` (phase 5's
   3x12x48x48 tube series): runs the port per stage on both devices,
   compares the artifacts that feed tracking, then runs tracking on the
   card on the CPU run's artifacts and, for each frame and frame pair,
   compares the tracker's intermediate values (the log-normalised Frangi
   image and dilated distance, the ROI features, the physical
   coordinates, the masked pair sums and the cost minima), and for the
   first frame each step of the Hu moments of the ROI cubes.
2. The segment statistics (``kernels/segstats.py``): each step of
   ``segment_nanstats`` on seeded values.

Prints how many values differ and by how much at each step.  Needs a
CUDA GPU; imports no JAX.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402

DIM_RES = {"X": 0.2, "Y": 0.2, "Z": 0.5, "T": 1.0}
UPSTREAM = ("im_preprocessed", "im_distance", "im_marker")


def differ(name, a, b):
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b)
    if a.shape != b.shape:
        print(f"  {name}: shapes {a.shape} vs {b.shape}", flush=True)
        return True
    if a.dtype.kind == "f":
        bad = (a != b) & ~(np.isnan(a) & np.isnan(b))
        worst = float(np.nanmax(np.abs(a.astype(np.float64) - b))) if bad.any() else 0.0
    else:
        bad = a != b
        worst = float(np.abs(a.astype(np.float64) - b).max()) if bad.any() else 0.0
    print(f"  {name}: {int(bad.sum())} of {a.size} differ, max |diff| {worst:.3g}", flush=True)
    return bool(bad.any())


def main() -> None:
    if not torch.cuda.is_available():
        smoke.fail("needs a CUDA GPU")
    from nellie_tpu_torch.io import ImInfo
    from nellie_tpu_torch.kernels import matching
    from nellie_tpu_torch.pipeline.run import run
    from nellie_tpu_torch.stages import hu_tracking as ht

    print(smoke.gpu_line(), flush=True)
    data = smoke.small_series()
    root = tempfile.mkdtemp(prefix="nellie_flow_gap_")
    try:
        infos = {}
        for dev in ("cpu", "cuda"):
            fi = smoke.write_input(os.path.join(root, dev), "small", data, "TZYX", DIM_RES)
            infos[dev] = run(fi, device=dev, fused=False)
        print("whole runs, card vs CPU:", flush=True)
        for name in UPSTREAM + ("flow_vector_array",):
            differ(name, smoke.artifact(infos["cuda"], name), smoke.artifact(infos["cpu"], name))

        # tracking on the card on the CPU run's artifacts
        fi = smoke.write_input(os.path.join(root, "alone"), "small", data, "TZYX", DIM_RES)
        alone = ImInfo(fi)
        for name in UPSTREAM:
            shutil.copyfile(infos["cpu"].pipeline_paths[name], alone.pipeline_paths[name])
        ht.HuMomentTracking(alone, device="cuda").run()
        print("tracking alone on the CPU run's artifacts, card vs CPU:", flush=True)
        differ("flow_vector_array", smoke.artifact(alone, "flow_vector_array"),
               smoke.artifact(infos["cpu"], "flow_vector_array"))

        trackers = {dev: ht.HuMomentTracking(alone, device=dev) for dev in ("cpu", "cuda")}
        for tr in trackers.values():
            tr._allocate_memory()
        prev = {}
        for t in range(data.shape[0]):
            print(f"frame {t}:", flush=True)
            frangi = {d: tr._frame("im_preprocessed", tr.im_frangi_memmap, t)
                      for d, tr in trackers.items()}
            distance = {d: tr._frame("im_distance", tr.im_distance_memmap, t)
                        for d, tr in trackers.items()}
            prep = {d: ht._prep_frame_kernel(frangi[d], distance[d]) for d in trackers}
            differ("log-normalised frangi", prep["cuda"][0], prep["cpu"][0])
            differ("dilated distance", prep["cuda"][1], prep["cpu"][1])
            feats = {d: tr._get_frame_features(t) for d, tr in trackers.items()}
            differ("ROI features", feats["cuda"].feats, feats["cpu"].feats)
            cols = feats["cpu"].feats.shape[1]
            for c in range(cols):
                a, b = feats["cuda"].feats[:, c].cpu(), feats["cpu"].feats[:, c]
                if not torch.equal(a, b):
                    differ(f"  feature column {c}", a, b)
            differ("physical coordinates", feats["cuda"].coords_phys, feats["cpu"].coords_phys)
            if t == 0:
                hu_steps(trackers, t)
            if prev:
                n_post, n_pre = feats["cpu"].n, prev["cpu"].n
                pad = (matching.bucket(n_post, 1024), matching.bucket(n_pre, 1024))
                stats = {d: matching.pair_stats(
                    feats[d].coords_phys, prev[d].coords_phys, feats[d].feats, prev[d].feats,
                    smoke_max_d(trackers[d]), padded=pad) for d in trackers}
                print(f"  pair count card {stats['cuda'][0]}, CPU {stats['cpu'][0]}", flush=True)
                differ("pair sums", stats["cuda"][1], stats["cpu"][1])
                differ("pair sums of squares", stats["cuda"][2], stats["cpu"][2])
                mean, std = matching._moments(stats["cpu"][0],
                                              stats["cpu"][1].numpy().astype(np.float64),
                                              stats["cpu"][2].numpy().astype(np.float64))
                costs = {}
                for d in trackers:
                    dev = feats[d].feats.device
                    costs[d] = matching.pair_costs(
                        feats[d].coords_phys, prev[d].coords_phys, feats[d].feats, prev[d].feats,
                        smoke_max_d(trackers[d]),
                        torch.from_numpy(mean.astype(np.float32)).to(dev),
                        torch.from_numpy(std.astype(np.float32)).to(dev), ht.N_STATS)
                for i, name in enumerate(("row minima", "row argmin", "column minima",
                                          "column argmin")):
                    differ(name, costs["cuda"][i], costs["cpu"][i])
            prev = feats
    finally:
        shutil.rmtree(root, ignore_errors=True)
    segstats_steps()


def hu_steps(trackers, t):
    """Each step of the 3D Hu features of frame t's ROI cubes, card
    against CPU, on the same cubes."""
    from nellie_tpu_torch.kernels import moments
    from nellie_tpu_torch.stages import hu_tracking as ht

    cubes = {}
    original = moments.hu_3d
    for dev, tr in trackers.items():
        def capture(volumes, looped=False, _dev=dev):
            cubes[_dev] = volumes
            return original(volumes, looped)
        moments.hu_3d = capture
        try:
            tr._get_frame_features(t)
        finally:
            moments.hu_3d = original
    differ("ROI cubes", cubes["cuda"], cubes["cpu"])
    idx = torch.arange(4)
    exponent = ((idx[:, None] + idx[None, :])[None] + 2) / 2.0
    for axis in (1, 2, 3):
        steps = {}
        for dev, vol in cubes.items():
            proj = vol.amax(dim=axis)
            m = moments.raw_moments(proj, order=3)
            mu = moments.central_moments(m)
            power = m[:, 0, 0][:, None, None] ** exponent.to(m.device)
            eta = mu / (power + 1e-12)
            hu = moments.hu_moments(eta, projections=True)
            steps[dev] = dict(raw=m, central=mu, power=power, eta=eta, hu=hu,
                              log_hu=moments.log_hu(hu))
        for name in steps["cpu"]:
            differ(f"projection {axis}: {name}", steps["cuda"][name], steps["cpu"][name])
        m = steps["cpu"]["raw"][:, 0, 0][:, None, None]
        for e in exponent.flatten().unique().tolist():
            card = (m.cuda() ** e).cpu()
            differ(f"projection {axis}: m00 ** {e}", card, m ** e)
            differ(f"projection {axis}: m00 ** {e} in float64, rounded",
                   (m.double().cuda() ** e).float().cpu(), (m.double() ** e).float())


def segstats_steps():
    """Each step of ``segment_nanstats`` on the card against the CPU."""
    from nellie_tpu_torch.kernels import segstats

    print("segment statistics:", flush=True)
    rng = np.random.default_rng(0)
    values = rng.normal(5, 2, (11, 200_000)).astype(np.float32)
    values[rng.random(values.shape) < 0.1] = np.nan
    ids = rng.integers(-1, 3100, 200_000)
    steps = {}
    for dev in ("cpu", "cuda"):
        v = torch.from_numpy(values).to(dev)
        seg = torch.from_numpy(ids).to(dev)
        in_range = (seg >= 0) & (seg < 3000)
        sid = torch.where(in_range, seg, 3000).expand(v.shape)
        valid = ~torch.isnan(v) & in_range[None, :]
        v64 = torch.where(valid, v, 0.0).double()
        sums = segstats._SegmentSums(torch.where(in_range, seg, 3000), 3001)
        cnt = sums(valid.double())
        total = sums(v64)
        mean = total / cnt.clamp(min=1.0)
        centred = torch.where(valid, v64 - mean.gather(1, sid), 0.0)
        square = centred * centred
        ssq = sums(square)
        ratio = ssq / cnt.clamp(min=1.0)
        steps[dev] = dict(v64=v64, cnt=cnt, total=total, mean=mean, centred=centred,
                          square=square, ssq=ssq, ratio=ratio, std=torch.sqrt(ratio.clamp(min=0.0)),
                          sqrt_of_cpu_ratio=None)
    cpu_ratio = steps["cpu"]["ratio"]
    steps["cuda"]["sqrt_of_cpu_ratio"] = torch.sqrt(cpu_ratio.cuda().clamp(min=0.0))
    steps["cpu"]["sqrt_of_cpu_ratio"] = torch.sqrt(cpu_ratio.clamp(min=0.0))
    for name in steps["cpu"]:
        differ(name, steps["cuda"][name], steps["cpu"][name])


def smoke_max_d(tracker):
    from nellie_tpu_torch.kernels._fp import f32

    return f32(tracker.max_distance_um)


if __name__ == "__main__":
    main()
