"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. the device: name, ``nvidia-smi`` name and power limit, torch/CUDA versions;
2. builds the nearest-neighbour CUDA kernel from the checkout, times the
   build and prints its registers, spills and resident warps per SM;
3. checks the kernel against its plain PyTorch version on the card (ragged
   shapes, exact ties on a grid, 150,000 voxels each way) and times both;
   then holds its d2 bit for bit, and its indices, to the plain version on
   CPU copies at the split edges: 20,000 voxels each way, duplicates in
   other reference splits, d2 cancelling to <= 0, one query against 10**6
   references, every width d from 1 to 8;
4. drives ``nellie_tpu_torch.pipeline.run.run`` on a 3x64x256x256 uint16
   confocal-like time series (Filter -> ... -> VoxelReassigner ->
   Hierarchy), prints each stage's seconds, the Hierarchy's host share,
   the rows of every feature CSV, the peak device memory and the kernel's
   launches by stage, and checks the outputs and that both the reassigner
   and the Hierarchy launched the kernel; then checks the kernel again at
   the shapes each of them gave it (bit for bit against the CPU) and
   prints its time beside the plain version's, one PyTorch call's
   (``library_ms``: ``torch.cdist`` and ``min``, which the port never
   calls) and its bound (``bound_ms``) with the share of it reached;
5. runs the same pipeline on a small input on the card and on the CPU and
   holds the two against each other, the feature CSVs and the adjacency
   pickle included.

The last line is ``{"ok": true, "device": {...}}``.  Without CUDA the script
exits non-zero before printing any result.  It imports no JAX.
"""
from __future__ import annotations

import csv
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

MAIN_SHAPE = (3, 64, 256, 256)
DIM_RES = {"X": 0.2, "Y": 0.2, "Z": 0.5, "T": 2.0}
SMALL_SHAPE = (3, 12, 48, 48)
NN_MAIN_ROWS = 150_000
FEATURE_RTOL = FEATURE_ATOL = 1e-4  # the reference's features bar
REL_COLUMNS = ("rel_linear_vel", "rel_angular_vel", "rel_linear_acc", "rel_angular_acc",
               "rel_directionality")
HIERARCHY_INPUTS = ("im_preprocessed", "im_instance_label", "im_skel", "im_pixel_class",
                    "im_skel_relabelled", "im_distance", "im_border",
                    "im_branch_label_reassigned", "im_obj_label_reassigned", "flow_vector_array")
TIE_REL = 1e-6   # an index may differ only where the two candidates' float64
                 # squared distances differ by <= TIE_REL * (|q|^2 + |r|^2)
# published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

def nn_mismatches(q, r, idx_a, idx_b):
    """Indices that differ without a float64 near-tie to excuse them."""
    q64 = q.double()
    r64 = r.double()
    ia, ib = idx_a.long(), idx_b.long()
    da = ((q64 - r64[ia]) ** 2).sum(1)
    db = ((q64 - r64[ib]) ** 2).sum(1)
    scale = (q64 * q64).sum(1) + torch.maximum((r64[ia] ** 2).sum(1), (r64[ib] ** 2).sum(1))
    bad = (ia != ib) & ((da - db).abs() > TIE_REL * scale)
    return int((ia != ib).sum()), int(bad.sum())


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """The device time of one call of ``fn``: the sum of the times of the
    CUDA kernels it launches, from ``torch.profiler``, over ``reps`` calls.
    Unlike :func:`time_ms` it leaves out the host's time between launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if not us:
        fail("torch.profiler recorded no device time")
    return us / reps / 1e3


def check_case(name, q, r, nn):
    d2_k, idx_k = nn.NN_KERNEL(q, r)
    torch.cuda.synchronize()
    d2_p, idx_p = nn.nn_argmin_plain(q, r)
    differ, bad = nn_mismatches(q, r, idx_k, idx_p)
    scale = (q.double() ** 2).sum(1) + (r.double()[idx_p.long()] ** 2).sum(1)
    d_err = (d2_k.double() - d2_p.double()).abs()
    d_bad = int((d_err > TIE_REL * scale + 1e-30).sum())
    max_abs = float(d_err.max())
    print(f"nn check {name}: Q={q.shape[0]} M={r.shape[0]} d={q.shape[1]} "
          f"index differences {differ} (unexcused {bad}), d2 max abs err {max_abs:.3e} "
          f"(over tolerance {d_bad})", flush=True)
    if bad or d_bad:
        fail(f"nn kernel disagrees with its plain version on {name}")
    return max_abs


def nn_bound(n_q, n_r, d):
    """(bound_ms, bound_by): the least time the card could take for one
    call.  Operations: Q * M pairs of 2d + 2 float32 flops (the dot's d
    multiplies and d - 1 adds, |q|^2 + |r|^2, the doubling and the
    subtraction) at the fp32 peak.  Bytes: queries and references read
    once, d2 and index written once, at the memory rate."""
    ops_ms = n_q * n_r * (2 * d + 2) / FP32_FLOPS * 1e3
    bytes_ms = (4 * d * (n_q + n_r) + 8 * n_q) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def check_bitwise(name, q, r, nn):
    """The kernel on the card against the plain version on CPU copies: d2
    bit for bit and equal indices, or fail.  Returns the plain (d2, idx)."""
    d2_k, idx_k = nn.NN_KERNEL(q, r)
    d2_k, idx_k = d2_k.cpu(), idx_k.cpu()
    d2_p, idx_p = nn.nn_argmin_plain(q.cpu(), r.cpu())
    bits = int((d2_k.view(torch.int32) != d2_p.view(torch.int32)).sum())
    moved = int((idx_k != idx_p).sum())
    print(f"nn bitwise {name}: Q={q.shape[0]} M={r.shape[0]} d={q.shape[1]} "
          f"d2 differing in any bit {bits}, indices differing {moved}", flush=True)
    if bits or moved:
        fail(f"nn kernel is not bitwise equal to the CPU plain version on {name}")
    return d2_p, idx_p


def phase_split_edges(nn):
    """The cases where the reference splits meet, bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"

    def voxels(n_q, n_r, d=3):
        scale = torch.tensor([0.5, 0.2, 0.2, 0.3, 0.4, 0.25, 0.1, 0.6][:d], device=dev)
        extent = torch.tensor([64, 256, 256, 32, 16, 16, 8, 8][:d], device=dev)
        r = torch.floor(torch.rand(n_r, d, generator=gen, device=dev) * extent) * scale
        q = (torch.rand(n_q, d, generator=gen, device=dev) * extent
             + torch.randn(n_q, d, generator=gen, device=dev)) * scale
        return q, r

    check_bitwise("20000 voxels each way", *voxels(20000, 20000), nn)
    q, base = voxels(5000, 20000)
    r = torch.cat([base, base, base])
    plan = nn.launch_plan(q.shape[0], r.shape[0])
    _, idx = check_bitwise(f"each reference three times, {plan.splits} splits of "
                           f"{plan.split_len}", q, r, nn)
    if int(idx.max()) >= base.shape[0]:
        fail("a duplicate in a later split won over the first copy")
    r = torch.rand(30000, 3, generator=gen, device=dev) * 2000 + 3000
    q = torch.cat([r[torch.randperm(30000, generator=gen, device=dev)[:4000]],
                   torch.rand(1000, 3, generator=gen, device=dev) * 2000 + 3000])
    d2, _ = check_bitwise("queries on far references (cancellation)", q, r, nn)
    negative, zero = int((d2[:4000] < 0).sum()), int((d2[:4000] == 0).sum())
    print(f"nn cancellation: of 4000 queries on a reference, d2 < 0 for {negative}, "
          f"== 0 for {zero}", flush=True)
    if not negative or not zero:
        fail("the cancellation case produced no negative or no zero d2")
    check_bitwise("one query", *voxels(1, 1_000_000), nn)
    for d in range(1, 9):
        check_bitwise(f"width {d}", *voxels(3000, 7001, d), nn)


def phase_kernel(nn, gpu):
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    max_abs = 0.0
    for qn, mn, d in ((1, 1, 3), (37, 5, 3), (513, 2049, 3), (1000, 3001, 2), (700, 900, 8)):
        q = torch.rand(qn, d, generator=gen, device=dev) * 40
        r = torch.rand(mn, d, generator=gen, device=dev) * 40
        max_abs = max(max_abs, check_case(f"ragged {qn}x{mn}", q, r, nn))

    # exact ties: integer grid references, queries at half-integer offsets
    g = torch.stack(torch.meshgrid(*[torch.arange(12, device=dev)] * 3, indexing="ij"), -1)
    r = g.reshape(-1, 3).float()
    q = (torch.randint(0, 22, (4000, 3), generator=gen, device=dev).float() / 2.0)
    d2_k, idx_k = nn.NN_KERNEL(q, r)
    d2_p, idx_p = nn.nn_argmin_plain(q, r)
    d64 = ((q.double()[:, None, :] - r.double()[None]) ** 2).sum(-1)
    first = torch.argmin(d64, dim=1)  # first index of the exact minimum
    ties = int(((d64 == d64.min(dim=1, keepdim=True).values).sum(1) > 1).sum())
    wrong = int((idx_k.long() != first).sum())
    print(f"nn check grid ties: Q=4000 M={r.shape[0]} queries with exact ties {ties}, "
          f"kernel not at the lowest tied index {wrong}, plain not {int((idx_p.long() != first).sum())}",
          flush=True)
    if wrong:
        fail("the kernel broke an exact tie away from the lowest index")

    # one main-path shape: voxel coordinates of a 64x256x256 frame in microns
    scale = torch.tensor([0.5, 0.2, 0.2], device=dev)
    extent = torch.tensor([64, 256, 256], device=dev)
    vox = torch.rand(NN_MAIN_ROWS, 3, generator=gen, device=dev) * extent
    r = torch.floor(vox) * scale
    q = (vox + torch.randn(NN_MAIN_ROWS, 3, generator=gen, device=dev)) * scale
    max_abs = max(max_abs, check_case(f"{NN_MAIN_ROWS} voxels", q, r, nn))
    ms = time_ms(lambda: nn.NN_KERNEL(q, r), 10)
    on_device_ms = device_ms(lambda: nn.NN_KERNEL(q, r), 10)
    plain_ms = time_ms(lambda: nn.nn_argmin_plain(q, r), 2)
    bound_ms, bound_by = nn_bound(NN_MAIN_ROWS, NN_MAIN_ROWS, 3)
    print(f"nn time at {NN_MAIN_ROWS}x{NN_MAIN_ROWS}x3: kernel {ms:.3f} ms a call (on the "
          f"device {on_device_ms:.3f} ms), "
          f"plain {plain_ms:.3f} ms, library not measured (its distance matrix would be "
          f"{NN_MAIN_ROWS ** 2 * 4 / 1e9:.0f} GB), bound {bound_ms:.3f} ms ({bound_by}), "
          f"share {bound_ms / ms:.3f} [{gpu}]", flush=True)
    phase_split_edges(nn)
    return max_abs


def library_nn(q, r):
    """One PyTorch call for the same function (the yardstick; the port
    never calls it): Euclidean distances through a GEMM, then the row
    minimum and its index."""
    return torch.cdist(q, r, compute_mode="use_mm_for_euclid_dist").min(dim=1)


def time_kernel_at(nn, gpu, name, q, r):
    """Time the kernel on (q, r) beside the plain version and the library
    call, then check it against the plain version on the card and bit for
    bit on the CPU (after the timing, so that no CPU work overlaps it).
    Returns the numbers of its ``paths`` entry."""
    plain_ms = time_ms(lambda: nn.nn_argmin_plain(q, r), 5)
    ms = time_ms(lambda: nn.NN_KERNEL(q, r), 20)
    library_ms = time_ms(lambda: library_nn(q, r), 5)
    ms_again = time_ms(lambda: nn.NN_KERNEL(q, r), 20)
    on_device_ms = device_ms(lambda: nn.NN_KERNEL(q, r), 20)
    bound_ms, bound_by = nn_bound(q.shape[0], r.shape[0], q.shape[1])
    print(f"nn time at {name} {q.shape[0]}x{r.shape[0]}x{q.shape[1]}: kernel {ms:.4f} ms a call "
          f"(again {ms_again:.4f} ms; on the device {on_device_ms:.4f} ms), plain {plain_ms:.4f} ms, "
          f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"share {bound_ms / ms:.3f} [{gpu}]", flush=True)
    max_abs = check_case(name, q, r, nn)
    check_bitwise(name, q, r, nn)
    return {"max_abs_err": max_abs, "ms": ms, "device_ms": on_device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_kernel_main_shapes(nn, gpu, im_info):
    """The kernel at the shapes the main path gave it.  The reassigner
    matches the voxels of frame 0's objects (in microns) against those of
    frame 1; the Hierarchy measures the border distance of frame 0's
    skeleton and node voxels against its border voxels."""
    labels = artifact(im_info, "im_instance_label")
    branches = artifact(im_info, "im_skel_relabelled")
    skel = artifact(im_info, "im_skel")
    pixel_class = artifact(im_info, "im_pixel_class")
    border = artifact(im_info, "im_border")
    scale = torch.tensor([DIM_RES["Z"], DIM_RES["Y"], DIM_RES["X"]], device="cuda")

    def microns(mask):
        return torch.from_numpy(np.argwhere(mask).astype(np.float32)).to("cuda") * scale

    reassign = time_kernel_at(nn, gpu, "the reassigner's frames 0->1",
                              *[microns((labels[t] > 0) | (branches[t] > 0)) for t in (0, 1)])
    hierarchy = time_kernel_at(nn, gpu, "the Hierarchy's frame 0 border",
                               microns((skel[0] > 0) | (pixel_class[0] > 0)), microns(border[0] > 0))
    return reassign, hierarchy


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def make_frame(shape, seed=0):
    """Six wavy tubes plus camera-like noise (the repo's end-to-end input)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    vol = np.zeros(shape, np.float32)
    for i in range(6):
        cy = 30 + 32 * i
        vol += 800.0 * np.exp(
            -(((z - 32 - 8 * np.sin((x + 20 * i) / 30.0)) ** 2) * 0.3
              + (y - cy + 10 * np.sin(x / 17.0)) ** 2 / 2) / (2 * 2.2 ** 2))
    return np.clip(vol + rng.normal(100, 5, shape), 0, None).astype(np.float32)


def write_series(directory, shape):
    from nellie_tpu_torch.io import FileInfo, ome, tiff

    t_n, *vol = shape
    frame = make_frame(tuple(vol))
    data = np.stack([np.roll(frame, shift=3 * t, axis=1) for t in range(t_n)])
    data = np.clip(data, 0, 65535).astype(np.uint16)
    desc = ome.build_ome_xml("TZYX", data.shape, "uint16", dim_res=DIM_RES)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "series.ome.tif")
    tiff.imwrite(path, data, description=desc)
    fi = FileInfo(path)
    fi.find_metadata()
    fi.load_metadata()
    return fi


def artifact(im_info, name):
    path = im_info.pipeline_paths[name]
    if path.endswith(".npy"):
        return np.load(path, allow_pickle=True)
    return np.array(im_info.get_memmap(path, read_mode="r"))


class StageWatch:
    """Counts the kernel's launches in each watched stage's ``run`` and
    keeps the stage objects, for the duration of a ``with`` block."""

    def __init__(self, nn, classes):
        self.nn = nn
        self.classes = classes
        self.launches = {}
        self.stages = {}
        self._saved = {}

    def __enter__(self):
        for cls in self.classes:
            original = cls.run
            self._saved[cls] = original

            def watched(stage, _original=original, _name=cls.__name__):
                before = self.nn.NN_KERNEL.launches
                try:
                    return _original(stage)
                finally:
                    self.launches[_name] = self.nn.NN_KERNEL.launches - before
                    self.stages[_name] = stage

            cls.run = watched
        return self

    def __exit__(self, *exc):
        for cls, original in self._saved.items():
            cls.run = original


def expected_headers(skip_nodes):
    """The feature CSVs' columns, in the reference's order."""
    from nellie_tpu_torch.kernels.segstats import STAT_KEYS
    from nellie_tpu_torch.stages import hierarchical as h

    def agg(names):
        return [f"{n}_{k}" for n in names for k in STAT_KEYS]

    def raw(names):
        return [f"{n}_raw" for n in names]

    xyz = ["x_raw", "y_raw", "z_raw"]
    nodes = [] if skip_nodes else agg(h.NODE_STATS)
    heads = {
        "voxels": raw(h.VOXEL_STATS) + xyz,
        "branches": nodes + agg(h.VOXEL_STATS) + raw(h.BRANCH_STATS)
        + ["reassigned_label_raw"] + xyz,
        "organelles": nodes + agg(h.VOXEL_STATS) + agg(h.BRANCH_STATS)
        + raw(h.ORGANELLE_STATS) + ["reassigned_label_raw"] + xyz,
        "image": nodes + agg(h.VOXEL_STATS) + agg(h.BRANCH_STATS) + agg(h.ORGANELLE_STATS),
    }
    if not skip_nodes:
        heads["nodes"] = agg(h.VOXEL_STATS) + raw(h.NODE_STATS) + xyz
    return {k: ["t", "label"] + v for k, v in heads.items()}


def read_table(path):
    """(header, rows as lists of strings) of a feature CSV."""
    if not os.path.exists(path):
        fail(f"{path} was not written")
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        fail(f"{path} is empty")
    return rows[0], rows[1:]


def check_tables(im_info, skip_nodes):
    """Every feature CSV exists with the reference's header; returns the
    rows of each."""
    tables = {}
    for name, header in expected_headers(skip_nodes).items():
        got, rows = read_table(im_info.pipeline_paths[f"features_{name}"])
        if got != header:
            fail(f"features_{name}: header {got[:4]}... ({len(got)} columns) is not the "
                 f"reference's ({len(header)} columns)")
        tables[name] = rows
    return tables


def phase_main_path(nn, gpu, root):
    from nellie_tpu_torch.pipeline.run import run
    from nellie_tpu_torch.stages.hierarchical import Hierarchy
    from nellie_tpu_torch.stages.voxel_reassignment import VoxelReassigner

    fi = write_series(os.path.join(root, "main"), MAIN_SHAPE)
    torch.cuda.reset_peak_memory_stats()
    nn.NN_KERNEL.launches = 0
    with StageWatch(nn, (VoxelReassigner, Hierarchy)) as watch:
        im_info, timings = run(fi, device="cuda", return_timings=True)
    launches = nn.NN_KERNEL.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for stage, seconds in timings.items():
        print(f"stage {stage}: {seconds:.3f} s [{gpu}]", flush=True)
    host = watch.stages["Hierarchy"].host_seconds
    print(f"hierarchy: {timings['hierarchy']:.3f} s, of which CSV formatting and writing "
          f"{host['csv']:.3f} s on the writer thread (waited for at the end: {host['drain']:.3f} s), "
          f"region morphology {host['regionprops']:.3f} s on the host [{gpu}]", flush=True)
    print(f"peak device memory: {peak_gib:.3f} GiB [{gpu}]", flush=True)
    labels = artifact(im_info, "im_instance_label")
    flow = artifact(im_info, "flow_vector_array")
    reassigned = artifact(im_info, "im_obj_label_reassigned")
    matches = artifact(im_info, "voxel_matches")
    pre = artifact(im_info, "im_preprocessed")
    pixel_class = artifact(im_info, "im_pixel_class")
    fg = [int((labels[t] > 0).sum()) for t in range(labels.shape[0])]
    n_matches = sum(len(m[1]) for m in matches)
    print(f"main path: foreground voxels per frame {fg}, objects per frame "
          f"{[int(labels[t].max()) for t in range(labels.shape[0])]}, flow rows {len(flow)}, "
          f"reassigned voxels {int((reassigned[1:] > 0).sum())}, voxel matches {n_matches}, "
          f"nn launches {launches} (reassigner {watch.launches['VoxelReassigner']}, "
          f"hierarchy {watch.launches['Hierarchy']})", flush=True)
    if not np.isfinite(pre).all() or pre.shape != MAIN_SHAPE:
        fail("im_preprocessed is not finite or has the wrong shape")
    if min(fg) == 0:
        fail("a frame came out with no labels")
    if len(flow) == 0 or n_matches == 0:
        fail("no flow rows or no voxel matches")
    if watch.launches["VoxelReassigner"] == 0 or watch.launches["Hierarchy"] == 0:
        fail("the reassigner or the Hierarchy never launched the nn kernel")

    tables = check_tables(im_info, skip_nodes=False)
    print("feature rows: " + ", ".join(f"{k} {len(v)}" for k, v in tables.items()), flush=True)
    if len(tables["voxels"]) != sum(fg):
        fail(f"features_voxels has {len(tables['voxels'])} rows for {sum(fg)} foreground voxels")
    if len(tables["nodes"]) != int((pixel_class > 0).sum()):
        fail("features_nodes does not have one row per skeleton voxel")
    if len(tables["image"]) != MAIN_SHAPE[0] or min(len(v) for v in tables.values()) == 0:
        fail("a feature table has no rows, or the image table not one row per frame")
    for name, rows in tables.items():
        coords = [float(r[i]) for r in rows for i in (-3, -2, -1) if name != "image" and r[i]]
        if not all(math.isfinite(c) for c in coords):
            fail(f"features_{name} has non-finite coordinates")
    with open(im_info.pipeline_paths["adjacency_maps"], "rb") as f:
        adjacency = pickle.load(f)
    if sorted(adjacency) != ["b_o", "n_b", "n_o", "v_b", "v_n", "v_o"] or any(
            len(v) != MAIN_SHAPE[0] for v in adjacency.values()):
        fail("adjacency_maps.pkl lacks a key or a frame")
    return launches, watch.launches, im_info


# ---------------------------------------------------------------------------
# phase 5: the card against the CPU on a small input
# ---------------------------------------------------------------------------

def phase_small_parity(root):
    from nellie_tpu_torch.pipeline.run import run

    t_n, z_n, y_n, x_n = SMALL_SHAPE
    z, y, x = np.mgrid[0:z_n, 0:y_n, 0:x_n].astype(np.float64)
    rng = np.random.default_rng(0)
    frames = []
    for t in range(t_n):
        vol = 900.0 * np.exp(-(((z - z_n / 2) ** 2)
                               + (y - 0.3 * y_n - t - 5 * np.sin(x / 9.0)) ** 2) / (2 * 2.6 ** 2))
        vol += 700.0 * np.exp(-(((z - z_n / 2 + 1) ** 2)
                                + (y - 0.7 * y_n - t + 4 * np.cos(x / 11.0)) ** 2) / (2 * 2.8 ** 2))
        frames.append(np.clip(vol + rng.normal(100, 5, vol.shape), 0, None))
    data = np.stack(frames).astype(np.uint16)

    from nellie_tpu_torch.io import FileInfo, ome, tiff

    infos = {}
    for dev in ("cuda", "cpu"):
        d = os.path.join(root, f"small_{dev}")
        os.makedirs(d)
        path = os.path.join(d, "small.ome.tif")
        tiff.imwrite(path, data, description=ome.build_ome_xml(
            "TZYX", data.shape, "uint16", dim_res={"X": 0.2, "Y": 0.2, "Z": 0.5, "T": 1.0}))
        fi = FileInfo(path)
        fi.find_metadata()
        fi.load_metadata()
        infos[dev] = run(fi, device=dev)
    worst = {}
    for name in ("im_preprocessed", "im_distance"):
        a, b = artifact(infos["cuda"], name), artifact(infos["cpu"], name)
        err = max(float(np.abs(a[t].astype(np.float64) - b[t]).max()) / max(float(np.abs(b[t]).max()), 1e-30)
                  for t in range(a.shape[0]))
        worst[name] = err
        if err > 1e-4:
            fail(f"{name}: card vs CPU error {err:.3g} of the frame max > 1e-4")
    fg = int((artifact(infos["cpu"], "im_instance_label") > 0).sum())
    for name in ("im_instance_label", "im_skel", "im_pixel_class", "im_skel_relabelled",
                 "im_marker", "im_border", "im_branch_label_reassigned", "im_obj_label_reassigned"):
        a, b = artifact(infos["cuda"], name), artifact(infos["cpu"], name)
        diff = int((a != b).sum())
        worst[name] = diff
        if diff > 0.001 * fg:
            fail(f"{name}: {diff} voxels differ between card and CPU (foreground {fg})")
    fa, fb = artifact(infos["cuda"], "flow_vector_array"), artifact(infos["cpu"], "flow_vector_array")
    if fa.shape != fb.shape or fa.shape[0] == 0:
        fail(f"flow_vector_array shapes differ or are empty: {fa.shape} vs {fb.shape}")
    worst["flow_vector_array"] = float(np.abs(fa - fb).max())

    # the whole runs' feature tables, all but the branch-relative columns:
    # a branch's reference voxel (its member of minimum |flow|) is a tie
    # broken by single ulps on fields of equal unit steps, so it may move
    # with the flow costs' last-bit differences above
    want = check_tables(infos["cpu"], skip_nodes=False)
    got = check_tables(infos["cuda"], skip_nodes=False)
    worst["features, whole runs (rel_* aside)"] = compare_tables(
        got, want, expected_headers(False), skip=REL_COLUMNS)

    # the Hierarchy alone on the CPU run's artifacts: every column, and the
    # adjacency edges exactly
    from nellie_tpu_torch.io import ImInfo
    from nellie_tpu_torch.stages.hierarchical import Hierarchy

    d = os.path.join(root, "small_hierarchy")
    os.makedirs(d)
    path = os.path.join(d, "small.ome.tif")
    shutil.copyfile(infos["cpu"].im_path, path)
    fi = FileInfo(path)
    fi.find_metadata()
    fi.load_metadata()
    alone = ImInfo(fi)
    for name in HIERARCHY_INPUTS:
        shutil.copyfile(infos["cpu"].pipeline_paths[name], alone.pipeline_paths[name])
    Hierarchy(alone, skip_nodes=False, device="cuda").run()
    worst["features, Hierarchy on the same artifacts"] = compare_tables(
        check_tables(alone, skip_nodes=False), want, expected_headers(False), skip=())
    with open(alone.pipeline_paths["adjacency_maps"], "rb") as f:
        adj_card = pickle.load(f)
    with open(infos["cpu"].pipeline_paths["adjacency_maps"], "rb") as f:
        adj_cpu = pickle.load(f)
    if list(adj_card) != list(adj_cpu) or any(
            len(adj_card[k]) != len(adj_cpu[k])
            or not all(np.array_equal(a, b) for a, b in zip(adj_card[k], adj_cpu[k]))
            for k in adj_cpu):
        fail("adjacency_maps.pkl differs between card and CPU")
    worst["adjacency edges"] = sum(len(a) for v in adj_cpu.values() for a in v)
    print(f"small input {SMALL_SHAPE}, card vs CPU: {json.dumps(worst)}", flush=True)


def compare_tables(got, want, headers, skip):
    """Largest |card - CPU| / (1e-4 + 1e-4 |CPU|) over the feature tables
    (fails above 1, or on another row count or NaN pattern); columns whose
    names start with ``skip`` are left out."""
    worst = 0.0
    for name, header in headers.items():
        if len(got[name]) != len(want[name]):
            fail(f"features_{name}: {len(got[name])} rows on the card, {len(want[name])} on the CPU")
        cols = [i for i, c in enumerate(header) if not c.startswith(skip)]
        for row_g, row_w in zip(got[name], want[name]):
            for i in cols:
                a, b = row_g[i], row_w[i]
                if (a == "") != (b == ""):
                    fail(f"features_{name} {header[i]}: NaN on one side only ({a!r} vs {b!r})")
                if a:
                    ratio = abs(float(a) - float(b)) / (FEATURE_ATOL + FEATURE_RTOL * abs(float(b)))
                    worst = max(worst, ratio)
                    if ratio > 1:
                        fail(f"features_{name} {header[i]}: card {a} vs CPU {b}")
    return worst


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    from nellie_tpu_torch.device import resolve_device
    from nellie_tpu_torch.kernels import nn

    kind = torch.cuda.get_device_name(0)
    gpu = gpu_line()
    print(f"device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"devices {torch.cuda.device_count()}", flush=True)
    print(gpu, flush=True)

    resolve_device("cuda")  # full float32: TF32 off for the library call too
    start = time.perf_counter()
    nn.NN_KERNEL.build()
    print(f"nn kernel build: {time.perf_counter() - start:.2f} s "
          f"(nvcc {nn.NN_KERNEL.build_seconds if nn.NN_KERNEL.build_seconds is not None else 'cached'})",
          flush=True)
    for d in (3, 8):
        print(f"nn kernel at d={d}: {nn.NN_KERNEL.info(d)}", flush=True)

    max_abs = phase_kernel(nn, gpu)
    root = tempfile.mkdtemp(prefix="nellie_port_smoke_")
    try:
        launches, by_stage, im_info = phase_main_path(nn, gpu, root)
        reassign, hierarchy = phase_kernel_main_shapes(nn, gpu, im_info)
        max_abs = max(max_abs, reassign["max_abs_err"], hierarchy["max_abs_err"])
        phase_small_parity(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    reassign["launches"] = by_stage["VoxelReassigner"]
    hierarchy["launches"] = by_stage["Hierarchy"]
    top = {k: reassign[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    print(json.dumps({"kernels": [{
        "name": "nn_argmin", "route": "cuda",
        "source": "nellie_tpu_torch/kernels/csrc/nn_argmin.cu",
        "replaces": "nellie_tpu/kernels/pallas_nn.py:72",
        "launches": launches, "max_abs_err": max_abs, **top,
        "paths": {"reassign": reassign, "hierarchy": hierarchy}}]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
