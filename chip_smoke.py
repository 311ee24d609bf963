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
   Hierarchy, the first four as the fused chain, ``run``'s default),
   prints each stage's seconds, the Hierarchy's host share, the rows of
   every feature CSV, the peak device memory and the kernel's launches by
   stage, and checks the outputs and that both the reassigner and the
   Hierarchy launched the kernel; runs the series again with
   ``fused=False`` and holds every artifact of the two runs equal byte for
   byte, printing ``seg_fused`` beside the four stages' seconds, the device
   frame cache's peak and ``FusedSegmentation.run(fence_stages=True)``'s
   seconds by stage; then checks the kernel again at
   the shapes each of them gave it (bit for bit against the CPU) and
   prints its time beside the plain version's, one PyTorch call's
   (``library_ms``: ``torch.cdist`` and ``min``, which the port never
   calls) and its bound (``bound_ms``) with the share of it reached;
5. runs the same pipeline on a small input on the card and on the CPU and
   holds the two against each other, the feature CSVs and the adjacency
   pickle included;
6. drives the 2D main path: ``run`` on a 5x1024x1024 uint16 ``TYX`` movie
   (X = Y = 0.1 um, T = 2 s), with phase 4's prints and checks (every frame
   labelled, six-column flow rows, every CSV with the reference's header
   and ``z_raw`` empty, the kernel launched by the reassigner and by the
   Hierarchy, the fused and per-stage runs equal), then the kernel at
   d = 2 at the shapes those two gave it;
7. holds a small ``TYX`` and a ``YX`` input on the card to the CPU, as
   phase 5 does;
8. runs the batch CLI (``nellie_tpu_torch.pipeline.cli.main``) in this
   process on a directory of one ``TYX`` file, one ``YX`` file and one file
   its substring filter skips, and checks each matching file's organelle
   table and that the kernel was launched;
9. holds the capacity path (``pipeline/capacity.py``) on the card to the
   CPU, exactly: ``segment_volume`` on a 24x64x64 volume with the monolith
   and the chunked strategy (on a 3x3x3 cell grid) and all three emits, on
   a 2D image, and ``segment_path`` writing ``im_instance_label``;
10. low memory, card against CPU at phase 5's bars: ``run`` on the small
   ``TZYX`` input with every stage in its low-memory mode (Label in Z
   slabs of ``chunk_z``), with the kernel's launches by stage (the
   low-memory reassigner's among them) and the kernel at the shapes that
   reassigner gave it; then tracking with ``mode="sparse"`` on 1,500
   markers a frame, so that the row-tiled matcher runs in two tiles;
11. the capacity path at 1024^3 (BASELINE config #4): a uint16 volume of
   about 40 tubes on N(100, 8) noise made on the card from a seed,
   ``segment_volume(..., emit="sparse_labels")`` with ``strategy="auto"``
   (the chunked strategy), its seconds by phase, label count, foreground,
   label dtype and peak device memory, and its labels held to
   ``scipy.ndimage.label`` of their support, exactly;
12. the repo's sample movie (``sample_data/synthetic_3d_mitochondria.ome.tif``,
   4x16x128x128 ``TZYX``) through ``run_path`` on the card and on the
   CPU at phase 5's bars, then ``LabelTracks`` of every label from frame 1,
   the flow vectors as tracks and the markers as points, card against CPU,
   with ``LabelTracks``' seconds on the card.

Phases 5, 7 and 12 run the fused chain (``run``'s default); phase 10's
low-memory config takes the per-stage path.

The last line is ``{"ok": true, "device": {...}}``.  Without CUDA the script
exits non-zero before printing any result.  It imports no JAX.
"""
from __future__ import annotations

import csv
import filecmp
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
MAIN_SHAPE_2D = (5, 1024, 1024)
DIM_RES_2D = {"X": 0.1, "Y": 0.1, "Z": None, "T": 2.0}
SMALL_SHAPE_2D = (3, 64, 64)
NN_MAIN_ROWS = 150_000
FEATURE_RTOL = FEATURE_ATOL = 1e-4  # the reference's features bar
REL_COLUMNS = ("rel_linear_vel", "rel_angular_vel", "rel_linear_acc", "rel_angular_acc",
               "rel_directionality")
HIERARCHY_INPUTS = ("im_preprocessed", "im_instance_label", "im_skel", "im_pixel_class",
                    "im_skel_relabelled", "im_distance", "im_border",
                    "im_branch_label_reassigned", "im_obj_label_reassigned", "flow_vector_array")
CAPACITY_EDGE = 1024
CAPACITY_SIGMAS = (0.75, 1.1, 1.6)
LIBRARY_MAX_BYTES = 30e9  # largest distance matrix the library call may write
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
    for _ in range(3):  # the profiler now and then hands back no events at all
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us:
            return us / reps / 1e3
    fail("torch.profiler recorded no device time in three tries")


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
    matrix_bytes = 4 * q.shape[0] * r.shape[0]
    library_ms = (time_ms(lambda: library_nn(q, r), 5) if matrix_bytes <= LIBRARY_MAX_BYTES
                  else None)
    ms_again = time_ms(lambda: nn.NN_KERNEL(q, r), 20)
    on_device_ms = device_ms(lambda: nn.NN_KERNEL(q, r), 20)
    bound_ms, bound_by = nn_bound(q.shape[0], r.shape[0], q.shape[1])
    library = (f"{library_ms:.4f} ms" if library_ms is not None else
               f"not measured (its distance matrix would be {matrix_bytes / 1e9:.0f} GB)")
    print(f"nn time at {name} {q.shape[0]}x{r.shape[0]}x{q.shape[1]}: kernel {ms:.4f} ms a call "
          f"(again {ms_again:.4f} ms; on the device {on_device_ms:.4f} ms), plain {plain_ms:.4f} ms, "
          f"library {library}, bound {bound_ms:.4f} ms ({bound_by}), "
          f"share {bound_ms / ms:.3f} [{gpu}]", flush=True)
    max_abs = check_case(name, q, r, nn)
    check_bitwise(name, q, r, nn)
    return {"max_abs_err": max_abs, "ms": ms, "device_ms": on_device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_kernel_main_shapes(nn, gpu, im_info, tag=""):
    """The kernel at the shapes a main path gave it.  The reassigner
    matches the voxels of frame 0's objects (in microns) against those of
    frame 1; the Hierarchy measures the border distance of frame 0's
    skeleton and node voxels against its border voxels."""
    labels = artifact(im_info, "im_instance_label")
    branches = artifact(im_info, "im_skel_relabelled")
    skel = artifact(im_info, "im_skel")
    pixel_class = artifact(im_info, "im_pixel_class")
    border = artifact(im_info, "im_border")
    axes = ("Y", "X") if im_info.no_z else ("Z", "Y", "X")
    scale = torch.tensor([im_info.dim_res[a] for a in axes], device="cuda")

    def microns(mask):
        return torch.from_numpy(np.argwhere(mask).astype(np.float32)).to("cuda") * scale

    reassign = time_kernel_at(nn, gpu, f"the {tag}reassigner's frames 0->1",
                              *[microns((labels[t] > 0) | (branches[t] > 0)) for t in (0, 1)])
    hierarchy = time_kernel_at(nn, gpu, f"the {tag}Hierarchy's frame 0 border",
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


def make_frame_2d(shape, seed=0):
    """A confocal-like 2D frame: twelve wavy tubes of radius about 3 pixels
    (about 7 % of the frame once segmented) on camera noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    img = np.zeros(shape, np.float32)
    spacing = shape[0] / 12
    for i in range(12):
        cy = spacing * (i + 0.5) + 12 * np.sin(x / (40.0 + 7 * i) + i)
        img += (600.0 + 30 * i) * np.exp(-((y - cy) ** 2) / (2 * 2.0 ** 2))
    return np.clip(img + rng.normal(100, 5, shape), 0, None).astype(np.float32)


def write_input(directory, name, data, axes, dim_res):
    from nellie_tpu_torch.io import FileInfo, ome, tiff

    data = np.clip(data, 0, 65535).astype(np.uint16)
    desc = ome.build_ome_xml(axes, data.shape, "uint16", dim_res=dim_res)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.ome.tif")
    tiff.imwrite(path, data, description=desc)
    fi = FileInfo(path)
    fi.find_metadata()
    fi.load_metadata()
    return fi


def write_series(directory, shape):
    """The 3D main path's series: the frame rolled 3 voxels along Y per
    timepoint; for a 2D shape the 2D frame, rolled 2 pixels."""
    t_n, *frame_shape = shape
    if len(frame_shape) == 2:
        frame = make_frame_2d(tuple(frame_shape))
        data = np.stack([np.roll(frame, shift=2 * t, axis=0) for t in range(t_n)])
        return write_input(directory, "series", data, "TYX", DIM_RES_2D)
    frame = make_frame(tuple(frame_shape))
    data = np.stack([np.roll(frame, shift=3 * t, axis=1) for t in range(t_n)])
    return write_input(directory, "series", data, "TZYX", DIM_RES)


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


def phase_main_path(nn, gpu, root, shape=MAIN_SHAPE, tag=""):
    """Drive ``run`` on the card on a series of ``shape`` (3D or 2D), with
    the kernel's launch count set to 0 just before and read just after;
    print and check what it wrote."""
    from nellie_tpu_torch.pipeline.run import run
    from nellie_tpu_torch.stages.hierarchical import Hierarchy
    from nellie_tpu_torch.stages.voxel_reassignment import VoxelReassigner

    fi = write_series(os.path.join(root, f"main{tag.strip()}"), shape)
    torch.cuda.reset_peak_memory_stats()
    nn.NN_KERNEL.launches = 0
    with StageWatch(nn, (VoxelReassigner, Hierarchy)) as watch:
        im_info, timings = run(fi, device="cuda", return_timings=True)
    launches = nn.NN_KERNEL.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for stage, seconds in timings.items():
        print(f"{tag}stage {stage}: {seconds:.3f} s [{gpu}]", flush=True)
    host = watch.stages["Hierarchy"].host_seconds
    print(f"{tag}hierarchy: {timings['hierarchy']:.3f} s, of which CSV formatting and writing "
          f"{host['csv']:.3f} s on the writer thread (waited for at the end: {host['drain']:.3f} s), "
          f"region morphology {host['regionprops']:.3f} s on the host [{gpu}]", flush=True)
    print(f"{tag}peak device memory: {peak_gib:.3f} GiB [{gpu}]", flush=True)
    labels = artifact(im_info, "im_instance_label")
    flow = artifact(im_info, "flow_vector_array")
    reassigned = artifact(im_info, "im_obj_label_reassigned")
    matches = artifact(im_info, "voxel_matches")
    pre = artifact(im_info, "im_preprocessed")
    pixel_class = artifact(im_info, "im_pixel_class")
    fg = [int((labels[t] > 0).sum()) for t in range(labels.shape[0])]
    n_matches = sum(len(m[1]) for m in matches)
    print(f"{tag}main path: foreground voxels per frame {fg}, objects per frame "
          f"{[int(labels[t].max()) for t in range(labels.shape[0])]}, flow rows {len(flow)}, "
          f"reassigned voxels {int((reassigned[1:] > 0).sum())}, voxel matches {n_matches}, "
          f"nn launches {launches} (reassigner {watch.launches['VoxelReassigner']}, "
          f"hierarchy {watch.launches['Hierarchy']})", flush=True)
    if not np.isfinite(pre).all() or pre.shape != shape:
        fail(f"{tag}im_preprocessed is not finite or has the wrong shape")
    if min(fg) == 0:
        fail(f"{tag}a frame came out with no labels")
    if len(flow) == 0 or n_matches == 0:
        fail(f"{tag}no flow rows or no voxel matches")
    if flow.shape[1] != 2 * len(shape):
        fail(f"{tag}flow_vector_array has {flow.shape[1]} columns, not {2 * len(shape)}")
    if watch.launches["VoxelReassigner"] == 0 or watch.launches["Hierarchy"] == 0:
        fail(f"{tag}the reassigner or the Hierarchy never launched the nn kernel")

    tables = check_tables(im_info, skip_nodes=False)
    print(f"{tag}feature rows: " + ", ".join(f"{k} {len(v)}" for k, v in tables.items()),
          flush=True)
    if len(tables["voxels"]) != sum(fg):
        fail(f"features_voxels has {len(tables['voxels'])} rows for {sum(fg)} foreground voxels")
    if len(tables["nodes"]) != int((pixel_class > 0).sum()):
        fail("features_nodes does not have one row per skeleton voxel")
    if len(tables["image"]) != shape[0] or min(len(v) for v in tables.values()) == 0:
        fail("a feature table has no rows, or the image table not one row per frame")
    for name, rows in tables.items():
        coords = [float(r[i]) for r in rows for i in (-3, -2, -1) if name != "image" and r[i]]
        if not all(math.isfinite(c) for c in coords):
            fail(f"features_{name} has non-finite coordinates")
        if im_info.no_z and name != "image" and any(r[-1] != "" for r in rows):
            fail(f"{tag}features_{name}: z_raw is not empty in 2D")
    with open(im_info.pipeline_paths["adjacency_maps"], "rb") as f:
        adjacency = pickle.load(f)
    if sorted(adjacency) != ["b_o", "n_b", "n_o", "v_b", "v_n", "v_o"] or any(
            len(v) != shape[0] for v in adjacency.values()):
        fail("adjacency_maps.pkl lacks a key or a frame")
    return launches, watch.launches, im_info, timings


# ---------------------------------------------------------------------------
# phases 4 and 6: the fused chain against the per-stage path
# ---------------------------------------------------------------------------

SEGMENTATION_STAGES = ("filter", "label", "network", "markers")


def written_files(im_info):
    return {k: p for k, p in im_info.pipeline_paths.items() if os.path.exists(p)}


def fused_segmentation_seconds(root, name, shape, fence):
    """``FusedSegmentation.run`` alone on a fresh copy of the series:
    (its wall seconds, its seconds by stage when ``fence``)."""
    from nellie_tpu_torch.io import ImInfo
    from nellie_tpu_torch.pipeline.fused import FusedSegmentation

    seg = FusedSegmentation(ImInfo(write_series(os.path.join(root, name), shape)),
                            device="cuda")
    torch.cuda.synchronize()
    start = time.perf_counter()
    stage_times = seg.run(fence_stages=fence)
    torch.cuda.synchronize()
    return time.perf_counter() - start, stage_times


def phase_fused_vs_staged(gpu, root, shape, fused_info, fused_timings, tag=""):
    """``run(fused=False)`` on the same series on the card: every artifact
    equal to the fused run's byte for byte (the feature CSVs too, or, where
    the Hierarchy's float64 ``scatter_add_`` on the card summed in another
    order, within the features bar), ``seg_fused`` beside the four stages'
    seconds, the device frame cache's peak, and the fused chain's own
    seconds by stage with each stage fenced."""
    from nellie_tpu_torch.pipeline.run import run
    from nellie_tpu_torch.utils.device_cache import frame_cache

    fi = write_series(os.path.join(root, f"staged{tag.strip()}"), shape)
    staged_info, staged = run(fi, device="cuda", fused=False, return_timings=True)
    fused_files, staged_files = written_files(fused_info), written_files(staged_info)
    if sorted(fused_files) != sorted(staged_files):
        fail(f"{tag}fused and per-stage runs wrote different artifacts: "
             f"{sorted(set(fused_files) ^ set(staged_files))}")
    differ = [k for k, p in fused_files.items()
              if not filecmp.cmp(p, staged_files[k], shallow=False)]
    tables = [k for k in differ if k.startswith("features_")]
    if set(differ) - set(tables):
        fail(f"{tag}fused and per-stage artifacts differ on the card: {sorted(differ)}")
    worst = compare_tables(check_tables(fused_info, skip_nodes=False),
                           check_tables(staged_info, skip_nodes=False),
                           expected_headers(False), skip=()) if tables else 0.0
    print(f"{tag}fused vs per-stage on the card: {len(fused_files) - len(differ)} of "
          f"{len(fused_files)} artifacts equal byte for byte; feature CSVs differing in bytes "
          f"{tables} (worst at {worst:.3g} of the features bar)", flush=True)
    per_stage = {k: staged[k] for k in SEGMENTATION_STAGES}
    warm, _ = fused_segmentation_seconds(root, f"fused_warm{tag.strip()}", shape, fence=False)
    _, fenced = fused_segmentation_seconds(root, f"fused_fenced{tag.strip()}", shape, fence=True)
    cache = frame_cache(fused_info)
    if cache is None or cache.peak == 0 or len(cache):
        fail(f"{tag}the fused run left no frames in the device cache, or left some behind")
    print(f"{tag}seg_fused {fused_timings['seg_fused']:.3f} s in the main run, "
          f"{warm:.3f} s again alone; per-stage path "
          + ", ".join(f"{k} {v:.3f}" for k, v in per_stage.items())
          + f" = {sum(per_stage.values()):.3f} s; fused stages fenced "
          + ", ".join(f"{k} {v:.3f}" for k, v in fenced.items())
          + f" s; device frame cache peak {cache.peak / 1e9:.3f} GB [{gpu}]", flush=True)


# ---------------------------------------------------------------------------
# phase 5: the card against the CPU on a small input
# ---------------------------------------------------------------------------

def small_series():
    """Two drifting tubes in a 3x12x48x48 series (the CPU tests' input)."""
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
    return np.stack(frames).astype(np.uint16)


def small_series_2d():
    """Two drifting wavy filaments in a 3x64x64 series (the CPU tests' 2D
    input)."""
    t_n, y_n, x_n = SMALL_SHAPE_2D
    y, x = np.mgrid[0:y_n, 0:x_n].astype(np.float64)
    rng = np.random.default_rng(0)
    frames = []
    for t in range(t_n):
        img = 700.0 * np.exp(-((y - 0.3 * y_n - t - 5 * np.sin(x / 8.0)) ** 2) / (2 * 2.0 ** 2))
        img += 500.0 * np.exp(-((y - 0.7 * y_n + t - 4 * np.cos(x / 7.0)) ** 2) / (2 * 2.4 ** 2))
        frames.append(np.clip(img + rng.normal(80, 5, img.shape), 0, None))
    return np.stack(frames).astype(np.uint16)


def open_file(path):
    from nellie_tpu_torch.io import FileInfo

    fi = FileInfo(path)
    fi.find_metadata()
    fi.load_metadata()
    return fi


def phase_small_parity(root, data, axes, dim_res, tag="", config=None, nn=None, source=None,
                       infos=None):
    """The pipeline on ``data`` on the card and on the CPU, held to each
    other: float artifacts within 1e-4 of the frame max, integer artifacts
    on all but 0.1% of the foreground, flow costs and the feature tables at
    the features bar, and the Hierarchy alone on the CPU run's artifacts
    exactly so, with equal adjacency edges.  With ``source`` (a file), each
    device runs a copy of it through ``run_path`` instead.  With ``nn``,
    returns the kernel's launches by stage in the card's run; ``infos``
    (a dict) receives each device's ``ImInfo``."""
    from nellie_tpu_torch.io import ImInfo
    from nellie_tpu_torch.pipeline.run import run, run_path
    from nellie_tpu_torch.stages.hierarchical import Hierarchy
    from nellie_tpu_torch.stages.voxel_reassignment import VoxelReassigner

    def input_copy(directory):
        if source is None:
            return write_input(directory, "small", data, axes, dim_res)
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, os.path.basename(source))
        shutil.copyfile(source, path)
        return open_file(path)

    infos = {} if infos is None else infos
    launches = {}
    for dev in ("cuda", "cpu"):
        fi = input_copy(os.path.join(root, f"small{tag.strip()}_{dev}"))
        if source is not None:
            infos[dev] = run_path(fi.filepath, device=dev, config=config)
        elif nn is not None and dev == "cuda":
            nn.NN_KERNEL.launches = 0
            with StageWatch(nn, (VoxelReassigner, Hierarchy)) as watch:
                infos[dev] = run(fi, device=dev, config=config)
            launches = dict(watch.launches, total=nn.NN_KERNEL.launches)
            print(f"{tag}nn launches by stage: {json.dumps(launches)}", flush=True)
        else:
            infos[dev] = run(fi, device=dev, config=config)
    temporal = not infos["cpu"].no_t
    worst = {}
    for name in ("im_preprocessed", "im_distance"):
        a, b = artifact(infos["cuda"], name), artifact(infos["cpu"], name)
        err = max(float(np.abs(a[t].astype(np.float64) - b[t]).max()) / max(float(np.abs(b[t]).max()), 1e-30)
                  for t in range(a.shape[0]))
        worst[name] = err
        if err > 1e-4:
            fail(f"{tag}{name}: card vs CPU error {err:.3g} of the frame max > 1e-4")
    fg = int((artifact(infos["cpu"], "im_instance_label") > 0).sum())
    names = ["im_instance_label", "im_skel", "im_pixel_class", "im_skel_relabelled",
             "im_marker", "im_border"]
    if temporal:
        names += ["im_branch_label_reassigned", "im_obj_label_reassigned"]
    for name in names:
        a, b = artifact(infos["cuda"], name), artifact(infos["cpu"], name)
        diff = int((a != b).sum())
        worst[name] = diff
        if diff > 0.001 * fg:
            fail(f"{tag}{name}: {diff} voxels differ between card and CPU (foreground {fg})")
    if temporal:
        fa = artifact(infos["cuda"], "flow_vector_array")
        fb = artifact(infos["cpu"], "flow_vector_array")
        if fa.shape != fb.shape or fa.shape[0] == 0:
            fail(f"{tag}flow_vector_array shapes differ or are empty: {fa.shape} vs {fb.shape}")
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
    alone = ImInfo(input_copy(os.path.join(root, f"small{tag.strip()}_hierarchy")))
    for name in HIERARCHY_INPUTS:
        if os.path.exists(infos["cpu"].pipeline_paths[name]):
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
        fail(f"{tag}adjacency_maps.pkl differs between card and CPU")
    worst["adjacency edges"] = sum(len(a) for v in adj_cpu.values() for a in v)
    shape = infos["cpu"].shape if data is None else data.shape
    print(f"{tag}small input {axes} {shape}, card vs CPU: {json.dumps(worst)}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 8: the batch CLI on the card
# ---------------------------------------------------------------------------

def phase_cli(nn, root):
    """``cli.main`` in this process on a directory of one TYX file, one YX
    file and one file that ``--substring`` skips; each matching file gets
    its organelle table and the kernel is launched."""
    from nellie_tpu_torch.pipeline import cli

    directory = os.path.join(root, "cli")
    series = small_series_2d()
    write_input(directory, "mito_movie", series, "TYX", {"X": 0.1, "Y": 0.1, "Z": None, "T": 1.0})
    write_input(directory, "mito_still", series[0], "YX", {"X": 0.1, "Y": 0.1, "Z": None, "T": None})
    write_input(directory, "er_skip", series[0], "YX", {"X": 0.1, "Y": 0.1, "Z": None, "T": None})
    nn.NN_KERNEL.launches = 0
    cli.main(["--directory", directory, "--substring", "mito"])
    launches = nn.NN_KERNEL.launches
    out = os.path.join(directory, "nellie_output")
    written = sorted(os.listdir(out))
    for name in ("mito_movie", "mito_still"):
        tables = [f for f in written if f.startswith(name) and f.endswith("features_organelles.csv")]
        if not tables:
            fail(f"the CLI wrote no organelle table for {name}")
        header, rows = read_table(os.path.join(out, tables[0]))
        if header != expected_headers(False)["organelles"] or not rows:
            fail(f"the CLI's organelle table for {name} has another header or no rows")
    if any(f.startswith("er_skip") for f in written):
        fail("the CLI processed the file its substring filter skips")
    if launches == 0:
        fail("the CLI's runs never launched the nn kernel")
    print(f"cli: {len(written)} outputs for the 2 matching files, nn launches {launches}",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 9: the capacity path, card against CPU
# ---------------------------------------------------------------------------

def capacity_tube(shape=(24, 64, 64), seed=0):
    """One wavy tube on noise (the CPU tests' capacity input)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    tube = 800.0 * np.exp(-(((z - 12) ** 2) * 0.3 + (y - 32 + 6 * np.sin(x / 8.0)) ** 2 / 2)
                          / (2 * 2.0 ** 2))
    return np.clip(tube + rng.normal(100, 5, shape), 0, 65535).astype(np.uint16)


def same_capacity_result(name, card, cpu):
    """Fail unless two ``segment_volume`` results are equal in every product
    and count."""
    for key in ("n_labels", "fg_count", "emit", "strategy", "bytes_up", "bytes_down"):
        if card.get(key) != cpu.get(key):
            fail(f"capacity {name}: {key} {card.get(key)} on the card, {cpu.get(key)} on the CPU")
    product = "labels" if "labels" in cpu else "mask_packed"
    a, b = card[product], cpu[product]
    if a.dtype != b.dtype or not np.array_equal(a, b):
        fail(f"capacity {name}: {product} differ in {int((a != b).sum())} entries")
    return {k: cpu.get(k) for k in ("n_labels", "fg_count")}


def phase_capacity_parity(root):
    from nellie_tpu_torch.kernels.frangi import FrangiParams
    from nellie_tpu_torch.pipeline import capacity

    params = FrangiParams(sigmas=(0.75, 0.95), spacing=(0.5, 0.2, 0.2), z_ratio=2.5)
    vol = capacity_tube()
    kw = dict(min_area=4, max_chunk_voxels=16 * 64 * 64)
    grid = capacity._ccl_grid
    counts = {}
    try:
        # a 3x3x3 cell grid, so that the chunked strategy merges on this volume
        capacity._ccl_grid = lambda shape, **_: [
            tuple(int(round(d * i / 3)) for i in range(4)) for d in shape]
        for strategy in ("monolith", "chunked"):
            for emit in ("labels", "sparse_labels", "mask"):
                out = {dev: capacity.segment_volume(vol, params, emit=emit, strategy=strategy,
                                                    device=dev, **kw) for dev in ("cuda", "cpu")}
                counts[f"{strategy} {emit}"] = same_capacity_result(
                    f"{strategy} {emit}", out["cuda"], out["cpu"])
    finally:
        capacity._ccl_grid = grid
    img = small_series_2d()[0]
    params_2d = FrangiParams(sigmas=(0.75, 1.1), spacing=(0.1, 0.1))
    out = {dev: capacity.segment_volume(img, params_2d, min_area=4, emit="sparse_labels",
                                        max_chunk_voxels=32 * 64, device=dev)
           for dev in ("cuda", "cpu")}
    counts["2D sparse_labels"] = same_capacity_result("2D", out["cuda"], out["cpu"])
    written = {}
    for dev in ("cuda", "cpu"):
        fi = write_input(os.path.join(root, f"capacity_{dev}"), "volume", vol, "ZYX",
                         {"X": 0.2, "Y": 0.2, "Z": 0.5, "T": None})
        out = capacity.segment_path(fi.filepath, min_area=4, sigmas=(0.75, 0.95), device=dev)
        written[dev] = artifact(out["im_info"], "im_instance_label")
    if written["cuda"].dtype != np.int32 or not np.array_equal(written["cuda"], written["cpu"]):
        fail("capacity segment_path: im_instance_label differs between card and CPU")
    counts["segment_path"] = int(written["cpu"].max())
    print(f"capacity card vs CPU, all equal: {json.dumps(counts)}", flush=True)


# ---------------------------------------------------------------------------
# phase 10: low memory, card against CPU
# ---------------------------------------------------------------------------

def low_memory_config():
    from nellie_tpu_torch.config import SettingsConfig

    return SettingsConfig(
        preprocessing_low_memory=True, segmentation_label_low_memory=True,
        segmentation_label_chunk_z=5, segmentation_network_low_memory=True,
        mocap_low_memory=True, mocap_max_chunk_voxels=12 * 24 * 24, tracking_low_memory=True,
        reassign_low_memory=True, feature_low_memory=True, analyze_node_level=True)


def many_markers(shape=(2, 12, 64, 64), n=1500, seed=5):
    """Tracking artifacts with ``n`` markers a frame (the CPU tests' input):
    smooth intensity and Frangi images, frame 1 moved one voxel along X."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    smooth = ndimage.gaussian_filter(rng.normal(size=shape[1:]), 1.5)
    frame = 300 + 100 * smooth / smooth.std()
    im = np.stack([np.roll(frame, t, axis=2) for t in range(shape[0])])
    frangi = np.stack([np.roll(np.abs(smooth), t, axis=2) for t in range(shape[0])])
    marker = np.zeros(shape, np.uint8)
    flat = rng.choice(int(np.prod(shape[1:])), n, replace=False)
    idx = np.stack(np.unravel_index(flat, shape[1:]), 1)
    for t in range(shape[0]):
        moved = idx.copy()
        moved[:, 2] = (moved[:, 2] + t) % shape[3]
        marker[(t,) + tuple(moved.T)] = 1
    return im, {"im_preprocessed": (frangi * 1e-3).astype(np.float32), "im_marker": marker,
                "im_instance_label": marker.astype(np.int32),
                "im_distance": (1.0 + rng.random(shape)).astype(np.float32)}


def phase_low_memory(nn, gpu, root):
    """The small TZYX input with every stage in low-memory mode, card vs
    CPU (phase 5's bars, with the kernel's launches by stage on the card),
    then the tiled matcher on the card against the CPU."""
    from nellie_tpu_torch.io import ImInfo
    from nellie_tpu_torch.stages import hu_tracking, voxel_reassignment

    calls = []
    original = voxel_reassignment.nearest_neighbors

    def recorded(queries, refs, device="cpu", **kwargs):
        if str(device).startswith("cuda"):
            calls.append((queries, refs))
        return original(queries, refs, device=device, **kwargs)

    voxel_reassignment.nearest_neighbors = recorded
    try:
        launches = phase_small_parity(
            root, small_series(), "TZYX", {"X": 0.2, "Y": 0.2, "Z": 0.5, "T": 1.0},
            tag="low-memory ", config=low_memory_config(), nn=nn)
    finally:
        voxel_reassignment.nearest_neighbors = original
    if launches["VoxelReassigner"] == 0 or not calls:
        fail("the low-memory reassigner never launched the nn kernel")
    print("low-memory reassigner nn calls (Q x M): "
          + ", ".join(f"{q.shape[0]}x{r.shape[0]}" for q, r in calls), flush=True)
    q, r = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to("cuda") for a in calls[0])
    timing = time_kernel_at(nn, gpu, "the low-memory reassigner's first call", q, r)

    im, arrays = many_markers()
    flows = {}
    for dev in ("cuda", "cpu"):
        im_info = ImInfo(write_input(os.path.join(root, f"tiles_{dev}"), "markers", im, "TZYX",
                                     {"X": 0.2, "Y": 0.2, "Z": 0.5, "T": 1.0}))
        for name, arr in arrays.items():
            im_info.allocate_memory(im_info.pipeline_paths[name], dtype=arr.dtype.name,
                                    data=arr, description=name)
        stage = hu_tracking.HuMomentTracking(im_info, device=dev, mode="sparse")
        stage.run()
        flows[dev] = artifact(im_info, "flow_vector_array")
    a, b = flows["cuda"], flows["cpu"]
    if a.shape != b.shape or a.shape[0] <= 1024 or not np.array_equal(a[:, :7], b[:, :7]):
        fail(f"tiled matcher: flow rows differ between card and CPU ({a.shape} vs {b.shape})")
    cost_err = float(np.abs(a[:, 7] - b[:, 7]).max())
    if cost_err > 1e-4:
        fail(f"tiled matcher: flow costs differ by {cost_err:.3g} between card and CPU")
    print(f"tiled matcher (1,500 markers a frame, tiles of "
          f"{stage._tile_rows(1500, 1500)} rows): {a.shape[0]} flow rows equal card to CPU, "
          f"costs within {cost_err:.3g}", flush=True)
    timing["launches"] = launches["VoxelReassigner"]
    return timing


# ---------------------------------------------------------------------------
# phase 11: the capacity path at 1024^3
# ---------------------------------------------------------------------------

def capacity_volume(edge, seed=0):
    """The lightsheet-like volume of ``scripts/measure_capacity_1024.py``
    (about ``edge / 25`` bright tubes along random axes on N(100, 8) noise),
    with the noise drawn on the card from a seeded generator and the volume
    built slab by slab; returned as uint16 on the host."""
    rng = np.random.default_rng(seed)
    tubes = []
    for _ in range(max(8, edge // 25)):
        axis = int(rng.integers(0, 3))
        c = rng.integers(8, edge - 8, size=2)
        r = int(rng.integers(2, 4))
        lo, hi = sorted(int(v) for v in rng.integers(0, edge, size=2))
        if hi - lo < edge // 8:
            hi = min(edge, lo + edge // 8)
        sl = [slice(int(c[0]) - r, int(c[0]) + r + 1), slice(int(c[1]) - r, int(c[1]) + r + 1)]
        sl.insert(axis, slice(lo, hi))
        tubes.append(tuple(sl))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = torch.empty((edge, edge, edge), dtype=torch.int32, device="cuda")
    slab = 64
    for z0 in range(0, edge, slab):
        z1 = min(z0 + slab, edge)
        block = torch.randn((z1 - z0, edge, edge), generator=gen, device="cuda") * 8.0 + 100.0
        for sl in tubes:
            lo, hi = max(sl[0].start, z0), min(sl[0].stop, z1)
            if lo < hi:
                block[lo - z0:hi - z0, sl[1], sl[2]] += 400.0
        out[z0:z1] = torch.clamp(block, 0, 65535).to(torch.int32)
    return out.cpu().numpy().astype(np.uint16)


def phase_capacity_1024(gpu, edge=CAPACITY_EDGE):
    from scipy import ndimage

    from nellie_tpu_torch.kernels.frangi import FrangiParams
    from nellie_tpu_torch.pipeline import capacity

    start = time.perf_counter()
    vol = capacity_volume(edge)
    made = time.perf_counter() - start
    params = FrangiParams(sigmas=CAPACITY_SIGMAS, spacing=(1.0, 1.0, 1.0), z_ratio=1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    out = capacity.segment_volume(vol, params, emit="sparse_labels", device="cuda")
    seconds = time.perf_counter() - start
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    labels = out["labels"]
    del vol
    print(f"capacity {edge}^3: volume made in {made:.1f} s; segment_volume {seconds:.1f} s "
          f"({labels.size / seconds / 1e6:.1f} Mvox/s), strategy {out['strategy']}, emit "
          f"{out['emit']}, raw resident {out['raw_resident']}, n_labels {out['n_labels']}, "
          f"fg_count {out['fg_count']} ({out['fg_count'] / labels.size:.4%}), labels "
          f"{labels.dtype}, {out['bytes_up'] / 1e9:.3f} GB up, {out['bytes_down'] / 1e9:.3f} "
          f"GB down, peak device memory {peak_gib:.3f} GiB [{gpu}]", flush=True)
    print(f"capacity {edge}^3 seconds by phase: "
          + ", ".join(f"{k} {v:.3f}" for k, v in out["seconds"].items()) + f" [{gpu}]",
          flush=True)
    if out["strategy"] != "chunked" or out["fg_count"] != int((labels > 0).sum()):
        fail(f"capacity {edge}^3: not the chunked strategy, or fg_count is not the support")
    start = time.perf_counter()
    ref, ref_n = ndimage.label(labels > 0, structure=np.ones((3, 3, 3)))
    equal = ref_n == out["n_labels"] and np.array_equal(ref, labels)
    print(f"capacity {edge}^3 against scipy.ndimage.label: {ref_n} components, labels "
          f"{'equal' if equal else 'DIFFERENT'} ({time.perf_counter() - start:.1f} s)", flush=True)
    if not equal:
        fail(f"capacity {edge}^3: labels are not scipy's labelling of their support")
    return {k: out[k] for k in ("n_labels", "fg_count", "seconds")}


# ---------------------------------------------------------------------------
# phase 12: the sample movie through run_path, and the track API
# ---------------------------------------------------------------------------

SAMPLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sample_data",
                      "synthetic_3d_mitochondria.ome.tif")


def phase_sample_tracks(gpu, root):
    """The repo's sample movie through ``run_path`` on the card and on the
    CPU at phase 5's bars; then ``LabelTracks`` of every label from frame 1
    (ids, frames and properties equal, coordinates within 1e-5 voxel), the
    flow vectors as tracks and the markers as points, card against CPU."""
    from nellie_tpu_torch.stages import flow_vector_viz as viz
    from nellie_tpu_torch.stages.all_tracks_for_label import LabelTracks

    if not os.path.exists(SAMPLE):
        fail(f"{SAMPLE} is missing")
    infos = {}
    phase_small_parity(root, None, "TZYX", None, tag="sample ", source=SAMPLE, infos=infos)
    tracks, seconds = {}, {}
    for dev in ("cuda", "cpu"):
        torch.cuda.synchronize()
        start = time.perf_counter()
        tracks[dev] = LabelTracks(infos[dev], device=dev).run(label_num=None, start_frame=1)
        torch.cuda.synchronize()
        seconds[dev] = time.perf_counter() - start
    a, b = (np.asarray(tracks[dev][0], np.float64) for dev in ("cuda", "cpu"))
    if (a.shape != b.shape or a.shape[0] == 0 or not np.array_equal(a[:, :2], b[:, :2])
            or tracks["cuda"][1] != tracks["cpu"][1]):
        fail(f"LabelTracks: ids, frames or properties differ between card and CPU "
             f"({a.shape} vs {b.shape})")
    coord_err = float(np.abs(a[:, 2:] - b[:, 2:]).max())
    if coord_err > 1e-5:
        fail(f"LabelTracks: coordinates differ by {coord_err:.3g} voxel between card and CPU")
    flow = {dev: viz.load_flow_vectors_as_tracks(infos[dev]) for dev in ("cuda", "cpu")}
    if not np.array_equal(flow["cuda"][0], flow["cpu"][0]):
        fail("flow_vectors_to_tracks: the tracks differ between card and CPU")
    cost_err = float(np.abs(flow["cuda"][1]["cost"] - flow["cpu"][1]["cost"]).max())
    if cost_err > 1e-4:
        fail(f"flow_vectors_to_tracks: costs differ by {cost_err:.3g} between card and CPU")
    points = {dev: viz.load_mocap_markers_as_points(infos[dev]) for dev in ("cuda", "cpu")}
    if points["cuda"].shape[0] == 0 or not np.array_equal(points["cuda"], points["cpu"]):
        fail("load_mocap_markers_as_points: the points differ between card and CPU")
    print(f"sample tracks: LabelTracks {a.shape[0]} track points from frame 1, equal card to "
          f"CPU (coordinates within {coord_err:.3g} voxel), {seconds['cuda']:.3f} s on the card, "
          f"{seconds['cpu']:.3f} s on the CPU; flow tracks {flow['cpu'][0].shape[0]} points "
          f"equal (costs within {cost_err:.3g}); marker points {points['cpu'].shape[0]} equal "
          f"[{gpu}]", flush=True)


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
        launches, by_stage, im_info, timings = phase_main_path(nn, gpu, root)
        phase_fused_vs_staged(gpu, root, MAIN_SHAPE, im_info, timings)
        reassign, hierarchy = phase_kernel_main_shapes(nn, gpu, im_info)
        phase_small_parity(root, small_series(), "TZYX",
                           {"X": 0.2, "Y": 0.2, "Z": 0.5, "T": 1.0})
        _, by_stage_2d, im_info_2d, timings_2d = phase_main_path(nn, gpu, root, MAIN_SHAPE_2D,
                                                                 tag="2D ")
        phase_fused_vs_staged(gpu, root, MAIN_SHAPE_2D, im_info_2d, timings_2d, tag="2D ")
        reassign_2d, hierarchy_2d = phase_kernel_main_shapes(nn, gpu, im_info_2d, tag="2D ")
        series_2d = small_series_2d()
        for data, axes, t_res in ((series_2d, "TYX", 1.0), (series_2d[0], "YX", None)):
            phase_small_parity(root, data, axes, {"X": 0.1, "Y": 0.1, "Z": None, "T": t_res},
                               tag=f"2D {axes} ")
        phase_cli(nn, root)
        phase_capacity_parity(root)
        reassign_low = phase_low_memory(nn, gpu, root)
        phase_sample_tracks(gpu, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_capacity_1024(gpu)

    reassign["launches"] = by_stage["VoxelReassigner"]
    hierarchy["launches"] = by_stage["Hierarchy"]
    reassign_2d["launches"] = by_stage_2d["VoxelReassigner"]
    hierarchy_2d["launches"] = by_stage_2d["Hierarchy"]
    paths = {"reassign": reassign, "hierarchy": hierarchy,
             "reassign_2d": reassign_2d, "hierarchy_2d": hierarchy_2d,
             "reassign_low_memory": reassign_low}
    max_abs = max([max_abs] + [p["max_abs_err"] for p in paths.values()])
    top = {k: reassign[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    print(json.dumps({"kernels": [{
        "name": "nn_argmin", "route": "cuda",
        "source": "nellie_tpu_torch/kernels/csrc/nn_argmin.cu",
        "replaces": "nellie_tpu/kernels/pallas_nn.py:72",
        "launches": launches, "max_abs_err": max_abs, **top,
        "paths": paths}]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
