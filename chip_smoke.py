"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. the device: name, ``nvidia-smi`` name and power limit, torch/CUDA versions;
2. builds every hand kernel's CUDA source from the checkout (seventeen:
   nearest neighbour, union-find, capacity's cross-cell merge, flow
   interpolation, fused multiply-add, the Gaussian cascade's 1-D
   correlation, the Frangi tail, Network's 3D thinning and nearest seed,
   tracking's pair sums, pair costs, ROI statistics and log-Hu features,
   the histogram thresholds, the 2D thinning, the clamped EDT and the
   masked percentile; one nvcc each, in parallel), times the builds and prints
   the nearest-neighbour kernel's registers, spills and resident warps per
   SM;
3. checks the kernel against its plain PyTorch version on the card (ragged
   shapes, exact ties on a grid, 150,000 voxels each way) and times both;
   then holds its d2 bit for bit, and its indices, to the plain version on
   CPU copies at the split edges: 20,000 voxels each way, duplicates in
   other reference splits, d2 cancelling to <= 0, one query against 10**6
   references, every width d from 1 to 8; in both rounding modes of the
   norms where both run (square by square, and fused as the reassigner's
   pair kernel asks, ``fused_norms=True``);
4. drives ``nellie_tpu_torch.pipeline.run.run`` on a 3x64x256x256 uint16
   confocal-like time series (Filter -> ... -> VoxelReassigner ->
   Hierarchy, the first four as the fused chain, ``run``'s default),
   prints each stage's seconds, the Hierarchy's host share, the rows of
   every feature CSV, the peak device memory and the kernel's launches by
   stage, and checks the outputs and that both the reassigner and the
   Hierarchy launched the kernel; runs the series again with
   ``fused=False`` and holds every artifact of the two runs equal byte for
   byte (the feature CSVs too: the Hierarchy's float64 sums add in one
   order on every device), printing ``seg_fused`` beside the four stages'
   seconds, the device
   frame cache's peak and ``FusedSegmentation.run(fence_stages=True)``'s
   seconds by stage (Network's on a line of its own, with the thinning and
   nearest-seed kernels' launches); then checks the kernel again on the operands of the
   largest call each of them made, in that call's rounding mode (bit for
   bit against the CPU), and prints its time beside the plain version's, one PyTorch call's
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
   (the chunked strategy, its cells' pieces merged on the card by
   ``kernels/csrc/ccl_merge.cu``), its seconds by phase, label count,
   foreground, label dtype, bytes down and peak device memory (at most
   ``CAPACITY_PEAK_GIB``), and its labels held to ``scipy.ndimage.label`` of
   their support, exactly;
12. the repo's sample movie (``sample_data/synthetic_3d_mitochondria.ome.tif``,
   4x16x128x128 ``TZYX``) through ``run_path`` on the card and on the
   CPU at phase 5's bars, then ``LabelTracks`` of every label from frame 1,
   the flow vectors as tracks and the markers as points, card against CPU,
   with ``LabelTracks``' seconds on the card;
13. the float16 Frangi carry: the small 3D and 2D series with
   ``preprocessing_carry_dtype="float16"``, card against CPU at phase 5's
   bars (with the kernel's launches in the 3D run), then Filter on the 3D
   main series, float32 and float16 in turns, with its seconds;
14. the native TIFF codec (``nellie_tpu_torch/native``) built with this
   machine's ``g++``, and the committed fixture files of
   ``tests/fixtures/tiff_codec`` (LZW, PackBits, the horizontal predictor)
   decoded strip by strip, in one threaded batch and whole through the
   reader, native against Python and against the manifest's checksums;
15. the napari plugin on the card: ``NellieLoader`` on the repo's
   pure-Python Qt and napari stand-ins (``tests/qt_stubs.py``), file
   select and Run Nellie on phase 5's small 3D series on the default
   device (``cuda``), with the kernel's launches, every file equal byte for
   byte to ``run(fused=False, device="cuda")``'s with the same settings;
16. the multi-device path (``nellie_tpu_torch.mesh``) on logical shards of
   the card (``make_mesh(devices=["cuda:0"] * 4, t_axis=2)``): ``run(mesh=)``
   on the 3D main series, every file byte for byte phase 4's, its seconds
   by stage beside phase 4's and the kernel's launches by stage; phase 7's
   small ``TYX`` input through a 1 x 4 mesh against its one-device run;
   ``run_files`` over two main-series files (the second shifted) on a 2 x 1
   mesh against each file's ``run()``; capacity's mesh strategy (z = 4) on
   a 256x512x512 volume of phase 11's generator against the one-window
   monolith, with seconds and peak memory; with more than one card, the 3D
   check again over the real cards.

17. the union-find (``kernels/csrc/ccl_union_find.cu``), flow
   interpolation (``kernels/csrc/flow_interp.cu``) and fused multiply-add
   (``kernels/csrc/fma_f32.cu``) kernels against their plain versions on
   the card.  Union-find, exactly (``torch.equal``), at both
   connectivities: background, foreground, one voxel, a checkerboard, a
   one-voxel serpentine and a mask touching every face, at 0.1 % and 25 %
   (64x256x256 and 1024x1024, component counts also held to
   ``scipy.ndimage.label``), every mask phases 4, 6 and 11 gave it (the
   capacity window and cells included), a synthetic 262x520x640 window at
   0.1 % and a 64x256x256 background at 98.8 %.  Interpolation, bit for
   bit (NaN where NaN) with no row allowed to differ: synthetic inputs at
   M < 32, 32 < M <= 1024, M > 1024 and M = 20,000 (streamed through
   shared tiles), d = 2 and 3, with queries on an anchor, with an empty
   radius and NaN, a radius of 3 where most queries overflow their list,
   also against CPU copies, then every call of phases 4 and 6.  Fused
   multiply-add, bit for bit against round-to-odd in float64 torch on the
   card and the CPU: ``fma_operands``, the double-rounding tie, views,
   numbers and broadcasting, and the largest call each of phases 4, 6 and
   11 made, on its own operands.  Each kernel's time (CUDA events per call
   and ``torch.profiler`` on the device) at its main-path shapes (the
   union-find also at the 3D ``label/fill_holes`` mask and capacity's
   window, fill-holes cell and label cell; the multiply-add at each path's
   largest call) beside the plain version's, the library call's where
   there is one and the bound, with the launches on the 3D and 2D
   main paths (counted in phases 4 and 6, set to 0 just before each run)
   and in phase 11.  The 1-D correlation (``kernels/csrc/gauss_axis.cu``)
   and the Frangi tail's two passes (``kernels/csrc/frangi_tail.cu``),
   called through their wrappers (``filters.correlate1d_traced`` and
   ``_correlate1d``, ``frangi.hessian_frob`` and ``frangi_response``), bit
   for bit against the plain versions (``correlate1d_traced_plain``,
   ``_correlate1d_plain``, ``hessian_frob_plain``,
   ``frangi_response_plain``) on the same arguments: the 3D and 2D main
   cascades' taps with both carries, the LoG's, every tap count that has
   its own unrolled correlation instance (exactly the counts of the -r..r
   tap lists that phases 4, 6 and 11 launched, each of which must have
   taken its instance, as the kernel reports) and the run-time loop's
   (``gauss_instance_weights``), a dim block, a last axis of 128, a core
   box, no mask, on synthetic frames (and CPU copies at small shapes),
   then the largest call of each wrapper in phases 4, 6 and 11 on the
   caller's own arguments (weights, carry, spacing, frame shape, core,
   mask), with their times beside the plain versions', the bound and (the
   correlation) one cuDNN convolution, the instance and copy width each
   correlation took and its host-to-device copies a call (none, or the
   phase fails).  Network's 3D
   thinning (``kernels/csrc/thin26.cu``, through ``skeleton.skeletonize_3d``)
   and nearest seed (``kernels/csrc/nearest_seed.cu``, through
   ``edt.nearest_seed``), exactly against ``skeletonize_3d_plain`` and
   ``nearest_seed_plain``: ``thin_masks`` at three shapes (the thinning's
   rounds, host reads, sweeps and CUDA kernels also held to
   ``thin26_model``: one persistent launch and one read a call),
   ``seed_inputs`` in 3D and 2D with and without objects and a search
   radius (each call's CUDA kernels held to ``seed_work``'s and to the
   kernel's own count, with no host read: one persistent launch a call),
   then Network's largest call on each main path with its
   own operands (whether a nearest seed waits on the card, read from how
   long the call takes with 50 ms of work queued before it, which an
   ``.item()`` must wait out, held to the kernel's own count of host
   reads), with their times on a cold L2, the plain bodies' and the
   byte bounds of each call's inputs read and outputs written once; both
   rows also give the CUDA kernels that the main paths' calls launched
   (``kernel_launches``: one call runs the whole loop).  Tracking's pair
   sums (``kernels/csrc/pair_sums.cu``, through ``matching.pair_stats``)
   and pair costs (``kernels/csrc/pair_costs.cu``, through
   ``matching.pair_costs``), ROI statistics (``kernels/csrc/roi_stats.cu``,
   through ``moments.masked_mean_variance``) and the histogram thresholds
   (``kernels/csrc/hist_threshold.cu``, through ``thresholds.otsu_threshold``,
   ``triangle_threshold``, ``triangle_and_otsu`` and ``min_triangle_otsu``),
   bit for bit against
   their plain bodies (``*_plain``) on synthetic cases (``PAIR_CASES``: a
   tile of one window level, a second level over 4,096 x 4,096, the lanes
   of a padded 2,048 x 128 and 2,048 x 256 tile, no gated pair, NaN and
   subnormal features, gated terms of +0, every window of a tile real;
   ``PAIR_COST_CASES``: the main
   paths' shapes, ties across rows and columns, a row and a column with no
   gated pair, costs that overflow, NaN features, costs of -0 and +0, no
   gated pair;
   ``ROI_CASES``: 16^3, 20^2 and 20^3 ROIs, sums that stay subnormal,
   subnormal voxels, signed voxels, an empty ROI each; ``THRESHOLD_CASES``:
   an empty mask, a span of 0, one masked value, two bins, both triangle
   flips, no mask, 100, 1,000 and 10,000 bins, a frame's worth of values,
   more than 2^24 values), then on
   each path's largest call with the caller's own arguments (the tracker's
   3D and 2D calls; the Filter's, Label's and capacity's thresholds), with
   their times on a cold L2, the plain bodies', ``torch.histc``'s beside
   the histogram, the CUDA kernels a call, the calls each path made, the
   bound (for the pair sums also the most dependent adds a sum can take;
   for both pair kernels every pair's gate and the gated pairs' work) and
   the host reads, counted by ``torch.cuda.set_sync_debug_mode`` and read
   from whether the call waits out 50 ms of work queued on the card before
   it (the pair sums must: they read their packed result once; the pair
   costs, the thresholds and the ROI statistics must not), and a frame
   pair's matching (``match_frames_device``) on each path's largest tile,
   which must make 2 host reads.  ``max_abs_err`` is
   the largest |kernel - plain| over the compared calls.  The multiply-add,
   correlation and tail rows are timed on a cold L2 cache (flushed before
   every call), so that the byte bounds at the memory rate hold;
18. a real out-of-memory on the card: with most of the card's memory held
   by a ballast, the Filter on a 3D series whose full-frame working set
   passes the ladder's estimate; right after the estimate more ballast
   takes all but 5 frames (as another process would), so the stage runs
   out of memory and reruns in its low-memory mode on the same device;
   its ``im_preprocessed`` is held byte for byte to a run that asked for
   low memory from the start.

Phases 4 and 6 also print the hand kernels' launches by caller and
``fma_f32``'s by calling function, single calls and chains (``fma_chain``,
one launch a straight-line program of multiply-adds), beside the launches
the same work took one call a step before the chains (failing if the
Filter's arithmetic or Network's nearest seed launched either), and phase
11 the same for capacity.  Phase 17 also holds the chain to its plain
version (``_fp.run_steps``) on synthetic programs of each of its kernels'
forms and on each path's largest chain, timed beside its bound and one
``torch.addcmul`` over as many elements.  It holds the 2D thinning
(``csrc/thin2d.cu``), the clamped EDT (``csrc/edt_minplus.cu``), the
masked percentile's two forms (``csrc/masked_percentile.cu``) and the
log-Hu features (``csrc/hu_features.cu``) bit for bit to their plain
bodies on ``thin2d_masks``, ``EDT_CASES``, ``PERCENTILE_CASES`` and
``HU_CASES`` and at each path's largest call (the EDT's again at a clamp
neither path uses, ``OTHER_EDT_CLAMP``); on every Filter frame of both
main paths it holds the finalize's per-term rule (``frangi.FINALIZE_FORMS``)
card = CPU and counts the voxels between the percentile's two forms, and
on ``finalize_cross_frame``'s frames it checks each cross against the
table.  Phases 4 and 6 print tracking's CUDA kernels, the stage rerun
alone under the profiler (``tracking_launches``).

Phase 17 holds the cross-cell merge (``csrc/ccl_merge.cu``, through
``ccl.MERGE_KERNEL``) bit for bit to ``ccl.merge_cell_roots_plain`` on
``merge_masks`` (3D and 2D on fine grids, full and faces connectivity,
on the card and on CPU copies) and on the 1024^3 volume's label and
hole-filling merges, recorded from a second run of the chunked strategy,
timed beside the plain body, the host union-find it replaced and the
bound, with the host's time with work queued on the card (no host read).

Phase 5 holds the flow costs card = CPU exactly (the Hu moments' powers
round as XLA's CPU code rounds them, ``kernels/_fp.py::pow``).
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
# the hand kernels of the 1024^3 capacity path
CAPACITY_KERNELS = ("ccl_union_find", "ccl_merge", "fma_chain", "gauss_axis", "frangi_tail",
                    "hist_threshold", "masked_percentile")
# the 1024^3 capacity run's peak device memory may not pass 1.5 times the
# 7.847 GiB it took while its cells were merged on the host
CAPACITY_PEAK_GIB = 11.8
LIBRARY_MAX_BYTES = 30e9  # largest distance matrix the library call may write
TIE_REL = 1e-6   # an index may differ only where the two candidates' float64
                 # squared distances differ by <= TIE_REL * (|q|^2 + |r|^2)
# published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12  # H100 SXM, float64 outside the tensor cores (NVIDIA's data sheet)
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


def device_ms(fn, reps: int, required: bool = True):
    """The device time of one call of ``fn``: the sum of the times of the
    CUDA kernels it launches, from ``torch.profiler``, over ``reps`` calls.
    Unlike :func:`time_ms` it leaves out the host's time between launches.
    When the profiler records nothing in its tries, fails, or returns None
    (not measured) unless ``required``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    tries = 3 if required else 5
    for _ in range(tries):  # the profiler now and then hands back no events at all
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us:
            return us / reps / 1e3
    if required:
        fail("torch.profiler recorded no device time in three tries")
    print(f"torch.profiler recorded no device time in {tries} tries: not measured", flush=True)
    return None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def mode_name(fused_norms):
    return "fused norms" if fused_norms else "rounded norms"


def check_case(name, q, r, nn, fused_norms=False):
    d2_k, idx_k = nn.NN_KERNEL(q, r, fused_norms)
    torch.cuda.synchronize()
    d2_p, idx_p = nn.nn_argmin_plain(q, r, fused_norms)
    differ, bad = nn_mismatches(q, r, idx_k, idx_p)
    scale = (q.double() ** 2).sum(1) + (r.double()[idx_p.long()] ** 2).sum(1)
    d_err = (d2_k.double() - d2_p.double()).abs()
    d_bad = int((d_err > TIE_REL * scale + 1e-30).sum())
    max_abs = float(d_err.max())
    print(f"nn check {name}: Q={q.shape[0]} M={r.shape[0]} d={q.shape[1]} "
          f"{mode_name(fused_norms)}, index differences {differ} (unexcused {bad}), d2 max abs err {max_abs:.3e} "
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


def check_bitwise(name, q, r, nn, fused_norms=False):
    """The kernel on the card against the plain version on CPU copies, in
    one rounding mode of the norms: d2 bit for bit and equal indices, or
    fail.  Returns the plain (d2, idx)."""
    d2_k, idx_k = nn.NN_KERNEL(q, r, fused_norms)
    d2_k, idx_k = d2_k.cpu(), idx_k.cpu()
    d2_p, idx_p = nn.nn_argmin_plain(q.cpu(), r.cpu(), fused_norms)
    bits = int((d2_k.view(torch.int32) != d2_p.view(torch.int32)).sum())
    moved = int((idx_k != idx_p).sum())
    print(f"nn bitwise {name}: Q={q.shape[0]} M={r.shape[0]} d={q.shape[1]} "
          f"{mode_name(fused_norms)}, d2 differing in any bit {bits}, indices differing {moved}", flush=True)
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

    q, r = voxels(20000, 20000)
    for fused in (False, True):
        check_bitwise("20000 voxels each way", q, r, nn, fused)
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
    check_bitwise("queries on far references (cancellation)", q, r, nn, fused_norms=True)
    negative, zero = int((d2[:4000] < 0).sum()), int((d2[:4000] == 0).sum())
    print(f"nn cancellation: of 4000 queries on a reference, d2 < 0 for {negative}, "
          f"== 0 for {zero}", flush=True)
    if not negative or not zero:
        fail("the cancellation case produced no negative or no zero d2")
    check_bitwise("one query", *voxels(1, 1_000_000), nn)
    for d in range(1, 9):
        q, r = voxels(3000, 7001, d)
        for fused in (False, True):
            check_bitwise(f"width {d}", q, r, nn, fused)


def phase_kernel(nn, gpu):
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    max_abs = 0.0
    for qn, mn, d in ((1, 1, 3), (37, 5, 3), (513, 2049, 3), (1000, 3001, 2), (700, 900, 8)):
        q = torch.rand(qn, d, generator=gen, device=dev) * 40
        r = torch.rand(mn, d, generator=gen, device=dev) * 40
        for fused in (False, True):
            max_abs = max(max_abs, check_case(f"ragged {qn}x{mn}", q, r, nn, fused))

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
    for fused in (False, True):
        max_abs = max(max_abs, check_case(f"{NN_MAIN_ROWS} voxels", q, r, nn, fused))
    ms = time_ms(lambda: nn.NN_KERNEL(q, r), 10)
    on_device_ms = device_ms(lambda: nn.NN_KERNEL(q, r), 10)
    plain_ms = time_ms(lambda: nn.nn_argmin_plain(q, r), 2)
    # chunks of 9 GB: cdist's GEMM output and its sum each take one
    library_ms = time_ms(lambda: library_nn(q, r, 9e9), 2)
    chunks = -(-NN_MAIN_ROWS // library_rows(r, 9e9))
    bound_ms, bound_by = nn_bound(NN_MAIN_ROWS, NN_MAIN_ROWS, 3)
    print(f"nn time at {NN_MAIN_ROWS}x{NN_MAIN_ROWS}x3: kernel {ms:.3f} ms a call (on the "
          f"device {on_device_ms:.3f} ms), plain {plain_ms:.3f} ms, library "
          f"{library_ms:.3f} ms in {chunks} row chunks, bound {bound_ms:.3f} ms ({bound_by}), "
          f"share {bound_ms / ms:.3f} [{gpu}]", flush=True)
    phase_split_edges(nn)
    return max_abs


def library_rows(r, max_bytes=LIBRARY_MAX_BYTES):
    """Query rows a chunk of :func:`library_nn` takes against ``r``."""
    return max(1, int(max_bytes // (4 * r.shape[0])))


def library_nn(q, r, max_bytes=LIBRARY_MAX_BYTES):
    """One PyTorch call for the same function (the yardstick; the port
    never calls it): Euclidean distances through a GEMM, then the row
    minimum and its index; in chunks of rows whose distance matrix holds at
    most ``max_bytes``."""
    rows = library_rows(r, max_bytes)
    parts = [torch.cdist(q[i:i + rows], r, compute_mode="use_mm_for_euclid_dist").min(dim=1)
             for i in range(0, q.shape[0], rows)]
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.values for p in parts]), torch.cat([p.indices for p in parts])


def time_kernel_at(nn, gpu, name, q, r, fused_norms=False):
    """Time the kernel on (q, r) in the caller's rounding mode of the norms
    beside the plain version in that mode and the library call, then check
    it against the plain version on the card and bit for bit on the CPU
    (after the timing, so that no CPU work overlaps it).  Returns the
    numbers of its ``paths`` entry."""
    plain_ms = time_ms(lambda: nn.nn_argmin_plain(q, r, fused_norms), 5)
    ms = time_ms(lambda: nn.NN_KERNEL(q, r, fused_norms), 20)
    chunks = -(-q.shape[0] // library_rows(r))
    library_ms = time_ms(lambda: library_nn(q, r), 5)
    ms_again = time_ms(lambda: nn.NN_KERNEL(q, r, fused_norms), 20)
    on_device_ms = device_ms(lambda: nn.NN_KERNEL(q, r, fused_norms), 20)
    bound_ms, bound_by = nn_bound(q.shape[0], r.shape[0], q.shape[1])
    library = f"{library_ms:.4f} ms" + (f" in {chunks} row chunks" if chunks > 1 else "")
    print(f"nn time at {name} {q.shape[0]}x{r.shape[0]}x{q.shape[1]} ({mode_name(fused_norms)}): "
          f"kernel {ms:.4f} ms a call "
          f"(again {ms_again:.4f} ms; on the device {on_device_ms:.4f} ms), plain {plain_ms:.4f} ms, "
          f"library {library}, bound {bound_ms:.4f} ms ({bound_by}), "
          f"share {bound_ms / ms:.3f} [{gpu}]", flush=True)
    max_abs = check_case(name, q, r, nn, fused_norms)
    check_bitwise(name, q, r, nn, fused_norms)
    return {"fused_norms": fused_norms, "max_abs_err": max_abs, "ms": ms, "device_ms": on_device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_kernel_main_shapes(nn, gpu, nn_calls, tag=""):
    """The kernel at the largest call each of its callers made on a main
    path, on the operands and in the rounding mode of that call: the
    reassigner's pair kernel matches the predictions of one frame's voxels
    (in microns) against the next frame's voxels with fused norms; the
    Hierarchy measures the border distance of a frame's skeleton and node
    voxels against its border voxels with rounded ones."""
    rows = []
    for caller, what in (("reassign", "reassigner's largest match"),
                         ("hierarchy", "Hierarchy's largest border match")):
        if caller not in nn_calls:
            fail(f"the {tag}main path made no nn call from the {caller} stage")
        q, r, fused = nn_calls[caller]
        rows.append(time_kernel_at(nn, gpu, f"the {tag}{what}", q, r, fused))
    return tuple(rows)


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


def tracking_launches(im_info, flow_path):
    """The tracking stage alone (``HuMomentTracking(im_info,
    device="cuda").run()``, as ``run`` calls it by default) on a series whose
    other stages have run, under ``torch.profiler``, writing its flow vectors
    to ``flow_path`` so that the series' own artifact stays as ``run`` wrote
    it: its CUDA kernels, its copies and memsets (device events apart from
    the kernels), its seconds with the profiler on, and whether its flow
    vectors equal the series' byte for byte."""
    from torch.profiler import ProfilerActivity, profile

    from nellie_tpu_torch.stages.hu_tracking import HuMomentTracking

    class Profiled(HuMomentTracking):
        def _allocate_memory(self):
            super()._allocate_memory()
            self.flow_vector_array_path = flow_path

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        Profiled(im_info, device="cuda").run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(1 for n in names if n.startswith(("Memcpy", "Memset")))
    same = np.load(flow_path).tobytes() == artifact(im_info, "flow_vector_array").tobytes()
    return {"cuda_kernels": len(names) - copies, "memcpy_memset": copies, "seconds": seconds,
            "same_flow": same}


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
    reset_hand_counts()
    with StageWatch(nn, (VoxelReassigner, Hierarchy)) as watch, KernelCalls() as calls:
        im_info, timings = run(fi, device="cuda", return_timings=True)
    launches = nn.NN_KERNEL.launches
    hand = read_hand_counts()
    kernel_launches = read_kernel_launches()
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
    by_caller = {name: {} for name in calls.calls}
    for name, made in calls.calls.items():
        for caller, _ in made:
            by_caller[name][caller] = by_caller[name].get(caller, 0) + 1
    print(f"{tag}hand kernel launches on the main path: {json.dumps(hand)}, by caller "
          f"{json.dumps(by_caller)}", flush=True)
    check_fma_callers(tag + "main path", calls.fma_callers(), hand["fma_f32"], hand["fma_chain"])
    seed_dist = {c: n for by in (calls.fma_by_caller, calls.chain_by_caller)
                 for c, n in by.items() if c.startswith("edt.")}
    if seed_dist:
        fail(f"{tag}Network's nearest seed launched fma_f32: {json.dumps(seed_dist)}")
    # thinning: thin26 on the 3D path, Zhang-Suen's thin2d on the 2D path;
    # the cross-cell merge on the capacity path only
    required = {k: n for k, n in hand.items()
                if (k != "thin26" or len(shape) == 4) and (k != "thin2d" or len(shape) == 3)
                and k != "ccl_merge"}
    if min(required.values()) == 0:
        fail(f"{tag}the main path never launched one of the hand kernels: {json.dumps(hand)}")
    print_gauss_taps(tag + "main path", calls.gauss_taps)
    print(f"{tag}Network's kernels on the main path: thin26 {hand['thin26']} calls "
          f"({kernel_launches['thin26']} CUDA kernels), thin2d {hand['thin2d']} calls "
          f"({kernel_launches['thin2d']} CUDA kernels), nearest_seed {hand['nearest_seed']} "
          f"calls ({kernel_launches['nearest_seed']} CUDA kernels); Markers' edt_minplus "
          f"{hand['edt_minplus']} calls ({kernel_launches['edt_minplus']} CUDA kernels); the "
          f"Filter's masked_percentile {hand['masked_percentile']} calls "
          f"({kernel_launches['masked_percentile']} CUDA kernels)", flush=True)
    print(f"{tag}tracking's and the thresholds' kernels on the main path: "
          + ", ".join(f"{k} {hand[k]} calls ({kernel_launches[k]} CUDA kernels)"
                      for k in ("hu_features", "pair_sums", "pair_costs", "roi_stats",
                                "hist_threshold")),
          flush=True)
    tracking = tracking_launches(im_info, os.path.join(root, f"flow_profiled{tag.strip()}.npy"))
    print(f"{tag}tracking alone on the main path's artifacts (HuMomentTracking.run under "
          f"torch.profiler): {tracking['cuda_kernels']} CUDA kernels, "
          f"{tracking['memcpy_memset']} copies and memsets, {tracking['seconds']:.3f} s with "
          f"the profiler on, flow vectors equal to the main path's: {tracking['same_flow']} "
          f"[{gpu}]", flush=True)
    if not tracking["same_flow"]:
        fail(f"{tag}tracking run again gave other flow vectors than the main path's")

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
    return launches, watch.launches, im_info, timings, {"launches": hand,
                                                        "kernel_launches": kernel_launches,
                                                        "calls": calls.calls,
                                                        "fma_largest": calls.fma_largest,
                                                        "largest": calls.largest(),
                                                        "wrapper_calls": calls.wrapper_calls,
                                                        "nn": calls.nn_operands(),
                                                        "fma_by_caller": calls.fma_callers(),
                                                        "gauss_taps": calls.gauss_taps,
                                                        "filter_frames": calls.filter_frames,
                                                        "tracking": tracking}


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
    equal to the fused run's byte for byte, the feature CSVs too (the
    Hierarchy's float64 sums add in one order on every device),
    ``seg_fused`` beside the four stages' seconds, the device frame cache's
    peak, and the fused chain's own seconds by stage with each stage
    fenced."""
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
    if differ:
        fail(f"{tag}fused and per-stage artifacts differ on the card: {sorted(differ)}")
    print(f"{tag}fused vs per-stage on the card: {len(fused_files)} of {len(fused_files)} "
          f"artifacts equal byte for byte", flush=True)
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
    print(f"{tag}Network fenced in the fused chain: {fenced['network']:.3f} s [{gpu}]",
          flush=True)


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
    exactly, flow costs and the feature tables at
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
    names = ["im_instance_label", "im_skel", "im_pixel_class", "im_skel_relabelled",
             "im_marker", "im_border"]
    if temporal:
        names += ["im_branch_label_reassigned", "im_obj_label_reassigned"]
    for name in names:
        a, b = artifact(infos["cuda"], name), artifact(infos["cpu"], name)
        diff = int((a != b).sum())
        worst[name] = diff
        if diff:
            fail(f"{tag}{name}: {diff} voxels differ between card and CPU")
    if temporal:
        fa = artifact(infos["cuda"], "flow_vector_array")
        fb = artifact(infos["cpu"], "flow_vector_array")
        if fa.shape != fb.shape or fa.shape[0] == 0:
            fail(f"{tag}flow_vector_array shapes differ or are empty: {fa.shape} vs {fb.shape}")
        worst["flow_vector_array"] = float(np.abs(fa - fb).max())
        if config is None and source is None and worst["flow_vector_array"] != 0:
            fail(f"{tag}flow costs differ between card and CPU "
                 f"({worst['flow_vector_array']:.3g})")

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

    def recorded(queries, refs, device="cuda", **kwargs):
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
    reset_hand_counts()
    shapes = {}

    def keep(name, tag, args):
        """The first area-filter window and the first fill-holes and label
        cells."""
        key = (tag, tuple(args[0].shape))
        shapes[key] = shapes.get(key, 0) + 1
        first = sum(n for (t, _), n in shapes.items() if t == tag) == 1
        return name == "ccl_union_find" and first and (
            (key[1] == CAPACITY_WINDOW and tag == "capacity/remove_small_components")
            or tag in ("capacity/fill_holes_cell", "capacity/label_cell"))

    start = time.perf_counter()
    with KernelCalls(keep) as calls:
        out = capacity.segment_volume(vol, params, emit="sparse_labels", device="cuda")
    seconds = time.perf_counter() - start
    hand = read_hand_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    labels = out["labels"]
    print(f"capacity {edge}^3: volume made in {made:.1f} s; segment_volume {seconds:.1f} s "
          f"({labels.size / seconds / 1e6:.1f} Mvox/s), strategy {out['strategy']}, emit "
          f"{out['emit']}, raw resident {out['raw_resident']}, n_labels {out['n_labels']}, "
          f"fg_count {out['fg_count']} ({out['fg_count'] / labels.size:.4%}), labels "
          f"{labels.dtype}, {out['bytes_up'] / 1e9:.3f} GB up, {out['bytes_down'] / 1e9:.3f} "
          f"GB down, peak device memory {peak_gib:.3f} GiB [{gpu}]", flush=True)
    print(f"capacity {edge}^3 seconds by phase: "
          + ", ".join(f"{k} {v:.3f}" for k, v in out["seconds"].items()) + f" [{gpu}]",
          flush=True)
    print(f"capacity {edge}^3 hand kernel launches: {json.dumps(hand)}; union-find calls by "
          "caller and shape: " + ", ".join(f"{t} {sh} x{n}" for (t, sh), n in shapes.items()),
          flush=True)
    check_fma_callers(f"capacity {edge}^3", calls.fma_callers(), hand["fma_f32"],
                      hand["fma_chain"])
    print_gauss_taps(f"capacity {edge}^3", calls.gauss_taps)
    # fma_f32's one call a volume was the percentile's; the percentile kernel
    # does its own multiply-add
    if min(hand[k] for k in CAPACITY_KERNELS) == 0:
        fail(f"capacity {edge}^3 never launched one of {', '.join(CAPACITY_KERNELS)}: "
             f"{json.dumps(hand)}")
    if out["strategy"] != "chunked" or out["fg_count"] != int((labels > 0).sum()):
        fail(f"capacity {edge}^3: not the chunked strategy, or fg_count is not the support")
    print(f"capacity {edge}^3 merges: {hand['ccl_merge']} calls of the merge kernel, "
          f"{read_kernel_launches()['ccl_merge']} CUDA kernels; bytes down "
          f"{out['bytes_down']} (the product: {out['fg_count']} int32 indices and "
          f"{labels.dtype} labels)", flush=True)
    if out["bytes_down"] != out["fg_count"] * (4 + labels.itemsize):
        fail(f"capacity {edge}^3: {out['bytes_down']} bytes down, not the product's alone")
    if peak_gib > CAPACITY_PEAK_GIB:
        fail(f"capacity {edge}^3: peak device memory {peak_gib:.3f} GiB > {CAPACITY_PEAK_GIB}")
    start = time.perf_counter()
    ref, ref_n = ndimage.label(labels > 0, structure=np.ones((3, 3, 3)))
    equal = ref_n == out["n_labels"] and np.array_equal(ref, labels)
    print(f"capacity {edge}^3 against scipy.ndimage.label: {ref_n} components, labels "
          f"{'equal' if equal else 'DIFFERENT'} ({time.perf_counter() - start:.1f} s)", flush=True)
    if not equal:
        fail(f"capacity {edge}^3: labels are not scipy's labelling of their support")
    return dict({k: out[k] for k in ("n_labels", "fg_count", "seconds")}, launches=hand,
                kernel_launches=read_kernel_launches(),
                calls=calls.calls["ccl_union_find"], fma_largest=calls.fma_largest,
                largest=calls.largest(), wrapper_calls=calls.wrapper_calls,
                fma_by_caller=calls.fma_callers(), gauss_taps=calls.gauss_taps,
                peak_gib=peak_gib, volume=vol)


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


# ---------------------------------------------------------------------------
# phase 13: the float16 Frangi carry
# ---------------------------------------------------------------------------

def phase_float16(nn, gpu, root):
    """The small 3D and 2D series with ``preprocessing_carry_dtype=
    "float16"``, card against CPU at phase 5's bars (with the kernel's
    launches in the card's 3D run); then Filter on the 3D main series,
    float32 and float16 in turns, with its seconds."""
    from nellie_tpu_torch.config import SettingsConfig
    from nellie_tpu_torch.io import ImInfo
    from nellie_tpu_torch.stages.filtering import Filter

    cfg = SettingsConfig(preprocessing_carry_dtype="float16", analyze_node_level=True)
    launches = phase_small_parity(root, small_series(), "TZYX",
                                  {"X": 0.2, "Y": 0.2, "Z": 0.5, "T": 1.0},
                                  tag="float16 ", config=cfg, nn=nn)
    if launches["total"] == 0:
        fail("the float16 run never launched the nn kernel")
    phase_small_parity(root, small_series_2d(), "TYX", {"X": 0.1, "Y": 0.1, "Z": None, "T": 1.0},
                       tag="float16 2D ", config=cfg)
    seconds = {"float32": [], "float16": []}
    frames = {}
    for carry in ("float32", "float16", "float16", "float32"):
        im_info = ImInfo(write_series(
            os.path.join(root, f"filter_{carry}_{len(seconds[carry])}"), MAIN_SHAPE))
        stage = Filter(im_info, device="cuda", carry_dtype=carry)
        torch.cuda.synchronize()
        start = time.perf_counter()
        stage.run()
        torch.cuda.synchronize()
        seconds[carry].append(time.perf_counter() - start)
        frames[carry] = artifact(im_info, "im_preprocessed")
    a, b = frames["float16"], frames["float32"]
    both = (a > 0) & (b > 0)
    err = max(float(np.abs(a[t][both[t]].astype(np.float64) - b[t][both[t]]).max(initial=0.0))
              / max(float(np.abs(b[t]).max()), 1e-30) for t in range(MAIN_SHAPE[0]))
    flipped = int(((a > 0) != (b > 0)).sum())
    print(f"float16 carry: Filter on the 3D main series {MAIN_SHAPE}, in turns: float32 "
          + ", ".join(f"{x:.3f}" for x in seconds["float32"]) + " s, float16 "
          + ", ".join(f"{x:.3f}" for x in seconds["float16"])
          + f" s; im_preprocessed float16 vs float32: within {err:.3g} of the frame max where "
          f"both are positive, {flipped} of {a.size} voxels positive in only one [{gpu}]",
          flush=True)
    return {"launches": launches["total"]}


# ---------------------------------------------------------------------------
# phase 14: the native TIFF codec
# ---------------------------------------------------------------------------

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                        "tiff_codec")


def phase_native_codec():
    """Build the native TIFF codec with this machine's g++, then decode the
    committed fixture files (LZW, PackBits, the horizontal predictor), strip
    by strip, in one threaded batch and whole through the reader: native
    and Python decoders byte-equal, the pixels those of the manifest."""
    import hashlib

    from nellie_tpu_torch import native
    from nellie_tpu_torch.io import tiff

    if shutil.which("g++") is None:
        fail("g++ not found: the native TIFF codec cannot be built")
    start = time.perf_counter()
    native.available()
    build = time.perf_counter() - start
    status = native.status()
    if status["decoder"] != "native":
        fail(f"native TIFF codec not built: {status['error']}")
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    n_strips = 0
    for name, meta in sorted(manifest.items()):
        path = os.path.join(FIXTURES, name)
        with tiff.TiffFile(path) as tf:
            page = tf.pages[0]
            offsets = tiff._as_tuple(page.tag_value(273))
            counts = tiff._as_tuple(page.tag_value(279))
            rows_per_strip = int(page.tag_value(278, page.shape[0]))
            row_bytes = page.shape[1] * page.dtype.itemsize
            code, height = page.compression, page.shape[0]
        with open(path, "rb") as f:
            raws = []
            for off, cnt in zip(offsets, counts):
                f.seek(int(off))
                raws.append(f.read(int(cnt)))
        sizes = [min(rows_per_strip, height - i * rows_per_strip) * row_bytes
                 for i in range(len(raws))]
        python = tiff._lzw_decode if code == 5 else tiff._packbits_decode
        fast = native.lzw_decode if code == 5 else native.packbits_decode
        plain = [python(raw)[:size] for raw, size in zip(raws, sizes)]
        if [fast(raw, size) for raw, size in zip(raws, sizes)] != plain:
            fail(f"{name}: a strip decodes otherwise natively than in Python")
        batch = np.zeros(sum(sizes), np.uint8)
        lengths = [len(r) for r in raws]
        if not native.decode_strips(b"".join(raws), np.cumsum([0] + lengths[:-1]), lengths,
                                    batch, np.cumsum([0] + sizes[:-1]), sizes, code) \
                or batch.tobytes() != b"".join(plain):
            fail(f"{name}: the batch strip decoder differs from the Python decoder")
        before = native.status()["decoded"]["native"]
        whole = tiff.imread(path)
        if native.status()["decoded"]["native"] == before:
            fail(f"{name}: the reader did not take the native decoder")
        saved, native.CODEC = native.CODEC, native._Codec()
        native.CODEC.tried = True  # no library: the reader's Python decoders
        try:
            slow = tiff.imread(path)
        finally:
            native.CODEC = saved
        digest = hashlib.sha256(whole.tobytes()).hexdigest()
        if whole.tobytes() != slow.tobytes() or digest != meta["sha256"] \
                or list(whole.shape) != meta["shape"] or whole.dtype.str != meta["dtype"]:
            fail(f"{name}: the reader's native and Python paths, or the manifest, disagree")
        n_strips += len(raws)
    print(f"native TIFF codec: built with g++ in {build:.2f} s ({status['library']}); "
          f"{len(manifest)} fixture files, {n_strips} strips: native = batch = Python decoders, "
          f"whole-file reads native = Python = manifest; {native.status()['decoded']}",
          flush=True)


# ---------------------------------------------------------------------------
# phase 15: the napari plugin on the card
# ---------------------------------------------------------------------------

def plugin_artifacts(im_info):
    out = {}
    for directory in (im_info.file_info.output_dir, im_info.file_info.nellie_necessities_dir):
        for name in os.listdir(directory):
            if os.path.isfile(os.path.join(directory, name)):
                out[name] = os.path.join(directory, name)
    return out


def phase_plugin(nn, gpu, root):
    """The port's ``NellieLoader`` on the repo's pure-Python Qt and napari
    stand-ins (``tests/qt_stubs.py``, installed only where Qt is absent):
    file select, then Run Nellie on the card's default device, on phase
    5's small 3D series, with the kernel's launches; every file it writes
    equal byte for byte to ``run(fused=False, device="cuda")``'s with the
    same settings."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import qt_stubs

    stubbed = qt_stubs.install()
    from nellie_tpu_torch.pipeline.run import run
    from nellie_tpu_torch.plugin.nellie_loader import NellieLoader

    dim_res = {"X": 0.2, "Y": 0.2, "Z": 0.5, "T": 1.0}
    nellie = NellieLoader(qt_stubs.FakeViewer())
    if nellie.settings.device() != "cuda":
        fail(f"the plugin's default device is {nellie.settings.device()!r}, not 'cuda'")
    fi = write_input(os.path.join(root, "plugin_gui"), "small", small_series(), "TZYX", dim_res)
    nellie.file_select.initialize_single_file(fi.filepath)
    nellie.file_select.process_button.click()
    nn.NN_KERNEL.launches = 0
    start = time.perf_counter()
    nellie.processor.run_all_button.click()
    seconds = time.perf_counter() - start
    launches = nn.NN_KERNEL.launches
    status = nellie.processor.status_label.text()
    if status != "Status: finished feature extraction":
        fail(f"the plugin's Run Nellie ended with {status!r}")
    if launches == 0:
        fail("the plugin's run never launched the nn kernel")
    ref = run(write_input(os.path.join(root, "plugin_run"), "small", small_series(), "TZYX",
                          dim_res), device="cuda", fused=False, config=nellie.settings.to_config())
    got, want = plugin_artifacts(nellie.im_info), plugin_artifacts(ref)
    if sorted(got) != sorted(want):
        fail(f"the plugin wrote other files than run(): {sorted(set(got) ^ set(want))}")
    differ = [k for k in got if not filecmp.cmp(got[k], want[k], shallow=False)]
    if differ:
        fail(f"the plugin's files differ from run(fused=False)'s: {sorted(differ)}")
    print(f"plugin on the card ({'Qt stand-ins' if stubbed else 'real Qt'}): Run Nellie "
          f"{seconds:.3f} s, nn launches {launches}; {len(got)} of {len(got)} files equal "
          f"run(fused=False, device='cuda')'s byte for byte [{gpu}]", flush=True)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 16: the multi-device path
# ---------------------------------------------------------------------------

MESH_CAPACITY_SHAPE = (256, 512, 512)


def differing_files(a_info, b_info, tag):
    """Names of the files two runs wrote that differ (fails when they wrote
    different files); also returns how many were compared."""
    a, b = written_files(a_info), written_files(b_info)
    if sorted(a) != sorted(b):
        fail(f"{tag}the runs wrote different files: {sorted(set(a) ^ set(b))}")
    return [k for k in a if not filecmp.cmp(a[k], b[k], shallow=False)], len(a)


def mesh_main_series(nn, gpu, root, mesh, name, single_info, single_timings):
    """``run(mesh=)`` on the 3D main series, the kernel's count set to 0 just
    before and read just after; every file held to phase 4's run."""
    from nellie_tpu_torch.pipeline.run import run
    from nellie_tpu_torch.stages.hierarchical import Hierarchy
    from nellie_tpu_torch.stages.voxel_reassignment import VoxelReassigner

    fi = write_series(os.path.join(root, f"mesh_{name}"), MAIN_SHAPE)
    nn.NN_KERNEL.launches = 0
    with StageWatch(nn, (VoxelReassigner, Hierarchy)) as watch:
        info, timings = run(fi, mesh=mesh, return_timings=True)
    launches = dict(watch.launches, total=nn.NN_KERNEL.launches)
    differ, n = differing_files(single_info, info, f"mesh {name}: ")
    if differ:
        fail(f"mesh {name}: files differ from the one-device run: {sorted(differ)}")
    print(f"mesh {name} {mesh}: {n} of {n} files equal phase 4's byte for byte; nn launches "
          f"by stage {json.dumps(launches)}", flush=True)
    print(f"mesh {name} seconds by stage: "
          + ", ".join(f"{k} {v:.3f} (one device {single_timings.get(k, float('nan')):.3f})"
                      for k, v in timings.items()) + f" [{gpu}]", flush=True)
    if launches["total"] == 0 or launches["VoxelReassigner"] == 0 or launches["Hierarchy"] == 0:
        fail(f"mesh {name}: the reassigner or the Hierarchy never launched the nn kernel")
    return launches


def phase_mesh(nn, gpu, root, single_info, single_timings):
    """16: the multi-device path (see the module docstring)."""
    from nellie_tpu_torch.kernels.frangi import FrangiParams
    from nellie_tpu_torch.mesh import make_mesh
    from nellie_tpu_torch.pipeline import capacity
    from nellie_tpu_torch.pipeline.batch import run_files
    from nellie_tpu_torch.pipeline.run import run

    start = time.perf_counter()
    print("mesh: logical shards (one card listed four times); their seconds are not a "
          "multi-GPU speed", flush=True)
    launches = mesh_main_series(nn, gpu, root, make_mesh(devices=["cuda:0"] * 4, t_axis=2),
                                "3D 2x2", single_info, single_timings)

    small = small_series_2d()
    res_2d = {"X": 0.1, "Y": 0.1, "Z": None, "T": 1.0}
    one = run(write_input(os.path.join(root, "mesh2d_one"), "small", small, "TYX", res_2d),
              device="cuda")
    four = run(write_input(os.path.join(root, "mesh2d_mesh"), "small", small, "TYX", res_2d),
               mesh=make_mesh(devices=["cuda:0"] * 4))
    differ, n = differing_files(one, four, "mesh 2D: ")
    if differ:
        fail(f"mesh 2D 1x4: files differ from the one-device run: {sorted(differ)}")
    print(f"mesh 2D 1x4 on the small TYX input: {n} of {n} files equal byte for byte",
          flush=True)

    t_n, *frame_shape = MAIN_SHAPE
    frame = make_frame(tuple(frame_shape))
    shifted = np.stack([np.roll(np.roll(frame, 3 * t, axis=1), 11, axis=2) for t in range(t_n)])
    alone = run(write_input(os.path.join(root, "files_alone1"), "series", shifted, "TZYX",
                            DIM_RES), device="cuda")
    files = [write_series(os.path.join(root, "files0"), MAIN_SHAPE),
             write_input(os.path.join(root, "files1"), "series", shifted, "TZYX", DIM_RES)]
    t0 = time.perf_counter()
    batch = run_files(files, mesh=make_mesh(devices=["cuda:0"] * 2, t_axis=2))
    batch_s = time.perf_counter() - t0
    for k, want in enumerate((single_info, alone)):
        differ, n = differing_files(want, batch[k], f"run_files file {k}: ")
        if differ:
            fail(f"run_files file {k}: files differ from its own run(): {sorted(differ)}")
    print(f"run_files on a 2x1 mesh: two main-series files in {batch_s:.3f} s, {n} of {n} "
          f"files of each equal its own run()'s [{gpu}]", flush=True)

    vol = np.ascontiguousarray(capacity_volume(MESH_CAPACITY_SHAPE[1])[:MESH_CAPACITY_SHAPE[0]])
    params = FrangiParams(sigmas=CAPACITY_SIGMAS, spacing=(1.0, 1.0, 1.0), z_ratio=1.0)
    out = {}
    for name, kw in (("monolith", dict(strategy="monolith", max_chunk_voxels=vol.size,
                                       device="cuda")),
                     ("mesh", dict(mesh=make_mesh(devices=["cuda:0"] * 4)))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = capacity.segment_volume(vol, params, emit="labels", **kw)
        torch.cuda.synchronize()
        out[name] = (res, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2 ** 30)
    (mono, mono_s, mono_gib), (mesh_res, mesh_s, mesh_gib) = out["monolith"], out["mesh"]
    equal = (mesh_res["strategy"] == "mesh" and mesh_res["n_labels"] == mono["n_labels"]
             and np.array_equal(mesh_res["labels"], mono["labels"]))
    print(f"capacity mesh z=4 on {MESH_CAPACITY_SHAPE}: {mesh_s:.3f} s, peak {mesh_gib:.3f} GiB, "
          f"{mesh_res['n_labels']} labels; one-window monolith {mono_s:.3f} s, peak "
          f"{mono_gib:.3f} GiB, {mono['n_labels']} labels; labels "
          f"{'equal' if equal else 'DIFFERENT'} [{gpu}]", flush=True)
    if not equal or mono["n_labels"] == 0:
        fail("capacity mesh: labels differ from the one-window monolith's, or none")

    if torch.cuda.device_count() > 1:
        mesh_main_series(nn, gpu, root, make_mesh(t_axis=2), "3D real cards", single_info,
                         single_timings)
    else:
        print("mesh: one card visible, so only logical shards ran; a run over real cards "
              "needs a machine with more than one", flush=True)
    print(f"phase 16 (mesh): {time.perf_counter() - start:.1f} s", flush=True)
    return {"launches": launches["total"], "by_stage": launches}


# ---------------------------------------------------------------------------
# phase 17: the union-find and flow interpolation kernels against their
# plain bodies; their inputs and numpy models (the CPU tests use them too)
# ---------------------------------------------------------------------------

CCL_SHAPE_3D = (64, 256, 256)
CCL_SHAPE_2D = (1024, 1024)
CAPACITY_WINDOW = (262, 520, 640)  # one halo window of the 1024^3 area filter
# the plain body's min propagation crosses a stretch of the serpentine that
# runs against the raster order one voxel a round, so it is held to the
# plain body at these shapes only, and to scipy's labelling at the large ones
SERPENTINE_SHAPES = ((8, 32, 64), (64, 128))
INTERP_LIST_LEN = 32  # in-radius rows a query of flow_interp.cu lists before it overflows
INTERP_TILED_ROWS = 20_000  # more flow rows than flow_interp.cu keeps in shared memory


def serpentine(shape):
    """A one-voxel-thick path through the whole volume (2D or 3D): every
    other row in full, joined at alternate ends, every other plane likewise;
    one component at either connectivity, and the longest path for
    propagation rounds."""
    if len(shape) < 3:
        return serpentine((1,) * (3 - len(shape)) + tuple(shape)).reshape(shape)
    mask = np.zeros(shape, bool)
    z_n, y_n, x_n = shape
    end = 0
    rows = [(z, y) for z in range(0, z_n, 2)
            for y in (range(0, y_n, 2) if z % 4 == 0 else range((y_n - 1) // 2 * 2, -1, -2))]
    for k, (z, y) in enumerate(rows):
        mask[z, y, :] = True
        if k + 1 < len(rows):
            nz, ny = rows[k + 1]
            end = x_n - 1 if k % 2 == 0 else 0
            if nz == z:
                mask[z, min(y, ny):max(y, ny) + 1, end] = True
            else:
                mask[z:nz + 1, y, end] = True
    return mask


def ccl_masks(shape, seed=0):
    """Phase 17's masks for the union-find kernel at a 2D or 3D ``shape``,
    by name, as numpy bool arrays (the serpentine apart: see
    :data:`SERPENTINE_SHAPES`)."""
    rng = np.random.default_rng(seed)
    one = np.zeros(shape, bool)
    one[tuple(s // 2 for s in shape)] = True
    faces = rng.random(shape) < 0.3
    for axis in range(len(shape)):
        for end in (0, shape[axis] - 1):
            idx = [slice(None)] * len(shape)
            idx[axis] = end
            faces[tuple(idx)] |= rng.random(faces[tuple(idx)].shape) < 0.6
    return {
        "background": np.zeros(shape, bool),
        "foreground": np.ones(shape, bool),
        "one voxel": one,
        "checkerboard": np.indices(shape).sum(axis=0) % 2 == 0,
        "every face": faces,
        "random 0.1%": rng.random(shape) < 0.001,
        "random 25%": rng.random(shape) < 0.25,
    }


def thin_masks(shape, seed=0):
    """Masks for the 3D thinning at ``shape``, by name, as numpy bool
    arrays: wavy tubes, blobs, a one-voxel sheet, noise, a cross touching
    every face of the volume, empty and full."""
    rng = np.random.default_rng(seed)
    z, y, x = np.indices(shape, dtype=np.float64)
    z_n, y_n, x_n = shape
    tubes = ((y - 0.3 * y_n - 3 * np.sin(x / 4.0)) ** 2 + (z - z_n / 2) ** 2 < 5) | (
        (x - 0.6 * x_n - 2 * np.cos(y / 3.0)) ** 2 + (z - z_n / 2 + 1) ** 2 < 4)
    blobs = np.zeros(shape, bool)
    for _ in range(4):
        c = [rng.uniform(0, n) for n in shape]
        blobs |= (z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2 < rng.uniform(4, 12)
    sheet = np.zeros(shape, bool)
    sheet[z_n // 2, 1:-1, 2:] = True
    cz, cy, cx = z_n / 2 - 0.5, y_n / 2 - 0.5, x_n / 2 - 0.5
    faces = ((np.abs(y - cy) < 2.5) & (np.abs(z - cz) < 1.5)) | (
        (np.abs(x - cx) < 2.5) & (np.abs(z - cz) < 1.5)) | (
        (np.abs(x - cx) < 1.5) & (np.abs(y - cy) < 2.5))
    return {"tubes": tubes, "blobs": blobs, "sheet": sheet,
            "noise": rng.random(shape) < 0.35, "every face": faces,
            "empty": np.zeros(shape, bool), "full": np.ones(shape, bool)}


def thin2d_masks(shape, seed=0):
    """Masks for the 2D thinning at ``shape``, by name, as numpy bool
    arrays: the 2D path's tubes (``make_frame_2d`` above 300), blobs,
    one-pixel lines (a row, a column, a diagonal), a cross and a corner
    block touching every edge of the frame, noise, empty and full."""
    rng = np.random.default_rng(seed)
    y, x = np.indices(shape, dtype=np.float64)
    h, w = shape
    blobs = np.zeros(shape, bool)
    for _ in range(4):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        blobs |= (y - cy) ** 2 + (x - cx) ** 2 < rng.uniform(4, 40)
    lines = np.zeros(shape, bool)
    lines[h // 3, 1:-1] = True
    lines[1:-1, (2 * w) // 3] = True
    k = np.arange(min(h, w))
    lines[k, k] = True
    edges = (np.abs(y - h / 2) < 2.5) | (np.abs(x - w / 2) < 2.5)
    edges[:4, :4] = True
    return {"tubes": make_frame_2d(shape, seed) > 300, "blobs": blobs, "lines": lines,
            "edges": edges, "noise": rng.random(shape) < 0.35,
            "empty": np.zeros(shape, bool), "full": np.ones(shape, bool)}


def edt_mask(shape, seed=0, fill=0.35):
    """A mask for the distance transform: balls of radius 2 to 9 voxels
    on an empty frame (about ``fill`` of it), numpy bool."""
    rng = np.random.default_rng(seed)
    grid = np.indices(shape, dtype=np.float64)
    mask = np.zeros(shape, bool)
    while mask.mean() < fill:
        c = [rng.uniform(0, n) for n in shape]
        mask |= sum((g - cc) ** 2 for g, cc in zip(grid, c)) < rng.uniform(2, 9) ** 2
    return mask


# name: (shape, sampling, max_radius_px, mask kind): the Markers' clamps (11
# in 3D, 21 in 2D), no clamp, anisotropic spacing, an axis shorter than the
# clamp, one axis, a frame with no background, a clamp neither path uses,
# and one whose halo along a strided axis takes several chunks of the
# kernel's shared tile
EDT_CASES = {
    "3D clamp 11": ((14, 40, 44), None, 11, "balls"),
    "3D clamp 11, Z shorter": ((6, 30, 36), None, 11, "balls"),
    "2D clamp 21": ((48, 64), None, 21, "balls"),
    "2D clamp 21, Y shorter": ((12, 70), None, 21, "balls"),
    "3D no clamp, anisotropic": ((10, 30, 33), (0.5, 0.2, 0.2), None, "balls"),
    "2D no clamp, anisotropic": ((40, 50), (0.5, 0.2), None, "balls"),
    "2D clamp 21, anisotropic": ((44, 52), (0.3, 0.1), 21, "balls"),
    "1-D clamp 5": ((61,), None, 5, "balls"),
    "3D clamp 15": ((18, 40, 44), None, 15, "balls"),
    "2D clamp 15": ((40, 90), None, 15, "balls"),
    "2D clamp 70, halo in chunks": ((300, 30), (0.3, 0.2), 70, "balls"),
    "3D full": ((5, 9, 11), None, 11, "full"),
    "2D empty": ((20, 30), None, 21, "empty"),
}


def edt_case_mask(name, seed=0):
    """``EDT_CASES[name]``'s mask, numpy bool."""
    shape, _, _, kind = EDT_CASES[name]
    if kind == "full":
        return np.ones(shape, bool)
    if kind == "empty":
        return np.zeros(shape, bool)
    return edt_mask(shape, seed)


PERCENTILE_QS = (0.0, 1.0, 50.0, 100.0)
PERCENTILE_CASES = ("positive sample", "signed values", "ties", "one value", "empty", "+inf",
                    "all masked", "masked NaN", "masked NaN, all masked", "signed zeros")


def percentile_inputs(name, n=5000, seed=0):
    """(values float32, mask bool) numpy arrays of ``n`` for the percentile
    case ``name``: a frame's positive sample (the callers' mask, values >
    0), signed values, ties (a few integers), one masked value, none, +inf
    among the masked values, every value masked, masked signed values
    nearly all NaN (with unmasked values, whose +inf pads come before the
    NaNs in the sort, so that q = 1 interpolates between two pads, and with
    none), and zeros of both signs (three in
    four -0) with a few negatives below them, so that q = 1 and q = 50
    fall on the zeros and the sign of the one at each rank counts."""
    rng = np.random.default_rng(seed)
    values = (rng.gamma(2.0, 50.0, n) - 20.0).astype(np.float32)
    mask = values > 0
    if name == "signed values":
        mask = rng.random(n) < 0.6
    elif name == "ties":
        values = rng.integers(-2, 4, n).astype(np.float32)
        mask = rng.random(n) < 0.5
    elif name == "one value":
        mask = np.zeros(n, bool)
        mask[rng.integers(n)] = True
    elif name == "empty":
        mask = np.zeros(n, bool)
    elif name == "+inf":
        values[rng.random(n) < 0.1] = np.inf
    elif name == "all masked":
        mask = np.ones(n, bool)
    elif name.startswith("masked NaN"):
        values[rng.random(n) < 0.995] = np.nan
        mask = np.ones(n, bool) if name.endswith("all masked") else rng.random(n) < 0.6
    elif name == "signed zeros":
        values = np.where(rng.random(n) < 0.75, np.float32(-0.0), np.float32(0.0))
        kind = rng.random(n)
        values = np.where(kind < 0.005, -values - 1.0, values)
        values = np.where(kind > 0.8, np.abs(values) + 1.0, values).astype(np.float32)
        mask = rng.random(n) < 0.7
    return values, mask


THIN_DIRECTIONS = ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))


def thin26_model(mask, lut):
    """``kernels/csrc/thin26.cu`` in numpy: the list of the starting
    foreground; per direction the border phase's list of candidates; per
    round the select phase over the round's work list, then the commit
    phase, whose blocked voxels are the next round's work list (each phase
    writes only buffers it does not read; a barrier after each), until a
    round commits nothing.  Returns (the skeleton, (rounds, host reads,
    sweeps, kernels launched)) as the C entry point counts them: one launch
    and one read of the counts a call, none for an empty mask.  ``lut``:
    the 2**23-byte table as uint8."""
    from nellie_tpu_torch.kernels.simple_point import OFFSETS_26

    fg = np.pad(np.asarray(mask, bool).astype(np.uint8), 1)  # outside the volume: 0
    del_now = np.zeros_like(fg)
    listed = [a + 1 for a in np.nonzero(mask)]
    flips = [((abs(o[0]) % 2) << 2) | ((abs(o[1]) % 2) << 1) | abs(o[2]) % 2 for o in OFFSETS_26]

    def at(buf, pts, off):
        z, y, x = pts
        return buf[z + off[0], y + off[1], x + off[2]]

    def deletable(pts):
        code = np.zeros(pts[0].shape, np.uint32)
        for k, off in enumerate(OFFSETS_26):
            code |= at(fg, pts, off).astype(np.uint32) << np.uint32(k)
        return (lut[code >> 3] >> (code & 7)) & 1

    rounds = sweeps = 0
    changed = listed[0].size > 0
    while changed:
        changed = False
        sweeps += 1
        for d in THIN_DIRECTIONS:
            cand = (at(fg, listed, (0, 0, 0)) & (1 - at(fg, listed, d)) & deletable(listed)) > 0
            work = [a[cand] for a in listed]
            go = True
            while go:
                del_now[tuple(work)] = at(fg, work, (0, 0, 0)) & deletable(work)
                dn = at(del_now, work, (0, 0, 0)).astype(bool)
                z, y, x = work
                parity = ((z - 1) % 2) * 4 + ((y - 1) % 2) * 2 + (x - 1) % 2
                blocked = np.zeros(z.shape, bool)
                for off, flip in zip(OFFSETS_26, flips):
                    blocked |= at(del_now, work, off).astype(bool) & ((parity ^ flip) < parity)
                commit = dn & ~blocked
                fg[z[commit], y[commit], x[commit]] = 0
                del_now[tuple(work)] = 0
                work = [a[dn & blocked] for a in work]
                rounds += 1
                go = bool(commit.any())
                changed = changed or go
    stats = (rounds, 1, sweeps, 1) if listed[0].size else (0, 0, 0, 0)
    return fg[1:-1, 1:-1, 1:-1].astype(bool), stats


def seed_inputs(shape, seed=0, seed_fraction=0.05):
    """Object-constrained nearest-seed inputs at a 2D or 3D ``shape`` (numpy
    int32): objects, the labelled components of dilated noise; seeds,
    values 1-8 at a ``seed_fraction`` of the object voxels."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    mask = ndimage.binary_dilation(rng.random(shape) < 0.02, iterations=3)
    objects, _ = ndimage.label(mask)
    seeds = np.where((rng.random(shape) < seed_fraction) & mask,
                     rng.integers(1, 9, shape), 0)
    return seeds.astype(np.int32), objects.astype(np.int32)


def filter_frame(shape, seed=0, smooth=False):
    """A float32 frame for the Filter's kernels: a few bright wavy tubes on
    N(100, 8) noise, any shape of 1 to 3 axes; ``smooth`` passes it through
    a Gaussian of sigma 1 (what the tail sees after the cascade)."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.arange(n, dtype=np.float64) for n in shape], indexing="ij")
    frame = rng.normal(100.0, 8.0, shape)
    last = grids[-1]
    for _ in range(4):
        dist2 = np.zeros(shape)
        for g, n in zip(grids[:-1], shape[:-1]):
            centre = rng.uniform(0, n) + 0.15 * n * np.sin(last / rng.uniform(5, 15))
            dist2 = dist2 + (g - centre) ** 2
        frame = frame + rng.uniform(300, 900) * np.exp(-dist2 / (2 * rng.uniform(1.0, 3.0) ** 2))
    if smooth:
        frame = ndimage.gaussian_filter(frame, 1.0, mode="reflect")
    return frame.astype(np.float32)


def interp_inputs(n_q, n_m, d, seed=0):
    """Flow-interpolation inputs as a frame's flow gives them (numpy
    float32): anchors on a voxel grid in microns, vectors of whole voxel
    steps (many components exactly 0), positive costs; the queries voxels
    near the anchors, with ``n_q // 8`` on an anchor (distance 0), as many
    far from every anchor (an empty radius) and as many NaN.  Returns
    (query, anchors, vectors, costs, max_distance)."""
    rng = np.random.default_rng(seed)
    scale = np.array([0.5, 0.2, 0.2][-d:], np.float32)
    extent = np.array([16, 48, 48][-d:])
    anchors = (rng.integers(0, extent, (n_m, d)) * scale).astype(np.float32)
    vectors = rng.integers(-2, 3, (n_m, d)).astype(np.float32)
    costs = (rng.random(n_m) * 40 + 0.5).astype(np.float32)
    query = ((rng.random((n_q, d)) * extent) * scale).astype(np.float32)
    k = n_q // 8
    query[:k] = anchors[rng.integers(0, n_m, k)]
    query[k:2 * k] = -50.0 - rng.random((k, d)).astype(np.float32)
    query[2 * k:3 * k] = np.nan
    return query, anchors, vectors, costs, 1.0


def fma_rounded_twice(a, b, c):
    """a*b + c in float64, then float32: two roundings, as the port's
    ``_fp.fma`` computed it before it rounded to odd."""
    a, b, c = (np.asarray(x, np.float32).astype(np.float64) for x in (a, b, c))
    with np.errstate(invalid="ignore", over="ignore"):
        return (a * b + c).astype(np.float32)


def fma_exact(a, b, c):
    """a*b + c rounded once to float32, as ``__fmaf_rn`` rounds it: the
    product is exact in float64, the sum is rounded to odd (its error from
    a two-sum sets the last bit), and that rounds to float32 correctly,
    since 53 >= 24 + 2 bits."""
    a, b, c = (np.asarray(x, np.float32).astype(np.float64) for x in (a, b, c))
    with np.errstate(invalid="ignore", over="ignore"):
        p = a * b
        s = p + c
        bp = s - p
        err = (p - (s - bp)) + (c - bp)
        fix = np.isfinite(s) & (err != 0) & ((s.view(np.int64) & 1) == 0)
        s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
        return s.astype(np.float32)


def fma_operands(n, seed=0):
    """float32 (a, b, c), about n each, for the fused multiply-add: mixed
    signs over many scales, sums that cancel to zero or near it, subnormal
    results, infinities, NaN and signed zeros, and products on a float32
    midpoint nudged off it by a tiny c (``(1 + i 2**-12)(1 + j 2**-12)`` with
    i j odd needs 25 bits), where rounding twice goes wrong half the time."""
    rng = np.random.default_rng(seed)
    k = n // 5
    f32 = np.float32

    def scaled(size, lo, hi):
        return rng.standard_normal(size) * 2.0 ** rng.integers(lo, hi, size)

    wide = [scaled(k, -30, 30) for _ in range(3)]
    a, b = scaled(k, -20, 20).astype(f32), scaled(k, -20, 20).astype(f32)
    ulps = rng.integers(-3, 4, k).astype(f32)
    cancel = [a, b, -(a * b) + ulps * np.spacing(a * b)]
    tiny = [scaled(k, -80, -70), scaled(k, -80, -70),
            np.where(rng.random(k) < 0.5, 0.0, scaled(k, -140, -127))]
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -2.5, 3e38, 1e-45], f32)
    specials = [rng.choice(special, k) for _ in range(3)]
    i, j = (rng.integers(0, 2 ** 9, k) * 2 + 1 for _ in range(2))
    e1, e2 = rng.integers(-30, 30, k), rng.integers(-30, 30, k)
    sign = rng.choice([-1.0, 1.0], k)
    ties = [(1 + i * 2.0 ** -12) * 2.0 ** e1, (1 + j * 2.0 ** -12) * 2.0 ** e2 * sign,
            rng.choice([-1.0, 1.0, 3.0], k) * 2.0 ** (e1 + e2 - 60)]
    return tuple(np.concatenate([part[t] for part in (wide, cancel, tiny, specials, ties)])
                 .astype(f32) for t in range(3))


def chain_model(meta, bases, konst, shape, sources):
    """``fma_chain`` (``kernels/csrc/fma_f32.cu``) in torch: decode its
    int64 header, slot pointers and constants as the C entry point does,
    read each load as a strided view of the source tensor whose data the
    slot's pointer is (``sources``), and run the steps with
    ``_fp.fma_plain`` and float32 products and sums.  Returns the last
    step's value in ``shape``."""
    from nellie_tpu_torch.kernels import _fp

    by_ptr = {t.data_ptr(): t for t in sources}
    ndim, sizes, n_slots = meta[0], meta[1:5], meta[5]
    n = int(np.prod(shape))
    loads = []
    for j in range(meta[38]):
        slot, offset = meta[39 + j], meta[55 + j]
        base = by_ptr[bases[slot]]
        size, stride = ((n,), (1,)) if ndim == 0 else (
            tuple(sizes[:ndim]), tuple(meta[6 + 4 * slot:6 + 4 * slot + ndim]))
        assert slot < n_slots
        loads.append(torch.as_strided(base, size, stride, base.storage_offset() + offset)
                     .reshape(shape))
    regs = [None] * 4
    out = None
    for s in range(meta[71]):
        op, dst, *codes = meta[72 + 5 * s:77 + 5 * s]
        v = [regs[c] if c < 4 else loads[c - 4] if c < 20 else
             torch.tensor(konst[3 * s + a], dtype=torch.float32) for a, c in enumerate(codes)]
        if op == 0:
            out = _fp.fma_plain(v[0], v[1], v[2])
        elif op == 1:
            out = v[0] * v[1]
        else:
            out = v[0] + v[1]
        regs[dst] = torch.broadcast_to(out, shape)
    return regs[dst].reshape(shape)


def _interp_squared_norms(query, anchors):
    """(Q, M) squared norms as the kernel rounds them: d0*d0, then
    fma(dk, dk, acc)."""
    diff = query[:, None, :] - anchors[None, :, :]
    s = diff[..., 0] * diff[..., 0]
    for k in range(1, diff.shape[-1]):
        s = fma_exact(diff[..., k], diff[..., k], s)
    return s


def _interp_pass(s, costs, thresh):
    """The radius test of every pair, and over the rows inside it the
    statistics the kernel takes from its list: (inside (Q, M), any row
    inside, any inside at distance 0, -w_min)."""
    f32 = np.float32
    inside = s <= thresh
    dist = np.sqrt(np.where(inside, s, f32(1)))
    zero = inside & (dist == 0)
    inv = np.where(dist > 0, f32(1) / dist, f32(0))
    has_zero = zero.any(axis=1)
    mins = []
    for dw in (inv, zero.astype(f32)):
        products = np.where(inside, -costs[None, :] * dw, f32(np.inf))
        # NaN propagates through the kernel's minimum, as through torch.amin
        mins.append(np.where(np.isnan(products).any(axis=1), f32(np.nan), products.min(axis=1)))
    neg_w_min = -np.where(has_zero, mins[1], mins[0])
    return inside, inside.any(axis=1), has_zero, neg_w_min


def _interp_weight(s, cost, has_zero, neg_w_min):
    """A row's weight inside the radius: fma(-c, dw, -w_min) + 1."""
    f32 = np.float32
    dist = np.sqrt(f32(s))
    if has_zero:
        dw = f32(1) if dist == 0 else f32(0)
    else:
        dw = f32(1) / dist if dist > 0 else f32(0)
    return fma_exact(-cost, dw, neg_w_min) + f32(1)


def interp_lane_counts(vectors):
    """(signed, nonfinite): per dot lane (row mod 4) and component, how
    many rows' vector components have their sign bit set, and how many are
    not finite.  A row outside the radius adds +0 * v to its lane: -0
    where v's sign bit is set, NaN where v is not finite."""
    v = np.asarray(vectors, np.float32)
    lanes = np.arange(len(v)) % 4
    signed = np.stack([np.signbit(v[lanes == l]).sum(axis=0) for l in range(4)])
    nonfinite = np.stack([(~np.isfinite(v[lanes == l])).sum(axis=0) for l in range(4)])
    return signed, nonfinite


def interp_model(query, anchors, vectors, costs, max_distance, list_len=INTERP_LIST_LEN):
    """``kernels/csrc/flow_interp.cu`` in numpy, query by query.

    One pass over every pair takes the radius test (the squared norm
    against ``radius_threshold``) and lists the rows inside the radius in
    row order.  A query with at most ``list_len`` such rows then takes the
    distance-0 flag and the minimum weights over them, sums their weights
    in XLA's tree
    order, moving the window accumulators forward across every window
    boundary between two listed rows (a skipped row adds +0 to a sum that
    is never -0), and takes the dot over them in four lanes by row mod 4,
    each lane starting at -0 (the identity of a sum); a lane that stays
    zero is -0 only if every row it skipped has a negative-signed vector
    component, and NaN if one has a component that is not finite
    (:func:`interp_lane_counts`).  A query with more rows overflows its
    list and takes the three-pass loop over every row
    (:func:`interp_model_three_pass`)."""
    from nellie_tpu_torch.stages.flow_interpolation import radius_threshold, tree_levels

    f32 = np.float32
    q = np.asarray(query, f32)
    anchors, vectors, costs = (np.asarray(a, f32) for a in (anchors, vectors, costs))
    n_q, d = q.shape
    n_m = anchors.shape[0]
    thresh = f32(radius_threshold(max_distance))
    levels = tree_levels(n_m)
    signed, nonfinite = interp_lane_counts(vectors)
    per_lane = -(-n_m // 4)  # rows of each lane, zero padding rows included
    out = np.full((n_q, d), np.nan, f32)
    with np.errstate(all="ignore"):
        s = _interp_squared_norms(q, anchors)
        inside, anywhere, has_zero, neg_w_min = _interp_pass(s, costs, thresh)
        overflow = inside.sum(axis=1) > list_len
        if overflow.any():
            out[overflow] = interp_model_three_pass(q[overflow], anchors, vectors, costs,
                                                    max_distance)
        for i in np.flatnonzero(anywhere & ~overflow):
            rows = np.flatnonzero(inside[i])
            w = [_interp_weight(s[i, m], costs[m], has_zero[i], neg_w_min[i]) for m in rows]
            acc = [f32(0)] * (levels + 1)

            def cross(prev, m):  # flush every level whose window ends in (prev, m]
                for j in range(levels):
                    shift = 5 * (j + 1)
                    if (m >> shift) <= (prev >> shift):
                        break
                    acc[j + 1] = f32(acc[j + 1] + acc[j])
                    acc[j] = f32(0)

            prev = -1
            for m, wm in zip(rows, w):
                if prev >= 0:
                    cross(prev, m)
                acc[0] = f32(acc[0] + wm)
                prev = m
            cross(prev, n_m)
            for j in range(levels):
                acc[j + 1] = f32(acc[j + 1] + acc[j])
            safe = acc[levels] if acc[levels] > 0 else f32(1)
            lanes = np.full((4, d), -0.0, f32)
            listed = np.zeros(4, int)
            listed_signed = np.zeros((4, d), int)
            listed_nonfinite = np.zeros((4, d), int)
            for m, wm in zip(rows, w):
                lane = m % 4
                lanes[lane] = fma_exact(f32(wm / safe), vectors[m], lanes[lane])
                listed[lane] += 1
                listed_signed[lane] += np.signbit(vectors[m])
                listed_nonfinite[lane] += ~np.isfinite(vectors[m])
            skipped = (per_lane - listed)[:, None]
            all_negative = (signed - listed_signed) == skipped
            lanes = np.where((lanes == 0) & np.signbit(lanes) & ~all_negative, f32(0), lanes)
            lanes = np.where(nonfinite > listed_nonfinite, f32(np.nan), lanes)
            out[i] = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    return out


def interp_model_three_pass(query, anchors, vectors, costs, max_distance):
    """The kernel's path for a query whose list overflows, in numpy, all
    queries side by side: three passes over every row in order (the
    statistics, the weight sum, the dot); rows outside the radius skipped
    in the sum,
    which keeps one accumulator per level of XLA's windows of 32 and moves
    a full window up at its end; the dot in four lanes by row mod 4 over
    every row, padded with zero rows to a multiple of 4."""
    from nellie_tpu_torch.kernels._fp import REDUCE_WINDOW
    from nellie_tpu_torch.stages.flow_interpolation import tree_levels

    f32 = np.float32
    q = np.asarray(query, f32)
    anchors, vectors, costs = (np.asarray(a, f32) for a in (anchors, vectors, costs))
    n_q, d = q.shape
    n_m = anchors.shape[0]
    radius = f32(max_distance)
    one, zero = f32(1), f32(0)

    def squared_norm(m):
        diff = q - anchors[m]
        s = diff[:, 0] * diff[:, 0]
        for k in range(1, d):
            s = fma_exact(diff[:, k], diff[:, k], s)
        return s

    def weight(m, dist, inside, has_zero, neg_w_min):
        dw = np.where(has_zero, np.where(dist == 0, one, zero),
                      np.where(dist > 0, one / np.where(dist > 0, dist, one), zero))
        return np.where(inside, fma_exact(-costs[m], dw, neg_w_min) + one, zero)

    with np.errstate(all="ignore"):
        anywhere = np.zeros(n_q, bool)
        has_zero = np.zeros(n_q, bool)
        min_inv = np.full(n_q, np.inf, f32)
        min_zero = np.full(n_q, np.inf, f32)
        for m in range(n_m):
            dist = np.sqrt(squared_norm(m))
            inside = dist <= radius
            at_zero = dist == 0
            inv = np.where(dist > 0, one / np.where(dist > 0, dist, one), zero)
            for products, best in ((-costs[m] * inv, min_inv),
                                   (-costs[m] * np.where(at_zero, one, zero), min_zero)):
                take = inside & (np.isnan(products) | (products < best))
                best[take] = products[take]
            anywhere |= inside
            has_zero |= inside & at_zero
        neg_w_min = -np.where(has_zero, min_zero, min_inv)

        levels = tree_levels(n_m)
        acc = [np.zeros(n_q, f32) for _ in range(levels + 1)]
        for m in range(n_m):
            dist = np.sqrt(squared_norm(m))
            inside = dist <= radius
            if inside.any():
                w = weight(m, dist, inside, has_zero, neg_w_min)
                acc[0] = np.where(inside, acc[0] + w, acc[0])
            for j in range(levels):
                if (m + 1) % REDUCE_WINDOW ** (j + 1):
                    break
                acc[j + 1] = acc[j + 1] + acc[j]
                acc[j] = np.zeros(n_q, f32)
        for j in range(levels):
            acc[j + 1] = acc[j + 1] + acc[j]
        safe = np.where(acc[levels] > 0, acc[levels], one)

        lanes = [None] * 4
        for m in range(-(-n_m // 4) * 4):
            if m < n_m:
                dist = np.sqrt(squared_norm(m))
                inside = dist <= radius
                wn = np.where(inside, weight(m, dist, inside, has_zero, neg_w_min) / safe, zero)
                v = vectors[m]
            else:
                wn, v = np.zeros(n_q, f32), np.zeros(d, f32)
            a, b = wn[:, None], v[None, :]
            lanes[m % 4] = a * b if m < 4 else fma_exact(a, b, lanes[m % 4])
        out = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    return np.where(anywhere[:, None], out, f32(np.nan))


def same_bits(a, b):
    """Elementwise: equal float32 bits, or both NaN (NaN payloads differ
    between devices)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))


CAPACITY_CELLS = {"_fill_holes_chunked": "fill_holes_cell", "_label_chunked": "label_cell",
                  "_remove_small_chunked": "area_filter_cell"}


def caller_tag():
    """Which stage or path made the current kernel call, and through which
    ``ccl`` function or capacity cell pass: e.g. ``label/fill_holes``,
    ``network/label``, ``reassign``, ``hierarchy``,
    ``capacity/remove_small_components``, ``capacity/fill_holes_cell``."""
    import traceback

    places = (("stages/labelling.py", "label"), ("stages/networking.py", "network"),
              ("stages/voxel_reassignment.py", "reassign"), ("stages/hierarchical.py", "hierarchy"),
              ("pipeline/capacity.py", "capacity"), ("mesh/", "mesh"))
    stage, via = "other", None
    for frame in reversed(traceback.extract_stack()):
        path = frame.filename.replace(os.sep, "/")
        if via is None and path.endswith("kernels/ccl.py") and frame.name in (
                "fill_holes", "remove_small_components", "label"):
            via = frame.name
        if via is None and path.endswith("pipeline/capacity.py") and frame.name in CAPACITY_CELLS:
            via = CAPACITY_CELLS[frame.name]
        hit = next((name for place, name in places if place in path), None)
        if hit and (hit != "capacity" or via is not None or frame.name not in (
                "_cell_roots", "_merged_roots", "_iter_cells")):
            stage = hit
            break
    return stage if via is None else f"{stage}/{via}"


# the fma_f32 callers (module.function) that are the Filter's per-voxel
# arithmetic: since the Filter's kernels took it over, none may launch it
FILTER_FMA_MODULES = ("filters.", "hessian.", "eigen.")


def fma_caller():
    """The port's function that called ``_fp.fma`` (or a helper of
    ``_fp`` that did): ``module.function``, e.g. ``thresholds.triangle_threshold``."""
    frame = sys._getframe(1)
    while frame is not None:
        path = frame.f_code.co_filename.replace(os.sep, "/")
        if "/nellie_tpu_torch/" in path and not path.endswith("kernels/_fp.py"):
            return f"{path.rsplit('/', 1)[-1][:-3]}.{frame.f_code.co_name}"
        frame = frame.f_back
    return "other"


def filter_fma_callers(by_caller):
    """The Filter's per-voxel callers among ``fma_f32``'s callers."""
    return {c: n for c, n in by_caller.items()
            if c.startswith(FILTER_FMA_MODULES) or c.startswith("frangi.")}


class KernelCalls:
    """Within a ``with`` block, records the union-find and interpolation
    kernels' calls as (caller tag, arguments), keeping those for which
    ``keep(kernel name, tag, args)`` is true (tensors are cloned); the
    largest call of ``fma_f32`` (its operands); the largest call of the nn
    kernel from each caller tag (its operands and rounding mode); the
    largest call of each of the Filter's kernel wrappers,
    ``filters.correlate1d_traced`` and ``filters._correlate1d``,
    ``frangi.hessian_frob`` and ``frangi.frangi_response``, and of
    Network's, ``skeleton.skeletonize_3d`` and ``edt.nearest_seed``, with
    the caller's own arguments (tensors copied to the host before the call;
    the first of equal sizes); the largest chain of ``fma_f32.cu`` (its
    steps); and the single and chain launches by calling function, with the
    ``fma_f32`` launches each chain's steps took one call a step; and
    ``gauss_axis``'s launches by (tap count, offsets -r..r, the unrolled
    count of the instance the launch took, 0 for the run-time loop)."""

    WRAPPERS = {"correlate1d_traced": "filters", "_correlate1d": "filters",
                "hessian_frob": "frangi", "frangi_response": "frangi",
                "skeletonize_3d": "skeleton", "nearest_seed": "edt",
                "pair_stats": "matching", "pair_costs": "matching",
                "masked_mean_variance": "moments",
                "min_triangle_otsu": "thresholds", "otsu_threshold": "thresholds",
                "triangle_threshold": "thresholds", "triangle_and_otsu": "thresholds",
                "skeletonize_2d": "skeleton", "distance_transform": "edt",
                "masked_percentile_forms": "frangi", "hu_features": "moments"}

    def __init__(self, keep=lambda name, tag, args: True):
        self.keep = keep
        self.calls = {"ccl_union_find": [], "flow_interp": []}
        self.fma_largest = (0, None)  # (elements, operands) of the largest fma_f32 call
        self.fma_by_caller = {}
        # (elements, (steps, the program its caller passed)) of the largest chain
        self.chain_largest = (0, None)
        self.chain_by_caller = {}  # fma_f32.cu chain launches by calling function
        self.chain_fma_steps = {}  # the fma_f32 launches the chains' steps took one by one
        self.nn_largest = {}  # caller tag: (Q * M, (queries, refs, fused_norms))
        self.wrapper_largest = {name: (0, None) for name in self.WRAPPERS}
        self.wrapper_calls = {name: 0 for name in self.WRAPPERS}
        self.gauss_taps = {}  # (taps, offsets -r..r, instance taken): launches
        self.filter_frames = []  # (frame on the host, max_samples) of each finalize_frame call
        self._saved = []

    def _patch(self, cls, name, wrapper):
        original = getattr(cls, name)
        setattr(cls, name, lambda kernel, *args, _o=original, **kw: wrapper(_o, kernel, *args, **kw))
        self._saved.append((cls, name, original))

    def _record_wrapper(self, module, name):
        """Replace ``module.name`` (the callers look it up there) by a
        recorder of its largest call by the first argument's size."""
        import inspect

        original = getattr(module, name)
        signature = inspect.signature(original)

        def recorded(x, *args, **kw):
            self.wrapper_calls[name] += x.device.type == "cuda"
            if x.device.type == "cuda" and x.numel() > self.wrapper_largest[name][0]:
                # keyword arguments recorded by position, so that a replay
                # passes them all
                bound = args
                if kw:
                    full = signature.bind(x, *args, **kw)
                    full.apply_defaults()
                    bound = full.args[1:]
                host = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in bound)
                self.wrapper_largest[name] = (x.numel(), (x.cpu(),) + host)
            return original(x, *args, **kw)

        setattr(module, name, recorded)
        self._saved.append((module, name, original))

    def __enter__(self):
        from nellie_tpu_torch.kernels import (_fp, ccl, edt, filters, frangi, matching, moments,
                                              nn, skeleton, thresholds)
        from nellie_tpu_torch.stages import flow_interpolation as fi

        def fma_recorded(original, kernel, a, b, c):  # the operands themselves: their layout is timed
            caller = fma_caller()
            self.fma_by_caller[caller] = self.fma_by_caller.get(caller, 0) + 1
            out = original(kernel, a, b, c)
            if out.numel() > self.fma_largest[0]:
                self.fma_largest = (out.numel(), (a, b, c))
            return out

        def chain_recorded(original, kernel, steps, program=None):
            caller = fma_caller()
            listed = list(steps() if callable(steps) else steps)
            self.chain_by_caller[caller] = self.chain_by_caller.get(caller, 0) + 1
            self.chain_fma_steps[caller] = self.chain_fma_steps.get(caller, 0) + sum(
                op == _fp.FMA for _, op, *_ in listed)
            out = original(kernel, steps, program)
            if out.numel() > self.chain_largest[0]:
                self.chain_largest = (out.numel(), (listed, program))
            return out

        def nn_recorded(original, kernel, queries, refs, fused_norms=False):
            tag = caller_tag()
            size = queries.shape[0] * refs.shape[0]
            if size > self.nn_largest.get(tag, (0, None))[0]:
                self.nn_largest[tag] = (size, (queries.clone(), refs.clone(), fused_norms))
            return original(kernel, queries, refs, fused_norms)

        self._patch(_fp._FmaKernel, "__call__", fma_recorded)
        self._patch(_fp._FmaChainKernel, "__call__", chain_recorded)
        def gauss_recorded(original, kernel, x, taps, *args, **kw):
            out = original(kernel, x, taps, *args, **kw)
            if x.numel():
                offsets = [o for o, _ in taps]
                reach = len(offsets) // 2
                key = (len(offsets), offsets == list(range(-reach, reach + 1)),
                       kernel.last_used[0])
                self.gauss_taps[key] = self.gauss_taps.get(key, 0) + 1
            return out

        self._patch(nn._NNKernel, "__call__", nn_recorded)
        self._patch(filters._GaussAxisKernel, "__call__", gauss_recorded)
        modules = {"filters": filters, "frangi": frangi, "skeleton": skeleton, "edt": edt,
                   "moments": moments, "matching": matching, "thresholds": thresholds}
        for name, module in self.WRAPPERS.items():
            self._record_wrapper(modules[module], name)

        finalize = frangi.finalize_frame

        def finalize_recorded(frame, max_samples=int(1e6)):
            if frame.device.type == "cuda":
                self.filter_frames.append((frame.cpu(), max_samples))
            return finalize(frame, max_samples)

        frangi.finalize_frame = finalize_recorded
        self._saved.append((frangi, "finalize_frame", finalize))

        for name, cls in (("ccl_union_find", ccl._CCLKernel),
                          ("flow_interp", fi._FlowInterpKernel)):
            def recorded(original, kernel, *args, _name=name):
                tag = caller_tag()
                if self.keep(_name, tag, args):
                    self.calls[_name].append(
                        (tag, tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                    for a in args)))
                return original(kernel, *args)

            self._patch(cls, "__call__", recorded)
        return self

    def __exit__(self, *exc):
        for owner, name, original in reversed(self._saved):
            setattr(owner, name, original)

    def largest(self):
        """The largest calls of the Filter's and Network's kernel wrappers,
        of fma_f32 and of its chain."""
        return {"fma": self.fma_largest, "fma_chain": self.chain_largest, **self.wrapper_largest}

    def fma_callers(self):
        """fma_f32's single launches, chain launches and the chains' steps
        taken one call each, by calling function."""
        return {"single": self.fma_by_caller, "chain": self.chain_by_caller,
                "chain_steps": self.chain_fma_steps}

    def nn_operands(self):
        """{caller tag: (queries, refs, fused_norms)} of the largest nn calls."""
        return {tag: args for tag, (_, args) in self.nn_largest.items()}


def check_fma_callers(what, callers, launches, chain_launches):
    """Print ``fma_f32``'s launches by calling function, single calls and
    chains, beside the launches the same work took before the chains (one
    single call an ``FMA`` step), and fail if one of them is the Filter's
    per-voxel arithmetic, which its own kernels do."""
    single, chain, steps = callers["single"], callers["chain"], callers["chain_steps"]
    if sum(single.values()) != launches or sum(chain.values()) != chain_launches:
        fail(f"{what}: fma_f32 launches by caller add up to {sum(single.values())} single and "
             f"{sum(chain.values())} chain, the kernel counted {launches} and {chain_launches}")
    names = sorted(set(single) | set(chain))
    before = {c: single.get(c, 0) + steps.get(c, 0) for c in names}
    after = {c: single.get(c, 0) + chain.get(c, 0) for c in names}
    print(f"{what}: fma_f32 launches by caller, single {json.dumps(dict(sorted(single.items())))}"
          f", chain {json.dumps(dict(sorted(chain.items())))}; launches one call a step "
          f"(before the chains) {sum(before.values())}, with the chains {sum(after.values())}: "
          f"{json.dumps({c: [before[c], after[c]] for c in names})}", flush=True)
    filter_calls = filter_fma_callers({c: single.get(c, 0) + chain.get(c, 0) for c in names})
    if filter_calls:
        fail(f"{what}: the Filter's arithmetic launched fma_f32: {json.dumps(filter_calls)}")


def hand_counts():
    from nellie_tpu_torch.kernels import (_fp, ccl, edt, filters, frangi, matching, moments,
                                          skeleton, thresholds)
    from nellie_tpu_torch.stages import flow_interpolation as fi

    return {"ccl_union_find": ccl.CCL_KERNEL, "ccl_merge": ccl.MERGE_KERNEL,
            "flow_interp": fi.FLOW_INTERP_KERNEL,
            "fma_f32": _fp.FMA_KERNEL, "fma_chain": _fp.FMA_CHAIN_KERNEL,
            "gauss_axis": filters.GAUSS_AXIS_KERNEL,
            "frangi_tail": frangi.FRANGI_TAIL_KERNEL, "thin26": skeleton.THIN26_KERNEL,
            "nearest_seed": edt.NEAREST_SEED_KERNEL, "pair_sums": matching.PAIR_SUMS_KERNEL,
            "pair_costs": matching.PAIR_COSTS_KERNEL, "roi_stats": moments.ROI_STATS_KERNEL,
            "hist_threshold": thresholds.HIST_THRESHOLD_KERNEL,
            "thin2d": skeleton.THIN2D_KERNEL, "edt_minplus": edt.EDT_MINPLUS_KERNEL,
            "masked_percentile": frangi.MASKED_PERCENTILE_KERNEL,
            "hu_features": moments.HU_FEATURES_KERNEL}


def reset_hand_counts():
    for kernel in hand_counts().values():
        kernel.launches = 0
        if hasattr(kernel, "kernel_launches"):
            kernel.kernel_launches = 0


def read_hand_counts():
    return {name: kernel.launches for name, kernel in hand_counts().items()}


def read_kernel_launches():
    """The CUDA kernels launched by the wrappers that count them
    (``thin26``, ``nearest_seed``, ``pair_sums``, ``pair_costs``,
    ``roi_stats``, ``hist_threshold``, ``thin2d``, ``edt_minplus``,
    ``masked_percentile``, ``hu_features``); every other wrapper's call
    launches one kernel."""
    return {name: kernel.kernel_launches for name, kernel in hand_counts().items()
            if hasattr(kernel, "kernel_launches")}


def scipy_roots(mask, connectivity):
    """(each voxel's minimum linear index of its component, n for
    background; the roots) from ``scipy.ndimage.label``."""
    from scipy import ndimage

    structure = (np.ones((3,) * mask.ndim) if connectivity == "full"
                 else ndimage.generate_binary_structure(mask.ndim, 1))
    lab, _ = ndimage.label(mask, structure=structure)
    flat = lab.reshape(-1)
    _, first = np.unique(flat, return_index=True)
    first = np.asarray(first, np.int64)
    if flat[first[0]] == 0:
        first[0] = mask.size  # background
    else:
        first = np.concatenate([[mask.size], first])
    return first[flat], first[1:]


def ccl_bound(n):
    """(bound_ms, "bytes"): the mask read once (1 byte a voxel) and the int64
    roots written once (8 bytes), at the memory rate."""
    return 9 * n / HBM_BYTES_PER_S * 1e3, "bytes"


def check_ccl(mask, connectivity):
    """The kernel against the plain body on the card, exactly; returns (the
    number of components, max |kernel - plain|)."""
    from nellie_tpu_torch.kernels import ccl

    got = ccl.CCL_KERNEL(mask, connectivity)
    want = ccl.union_find_roots_plain(mask, connectivity)
    if got.dtype != torch.int64 or got.shape != want.shape:
        fail(f"union-find kernel on {tuple(mask.shape)}: {got.dtype} {tuple(got.shape)}, "
             f"not int64 {tuple(want.shape)}")
    err = int((got - want).abs().max()) if want.numel() else 0
    if err:
        fail(f"union-find kernel differs from its plain body on {tuple(mask.shape)} "
             f"{connectivity} in {int((got != want).sum())} voxels")
    return int((want == torch.arange(want.numel(), device=want.device)).sum()), err


def kernel_times(fn, reps):
    """(ms a call, ms on the device or None): the least of two rounds of
    ``time_ms`` and ``device_ms``."""
    times = [(time_ms(fn, reps), device_ms(fn, reps, required=False)) for _ in range(2)]
    return (min(t[0] for t in times),
            min((t[1] for t in times if t[1] is not None), default=None))


L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2 cache


def cold_times(fn, reps, on_device=True):
    """(ms a call, ms on the device or None) of ``fn`` with the L2 cache
    flushed before every call (a 256 MiB int16 buffer filled), so that
    every operand comes from device memory as the bounds assume: CUDA
    events around each call, and ``torch.profiler``'s kernel times less
    the flushes' (told apart by their int16 fill kernel, which no wrapper
    launches; skipped unless ``on_device``); the least of two rounds."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES // 2, dtype=torch.int16, device="cuda")

    def flushed_calls():
        for _ in range(reps):
            flush.fill_(1)
            fn()

    def device_round():
        """One profiled round's device ms a call, or None when the profiler
        hands back no events or not one flush a call."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flushed_calls()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        flushes = [e for e in events if "FillFunctor<short>" in e.name]
        if len(flushes) != reps or len(events) == reps:
            return None
        return sum(e.device_time for e in events if e not in flushes) / reps / 1e3

    fn()
    torch.cuda.synchronize()
    per_call, device = [], []
    for _ in range(2):
        pairs = []
        for _ in range(reps):
            flush.fill_(1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        per_call.append(sum(a.elapsed_time(b) for a, b in pairs) / reps)
        for _ in range(3 if on_device else 0):  # the profiler now and then records nothing
            ms = device_round()
            if ms is not None:
                device.append(ms)
                break
    del flush
    if on_device and not device:
        print("cold_times: the profiler gave no device time in three tries: not measured",
              flush=True)
    return min(per_call), min(device, default=None)


def time_ccl(gpu, name, mask, connectivity):
    """Per-call and device ms of the kernel, the plain body's ms and the
    bound."""
    from nellie_tpu_torch.kernels import ccl

    plain_ms = time_ms(lambda: ccl.union_find_roots_plain(mask, connectivity), 2)
    ms, on_device = kernel_times(lambda: ccl.CCL_KERNEL(mask, connectivity), 20)
    bound_ms, bound_by = ccl_bound(mask.numel())
    fg = float(mask.float().mean())
    print(f"ccl time at {name} {tuple(mask.shape)} {connectivity} ({fg:.4%} foreground): kernel "
          f"{ms:.4f} ms a call (on the device {fmt_ms(on_device)}), plain {plain_ms:.4f} "
          f"ms, library none, bound {bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.3f} "
          f"(on the device {fmt_share(bound_ms, on_device)}) [{gpu}]", flush=True)
    return {"shape": list(mask.shape), "foreground": fg, "ms": ms, "device_ms": on_device,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def fmt_share(bound_ms, ms):
    return "not measured" if ms is None else f"{bound_ms / ms:.4g}"


def ccl_rows(recorded, capacity_calls):
    """The union-find calls that phase 17 times, {row: (mask,
    connectivity)}: each main path's first call from Label's area filter,
    from Network and (3D) from Label's hole filling; capacity's first
    area-filter window, fill-holes cell and label cell."""
    rows = {}
    for path, calls in recorded.items():
        tags = ("label/remove_small_components", "network/label") + (
            ("label/fill_holes",) if path == "3D" else ())
        for tag in tags:
            first = next(((m, c) for t, (m, c) in calls if t == tag), None)
            if first is None:
                fail(f"the {path} main path made no union-find call from {tag}")
            rows[f"{path} {tag}"] = first
    for tag, name in (("capacity/remove_small_components", "window"),
                      ("capacity/fill_holes_cell", "fill holes cell"),
                      ("capacity/label_cell", "label cell")):
        first = next(((m, c) for t, (m, c) in capacity_calls if t == tag), None)
        if first is None:
            fail(f"the 1024^3 capacity run made no union-find call from {tag}")
        rows[f"capacity {name}"] = first
    return rows


def phase_ccl_kernel(gpu, recorded, capacity_calls):
    """The union-find kernel against its plain body on the card: the
    synthetic masks in 2D and 3D at both connectivities (component counts
    also held to ``scipy.ndimage.label``; the serpentine small, and large
    against scipy's roots), every mask the 3D and 2D main paths gave it,
    the capacity window and cells; then its times.  Returns (rows, max
    |kernel - plain| over every check)."""
    from nellie_tpu_torch.kernels import ccl

    worst = 0

    def check(mask, conn):
        nonlocal worst
        n, err = check_ccl(mask, conn)
        worst = max(worst, err)
        return n

    counts = {}
    for shape in (CCL_SHAPE_3D, CCL_SHAPE_2D):
        for name, mask in ccl_masks(shape).items():
            m = torch.from_numpy(mask).cuda()
            for conn in ("full", "faces"):
                n = check(m, conn)
                if n != len(scipy_roots(mask, conn)[1]):
                    fail(f"union-find {name} {shape} {conn}: {n} components, scipy disagrees")
                counts[f"{len(shape)}D {name} {conn}"] = n
    for shape in SERPENTINE_SHAPES:
        for conn in ("full", "faces"):
            counts[f"serpentine {shape} {conn}"] = check(
                torch.from_numpy(serpentine(shape)).cuda(), conn)
    print(f"ccl kernel = plain body on the card, exactly, at {CCL_SHAPE_3D} and {CCL_SHAPE_2D} "
          f"(the serpentine at {SERPENTINE_SHAPES}); components (= scipy): "
          f"{json.dumps(counts)}", flush=True)
    for shape in (CCL_SHAPE_3D, CCL_SHAPE_2D):
        mask = serpentine(shape)
        m = torch.from_numpy(mask).cuda()
        for conn in ("full", "faces"):
            want, _ = scipy_roots(mask, conn)
            if not np.array_equal(ccl.CCL_KERNEL(m, conn).cpu().numpy(), want):
                fail(f"union-find kernel on the serpentine {shape} {conn}: not scipy's roots")
        print(f"ccl kernel on the serpentine {shape} ({int(mask.sum())} voxels in one path): "
              f"roots = scipy's at both connectivities; "
              f"{time_ms(lambda: ccl.CCL_KERNEL(m, 'full'), 5):.4f} ms a call", flush=True)
    for path, calls in list(recorded.items()) + [("capacity", capacity_calls)]:
        for tag, (mask, conn) in calls:
            check(mask, conn)
        print(f"ccl kernel = plain body on the card on the {len(calls)} masks the {path} path "
              f"gave it: " + ", ".join(sorted({f'{t} {tuple(a[0].shape)}' for t, a in calls})),
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(17)
    sparse = torch.rand(CAPACITY_WINDOW, generator=gen, device="cuda") < 0.001
    dense = ~(torch.rand(CCL_SHAPE_3D, generator=gen, device="cuda") < 0.012)
    for conn in ("full", "faces"):
        check(sparse, conn)
        check(dense, conn)
    print(f"ccl kernel = plain body on a synthetic {CAPACITY_WINDOW} window at 0.1% foreground "
          f"and a {CCL_SHAPE_3D} background at 98.8%, both connectivities", flush=True)
    rows = {row: time_ccl(gpu, f"the {row} call", *args)
            for row, args in ccl_rows(recorded, capacity_calls).items()}
    return rows, worst


# ---------------------------------------------------------------------------
# phase 17: the cross-cell merge of capacity's chunked strategy
# ---------------------------------------------------------------------------

MERGE_SHAPES = {3: (20, 40, 48), 2: (40, 48)}
MERGE_CELLS = {3: 3, 2: 4}  # cells an axis of the grids the merge cases take
MERGE_REPS = 10


def merge_grid(shape, cells):
    """The cut positions of a grid of ``cells`` cells an axis."""
    return [tuple(int(round(d * i / cells)) for i in range(cells + 1)) for d in shape]


def merge_masks(ndim):
    """The cross-cell merge's masks at ``MERGE_SHAPES[ndim]`` by name, as
    numpy bool arrays, for the grid of ``MERGE_CELLS[ndim]`` cells an axis:
    random blobs; a lattice of lines every 7 voxels along each axis, one
    component through every cell; a closed shell whose hole crosses a
    boundary along every axis; pieces that touch only across a diagonal of
    a boundary (joined under full connectivity, apart under faces); and
    nothing."""
    from scipy import ndimage

    shape = MERGE_SHAPES[ndim]
    noise = ndimage.gaussian_filter(
        np.random.default_rng(1 if ndim == 3 else 3).normal(size=shape), 2.0)
    on_line = np.indices(shape) % 7 == 3
    lattice = np.zeros(shape, bool)
    for axis in range(ndim):
        lattice |= np.all(np.delete(on_line, axis, axis=0), axis=0)
    shell = np.zeros(shape, bool)
    diagonal = np.zeros(shape, bool)
    if ndim == 3:
        shell[4:11, 10:20, 12:24] = True
        shell[5:10, 11:19, 13:23] = False
        pairs = (((6, 5, 5), (7, 6, 6)), ((10, 30, 15), (11, 31, 16)),
                 ((2, 12, 40), (3, 13, 41)), ((15, 26, 30), (15, 27, 31)))
    else:
        shell[8:20, 10:22] = True
        shell[9:19, 11:21] = False
        pairs = (((9, 5), (10, 6)), ((30, 11), (31, 12)), ((25, 35), (26, 36)))
    for a, b in pairs:
        diagonal[a] = diagonal[b] = True
    return {"blobs": noise > 0.8 * noise.std(), "lattice": lattice, "shell": shell,
            "diagonal": diagonal, "empty": np.zeros(shape, bool)}


def cell_roots(mask, bounds, connectivity, invert=False):
    """The merge's input: the int32 roots of ``mask`` (of ``~mask`` with
    ``invert``) labelled cell by cell on the grid ``bounds`` by capacity's
    ``_cell_roots``, on the mask's device."""
    from nellie_tpu_torch.pipeline import capacity

    shape = tuple(mask.shape)
    roots = torch.empty(shape, dtype=torch.int32, device=mask.device)
    for origin, cshape in capacity._iter_cells(bounds):
        capacity._cell_roots(roots, mask, origin, cshape, shape, invert, connectivity)
    return roots


def merge_bound(before, after, bounds):
    """(bound_ms, "bytes") of one merge: the roots read once (4 bytes a
    voxel), the members whose root changed written once (4 bytes each) and
    the two planes of every boundary read once (4 bytes a voxel each), at
    the memory rate."""
    from nellie_tpu_torch.kernels import ccl

    n = before.numel()
    changed = int((before != after).sum())
    planes = sum(2 * (n // before.shape[axis]) for axis, _ in ccl.internal_planes(bounds))
    return 4 * (n + changed + planes) / HBM_BYTES_PER_S * 1e3, "bytes"


def check_merge(what, roots, bounds, connectivity, against_cpu=False):
    """The merge kernel on a copy of ``roots`` against its plain body on
    another, exactly (and on CPU copies with ``against_cpu``), with one
    wrapper call and its two CUDA kernels counted; returns (the kernel's
    output, max |kernel - plain|)."""
    from nellie_tpu_torch.kernels import ccl

    kernel = ccl.MERGE_KERNEL
    calls, launched = kernel.launches, kernel.kernel_launches
    got = kernel(roots.clone(), bounds, connectivity)
    if ccl.internal_planes(bounds) and (kernel.launches - calls,
                                        kernel.kernel_launches - launched) != (1, 2):
        fail(f"merge kernel on {what}: {kernel.launches - calls} calls and "
             f"{kernel.kernel_launches - launched} CUDA kernels counted, not 1 and 2")
    want = ccl.merge_cell_roots_plain(roots.clone(), bounds, connectivity)
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if got.dtype != torch.int32 or err:
        fail(f"merge kernel differs from its plain body on {what} in "
             f"{int((got != want).sum())} voxels")
    if against_cpu and not torch.equal(
            got.cpu(), ccl.merge_cell_roots_plain(roots.cpu(), bounds, connectivity)):
        fail(f"merge kernel on {what}: the card differs from the plain body on the CPU")
    return got, err


def time_merge(roots, bounds, connectivity, reps=MERGE_REPS):
    """(ms a call, ms on the device, the profiler's ms on the device or
    None) of the merge kernel, each call on a fresh copy of ``roots`` made
    before it (a volume of 4 bytes a voxel, which also pushes most of the
    roots out of the L2); the least of two rounds.  A call: CUDA events
    around it.  On the device: the same events with ``QUEUED_MS`` of work
    queued on the card ahead of the round, so that every copy and call is
    queued before the card reaches it and the events hold the two kernels
    alone.  The profiler: its times of the kernel's two kernels, kept only
    when it recorded exactly two a call (it misses some of the ctypes
    libraries' kernels)."""
    from torch.profiler import ProfilerActivity, profile

    from nellie_tpu_torch.kernels import ccl

    work = torch.empty_like(roots)

    def event_round(queued):
        pairs = []
        if queued:
            queue_sleep(QUEUED_MS)
        for _ in range(reps):
            work.copy_(roots)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ccl.MERGE_KERNEL(work, bounds, connectivity)
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps

    per_call, device, profiled = [], [], []
    for _ in range(2):
        per_call.append(event_round(False))
        device.append(event_round(True))
        for _ in range(3):  # the profiler now and then records nothing
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    work.copy_(roots)
                    ccl.MERGE_KERNEL(work, bounds, connectivity)
                torch.cuda.synchronize()
            events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and ("merge_kernel" in e.name or "flatten_kernel" in e.name)]
            if len(events) == 2 * reps:
                profiled.append(sum(e.device_time for e in events) / reps / 1e3)
                break
            print(f"time_merge: the profiler recorded {len(events)} of the {2 * reps} "
                  "merge and flatten kernels: not kept", flush=True)
    del work
    return min(per_call), min(device), min(profiled, default=None)


def host_merge_seconds(roots, bounds, connectivity):
    """Seconds of the host union-find that the kernel replaced
    (``mesh.cells._HostUnionFind`` over ``ccl.plane_pairs``) on the same
    roots: every boundary's two planes pulled to the host and their root
    pairs united."""
    from nellie_tpu_torch.kernels import ccl
    from nellie_tpu_torch.mesh import cells

    torch.cuda.synchronize()
    start = time.perf_counter()
    uf = cells._HostUnionFind()
    for axis, pos in ccl.internal_planes(bounds):
        left, right = roots.select(axis, pos - 1).cpu(), roots.select(axis, pos).cpu()
        uf.union_pairs(*(p.numpy() for p in ccl.plane_pairs(left, right, connectivity)))
    return time.perf_counter() - start


def phase_merge_kernel(gpu, volume):
    """The cross-cell merge kernel against its plain body on the card,
    exactly: ``merge_masks`` in 3D and 2D on their fine grids (full and
    faces connectivity, the latter also on the inverted masks, as hole
    filling takes them), also against CPU copies; then the 1024^3 capacity
    volume's two merges (label, full; hole filling, faces), recorded from a
    second run of the chunked strategy on ``volume``, with their times
    beside the plain body's, the host union-find's that the kernel replaced
    and the bound.  Returns (the rows, max |kernel - plain| over every
    check)."""
    from nellie_tpu_torch.kernels import ccl
    from nellie_tpu_torch.kernels.frangi import FrangiParams
    from nellie_tpu_torch.pipeline import capacity

    checked, worst = 0, 0
    for ndim in (3, 2):
        bounds = merge_grid(MERGE_SHAPES[ndim], MERGE_CELLS[ndim])
        for name, mask in merge_masks(ndim).items():
            m = torch.from_numpy(mask).cuda()
            for conn, invert in (("full", False), ("faces", False), ("faces", True)):
                what = f"{ndim}D {name} {conn}{' inverted' if invert else ''}"
                _, err = check_merge(what, cell_roots(m, bounds, conn, invert), bounds, conn,
                                     against_cpu=True)
                worst, checked = max(worst, err), checked + 1
    print(f"merge kernel = plain body on the card and on the CPU, exactly, on {checked} cases "
          f"({', '.join(merge_masks(3))}; 3D {MERGE_SHAPES[3]} on {MERGE_CELLS[3]} cells an "
          f"axis, 2D {MERGE_SHAPES[2]} on {MERGE_CELLS[2]}; full, faces, faces inverted)",
          flush=True)

    recorded = {}
    original = ccl.merge_cell_roots

    def recording(roots, bounds, connectivity="full"):
        recorded["label" if connectivity == "full" else "fill holes"] = (
            roots.clone(), bounds, connectivity)
        return original(roots, bounds, connectivity)

    params = FrangiParams(sigmas=CAPACITY_SIGMAS, spacing=(1.0, 1.0, 1.0), z_ratio=1.0)
    ccl.merge_cell_roots = recording
    try:
        capacity.segment_volume(volume, params, emit="sparse_labels", device="cuda")
    finally:
        ccl.merge_cell_roots = original
    rows = {}
    for name in ("label", "fill holes"):
        roots, bounds, conn = recorded.pop(name)
        got, err = check_merge(f"the capacity {name} merge", roots, bounds, conn)
        worst = max(worst, err)
        bound_ms, bound_by = merge_bound(roots, got, bounds)
        changed = int((roots != got).sum())
        del got
        ms, on_device, profiled = time_merge(roots, bounds, conn)
        work = roots.clone()
        wait_ms = host_wait_ms(lambda: ccl.MERGE_KERNEL(work.copy_(roots), bounds, conn))
        if wait_ms >= QUEUED_MS / 2:
            fail(f"the merge kernel at the capacity {name} merge waited {wait_ms:.1f} ms on "
                 f"{QUEUED_MS} ms of work queued on the card: a host read")
        plain_ms = time_ms(lambda: ccl.merge_cell_roots_plain(work.copy_(roots), bounds, conn), 1)
        host_s = host_merge_seconds(roots, bounds, conn)
        planes = ccl.internal_planes(bounds)
        del work, roots
        rows[f"capacity {name}"] = {
            "shape": list(volume.shape), "connectivity": conn, "planes": len(planes),
            "changed": changed, "ms": ms, "device_ms": on_device, "profiler_ms": profiled,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "host_wait_ms": wait_ms, "host_union_find_ms": host_s * 1e3}
        print(f"merge time at the capacity {name} merge {tuple(volume.shape)} {conn} "
              f"({len(planes)} boundaries, {changed} roots changed): kernel {ms:.4f} ms a call "
              f"(on the device {on_device:.4f} ms by events with work queued ahead, "
              f"{fmt_ms(profiled)} by the profiler), plain {plain_ms:.4f} ms (the copy of the "
              f"input included), the host union-find it replaced {host_s * 1e3:.1f} ms, library "
              f"none, bound {bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.3f} (on the "
              f"device {bound_ms / on_device:.3f}); 1 call and 2 CUDA kernels a merge; "
              f"{wait_ms:.2f} ms of host time with {QUEUED_MS} ms queued on the card, so no "
              f"host read [{gpu}]", flush=True)
        torch.cuda.empty_cache()
    return rows, worst


def interp_bound(q, f, max_distance):
    """(bound_ms, bound_by) of one interpolation call: operations, every
    (query, row) pair's squared norm (3d - 1 flops) and, for each pair
    inside the radius (counted on these inputs), its weight, normalisation
    and dot (2d + 6 flops), at the fp32 peak; bytes, the queries and rows
    read once and the output written once, at the memory rate."""
    from nellie_tpu_torch.stages import flow_interpolation as fi

    thresh = fi.radius_threshold(max_distance)
    (n_q, d), n_m = q.shape, f.shape[0]
    inside = 0
    for s in range(0, n_q, 2048):
        diff = q[s:s + 2048, None, :] - f[None]
        inside += int(((diff * diff).sum(-1) <= thresh).sum())
    ops_ms = (n_q * n_m * (3 * d - 1) + inside * (2 * d + 6)) / FP32_FLOPS * 1e3
    bytes_ms = 4 * (2 * n_q * d + n_m * (2 * d + 1)) / HBM_BYTES_PER_S * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")), inside


def interp_overflows(query, anchors, max_distance):
    """How many queries have more than ``INTERP_LIST_LEN`` rows inside the
    radius (the kernel's three-pass path), counted with its rounding
    (d0*d0, then exact fused multiply-adds) on the tensors' device."""
    from nellie_tpu_torch.kernels._fp import fma_plain
    from nellie_tpu_torch.stages.flow_interpolation import radius_threshold

    q, f = (torch.as_tensor(a) for a in (query, anchors))
    thresh = radius_threshold(max_distance)
    count = 0
    for s in range(0, q.shape[0], 1024):
        diff = q[s:s + 1024, None, :] - f[None]
        acc = diff[..., 0] * diff[..., 0]
        for k in range(1, diff.shape[-1]):
            acc = fma_plain(diff[..., k], diff[..., k], acc)
        count += int(((acc <= thresh).sum(dim=1) > INTERP_LIST_LEN).sum())
    return count


def check_interp(name, args, against_cpu=False):
    """The kernel against the plain body on the card (and on CPU copies):
    bit for bit, NaN where it has NaN; no row may differ.  Returns
    (differing rows, max |difference|)."""
    from nellie_tpu_torch.stages import flow_interpolation as fi

    got = fi.FLOW_INTERP_KERNEL(*args).cpu().numpy()
    wants = [fi._interp_all_plain(*args).cpu().numpy()]
    if against_cpu:
        wants.append(fi._interp_all_plain(*[a.cpu() if isinstance(a, torch.Tensor) else a
                                            for a in args]).numpy())
    rows = set()
    max_abs = 0.0
    for want in wants:
        same = same_bits(got, want)
        rows |= set(np.flatnonzero(~same.all(axis=1)).tolist())
        both = ~np.isnan(got) & ~np.isnan(want)
        max_abs = max(max_abs, float(np.abs(got[both].astype(np.float64) - want[both]).max(
            initial=0.0)))
    if rows:
        fail(f"flow interpolation kernel: {len(rows)} rows differ from the plain body on {name}")
    return len(rows), max_abs


def time_interp(gpu, name, args):
    """Per-call and device ms of the kernel, the plain body's ms and the
    bound."""
    from nellie_tpu_torch.stages import flow_interpolation as fi

    q, f = args[0], args[1]
    plain_ms = time_ms(lambda: fi._interp_all_plain(*args), 2)
    ms, on_device = kernel_times(lambda: fi.FLOW_INTERP_KERNEL(*args), 10)
    (bound_ms, bound_by), inside = interp_bound(q, f, args[4])
    overflow = interp_overflows(q, f, args[4])
    print(f"flow_interp time at {name} Q={q.shape[0]} M={f.shape[0]} d={q.shape[1]} "
          f"({inside} query-row pairs in the radius, {overflow} queries over the list): kernel "
          f"{ms:.4f} ms a call (on the device {fmt_ms(on_device)}), plain {plain_ms:.4f} "
          f"ms, library none, bound {bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.3f} "
          f"(on the device {fmt_share(bound_ms, on_device)}) [{gpu}]", flush=True)
    return {"shape": [q.shape[0], f.shape[0], q.shape[1]], "ms": ms, "device_ms": on_device,
            "overflowing_queries": overflow,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def interp_rows(recorded):
    """The interpolation calls that phase 17 times, {row: args}: each main
    path's first call from the reassigner and from the Hierarchy."""
    rows = {}
    for path, calls in recorded.items():
        for tag in ("reassign", "hierarchy"):
            first = next((a for t, a in calls if t == tag), None)
            if first is None:
                fail(f"the {path} main path made no interpolation call from {tag}")
            rows[f"{path} {tag}"] = first
    return rows


def phase_interp_kernel(gpu, recorded):
    """The interpolation kernel against its plain body on the card and on
    CPU copies (synthetic inputs: M < 32, 32 < M <= 1024, M > 1024, d = 2
    and 3, queries on an anchor, with an empty radius and NaN), then on
    every call the 3D and 2D main paths made; then its times."""
    differ, max_abs, cases, overflows = 0, 0.0, [], 0
    for d in (2, 3):
        for n_m, radius in ((20, None), (700, None), (3000, None), (3000, 3.0),
                            (INTERP_TILED_ROWS, None)):
            inputs = interp_inputs(4096, n_m, d, seed=n_m + d)
            radius = inputs[4] if radius is None else radius
            args = tuple(torch.from_numpy(a).cuda() for a in inputs[:4]) + (radius,)
            n, err = check_interp(f"synthetic M={n_m} d={d} radius {radius}", args,
                                  against_cpu=n_m <= 3000)
            over = interp_overflows(inputs[0], inputs[1], radius)
            differ, max_abs, overflows = differ + n, max(max_abs, err), overflows + over
            cases.append(f"M={n_m} d={d} radius {radius}: {over} over the list")
    if not overflows:
        fail("no synthetic interpolation query overflowed its list")
    print(f"flow_interp kernel on synthetic inputs ({'; '.join(cases)}; Q=4096 with 512 on an "
          f"anchor, 512 with an empty radius, 512 NaN; M={INTERP_TILED_ROWS} streams through "
          f"shared tiles): rows differing from the plain body on the card or the CPU {differ}",
          flush=True)
    for path, calls in recorded.items():
        n_rows = 0
        for tag, args in calls:
            n, err = check_interp(f"the {path} path's {tag} call", args)
            differ, max_abs = differ + n, max(max_abs, err)
            n_rows += args[0].shape[0]
        print(f"flow_interp kernel on the {len(calls)} calls of the {path} main path "
              f"({n_rows} queries; M per call "
              f"{sorted({int(a[1].shape[0]) for _, a in calls})}): rows differing from the plain "
              f"body so far {differ}", flush=True)
    rows = {row: time_interp(gpu, f"the {row} call", args)
            for row, args in interp_rows(recorded).items()}
    print(f"flow_interp: rows differing from the plain body in all {differ}, max |difference| "
          f"{max_abs:.3g}", flush=True)
    return rows, differ, max_abs


def fma_bound(args, n):
    """(bound_ms, "bytes"): every element of storage that a tensor operand
    reads, read once however many operands view it (views of one storage,
    broadcasting), and the n float32 results written once."""
    touched = {}
    for a in args:
        if isinstance(a, torch.Tensor) and a.numel():
            storage = a.untyped_storage()
            key = storage.data_ptr()
            if key not in touched:
                touched[key] = torch.zeros(storage.nbytes() // a.element_size(),
                                           dtype=torch.bool, device=a.device)
            touched[key].as_strided(a.shape, a.stride(), a.storage_offset()).fill_(True)
    read = sum(4 * int(flags.sum()) for flags in touched.values())
    return (read + 4 * n) / HBM_BYTES_PER_S * 1e3, "bytes"


def check_fma(name, args):
    """The kernel against its plain version on the card and on CPU copies,
    bit for bit (NaN where NaN); returns max |kernel - plain| over the
    finite results."""
    from nellie_tpu_torch.kernels import _fp

    got = _fp.FMA_KERNEL(*args).cpu().numpy()
    worst = 0.0
    for want in (_fp.fma_plain(*args),
                 _fp.fma_plain(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))):
        want = want.cpu().numpy()
        if got.shape != want.shape or not same_bits(got, want).all():
            fail(f"fma_f32 differs from its plain version on {name}")
        both = np.isfinite(got) & np.isfinite(want)
        worst = max(worst, float(np.abs(got[both].astype(np.float64) - want[both]).max(
            initial=0.0)))
    return worst


def phase_fma_kernel(gpu, largest):
    """The fused multiply-add kernel against its plain version (round to
    odd in float64 torch) on the card and on CPU copies, bit for bit (NaN
    where NaN): ``fma_operands`` and the constructed double-rounding cases,
    narrowed views along every axis, numbers, 0-dim tensors and
    broadcasting, and the largest call of each path on its own operands;
    then its time at those calls beside the plain version's, one PyTorch
    call's (``torch.addcmul``, numbers as 0-dim tensors: two roundings;
    the port never calls it) and its bound, each call on a
    cold L2 cache (:func:`cold_times`).  Returns (rows, max |kernel -
    plain| over every check)."""
    from nellie_tpu_torch.kernels import _fp

    ops = [torch.from_numpy(x).cuda() for x in fma_operands(1 << 22, seed=3)]
    tie = [torch.tensor(np.float32(v), device="cuda") for v in (1 + 2 ** -12, 1 + 2 ** -12,
                                                                   2 ** -60)]
    x = torch.randn((64, 256, 256), device="cuda")
    y = torch.randn((256, 1), device="cuda")
    cases = [("operands", ops), ("double-rounding tie", tie),
             ("numbers and broadcasting", [x, y, 0.3]), ("0-dim", [x, tie[0], tie[2]]),
             ("number first", [0.1, x, y])]
    cases += [(f"views along axis {axis}", [x.narrow(axis, 1, 60), 0.25, x.narrow(axis, 0, 60)])
              for axis in range(3)]
    worst = max(check_fma(name, args) for name, args in cases)
    if float(_fp.FMA_KERNEL(*tie)).hex() != "0x1.0020020000000p+0":
        fail("fma_f32 does not round a*b + c once on the double-rounding tie")
    print(f"fma_f32 = plain version (round to odd) bit for bit on the card and on CPU copies: "
          f"{', '.join(n for n, _ in cases)} ({ops[0].numel()} operand triples)", flush=True)
    rows = {}
    for path, (n, args) in largest.items():
        if args is None:
            fail(f"the {path} path made no fma_f32 call")
        worst = max(worst, check_fma(f"the {path} path's largest call", args))
        plain_ms, _ = cold_times(lambda: _fp.fma_plain(*args), 5, on_device=False)
        ms, on_device = cold_times(lambda: _fp.FMA_KERNEL(*args), 20)
        # the numbers as 0-d float32 tensors on the card
        a, b, c = (v if isinstance(v, torch.Tensor) else
                   torch.tensor(np.float32(v), device="cuda") for v in args)
        library_ms = cold_times(lambda: torch.addcmul(c, a, b), 20, on_device=False)[0]
        bound_ms, bound_by = fma_bound(args, n)
        print(f"fma_f32 = plain version bit for bit, and its time, at the {path} path's "
              f"largest call ({n} elements, operand shapes "
              f"{[tuple(a.shape) if isinstance(a, torch.Tensor) else 'number' for a in args]}, "
              f"strides {[a.stride() if isinstance(a, torch.Tensor) else None for a in args]}): "
              f"kernel {ms:.4f} ms a call on a cold L2 (on the device {fmt_ms(on_device)}), "
              f"plain {plain_ms:.4f} ms, library (addcmul) {fmt_ms(library_ms)}, bound "
              f"{bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.3f} (on the device "
              f"{fmt_share(bound_ms, on_device)}) [{gpu}]", flush=True)
        rows[path] = {"elements": n, "ms": ms, "device_ms": on_device, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
    return rows, worst


def chain_sources(steps):
    return [x for _, _, *args in steps for x in args if isinstance(x, torch.Tensor)]


def chain_bound(steps, n):
    """(bound_ms, "bytes"): :func:`fma_bound`'s rule for a chain: every
    element of storage that its tensor sources read, once however many
    sources view it, and the n float32 results written once."""
    return fma_bound(chain_sources(steps), n)


def chain_kind(steps):
    """Which of fma_f32.cu's chain kernels runs ``steps``."""
    from nellie_tpu_torch.kernels import _fp

    program, tensors = _fp._chain_program(steps)
    prog = [(dst, op, [x if isinstance(x, (torch.Tensor, _fp.Reg)) else _fp.f32(x)
                       for x in args]) for dst, op, *args in steps]
    shape = torch.broadcast_shapes(*(t.shape for t in tensors))
    kind = list(_fp._chain_layout(prog, shape, max(shape.numel(), 1))[0])[-1]
    return {_fp.KIND_GENERAL: "general", _fp.KIND_ACCUMULATE: "accumulate",
            _fp.KIND_LOG: "log", _fp.KIND_EXP: "exp", _fp.KIND_LANES: "lanes"}[kind]


def check_chain(name, steps):
    """The chain kernel (one launch) against its plain version
    (``_fp.run_steps``: ``fma_plain`` and float32 products and sums) on the
    card and on CPU copies, bit for bit (NaN where NaN); returns max
    |kernel - plain| over the finite results."""
    from nellie_tpu_torch.kernels import _fp

    before = _fp.FMA_CHAIN_KERNEL.launches
    got = _fp.FMA_CHAIN_KERNEL(steps)
    if _fp.FMA_CHAIN_KERNEL.launches != before + 1:
        fail(f"the chain on {name} was not one launch")
    got = got.cpu().numpy()
    cpu = [(d, op, *(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
           for d, op, *args in steps]
    worst = 0.0
    for want in (_fp.run_steps(steps), _fp.run_steps(cpu)):
        want = want.cpu().numpy()
        if got.shape != want.shape or not same_bits(got, want).all():
            fail(f"the fma chain differs from its plain version on {name}")
        both = np.isfinite(got) & np.isfinite(want)
        worst = max(worst, float(np.abs(got[both].astype(np.float64) - want[both]).max(
            initial=0.0)))
    return worst


def phase_chain_kernel(gpu, largest):
    """The multiply-add chain (``fma_f32.cu``'s ``fma_chain``) against its
    plain version, bit for bit on the card and on CPU copies: the log and
    exp polynomials, sums of products and of squares, the dot product's
    lanes, a program of 16 steps, broadcast and strided views (each of the
    kernel's forms: compiled in full, accumulating, general), then the
    largest chain of each path on its own sources, timed on a cold L2
    beside the plain version, one ``torch.addcmul`` over as many elements
    (a yardstick: no one PyTorch call computes a chain) and the bound.
    ``largest``: {path: (elements, (steps, the caller's program)) or (0,
    None)}.  Returns (rows, max |kernel - plain|)."""
    from nellie_tpu_torch.kernels import _fp
    from nellie_tpu_torch.kernels._fp import ADD, FMA, MUL, R0, R1, R2, R3

    a, b, c = (torch.from_numpy(x).cuda() for x in fma_operands(1 << 22, seed=5))
    e = torch.round(torch.nan_to_num(b, nan=3.0, posinf=60.0, neginf=-60.0).clamp(-60, 60))
    m = a[:4_000_000].reshape(2000, 2000)
    d3 = torch.stack([a, b, c], dim=-1)
    x4 = torch.nn.functional.pad(m[:, :13], (0, 3)).reshape(2000, 4, 4)
    w4 = b[:64].reshape(4, 4, 4)
    cases = {
        "log polynomial": _fp._log_polynomial(a, e),
        "exp polynomial": _fp._exp_polynomial(a, e),
        "sum of three products": [(R0, MUL, b, c), (R0, FMA, a, b, R0), (R0, FMA, c, a, R0)],
        "sum of squares of strided views": [(R0, MUL, d3[..., 0], d3[..., 0]),
                                            (R0, FMA, d3[..., 1], d3[..., 1], R0),
                                            (R0, FMA, d3[..., 2], d3[..., 2], R0)],
        "dot product lanes": [(R0, MUL, x4[:, 0, :, None], w4[0])]
        + [(R0, FMA, x4[:, i, :, None], w4[i], R0) for i in range(1, 4)],
        "lane sum": _fp._lane_sum(*(m[:, k:k + 500] for k in (0, 500, 1000, 1500))),
        "sixteen steps": [(R0, MUL, a, b)] + [(R0 if i % 2 else R1, FMA, (a, b, c)[i % 3],
                                              R0, float(i)) for i in range(15)],
        "views and registers": [(R0, MUL, m[:, 0:50], m[:, 1:51]),
                                (R0, FMA, m[:, 2:52], m[:, 3:53], R0),
                                (R2, ADD, m.t()[:50].t(), R0), (R3, FMA, -1.5, R2, R0),
                                (R0, ADD, R3, R3)],
        "misaligned and broadcast": [(R0, FMA, a[1:1 << 20], b[3:(1 << 20) + 2], 0.25),
                                     (R1, MUL, torch.tensor(0.5, device="cuda"), R0),
                                     (R0, FMA, R1, c[2:(1 << 20) + 1], R0)],
    }
    worst, kinds = 0.0, {}
    for name, steps in cases.items():
        worst = max(worst, check_chain(name, steps))
        kinds[name] = chain_kind(steps)
    print(f"fma chain = plain version bit for bit on the card and on CPU copies: "
          f"{json.dumps(kinds)}", flush=True)
    rows = {}
    for path, (n, recorded) in largest.items():
        if recorded is None:
            fail(f"the {path} path made no fma chain call")
        steps, program = recorded
        worst = max(worst, check_chain(f"the {path} path's largest chain", steps))
        plain_ms, _ = cold_times(lambda: _fp.run_steps(steps), 3, on_device=False)
        # as its caller called it: with the program it passed (a template's
        # is read once, the general chain's each call)
        ms, on_device = cold_times(lambda: _fp.FMA_CHAIN_KERNEL(steps, program), 20)
        t = torch.rand(n, device="cuda")
        one, half = (torch.tensor(np.float32(v), device="cuda") for v in (1.5, 0.5))
        addcmul_ms = cold_times(lambda: torch.addcmul(half, t, one), 20, on_device=False)[0]
        bound_ms, bound_by = chain_bound(steps, n)
        sources = chain_sources(steps)
        print(f"fma chain = plain version bit for bit, and its time, at the {path} path's "
              f"largest chain ({n} elements, {len(steps)} steps, {chain_kind(steps)} kernel, "
              f"{len({id(x) for x in sources})} tensor sources of shapes "
              f"{sorted({tuple(x.shape) for x in sources})}): kernel {ms:.4f} ms a call on a cold "
              f"L2 (on the device {fmt_ms(on_device)}), plain {plain_ms:.4f} ms, one addcmul over "
              f"as many elements {addcmul_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"share {bound_ms / ms:.3f} (on the device {fmt_share(bound_ms, on_device)}) "
              f"[{gpu}]", flush=True)
        rows[path] = {"elements": n, "steps": len(steps), "kind": chain_kind(steps), "ms": ms,
                      "device_ms": on_device, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": None, "addcmul_ms": addcmul_ms}
        del t
    return rows, worst


# (float32, float64) operations a voxel of the Frangi tail's passes in the
# plain version's arithmetic (hessian.py, eigen.py, frangi.py; a fused
# multiply-add counts two, a division or a root one), counted one for one
# from csrc/frangi_tail.cu, which repeats it: pass 1 the first derivatives
# and the components (18 in 3D), the flushed sums of squares and the root
# (13) and the largest |component| (11); pass 2 the components again, the
# eigenvalues (the scaling, the trigonometric method's 145 float32
# operations with nine divisions and fdlibm's acos, and glibc's two cosines
# reduced and summed in float64, 44), three exps and the response (118),
# and the carry's maximum
TAIL_OPS = {("hessian_frob", 3): (42, 0), ("hessian_frob", 2): (22, 0),
            ("frangi_response", 3): (282, 44), ("frangi_response", 2): (102, 0)}
MAIN_FRANGI = {3: dict(sigmas=(0.625, 0.8333, 1.0417, 1.25), spacing=(0.5, 0.2, 0.2),
                       z_ratio=2.5),
               2: dict(sigmas=(1.25, 1.6667, 2.0833, 2.5, 2.9167), spacing=(0.1, 0.1))}


def gauss_bound(x_numel):
    """(bound_ms, "bytes"): the input read once and the float32 output
    written once, 8 bytes a voxel at the memory rate."""
    return 8 * x_numel / HBM_BYTES_PER_S * 1e3, "bytes"


def max_abs_diff(got, want):
    """max |got - want| in float64 over the elements finite in both (0 for
    booleans that are equal, 1 where they differ)."""
    a, b = got.double().cpu(), want.double().cpu()
    both = torch.isfinite(a) & torch.isfinite(b)
    return float((a[both] - b[both]).abs().max()) if bool(both.any()) else 0.0


def same_tensor(got, want):
    """Equal dtype and shape, and equal bits (NaN where NaN)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype == torch.bool:
        return torch.equal(got.cpu(), want.cpu())
    return bool(same_bits(got.float().cpu().numpy(), want.float().cpu().numpy()).all())


def gauss_plain(which, x, args):
    """What the wrapper ``filters.<which>`` computes, by the plain version:
    ``correlate1d_traced_plain`` (weights, axis, carry: the result rounded
    to the carry) or ``_correlate1d_plain`` (weights, axis)."""
    from nellie_tpu_torch.kernels import filters

    if which == "_correlate1d":
        args = [a.to(x.device) if isinstance(a, torch.Tensor) else a for a in args]
        return filters._correlate1d_plain(x, *args)
    weights, axis, carry = args
    out = filters.correlate1d_traced_plain(x, weights, axis)
    return out.to(carry).float() if carry == torch.float16 else out


def check_gauss(name, which, x, args, against_cpu=False):
    """The wrapper ``filters.<which>`` on the card (one launch of the
    kernel) against the plain version with the caller's own arguments, on
    the card (and on CPU copies), bit for bit; returns max |kernel - plain|."""
    from nellie_tpu_torch.kernels import filters

    before = filters.GAUSS_AXIS_KERNEL.launches
    got = getattr(filters, which)(x, *args)
    if filters.GAUSS_AXIS_KERNEL.launches != before + 1:
        fail(f"filters.{which} on {name} did not launch gauss_axis once")
    worst = 0.0
    for dev in ["cuda"] + (["cpu"] if against_cpu else []):
        want = gauss_plain(which, x.to(dev), args)
        if not same_tensor(got, want):
            fail(f"gauss_axis ({which}) differs from its plain version on {name} ({dev})")
        worst = max(worst, max_abs_diff(got, want))
    return worst


def gauss_instance_weights(seed=0):
    """Seeded nonzero weights of every tap count that has its own kernel
    instance (``filters.GAUSS_UNROLLED_COUNTS``), then lists that take the
    run-time loop: 19 and 1 taps, and 9 taps with a zero inside (the
    nonzero offsets are then not -r..r)."""
    from nellie_tpu_torch.kernels import filters

    rng = np.random.default_rng(seed)
    out = [rng.uniform(0.05, 1.0, c) * rng.choice([-1.0, 1.0], c)
           for c in filters.GAUSS_UNROLLED_COUNTS + (19, 1, 9)]
    out[-1][3] = 0.0
    return out


def print_gauss_taps(what, hist):
    """``gauss_axis``'s launches on a path by tap count
    (``KernelCalls.gauss_taps``), with the instance each took."""
    parts = [f"{count} taps{'' if tight else ' (not -r..r)'} x{n} "
             f"({f'unrolled {instance}' if instance else 'run-time loop'})"
             for (count, tight, instance), n in sorted(hist.items())]
    print(f"{what}: gauss_axis launches by tap count: {', '.join(parts)}", flush=True)


def check_gauss_instances(hists):
    """Holds the kernel's unrolled counts to the paths' traffic
    (``hists``: {path: ``KernelCalls.gauss_taps``}): every launch of 3 or
    more taps at -r..r took the instance of its own count, every other
    launch the run-time loop, and every unrolled count was launched on
    some path."""
    from nellie_tpu_torch.kernels import filters

    unrolled = set(filters.GAUSS_UNROLLED_COUNTS)
    seen = set()
    for path, hist in hists.items():
        for (count, tight, instance), n in hist.items():
            should = tight and count >= 3
            if should:
                seen.add(count)
            if instance != (count if should and count in unrolled else 0):
                took = f"the {instance}-tap instance" if instance else "the run-time loop"
                fail(f"gauss_axis on the {path} path: {n} launches of {count} taps (-r..r "
                     f"{tight}) took {took}; the unrolled counts are {sorted(unrolled)}")
    if seen != unrolled:
        fail(f"gauss_axis unrolls {sorted(unrolled)} taps, the paths launch -r..r lists of "
             f"{sorted(seen)} (missing {sorted(seen - unrolled)}, unused "
             f"{sorted(unrolled - seen)})")
    print(f"gauss_axis: every -r..r tap list of the {', '.join(hists)} paths took the "
          f"unrolled instance of its count, and every unrolled count ({sorted(unrolled)}) "
          "was launched", flush=True)


def host_to_device_copies(fn):
    """The host-to-device copies one call of ``fn`` makes, by
    ``torch.profiler`` (after one call outside it)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if "HtoD" in e.name)


def library_correlation(x, taps, axis):
    """One cuDNN convolution of the input padded beforehand (symmetric
    edges; the pad is outside the timed call): the same correlation, in
    cuDNN's order of summation.  The port never calls it."""
    from nellie_tpu_torch.kernels import filters

    radius = max(abs(o) for o, _ in taps)
    weights = [0.0] * (2 * radius + 1)
    for o, w in taps:
        weights[o + radius] = w
    xp = filters.pad_symmetric(x, axis, radius, radius)[None, None]
    shape = [1, 1] + [1] * x.ndim
    shape[2 + axis] = len(weights)
    kernel = torch.tensor(weights, dtype=torch.float32, device=x.device).reshape(shape)
    conv = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
            3: torch.nn.functional.conv3d}[x.ndim]
    return lambda: conv(xp, kernel)


def phase_gauss_kernel(gpu, largest, tap_hists):
    """The 1-D correlation kernel through its wrappers
    (``filters.correlate1d_traced``, ``filters._correlate1d``) against the
    plain versions on the card: the 3D and 2D main cascades' taps along
    every axis with both carries, the LoG's, one tap, an axis shorter than
    the taps (also on CPU copies); then the largest call of each wrapper on
    each path, on the caller's own arguments, bit for bit, with its times
    on a cold L2 cache.  ``largest``: {path: {wrapper: (voxels, (x on the
    host, arguments...)) or (0, None)}}; ``tap_hists``: {path:
    ``KernelCalls.gauss_taps``}, held by :func:`check_gauss_instances`.
    Returns (rows, max |kernel - plain| over every check)."""
    from nellie_tpu_torch.kernels import filters, frangi

    check_gauss_instances(tap_hists)
    check_host_waits()
    cases, worst = 0, 0.0
    for shape in ((12, 48, 48), CCL_SHAPE_3D, (7, 33, 128), CCL_SHAPE_2D, (3, 200)):
        x = torch.from_numpy(filter_frame(shape, seed=len(shape))).cuda()
        small = x.numel() <= 1 << 16
        params = frangi.FrangiParams(**MAIN_FRANGI[2 if x.ndim == 2 else 3]) \
            if x.ndim > 1 else None
        for axis in range(x.ndim):
            calls = [("correlate1d_traced", (w, axis, carry)) for w in
                     frangi._delta_kernels(params, x.ndim)[axis]
                     for carry in (torch.float32, torch.float16)]
            calls += [("_correlate1d", (filters.gaussian_kernel1d(s, 4.0, order=o), axis))
                      for s, o in ((1.0, 0), (1.0, 2), (2.5, 2))]
            calls += [("_correlate1d", (np.array([0.3]), axis))]
            calls += [("_correlate1d", (w, axis)) for w in gauss_instance_weights()]
            calls += [("correlate1d_traced", (w, axis, carry)) for w in gauss_instance_weights()
                      for carry in (torch.float32, torch.float16)]
            for which, args in calls:
                worst = max(worst, check_gauss(f"{shape} axis {axis}", which, x, args, small))
                cases += 1
    print(f"gauss_axis (through correlate1d_traced and _correlate1d) = plain version bit for bit "
          f"on {cases} synthetic calls (the main cascades' taps with both carries, the LoG's, "
          "one tap, an axis shorter than the taps, every tap count with its own instance and "
          "the run-time loop's; CPU copies too at the small shapes)", flush=True)
    rows = {}
    for path, calls in largest.items():
        for which, row in (("correlate1d_traced", path), ("_correlate1d", f"{path} LoG")):
            n, recorded = calls[which]
            if recorded is None:
                if which == "correlate1d_traced":
                    fail(f"the {path} path made no correlate1d_traced call")
                continue
            x, *args = recorded
            x = x.cuda()
            args = [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]
            err = check_gauss(f"the {path} path's largest {which} call", which, x, args)
            instance, copy_bytes = filters.GAUSS_AXIS_KERNEL.last_used
            worst = max(worst, err)
            wrapper = getattr(filters, which)
            plain_ms, _ = cold_times(lambda: gauss_plain(which, x, args), 3, on_device=False)
            ms, on_device = cold_times(lambda: wrapper(x, *args), 20)
            taps = (filters.nonzero_taps(args[0]) if which == "_correlate1d"
                    else filters.traced_taps(args[0]))
            library_ms, _ = cold_times(library_correlation(x, taps, args[1]), 20, on_device=False)
            uploads = host_to_device_copies(lambda: wrapper(x, *args))
            wait_ms = host_wait_ms(lambda: wrapper(x, *args))
            if uploads or wait_ms >= QUEUED_MS / 2:
                fail(f"gauss_axis ({which}) at the {path} path's largest call copied "
                     f"{uploads} times from the host a call, or waited on the card (it "
                     f"returned after {wait_ms:.3f} ms with {QUEUED_MS} ms queued)")
            bound_ms, bound_by = gauss_bound(n)
            half = len(args) > 2 and args[2] == torch.float16
            print(f"gauss_axis ({which}) = plain version bit for bit, and its time, at the "
                  f"{path} path's largest call ({tuple(x.shape)} along axis {args[1]}, "
                  f"{len(taps)} taps, float16 carry {half}; "
                  f"{f'the {instance}-tap unrolled' if instance else 'the run-time'} tap loop, "
                  f"{copy_bytes}-byte copies): kernel {ms:.4f} ms a call on a "
                  f"cold L2 (on the device {fmt_ms(on_device)}), plain {plain_ms:.4f} ms, "
                  f"library (cuDNN convolution of the padded input) {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.3f} (on the device "
                  f"{fmt_share(bound_ms, on_device)}), host-to-device copies a call {uploads}, "
                  f"returned after {wait_ms:.3f} ms with {QUEUED_MS} ms queued on the card "
                  f"[{gpu}]", flush=True)
            rows[row] = {"wrapper": which, "shape": list(x.shape), "axis": args[1],
                         "taps": len(taps), "instance": instance, "copy_bytes": copy_bytes,
                         "max_abs_err": err, "ms": ms, "host_ms_with_work_queued": wait_ms,
                         "device_ms": on_device, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": library_ms}
            del x
    return rows, worst


def tail_bound(name, g, carry_bytes, active=None):
    """(bound_ms, bound_by) of one pass over block ``g``: bytes at the
    memory rate, or ``TAIL_OPS`` operations a voxel, float32 at the fp32
    peak and float64 at the fp64 peak (the two pipes side by side: the
    larger), the larger.  Pass 1: the block read and the norm written, 8
    bytes a voxel.  Pass 2 does its work only at the ``active`` voxels of the
    Frobenius mask (all without one): the mask read and vessel read and
    written everywhere (1 + 2 x carry bytes), the block read (4) and the
    operations there, all_mask written (1) elsewhere."""
    n = g.numel()
    active = n if active is None else active
    f32_ops, f64_ops = TAIL_OPS[(name, g.ndim)]
    if name == "hessian_frob":
        nbytes, voxels = 8 * n, n
    else:
        nbytes, voxels = (1 + 2 * carry_bytes) * n + 4 * active + (n - active), active
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(f32_ops * voxels / FP32_FLOPS, f64_ops * voxels / FP64_FLOPS) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def tail_plain(name, g, args):
    """What the wrapper ``frangi.<name>`` computes, by the plain version,
    from the caller's own arguments: pass 1 ``hessian_frob_plain`` (spacing,
    frame shape, core) as (frob, largest); pass 2 (components, params,
    frame shape, mask, gamma_sq, vessel, all_mask) the components from
    ``hessian.hessian_unnormalized`` (with no mask, as the program without
    the Frobenius mask rounds them) and ``frangi_response_plain``."""
    from nellie_tpu_torch.kernels import frangi, hessian

    if name == "hessian_frob":
        _, frob, largest = frangi.hessian_frob_plain(g, *args)
        return frob, largest
    _, params, minor, mask, gamma_sq, vessel, all_mask = args
    h, _ = hessian.hessian_unnormalized(g, params.spacing, minor, masked=mask is not None)
    return frangi.frangi_response_plain(h, mask, gamma_sq, params, vessel, all_mask)


def tail_kernel(name, g, args, copy=True):
    """The wrapper ``frangi.<name>`` on the card: its outputs (pass 2 on
    copies of ``vessel`` and ``all_mask``, or in place)."""
    from nellie_tpu_torch.kernels import frangi

    if name == "hessian_frob":
        _, frob, largest = frangi.hessian_frob(g, *args)
        return frob, largest
    if copy:
        args = args[:5] + (args[5].clone(), args[6].clone())
    return frangi.frangi_response(g, *args)


def on_device_args(args, dev):
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args)


def check_tail(what, name, g, args, against_cpu=False):
    """One pass of the kernel through its wrapper (one launch) against the
    plain version with the same arguments on the card (and on CPU copies),
    bit for bit; returns max |kernel - plain| over its outputs."""
    from nellie_tpu_torch.kernels import frangi

    before = frangi.FRANGI_TAIL_KERNEL.launches
    got = tail_kernel(name, g, args)
    if frangi.FRANGI_TAIL_KERNEL.launches != before + 1:
        fail(f"frangi.{name} on {what} did not launch frangi_tail once")
    worst = 0.0
    for dev in ["cuda"] + (["cpu"] if against_cpu else []):
        want = tail_plain(name, g.to(dev), on_device_args(args, dev))
        for a, b in zip(got, want):
            if not same_tensor(a, b):
                fail(f"frangi_tail {name} differs from its plain version on {what} ({dev})")
            worst = max(worst, max_abs_diff(a, b))
    return worst


def synthetic_tail_args(g, params, minor, core, carry, mask_fraction=0.7, seed=0):
    """The wrappers' arguments on block ``g`` as ``vesselness_blocks`` gives
    them: (pass 1's, pass 2's), with a Frobenius mask of about
    ``mask_fraction`` true and a running vessel of small values."""
    gen = torch.Generator(device=g.device).manual_seed(seed)
    mask = torch.rand(g.shape, generator=gen, device=g.device) < mask_fraction
    vessel = (torch.rand(g.shape, generator=gen, device=g.device) * 0.01).to(carry)
    all_mask = torch.rand(g.shape, generator=gen, device=g.device) < 0.9
    gamma_sq = torch.tensor(np.float32(2.0 * 40.0 ** 2), device=g.device)
    return ((params.spacing, minor, core),
            (None, params, minor, mask, gamma_sq, vessel, all_mask))


def phase_tail_kernel(gpu, largest):
    """The Frangi tail's two passes through their wrappers
    (``frangi.hessian_frob``, ``frangi.frangi_response``) against the plain
    versions on the card: synthetic smoothed blocks in 3D and 2D at the main
    shapes, a last axis of 128, a core box, both carries, no mask, a dim
    block (also on CPU copies at the small shapes); then the largest call of
    each pass on each path, on the caller's own arguments (spacing, frame
    extent, core, params, mask), bit for bit, with their times on a cold L2
    cache.  ``largest``: {path: {pass: (voxels, (block on the host,
    arguments...))}}.  Returns (rows, max |kernel - plain| over every
    check)."""
    from nellie_tpu_torch.kernels import frangi

    cases, worst = 0, 0.0
    core = lambda v: v.narrow(0, 1, v.shape[0] - 2)  # noqa: E731
    for shape, scale in (((12, 48, 48), 1.0), ((12, 48, 48), 1e-19), ((7, 33, 128), 1.0),
                         (CCL_SHAPE_3D, 1.0), ((64, 128), 1.0), (CCL_SHAPE_2D, 1.0)):
        g = torch.from_numpy(filter_frame(shape, seed=sum(shape), smooth=True)
                             * np.float32(scale)).cuda()
        params = frangi.FrangiParams(**MAIN_FRANGI[g.ndim])
        small = g.numel() <= 1 << 16
        for carry in (torch.float32, torch.float16):
            # a block 128 wide of a frame that is not
            for minor in ((None, tuple(shape[:-1]) + (1,)) if shape[-1] == 128 else (None,)):
                one, two = synthetic_tail_args(g, params, minor, core, carry)
                no_mask = two[:3] + (None,) + two[4:]
                for name, args in (("hessian_frob", one), ("frangi_response", two),
                                   ("frangi_response", no_mask)):
                    worst = max(worst, check_tail(f"{shape} x {scale}", name, g, args, small))
                    cases += 1
    print(f"frangi_tail (through hessian_frob and frangi_response) = plain version bit for bit "
          f"on {cases} synthetic passes (3D and 2D, main shapes, a last axis of 128, a core box, "
          "both carries, no mask, a dim block; CPU copies too at the small shapes)", flush=True)
    rows = {}
    for path, calls in largest.items():
        row = {}
        for name in ("hessian_frob", "frangi_response"):
            n, recorded = calls[name]
            if recorded is None:
                fail(f"the {path} path made no frangi.{name} call")
            g, *args = recorded
            g, args = g.cuda(), on_device_args(tuple(args), "cuda")
            err = check_tail(f"the {path} path's largest call", name, g, args)
            worst = max(worst, err)
            plain_ms, _ = cold_times(lambda: tail_plain(name, g, args), 2, on_device=False)
            ms, on_device = cold_times(lambda: tail_kernel(name, g, args, copy=False), 10)
            active = carry_bytes = None
            if name == "frangi_response":
                carry_bytes = args[5].element_size()
                active = None if args[3] is None else int(args[3].sum())
            bound_ms, bound_by = tail_bound(name, g, carry_bytes, active)
            share_active = "" if active is None else f", {active / g.numel():.2%} in the mask"
            print(f"frangi_tail {name} = plain version bit for bit, and its time, at the {path} "
                  f"path's largest call ({tuple(g.shape)}{share_active}): kernel {ms:.4f} ms a "
                  f"call on a cold L2 (on the device {fmt_ms(on_device)}), plain "
                  f"{plain_ms:.4f} ms, library none, bound {bound_ms:.4f} ms ({bound_by}), "
                  f"share {bound_ms / ms:.3f} (on the device "
                  f"{fmt_share(bound_ms, on_device)}) [{gpu}]", flush=True)
            row[name] = {"shape": list(g.shape), "max_abs_err": err, "ms": ms,
                         "device_ms": on_device, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by}
            if active is not None:
                row[name]["mask_share"] = active / g.numel()
            del g, args
        both = lambda k: sum(r[k] for r in row.values())  # noqa: E731
        on_dev = [r["device_ms"] for r in row.values()]
        rows[path] = dict(row, max_abs_err=max(r["max_abs_err"] for r in row.values()),
                          ms=both("ms"), plain_ms=both("plain_ms"), bound_ms=both("bound_ms"),
                          device_ms=None if None in on_dev else sum(on_dev),
                          bound_by=max(row.values(), key=lambda r: r["bound_ms"])["bound_by"],
                          library_ms=None)
    return rows, worst


def thin_bound(n_voxels):
    """(bound_ms, "bytes") of one thinning: the mask read and the skeleton
    written once, one byte a voxel each, at the memory rate.  The state
    that the loop's phases touch between them (the foreground's list, the
    per-voxel byte buffers and the flags) stays in the L2 and is not
    counted."""
    return 2 * n_voxels / HBM_BYTES_PER_S * 1e3, "bytes"


def check_thin(what, mask, lut):
    """The kernel through ``skeleton.skeletonize_3d`` (one launch) against
    ``skeletonize_3d_plain`` on the card, exactly; returns (max |kernel -
    plain|, the kernel's (rounds, host reads, sweeps, kernels launched))."""
    from nellie_tpu_torch.kernels import skeleton

    kernel = skeleton.THIN26_KERNEL
    before, kernels_before = kernel.launches, kernel.kernel_launches
    got = skeleton.skeletonize_3d(mask, lut)
    stats = kernel.last_stats
    if kernel.launches != before + 1 or kernel.kernel_launches != kernels_before + stats[3]:
        fail(f"skeletonize_3d on {what} did not launch thin26 once, or miscounted its kernels")
    want = skeleton.skeletonize_3d_plain(mask, lut)
    if not same_tensor(got, want):
        fail(f"thin26 differs from its plain body on {what} in "
             f"{int((got.cpu() != want.cpu()).sum())} voxels")
    return max_abs_diff(got.int(), want.int()), stats


def phase_thin_kernel(gpu, largest):
    """The 3D thinning kernel through ``skeleton.skeletonize_3d`` against
    ``skeletonize_3d_plain`` on the card: ``thin_masks`` at three shapes
    (its rounds, host reads, sweeps and kernels launched also held to
    ``thin26_model``: one launch and one host read a call), then Network's largest call on the 3D path on its
    own mask and table, exactly, with its times on a cold L2 cache.  ``largest``: {path:
    (voxels, (mask on the host, table)) or (0, None)}.  Returns (rows, max
    |kernel - plain| over every check)."""
    from nellie_tpu_torch.kernels import skeleton
    from nellie_tpu_torch.kernels.simple_point import get_simple26_lut

    lut = skeleton.simple26_lut("cuda")
    table = get_simple26_lut()
    cases, worst = 0, 0.0
    for shape in ((10, 18, 20), (9, 17, 21), (3, 40, 33)):
        for name, m in thin_masks(shape, seed=sum(shape)).items():
            err, stats = check_thin(f"{name} {shape}", torch.from_numpy(m).cuda(), lut)
            _, want = thin26_model(m, table)
            if stats != want:
                fail(f"thin26 on {name} {shape}: rounds, reads, sweeps, kernels {stats}, the "
                     f"model's {want}")
            worst = max(worst, err)
            cases += 1
    print(f"thin26 (through skeletonize_3d) = plain body exactly on {cases} synthetic masks "
          "(tubes, blobs, a sheet, noise, a cross on every face, empty, full; rounds, host reads, "
          "sweeps and kernels launched as thin26_model's)", flush=True)
    rows = {}
    for path, (n, recorded) in largest.items():
        if recorded is None:
            fail(f"the {path} path made no skeletonize_3d call")
        mask, table_used = recorded
        mask, table_used = mask.cuda(), table_used.cuda()
        err, (rounds, reads, sweeps, kernels) = check_thin(f"the {path} path's largest call",
                                                           mask, table_used)
        worst = max(worst, err)
        n_list = int(mask.sum())
        plain_ms, _ = cold_times(lambda: skeleton.skeletonize_3d_plain(mask, table_used), 2,
                                 on_device=False)
        ms, on_device = cold_times(lambda: skeleton.skeletonize_3d(mask, table_used), 5)
        bound_ms, bound_by = thin_bound(n)
        print(f"thin26 = plain body exactly, and its time, at the {path} path's largest call "
              f"({tuple(mask.shape)}, {n_list} foreground voxels, {sweeps} sweeps, {rounds} "
              f"rounds, {reads} host reads, {kernels} CUDA kernels a call): kernel {ms:.4f} ms "
              f"a call on a cold L2 (on the device {fmt_ms(on_device)}), plain {plain_ms:.4f} ms, "
              f"library none, bound {bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.4g} "
              f"(on the device {fmt_share(bound_ms, on_device)}) [{gpu}]", flush=True)
        rows[path] = {"shape": list(mask.shape), "foreground": n_list, "sweeps": sweeps,
                      "rounds": rounds, "host_reads": reads, "kernels_a_call": kernels,
                      "max_abs_err": err, "ms": ms, "device_ms": on_device,
                      "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": None}
        del mask, table_used
    return rows, worst


def percentile_library(values, mask, q):
    """One PyTorch call that computes the percentile, as a function, or
    None when nothing is masked in: ``torch.quantile`` of ``values[mask]``
    (the selection, the mask's gather, made beforehand; the port never
    calls it)."""
    sel = values.reshape(-1)[mask.reshape(-1)].float()
    if sel.numel() == 0:
        return None
    level = torch.tensor(q / 100.0, device=sel.device)
    return lambda: torch.quantile(sel, level)


def cuda_kernels_a_call(fn):
    """The CUDA kernels one call of ``fn`` launches, by ``torch.profiler``
    (None when it records none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


# the last jnp kernels ported, by kernel: (module, wrapper, its plain body,
# the reference line it replaces, the paths that must call it)
LAST_KERNELS = {
    "thin2d": ("skeleton", "skeletonize_2d", "skeletonize_2d_plain",
               "nellie_tpu/kernels/skeleton.py:311", ("2D",)),
    "edt_minplus": ("edt", "distance_transform", "distance_transform_plain",
                    "nellie_tpu/kernels/edt.py:218", ("3D", "2D")),
    "masked_percentile": ("frangi", "masked_percentile_forms", "masked_percentile_plain",
                          "nellie_tpu/kernels/frangi.py:226", ("3D", "2D", "capacity_1024")),
    "hu_features": ("moments", "hu_features", "hu_features_plain",
                    "nellie_tpu/kernels/moments.py:25", ("3D", "2D")),
}
THIN2D_SHAPES = ((48, 64), (33, 47), (1, 12), (12, 1), (130, 257))


def thin2d_bound(mask):
    """(bound_ms, "bytes") of one 2D thinning: the mask read and the
    skeleton written once, a byte a pixel each (the list and the frames
    between the subiterations stay in the L2 and are not counted)."""
    return 2 * mask.numel() / HBM_BYTES_PER_S * 1e3, "bytes"


def edt_candidates(shape, radii):
    """The min-plus passes' window candidates: for each axis, each voxel's
    positions inside the axis within its half window."""
    numel, total = int(np.prod(shape)), 0
    for n, r in zip(shape, radii):
        i = np.arange(n)
        total += int((np.minimum(n - 1, i + r) - np.maximum(0, i - r) + 1).sum()) * (numel // n)
    return total


def edt_bound(mask, sampling=None, max_radius_px=None):
    """(bound_ms, bound_by) of one distance transform: the mask read (a
    byte a voxel) and the float32 distances written once at the memory
    rate, or the window candidates, an add and a minimum each, at the
    float32 rate: the larger."""
    from nellie_tpu_torch.kernels import edt

    shape = tuple(mask.shape)
    bytes_ms = 5 * mask.numel() / HBM_BYTES_PER_S * 1e3
    candidates = edt_candidates(shape, edt.window_radii(shape, max_radius_px))
    ops_ms = 2 * candidates / FP32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def percentile_bound(values, mask, q=None):
    """(bound_ms, "bytes") of one percentile: the values and the mask read
    and the two forms written once; a radix select's few operations a
    value are far below the float32 rate."""
    nbytes = values.numel() * values.element_size() + mask.numel() + 8
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def hu_bound(cubes, looped=False):
    """(bound_ms, "bytes") of one call of the log-Hu features: the ROIs read
    and the features written once (float32), at the memory rate; the
    projections' maxima and the moments' sums, a few operations a voxel,
    are far below the float32 rate."""
    n = cubes.shape[0]
    feats = 18 if cubes.dim() == 4 else 6
    return 4 * (cubes.numel() + n * feats) / HBM_BYTES_PER_S * 1e3, "bytes"


# (ROIs' shape, looped) of phase 17's synthetic log-Hu cases; "symmetric"
# is symmetric_hu_rois (an h4 that cancels to a subnormal)
HU_CASES = {"3D 16^3": ((64, 16, 16, 16), False), "3D 16^3 looped": ((64, 16, 16, 16), True),
            "2D 20^2": ((64, 20, 20), False), "2D 20^2 looped": ((64, 20, 20), True),
            "3D 13^3 looped": ((32, 13, 13, 13), True), "2D 7^2": ((32, 7, 7), False),
            "3D 5x9x6": ((16, 5, 9, 6), False), "3D 1^3": ((8, 1, 1, 1), True),
            "symmetric": ((64, 20, 20), True)}


def hu_rois(shape, seed=0):
    """Seeded ROIs of intensities of ``shape`` (N, ...), about 40 % zero
    voxels, the first two all zero."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1000, shape).astype(np.float32)
    x[rng.random(x.shape) < 0.4] = 0
    x[:2] = 0
    return x


def symmetric_hu_rois():
    """2D ROIs of 20 x 20, each the mirror of itself along the columns, one
    of whose h4 cancels to a subnormal in the looped program."""
    rng = np.random.default_rng(43)
    half = rng.uniform(0, 1000, (64, 20, 10)).astype(np.float32)
    half[rng.random(half.shape) < 0.5] = 0
    x = np.concatenate([half, half[:, :, ::-1]], axis=2)
    return x * rng.uniform(0.5, 1.5, (64, 1, 1)).astype(np.float32)


LAST_BOUNDS = {"thin2d": thin2d_bound, "edt_minplus": edt_bound,
               "masked_percentile": percentile_bound, "hu_features": hu_bound}


def check_last(kernel_name, what, args, against_cpu=False):
    """One call of the kernel's wrapper on CUDA ``args`` against its plain
    body on the card (and on CPU copies), bit for bit (NaN where NaN);
    fails unless it launched the kernel once and counted its CUDA kernels.
    Returns (max |kernel - plain|, the call's ``last_stats``)."""
    import importlib

    module_name, wrapper, plain_name, _, _ = LAST_KERNELS[kernel_name]
    module = importlib.import_module(f"nellie_tpu_torch.kernels.{module_name}")
    kernel = hand_counts()[kernel_name]
    before, kernels_before = kernel.launches, kernel.kernel_launches
    got = getattr(module, wrapper)(*args)
    stats = kernel.last_stats
    if kernel.launches != before + 1 or \
            kernel.kernel_launches != kernels_before + stats["cuda_kernels"]:
        fail(f"{wrapper} on {what} did not launch {kernel_name} once, or miscounted its kernels")
    plain = getattr(module, plain_name)
    wants = [plain(*args)]
    if against_cpu:
        wants.append(plain(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)))
    for want in wants:
        if not same_tensor(got.to(want.device), want):
            fail(f"{kernel_name} differs from its plain body on {what} ({want.device}): "
                 f"{max_abs_diff(got.float(), want.float())} at most")
    return max_abs_diff(got.float(), wants[0].float()), stats


def phase_last_kernels(gpu, largest, calls, launches):
    """The 2D thinning (``csrc/thin2d.cu``), the clamped EDT
    (``csrc/edt_minplus.cu``), the masked percentile's two forms
    (``csrc/masked_percentile.cu``) and the log-Hu features
    (``csrc/hu_features.cu``) against their plain bodies on the card, bit
    for bit: the synthetic cases (``thin2d_masks`` at ``THIN2D_SHAPES``,
    ``EDT_CASES``, ``PERCENTILE_CASES`` at each of ``PERCENTILE_QS``,
    ``HU_CASES``; also against CPU copies), then each path's largest
    call with the caller's own arguments, timed on a cold L2 (per call and
    on the device) beside the plain body and (the percentile)
    ``torch.quantile``, with the CUDA kernels a call (the kernel's count and
    the profiler's), its host reads (``host_reads`` and ``host_wait_ms``:
    none may wait on the card), its bound and the launches each path made.
    ``largest``: {path: {wrapper: (size, args on the host)}}; ``calls``:
    {path: {wrapper: calls}}; ``launches``: {path: {kernel: launches}}.
    Returns ({kernel: rows}, {kernel: max |kernel - plain|})."""
    import importlib

    errs = {k: 0.0 for k in LAST_KERNELS}
    rows = {k: {} for k in LAST_KERNELS}
    cases = 0
    for shape in THIN2D_SHAPES:
        for name, m in thin2d_masks(shape, seed=sum(shape)).items():
            err, _ = check_last("thin2d", f"{name} {shape}", (torch.from_numpy(m).cuda(),),
                                against_cpu=True)
            errs["thin2d"] = max(errs["thin2d"], err)
            cases += 1
    print(f"thin2d (through skeletonize_2d) = plain body exactly, on the card and on CPU "
          f"copies, on {cases} synthetic masks (tubes, blobs, one-pixel lines, a cross and a "
          f"block on the edges, noise, empty, full at {THIN2D_SHAPES})", flush=True)
    for k, (name, (_, sampling, radius, _)) in enumerate(EDT_CASES.items()):
        mask = torch.from_numpy(edt_case_mask(name, seed=k)).cuda()
        err, _ = check_last("edt_minplus", name, (mask, sampling, radius), against_cpu=True)
        errs["edt_minplus"] = max(errs["edt_minplus"], err)
    print(f"edt_minplus (through distance_transform) = plain body bit for bit, on the card and "
          f"on CPU copies, on {len(EDT_CASES)} cases: {', '.join(EDT_CASES)}", flush=True)
    for k, name in enumerate(PERCENTILE_CASES):
        values, mask = (torch.from_numpy(a).cuda() for a in percentile_inputs(name, seed=k))
        for q in PERCENTILE_QS:
            err, _ = check_last("masked_percentile", f"{name} at q {q}", (values, mask, q),
                                against_cpu=True)
            errs["masked_percentile"] = max(errs["masked_percentile"], err)
    print(f"masked_percentile (both forms) = plain body bit for bit (NaN where NaN), on the "
          f"card and on CPU "
          f"copies, on {len(PERCENTILE_CASES)} cases at q in {PERCENTILE_QS}: "
          f"{', '.join(PERCENTILE_CASES)}", flush=True)

    for k, (name, (shape, looped)) in enumerate(HU_CASES.items()):
        x = symmetric_hu_rois() if name == "symmetric" else hu_rois(shape, seed=k)
        err, _ = check_last("hu_features", name, (torch.from_numpy(x).cuda(), looped),
                            against_cpu=True)
        errs["hu_features"] = max(errs["hu_features"], err)
    print(f"hu_features = plain body bit for bit, on the card and on CPU copies, on "
          f"{len(HU_CASES)} cases: {', '.join(HU_CASES)}", flush=True)

    for kernel_name, (module_name, wrapper, plain_name, _, required) in LAST_KERNELS.items():
        module = importlib.import_module(f"nellie_tpu_torch.kernels.{module_name}")
        kernel = hand_counts()[kernel_name]
        plain = getattr(module, plain_name)
        for path, recorded in largest.items():
            n, host_args = recorded.get(wrapper, (0, None))
            if host_args is None:
                if path in required:
                    fail(f"the {path} path made no {wrapper} call")
                continue
            args = tuple(a.cuda() if isinstance(a, torch.Tensor) else a for a in host_args)
            err, stats = check_last(kernel_name, f"the {path} path's largest call", args)
            errs[kernel_name] = max(errs[kernel_name], err)
            fn = lambda: getattr(module, wrapper)(*args)  # noqa: E731
            profiled = cuda_kernels_a_call(fn)
            own = kernel.last_stats["cuda_kernels"]
            wait_ms = host_wait_ms(fn)
            _, reads = host_reads(fn)
            if reads or wait_ms >= QUEUED_MS / 2 or stats["host_reads"]:
                fail(f"{kernel_name} at the {path} path's largest call made {reads} host reads "
                     f"and returned after {wait_ms:.3f} ms with {QUEUED_MS} ms queued on the "
                     "card")
            plain_ms, plain_device = cold_times(lambda: plain(*args), 3)
            ms, on_device = cold_times(fn, 10)
            bound_ms, bound_by = LAST_BOUNDS[kernel_name](*args)
            library = percentile_library(*args) if kernel_name == "masked_percentile" else None
            library_ms = None if library is None else cold_times(library, 5,
                                                                 on_device=False)[0]
            shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
            n_calls = calls[path].get(wrapper, 0)
            print(f"{kernel_name} = plain body bit for bit, and its time, at the {path} path's "
                  f"largest {wrapper} call ({shapes}, "
                  f"{[a for a in args if not isinstance(a, torch.Tensor)]}, {n_calls} calls and "
                  f"{launches[path][kernel_name]} launches on the path): kernel {ms:.4f} ms a "
                  f"call on a cold L2 (on the device {fmt_ms(on_device)}), plain {plain_ms:.4f} "
                  f"ms (on the device {fmt_ms(plain_device)}), library "
                  f"{'none' if library is None else f'(torch.quantile of values[mask]) {library_ms:.4f} ms'}; "
                  f"{own} CUDA kernels a call by the kernel's count ({profiled} device events by "
                  f"the profiler), {reads} host reads (returned after {wait_ms:.3f} ms with "
                  f"{QUEUED_MS} ms queued); bound {bound_ms:.6f} ms ({bound_by}), share "
                  f"{bound_ms / ms:.4g} (on the device {fmt_share(bound_ms, on_device)}) [{gpu}]",
                  flush=True)
            rows[kernel_name][path] = {
                "shapes": shapes, "calls": n_calls, "launches": launches[path][kernel_name],
                "kernels_a_call": own, "device_events_a_call": profiled,
                "host_reads_a_call": reads, "host_ms_with_work_queued": wait_ms,
                "max_abs_err": err, "ms": ms, "device_ms": on_device, "plain_ms": plain_ms,
                "plain_device_ms": plain_device, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}
            del args

    # one design serves every window: each path's largest EDT call again at a
    # clamp that neither path uses
    from nellie_tpu_torch.kernels import edt

    for path, recorded in largest.items():
        _, host_args = recorded.get("distance_transform", (0, None))
        if host_args is None:
            continue
        args = (host_args[0].cuda(), host_args[1], OTHER_EDT_CLAMP)
        what = f"the {path} path's largest call at clamp {OTHER_EDT_CLAMP}"
        err, _ = check_last("edt_minplus", what, args)
        errs["edt_minplus"] = max(errs["edt_minplus"], err)
        ms, on_device = cold_times(lambda: edt.distance_transform(*args), 10)
        plain_ms, plain_device = cold_times(lambda: edt.distance_transform_plain(*args), 3)
        bound_ms, bound_by = edt_bound(*args)
        print(f"edt_minplus = plain body bit for bit, and its time, at {what} "
              f"({tuple(args[0].shape)}): kernel {ms:.4f} ms a call on a cold L2 (on the device "
              f"{fmt_ms(on_device)}), plain {plain_ms:.4f} ms (on the device "
              f"{fmt_ms(plain_device)}); bound {bound_ms:.6f} ms ({bound_by}), share "
              f"{bound_ms / ms:.4g} (on the device {fmt_share(bound_ms, on_device)}) [{gpu}]",
              flush=True)
        rows["edt_minplus"][f"{path} clamp {OTHER_EDT_CLAMP}"] = {
            "shapes": [tuple(args[0].shape)], "max_abs_err": err, "ms": ms,
            "device_ms": on_device, "plain_ms": plain_ms, "plain_device_ms": plain_device,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        del args
    return rows, errs


OTHER_EDT_CLAMP = 15  # a clamp between the Markers' 11 (3D) and 21 (2D)


FINALIZE_CROSS_SHAPES = {3: (64, 128, 128), 2: (1024, 1024)}


def percentile_forms_of(sample: np.ndarray):
    """(A, B), the two forms of the 1st percentile of the positive values
    of ``sample`` (numpy float32)."""
    from nellie_tpu_torch.kernels import _fp

    s = np.sort(sample[sample > 0])
    pos = np.float32(0.01) * np.float32(s.size - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    frac = np.float32(pos - np.float32(lo))
    one = np.float32(1.0) - frac
    s_lo, s_hi, f, o = (torch.tensor(np.float32(v)) for v in (s[lo], s[hi], frac, one))
    return np.float32(_fp.fma(s_lo, o, s_hi * f)), np.float32(_fp.fma(s_hi, f, s_lo * o))


def opening_arms(ndim):
    """The centre, then ±1 along each axis (keys of the side terms)."""
    out = [((0,) * ndim, None)]
    for axis in range(ndim):
        for shift in (1, -1):
            out.append((tuple(shift if k == axis else 0 for k in range(ndim)), (axis, shift)))
    return out


def finalize_cross_frame(ndim: int, a_less: bool):
    """A frame of ``FINALIZE_CROSS_SHAPES[ndim]`` for the finalize's per-term
    rule: its strided sample (every second voxel on each axis) holds values
    in [5, 6), a fifth of them 0, whose 1st percentile's two forms differ
    (A < B when ``a_less``; seeds are searched in order), and crosses of
    the opening's 7 (5) voxels centred on odd voxels, which the sample never
    reads: all above both forms, all at A, all at B, and one for each term
    of the centre's erosion, whose single voxel read by that term is at
    max(A, B) and the others above both.  Returns (frame, A, B, {name: (centre,
    whether the opening keeps the cross under
    ``frangi.FINALIZE_FORMS``)})."""
    from nellie_tpu_torch.kernels import frangi, thresholds

    shape = FINALIZE_CROSS_SHAPES[ndim]
    assert thresholds.sample_strides(shape, int(1e6)) == (2,) * ndim
    seed = 0
    while True:
        rng = np.random.default_rng(seed)
        sample = rng.uniform(5, 6, tuple(s // 2 for s in shape)).astype(np.float32)
        sample[rng.random(sample.shape) < 0.2] = 0
        a, b = percentile_forms_of(sample)
        if a != b and (a < b) == a_less:
            break
        seed += 1
    frame = np.zeros(shape, np.float32)
    frame[tuple(slice(None, None, 2) for _ in shape)] = sample
    value = {frangi.A: a, frangi.B: b}
    centre_form, side_form = frangi.FINALIZE_FORMS[ndim]
    high = np.nextafter(max(a, b), np.float32(np.inf))
    # (name, the voxel at the odd value or None for all, that value)
    cases = [("all above both", None, high), ("all at A", None, a), ("all at B", None, b)]
    for offset, term in opening_arms(ndim):
        name = "centre" if term is None else f"arm {term[0]}{'+' if term[1] > 0 else '-'}"
        cases.append((f"{name} at max(A, B)", offset, max(a, b)))
    # centres on odd coordinates, 18 apart: no voxel of a cross is sampled
    centres = [c for c in np.ndindex(*[len(range(9, s - 8, 18)) for s in shape])]
    crosses = {}
    for (name, odd, v), index in zip(cases, centres):
        centre = tuple(9 + 18 * i for i in index)
        for offset, term in opening_arms(ndim):
            voxel = tuple(c + o for c, o in zip(centre, offset))
            frame[voxel] = v if odd is None or offset == odd else high
        if odd is None:
            kept = v > value[centre_form] and v > value[side_form]
        else:
            form = centre_form if not any(odd) else side_form
            kept = v > value[form]
        crosses[name] = (centre, bool(kept))
    return frame, a, b, crosses


def phase_percentile_band(gpu, frames):
    """The finalize's per-term rule (``frangi.FINALIZE_FORMS``) on every
    Filter frame of each main path (``finalize_frame``'s input, recorded):
    the percentile's two forms from the kernel against the plain body on a
    CPU copy, and the finalized frame on the card against the CPU's, bit
    for bit; with the voxels in the band min(A, B) < z <= max(A, B) and the
    voxels of the finalized frame that differ from a finalize comparing
    every term with A (the port's rule before the per-term table).
    ``frames``: {path: [(frame on the host, max_samples)]}.  Returns {path:
    row}."""
    from nellie_tpu_torch.kernels import filters, frangi, thresholds

    rows = {}
    for path, recorded in frames.items():
        band = differ = unequal = voxels = 0
        for host_frame, max_samples in recorded:
            frame = host_frame.cuda()
            got = frangi.finalize_frame(frame, max_samples)
            if not same_tensor(got, frangi.finalize_frame(host_frame, max_samples)):
                fail(f"the {path} path's finalize differs between the card and the CPU")
            sample = thresholds.downsample(
                frame, thresholds.sample_strides(tuple(frame.shape), max_samples))
            pos = sample > 0
            if not (bool(frame.sum() > 0) and bool(pos.any())):
                continue
            forms = frangi.masked_percentile_forms(sample, pos, 1.0)
            if not same_tensor(forms, frangi.masked_percentile_plain(sample.cpu(), pos.cpu(),
                                                                     1.0)):
                fail(f"the {path} path's percentile forms differ from the plain body")
            a, b = forms[frangi.A], forms[frangi.B]
            unequal += int(not same_tensor(a, b))
            band += int(((frame > torch.minimum(a, b)) & (frame <= torch.maximum(a, b))).sum())
            all_a = frame * filters.binary_opening(frame > a)
            differ += int((got != all_a).sum())
            voxels += frame.numel()
        print(f"the finalize's per-term rule on the {path} path's {len(recorded)} Filter frames "
              f"({voxels} voxels): card = CPU bit for bit; A != B on {unequal} frames, {band} "
              f"voxels in the band min(A, B) < z <= max(A, B), {differ} voxels of the finalized "
              f"frames differ from comparing every term with A [{gpu}]", flush=True)
        rows[path] = {"frames": len(recorded), "voxels": voxels, "frames_a_differs": unequal,
                      "band_voxels": band, "finalized_voxels_differing_from_all_a": differ}
    for ndim in (3, 2):
        for a_less in (True, False):
            frame, _, _, crosses = finalize_cross_frame(ndim, a_less)
            host = torch.from_numpy(frame)
            got = frangi.finalize_frame(host.cuda())
            if not same_tensor(got, frangi.finalize_frame(host)):
                fail(f"the finalize on the {ndim}D cross frame differs between card and CPU")
            wrong = [name for name, (centre, kept) in crosses.items()
                     if bool(got[centre] != 0) != kept]
            if wrong:
                fail(f"the finalize on the {ndim}D cross frame (A {'<' if a_less else '>'} B) "
                     f"kept or dropped against FINALIZE_FORMS: {wrong}")
    print(f"the finalize on the cross frames ({FINALIZE_CROSS_SHAPES}, A < B and A > B): card = "
          f"CPU bit for bit, every cross kept or dropped as FINALIZE_FORMS says", flush=True)
    return rows


QUEUED_MS = 50.0  # the work queued on the card before a call that host_wait_ms times


def queue_sleep(ms):
    """Queue about ``ms`` of work on the card: one ``torch.cuda._sleep``
    kernel, its cycles a millisecond measured first (the card idle)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    torch.cuda._sleep(int(10 ** 7 * ms / start.elapsed_time(end)))


def host_wait_ms(fn, queued_ms=QUEUED_MS):
    """The host's milliseconds in one call of ``fn`` made with about
    ``queued_ms`` of work queued on the card before it (one
    ``torch.cuda._sleep`` kernel, its cycles measured first), after one
    call outside it.  A call that reads anything back from the card, or
    waits on it, cannot return before that work ends; one that only queues
    work returns at once.  (``torch.profiler`` does not serve here: on the
    card it traced no kernel in some calls of the ctypes libraries.)"""
    fn()
    torch.cuda.synchronize()
    queue_sleep(queued_ms)
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return host_ms


def host_reads(fn):
    """(fn(), the synchronising calls PyTorch made on the card in it):
    ``torch.cuda.set_sync_debug_mode("warn")`` warns at each (a copy to the
    host, ``.item()``, ``bool()`` of a CUDA tensor, a ``nonzero``); those
    warnings are counted (not the notice that the mode is a prototype)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message) for w in caught)


def filter_host_reads(shape=MAIN_SHAPE):
    """The host reads of the Filter stage on the card over a main series
    of ``shape`` (one warm-up run first): its percentile's count, its
    writes to the host and (before the thresholds kept their results on
    the card) a read before each Frangi threshold."""
    from nellie_tpu_torch.io import ImInfo
    from nellie_tpu_torch.stages.filtering import Filter

    root = tempfile.mkdtemp(prefix="nellie_port_filter_reads_")
    try:
        reads = []
        for k in range(2):
            im_info = ImInfo(write_series(os.path.join(root, str(k)), shape))
            _, n = host_reads(lambda: Filter(im_info, device="cuda").run())
            reads.append(n)
        return reads[-1]
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_host_waits():
    """The host-wait test must see the wait of an ``.item()``."""
    ms = host_wait_ms(lambda: torch.ones(1, device="cuda").item())
    if ms < QUEUED_MS / 2:
        fail(f".item() returned in {ms:.3f} ms with {QUEUED_MS} ms queued on the card: the "
             "host-wait test cannot see a host read")
    return ms


def seed_bound(seeds, objects):
    """(bound_ms, "bytes") of one nearest seed: the seeds and the objects
    read and the labels (the seeds' type) and the float32 distances written
    once, at the memory rate.  The state that the passes touch between them
    (two int32 buffers) is not counted."""
    nbytes = seeds.numel() * (2 * seeds.element_size() + 4)
    if objects is not None:
        nbytes += objects.numel() * objects.element_size()
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def seed_work(seeds, objects, max_radius_px):
    """(the voxels that run, the CUDA kernels launched) of one nearest
    seed: the voxels outside object 0 when objects are given and no seed
    lies in object 0, else every voxel; one persistent kernel a call (its
    flags cleared by a memset beforehand, not counted)."""
    work = seeds.numel()
    if objects is not None and not bool(((seeds > 0) & (objects == 0)).any()):
        work = int((objects != 0).sum())
    return work, 1


def check_seed(what, args):
    """The kernel through ``edt.nearest_seed`` (one launch of
    ``seed_work``'s kernels, no ``fma_f32``) against ``nearest_seed_plain``
    on the card: labels exactly, distances bit for bit; returns max |kernel
    - plain| over the labels and the finite distances."""
    from nellie_tpu_torch.kernels import _fp, edt

    kernel = edt.NEAREST_SEED_KERNEL
    before, kernels_before = kernel.launches, kernel.kernel_launches
    fma = _fp.FMA_KERNEL.launches
    labels, dist = edt.nearest_seed(*args)
    _, kernels = seed_work(args[0], args[1], args[3] if len(args) > 3 else None)
    if (kernel.launches != before + 1 or _fp.FMA_KERNEL.launches != fma
            or kernel.kernel_launches != kernels_before + kernels
            or kernel.last_stats["cuda_kernels"] != kernels
            or kernel.last_stats["host_reads"] != 0):
        fail(f"nearest_seed on {what} did not launch its kernel once with {kernels} CUDA "
             f"kernels and no host read ({kernel.last_stats}), or launched fma_f32")
    want = edt.nearest_seed_plain(*args)
    if not (torch.equal(labels, want[0]) and same_tensor(dist, want[1])):
        fail(f"nearest_seed differs from its plain body on {what}")
    return max(max_abs_diff(labels, want[0]), max_abs_diff(dist, want[1]))


def phase_seed_kernel(gpu, largest):
    """The nearest-seed kernel through ``edt.nearest_seed`` against
    ``nearest_seed_plain`` on the card: ``seed_inputs`` in 3D and 2D with
    and without objects, ``max_radius_px`` set and unset, seeds in object 0;
    then Network's largest call on each main path on its own seeds,
    objects and sampling, with its times on a cold L2 cache.  ``largest``:
    {path: (voxels, (seeds, objects, sampling) on the host) or (0, None)}.
    Returns (rows, max |kernel - plain| over every check)."""
    from nellie_tpu_torch.kernels import edt

    cases, worst = 0, 0.0
    for shape, sampling in (((10, 24, 28), (0.5, 0.2, 0.2)), ((40, 44), (0.5, 0.2)),
                            ((64, 256, 256), (0.5, 0.2, 0.2))):
        seeds, objects = seed_inputs(shape, seed=len(shape), seed_fraction=0.01)
        in_zero = np.where((objects == 0) & (np.random.default_rng(1).random(shape) < 0.002),
                           9, seeds).astype(np.int32)
        for s, o in ((seeds, objects), (seeds, None), (in_zero, objects)):
            for radius in (None, 3):
                args = (torch.from_numpy(s).cuda(),
                        None if o is None else torch.from_numpy(o).cuda(), sampling, radius)
                worst = max(worst, check_seed(f"{shape} radius {radius}", args))
                cases += 1
    print(f"nearest_seed = plain body (labels exactly, distances bit for bit) on {cases} "
          "synthetic calls (3D and 2D, with and without objects, max_radius_px 3 and none, "
          "seeds in object 0)", flush=True)
    item_ms = check_host_waits()
    rows = {}
    for path, (_, recorded) in largest.items():
        if recorded is None:
            fail(f"the {path} path made no nearest_seed call")
        seeds, objects, *rest = recorded
        args = (seeds.cuda(), None if objects is None else objects.cuda(), *rest)
        err = check_seed(f"the {path} path's largest call", args)
        worst = max(worst, err)
        sampling = rest[0] if rest else None
        radius = rest[1] if len(rest) > 1 else None
        steps = edt.jump_steps(tuple(seeds.shape), radius)
        work, kernels = seed_work(seeds, objects, radius)
        stats = dict(edt.NEAREST_SEED_KERNEL.last_stats)
        wait_ms = host_wait_ms(lambda: edt.nearest_seed(*args))
        reads = int(wait_ms >= QUEUED_MS / 2)  # 1: at least one
        if reads != stats["host_reads"]:
            fail(f"nearest_seed at the {path} path's largest call returned after {wait_ms:.3f} "
                 f"ms with {QUEUED_MS} ms queued on the card (.item() {item_ms:.3f} ms): it "
                 f"waits on the card, the kernel counts {stats['host_reads']} host reads")
        plain_ms, _ = cold_times(lambda: edt.nearest_seed_plain(*args), 2, on_device=False)
        ms, on_device = cold_times(lambda: edt.nearest_seed(*args), 10)
        bound_ms, bound_by = seed_bound(seeds, objects)
        print(f"nearest_seed = plain body bit for bit, and its time, at the {path} path's "
              f"largest call ({tuple(seeds.shape)}, sampling {sampling}, {work} voxels run, "
              f"{len(steps)} steps; a call: {stats['cuda_kernels']} CUDA kernel and "
              f"{stats['host_reads']} host reads by the kernel's count, returned after "
              f"{wait_ms:.3f} ms with {QUEUED_MS} ms queued on the card (.item() "
              f"{item_ms:.3f} ms), so {reads} host reads; a grid of {stats['blocks']} "
              f"blocks): kernel {ms:.4f} ms a call "
              f"on a cold L2 (on the device {fmt_ms(on_device)}), plain {plain_ms:.4f} ms, "
              f"library none, bound {bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.4g} "
              f"(on the device {fmt_share(bound_ms, on_device)}) [{gpu}]", flush=True)
        rows[path] = {"shape": list(seeds.shape), "voxels_run": work, "steps": len(steps),
                      "kernels_a_call": kernels, "host_reads_a_call": reads,
                      "host_ms_with_work_queued": wait_ms,
                      "blocks": stats["blocks"],
                      "max_abs_err": err, "ms": ms, "device_ms": on_device,
                      "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": None}
        del args
    return rows, worst


# ---------------------------------------------------------------------------
# phase 17: tracking's pair sums and ROI statistics, the histogram thresholds
# ---------------------------------------------------------------------------

PAIR_WINDOW = 32  # XLA's CPU tree-reduction window, the level-1 window of both pair kernels
# synthetic pair-sum tiles: (n_post, n_pre, ndim, F, padded tile, max
# distance, shift of the later frame, kind of features): the 3D main path's
# one window level (F = 22), the 2D path's second general level over 4,096 x
# 4,096 (F = 10), the lanes of a padded 2,048 x 128 (8 lanes of 4 columns)
# and 2,048 x 256 (4 of 8), no gated pair, NaN and subnormal features, a
# window row whose gated terms are all +0 (pair_tile's kinds), and a tile
# whose 32 x 32 windows all hold real pairs (the final sum's staging past
# 48 KB of shared memory)
PAIR_CASES = {
    "3D 1024 tile": (338, 332, 3, 22, (1024, 1024), 1.0, 0.0, "normal"),
    "2D 4096 tile": (2196, 2195, 2, 10, (4096, 4096), 1.0, 0.0, "normal"),
    "lanes 2048x128": (1100, 70, 3, 22, (2048, 128), 1.0, 0.0, "normal"),
    "lanes 2048x256": (1100, 200, 2, 10, (2048, 256), 1.0, 0.0, "normal"),
    "no gated pair": (90, 70, 3, 22, (128, 128), 1e-6, 50.0, "normal"),
    "NaN features": (300, 280, 2, 10, (4096, 4096), 1.0, 0.0, "nan"),
    "subnormal features": (338, 332, 3, 22, (1024, 1024), 1.0, 0.0, "subnormal"),
    "+0 gated terms": (90, 70, 3, 22, (128, 128), 1.0, 0.0, "zero terms"),
    "3D 1024 tile, every window real": (1000, 990, 3, 22, (1024, 1024), 1.0, 0.0, "normal"),
}


def pair_tile(n_post, n_pre, ndim, n_feat, seed=0, shift=0.0, kind="normal"):
    """(coords_post, coords_pre, feats_post, feats_pre) float32 numpy
    arrays: earlier markers on a lattice of 0.5 / 0.2 um, later ones near
    them (moved by ``shift`` um), normal features.  ``kind``: "normal";
    "nan" (about 2 % of the features NaN on each side); "subnormal" (the
    features scaled by 2**-140, so that differences are subnormal and
    their squares +0); "zero terms" (earlier markers 2 um apart, and the
    first 40 later ones exact copies of earlier ones, coordinates and
    features, so that every gated pair of the first window row adds +0)."""
    rng = np.random.default_rng(seed)
    spacing = np.array([0.5, 0.2, 0.2][-ndim:])
    step = 10 if kind == "zero terms" else 1
    coords_pre = (rng.integers(0, 24, (n_pre, ndim)) * spacing * step).astype(np.float32)
    pick = rng.integers(0, n_pre, n_post)
    coords_post = (coords_pre[pick]
                   + rng.normal(0, 0.2, (n_post, ndim)) + shift).astype(np.float32)
    feats = [rng.normal(0, 1, (n, n_feat)).astype(np.float32) for n in (n_post, n_pre)]
    if kind == "nan":
        for f in feats:
            f[rng.random(f.shape) < 0.02] = np.nan
    elif kind == "subnormal":
        feats = [(f * np.float32(2.0 ** -140)).astype(np.float32) for f in feats]
    elif kind == "zero terms":
        copies = min(40, n_post)
        coords_post[:copies] = coords_pre[pick[:copies]]
        feats[0][:copies] = feats[1][pick[:copies]]
    return coords_post, coords_pre, feats[0], feats[1]


def pair_chain(padded):
    """The most dependent adds one of ``pair_sums.cu``'s sums can take: 1,024
    at level 1, each later level's window (1,024, or 32 / lanes rows of the
    columns and the halving of the lanes), then the window sums left (the
    kernel adds only the nonzero terms, so a sum's chain is shorter)."""
    w = PAIR_WINDOW
    rows, cols = padded[0] // w, padded[1] // w
    chain = w * w
    while rows > w or cols > w:
        lanes = {4: 8, 8: 4}.get(cols) if rows > w else None
        chain += (w // lanes * cols + lanes.bit_length() - 1) if lanes else w * w
        rows, cols = -(-rows // w), 1 if lanes else -(-cols // w)
    return chain + rows * cols


def gated_pairs(cp, cq, max_d):
    """The pairs the matcher gates: (i, j) index arrays, from the plain
    body's gate on ``cp``'s device."""
    from nellie_tpu_torch.kernels import matching

    _, mask = matching._pair_mask_and_dist(cp, cq, max_d)
    return torch.nonzero(mask, as_tuple=True)


def pair_gate_ops(ndim):
    """Float32 operations of one pair's gate: the differences, squares and
    adds, the root and the compare."""
    return 3 * ndim + 1


def pair_bound(args, gated):
    """(bound_ms, bound_by) of one pair sum: its inputs read and its sums
    written once at the memory rate, or its float32 operations at the
    float32 rate, the larger: every pair's gate, and for the ``gated``
    pairs only the normalised distance's division and, for the distance
    and each feature, a difference, an absolute value, a square and two
    adds (all that the function needs; the plain body also computes the
    ungated pairs' terms)."""
    cp, cq, fp, fq = args[:4]
    pairs, ndim, n_feat = cp.shape[0] * cq.shape[0], cp.shape[1], fp.shape[1]
    nbytes = 4 * (cp.numel() + cq.numel() + fp.numel() + fq.numel() + 2 * (n_feat + 1)) + 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (pairs * pair_gate_ops(ndim) + gated * (1 + 5 * (n_feat + 1))) / FP32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def exact_bits(got, want):
    """Equal dtype and shape and equal bits, NaN payloads included (two
    results of the same card)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    a, b = got.contiguous().cpu(), want.contiguous().cpu()
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def check_pair_sums(what, args, against_cpu=False):
    """The kernel through ``matching.pair_stats`` (one C call: a memset and
    at most two CUDA kernels, one more than one only where a later window
    level follows) against ``pair_stats_plain`` on the card, bit for bit
    with NaN bits, and on CPU copies (NaN as NaN): the count exactly, the
    sums bit for bit; returns (count, max |kernel - plain|)."""
    from nellie_tpu_torch.kernels import matching

    kernel = matching.PAIR_SUMS_KERNEL
    w = PAIR_WINDOW
    want_kernels = 1 + int(args[5][0] > w * w or args[5][1] > w * w)
    before, kernels = kernel.launches, kernel.kernel_launches
    got = matching.pair_stats(*args)
    if kernel.launches != before + 1 or kernel.kernel_launches != kernels + want_kernels:
        fail(f"pair_stats on {what} did not launch its kernel once with {want_kernels} CUDA "
             f"kernels ({kernel.kernel_launches - kernels} CUDA kernels)")
    if got[1].device.type != "cpu":
        fail(f"pair_stats on {what} returned its sums on {got[1].device}, not the host")
    worst = 0.0
    for where in ["cuda"] + (["cpu"] if against_cpu else []):
        want = matching.pair_stats_plain(*(a.to(where) if isinstance(a, torch.Tensor) else a
                                           for a in args))
        same = exact_bits if where == "cuda" else same_tensor
        if got[0] != want[0] or not (same(got[1], want[1]) and same(got[2], want[2])):
            fail(f"pair_stats differs from its plain body on {what} ({where}): counts "
                 f"{got[0]} and {want[0]}")
        worst = max(worst, max_abs_diff(got[1], want[1]), max_abs_diff(got[2], want[2]))
    return got[0], worst


# synthetic pair-cost tiles (pair_cost_inputs): the 3D and 2D main paths'
# shapes, then the minima's hard cases
PAIR_COST_CASES = ("3D 338x332", "2D 2196x2195", "ties", "lonely row and column",
                   "overflow", "NaN features", "zero signs", "no gated pair")


def pair_moments(cp, cq, fp, fq, max_d):
    """Float32 (mean, std) of the normalised distance and of each feature's
    |difference| over the pairs closer than ``max_d`` (float64 on the host,
    the std at least 1e-8); (0, 1) where no pair is that close."""
    d2 = ((cp[:, None, :].astype(np.float64) - cq[None, :, :]) ** 2).sum(-1)
    i, j = np.nonzero(d2 < float(max_d) ** 2)
    if len(i) == 0:
        return np.zeros(fp.shape[1] + 1, np.float32), np.ones(fp.shape[1] + 1, np.float32)
    terms = np.concatenate([np.sqrt(d2[i, j])[:, None] / max_d,
                            np.abs(fp[i].astype(np.float64) - fq[j])], axis=1)
    mean, std = np.nanmean(terms, 0), np.nanstd(terms, 0) + 1e-8
    return mean.astype(np.float32), std.astype(np.float32)


def pair_cost_inputs(name, seed=0):
    """(coords_post, coords_pre, feats_post, feats_pre, max_distance, mean,
    std, n_stats) as numpy arrays and numbers, for case ``name`` of
    ``PAIR_COST_CASES``: the main paths' shapes (3D 338 x 332, F = 22, 4
    statistics; 2D 2,196 x 2,195, F = 10) with their moments; ties across
    rows and columns (duplicated markers on both sides); a later and an
    earlier marker with no gated pair; costs that overflow (two features'
    std 1e-30, and both or one of them 1e30 in some later markers: rows of
    +inf, of NaN where +inf meets -inf, and of -inf); NaN features; costs of -0 and +0 that tie (earlier markers 2 um
    apart in duplicated pairs, later ones on them, features 0 or 2e-30
    against means of 1e-30 and a std of 3e38); no gated pair."""
    rng = np.random.default_rng(seed)
    ndim, n_feat, n_stats = (2, 10, 3) if name.startswith("2D") else (3, 22, 4)
    n_post, n_pre = {"3D 338x332": (338, 332), "2D 2196x2195": (2196, 2195)}.get(name,
                                                                                  (150, 140))
    kind = "nan" if name == "NaN features" else "normal"
    cp, cq, fp, fq = pair_tile(n_post, n_pre, ndim, n_feat, seed=seed,
                               shift=50.0 if name == "no gated pair" else 0.0, kind=kind)
    if name == "ties":
        cp[1::2], fp[1::2] = cp[0:-1:2], fp[0:-1:2]
        cq[1::2], fq[1::2] = cq[0:-1:2], fq[0:-1:2]
    elif name == "lonely row and column":
        cp[5], cq[7] = cp[5] + 100.0, cq[7] - 100.0
    elif name == "overflow":  # rows of +inf, of NaN (+inf and -inf) and of -inf
        kind_of_row = rng.random(n_post)
        fp[kind_of_row < 0.1, :2] = np.float32(1e30)
        fp[(kind_of_row >= 0.1) & (kind_of_row < 0.2), 0] = np.float32(1e30)
    elif name == "zero signs":
        sites = rng.permutation(12 ** ndim)[:n_pre // 2]
        grid = np.stack(np.unravel_index(sites, (12,) * ndim), axis=1) * 2.0
        cq = np.repeat(grid, 2, axis=0).astype(np.float32)
        cp = cq[rng.integers(0, len(cq), n_post)]
        fq = np.where(rng.random(fq.shape[:1] + (n_feat,)) < 0.95, 0.0,
                      2e-30).astype(np.float32)[:len(cq)]
        fp = np.zeros((n_post, n_feat), np.float32)
    mean, std = pair_moments(cp, cq, fp, fq, 1.0)
    if name == "overflow":
        std[1:3] = np.float32(1e-30)
    elif name == "zero signs":
        mean[:], std[:] = np.float32(1e-30), np.float32(3e38)
    return cp, cq, fp, fq, 1.0, mean, std, n_stats


def pair_costs_bound(args, gated):
    """(bound_ms, bound_by) of one ``pair_costs`` call: its inputs read and
    its minima and indices written once (4 + 8 bytes a row and column) at
    the memory rate, or its float32 operations at the float32 rate, the
    larger: every pair's gate, and for the ``gated`` pairs only the
    normalised distance, its z-score (a subtraction and a division) and,
    per feature, a difference, an absolute value, a subtraction, a
    division and a multiply-add (all that the function needs)."""
    cp, cq, fp, fq = args[:4]
    pairs, ndim, n_feat = cp.shape[0] * cq.shape[0], cp.shape[1], fp.shape[1]
    nbytes = 4 * (cp.numel() + cq.numel() + fp.numel() + fq.numel() + 2 * (n_feat + 1)) \
        + 12 * (cp.shape[0] + cq.shape[0])
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (pairs * pair_gate_ops(ndim) + gated * (3 + 5 * n_feat)) / FP32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def check_pair_costs(what, args, against_cpu=False):
    """The kernel through ``matching.pair_costs`` (one C call: a memset and
    one CUDA kernel, no host read) against ``pair_costs_plain`` on the
    card, bit for bit with NaN bits and the indices exactly, and on CPU
    copies (NaN as NaN); ``args`` the tile on the card, ``mean`` and
    ``std`` on the host.  Returns max |kernel - plain|."""
    from nellie_tpu_torch.kernels import matching

    kernel = matching.PAIR_COSTS_KERNEL
    before, kernels = kernel.launches, kernel.kernel_launches
    got = matching.pair_costs(*args)
    if kernel.launches != before + 1 or kernel.kernel_launches != kernels + 1:
        fail(f"pair_costs on {what} did not launch its kernel once with one CUDA kernel "
             f"({kernel.kernel_launches - kernels} CUDA kernels)")
    host = matching.to_host(got)
    worst = 0.0
    for where in ["cuda"] + (["cpu"] if against_cpu else []):
        want = matching.pair_costs_plain(*(a.to(where) if isinstance(a, torch.Tensor) else a
                                           for a in args))
        same = exact_bits if where == "cuda" else same_tensor
        for name, g, h, w_ in zip(("row minima", "row indices", "column minima",
                                   "column indices"), got, host, want):
            if not (same(g, w_) and same(h, w_.cpu())):
                fail(f"pair_costs differs from its plain body on {what} ({where}): {name}")
        worst = max(worst, max_abs_diff(got[0], want[0]), max_abs_diff(got[2], want[2]))
    return worst


def roi_inputs(shape, scale=500.0, fill=0.4, seed=0):
    """Float32 ROIs of ``shape`` (N, ...): uniform voxels up to ``scale``
    on a ``fill`` share of them, the first ROI empty."""
    rng = np.random.default_rng(seed)
    x = (rng.random(shape) * scale * (rng.random(shape) < fill)).astype(np.float32)
    x[0] = 0
    return x


def signed_rois(n=6, edge=17):
    """ROIs of edge^3 whose first 4,096 voxels cancel exactly to 0, then
    subnormal ones and a normal one: the second block of voxels starts
    from a zero sum."""
    rng = np.random.default_rng(6)
    v = edge ** 3
    x = np.zeros((n, v), np.float32)
    x[:, 10], x[:, 20] = 3.0, -3.0
    x[:, 4096:] = (rng.random((n, v - 4096)) * 1e-39).astype(np.float32)
    x[:, 4096 + 50] = 1.0
    return x.reshape((n,) + (edge,) * 3)


# synthetic ROI sets: (shape, scale, fill): the 3D main path's 16^3 ROIs and
# the 2D path's 20^2 (twice 338 markers), 20^3 (past one block of 4,096
# voxels), dim ROIs whose squares are subnormal, ROIs of voxels about the
# smallest normal float32 (the subnormal ones read as zero), ROIs of 17^3
# (every other one starts off 16 bytes; chunks of 1,024 and a short one),
# of 48^3 (442 KB each, past shared memory: 108 chunks), and ROI counts
# below the SMs (33, one a block) and above them (5,000 of 9^3, twelve a
# block, starting off 16 bytes)
ROI_CASES = {
    "3D 16^3": ((676, 16, 16, 16), 500.0, 0.4),
    "2D 20^2": ((676, 20, 20), 500.0, 0.4),
    "3D 20^3": ((64, 20, 20, 20), 500.0, 0.4),
    "dim": ((64, 12, 12, 12), 1e-20, 0.8),
    "subnormal voxels": ((64, 12, 12), 3e-38, 0.8),
    "17^3, misaligned": ((40, 17, 17, 17), 500.0, 0.4),
    "48^3, past shared memory": ((4, 48, 48, 48), 500.0, 0.4),
    "33 ROIs, below the SMs": ((33, 16, 16, 16), 500.0, 0.4),
    "5000 ROIs of 9^3, above the SMs": ((5000, 9, 9, 9), 500.0, 0.4),
}


def roi_bound(images):
    """(bound_ms, bound_by): the ROIs read and the (N, 2) float32 written
    once at the memory rate, or the float64 adds and squares (three a
    voxel) at the float64 rate, the larger."""
    n, voxels = images.shape[0], images[0].numel() if images.shape[0] else 0
    bytes_ms = (images.numel() * images.element_size() + 8 * n) / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * n * voxels / FP64_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def chain_floor_ms(images):
    """The device ms of ``roi_chain_floor`` on one ROI of ``images`` (the
    middle one): one thread's chain of the sum of squares alone, out of
    shared memory, on a cold L2 (``cold_times``); None where the ROI is
    larger than the entry point takes or the profiler recorded nothing."""
    from nellie_tpu_torch.kernels import moments

    roi = images[images.shape[0] // 2].float().contiguous()
    if roi.numel() > 12288:
        return None
    return cold_times(lambda: moments.ROI_STATS_KERNEL.chain_floor(roi), 10)[1]


def check_roi_stats(what, images, against_cpu=False):
    """The kernel through ``moments.masked_mean_variance`` (one CUDA kernel)
    against ``masked_mean_variance_plain`` on the card (and
    on CPU copies), bit for bit; returns max |kernel - plain|."""
    from nellie_tpu_torch.kernels import moments

    kernel = moments.ROI_STATS_KERNEL
    before, kernels = kernel.launches, kernel.kernel_launches
    got = moments.masked_mean_variance(images)
    if kernel.launches != before + 1 or kernel.kernel_launches != kernels + 1:
        fail(f"masked_mean_variance on {what} did not launch its kernel once with one CUDA "
             f"kernel ({kernel.kernel_launches - kernels} CUDA kernels)")
    worst = 0.0
    for where in ["cuda"] + (["cpu"] if against_cpu else []):
        want = moments.masked_mean_variance_plain(images.to(where))
        if not same_tensor(got, want.to(got.device)):
            fail(f"masked_mean_variance differs from its plain body on {what} ({where})")
        worst = max(worst, max_abs_diff(got, want))
    return worst


# synthetic threshold samples: (values, mask rule, nbins, size): skewed and
# bimodal, the triangle's peak near either end (both flips), Label's log10
# domain with no mask, an empty mask, every value equal (a span of 0), one
# masked value, every value in two bins, 100, 1,000 and 10,000 bins (past
# the kernel's shared-memory histogram), a frame's worth of values, and more
# values than 2^24 (the counts' float32 total rounds in XLA's order)
THRESHOLD_CASES = {
    "bimodal": ("bimodal", "random", 256, 4000),
    "peak low (flip)": ("peak_low", "random", 256, 4000),
    "peak high (no flip)": ("peak_high", "random", 256, 4000),
    "log, no mask": ("log", None, 256, 4000),
    "empty mask": ("bimodal", "none", 256, 4000),
    "span 0": ("equal", "random", 256, 4000),
    "one value": ("bimodal", "one", 256, 4000),
    "two bins": ("two_bins", "random", 256, 4000),
    "100 bins": ("bimodal", "random", 100, 4000),
    "1000 bins": ("peak_low", "random", 1000, 4000),
    "10000 bins": ("bimodal", "random", 10000, 40000),
    "64x256x256 values": ("peak_low", "random", 256, 64 * 256 * 256),
    "2^24 + 2^22 values": ("peak_low", None, 256, 2 ** 24 + 2 ** 22),
}

# the Filter's samples, stride_mask(shape, strides) & (frame > 0), on frames
# with non-positive voxels: (shape, stride, mask rule, nbins): the 3D
# frame's strides (2, 2, 2) at 64x256x256 and the capacity window's (4, 4,
# 4) at 266x272x384, and at small sizes whose value counts are not a
# multiple of 16: no positive voxel ("empty"), every value masked ("full":
# 4,194,304, past the kernel's record of 2^21), a NaN masked in ("nan"),
# 9,000 bins
STRIDE_THRESHOLD_CASES = {
    "3D frame, stride 2": ((64, 256, 256), 2, "positive", 256),
    "capacity window, stride 4": ((266, 272, 384), 4, "positive", 256),
    "stride 2, empty": ((15, 24, 41), 2, "empty", 256),
    "stride 4, full mask": ((25, 28, 43), 4, "full", 256),
    "64x256x256, full mask": ((64, 256, 256), 2, "full", 256),
    "stride 2, NaN": ((15, 24, 41), 2, "nan", 256),
    "stride 4, 9000 bins": ((25, 28, 43), 4, "positive", 9000),
}


def stride_threshold_inputs(shape, stride, rule, seed=0):
    """(frame float32, mask bool) numpy arrays of a Filter-like sample:
    normal values about 0.3 (a third not positive; none with "empty"),
    the mask the stride points that are positive, every value ("full"), or
    with a NaN masked in ("nan")."""
    rng = np.random.default_rng(seed + 200)
    v = rng.normal(0.3, 1.0, shape).astype(np.float32)
    if rule == "empty":
        v = -np.abs(v)
    m = np.zeros(shape, bool)
    m[tuple(slice(None, None, stride) for _ in shape)] = True
    m &= v > 0
    if rule == "full":
        m[:] = True
    if rule == "nan":
        v[2, 4, 6] = np.nan
        m[2, 4, 6] = True
    return v, m


def threshold_inputs(kind, rule, n, seed=0):
    """(values float32, mask bool or None) numpy arrays of ``n`` values."""
    rng = np.random.default_rng(seed)
    if kind == "bimodal":
        v = np.concatenate([rng.normal(1.0, 0.3, n - n // 3), rng.gamma(2.0, 2.0, n // 3)])
    elif kind == "peak_low":
        v = rng.gamma(1.5, 1.0, n)
    elif kind == "peak_high":
        v = 10.0 - rng.gamma(1.5, 1.0, n)
    elif kind == "log":
        v = np.log10(rng.gamma(2.0, 1e-3, n) + 1e-6)
    elif kind == "equal":
        v = np.full(n, 0.75)
    elif kind == "two_bins":
        v = np.where(rng.random(n) < 0.3, 2.0, 5.0)
    else:
        raise ValueError(kind)
    mask = None if rule is None else {"random": rng.random(n) < 0.8,
                                      "none": np.zeros(n, bool),
                                      "one": np.arange(n) == 17}[rule]
    return v.astype(np.float32), mask


THRESHOLD_FUNCTIONS = ("min_triangle_otsu", "otsu_threshold", "triangle_threshold",
                       "triangle_and_otsu")


def threshold_bound(values, mask):
    """(bound_ms, "bytes"): the least any implementation must move, at the
    memory rate: the mask's bytes, 4 bytes of each masked value (with no
    mask, every value) and the five results (17 bytes); a few operations a
    value are far below the float32 rate."""
    masked = values.numel() if mask is None else int(mask.sum())
    nbytes = (0 if mask is None else mask.numel()) + 4 * masked + 17
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def check_thresholds(what, values, mask, nbins=256, against_cpu=False):
    """The kernel against the plain bodies on the card (and on CPU copies),
    bit for bit: its five results from one call (two CUDA kernels), then
    each of the four public functions; returns max |kernel - plain|."""
    from nellie_tpu_torch.kernels import thresholds

    kernel = thresholds.HIST_THRESHOLD_KERNEL
    before, kernels = kernel.launches, kernel.kernel_launches
    otsu, criterion, tri, low, any_valid = kernel(values, mask, nbins)
    if kernel.launches != before + 1 or kernel.kernel_launches != kernels + 2:
        fail(f"the threshold kernel on {what} did not launch two CUDA kernels "
             f"({kernel.kernel_launches - kernels})")
    public = (*thresholds.otsu_threshold(values, mask, nbins),
              thresholds.triangle_threshold(values, mask, nbins),
              thresholds.min_triangle_otsu(values, mask, nbins))
    pair = thresholds.triangle_and_otsu(values, mask, nbins)
    if not (same_tensor(pair[0], public[2]) and same_tensor(pair[1], public[0])):
        fail(f"triangle_and_otsu on {what} differs from triangle_threshold and otsu_threshold")
    worst = 0.0
    for where in ["cuda"] + (["cpu"] if against_cpu else []):
        v, m = values.to(where), None if mask is None else mask.to(where)
        want = (*thresholds.otsu_threshold_plain(v, m, nbins),
                thresholds.triangle_threshold_plain(v, m, nbins),
                thresholds.min_triangle_otsu_plain(v, m, nbins))
        pair = thresholds.triangle_and_otsu_plain(v, m, nbins)
        if not (same_tensor(pair[0], want[2]) and same_tensor(pair[1], want[0])):
            fail(f"triangle_and_otsu_plain on {what} ({where}) differs from the single plain "
                 "bodies")
        for got in ((otsu, criterion, tri, low), public):
            for g, w, name in zip(got, want, ("Otsu", "criterion", "triangle", "minimum")):
                if not same_tensor(g, w.to(g.device)):
                    fail(f"the threshold kernel's {name} differs from the plain body on {what} "
                         f"({where}): {float(g)!r} and {float(w)!r}")
                worst = max(worst, max_abs_diff(g, w))
    valid = bool(values.numel() and (mask is None or mask.any()))
    if bool(any_valid) != valid:
        fail(f"the threshold kernel on {what}: any_valid {bool(any_valid)}, not {valid}")
    return worst


def library_histogram(values, mask, nbins):
    """One PyTorch call's histogram of values[mask] over their range
    (``torch.histc``; the range read once beforehand), as a function."""
    sel = values[mask]
    lo, hi = (float(sel.min()), float(sel.max())) if sel.numel() else (0.0, 1.0)
    return lambda: torch.histc(values[mask], nbins, lo, hi)


def phase_track_threshold_kernels(gpu, largest, calls):
    """Tracking's pair sums (``csrc/pair_sums.cu``) and ROI statistics
    (``csrc/roi_stats.cu``) and the histogram thresholds
    (``csrc/hist_threshold.cu``) against their plain bodies on the card,
    bit for bit: the synthetic cases (``PAIR_CASES``, ``ROI_CASES`` and
    signed ROIs, ``THRESHOLD_CASES``; the small ones also against CPU
    copies), then each path's largest call of ``pair_stats`` and
    ``masked_mean_variance`` (3D, 2D) and of each threshold function (3D,
    2D, capacity) on the caller's own arguments, timed on a cold L2 beside
    the plain bodies and (the histogram) ``torch.histc``, with the CUDA
    kernels a call (``torch.profiler``, and the kernels' own counts) and
    the calls each path made; a threshold call with 50 ms of work queued
    on the card must not wait for it.  ``largest``: {path: {wrapper:
    (size, args on the host)}}; ``calls``: {path: {wrapper: calls}}.
    Returns ({kernel: rows}, {kernel: max |kernel - plain|})."""
    from nellie_tpu_torch.kernels import matching, moments, thresholds

    errs = {"pair_sums": 0.0, "pair_costs": 0.0, "roi_stats": 0.0, "hist_threshold": 0.0}
    rows = {"pair_sums": {}, "pair_costs": {}, "roi_stats": {}, "hist_threshold": {}}
    for k, (name, (n_post, n_pre, ndim, n_feat, padded, max_d, shift, kind)) in enumerate(
            PAIR_CASES.items()):
        arrays = pair_tile(n_post, n_pre, ndim, n_feat, seed=k, shift=shift, kind=kind)
        args = (*(torch.from_numpy(a).cuda() for a in arrays), max_d, padded)
        count, err = check_pair_sums(name, args, against_cpu=n_post * n_pre < 10 ** 6)
        if (count == 0) != (name == "no gated pair"):
            fail(f"pair_stats on {name}: {count} gated pairs")
        errs["pair_sums"] = max(errs["pair_sums"], err)
    print(f"pair_stats = plain body (count exactly, sums bit for bit, NaN bits too) on "
          f"{len(PAIR_CASES)} synthetic tiles: {', '.join(PAIR_CASES)}", flush=True)
    for k, name in enumerate(PAIR_COST_CASES):
        cp, cq, fp, fq, max_d, mean, std, n_stats = pair_cost_inputs(name, seed=k)
        args = (*(torch.from_numpy(a).cuda() for a in (cp, cq, fp, fq)), max_d,
                torch.from_numpy(mean), torch.from_numpy(std), n_stats)
        errs["pair_costs"] = max(errs["pair_costs"],
                                 check_pair_costs(name, args, against_cpu=True))
    print(f"pair_costs = plain body (minima bit for bit, NaN bits and zero signs too, indices "
          f"exactly) on {len(PAIR_COST_CASES)} synthetic tiles: {', '.join(PAIR_COST_CASES)}",
          flush=True)
    for k, (name, (shape, scale, fill)) in enumerate(ROI_CASES.items()):
        images = torch.from_numpy(roi_inputs(shape, scale, fill, seed=k)).cuda()
        errs["roi_stats"] = max(errs["roi_stats"],
                                check_roi_stats(name, images, against_cpu=shape[0] <= 64))
    errs["roi_stats"] = max(errs["roi_stats"], check_roi_stats(
        "signed ROIs", torch.from_numpy(signed_rois()).cuda(), against_cpu=True))
    print(f"masked_mean_variance = plain body bit for bit on {len(ROI_CASES) + 1} synthetic "
          f"ROI sets: {', '.join(ROI_CASES)}, signed ROIs (each with an empty ROI)", flush=True)
    for k, (name, (kind, rule, nbins, n)) in enumerate(THRESHOLD_CASES.items()):
        v, m = threshold_inputs(kind, rule, n, seed=k)
        errs["hist_threshold"] = max(errs["hist_threshold"], check_thresholds(
            name, torch.from_numpy(v).cuda(), None if m is None else torch.from_numpy(m).cuda(),
            nbins, against_cpu=n < 10 ** 5))
    for k, (name, (shape, stride, rule, nbins)) in enumerate(STRIDE_THRESHOLD_CASES.items()):
        v, m = stride_threshold_inputs(shape, stride, rule, seed=k)
        errs["hist_threshold"] = max(errs["hist_threshold"], check_thresholds(
            name, torch.from_numpy(v).cuda(), torch.from_numpy(m).cuda(), nbins,
            against_cpu=v.size < 10 ** 5))
    print(f"the thresholds = plain bodies bit for bit on "
          f"{len(THRESHOLD_CASES) + len(STRIDE_THRESHOLD_CASES)} synthetic samples: "
          f"{', '.join([*THRESHOLD_CASES, *STRIDE_THRESHOLD_CASES])}", flush=True)
    item_ms = check_host_waits()

    def kernels_a_call(fn, kernel):
        """(device events by the profiler, CUDA kernels by the kernel's
        count) of one call."""
        profiled = cuda_kernels_a_call(fn)
        before = kernel.kernel_launches
        fn()
        return profiled, kernel.kernel_launches - before

    for path in ("3D", "2D"):
        recorded = largest[path]["pair_stats"][1]
        if recorded is None:
            fail(f"the {path} path made no pair_stats call")
        args = tuple(a.cuda() if isinstance(a, torch.Tensor) else a for a in recorded)
        count, err = check_pair_sums(f"the {path} path's largest call", args)
        errs["pair_sums"] = max(errs["pair_sums"], err)
        fn = lambda: matching.pair_stats(*args)  # noqa: E731
        profiled, own = kernels_a_call(fn, matching.PAIR_SUMS_KERNEL)
        wait_ms = host_wait_ms(fn)
        _, reads = host_reads(fn)
        if reads != 1 or wait_ms < QUEUED_MS / 2:
            fail(f"pair_stats at the {path} path's largest call made {reads} host reads and "
                 f"returned after {wait_ms:.3f} ms with {QUEUED_MS} ms queued on the card: it "
                 "reads its packed result once")
        plain_ms, _ = cold_times(lambda: matching.pair_stats_plain(*args), 2, on_device=False)
        ms, on_device = cold_times(fn, 10)
        bound_ms, bound_by = pair_bound(args, count)
        chain = pair_chain(args[5])
        shapes = [tuple(a.shape) for a in args[:4]]
        print(f"pair_sums = plain body bit for bit, and its time, at the {path} path's "
              f"largest call ({shapes}, padded tile {tuple(args[5])}, {count} gated pairs, "
              f"{calls[path]['pair_stats']} calls on the path): kernel {ms:.4f} ms a call on a "
              f"cold L2 (on the device {fmt_ms(on_device)}), plain {plain_ms:.4f} ms, library "
              f"none; {own} CUDA kernels a call by the kernel's count ({profiled} device events "
              f"by the profiler: a memset, the kernels and the result's copy), {reads} host "
              f"read (the packed count and sums, as the reference: returned after "
              f"{wait_ms:.3f} ms with {QUEUED_MS} ms queued); bound {bound_ms:.6f} ms "
              f"({bound_by}: every pair's gate, the gated pairs' terms), at most {chain} "
              f"dependent adds a sum [{gpu}]", flush=True)
        rows["pair_sums"][path] = {
            "shapes": shapes, "padded": list(args[5]), "gated_pairs": count,
            "calls": calls[path]["pair_stats"], "kernels_a_call": own,
            "device_events_a_call": profiled, "host_reads_a_call": reads,
            "host_ms_with_work_queued": wait_ms, "chain_adds_at_most": chain,
            "max_abs_err": err, "ms": ms, "device_ms": on_device, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        del args

        recorded = largest[path]["pair_costs"][1]
        if recorded is None:
            fail(f"the {path} path made no pair_costs call")
        args = tuple(a.cuda() if isinstance(a, torch.Tensor) and k < 4 else a
                     for k, a in enumerate(recorded))
        err = check_pair_costs(f"the {path} path's largest call", args)
        errs["pair_costs"] = max(errs["pair_costs"], err)
        fn = lambda: matching.pair_costs(*args)  # noqa: E731
        profiled, own = kernels_a_call(fn, matching.PAIR_COSTS_KERNEL)
        wait_ms = host_wait_ms(fn)
        _, reads = host_reads(fn)
        if reads or wait_ms >= QUEUED_MS / 2:
            fail(f"pair_costs at the {path} path's largest call made {reads} host reads and "
                 f"returned after {wait_ms:.3f} ms with {QUEUED_MS} ms queued on the card")
        plain_args = args[:5] + tuple(a.cuda() for a in args[5:7]) + args[7:]
        plain_ms, plain_device = cold_times(lambda: matching.pair_costs_plain(*plain_args), 3)
        plain_kernels = cuda_kernels_a_call(lambda: matching.pair_costs_plain(*plain_args))
        ms, on_device = cold_times(fn, 10)
        gated = int(gated_pairs(args[0], args[1], args[4])[0].numel())
        bound_ms, bound_by = pair_costs_bound(args, gated)
        # a frame pair's matching on these markers: two host reads
        n_stats = args[7]
        frame_pair = lambda: matching.match_frames_device(  # noqa: E731
            args[0], args[2], args[1], args[3], args[4], n_stats)
        _, pair_reads = host_reads(frame_pair)
        if pair_reads != 2:
            fail(f"match_frames_device on the {path} path's largest tile made {pair_reads} host "
                 "reads, not 2")
        shapes = [tuple(a.shape) for a in args[:4]]
        print(f"pair_costs = plain body bit for bit, and its time, at the {path} path's "
              f"largest call ({shapes}, {gated} gated pairs, {calls[path]['pair_costs']} calls "
              f"on the path): kernel {ms:.4f} ms a call on a cold L2 (on the device "
              f"{fmt_ms(on_device)}), plain {plain_ms:.4f} ms (on the device "
              f"{fmt_ms(plain_device)}, {plain_kernels} CUDA kernels a call), library none; "
              f"{own} CUDA kernel a call by the kernel's count ({profiled} device events by the "
              f"profiler, the memset among them), {reads} host reads (returned after "
              f"{wait_ms:.3f} ms with {QUEUED_MS} ms queued); bound {bound_ms:.6f} ms "
              f"({bound_by}: every pair's gate, the gated pairs' costs); match_frames_device "
              f"on this tile {pair_reads} host reads [{gpu}]", flush=True)
        rows["pair_costs"][path] = {
            "shapes": shapes, "gated_pairs": gated, "calls": calls[path]["pair_costs"],
            "kernels_a_call": own, "device_events_a_call": profiled,
            "host_reads_a_call": reads, "host_ms_with_work_queued": wait_ms,
            "plain_kernels_a_call": plain_kernels, "plain_device_ms": plain_device,
            "frame_pair_host_reads": pair_reads,
            "max_abs_err": err, "ms": ms, "device_ms": on_device, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        del args, plain_args

        recorded = largest[path]["masked_mean_variance"][1]
        if recorded is None:
            fail(f"the {path} path made no masked_mean_variance call")
        images = recorded[0].cuda()
        err = check_roi_stats(f"the {path} path's largest call", images)
        errs["roi_stats"] = max(errs["roi_stats"], err)
        fn = lambda: moments.masked_mean_variance(images)  # noqa: E731
        profiled, own = kernels_a_call(fn, moments.ROI_STATS_KERNEL)
        wait_ms = host_wait_ms(fn)
        reads = int(wait_ms >= QUEUED_MS / 2)
        if reads:
            fail(f"masked_mean_variance at the {path} path's largest call waited on the card "
                 f"({wait_ms:.3f} ms with {QUEUED_MS} ms queued)")
        plain_ms, _ = cold_times(lambda: moments.masked_mean_variance_plain(images), 2,
                                 on_device=False)
        ms, on_device = cold_times(fn, 10)
        bound_ms, bound_by = roi_bound(images)
        floor_ms = chain_floor_ms(images)
        print(f"roi_stats = plain body bit for bit, and its time, at the {path} path's largest "
              f"call ({tuple(images.shape)}, {calls[path]['masked_mean_variance']} calls on the "
              f"path): kernel {ms:.4f} ms a call on a cold L2 (on the device "
              f"{fmt_ms(on_device)}), plain {plain_ms:.4f} ms, library none; {own} CUDA kernel "
              f"a call by the kernel's count ({profiled} by the profiler), {reads} host reads "
              f"(returned after {wait_ms:.3f} ms with {QUEUED_MS} ms queued); bound "
              f"{bound_ms:.6f} ms ({bound_by}); one thread's chain of {images[0].numel()} "
              f"dependent steps of the sum of squares alone (roi_chain_floor) "
              f"{fmt_ms(floor_ms)} on the device [{gpu}]", flush=True)
        rows["roi_stats"][path] = {
            "shape": list(images.shape), "calls": calls[path]["masked_mean_variance"],
            "kernels_a_call": own, "device_events_a_call": profiled, "host_reads_a_call": reads,
            "host_ms_with_work_queued": wait_ms, "chain_adds": images[0].numel(),
            "chain_floor_ms": floor_ms,
            "max_abs_err": err, "ms": ms, "device_ms": on_device, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        del images

    for path, recorded in largest.items():
        for name in THRESHOLD_FUNCTIONS:
            if recorded.get(name, (0, None))[1] is None:
                continue
            values, mask, *rest = recorded[name][1]
            values = values.cuda()
            mask = None if mask is None else mask.cuda()
            nbins = rest[0] if rest else 256
            err = check_thresholds(f"the {path} path's largest {name} call", values, mask, nbins)
            errs["hist_threshold"] = max(errs["hist_threshold"], err)
            fn = lambda: getattr(thresholds, name)(values, mask, nbins)  # noqa: E731
            plain = getattr(thresholds, f"{name}_plain")
            profiled, own = kernels_a_call(fn, thresholds.HIST_THRESHOLD_KERNEL)
            wait_ms = host_wait_ms(fn)
            reads = int(wait_ms >= QUEUED_MS / 2)
            if reads:
                fail(f"{name} at the {path} path's largest call returned after {wait_ms:.3f} ms "
                     f"with {QUEUED_MS} ms queued on the card (.item() {item_ms:.3f} ms): it "
                     "waits on the card")
            plain_ms, _ = cold_times(lambda: plain(values, mask, nbins), 2, on_device=False)
            library_ms, _ = cold_times(library_histogram(values, mask, nbins), 5,
                                       on_device=False)
            ms, on_device = cold_times(fn, 10)
            bound_ms, bound_by = threshold_bound(values, mask)
            n_calls = calls[path].get(name, 0)
            print(f"hist_threshold = plain body bit for bit, and its time, at the {path} path's "
                  f"largest {name} call ({tuple(values.shape)}, "
                  f"{int(values.numel() if mask is None else mask.sum())} masked values, "
                  f"{nbins} bins, {n_calls} calls on the path): kernel {ms:.4f} ms a call on a "
                  f"cold L2 (on the device {fmt_ms(on_device)}), plain {plain_ms:.4f} ms, "
                  f"library (torch.histc of values[mask]) {library_ms:.4f} ms; {own} CUDA "
                  f"kernels a call by the kernel's count ({profiled} device events by the "
                  f"profiler, the memset among them), {reads} host reads (returned after "
                  f"{wait_ms:.3f} ms with {QUEUED_MS} ms queued on the card, .item() "
                  f"{item_ms:.3f} ms); bound {bound_ms:.6f} ms ({bound_by}) [{gpu}]",
                  flush=True)
            rows["hist_threshold"][f"{path} {name}"] = {
                "shape": list(values.shape), "nbins": nbins, "calls": n_calls,
                "kernels_a_call": own, "device_events_a_call": profiled,
                "host_reads_a_call": reads, "host_ms_with_work_queued": wait_ms,
                "max_abs_err": err, "ms": ms, "device_ms": on_device, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
            del values, mask
    for path in ("3D", "2D"):
        if f"{path} min_triangle_otsu" not in rows["hist_threshold"]:
            fail(f"the {path} path made no min_triangle_otsu call (the Filter's threshold)")
    return rows, errs


# ---------------------------------------------------------------------------
# phase 18: a real out-of-memory on the card
# ---------------------------------------------------------------------------

OOM_SHAPE = (2, 64, 512, 512)
OOM_FREE_FRAMES = 10  # float32 frames free for the ladder's estimate: over its 6 / 0.7
# float32 frames left once the run starts: under the full-frame Filter's peak
# (6.0 frames since the thresholds run in a hand kernel), over the low-memory one's
OOM_RUN_FRAMES = 5


def phase_out_of_memory(gpu, root):
    """Filter on a 3D series with ``low_memory=False`` while a ballast
    holds all but ``OOM_FREE_FRAMES`` float32 frames of the card's memory:
    the ladder's estimate (6 frames against 0.7 of what is free) lets it
    start in full-frame mode; right after the estimate more ballast takes
    all but ``OOM_RUN_FRAMES`` frames (as another process on the card
    would), the full frame's working set does not fit, PyTorch raises its
    out-of-memory error, and the ladder reruns the stage in low-memory mode
    on the same device.  ``im_preprocessed`` must equal, byte for byte, a
    run that asked for low memory from the start."""
    import logging

    from nellie_tpu_torch.io import ImInfo
    from nellie_tpu_torch.stages.filtering import Filter
    from nellie_tpu_torch.utils import adaptive_run

    start = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    data = np.stack([np.roll(make_frame(OOM_SHAPE[1:]), 3 * t, axis=1)
                     for t in range(OOM_SHAPE[0])])
    infos = {name: ImInfo(write_input(os.path.join(root, f"oom_{name}"), "series", data, "TZYX",
                                      DIM_RES)) for name in ("ladder", "low")}
    Filter(infos["low"], device="cuda", low_memory=True).run()
    frame_bytes = int(np.prod(OOM_SHAPE[1:])) * 4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)

    filled = []

    def fill_to(target):
        """Ballast until the ladder's own figure (the device's free memory
        and the free blocks PyTorch caches) is down to ``target`` bytes,
        all of them the device's free memory.  The cached blocks are
        fragments of segments that earlier phases' tensors still use, of
        any size: a piece of exactly each one's size takes it whole (the
        allocator picks the smallest block that fits), and one piece takes
        the device's free memory but ``target``, as another process
        would."""
        stream = torch.cuda.current_stream(dev).cuda_stream
        pieces = [torch.empty(block["size"], dtype=torch.uint8, device=dev)
                  for segment in torch.cuda.memory_snapshot()
                  if segment["device"] == dev.index and segment["stream"] == stream
                  for block in segment["blocks"] if block["state"] == "inactive"
                  # a request of at most 1 MiB is served from the small pool only
                  and (block["size"] <= 2 ** 20) == (segment["segment_type"] == "small")]
        filled.append(sum(piece.numel() for piece in pieces))
        free_now, _ = torch.cuda.mem_get_info(dev)
        pieces.append(torch.empty(max(int(free_now) - target, 0), dtype=torch.uint8,
                                  device=dev))
        return pieces

    ballast = fill_to(OOM_FREE_FRAMES * frame_bytes)
    left = adaptive_run.device_free_bytes(dev)
    estimate_low = adaptive_run.should_use_low_memory(infos["ladder"], dev)
    estimate = adaptive_run.should_use_low_memory
    left_at_run = []

    def estimate_then_shrink(im_info, device):
        low = estimate(im_info, device)
        if not left_at_run:
            ballast.extend(fill_to(OOM_RUN_FRAMES * frame_bytes))
            left_at_run.append(adaptive_run.device_free_bytes(dev))
        return low

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("nellie_tpu_torch")
    log.addHandler(handler)
    adaptive_run.should_use_low_memory = estimate_then_shrink
    try:
        Filter(infos["ladder"], device="cuda", low_memory=False).run()
    finally:
        adaptive_run.should_use_low_memory = estimate
        log.removeHandler(handler)
        del ballast
        torch.cuda.empty_cache()
    messages = [r.getMessage() for r in records]
    oom = [m for m in messages if "out of memory in full-frame mode" in m]
    rungs = [m for m in messages if m.startswith("Filter: ") and " mode on " in m]
    run_frames = left_at_run[0] / frame_bytes if left_at_run else float("nan")
    print(f"out of memory on the card: a ballast left {left / 2 ** 20:.1f} MiB free of "
          f"{total / 2 ** 30:.1f} GiB ({left / frame_bytes:.2f} float32 frames of "
          f"{OOM_SHAPE[1:]}); the ladder's estimate chose "
          f"{'low-memory' if estimate_low else 'full-frame'} mode; then {run_frames:.2f} "
          f"frames left for the run (cached fragments filled first: "
          f"{', '.join(f'{b / 2 ** 20:.1f}' for b in filled)} MiB); Filter's rungs: {rungs}; "
          f"out-of-memory retries: {len(oom)} [{gpu}]", flush=True)
    if estimate_low or not oom or not rungs or "low-memory mode on cuda" not in rungs[-1]:
        fail("phase 18: the Filter did not run out of memory in full-frame mode and rerun in "
             "low-memory mode on the card")
    paths = [info.pipeline_paths["im_preprocessed"] for info in infos.values()]
    arrays = [artifact(info, "im_preprocessed") for info in infos.values()]
    if not np.array_equal(arrays[0], arrays[1]) or not filecmp.cmp(*paths, shallow=False):
        fail("phase 18: the rerun's im_preprocessed is not the low-memory run's byte for byte")
    print(f"phase 18 (out of memory): im_preprocessed of the rerun = the low-memory run's, byte "
          f"for byte ({int((arrays[0] > 0).sum())} nonzero voxels); "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    return {"free_mib": left / 2 ** 20, "run_frames": run_frames, "retries": len(oom),
            "rungs": rungs, "fragments_filled_mib": [b / 2 ** 20 for b in filled]}


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


def build_kernels():
    """Build every hand kernel's library from the checkout, one nvcc a
    wrapper, all started together (``fma_f32`` and its chains share one
    source); print how many sources and the seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from nellie_tpu_torch.kernels import nn

    kernels = {"nn_argmin": nn.NN_KERNEL, **hand_counts()}
    start = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as ex:
        for future in [ex.submit(k.build) for k in kernels.values()]:
            future.result()
    sources = sorted({k.source for k in kernels.values()})
    print(f"kernel builds of {len(sources)} sources, in parallel: "
          f"{time.perf_counter() - start:.2f} s; nvcc "
          + ", ".join(f"{name} {k.build_seconds if k.build_seconds is not None else 'cached'}"
                      for name, k in kernels.items()), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    from nellie_tpu_torch.device import resolve_device
    from nellie_tpu_torch.kernels import frangi, nn

    kind = torch.cuda.get_device_name(0)
    gpu = gpu_line()
    print(f"device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"devices {torch.cuda.device_count()}", flush=True)
    print(gpu, flush=True)

    resolve_device("cuda")  # full float32: TF32 off for the library call too
    build_kernels()
    for d in (3, 8):
        print(f"nn kernel at d={d}: {nn.NN_KERNEL.info(d)}", flush=True)

    max_abs = phase_kernel(nn, gpu)
    root = tempfile.mkdtemp(prefix="nellie_port_smoke_")
    try:
        launches, by_stage, im_info, timings, hand = phase_main_path(nn, gpu, root)
        phase_fused_vs_staged(gpu, root, MAIN_SHAPE, im_info, timings)
        reassign, hierarchy = phase_kernel_main_shapes(nn, gpu, hand["nn"])
        phase_small_parity(root, small_series(), "TZYX",
                           {"X": 0.2, "Y": 0.2, "Z": 0.5, "T": 1.0})
        launches_2d, by_stage_2d, im_info_2d, timings_2d, hand_2d = phase_main_path(
            nn, gpu, root, MAIN_SHAPE_2D, tag="2D ")
        phase_fused_vs_staged(gpu, root, MAIN_SHAPE_2D, im_info_2d, timings_2d, tag="2D ")
        reassign_2d, hierarchy_2d = phase_kernel_main_shapes(nn, gpu, hand_2d["nn"], tag="2D ")
        series_2d = small_series_2d()
        for data, axes, t_res in ((series_2d, "TYX", 1.0), (series_2d[0], "YX", None)):
            phase_small_parity(root, data, axes, {"X": 0.1, "Y": 0.1, "Z": None, "T": t_res},
                               tag=f"2D {axes} ")
        phase_cli(nn, root)
        phase_capacity_parity(root)
        reassign_low = phase_low_memory(nn, gpu, root)
        phase_sample_tracks(gpu, root)
        float16 = phase_float16(nn, gpu, root)
        phase_native_codec()
        plugin = phase_plugin(nn, gpu, root)
        mesh = phase_mesh(nn, gpu, root, im_info, timings)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    capacity = phase_capacity_1024(gpu)

    start = time.perf_counter()
    ccl_rows, ccl_err = phase_ccl_kernel(gpu, {"3D": hand["calls"]["ccl_union_find"],
                                               "2D": hand_2d["calls"]["ccl_union_find"]},
                                         capacity["calls"])
    merge_rows, merge_err = phase_merge_kernel(gpu, capacity.pop("volume"))
    interp_rows, interp_differ, interp_err = phase_interp_kernel(
        gpu, {"3D": hand["calls"]["flow_interp"], "2D": hand_2d["calls"]["flow_interp"]})
    # capacity's one fma_f32 call a volume was the percentile's multiply-add,
    # which the percentile kernel now does
    fma_largest = {"3D": hand["fma_largest"], "2D": hand_2d["fma_largest"],
                   "capacity_1024": capacity["fma_largest"]}
    fma_rows, fma_err = phase_fma_kernel(gpu, {p: v for p, v in fma_largest.items()
                                               if p != "capacity_1024" or v[1] is not None})
    largest = {"3D": hand["largest"], "2D": hand_2d["largest"],
               "capacity_1024": capacity["largest"]}
    chain_rows, chain_err = phase_chain_kernel(gpu, {p: calls["fma_chain"]
                                                     for p, calls in largest.items()})
    gauss_rows, gauss_err = phase_gauss_kernel(
        gpu, largest, {"3D": hand["gauss_taps"], "2D": hand_2d["gauss_taps"],
                       "capacity_1024": capacity["gauss_taps"]})
    tail_rows, tail_err = phase_tail_kernel(gpu, largest)
    thin_rows, thin_err = phase_thin_kernel(gpu, {"3D": hand["largest"]["skeletonize_3d"]})
    seed_rows, seed_err = phase_seed_kernel(gpu, {"3D": hand["largest"]["nearest_seed"],
                                                  "2D": hand_2d["largest"]["nearest_seed"]})
    track_rows, track_errs = phase_track_threshold_kernels(
        gpu, largest, {"3D": hand["wrapper_calls"], "2D": hand_2d["wrapper_calls"],
                       "capacity_1024": capacity["wrapper_calls"]})
    last_rows, last_errs = phase_last_kernels(
        gpu, largest, {"3D": hand["wrapper_calls"], "2D": hand_2d["wrapper_calls"],
                       "capacity_1024": capacity["wrapper_calls"]},
        {"3D": hand["launches"], "2D": hand_2d["launches"], "capacity_1024": capacity["launches"]})
    last_rows["masked_percentile"]["contraction band"] = phase_percentile_band(
        gpu, {"3D": hand["filter_frames"], "2D": hand_2d["filter_frames"]})
    filter_reads = filter_host_reads()
    frame = torch.from_numpy(make_frame(MAIN_SHAPE[1:])).cuda().float()
    for name, blocks in (("a 3D frame", [frame]), ("nothing positive", [-frame])):
        _, reads = host_reads(lambda: frangi.WholeFrame.triangle_otsu(blocks, 10 ** 6))
        if reads:
            fail(f"the Filter's threshold on {name} made {reads} host reads")
    print(f"the Filter's host reads on the 3D main series ({MAIN_SHAPE}), counted by "
          f"torch.cuda.set_sync_debug_mode: {filter_reads}; 0 in a Frangi threshold (on a 3D "
          f"frame and on one with nothing positive; "
          f"{hand['wrapper_calls']['min_triangle_otsu']} min_triangle_otsu calls on the 3D "
          f"path) [{gpu}]", flush=True)
    print(f"phase 17 (hand kernels against their plain bodies): "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    root = tempfile.mkdtemp(prefix="nellie_port_oom_")
    try:
        phase_out_of_memory(gpu, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    reassign["launches"] = by_stage["VoxelReassigner"]
    hierarchy["launches"] = by_stage["Hierarchy"]
    reassign_2d["launches"] = by_stage_2d["VoxelReassigner"]
    hierarchy_2d["launches"] = by_stage_2d["Hierarchy"]
    paths = {"reassign": reassign, "hierarchy": hierarchy,
             "reassign_2d": reassign_2d, "hierarchy_2d": hierarchy_2d,
             "reassign_low_memory": reassign_low, "float16_small": float16, "plugin": plugin,
             "mesh": mesh}
    max_abs = max([max_abs] + [p["max_abs_err"] for p in paths.values() if "max_abs_err" in p])
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    launches_by_path = {name: {"3D": hand["launches"][name], "2D": hand_2d["launches"][name]}
                        for name in hand["launches"]}
    for name in ("fma_f32",) + CAPACITY_KERNELS:
        launches_by_path[name]["capacity_1024"] = capacity["launches"][name]
    # the CUDA kernels of the wrappers that count them (thin26 and nearest_seed
    # run many passes in one, hist_threshold launches two)
    kernel_launches_by_path = {name: {"3D": n, "2D": hand_2d["kernel_launches"][name]}
                               for name, n in hand["kernel_launches"].items()}
    for name in ("hist_threshold", "masked_percentile", "ccl_merge"):
        kernel_launches_by_path[name]["capacity_1024"] = capacity["kernel_launches"][name]
    fma_by_caller = {"3D": hand["fma_by_caller"], "2D": hand_2d["fma_by_caller"],
                     "capacity_1024": capacity["fma_by_caller"]}
    print(json.dumps({"kernels": [
        {"name": "nn_argmin", "route": "cuda",
         "source": "nellie_tpu_torch/kernels/csrc/nn_argmin.cu",
         "replaces": "nellie_tpu/kernels/pallas_nn.py:72",
         "launches": launches, "max_abs_err": max_abs, **{k: reassign[k] for k in keys},
         "launches_by_path": {"3D": launches, "2D": launches_2d}, "paths": paths},
        {"name": "ccl_union_find", "route": "cuda",
         "source": "nellie_tpu_torch/kernels/csrc/ccl_union_find.cu",
         "replaces": "nellie_tpu/kernels/ccl.py:162",
         "launches": hand["launches"]["ccl_union_find"], "max_abs_err": ccl_err,
         **{k: ccl_rows["3D label/remove_small_components"][k] for k in keys},
         "launches_by_path": launches_by_path["ccl_union_find"], "paths": ccl_rows},
        {"name": "ccl_merge", "route": "cuda",
         "source": "nellie_tpu_torch/kernels/csrc/ccl_merge.cu",
         "replaces": "nellie_tpu/pipeline/capacity.py:470",
         "launches": capacity["launches"]["ccl_merge"], "max_abs_err": merge_err,
         **{k: merge_rows["capacity label"][k] for k in keys},
         "launches_by_path": launches_by_path["ccl_merge"],
         "kernel_launches": capacity["kernel_launches"]["ccl_merge"],
         "kernel_launches_by_path": kernel_launches_by_path["ccl_merge"],
         "paths": merge_rows},
        {"name": "flow_interp", "route": "cuda",
         "source": "nellie_tpu_torch/kernels/csrc/flow_interp.cu",
         "replaces": "nellie_tpu/stages/flow_interpolation.py:29",
         "launches": hand["launches"]["flow_interp"], "max_abs_err": interp_err,
         **{k: interp_rows["3D reassign"][k] for k in keys},
         "differing_rows": interp_differ,
         "launches_by_path": launches_by_path["flow_interp"], "paths": interp_rows},
        {"name": "fma_f32", "route": "cuda",
         "source": "nellie_tpu_torch/kernels/csrc/fma_f32.cu",
         "replaces": "nellie_tpu/kernels/filters.py:69",
         "launches": hand["launches"]["fma_f32"], "max_abs_err": fma_err,
         **{k: fma_rows["3D"][k] for k in keys},
         "launches_by_path": launches_by_path["fma_f32"], "launches_by_caller": fma_by_caller,
         "paths": fma_rows},
        {"name": "fma_chain", "route": "cuda",
         "source": "nellie_tpu_torch/kernels/csrc/fma_f32.cu",
         "replaces": "nellie_tpu/stages/labelling.py:60",
         "launches": hand["launches"]["fma_chain"], "max_abs_err": chain_err,
         **{k: chain_rows["3D"][k] for k in keys}, "addcmul_ms": chain_rows["3D"]["addcmul_ms"],
         "launches_by_path": launches_by_path["fma_chain"], "launches_by_caller": fma_by_caller,
         "paths": chain_rows},
        {"name": "gauss_axis", "route": "cuda",
         "source": "nellie_tpu_torch/kernels/csrc/gauss_axis.cu",
         "replaces": "nellie_tpu/kernels/filters.py:73",
         "launches": hand["launches"]["gauss_axis"], "max_abs_err": gauss_err,
         **{k: gauss_rows["3D"][k] for k in keys},
         "launches_by_path": launches_by_path["gauss_axis"], "paths": gauss_rows},
        {"name": "frangi_tail", "route": "cuda",
         "source": "nellie_tpu_torch/kernels/csrc/frangi_tail.cu",
         "replaces": "nellie_tpu/kernels/frangi.py:151",
         "launches": hand["launches"]["frangi_tail"], "max_abs_err": tail_err,
         **{k: tail_rows["3D"][k] for k in keys},
         "launches_by_path": launches_by_path["frangi_tail"], "paths": tail_rows},
        {"name": "thin26", "route": "cuda",
         "source": "nellie_tpu_torch/kernels/csrc/thin26.cu",
         "replaces": "nellie_tpu/kernels/skeleton.py:213",
         "launches": hand["launches"]["thin26"], "max_abs_err": thin_err,
         **{k: thin_rows["3D"][k] for k in keys},
         "launches_by_path": launches_by_path["thin26"],
         "kernel_launches": hand["kernel_launches"]["thin26"],
         "kernel_launches_by_path": kernel_launches_by_path["thin26"], "paths": thin_rows},
        {"name": "nearest_seed", "route": "cuda",
         "source": "nellie_tpu_torch/kernels/csrc/nearest_seed.cu",
         "replaces": "nellie_tpu/kernels/edt.py:73",
         "launches": hand["launches"]["nearest_seed"], "max_abs_err": seed_err,
         **{k: seed_rows["3D"][k] for k in keys},
         "launches_by_path": launches_by_path["nearest_seed"],
         "kernel_launches": hand["kernel_launches"]["nearest_seed"],
         "kernel_launches_by_path": kernel_launches_by_path["nearest_seed"],
         "paths": seed_rows},
        *({"name": name, "route": "cuda", "source": f"nellie_tpu_torch/kernels/csrc/{name}.cu",
           "replaces": replaces, "launches": hand["launches"][name],
           "max_abs_err": track_errs[name], **{k: track_rows[name][row][k] for k in keys},
           "launches_by_path": launches_by_path[name],
           "kernel_launches": hand["kernel_launches"][name],
           "kernel_launches_by_path": kernel_launches_by_path[name], "paths": track_rows[name]}
          for name, replaces, row in (
              ("pair_sums", "nellie_tpu/kernels/matching.py:40", "3D"),
              ("pair_costs", "nellie_tpu/kernels/matching.py:61", "3D"),
              ("roi_stats", "nellie_tpu/kernels/moments.py:111", "3D"),
              ("hist_threshold", "nellie_tpu/kernels/thresholds.py:18",
               "3D min_triangle_otsu"))),
        *({"name": name, "route": "cuda", "source": f"nellie_tpu_torch/kernels/csrc/{name}.cu",
           "replaces": LAST_KERNELS[name][3], "launches": hand["launches"][name]
           if row != "2D" else hand_2d["launches"][name],
           "max_abs_err": last_errs[name], **{k: last_rows[name][row][k] for k in keys},
           "launches_by_path": launches_by_path[name],
           "kernel_launches": hand["kernel_launches"][name] if row != "2D"
           else hand_2d["kernel_launches"][name],
           "kernel_launches_by_path": kernel_launches_by_path[name],
           "paths": last_rows[name]}
          for name, row in (("thin2d", "2D"), ("edt_minplus", "3D"),
                            ("masked_percentile", "3D"), ("hu_features", "3D"))),
    ]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
