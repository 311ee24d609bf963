"""Multi-device execution of the segmentation path over a (t, z) device grid.

Port of ``nellie_tpu/mesh/sharded.py``.  The JAX package leaves the
partitioning to GSPMD; here every partition is explicit, in one process:

* A :class:`Mesh` is a (t, z) grid of ``torch.device``s.  One device may
  appear more than once: each appearance is a logical shard, so one card
  (or the CPU) runs the same cross-shard code as several cards.
* A frame is split along its first spatial axis whose extent divides the
  z extent (:class:`ShardPlan`), each piece on its own device; with no
  such axis the frame stays whole on the group's first device.
* Stencils run on each shard's block extended by the receptive radius,
  taken from as many neighbouring shards as it reaches and never past the
  frame, so the kernels' own edge rules act only at the frame's true ends;
  the block is cropped back to the shard (:func:`halo_map`).
* Frame-wide statistics (γ, the Frobenius and percentile thresholds, the
  Label thresholds, maxima) gather the shards' parts of the frame's
  strided sample in raster order on the group's first device and send the
  scalar back; connectivity (hole filling, the area filter, labels) joins
  the shards' pieces with a host union-find (:mod:`.cells`).

Every result equals the single-device one bit for bit.  Frames of a
group run on the mesh's t rows from one thread per row (on the calling
thread when the mesh is the CPU alone).
"""
from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels import ccl
from nellie_tpu_torch.kernels import frangi as frangi_k
from nellie_tpu_torch.kernels import thresholds as thr_k
from nellie_tpu_torch.kernels.filters import binary_opening, uniform_filter
from nellie_tpu_torch.mesh import cells


class Mesh:
    """A (t, z) grid of devices: ``devices`` is a numpy object array of
    ``torch.device`` of shape (t, z), ``shape`` a dict as the stages read
    it (``mesh.shape.get("t", 1)``)."""

    axis_names = ("t", "z")

    def __init__(self, grid: np.ndarray):
        self.devices = grid

    @property
    def shape(self) -> dict:
        return {"t": int(self.devices.shape[0]), "z": int(self.devices.shape[1])}

    def row(self, i: int) -> list:
        """The z group of t row ``i`` (modulo the t extent)."""
        return list(self.devices[i % self.devices.shape[0]])

    def flat(self) -> list:
        return list(self.devices.flatten())

    def map_rows(self, fn, n: int) -> list:
        """``[fn(i, row_devices) for i in range(n)]`` with item i on t row
        i mod t, each row's items in order on one thread of its own."""
        rows = self.shape["t"]
        if rows == 1 or n <= 1:
            return [fn(i, self.row(i)) for i in range(n)]
        out = [None] * n

        def run_row(r):
            for i in range(r, n, rows):
                out[i] = fn(i, self.row(i))

        with thread_pool(min(rows, n), self.flat()) as ex:
            for f in [ex.submit(run_row, r) for r in range(min(rows, n))]:
                f.result()
        return out

    def __repr__(self):
        return f"Mesh(t={self.shape['t']}, z={self.shape['z']}, devices={self.flat()})"


class _CallingThread:
    """The executor interface run on the calling thread: each ``submit``
    computes its result at once."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args):
        future = Future()
        try:
            future.set_result(fn(*args))
        except Exception as exc:  # noqa: BLE001 — raised again by future.result()
            future.set_exception(exc)
        return future

    def map(self, fn, items):
        return [fn(item) for item in items]

    def shutdown(self, wait=True, cancel_futures=False):
        pass


def thread_pool(workers: int, devices):
    """Executor for work spread over ``devices``: threads when a device is a
    card, so that the devices' launches overlap, each using the caller's
    number of intra-op CPU threads (CPU reductions then split their work as
    on the calling thread); the calling thread alone when every device is
    the CPU, whose every op already uses all its cores."""
    if all(torch.device(d).type == "cpu" for d in devices):
        return _CallingThread()
    n = torch.get_num_threads()
    return ThreadPoolExecutor(max_workers=workers, initializer=torch.set_num_threads,
                              initargs=(n,))


def make_mesh(n_devices: Optional[int] = None, t_axis: int = 1, devices=None) -> Mesh:
    """Mesh over (t, z): ``t_axis`` data-parallel rows, the rest spatial
    (``sharded.py:34-43``).  ``devices`` plays the role of
    ``jax.devices()``: by default every visible CUDA device once (raises
    without CUDA); a device listed more than once is a logical shard.  A
    ``t_axis`` that does not divide ``n_devices`` becomes 1."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"n_devices={n_devices}: {len(devices)} devices available")
    if n_devices % t_axis != 0:
        t_axis = 1
    grid = np.empty(n_devices, dtype=object)
    for i, d in enumerate(devices[:n_devices]):
        grid[i] = d
    return Mesh(grid.reshape(t_axis, n_devices // t_axis))


def make_hybrid_mesh(t_axis: Optional[int] = None, devices=None) -> Mesh:
    """The reference's multi-slice mesh on a single host is
    :func:`make_mesh` (``sharded.py:242-245``); one process spans one host."""
    return make_mesh(t_axis=t_axis or 1, devices=devices)


# ---------------------------------------------------------------------------
# shard plans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardPlan:
    """How one frame of ``shape`` lies on a z group: split along ``axis``
    (None: whole on ``devices[0]``) into ``bounds[k]`` on ``devices[k]``."""

    shape: tuple
    axis: Optional[int]
    bounds: tuple
    devices: tuple

    @property
    def n(self) -> int:
        return len(self.bounds)

    def box(self, k: int) -> tuple:
        sl = [slice(None)] * len(self.shape)
        if self.axis is not None:
            sl[self.axis] = slice(*self.bounds[k])
        return tuple(sl)

    def origin(self, k: int) -> tuple:
        o = [0] * len(self.shape)
        if self.axis is not None:
            o[self.axis] = self.bounds[k][0]
        return tuple(o)

    def shard_shape(self, k: int) -> tuple:
        s = list(self.shape)
        if self.axis is not None:
            s[self.axis] = self.bounds[k][1] - self.bounds[k][0]
        return tuple(s)


def plan_frame(devices: Sequence[torch.device], shape) -> ShardPlan:
    """The first spatial axis whose extent divides the group size is split
    evenly (``sharded.py:58-64``); when none does, the frame stays whole on
    the group's first device (the counterpart of ``P()``)."""
    shape = tuple(int(s) for s in shape)
    n = len(devices)
    for axis, extent in enumerate(shape):
        if extent % n == 0:
            step = extent // n
            bounds = tuple((k * step, (k + 1) * step) for k in range(n))
            return ShardPlan(shape, axis, bounds, tuple(devices))
    return ShardPlan(shape, None, ((0, shape[0]),), (devices[0],))


def frame_sharding(mesh: Mesh, shape) -> ShardPlan:
    """Plan of one frame over the mesh's z group (``sharded.py:46-66``)."""
    return plan_frame(mesh.row(0), shape)


def batch_sharding(mesh: Mesh, frame_shape) -> list:
    """Plans of a frame batch: one per t row (``sharded.py:106-118``)."""
    return [plan_frame(mesh.row(r), frame_shape) for r in range(mesh.shape["t"])]


_NUMPY_DTYPES = {torch.float32: np.float32, torch.int32: np.int32}


def scatter(frame, plan: ShardPlan, dtype=None) -> list:
    """A host array or tensor as the plan's shards (each sliced first, then
    moved to its device), converted to ``dtype`` (float32 or int32) when
    given."""
    out = []
    for k in range(plan.n):
        if isinstance(frame, torch.Tensor):
            piece = frame[plan.box(k)]
            piece = piece if dtype is None else piece.to(dtype)
        else:
            arr = np.asarray(frame[plan.box(k)])
            if dtype is not None:
                arr = arr.astype(_NUMPY_DTYPES[dtype], copy=False)
            piece = torch.from_numpy(np.ascontiguousarray(arr))
        out.append(piece.contiguous().to(plan.devices[k]))
    return out


def gather(shards, plan: ShardPlan, device=None) -> torch.Tensor:
    """The whole frame on ``device`` (default: the group's first device)."""
    dev = plan.devices[0] if device is None else device
    if plan.n == 1:
        return shards[0].to(dev)
    return torch.cat([s.to(dev) for s in shards], dim=plan.axis)


def shard_volume(volume, mesh: Mesh, batched: bool = False):
    """A (Z, Y, X) volume as shards along Z over the mesh's z group, or a
    (T, Z, Y, X) batch as a list over frames (frame i on t row
    i * t // T) of such shards (``sharded.py:69-75``)."""
    z = mesh.shape["z"]
    frames = [volume] if not batched else list(volume)
    if batched and len(frames) % mesh.shape["t"]:
        raise ValueError(f"T={len(frames)} must divide evenly over t={mesh.shape['t']}")
    per_row = max(1, len(frames) // mesh.shape["t"])
    out = []
    for i, f in enumerate(frames):
        if f.shape[0] % z:
            raise ValueError(f"Z={f.shape[0]} must divide evenly over {z} shards")
        devs = mesh.row(i // per_row)
        step = f.shape[0] // z
        plan = ShardPlan(tuple(f.shape), 0, tuple((k * step, (k + 1) * step) for k in range(z)),
                         tuple(devs))
        out.append(scatter(f, plan))
    return out if batched else out[0]


# ---------------------------------------------------------------------------
# halos and frame-wide statistics
# ---------------------------------------------------------------------------

def extend(shards, plan: ShardPlan, halo: int) -> list:
    """Each shard's block extended by ``halo`` along the split axis from as
    many neighbours as it reaches, never past the frame; returns
    (block, planes added before) per shard."""
    if plan.axis is None or halo <= 0 or plan.n == 1:
        return [(s, 0) for s in shards]
    ax = plan.axis
    extent = plan.shape[ax]
    out = []
    for k, (a, b) in enumerate(plan.bounds):
        lo, hi = max(0, a - halo), min(extent, b + halo)
        pieces = []
        for j, (aj, bj) in enumerate(plan.bounds):
            s, e = max(aj, lo), min(bj, hi)
            if s < e:
                pieces.append(shards[j].narrow(ax, s - aj, e - s).to(plan.devices[k]))
        out.append((torch.cat(pieces, dim=ax) if len(pieces) > 1 else pieces[0], a - lo))
    return out


def crop(block: torch.Tensor, plan: ShardPlan, k: int, lo: int) -> torch.Tensor:
    if plan.axis is None:
        return block
    a, b = plan.bounds[k]
    return block.narrow(plan.axis, lo, b - a)


def halo_map(fn, shards, plan: ShardPlan, halo: int) -> list:
    """``fn`` on each shard's extended block, cropped back to the shard."""
    return [crop(fn(block), plan, k, lo).contiguous()
            for k, (block, lo) in enumerate(extend(shards, plan, halo))]


def _strided_part(core: torch.Tensor, plan: ShardPlan, k: int, strides) -> torch.Tensor:
    sl = []
    for ax, s in enumerate(strides):
        start = 0
        if ax == plan.axis:
            a = plan.bounds[k][0]
            start = (-a) % s
        sl.append(slice(start, None, s))
    return core[tuple(sl)]


def gather_strided(cores, plan: ShardPlan, strides) -> torch.Tensor:
    """``frame[::s0, ::s1, ...]`` of the whole frame, assembled from the
    shards' cores on the group's first device."""
    parts = [_strided_part(c, plan, k, strides) for k, c in enumerate(cores)]
    return gather(parts, plan)


def gather_flat_strided(shards, plan: ShardPlan, step: int) -> torch.Tensor:
    """``frame.reshape(-1)[::step]`` of the whole frame, in raster order, on
    the group's first device."""
    dev = plan.devices[0]
    if plan.axis is None or plan.n == 1:
        return shards[0].reshape(-1)[::step].to(dev)
    if plan.axis == 0:
        plane = int(np.prod(plan.shape[1:]))
        parts = []
        for k, s in enumerate(shards):
            start = (-plan.bounds[k][0] * plane) % step
            parts.append(s.reshape(-1)[start::step].to(dev))
        return torch.cat(parts)
    strides = cells.vol_strides(plan.shape)
    idx, vals = [], []
    for k, s in enumerate(shards):
        g = torch.zeros(s.shape, dtype=torch.int64, device=s.device)
        for ax, o in enumerate(plan.origin(k)):
            view = [1] * s.ndim
            view[ax] = s.shape[ax]
            g = g + ((torch.arange(s.shape[ax], device=s.device) + o) * strides[ax]).reshape(view)
        sel = (g % step) == 0
        idx.append(g[sel].to(dev))
        vals.append(s[sel].to(dev))
    idx, vals = torch.cat(idx), torch.cat(vals)
    return vals[torch.argsort(idx)]


class ShardStats:
    """The cascade's frame-wide reductions over the cores of a frame's
    extended blocks (:func:`nellie_tpu_torch.kernels.frangi.vesselness_blocks`)."""

    def __init__(self, plan: ShardPlan, offsets):
        self.plan = plan
        self.offsets = offsets
        self.minor_extent = plan.shape[-1]  # the Hessian's rule is the frame's

    def core(self, k: int, block: torch.Tensor) -> torch.Tensor:
        return crop(block, self.plan, k, self.offsets[k])

    def all_max(self, values):
        dev = self.plan.devices[0]
        m = torch.stack([v.to(dev) for v in values]).max()
        return [m.to(d) for d in self.plan.devices]

    def triangle_otsu(self, blocks, max_samples: int):
        strides = thr_k.sample_strides(self.plan.shape, max_samples)
        sample = gather_strided([self.core(k, b) for k, b in enumerate(blocks)], self.plan,
                                strides)
        pos = sample > 0
        if not bool(pos.any()):
            return None
        thr = thr_k.min_triangle_otsu(sample, pos)
        return [thr.to(d) for d in self.plan.devices]


# ---------------------------------------------------------------------------
# the segmentation path on shards
# ---------------------------------------------------------------------------

def filter_halo(params: frangi_k.FrangiParams, plan: ShardPlan, blob: bool) -> int:
    """Receptive radius of the vesselness (and 2D blobness) along the
    plan's split axis."""
    if plan.axis is None:
        return 0
    ndim = len(plan.shape)
    halo = frangi_k.cascade_radius(params, ndim, plan.axis)
    if blob:
        halo = max(halo, frangi_k.blob_radius(params, plan.axis))
    return halo


def vesselness_shards(raw, plan: ShardPlan, params, apply_mask: bool = True,
                      blob: bool = False):
    """(vesselness, mask) shards of ``vesselness_frame`` (with ``blob``,
    the vesselness is its maximum with the 2D blobness, as Filter takes it)."""
    ext = extend(raw, plan, filter_halo(params, plan, blob))
    blocks = [b.float() for b, _ in ext]
    stats = ShardStats(plan, [lo for _, lo in ext])
    vessel, masks = frangi_k.vesselness_blocks(blocks, params, apply_mask, stats)
    if blob:
        laps = [frangi_k.log_blob_response(b, m, params) for b, m in zip(blocks, masks)]
        top = stats.all_max([stats.core(k, lap).max() for k, lap in enumerate(laps)])
        vessel = [torch.maximum(v, torch.clamp(frangi_k.normalize_blobness(lap, m), min=0.0))
                  for v, lap, m in zip(vessel, laps, top)]
    return ([stats.core(k, v).contiguous() for k, v in enumerate(vessel)],
            [stats.core(k, m).contiguous() for k, m in enumerate(masks)])


def remove_edges_shards(shards, plan: ShardPlan) -> list:
    """``remove_edges_frame``: the (Z, Y) rows holding signal, gathered
    over the shards, decide every shard's margin."""
    flat = len(plan.shape) == 2
    views = [s[None] if flat else s for s in shards]
    axis = None if plan.axis is None else plan.axis + (1 if flat else 0)
    rows = [(v != 0).any(dim=2) for v in views]
    dev = plan.devices[0]
    if axis == 2:
        table = torch.stack([r.to(dev) for r in rows]).any(dim=0)
    elif axis is None or plan.n == 1:
        table = rows[0].to(dev)
    else:
        table = torch.cat([r.to(dev) for r in rows], dim=axis)
    kill = frangi_k.edge_rows(table)
    out = []
    for k, v in enumerate(views):
        kk = kill
        if axis in (0, 1) and plan.n > 1:
            a, b = plan.bounds[k]
            kk = kill.narrow(axis, a, b - a)
        kk = kk.to(v.device)
        o = torch.where(kk[:, :, None], torch.zeros_like(v), v)
        out.append(o[0] if flat else o)
    return out


def finalize_shards(shards, plan: ShardPlan, max_samples: int) -> list:
    """``finalize_frame``: the 1st percentile of the frame's strided
    positive sample and the opened mask (halo 2)."""
    if not any(bool((s > 0).any()) for s in shards):
        return shards
    sample = gather_strided(shards, plan, thr_k.sample_strides(plan.shape, max_samples))
    pos = sample > 0
    if not bool(pos.any()):
        return shards
    pct = frangi_k.masked_percentile(sample, pos, 1.0)
    masks = [s > pct.to(s.device) for s in shards]
    opened = halo_map(binary_opening, masks, plan, 2)
    return [s * m for s, m in zip(shards, opened)]


def filter_shards(raw, plan: ShardPlan, params, apply_mask: bool, max_samples: int,
                  remove_edges: bool) -> list:
    """The Filter stage's frame (vesselness, 2D blobness, edge removal,
    finalize) on shards."""
    vessel, _ = vesselness_shards(raw, plan, params, apply_mask, blob=len(plan.shape) == 2)
    if remove_edges:
        vessel = remove_edges_shards(vessel, plan)
    return finalize_shards(vessel, plan, max_samples)


def clean_mask(mask, plan: ShardPlan, min_area: int, fill: bool) -> list:
    """Hole filling (``fill``), the area filter and the 3ⁿ smoothing > 0.5
    of a sharded mask."""
    if fill:
        mask = cells.fill_holes(mask, plan)
    if min_area > 1:
        mask = cells.remove_small(mask, plan, min_area)
    return halo_map(lambda m: uniform_filter(m.float(), 3) > 0.5, mask, plan, 1)


def label_tail(mask, plan: ShardPlan, min_area: int, fill: bool):
    """:func:`clean_mask`, then scipy-numbered labels: (int32 label shards,
    count)."""
    return cells.label(clean_mask(mask, plan, min_area, fill), plan)


def label_shards(frangi, original, plan: ShardPlan, intensity_thresh, frangi_thresh,
                 min_area: int, fill: bool, use_intensity: bool):
    """Label's ``_label_frame_kernel`` on shards; all background when the
    threshold is undefined (None)."""
    if frangi_thresh is None:
        return [torch.zeros(s.shape, dtype=torch.int32, device=s.device) for s in frangi], 0
    mask = []
    for f, o in zip(frangi, original):
        f = f.float()
        if use_intensity:
            f = f * (o > float(np.float32(intensity_thresh)))
        mask.append(f > float(np.float32(frangi_thresh)))
    return label_tail(mask, plan, min_area, fill)


def label_thresholds(frangi, raw, plan: ShardPlan, label):
    """The fused chain's Label thresholds (``fused.py:294-333``) from the
    strided voxels of a sharded frame: (intensity threshold or None,
    Frangi threshold or None).  ``label`` is the stage object holding the
    parameters."""
    from nellie_tpu_torch.stages.labelling import (
        _frangi_threshold_kernel,
        _intensity_otsu_kernel,
    )

    step = label._sample_step(int(np.prod(plan.shape)))
    f_sample = gather_flat_strided(frangi, plan, step)
    o_sample = None
    intensity_thresh = None
    if label.otsu_thresh_intensity:
        o_sample = gather_flat_strided(raw, plan, step)
        thr, ok = _intensity_otsu_kernel(o_sample, label.histogram_nbins, 1)
        intensity_thresh = float(thr) if ok else 0.0
    elif label.threshold is not None:
        o_sample = gather_flat_strided(raw, plan, step)
        intensity_thresh = float(label.threshold)
    thr, ok = _frangi_threshold_kernel(
        f_sample, o_sample, 0.0 if intensity_thresh is None else intensity_thresh,
        label.histogram_nbins, 1)
    return intensity_thresh, (float(thr) if ok else None)


# ---------------------------------------------------------------------------
# the reference's entry points
# ---------------------------------------------------------------------------

def _as_float_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.float()
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def sharded_vesselness(volume, params: frangi_k.FrangiParams, mesh: Mesh) -> torch.Tensor:
    """Vesselness of one frame, split over the mesh's z group; the whole
    frame on the group's first device (``sharded.py:201-210``)."""
    volume = _as_float_tensor(volume)
    plan = frame_sharding(mesh, volume.shape)
    vessel, _ = vesselness_shards(scatter(volume, plan), plan, params)
    return gather(vessel, plan)


def _segment_threshold(vessel_sample: torch.Tensor) -> torch.Tensor:
    from nellie_tpu_torch.stages.labelling import _frangi_threshold_kernel

    # with no positive sample both thresholds are 0 and the cut 10**0 = 1,
    # above every vesselness value, as in the reference
    thr, _ = _frangi_threshold_kernel(vessel_sample, None, 0.0, 256, 1)
    return thr


def _segment_step(frame, params: frangi_k.FrangiParams, min_area: int):
    """Vesselness -> the log-domain min(triangle, Otsu) threshold of the
    flat strided sample -> hole filling (3D), area filter, smoothing,
    labels, on one device (``sharded.py:78-103``).  Returns (vessel,
    int32 labels, count)."""
    frame = _as_float_tensor(frame)
    vessel, _ = frangi_k.vesselness_frame(frame, params)
    step = max(vessel.numel() // max(1, params.max_threshold_samples), 1)
    mask = vessel > _segment_threshold(vessel.reshape(-1)[::step])
    if frame.ndim == 3:
        mask = ccl.fill_holes(mask)
    mask = ccl.remove_small_components(mask, min_area)
    mask = uniform_filter(mask.float(), 3) > 0.5
    labels, n = ccl.label(mask)
    return vessel, labels.to(torch.int32), n


def _segment_step_shards(raw, plan: ShardPlan, params, min_area: int):
    vessel, _ = vesselness_shards(raw, plan, params)
    step = max(int(np.prod(plan.shape)) // max(1, params.max_threshold_samples), 1)
    thr = _segment_threshold(gather_flat_strided(vessel, plan, step))
    mask = [v > thr.to(v.device) for v in vessel]
    labels, n = label_tail(mask, plan, min_area, fill=len(plan.shape) == 3)
    return vessel, labels, n


def sharded_segment_step(batch, params: frangi_k.FrangiParams, mesh: Mesh, min_area: int = 4):
    """:func:`_segment_step` over a (T, *spatial) batch: frame i on t row
    i mod t, split over the row's z group (``sharded.py:213-230``).
    Returns (vessel, int32 labels) stacked on the mesh's first device and
    the per-frame counts."""
    frames = [_as_float_tensor(f) for f in batch]

    def one(i, row):
        plan = plan_frame(row, frames[i].shape)
        vessel, labels, n = _segment_step_shards(scatter(frames[i], plan), plan, params,
                                                 min_area)
        return gather(vessel, plan), gather(labels, plan), n

    out = mesh.map_rows(one, len(frames))
    dev = mesh.flat()[0]
    return (torch.stack([v.to(dev) for v, _, _ in out]),
            torch.stack([lab.to(dev) for _, lab, _ in out]),
            [n for _, _, n in out])


def batched_filter_kernel(frames, params, apply_mask: bool, max_samples: int,
                          remove_edges: bool, mesh: Mesh) -> list:
    """The Filter stage over a list of frames (``sharded.py:121-140``):
    frame i on t row i mod t, split over the row's z group; each result
    whole on its row's first device."""
    def one(i, row):
        plan = plan_frame(row, np.shape(frames[i]))
        raw = scatter(frames[i], plan, torch.float32)
        return gather(filter_shards(raw, plan, params, apply_mask, max_samples,
                                    remove_edges), plan)

    return mesh.map_rows(one, len(frames))


def batched_label_kernel(frangi_b, orig_b, intensity_thr_b, frangi_thr_b, valid_b,
                         min_area: int, fill: bool, use_intensity: bool, mesh: Mesh) -> list:
    """The Label stage over a list of frames with per-frame thresholds
    (``sharded.py:143-158``); a frame whose threshold is undefined gets the
    all-background result."""
    def one(i, row):
        plan = plan_frame(row, np.shape(frangi_b[i]))
        thr = frangi_thr_b[i] if valid_b[i] else None
        labels, _ = label_shards(scatter(frangi_b[i], plan, torch.float32),
                                 scatter(orig_b[i], plan, torch.float32), plan,
                                 intensity_thr_b[i], thr, min_area, fill, use_intensity)
        return gather(labels, plan)

    return mesh.map_rows(one, len(frangi_b))


def batched_network_kernel(labels_b, frangi_b, network, mesh: Mesh) -> list:
    """The Network stage over a list of frames (``sharded.py:161-189``):
    each frame whole on its row's first device, through the stage's own
    per-frame function; (skeleton, pixel class, branch labels) per frame."""
    def one(i, row):
        dev = row[0]
        return network._frame(torch.as_tensor(np.asarray(labels_b[i]), dtype=torch.int32,
                                              device=dev),
                              _as_float_tensor(frangi_b[i]).to(dev))

    return mesh.map_rows(one, len(labels_b))


def batched_markers_kernel(intensity_b, labels_b, markers, mesh: Mesh) -> list:
    """The Markers stage over a list of frames (``sharded.py:192-198``),
    each whole on its row's first device: (marker, distance, border)."""
    def one(i, row):
        dev = row[0]
        mask = torch.as_tensor(np.asarray(labels_b[i]) > 0, device=dev)
        if not bool(mask.any()):
            zero = torch.zeros(mask.shape, dtype=torch.uint8, device=dev)
            return zero, torch.zeros(mask.shape, dtype=torch.float32, device=dev), zero
        return markers._markers(_as_float_tensor(intensity_b[i]).to(dev), mask, None)

    return mesh.map_rows(one, len(labels_b))
