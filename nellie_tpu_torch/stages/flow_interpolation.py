"""Flow vector interpolation (forward/backward) at arbitrary coordinates.

Port of ``nellie_tpu/stages/flow_interpolation.py``: ``_interp_tile_body``
and ``_interp_all_kernel`` (``:29-77``) and ``FlowInterpolator``.  Each
query is scored against every flow vector of its frame inside the radius:

  w = (−cost) · (1/dist)          (indicator(dist==0) if any zero dist)
  w := w − min(w) + 1; w /= Σw    (shift-normalise over the radius set)
  v = Σ w · vec                   (NaN where the radius set is empty)

On a CUDA tensor :func:`_interp_all_kernel` launches the hand-written
kernel ``kernels/csrc/flow_interp.cu`` (built for ``sm_90a`` with ``nvcc``,
``-fmad=false``, on first use; bound through ``ctypes``), which rounds as
the plain body does, or raises; on a CPU tensor it runs the plain body
tile by tile.  ``FLOW_INTERP_KERNEL.launches`` counts the kernel's launches.

``interpolate_coord_dev`` leaves the vectors on the interpolator's device
for the Hierarchy; ``interpolate_coord`` is its host copy.
``interpolate_all_forward`` and ``interpolate_all_backward`` (``:210-257``)
walk coordinates through time along the interpolated flow into napari
tracks, for :class:`~nellie_tpu_torch.stages.all_tracks_for_label.LabelTracks`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from nellie_tpu_torch.io import ImInfo
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels._cuda import BASE_FLAGS, CudaKernel, check_error
from nellie_tpu_torch.kernels._fp import (REDUCE_WINDOW, contract, fma, reduce_sum_of_squares,
                                          sqrt, tree_sum)

_INTERP_TILE = 8192


def _interp_tile_body(query_scaled, flow_scaled, vectors, costs, max_distance):
    """(Q, d) interpolated vectors, NaN rows where no flow vector lies
    within ``max_distance``.

    Rounds as XLA rounds the reference on the CPU, so that the vectors
    are equal bit for bit (the Hierarchy's branch reference voxel is an
    argmin over their lengths): a correctly rounded square root, the
    shift ``w - min(w)`` fused into the product that makes ``w``, the
    weight sum in XLA's windowed order and the product with the vectors
    in its four-lane order."""
    diff = query_scaled[:, None, :] - flow_scaled[None, :, :]
    dist = sqrt(reduce_sum_of_squares(diff))
    mask = dist <= max_distance
    cost_w = -costs[None, :]
    zero = dist == 0
    has_zero = (mask & zero).any(dim=1, keepdim=True)
    pos = dist > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, dist, torch.ones_like(dist)),
                      torch.zeros_like(dist))
    dist_w = torch.where(has_zero, zero.float(), inv)
    w_min = torch.where(mask, cost_w * dist_w, float("inf")).amin(dim=1, keepdim=True)
    w = torch.where(mask, fma(cost_w, dist_w, -w_min) + 1.0, 0.0)
    w_sum = tree_sum(w)[:, None]
    any_nb = mask.any(dim=1, keepdim=True)
    w = w / torch.where(w_sum > 0, w_sum, torch.ones_like(w_sum))
    out = contract(w, vectors)
    return torch.where(any_nb, out, torch.full_like(out, float("nan")))


@functools.lru_cache(maxsize=64)
def radius_threshold(max_distance) -> float:
    """The largest float32 squared norm s whose correctly rounded square
    root is at most ``max_distance`` (as float32): ``sqrt(s) <= max_distance``
    exactly when ``s <= radius_threshold(max_distance)``, since the rounded
    root is monotonic."""
    r = np.float32(max_distance)
    if np.isnan(r) or r < 0:
        return float("-inf")
    if np.isinf(r):
        return float("inf")
    t = np.float32(np.float64(r) * np.float64(r))
    up, down = np.float32(np.inf), np.float32(-np.inf)
    while np.sqrt(t) > r:
        t = np.nextafter(t, down)
    while np.sqrt(np.nextafter(t, up)) <= r:
        t = np.nextafter(t, up)
    return float(t)


def tree_levels(n_rows: int) -> int:
    """How many times ``_fp.tree_sum`` folds ``n_rows`` values into windows
    of 32 before at most 32 remain."""
    levels = 0
    while n_rows > REDUCE_WINDOW:
        n_rows = -(-n_rows // REDUCE_WINDOW)
        levels += 1
    return levels


class _FlowInterpKernel(CudaKernel):
    """The compiled interpolation (``csrc/flow_interp.cu``), built once per
    process, with a launch count.  No multiply-add contraction and no fast
    math: the source writes out every fused multiply-add."""

    source = "flow_interp.cu"
    flags = (*BASE_FLAGS, "-fmad=false")

    def bind(self, lib):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flow_interp_f32.argtypes = [ptr] * 4 + [i32] * 3 + [ctypes.c_float, i32, ptr, ptr]
        lib.flow_interp_f32.restype = i32

    def __call__(self, query_scaled, flow_scaled, vectors, costs, max_distance):
        tensors = (query_scaled, flow_scaled, vectors, costs)
        if any(t.dtype != torch.float32 for t in tensors):
            raise TypeError("the flow interpolation kernel takes float32 tensors")
        n_q, dim = query_scaled.shape
        n_m = flow_scaled.shape[0]
        if dim not in (2, 3) or flow_scaled.shape != (n_m, dim) or vectors.shape != (n_m, dim) \
                or costs.shape != (n_m,):
            raise ValueError(f"shapes {[tuple(t.shape) for t in tensors]}: expected (Q, d), "
                             "(M, d), (M, d) and (M,) with d = 2 or 3")
        if n_q >= 2 ** 31 or n_m >= 2 ** 31:
            raise ValueError("more than 2**31 - 1 rows")
        dev = query_scaled.device
        if any(t.device != dev for t in tensors):
            raise ValueError("the flow interpolation's tensors must share one device")
        out = torch.empty((n_q, dim), dtype=torch.float32, device=dev)
        if n_q == 0:
            return out
        if n_m == 0:
            return out.fill_(float("nan"))
        lib = self.build()
        q, f, v, c = (t.contiguous() for t in tensors)
        # the library's launch cache is shared host state: one call at a time
        with self._lock, self.on_device(dev):
            err = lib.flow_interp_f32(q.data_ptr(), f.data_ptr(), v.data_ptr(), c.data_ptr(),
                                      n_q, n_m, dim, radius_threshold(max_distance),
                                      tree_levels(n_m), out.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
        check_error("flow_interp_f32 launch", err)
        self.count_launch()
        return out


FLOW_INTERP_KERNEL = _FlowInterpKernel()


def _interp_all_plain(query_scaled, flow_scaled, vectors, costs, max_distance):
    """All queries through the plain body, one tile of ``_INTERP_TILE``
    rows at a time."""
    return torch.cat([
        _interp_tile_body(query_scaled[s:s + _INTERP_TILE], flow_scaled, vectors,
                          costs, max_distance)
        for s in range(0, query_scaled.shape[0], _INTERP_TILE)
    ], dim=0)


def _interp_all_kernel(query_scaled, flow_scaled, vectors, costs, max_distance):
    """(Q, d) interpolated vectors for all queries: the hand-written kernel
    on a CUDA tensor (or it raises), :func:`_interp_all_plain` on a CPU
    tensor."""
    if query_scaled.device.type == "cuda":
        return FLOW_INTERP_KERNEL(query_scaled, flow_scaled, vectors, costs, max_distance)
    if query_scaled.device.type == "cpu":
        return _interp_all_plain(query_scaled, flow_scaled, vectors, costs, max_distance)
    raise ValueError(f"_interp_all_kernel: unsupported device {query_scaled.device}")


class FlowInterpolator:
    """Inverse-distance + cost weighted flow interpolation, fwd or bwd."""

    def __init__(self, im_info: ImInfo, num_t=None, max_distance_um=0.5, forward=True,
                 device="cuda"):
        self.im_info = im_info
        self.device = resolve_device(device)
        if im_info.no_t:
            return
        self.num_t = num_t
        if num_t is None:
            self.num_t = im_info.shape[im_info.axes.index("T")]
        res = im_info.dim_res
        self.scaling = ((res["Y"], res["X"]) if im_info.no_z
                        else (res["Z"], res["Y"], res["X"]))
        self.max_distance_um = max(max_distance_um * (res["T"] or 1.0), 0.5)
        self.forward = forward
        self.flow_vector_array = np.load(im_info.pipeline_paths["flow_vector_array"])
        self.current_t = None

    def _select_rows(self, t):
        """Flow rows and their anchors for timepoint t (fwd: origins; bwd:
        origins + vectors)."""
        d = len(self.scaling)
        if self.forward:
            rows = self.flow_vector_array[self.flow_vector_array[:, 0] == t]
            coords = rows[:, 1:1 + d]
        else:
            rows = self.flow_vector_array[self.flow_vector_array[:, 0] == t - 1]
            coords = rows[:, 1:1 + d] + rows[:, 1 + d:1 + 2 * d]
        self.check_rows = rows
        self.check_coords = coords
        self.current_t = t

    def interpolate_coord_dev(self, coords, t):
        """Interpolated flow vectors at ``coords`` as an (n, d) float32
        tensor on the interpolator's device (voxel units, NaN rows where
        no flow vector is within the radius), or None when frame t has no
        flow rows or there are no coordinates."""
        coords = np.asarray(coords, float)
        if self.current_t != t:
            self._select_rows(t)
        if coords.size == 0 or self.check_coords.shape[0] == 0:
            return None
        d = coords.shape[1]
        scaling = np.asarray(self.scaling, float)
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

        finite = ~np.isnan(coords).any(axis=1)
        query = np.where(finite[:, None], coords * scaling, 0.0)
        res = _interp_all_kernel(
            put(query), put(self.check_coords * scaling),
            put(self.check_rows[:, 1 + d:1 + 2 * d]), put(self.check_rows[:, -1]),
            float(np.float32(self.max_distance_um)))
        return torch.where(torch.from_numpy(finite).to(dev)[:, None], res, float("nan"))

    def interpolate_coord(self, coords, t):
        """Interpolated flow vectors (voxel units, float32 numpy) at
        ``coords``; NaN rows where no flow vector is within the radius."""
        coords = np.asarray(coords, float)
        if coords.size == 0:
            return np.zeros((0, coords.shape[1] if coords.ndim == 2 else 0))
        res = self.interpolate_coord_dev(coords, t)
        if res is None:
            return np.full(coords.shape, np.nan)
        return res.cpu().numpy()


def interpolate_all_forward(coords, start_t, end_t, im_info, min_track_num=0,
                            max_distance_um=0.5, device="cuda"):
    """Walk ``coords`` forward from ``start_t`` to ``end_t`` along the
    interpolated flow: napari tracks ``[id, t, (z,) y, x]`` and their
    ``frame_num`` property; a coordinate with no flow in reach stops
    (becomes NaN)."""
    flow_interpx = FlowInterpolator(im_info, forward=True, max_distance_um=max_distance_um,
                                    device=device)
    coords = np.asarray(coords, float).copy()
    tracks = []
    track_properties = {"frame_num": []}
    frame_range = np.arange(start_t, end_t)
    for t in frame_range:
        final_vector = flow_interpx.interpolate_coord(coords, t)
        if final_vector is None or len(final_vector) == 0:
            continue
        for coord_num, coord in enumerate(coords):
            if np.all(np.isnan(final_vector[coord_num])):
                coords[coord_num] = np.nan
                continue
            if t == frame_range[0]:
                tracks.append([coord_num + min_track_num, frame_range[0], *coord])
                track_properties["frame_num"].append(int(frame_range[0]))
            track_properties["frame_num"].append(int(t) + 1)
            coords[coord_num] = coord + final_vector[coord_num]
            tracks.append([coord_num + min_track_num, int(t) + 1, *coords[coord_num]])
    return tracks, track_properties


def interpolate_all_backward(coords, start_t, end_t, im_info, min_track_num=0,
                             max_distance_um=0.5, device="cuda"):
    """Walk ``coords`` backward from ``start_t`` down to ``end_t`` along the
    interpolated flow (the tracks of :func:`interpolate_all_forward`, in
    reverse time)."""
    flow_interpx = FlowInterpolator(im_info, forward=False, max_distance_um=max_distance_um,
                                    device=device)
    coords = np.asarray(coords, float).copy()
    tracks = []
    track_properties = {"frame_num": []}
    frame_range = list(np.arange(end_t, start_t + 1))[::-1]
    for t in frame_range:
        final_vector = flow_interpx.interpolate_coord(coords, t)
        if final_vector is None or len(final_vector) == 0:
            continue
        for coord_num, coord in enumerate(coords):
            if np.all(np.isnan(final_vector[coord_num])):
                coords[coord_num] = np.nan
                continue
            if t == frame_range[0]:
                tracks.append([coord_num + min_track_num, frame_range[0], *coord])
                track_properties["frame_num"].append(int(frame_range[0]))
            coords[coord_num] = coord - final_vector[coord_num]
            tracks.append([coord_num + min_track_num, int(t) - 1, *coords[coord_num]])
            track_properties["frame_num"].append(int(t) - 1)
    return tracks, track_properties
