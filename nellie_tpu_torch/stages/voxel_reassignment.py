"""Stage 6 — VoxelReassigner: propagate t=0 identities through time.

Port of ``nellie_tpu/stages/voxel_reassignment.py``.  The default fused
pair path runs as one sequential loop:
for each frame pair (t, t+1), ``_pair_match_kernel`` (``:335-424``)
interpolates the flow at every voxel of both frames, predicts each voxel
into the other frame, matches the prediction to the nearest real voxel
with the CUDA nearest-neighbour kernel (twice per pair), keeps matches
closer than the radius and picks each target's best pair;
``_pair_vote_kernel`` (``:426-452``) then votes both label streams.  The
reassigned labels of frame t+1 stay on the device as the next pair's
input.  The loop keeps the reference's early stops: an empty frame, a pair
without flow rows, or a pair without a single valid match ends it
(``:498-707``).

In low-memory mode the reference's step-by-step host path runs instead
(``:772-862``, one pair at a time): the flow is interpolated at each
frame's voxels (``FlowInterpolator.interpolate_coord``), the predictions
are matched to the nearest real voxel by the same CUDA kernel
(``_nn_match``, through ``kernels/nn.py::nearest_neighbors``), and the
candidates vote on the host with float64 weight sums (the fused path sums
in float32 on the device, so near-ties may fall the other way between
the two modes; from 200,000 candidates the votes run on the device in
float32, as there).  Writes ``im_branch_label_reassigned``,
``im_obj_label_reassigned`` (int32) and ``voxel_matches.npy``.

With a ``mesh`` of more than one device (``voxel_reassignment.py:498-545``)
the label-independent match of pair t (flow interpolation, the NN kernel,
the candidate filters) runs on the mesh's device t mod n, a device-count
of pairs ahead on a thread pool, and the voting chain consumes the pairs
in order on the mesh's first device: the same two kernels, so the same
labels and matches as on one device.

Not ported: the single-device prefetch and writer threads, and
``_assign_unique_matches`` (kept by the reference for its API; nothing
calls it).
"""
from __future__ import annotations

import numpy as np
import torch

from nellie_tpu_torch.io import ImInfo
from nellie_tpu_torch.utils.logger import logger
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels._fp import fma, reduce_sum_of_squares, sqrt
from nellie_tpu_torch.kernels.nn import nearest_neighbors, nn_argmin
from nellie_tpu_torch.kernels.voting import _vote_kernel, stable_lexsort
from nellie_tpu_torch.stages.flow_interpolation import (_INTERP_TILE, FlowInterpolator,
                                                        _interp_all_kernel)
from nellie_tpu_torch.utils import adaptive_run

_SENTINEL = int(np.iinfo(np.int32).max)


def _pair_distance(moved: torch.Tensor, sp: torch.Tensor, matched: torch.Tensor) -> torch.Tensor:
    """|moved * sp - matched| per row, as the reference's pair program
    rounds it on the CPU (``scripts/xla_pair_distance_probe.py``).  XLA
    recomputes the prediction ``moved * sp`` inside the distance's fusion,
    and LLVM contracts it into the difference; the squares then add as
    XLA's reduction loop adds them, and the root is correctly rounded.
    Where the frame's table is one interpolation tile (the reference pads
    it to a power of two, at least ``_INTERP_TILE`` rows), the fusion also
    takes the flow's validity select and branches on it, and the last
    axis's product reaches the subtraction through the branch's phi: it is
    rounded first.  Over several tiles the loop is vectorised in one block
    and every axis contracts."""
    d = moved.shape[1]
    contracted = d if moved.shape[0] > _INTERP_TILE else d - 1
    diffs = [fma(moved[:, k], sp[0, k], -matched[:, k]) if k < contracted
             else moved[:, k] * sp[0, k] - matched[:, k] for k in range(d)]
    return sqrt(reduce_sum_of_squares(torch.stack(diffs, dim=1)))


def _pair_match_kernel(cp, cp_scaled, cn, cn_scaled, origin_scaled, origin_post_scaled,
                       vec, cost, scaling, interp_max_d, match_max_d):
    """Interpolation -> nearest neighbour -> candidate filters -> best pair.

    cp/cn: (NP, d)/(NN, d) float32 voxel coordinates of frames t and t+1
    (d = 2 or 3), ``*_scaled`` their physical copies;
    origin_scaled/origin_post_scaled: (M, d) flow anchors for the
    forward/backward interpolation; vec (M, d) voxel-unit flow; cost (M,).  Returns the candidate table
    (src, tgt, dist, keep) and per-t+1-voxel (best_src, best_ok)."""
    npq, nnq = cp.shape[0], cn.shape[0]
    dev = cp.device
    vec_f = _interp_all_kernel(cp_scaled, origin_scaled, vec, cost, interp_max_d)
    vec_b = _interp_all_kernel(cn_scaled, origin_post_scaled, vec, cost, interp_max_d)
    sp = scaling[None, :]

    # forward: predict t voxels into t+1, match against real t+1 voxels
    f_ok = ~torch.isnan(vec_f).any(dim=1)
    moved_f = cp + torch.nan_to_num(vec_f)
    _, idx_f = nn_argmin(moved_f * sp, cn_scaled, fused_norms=True)
    idx_f = idx_f.long()
    d_f = _pair_distance(moved_f, sp, cn_scaled[idx_f])
    keep_f = f_ok & (d_f < match_max_d)

    # backward: predict t+1 voxels into t, match against real t voxels
    b_ok = ~torch.isnan(vec_b).any(dim=1)
    moved_b = cn - torch.nan_to_num(vec_b)
    _, idx_b = nn_argmin(moved_b * sp, cp_scaled, fused_norms=True)
    idx_b = idx_b.long()
    d_b = _pair_distance(moved_b, sp, cp_scaled[idx_b])
    keep_b = b_ok & (d_b < match_max_d)

    src = torch.cat([torch.arange(npq, device=dev), idx_b])
    tgt = torch.cat([idx_f, torch.arange(nnq, device=dev)])
    dist = torch.cat([d_f, d_b])
    keep = torch.cat([keep_f, keep_b])

    # per-target best pair by (distance, candidate order)
    tgt_k = torch.where(keep, tgt, _SENTINEL)
    dist_k = torch.where(keep, dist, float("inf"))
    perm = stable_lexsort([tgt_k, dist_k, src])
    tgt_s, src_s = tgt_k[perm], src[perm]
    first = torch.ones_like(keep)
    first[1:] = tgt_s[1:] != tgt_s[:-1]
    first = first & (tgt_s != _SENTINEL)
    best_src = torch.zeros(nnq, dtype=torch.long, device=dev)
    best_ok = torch.zeros(nnq, dtype=torch.bool, device=dev)
    best_src[tgt_s[first]] = src_s[first]
    best_ok[tgt_s[first]] = True
    return src, tgt, dist, keep, best_src, best_ok


def _pair_vote_kernel(src, tgt, dist, keep, prev_branch, prev_obj,
                      next_has_branch, next_has_obj):
    """Weighted label votes of both label streams for frame t+1."""
    nnq = next_has_branch.shape[0]
    weights = 1.0 / (dist + 1e-6)

    def vote(prev_labels, next_has):
        lbls = prev_labels[src]
        valid = keep & (lbls > 0) & next_has[tgt]
        win, vt, vl, _ = _vote_kernel(tgt, lbls, weights, valid)
        out = torch.zeros(nnq, dtype=torch.int32, device=src.device)
        out[vt[win]] = vl[win].to(torch.int32)
        return out

    return vote(prev_branch, next_has_branch), vote(prev_obj, next_has_obj)


class VoxelReassigner:
    """Dense voxel matching along the flow field + weighted label voting."""

    # from this many candidates a vote runs on the device (float32 sums)
    DEVICE_VOTE_CUTOVER = 200_000

    def __init__(self, im_info: ImInfo, num_t=None, viewer=None,
                 store_running_matches: bool = True, max_refine_iterations: int = 3,
                 device="cuda", low_memory: bool = False, mesh=None):
        self.im_info = im_info
        self.mesh = mesh
        # with a mesh, the stage's own device is the mesh's first
        self.device = resolve_device(device) if mesh is None else mesh.flat()[0]
        self.low_memory = bool(low_memory)
        self.max_refine_iterations = int(max_refine_iterations)
        self.store_running_matches = store_running_matches
        self.viewer = viewer
        self.running_matches = []
        if im_info.no_t:
            self.num_t = 1
            return
        self.num_t = num_t
        if num_t is None:
            self.num_t = im_info.shape[im_info.axes.index("T")]
        # holds the flow rows, the scaling and the radius; the pair kernel
        # interpolates both directions itself
        self.flow_interpolator_fw = FlowInterpolator(im_info, forward=True, device=self.device)

    def _allocate_memory(self):
        info = self.im_info
        self.voxel_matches_path = info.pipeline_paths["voxel_matches"]
        self.branch_label_memmap = info.get_memmap(info.pipeline_paths["im_skel_relabelled"])
        self.obj_label_memmap = info.get_memmap(info.pipeline_paths["im_instance_label"])
        self.shape = self.branch_label_memmap.shape
        self.spatial_shape = self.shape[1:]
        self.reassigned_branch_memmap = info.allocate_memory(
            info.pipeline_paths["im_branch_label_reassigned"],
            dtype="int32", description="branch label reassigned", return_memmap=True)
        self.reassigned_obj_memmap = info.allocate_memory(
            info.pipeline_paths["im_obj_label_reassigned"],
            dtype="int32", description="object label reassigned", return_memmap=True)

    def _get_master_mask(self, t):
        return (np.asarray(self.branch_label_memmap[t]) > 0) | (np.asarray(self.obj_label_memmap[t]) > 0)

    def _frame_table(self, t, dev):
        """(coords numpy, float32 coords, scaled coords) of frame t's master
        mask on ``dev``, or None when the frame is empty."""
        coords = np.argwhere(self._get_master_mask(t))
        if len(coords) == 0:
            return None
        cp = torch.from_numpy(coords.astype(np.float32)).to(dev)
        return coords, cp, cp * self._scaling.to(dev)

    def _flow_rows(self, t, dev):
        """(origin_scaled, origin_post_scaled, vec, cost) of pair (t, t+1) on
        ``dev``, or None when the pair has no flow rows."""
        fva = self.flow_interpolator_fw.flow_vector_array
        rows = fva[fva[:, 0] == t]
        if len(rows) == 0:
            return None
        scaling = np.asarray(self.flow_interpolator_fw.scaling, np.float64)
        d = len(scaling)
        origins = rows[:, 1:1 + d]
        vecs = rows[:, 1 + d:1 + 2 * d]

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

        return (put(origins * scaling), put((origins + vecs) * scaling), put(vecs), put(rows[:, -1]))

    def _label_at(self, memmap, t, coords, dev):
        return torch.from_numpy(np.ascontiguousarray(
            memmap[t][tuple(coords.T)], np.int32)).to(dev)

    def _match(self, t, dev, table=None):
        """Pair (t, t+1)'s tables and match outputs on ``dev``, or the reason
        the chain stops there ("novox" or "noflow")."""
        max_d = float(np.float32(self.flow_interpolator_fw.max_distance_um))
        table = table if table is not None else self._frame_table(t, dev)
        next_table = self._frame_table(t + 1, dev)
        if table is None or next_table is None:
            return "novox"
        flow = self._flow_rows(t, dev)
        if flow is None:
            return "noflow"
        _, cp, cp_s = table
        _, cn, cn_s = next_table
        return table, next_table, _pair_match_kernel(
            cp, cp_s, cn, cn_s, *flow, self._scaling.to(dev), max_d, max_d)

    def _matches_sequential(self, n_pairs):
        table = None
        for t in range(n_pairs):
            res = self._match(t, self.device, table)
            yield res
            if isinstance(res, str):
                return
            table = res[1]

    def _matches_windowed(self, n_pairs, devs):
        """Pairs a device-count ahead, pair t on ``devs[t % n]``; yielded in
        pair order until one stops the chain."""
        from nellie_tpu_torch.mesh.sharded import thread_pool

        window = len(devs)
        futures = {}
        with thread_pool(min(window, n_pairs), devs) as ex:
            try:
                for t in range(n_pairs):
                    for ahead in range(t, min(t + window, n_pairs)):
                        if ahead not in futures:
                            futures[ahead] = ex.submit(self._match, ahead, devs[ahead % window])
                    res = futures.pop(t).result()
                    yield res
                    if isinstance(res, str):
                        return
            finally:
                for f in futures.values():
                    f.cancel()

    def _run_reassignment_fused(self):
        devs = self.mesh.flat() if self.mesh is not None and self.mesh.devices.size > 1 else None
        chain = devs[0] if devs else self.device
        match_dtype = np.uint16 if max(self.spatial_shape) < 2 ** 16 else np.uint32
        n_pairs = self.num_t - 1
        pairs = (self._matches_windowed(n_pairs, devs) if devs
                 else self._matches_sequential(n_pairs))
        prev_branch = prev_obj = None
        for t in range(n_pairs):
            if self.viewer is not None:
                self.viewer.status = f"Reassigning voxels. Frame: {t + 1} of {self.num_t}."
            logger.info(f"Reassigning pixels between frames {t} and {t + 1}")
            res = next(pairs)
            if res == "novox":
                logger.info(f"No voxels to match between frames {t} and {t + 1}; stopping.")
                break
            if res == "noflow":
                logger.info(f"No valid matches between frames {t} and {t + 1}; stopping.")
                break
            (coords_p, _, _), (coords_n, _, _), m = res
            src, tgt, dist, keep, best_src, best_ok = (x.to(chain) for x in m)
            if prev_branch is None:
                prev_branch = self._label_at(self.reassigned_branch_memmap, t, coords_p, chain)
                prev_obj = self._label_at(self.reassigned_obj_memmap, t, coords_p, chain)
            next_has_b = self._label_at(self.branch_label_memmap, t + 1, coords_n, chain) > 0
            next_has_o = self._label_at(self.obj_label_memmap, t + 1, coords_n, chain) > 0
            voted_branch, voted_obj = _pair_vote_kernel(
                src, tgt, dist, keep, prev_branch, prev_obj, next_has_b, next_has_o)

            ok = best_ok.cpu().numpy()
            if not ok.any():
                logger.info(f"No valid matches between frames {t} and {t + 1}; stopping.")
                break
            if self.store_running_matches:
                src_np = best_src.cpu().numpy()
                self.running_matches.append([coords_p[src_np[ok]].astype(match_dtype),
                                             coords_n[ok].astype(match_dtype)])
            vb = voted_branch.cpu().numpy()
            vo = voted_obj.cpu().numpy()
            wb, wo = vb > 0, vo > 0
            self.reassigned_branch_memmap[t + 1][tuple(coords_n[wb].T)] = vb[wb]
            self.reassigned_obj_memmap[t + 1][tuple(coords_n[wo].T)] = vo[wo]
            self.reassigned_branch_memmap.flush()
            self.reassigned_obj_memmap.flush()
            prev_branch, prev_obj = voted_branch, voted_obj
        pairs.close()

    # -- the step-by-step path of low-memory mode ------------------------------
    def _scale_coords(self, coords):
        return np.asarray(coords, np.float32) * np.asarray(
            self.flow_interpolator_fw.scaling, np.float32)

    def _nn_match(self, coords_real_scaled, coords_query_scaled):
        """(distance, index) of the nearest real voxel of each query."""
        return nearest_neighbors(coords_query_scaled, coords_real_scaled, device=self.device)

    def _match_voxels_to_centroids(self, coords_real, coords_interpx):
        _, idx = self._nn_match(self._scale_coords(coords_real),
                                self._scale_coords(coords_interpx))
        return idx

    def _compute_error_distance(self, predicted, matched):
        if predicted.size == 0:
            return np.empty((0,), np.float32)
        scaling = np.asarray(self.flow_interpolator_fw.scaling, np.float32)
        diffs = (predicted - matched).astype(np.float32) * scaling
        return np.linalg.norm(diffs, axis=1).astype(np.float32)

    def _empty_matches(self, dim):
        return (np.empty((0, dim), np.int64), np.empty((0, dim), np.int64),
                np.empty((0,), np.float64))

    def _match_forward(self, flow_interpolator, vox_prev, vox_next, t):
        """Frame t's voxels moved by the flow, matched to frame t+1's."""
        empty = self._empty_matches(vox_prev.shape[1] if vox_prev.ndim == 2 else 3)
        if vox_prev.size == 0 or vox_next.size == 0:
            return empty
        vectors = flow_interpolator.interpolate_coord(vox_prev, t)
        kept = ~np.isnan(vectors).any(axis=1)
        if not kept.any():
            return empty
        vox_prev_kept = vox_prev[kept]
        centroids_next = vox_prev_kept + vectors[kept]
        matched = vox_next[self._match_voxels_to_centroids(vox_next, centroids_next)]
        distances = self._compute_error_distance(centroids_next, matched)
        mask = distances < self.flow_interpolator_fw.max_distance_um
        if not mask.any():
            return empty
        return (vox_prev_kept[mask].astype(np.int64), matched[mask].astype(np.int64),
                distances[mask].astype(np.float64))

    def _match_backward(self, flow_interpolator, vox_next, vox_prev, t):
        """Frame t+1's voxels moved back by the flow, matched to frame t's."""
        empty = self._empty_matches(vox_prev.shape[1] if vox_prev.ndim == 2 else 3)
        if vox_prev.size == 0 or vox_next.size == 0:
            return empty
        vectors = flow_interpolator.interpolate_coord(vox_next, t)
        kept = ~np.isnan(vectors).any(axis=1)
        if not kept.any():
            return empty
        vox_next_kept = vox_next[kept]
        centroids_prev = vox_next_kept - vectors[kept]
        matched = vox_prev[self._match_voxels_to_centroids(vox_prev, centroids_prev)]
        distances = self._compute_error_distance(centroids_prev, matched)
        mask = distances < self.flow_interpolator_fw.max_distance_um
        if not mask.any():
            return empty
        return (matched[mask].astype(np.int64), vox_next_kept[mask].astype(np.int64),
                distances[mask].astype(np.float64))

    def match_voxels(self, vox_prev, vox_next, t):
        """Forward candidates, then backward ones: (prev, next, distance)."""
        parts = [p for p in (
            self._match_forward(self.flow_interpolator_fw, vox_prev, vox_next, t),
            self._match_backward(self._flow_interpolator_bw, vox_next, vox_prev, t + 1))
            if len(p[0])]
        if not parts:
            return self._empty_matches(vox_prev.shape[1] if vox_prev.ndim == 2 else 3)
        return tuple(np.concatenate([p[k] for p in parts], axis=0) for k in range(3))

    def _select_best_pairs(self, vox_prev, vox_next, distances):
        """Each target's closest candidate (the first of equal distances)."""
        if vox_prev.size == 0:
            dim = vox_prev.shape[1] if vox_prev.ndim == 2 else 3
            return np.empty((0, dim), np.int64), np.empty((0, dim), np.int64)
        target_flat = np.ravel_multi_index(vox_next.T, self.spatial_shape)
        order = np.lexsort((distances, target_flat))
        target_sorted = target_flat[order]
        change = np.ones(len(order), bool)
        change[1:] = target_sorted[1:] != target_sorted[:-1]
        best = order[change]
        return vox_prev[best], vox_next[best]

    def _vote_targets(self, target_coords, source_labels, distances):
        """(targets, labels, candidate index) of each target's winning label:
        the largest sum of 1 / (distance + 1e-6) over its candidates of one
        label, ties to the lower label; sums in float64 on the host, or in
        float32 on the device from ``DEVICE_VOTE_CUTOVER`` candidates."""
        if target_coords.size == 0:
            return (np.empty((0,), np.int64), np.empty((0,), source_labels.dtype),
                    np.empty((0,), np.int64))
        target_flat = np.ravel_multi_index(target_coords.T, self.spatial_shape)
        if (len(target_flat) >= self.DEVICE_VOTE_CUTOVER
                and int(np.prod(self.spatial_shape)) < 2 ** 31 - 1):
            return self._vote_targets_device(target_flat, source_labels, distances)
        weights = 1.0 / (distances + 1e-6)
        cand_idx = np.arange(len(weights), dtype=np.int64)
        order = np.lexsort((-weights, source_labels, target_flat))
        ts, ls, ws, cs = (target_flat[order], source_labels[order], weights[order],
                          cand_idx[order])
        pair_change = np.ones(len(order), bool)
        pair_change[1:] = (ts[1:] != ts[:-1]) | (ls[1:] != ls[:-1])
        pair_starts = np.nonzero(pair_change)[0]
        pair_targets = ts[pair_change]
        pair_labels = ls[pair_change]
        pair_best = cs[pair_change]
        weight_sums = np.add.reduceat(ws, pair_starts)
        order2 = np.lexsort((-weight_sums, pair_targets))
        pts, pls, pbs = pair_targets[order2], pair_labels[order2], pair_best[order2]
        tchange = np.ones(len(order2), bool)
        tchange[1:] = pts[1:] != pts[:-1]
        return pts[tchange], pls[tchange], pbs[tchange]

    def _vote_targets_device(self, target_flat, source_labels, distances):
        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.device)

        weights = (1.0 / (np.asarray(distances, np.float64) + 1e-6)).astype(np.float32)
        win, tgt, lbl, idx = _vote_kernel(
            put(target_flat, np.int64), put(source_labels, np.int64),
            put(weights, np.float32), torch.ones(len(target_flat), dtype=torch.bool,
                                                 device=self.device))
        win = win.cpu().numpy()
        return (tgt.cpu().numpy()[win], lbl.cpu().numpy()[win].astype(source_labels.dtype),
                idx.cpu().numpy()[win])

    def _vote_assign_labels_for_frame(self, candidate_prev, candidate_next, candidate_dist,
                                      label_memmap, reassigned_memmap, t):
        """Frame t+1's labels by vote of its candidates whose frame-t voxel
        is labelled, in up to ``max_refine_iterations`` rounds over the
        targets still unlabelled."""
        if candidate_prev.size == 0:
            return
        prev_labels = reassigned_memmap[t][tuple(candidate_prev.T)]
        valid = prev_labels > 0
        if not valid.any():
            return
        candidate_prev, candidate_next = candidate_prev[valid], candidate_next[valid]
        candidate_dist, prev_labels = candidate_dist[valid], prev_labels[valid]
        target_has_label = label_memmap[t + 1][tuple(candidate_next.T)] > 0
        if not target_has_label.any():
            return
        candidate_prev = candidate_prev[target_has_label]
        candidate_next = candidate_next[target_has_label]
        candidate_dist = candidate_dist[target_has_label]
        prev_labels = prev_labels[target_has_label]
        for _ in range(max(1, self.max_refine_iterations)):
            unassigned = reassigned_memmap[t + 1][tuple(candidate_next.T)] == 0
            if not unassigned.any():
                break
            cn = candidate_next[unassigned]
            _, best_labels, best_idx = self._vote_targets(
                cn, prev_labels[unassigned], candidate_dist[unassigned])
            if len(best_idx) == 0:
                break
            reassigned_memmap[t + 1][tuple(cn[best_idx].T)] = best_labels

    def _run_reassignment_low_memory(self):
        """One pair at a time: candidates, the best pairs, then the votes."""
        self._flow_interpolator_bw = FlowInterpolator(self.im_info, forward=False,
                                                      device=self.device)
        match_dtype = np.uint16 if max(self.spatial_shape) < 2 ** 16 else np.uint32
        for t in range(self.num_t - 1):
            if self.viewer is not None:
                self.viewer.status = f"Reassigning voxels. Frame: {t + 1} of {self.num_t}."
            logger.info(f"Reassigning pixels between frames {t} and {t + 1}")
            vox_prev = np.argwhere(self._get_master_mask(t))
            vox_next = np.argwhere(self._get_master_mask(t + 1))
            if len(vox_prev) == 0 or len(vox_next) == 0:
                logger.info(f"No voxels to match between frames {t} and {t + 1}; stopping.")
                break
            candidate_prev, candidate_next, candidate_dist = self.match_voxels(
                vox_prev, vox_next, t)
            if len(candidate_prev) == 0:
                logger.info(f"No valid matches between frames {t} and {t + 1}; stopping.")
                break
            if self.store_running_matches:
                best_prev, best_next = self._select_best_pairs(
                    candidate_prev, candidate_next, candidate_dist)
                self.running_matches.append([best_prev.astype(match_dtype),
                                             best_next.astype(match_dtype)])
            self._vote_assign_labels_for_frame(
                candidate_prev, candidate_next, candidate_dist,
                self.branch_label_memmap, self.reassigned_branch_memmap, t)
            self._vote_assign_labels_for_frame(
                candidate_prev, candidate_next, candidate_dist,
                self.obj_label_memmap, self.reassigned_obj_memmap, t)
            self.reassigned_branch_memmap.flush()
            self.reassigned_obj_memmap.flush()

    def _run_reassignment(self):
        self._allocate_memory()
        self._scaling = torch.tensor(self.flow_interpolator_fw.scaling, dtype=torch.float32,
                                     device=self.device)
        self.reassigned_branch_memmap[0][:] = np.asarray(self.branch_label_memmap[0])
        self.reassigned_obj_memmap[0][:] = np.asarray(self.obj_label_memmap[0])
        self.running_matches = []
        if self.low_memory:
            self._run_reassignment_low_memory()
        else:
            self._run_reassignment_fused()
        if self.store_running_matches:
            np.save(self.voxel_matches_path, np.array(self.running_matches, dtype=object))

    def run(self):
        if self.im_info.no_t:
            logger.info("Skipping voxel reassignment for non-temporal dataset.")
            return

        def attempt(dev, low):
            self.low_memory = low
            self._run_reassignment()

        adaptive_run.run_with_ladder("VoxelReassigner", self.device, self.low_memory,
                                     self.im_info, attempt)
