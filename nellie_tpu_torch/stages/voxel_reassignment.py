"""Stage 6 — VoxelReassigner: propagate t=0 identities through time.

Port of the DEFAULT fused pair path of
``nellie_tpu/stages/voxel_reassignment.py``, run as one sequential loop:
for each frame pair (t, t+1), ``_pair_match_kernel`` (``:335-424``)
interpolates the flow at every voxel of both frames, predicts each voxel
into the other frame, matches the prediction to the nearest real voxel
with the CUDA nearest-neighbour kernel (twice per pair), keeps matches
closer than the radius and picks each target's best pair;
``_pair_vote_kernel`` (``:426-452``) then votes both label streams.  The
reassigned labels of frame t+1 stay on the device as the next pair's
input.  The loop keeps the reference's early stops: an empty frame, a pair
without flow rows, or a pair without a single valid match ends it
(``:498-707``).  Writes ``im_branch_label_reassigned``,
``im_obj_label_reassigned`` (int32) and ``voxel_matches.npy``.

Not ported: the prefetch and writer threads, the mesh window, and the
step-by-step host path of the low-memory rungs.
"""
from __future__ import annotations

import numpy as np
import torch

from nellie_tpu_torch.io import ImInfo
from nellie_tpu_torch.utils.logger import logger
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels.nn import nn_argmin
from nellie_tpu_torch.kernels.voting import _vote_kernel, stable_lexsort
from nellie_tpu_torch.stages.flow_interpolation import FlowInterpolator, _interp_all_kernel

_SENTINEL = int(np.iinfo(np.int32).max)


def _row_norm(diff: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((diff * diff).sum(dim=1))


def _pair_match_kernel(cp, cp_scaled, cn, cn_scaled, origin_scaled, origin_post_scaled,
                       vec, cost, scaling, interp_max_d, match_max_d):
    """Interpolation -> nearest neighbour -> candidate filters -> best pair.

    cp/cn: (NP, 3)/(NN, 3) float32 voxel coordinates of frames t and t+1,
    ``*_scaled`` their physical copies; origin_scaled/origin_post_scaled:
    (M, 3) flow anchors for the forward/backward interpolation; vec (M, 3)
    voxel-unit flow; cost (M,).  Returns the candidate table
    (src, tgt, dist, keep) and per-t+1-voxel (best_src, best_ok)."""
    npq, nnq = cp.shape[0], cn.shape[0]
    dev = cp.device
    vec_f = _interp_all_kernel(cp_scaled, origin_scaled, vec, cost, interp_max_d)
    vec_b = _interp_all_kernel(cn_scaled, origin_post_scaled, vec, cost, interp_max_d)
    sp = scaling[None, :]

    # forward: predict t voxels into t+1, match against real t+1 voxels
    f_ok = ~torch.isnan(vec_f).any(dim=1)
    pred_f = (cp + torch.nan_to_num(vec_f)) * sp
    _, idx_f = nn_argmin(pred_f, cn_scaled)
    idx_f = idx_f.long()
    d_f = _row_norm(pred_f - cn_scaled[idx_f])
    keep_f = f_ok & (d_f < match_max_d)

    # backward: predict t+1 voxels into t, match against real t voxels
    b_ok = ~torch.isnan(vec_b).any(dim=1)
    pred_b = (cn - torch.nan_to_num(vec_b)) * sp
    _, idx_b = nn_argmin(pred_b, cp_scaled)
    idx_b = idx_b.long()
    d_b = _row_norm(pred_b - cp_scaled[idx_b])
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

    def __init__(self, im_info: ImInfo, num_t=None, viewer=None,
                 store_running_matches: bool = True, device="cuda"):
        self.im_info = im_info
        self.device = resolve_device(device)
        self.store_running_matches = store_running_matches
        self.viewer = viewer
        self.running_matches = []
        if im_info.no_t:
            self.num_t = 1
            return
        if im_info.no_z:
            raise NotImplementedError("the port runs 3D data; the 2D branch is not ported yet")
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

    def _frame_table(self, t):
        """(coords numpy, float32 coords, scaled coords) of frame t's master
        mask on the device, or None when the frame is empty."""
        coords = np.argwhere(self._get_master_mask(t))
        if len(coords) == 0:
            return None
        cp = torch.from_numpy(coords.astype(np.float32)).to(self.device)
        return coords, cp, cp * self._scaling

    def _flow_rows(self, t):
        """(origin_scaled, origin_post_scaled, vec, cost) of pair (t, t+1), or
        None when the pair has no flow rows."""
        fva = self.flow_interpolator_fw.flow_vector_array
        rows = fva[fva[:, 0] == t]
        if len(rows) == 0:
            return None
        scaling = np.asarray(self.flow_interpolator_fw.scaling, np.float64)
        origins = rows[:, 1:4]
        vecs = rows[:, 4:7]

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

        return (put(origins * scaling), put((origins + vecs) * scaling), put(vecs), put(rows[:, -1]))

    def _label_at(self, memmap, t, coords):
        return torch.from_numpy(np.ascontiguousarray(
            memmap[t][tuple(coords.T)], np.int32)).to(self.device)

    def _run_reassignment_fused(self):
        max_d = float(np.float32(self.flow_interpolator_fw.max_distance_um))
        match_dtype = np.uint16 if max(self.spatial_shape) < 2 ** 16 else np.uint32
        table = None
        prev_branch = prev_obj = None
        for t in range(self.num_t - 1):
            if self.viewer is not None:
                self.viewer.status = f"Reassigning voxels. Frame: {t + 1} of {self.num_t}."
            logger.info(f"Reassigning pixels between frames {t} and {t + 1}")
            table = table if table is not None else self._frame_table(t)
            next_table = self._frame_table(t + 1)
            if table is None or next_table is None:
                logger.info(f"No voxels to match between frames {t} and {t + 1}; stopping.")
                break
            flow = self._flow_rows(t)
            if flow is None:
                logger.info(f"No valid matches between frames {t} and {t + 1}; stopping.")
                break
            coords_p, cp, cp_s = table
            coords_n, cn, cn_s = next_table
            src, tgt, dist, keep, best_src, best_ok = _pair_match_kernel(
                cp, cp_s, cn, cn_s, *flow, self._scaling, max_d, max_d)
            if prev_branch is None:
                prev_branch = self._label_at(self.reassigned_branch_memmap, t, coords_p)
                prev_obj = self._label_at(self.reassigned_obj_memmap, t, coords_p)
            next_has_b = self._label_at(self.branch_label_memmap, t + 1, coords_n) > 0
            next_has_o = self._label_at(self.obj_label_memmap, t + 1, coords_n) > 0
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
            table, prev_branch, prev_obj = next_table, voted_branch, voted_obj

    def run(self):
        if self.im_info.no_t:
            logger.info("Skipping voxel reassignment for non-temporal dataset.")
            return
        self._allocate_memory()
        self._scaling = torch.tensor(self.flow_interpolator_fw.scaling, dtype=torch.float32,
                                     device=self.device)
        self.reassigned_branch_memmap[0][:] = np.asarray(self.branch_label_memmap[0])
        self.reassigned_obj_memmap[0][:] = np.asarray(self.obj_label_memmap[0])
        self.running_matches = []
        self._run_reassignment_fused()
        if self.store_running_matches:
            np.save(self.voxel_matches_path, np.array(self.running_matches, dtype=object))
