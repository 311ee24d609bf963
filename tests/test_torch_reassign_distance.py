"""The reassigner's pair distances and matches against the JAX package's,
bit for bit, where predictions land on voxels.

With integer flow vectors a voxel's prediction often lands exactly on a
voxel of the other frame.  Inside the reference's jitted pair program XLA
recomputes the prediction ``(c + v) * spacing`` in the distance's fusion
and contracts it into the difference (all axes but the last), and the
nearest-neighbour norms take fused multiply-adds
(``scripts/xla_pair_distance_probe.py``); a distance rounded as plain
torch rounds it is 0 where the reference's is the product's rounding
error.  ``dist`` decides ``keep``, the best pair per target and the vote
weights, so it must be the reference's bit for bit: on the pair kernel
(``dist`` on the rows with a flow, ``keep``, ``best_src``, ``best_ok``) and
through the stage, fused and in low memory (the host path's float64
votes), in 2D and 3D, on the CPU.  The pair kernel's cases put each
frame's table within one interpolation tile (8192 rows), over it, and on
either side of it: XLA rounds the last axis's product apart from the
difference over one tile and contracts every axis over several.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_port_data as D
from torch_port_data import one_torch_thread  # noqa: F401 — autouse
from nellie_tpu.stages.flow_interpolation import _INTERP_TILE, _bucket
from nellie_tpu.stages.voxel_reassignment import VoxelReassigner as JReassigner
from nellie_tpu.stages.voxel_reassignment import _expand_coord_table
from nellie_tpu_torch.stages import voxel_reassignment as vr
from nellie_tpu_torch.stages.voxel_reassignment import VoxelReassigner

SPACING = {3: (0.5, 0.2, 0.2), 2: (0.2, 0.2)}
MAX_D = 1.0


def voxel_sets(shape, sizes, rng):
    """Sorted sets of distinct voxels in ``shape``, one of each size."""
    out = []
    for n in sizes:
        flat = np.sort(rng.choice(int(np.prod(shape)), n, replace=False))
        out.append(np.stack(np.unravel_index(flat, shape), 1))
    return out


def integer_flows(anchor_set, m, rng):
    """m flow rows anchored on voxels of ``anchor_set``: anchors, integer
    vectors in [-2, 2] and costs."""
    anchors = anchor_set[rng.choice(len(anchor_set), m, replace=False)]
    vecs = rng.integers(-2, 3, anchors.shape).astype(np.float64)
    return anchors, vecs, rng.uniform(0.0, 1.0, m)


def reference_pair(c0, c1, anchors, vecs, costs, spacing):
    """The reference's jitted pair program on padded tables, cropped."""
    d = c0.shape[1]

    def table(coords):
        cu = np.zeros((_bucket(len(coords), _INTERP_TILE), d), np.uint16)
        cu[:len(coords)] = coords
        return _expand_coord_table(jnp.asarray(cu), jnp.int32(len(coords)),
                                   jnp.asarray(spacing, jnp.float32))

    m, mb = len(anchors), _bucket(len(anchors))

    def pad(a, shape):
        out = np.zeros(shape, np.float32)
        out[:m] = a
        return jnp.asarray(out)

    flow = (pad(anchors * spacing, (mb, d)), pad((anchors + vecs) * spacing, (mb, d)),
            pad(vecs, (mb, d)), pad(costs, (mb,)), jnp.asarray(np.arange(mb) < m))
    (cp, cps, cpv), (cn, cns, cnv) = table(c0), table(c1)
    out = JReassigner._pair_match_kernel(
        cp, cps, cpv, cn, cns, cnv, *flow, jnp.asarray(spacing, jnp.float32),
        jnp.float32(MAX_D), jnp.float32(MAX_D), use_pallas=False)
    src, tgt, dist, keep, best_src, best_ok = (np.asarray(a) for a in out)
    n0, n1, np_pad = len(c0), len(c1), cp.shape[0]
    rows = np.r_[np.arange(n0), np_pad + np.arange(n1)]
    return src[rows], tgt[rows], dist[rows], keep[rows], best_src[:n1], best_ok[:n1]


def port_pair(c0, c1, anchors, vecs, costs, spacing):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    sp = t(spacing)
    cp, cn = t(c0), t(c1)
    flow = (t(anchors * spacing), t((anchors + vecs) * spacing), t(vecs), t(costs))
    out = vr._pair_match_kernel(cp, cp * sp, cn, cn * sp, *flow, sp, MAX_D, MAX_D)
    flowed = [~torch.isnan(vr._interp_all_kernel(c * sp, origins, flow[2], flow[3], MAX_D)).any(1)
              for c, origins in ((cp, flow[0]), (cn, flow[1]))]
    return tuple(a.numpy() for a in out) + (torch.cat(flowed).numpy(),)


# (dimensions, voxels of frame t, voxels of frame t+1): each frame's table
# within one interpolation tile (8192 rows), both over it, and one on each
# side of the tile boundary
PAIR_CASES = [(3, 3000, 3000), (2, 3000, 3000), (3, 9000, 9500), (2, 9500, 9000),
              (3, 5000, 9000), (2, 9000, 5000)]


@pytest.fixture(scope="module", params=PAIR_CASES, ids=lambda c: "{}d-{}-{}".format(*c))
def pair(request):
    d, n0, n1 = request.param
    rng = np.random.default_rng(d + n0 + n1)
    shape = (16, 48, 48) if d == 3 else (96, 96)
    if max(n0, n1) > _INTERP_TILE:
        shape = (24, 64, 64) if d == 3 else (192, 192)
    c0, c1 = voxel_sets(shape, (n0, n1), rng)
    spacing = np.asarray(SPACING[d])
    args = (c0, c1, *integer_flows(c0, n0 // 10, rng), spacing)
    return reference_pair(*args), port_pair(*args)


def test_pair_distance_bitwise(pair):
    """``dist`` of every candidate whose voxel has a flow equals the
    reference's bit for bit, with the same matched voxel; predictions land
    on voxels (a distance of 0 in plain rounding) in many rows.  (A voxel
    without a flow is never kept; the reference matches it from far away.)"""
    (src, tgt, dist, keep, _, _), (p_src, p_tgt, p_dist, p_keep, _, _, flowed) = pair
    np.testing.assert_array_equal(p_keep, keep)
    assert flowed.sum() > 4000 and keep.sum() > 1000
    np.testing.assert_array_equal(p_src[flowed], src[flowed])
    np.testing.assert_array_equal(p_tgt[flowed], tgt[flowed])
    differ = flowed & (p_dist.view(np.int32) != dist.view(np.int32))
    assert int(differ.sum()) == 0, f"{int(differ.sum())} of {int(flowed.sum())} rows differ"
    assert int((keep & (dist < 1e-6) & (dist > 0)).sum()) > 50


def test_best_pairs_exact(pair):
    (*_, best_src, best_ok), (*_, p_best_src, p_best_ok, _) = pair
    np.testing.assert_array_equal(p_best_ok, best_ok)
    np.testing.assert_array_equal(p_best_src[best_ok], best_src[best_ok])


def write_labels(im_info, branch, obj, flow):
    paths = im_info.pipeline_paths
    for name, data in (("im_skel_relabelled", branch), ("im_instance_label", obj)):
        im_info._invalidate_memmap(paths[name])
        im_info.allocate_memory(paths[name], dtype="int32", data=data, description=name)
    np.save(paths["flow_vector_array"], flow)


def label_series(data, seed):
    """Random branch and object labels on a third of the voxels of each
    frame, and integer flow rows [t, anchor, vector, cost] anchored on
    frame t's labelled voxels."""
    rng = np.random.default_rng(seed)
    n_t, spatial = data.shape[0], data.shape[1:]
    branch = np.zeros(data.shape, np.int32)
    obj = np.zeros(data.shape, np.int32)
    rows = []
    for t in range(n_t):
        on = rng.random(spatial) < 0.3
        branch[t][on] = rng.integers(1, 60, int(on.sum()))
        obj[t][on] = rng.integers(1, 8, int(on.sum()))
        if t + 1 < n_t:
            anchors, vecs, costs = integer_flows(np.argwhere(on), 250, rng)
            rows.append(np.column_stack([np.full(len(anchors), t), anchors, vecs, costs]))
    return branch, obj, np.concatenate(rows).astype(np.float32)


@pytest.mark.parametrize("low_memory", [False, True], ids=["fused", "low_memory"])
@pytest.mark.parametrize("d", [3, 2], ids=["3d", "2d"])
def test_reassigned_labels_exact(tmp_path, d, low_memory):
    """The stage on labels whose flows are integer: both reassigned label
    artifacts and the voxel matches equal the reference's exactly."""
    if d == 3:
        data, dim_res, axes = D.tube_series(), D.DIM_RES, "TZYX"
    else:
        data, dim_res, axes = D.tube_series_2d(), D.DIM_RES_2D, "TYX"
    ref = D.open_im_info(D.write_input(tmp_path / "jax", data, dim_res, axes))
    port = D.open_im_info(D.write_input(tmp_path / "port", data, dim_res, axes))
    inputs = label_series(data, seed=d)
    for info in (ref, port):
        write_labels(info, *inputs)
    JReassigner(ref, device="cpu", low_memory=low_memory).run()
    VoxelReassigner(port, device="cpu", low_memory=low_memory).run()
    for name in ("im_branch_label_reassigned", "im_obj_label_reassigned"):
        want = D.read(ref, name)
        assert int((want[1:] > 0).sum()) > 1000
        np.testing.assert_array_equal(D.read(port, name), want)
    matches_ref, matches_port = D.read(ref, "voxel_matches"), D.read(port, "voxel_matches")
    assert len(matches_ref) == len(matches_port) > 0
    for pair_ref, pair_port in zip(matches_ref, matches_port):
        for a, b in zip(pair_ref, pair_port):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
