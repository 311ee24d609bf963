"""Hierarchy (feature extraction) of the PyTorch port against the JAX package.

Kernel-level checks give the same numpy inputs, made from seeds, to the
JAX functions (jitted, on the CPU) and to their ports (on the CPU).  The
stage checks run the JAX stages once on ``torch_port_data.tube_series()``,
give the port the JAX package's artifacts and compare the five feature
CSVs and ``adjacency_maps.pkl``.

Bars: the features bar of ``tests/oracle/test_features_parity.py`` (rtol
1e-4, atol 1e-4, NaN where the reference has NaN) for every float
column; exact for row counts, column order, counts, min, max, branch
lengths and degrees, the branch reference voxels and every adjacency edge.
Segment statistics are also held at rtol 1e-5 against the reference's
float64 host oracle: the port sums in float64.
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_data as D
from nellie_tpu.kernels import segstats as j_segstats
from nellie_tpu.stages import flow_interpolation as j_fi
from nellie_tpu.stages import hierarchical as j_hier
from nellie_tpu.stages.filtering import Filter as JFilter
from nellie_tpu.stages.hu_tracking import HuMomentTracking as JTracking
from nellie_tpu.stages.labelling import Label as JLabel
from nellie_tpu.stages.mocap_marking import Markers as JMarkers
from nellie_tpu.stages.networking import Network as JNetwork
from nellie_tpu.stages.voxel_reassignment import VoxelReassigner as JReassigner
from nellie_tpu_torch.kernels import segstats
from nellie_tpu_torch.kernels._fp import reduce_sum_of_squares, sqrt
from nellie_tpu_torch.stages import hierarchical as hier
from nellie_tpu_torch.stages.flow_interpolation import FlowInterpolator

SPACING = np.array([0.5, 0.2, 0.2], np.float32)
T = torch.from_numpy


def _nan_close(got, want, rtol=D.FEATURE_RTOL, atol=D.FEATURE_ATOL, msg=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{msg} NaN pattern")
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _segment_inputs(seed=0, s=11, n=20_000, groups=300):
    rng = np.random.default_rng(seed)
    values = rng.normal(5, 2, (s, n)).astype(np.float32)
    values[rng.random((s, n)) < 0.1] = np.nan
    seg = rng.integers(-1, groups + 20, n).astype(np.int32)  # -1 and out of range
    seg[seg == 7] = 6  # an empty segment
    values[:, seg == 11] = 3.25  # a constant segment: std exactly 0
    return values, seg, groups


def _assert_segment_stats(got, want, rtol):
    for key in segstats.STAT_KEYS:
        if key in ("min", "max"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key], np.float64), err_msg=key)
        else:
            _nan_close(got[key], want[key], rtol=rtol, atol=0, msg=key)


def test_segment_nanstats_against_jax_kernel_and_host_oracle():
    values, seg, groups = _segment_inputs()
    got = segstats.segment_nanstats(T(values), seg, groups)
    out = np.asarray(j_segstats._segment_nanstats_kernel(jnp.asarray(values), jnp.asarray(seg),
                                                         groups))
    _assert_segment_stats(got, {k: out[i] for i, k in enumerate(segstats.STAT_KEYS)}, 1e-5)
    _assert_segment_stats(got, j_segstats.group_stats_host(values, seg, groups), 1e-5)
    assert np.isnan(got["mean"][:, 7]).all()
    assert (got["std_dev"][:, 11] == 0).all()
    # counts: the sum of an indicator of the values that count
    ones = np.where(np.isnan(values), np.nan, 1.0).astype(np.float32)
    counts = segstats.segment_nanstats(T(ones), seg, groups)["sum"]
    ok = (seg >= 0) & (seg < groups)
    want = np.stack([np.bincount(seg[ok & ~np.isnan(v)], minlength=groups) for v in values])
    np.testing.assert_array_equal(np.nan_to_num(counts), want)


def test_segment_nanstats_gathered_against_jax():
    values, _, groups = _segment_inputs(seed=1, n=3000)
    rng = np.random.default_rng(2)
    idx = rng.integers(0, values.shape[1], 40_000)
    seg = rng.integers(0, groups, 40_000).astype(np.int32)
    got = segstats.segment_nanstats_gathered(T(values), idx, seg, groups)
    want = j_segstats.segment_nanstats_gathered(values, idx, seg, groups)
    _assert_segment_stats(got, want, 1e-5)


def _random_skeleton(seed=0, shape=(12, 20, 24), labels=9):
    rng = np.random.default_rng(seed)
    skel = np.zeros(shape, np.int32)
    for lbl in range(1, labels + 1):  # random walks, some crossing each other
        p = rng.integers(0, shape)
        for _ in range(rng.integers(3, 25)):
            skel[tuple(p)] = lbl
            p = np.clip(p + rng.integers(-1, 2, 3), 0, np.array(shape) - 1)
    return skel


@pytest.mark.parametrize("case", ["random", "line", "diagonal_2d"])
def test_branch_geometry_against_jax(case):
    if case == "random":
        skel, spacing = _random_skeleton(), (0.5, 0.2, 0.2)
    elif case == "line":
        skel, spacing = np.zeros((3, 3, 7), np.int32), (1.0, 1.0, 1.0)
        skel[1, 1, 1:6] = 4
    else:
        skel, spacing = np.zeros((4, 4), np.int32), (2.0, 1.0)
        for i in range(4):
            skel[i, i] = 2
        skel[0, 3] = 5
    coords = np.argwhere(skel > 0)
    lengths, deg = segstats.branch_geometry(T(skel), spacing, coords)
    want_len, want_deg = j_segstats.branch_geometry(skel, spacing, coords=coords)
    assert lengths.dtype == np.float32 and deg.dtype == np.uint8
    np.testing.assert_array_equal(lengths, want_len)
    np.testing.assert_array_equal(deg, want_deg)
    if case == "line":
        assert lengths[4] == pytest.approx(4.0)
    if case == "diagonal_2d":
        assert lengths[2] == pytest.approx(3 * np.sqrt(5.0)) and lengths[5] == 0


def test_segment_argmin_against_jax():
    rng = np.random.default_rng(3)
    values = rng.integers(0, 6, 5000).astype(np.float32) * np.float32(0.25)  # many exact ties
    values[rng.random(5000) < 0.05] = np.nan
    seg = rng.integers(-1, 45, 5000).astype(np.int32)
    got = hier._segment_argmin(T(values), T(seg), 40).numpy()
    want = np.asarray(jax.jit(j_hier._segment_argmin, static_argnums=2)(values, seg, 40))
    np.testing.assert_array_equal(got, want)


def _motility_inputs(seed, n=3000):
    rng = np.random.default_rng(seed)
    coords = rng.permutation(np.argwhere(np.ones((10, 30, 30))))[:n].astype(np.float32)
    # unit steps along y with last-bit noise: |flow| ties are broken by
    # single ulps, as on real flow fields
    vec = np.zeros((n, 3), np.float32)
    vec[:, 1] = np.float32(1.0) + rng.integers(-2, 3, n).astype(np.float32) * np.float32(6e-8)
    vec[:, 2] = rng.normal(0, 0.2, n).astype(np.float32) * (rng.random(n) < 0.5)
    vec[rng.random(n) < 0.1] = np.nan
    labels = rng.integers(-1, 30, n).astype(np.int32)
    return coords, vec, labels


@pytest.mark.parametrize("has01", [True, False])
def test_motility_kernel_against_jax(has01):
    coords, vec12, labels = _motility_inputs(4)
    _, vec01, _ = _motility_inputs(5)
    if not has01:
        vec01 = np.full_like(vec01, np.nan)
    dt = np.float32(2.0)
    want = np.asarray(j_hier._motility_kernel(coords, vec01, vec12, labels, SPACING, dt,
                                              no_z=False, has01=has01, num_labels=30))
    got = hier._motility_kernel(T(coords), T(vec01), T(vec12), T(labels), T(SPACING),
                                float(dt), has01=has01, num_labels=30).numpy()
    assert got.shape == want.shape == (9, len(coords))
    for i, key in enumerate(hier._MOTILITY_KEYS):
        _nan_close(got[i], want[i], msg=key)
    # the reference voxels behind the rel_* columns
    euc_want = np.asarray(jax.jit(lambda v: jnp.linalg.norm(v * SPACING[None], axis=1))(vec12))
    euc_got = sqrt(reduce_sum_of_squares(T(vec12) * T(SPACING)[None])).numpy()
    np.testing.assert_array_equal(euc_got, euc_want)
    want_ref = np.asarray(jax.jit(j_hier._segment_argmin, static_argnums=2)(euc_want, labels, 30))
    np.testing.assert_array_equal(hier._segment_argmin(T(euc_got), T(labels), 30).numpy(), want_ref)


def _node_inputs(seed=6):
    rng = np.random.default_rng(seed)
    shape = (8, 24, 24)
    coords = np.argwhere(rng.random(shape) < 0.3)
    c = len(coords)
    nodes = coords[rng.permutation(c)[:60]]
    radius = rng.uniform(0.5, 3.0, len(nodes))
    lo = np.clip((nodes - radius[:, None]).astype(int), 0, shape).astype(np.int32)
    hi = np.clip((nodes + radius[:, None]).astype(int) + 1, 0, shape).astype(np.int32)
    vec01 = rng.normal(0, 0.3, (c, 3)).astype(np.float32)
    vec12 = rng.normal(0, 0.3, (c, 3)).astype(np.float32)
    vec01[rng.random(c) < 0.2] = np.nan
    stats = rng.normal(3, 1, (len(hier.VOXEL_STATS), c)).astype(np.float32)
    stats[rng.random(stats.shape) < 0.15] = np.nan
    return shape, coords, nodes, lo, hi, vec01, vec12, stats


def test_node_agg_scan_kernel_against_jax_and_host_oracle():
    shape, coords, nodes, lo, hi, vec01, vec12, stats = _node_inputs()
    c, m = len(coords), len(nodes)
    chunk = 400
    assert c > 3 * chunk  # four chunks
    args = (T(lo), T(hi), T(nodes.astype(np.float32)), T(coords.astype(np.int32)),
            T(vec01), T(vec12), T(stats), chunk)
    node_sums, stat_sums = (x.numpy() for x in hier._node_agg_scan_kernel(*args))

    n_chunks = -(-c // chunk)

    def chunked(arr, fill):
        out = np.full((n_chunks * chunk,) + arr.shape[1:], fill, arr.dtype)
        out[:c] = arr
        return out.reshape((n_chunks, chunk) + arr.shape[1:])

    stats_pad = np.full((stats.shape[0], n_chunks * chunk), np.nan, np.float32)
    stats_pad[:, :c] = stats
    j_node, j_stat = (np.asarray(x, np.float64) for x in j_hier._node_agg_scan_kernel(
        lo, hi, nodes.astype(np.float32), chunked(coords.astype(np.int32), -1),
        chunked(vec01, np.nan), chunked(vec12, np.nan),
        np.moveaxis(stats_pad.reshape(stats.shape[0], n_chunks, chunk), 1, 0)))
    for i in (0, 2, 4):  # counts
        np.testing.assert_array_equal(node_sums[i], j_node[i])
    np.testing.assert_allclose(node_sums, j_node, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(stat_sums[0], j_stat[0])
    np.testing.assert_array_equal(stat_sums[2:4], j_stat[2:4])  # min, max
    np.testing.assert_allclose(stat_sums[1], j_stat[1], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(stat_sums[4], j_stat[4], rtol=1e-4, atol=1e-4)

    conv, div, coord_means, vox_agg = hier._node_aggregate(*args)
    node_level = object.__new__(j_hier._NodeLevel)
    node_level.nodes, node_level.t = nodes, 0
    vox = types.SimpleNamespace(coords=coords, vec01=vec01, vec12=vec12, stats=stats)
    w_conv, w_div, w_means, w_agg = node_level._host_aggregate(
        types.SimpleNamespace(), lo, hi, vox, m)
    _nan_close(conv, w_conv, msg="convergence")
    _nan_close(div, w_div, msg="divergence")
    _nan_close(coord_means, w_means, msg="coordinate means")
    for key in segstats.STAT_KEYS:
        _nan_close(vox_agg[key], w_agg[key], msg=key)


def test_host_box_pairs_against_jax():
    shape, coords, _, lo, hi, *_ = _node_inputs(7)
    got = hier._host_box_pairs(lo, hi, coords, shape)
    want = j_hier._host_box_pairs(lo, hi, coords, shape)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) > 0


def test_border_distance_against_jax():
    rng = np.random.default_rng(8)
    border = np.zeros((10, 16, 16), bool)
    border[0] = True
    border[5, 8, 3] = True
    border[rng.random(border.shape) < 0.01] = True
    coords = rng.integers(0, (10, 16, 16), (500, 3))
    got = hier.border_distance(border, coords, SPACING, "cpu")
    want = j_hier.border_distance(border, coords, SPACING)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the stage, on the JAX package's artifacts
# ---------------------------------------------------------------------------

def _outputs(im_info, skip_nodes):
    pp = im_info.pipeline_paths
    tables = {k: D.read_features(pp[f"features_{k}"]) for k in D.FEATURE_TABLES
              if not (skip_nodes and k == "nodes")}
    return tables, D.read_adjacency(pp["adjacency_maps"])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's six stages, then its Hierarchy with and without
    the node level (outputs read back after each run)."""
    im_info = D.open_im_info(D.write_input(tmp_path_factory.mktemp("jax"), D.tube_series()))
    for stage in (JFilter, JLabel, JNetwork, JMarkers, JTracking, JReassigner):
        stage(im_info, device="cpu").run()
    outputs = {}
    for skip_nodes in (False, True):
        j_hier.Hierarchy(im_info, skip_nodes=skip_nodes, device="cpu").run()
        outputs[skip_nodes] = _outputs(im_info, skip_nodes)
    return im_info, outputs


@pytest.fixture(scope="module")
def port_outputs(reference, tmp_path_factory):
    ref, _ = reference
    outputs = {}
    for skip_nodes in (False, True):
        port = D.open_im_info(D.write_input(tmp_path_factory.mktemp("port"), D.tube_series()))
        D.copy_artifacts(ref, port, D.HIERARCHY_INPUTS)
        hier.Hierarchy(port, skip_nodes=skip_nodes, device="cpu").run()
        outputs[skip_nodes] = _outputs(port, skip_nodes)
    return outputs


@pytest.mark.parametrize("skip_nodes", [False, True], ids=["nodes", "skip_nodes"])
@pytest.mark.parametrize("table", D.FEATURE_TABLES)
def test_stage_feature_tables(reference, port_outputs, skip_nodes, table):
    want = reference[1][skip_nodes][0]
    got = port_outputs[skip_nodes][0]
    assert set(got) == set(want)
    if table not in want:
        assert skip_nodes and table == "nodes"
        return
    assert len(want[table]) > 0
    D.assert_features_equal(want[table], got[table], f"{table} skip_nodes={skip_nodes}")


@pytest.mark.parametrize("skip_nodes", [False, True], ids=["nodes", "skip_nodes"])
def test_stage_adjacency(reference, port_outputs, skip_nodes):
    want = reference[1][skip_nodes][1]
    D.assert_adjacency_equal(want, port_outputs[skip_nodes][1])
    assert len(want["v_n"]) == (0 if skip_nodes else 3)


def test_branch_reference_voxels_identical(reference):
    """The flow the motility bundle starts from is equal bit for bit, so
    the per-branch voxel of minimum |flow| is the same voxel."""
    ref, _ = reference
    labels, branches = D.read(ref, "im_instance_label"), D.read(ref, "im_skel_relabelled")
    norm = jax.jit(lambda v: jnp.linalg.norm(v * SPACING[None], axis=1))
    argmin = jax.jit(j_hier._segment_argmin, static_argnums=2)
    checked = 0
    for forward, frames in ((True, (0, 1)), (False, (1, 2))):
        j_interp = j_fi.FlowInterpolator(ref, forward=forward)
        p_interp = FlowInterpolator(ref, forward=forward, device="cpu")
        for t in frames:
            coords = np.argwhere(labels[t] > 0).astype(np.float32)
            lbl = branches[t][labels[t] > 0].astype(np.int32)
            num = int(lbl.max()) + 1
            want = np.asarray(j_interp.interpolate_coord(coords, t))
            got = p_interp.interpolate_coord_dev(coords, t)
            np.testing.assert_array_equal(got.numpy(), want)
            euc = sqrt(reduce_sum_of_squares(got * T(SPACING)[None]))
            ref_idx = np.asarray(argmin(norm(want), lbl, num))
            np.testing.assert_array_equal(hier._segment_argmin(euc, T(lbl), num).numpy(), ref_idx)
            checked += int((ref_idx >= 0).sum())
    assert checked >= 10  # one per branch and frame direction


def test_stage_empty_frame(reference, tmp_path):
    """A frame without objects gives rows in no table but the image's, and
    the tables still carry their headers."""
    ref, _ = reference
    copies = []
    for name in ("jax", "port"):
        im_info = D.open_im_info(D.write_input(tmp_path / name, D.tube_series()))
        D.copy_artifacts(ref, im_info, D.HIERARCHY_INPUTS)
        for art in ("im_instance_label", "im_skel", "im_pixel_class", "im_skel_relabelled",
                    "im_branch_label_reassigned", "im_obj_label_reassigned"):
            mm = im_info.get_memmap(im_info.pipeline_paths[art], read_mode="r+")
            mm[1] = 0
            mm.flush()
            im_info._invalidate_memmap(im_info.pipeline_paths[art])
        copies.append(im_info)
    j_hier.Hierarchy(copies[0], skip_nodes=False, device="cpu").run()
    hier.Hierarchy(copies[1], skip_nodes=False, device="cpu").run()
    want, want_adj = _outputs(copies[0], False)
    got, got_adj = _outputs(copies[1], False)
    for table in want:
        D.assert_features_equal(want[table], got[table], table)
    assert not (got["voxels"]["t"] == 1).any() and (got["image"]["t"] == 1).sum() == 1
    D.assert_adjacency_equal(want_adj, got_adj)


def test_csv_writer_formats(tmp_path):
    path = tmp_path / "f.csv"
    data = {"t": np.array([0, 0], np.int64), "label": np.array([3, 4], np.int64),
            "a_raw": np.array([0.1, np.nan], np.float32), "b_raw": np.array([1.0 / 3, -2.5])}
    hier._write_csv_rows(path, data, first=True)
    hier._write_csv_rows(path, {k: v[:0] for k, v in data.items()}, first=False)
    hier._write_csv_rows(path, data, first=False)
    lines = path.read_text().splitlines()
    assert lines[0] == "t,label,a_raw,b_raw"
    assert len(lines) == 5
    t, label, a, b = lines[2].split(",")
    assert (t, label, a) == ("0", "4", "")
    assert float(b) == -2.5
    assert float(lines[1].split(",")[2]) == float(np.float32(0.1))
    assert float(lines[1].split(",")[3]) == 1.0 / 3


def test_worker_reraises_first_error():
    worker = hier._AsyncWorker()
    ran = []
    worker.submit(lambda: ran.append(1))
    worker.submit(lambda: 1 / 0)
    worker.submit(lambda: ran.append(2))
    with pytest.raises(ZeroDivisionError):
        worker.close()
    assert ran == [1]


def test_low_memory_and_cuda_without_gpu_raise(reference):
    """``low_memory`` is accepted and quarters the node-mask budget; a CUDA
    request without a GPU raises."""
    ref, _ = reference
    assert hier.Hierarchy(ref, low_memory=True, device="cpu").low_memory
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            hier.Hierarchy(ref, device="cuda")
