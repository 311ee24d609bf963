"""The port's multi-device path (``nellie_tpu_torch.mesh``) on logical CPU
shards: ``make_mesh(devices=["cpu"] * k)`` lists the CPU k times, so every
halo block, gathered statistic and cross-shard merge runs as on k cards.

* Against the port's own single-device results, exactly: the sharded
  vesselness (3D with a halo deeper than one shard, and 2D), the segment
  step at t = 2, z = 4, ``run(mesh=)`` (fused in 3D, where T = 3 on a
  2 x 2 mesh pads one frame, and per stage in 2D): every file of
  ``nellie_output`` byte for byte; ``run_files`` through the CLI's
  ``--mesh`` and on single-timepoint files, against each file's own
  ``run()``; capacity's mesh strategy against a one-window monolith, and
  its logged routes.
* Against the JAX package's mesh functions on its 8-device CPU mesh, at the
  bars of ``tests/test_mesh.py`` and ``tests/test_halo.py``: ``make_mesh``,
  ``make_hybrid_mesh``, the shard axis, ``parse_mesh``, the halo exchange,
  ``sharded_vesselness`` and ``sharded_segment_step``.  The fused chain's
  mesh path against the JAX package's is in
  ``tests/test_torch_mesh_reference.py``, marked slow as the JAX package's
  own whole-chain mesh tests are.

The whole runs use a few planes and pixels, each frame and volume under
torch's 32,768-element grain, and the module runs torch on one intra-op
thread (``torch_port_data.one_torch_thread``): the comparisons with one
device hold at any size and thread count, and the suite shares the
machine's cores and its time limit with five other workers.
"""
import glob
import hashlib
import logging
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec

import torch_port_data as D
from torch_port_data import one_torch_thread  # noqa: F401 — autouse
from nellie_tpu.kernels import frangi as j_frangi
from nellie_tpu.kernels.filters import sum_filter as j_sum_filter
from nellie_tpu.mesh import make_hybrid_mesh as j_make_hybrid_mesh
from nellie_tpu.mesh import make_mesh as j_make_mesh
from nellie_tpu.mesh import sharded_segment_step as j_sharded_segment_step
from nellie_tpu.mesh import sharded_vesselness as j_sharded_vesselness
from nellie_tpu.mesh.halo import halo_exchange_apply as j_halo_exchange_apply
from nellie_tpu.mesh.sharded import frame_sharding as j_frame_sharding
from nellie_tpu.pipeline.cli import parse_mesh as j_parse_mesh
from nellie_tpu_torch.kernels import frangi
from nellie_tpu_torch.kernels.filters import sum_filter
from nellie_tpu_torch.mesh import cells, make_hybrid_mesh, make_mesh, sharded
from nellie_tpu_torch.mesh.halo import halo_exchange_apply
from nellie_tpu_torch.pipeline import capacity
from nellie_tpu_torch.pipeline.batch import run_files
from nellie_tpu_torch.pipeline.cli import parse_mesh
from nellie_tpu_torch.pipeline.run import run

PARAMS = dict(sigmas=(0.75, 0.95), spacing=(0.5, 0.2, 0.2), z_ratio=2.5)
PARAMS_2D = dict(sigmas=(0.75, 1.1), spacing=(0.1, 0.1))


def cpu_mesh(t, z):
    return make_mesh(devices=["cpu"] * (t * z), t_axis=t)


def tube(shape=(16, 32, 32), seed=0):
    """``tests/test_mesh.py``'s input."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    tube = 800.0 * np.exp(-(((z - 8) ** 2) * 0.3 + (y - 16 + 4 * np.sin(x / 6.0)) ** 2 / 2)
                          / (2 * 2.0 ** 2))
    return np.clip(tube + rng.normal(100, 5, shape), 0, None).astype(np.float32)


def outputs(directory):
    """sha256 of every file under ``directory``'s ``nellie_output``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(str(directory), "nellie_output", "**", "*"),
                                 recursive=True)):
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[os.path.relpath(path, str(directory))] = hashlib.sha256(f.read()).hexdigest()
    return out


def assert_same_outputs(a_dir, b_dir):
    a, b = outputs(a_dir), outputs(b_dir)
    assert a and sorted(a) == sorted(b)
    differ = [k for k in a if a[k] != b[k]]
    assert not differ, f"files differ: {differ}"


# -- the mesh and its shard plans ---------------------------------------------

def test_make_mesh_shapes_as_the_jax_package():
    for n, t_axis in ((8, 1), (8, 2), (8, 8), (6, 4), (8, 3)):
        m = make_mesh(devices=["cpu"] * n, t_axis=t_axis)
        assert m.axis_names == ("t", "z") == j_make_mesh(n, t_axis=t_axis).axis_names
        assert m.shape == dict(j_make_mesh(n, t_axis=t_axis).shape)
        assert m.devices.size == n and all(d == torch.device("cpu") for d in m.flat())
    assert make_mesh(2, t_axis=2, devices=["cpu"] * 8).shape == {"t": 2, "z": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh()


def test_make_hybrid_mesh_is_the_flat_mesh_on_one_host():
    m = make_hybrid_mesh(t_axis=2, devices=["cpu"] * 8)
    assert m.shape == cpu_mesh(2, 4).shape == dict(j_make_hybrid_mesh(t_axis=2).shape)


@pytest.mark.parametrize("shape, axis", [((16, 12, 9), 0), ((9, 12, 10), 1), ((9, 11, 13), None)])
def test_shard_plan_axis(shape, axis):
    """The first axis whose extent divides the z extent is split, as the
    JAX package's ``frame_sharding`` picks it; with none, the frame stays
    whole on the group's first device (``P()``)."""
    plan = sharded.frame_sharding(cpu_mesh(1, 4), shape)
    spec = j_frame_sharding(j_make_mesh(4), shape).spec
    assert plan.axis == (None if spec == PartitionSpec() else list(spec).index("z")) == axis
    if axis is None:
        assert plan.n == 1 and plan.bounds == ((0, shape[0]),)
    else:
        assert plan.bounds == tuple((k * shape[axis] // 4, (k + 1) * shape[axis] // 4)
                                    for k in range(4))


def test_shard_volume_and_batch_sharding():
    """Z split evenly over the z group (frames of a batch over the t rows),
    as ``P("z")`` and ``P("t", "z")`` place them; a Z that does not divide
    is refused."""
    vol = torch.arange(8 * 3 * 5, dtype=torch.float32).reshape(8, 3, 5)
    mesh = cpu_mesh(2, 4)
    shards = sharded.shard_volume(vol, mesh)
    assert [tuple(s.shape) for s in shards] == [(2, 3, 5)] * 4
    assert torch.equal(torch.cat(shards), vol)
    batch = sharded.shard_volume(torch.stack([vol, vol + 1]), mesh, batched=True)
    assert len(batch) == 2 and torch.equal(torch.cat(batch[1]), vol + 1)
    with pytest.raises(ValueError, match="divide evenly"):
        sharded.shard_volume(vol[:6], mesh)
    plans = sharded.batch_sharding(mesh, (8, 3, 5))
    assert len(plans) == 2 and all(p.axis == 0 and p.n == 4 for p in plans)


def test_parse_mesh():
    assert parse_mesh(None) is None and j_parse_mesh(None) is None
    for spec in ("8", "2x4"):
        assert parse_mesh(spec, device="cpu").shape == dict(j_parse_mesh(spec).shape)


# -- halo exchange --------------------------------------------------------------

def test_halo_exchange_sum_filter(rng):
    vol = rng.random((32, 16, 17)).astype(np.float32)
    out = halo_exchange_apply(lambda b: sum_filter(b, 3), vol, cpu_mesh(1, 8), halo=1)
    assert torch.equal(out, sum_filter(torch.from_numpy(vol), 3))
    ref = j_halo_exchange_apply(lambda b: j_sum_filter(b, 3), jnp.asarray(vol), j_make_mesh(8),
                                halo=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_halo_too_small_detectably_wrong(rng):
    vol = rng.random((32, 8, 9)).astype(np.float32)
    out = halo_exchange_apply(lambda b: sum_filter(b, 5), vol, cpu_mesh(1, 8), halo=1)
    assert not np.allclose(out.numpy(), sum_filter(torch.from_numpy(vol), 5).numpy())


def test_halo_validation(rng):
    mesh = cpu_mesh(1, 8)
    with pytest.raises(ValueError, match="divide evenly"):
        halo_exchange_apply(lambda b: b, rng.random((30, 8, 8)).astype(np.float32), mesh, 1)
    with pytest.raises(ValueError, match="halo"):
        halo_exchange_apply(lambda b: b, rng.random((32, 8, 8)).astype(np.float32), mesh, 5)


# -- sharded kernels --------------------------------------------------------------

def test_sharded_vesselness_3d_halo_deeper_than_a_shard():
    frame = tube()
    params = frangi.FrangiParams(**PARAMS)
    mesh = cpu_mesh(1, 8)
    plan = sharded.frame_sharding(mesh, frame.shape)
    assert sharded.filter_halo(params, plan, blob=False) > frame.shape[0] // 8
    got = sharded.sharded_vesselness(frame, params, mesh)
    single, _ = frangi.vesselness_frame(torch.from_numpy(frame), params)
    assert torch.equal(got, single)
    ref = j_sharded_vesselness(frame, j_frangi.FrangiParams(**PARAMS), j_make_mesh(8))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6)


def test_sharded_vesselness_2d():
    frame = D.tube_series_2d()[0].astype(np.float32)
    params = frangi.FrangiParams(**PARAMS_2D)
    got = sharded.sharded_vesselness(frame, params, cpu_mesh(1, 4))
    single, _ = frangi.vesselness_frame(torch.from_numpy(frame), params)
    assert torch.equal(got, single)
    ref = j_sharded_vesselness(frame, j_frangi.FrangiParams(**PARAMS_2D), j_make_mesh(8))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape", [(12, 20, 24), (10, 24, 20), (9, 11, 24), (9, 11, 13),
                                   (5, 7, 128), (36, 40), (9, 40)])
def test_filter_and_label_shards_on_every_split_axis(shape):
    """The flat strided sample, the Filter frame (with edge removal) and
    the Label tail on a frame split along Z, Y or X, or whole: the
    single-device results bit for bit, labels numbered as scipy numbers
    them."""
    from nellie_tpu_torch.kernels import ccl
    from nellie_tpu_torch.kernels.filters import uniform_filter

    rng = np.random.default_rng(len(shape))
    idx = np.indices(shape)
    frame = (rng.normal(100, 20, shape)
             + 900 * np.exp(-((idx[-2] - shape[-2] / 2 - 5 * np.sin(idx[-1] / 5.0)) ** 2) / 8.0))
    frame = np.clip(frame, 0, None).astype(np.float32)
    params = frangi.FrangiParams(
        **(PARAMS if len(shape) == 3 else PARAMS_2D), max_threshold_samples=500)
    plan = sharded.plan_frame([torch.device("cpu")] * 4, shape)
    shards = sharded.scatter(frame, plan)
    t = torch.from_numpy(frame)
    for step in (1, 7, 64):
        assert torch.equal(sharded.gather_flat_strided(shards, plan, step),
                           t.reshape(-1)[::step])
    got = sharded.gather(sharded.filter_shards(shards, plan, params, True, 500, True), plan)
    vessel, masks = frangi.vesselness_frame(t, params)
    if len(shape) == 2:
        vessel = torch.maximum(vessel, torch.clamp(frangi.log_blobness_2d(t, masks, params),
                                                   min=0.0))
    assert torch.equal(got, frangi.finalize_frame(frangi.remove_edges_frame(vessel), 500))

    mask = torch.from_numpy(rng.random(shape) < 0.45)
    labels, n = sharded.label_tail(sharded.scatter(mask, plan), plan, 4, len(shape) == 3)
    want = ccl.fill_holes(mask) if len(shape) == 3 else mask
    want, n_want = ccl.label(uniform_filter(ccl.remove_small_components(want, 4).float(), 3)
                             > 0.5)
    assert n == n_want > 1
    assert torch.equal(sharded.gather(labels, plan), want)


def test_sharded_segment_step_t2_z4():
    batch = np.stack([tube(seed=i) for i in range(2)])
    params = frangi.FrangiParams(**PARAMS)
    vessel, labels, counts = sharded.sharded_segment_step(batch, params, cpu_mesh(2, 4))
    for i in range(2):
        v, lab, n = sharded._segment_step(batch[i], params, 4)
        assert torch.equal(vessel[i], v) and torch.equal(labels[i], lab) and counts[i] == n
    j_vessel, j_labels, j_counts = j_sharded_segment_step(batch, j_frangi.FrangiParams(**PARAMS),
                                                          j_make_mesh(8, t_axis=2))
    assert labels.shape == j_labels.shape == batch.shape
    assert (labels > 0).any() and all(c >= 1 for c in counts) and all(int(c) >= 1 for c in j_counts)
    np.testing.assert_allclose(vessel.numpy(), np.asarray(j_vessel), rtol=1e-4, atol=1e-6)


# -- the pipeline over a mesh -----------------------------------------------------

# the series of the whole runs, cut to a few planes and pixels: the mesh
# runs are held to one device, at any size, and Z = 8 over z = 4 gives
# shards of two planes, shallower than the halo
SERIES = {
    "3d": (lambda: D.tube_series(shape=(3, 8, 32, 32)), None, "TZYX"),
    "2d": (lambda: D.tube_series_2d(shape=(3, 48, 48)), D.DIM_RES_2D, "TYX"),
    "2d shifted": (lambda: np.roll(D.tube_series_2d(shape=(3, 48, 48)), 5, axis=-1),
                   D.DIM_RES_2D, "TYX"),
}


@pytest.fixture(scope="module")
def single_runs(tmp_path_factory):
    """The port's one-device runs of each series."""
    out = {}
    for name, (make, res, axes) in SERIES.items():
        data = make()
        d = tmp_path_factory.mktemp("single")
        run(D.file_info(D.write_input(d, data, res, axes)), device="cpu")
        out[name] = (d, data, res, axes)
    return out


@pytest.mark.parametrize("series, t, z, fused", [("3d", 2, 2, True), ("2d", 1, 4, False)])
def test_run_over_a_mesh_equals_one_device(single_runs, tmp_path, series, t, z, fused):
    """``run(mesh=)``: the fused chain in 3D (a 2 x 2 mesh pads T = 3 to 4
    frames) and the stages one by one in 2D (Filter and Label split over
    z); tracking, the reassigner and the Hierarchy frame-parallel over the
    devices in both; every file byte for byte."""
    d, data, res, axes = single_runs[series]
    run(D.file_info(D.write_input(tmp_path, data, res, axes)), mesh=cpu_mesh(t, z), fused=fused)
    assert_same_outputs(d, tmp_path)


def test_run_files_equals_each_files_run(single_runs, tmp_path):
    """Two compatible files through the CLI with ``--mesh 2`` (a 2 x 1 mesh,
    which sends the folder through ``run_files``): each file's outputs
    those of its own ``run()``."""
    from nellie_tpu_torch.pipeline import cli

    singles = [single_runs[name] for name in ("2d", "2d shifted")]
    folder = tmp_path / "folder"
    folder.mkdir()
    for k, (_, data, res, axes) in enumerate(singles):
        os.rename(D.write_input(tmp_path / f"in{k}", data, res, axes),
                  folder / f"cells{k}.ome.tif")
    cli.main(["--directory", str(folder), "--device", "cpu", "--mesh", "2"])
    for k, (d, *_) in enumerate(singles):
        want = {p.replace("tubes", f"cells{k}"): h for p, h in outputs(d).items()}
        got = {p: h for p, h in outputs(folder).items() if f"cells{k}" in p}
        assert got and got == want


def test_run_files_single_timepoint_files(tmp_path):
    """Single-timepoint ZYX files batched over the t rows
    (``tests/test_mesh.py:277-321``)."""
    data = [D.tube_series(shape=(1, 8, 32, 32), seed=k)[0] for k in range(2)]
    for k, x in enumerate(data):
        run(D.file_info(D.write_input(tmp_path / f"single{k}", x, D.DIM_RES_ZYX, "ZYX")),
            device="cpu")
    paths = [D.write_input(tmp_path / f"batch{k}", x, D.DIM_RES_ZYX, "ZYX")
             for k, x in enumerate(data)]
    run_files([D.file_info(p) for p in paths], mesh=cpu_mesh(2, 2))
    for k in range(2):
        assert_same_outputs(tmp_path / f"single{k}", tmp_path / f"batch{k}")


# -- capacity's mesh strategy -------------------------------------------------------

def capacity_volume(shape=(12, 40, 48), seed=0):
    """``tests/test_torch_capacity.py``'s tube volume, cut to 12 x 40 x 48."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    tube = 800.0 * np.exp(-(((z - 6) ** 2) * 0.3 + (y - 20 + 6 * np.sin(x / 8.0)) ** 2 / 2)
                          / (2 * 2.0 ** 2))
    return np.clip(tube + rng.normal(100, 5, shape), 0, 65535).astype(np.uint16)


@pytest.mark.parametrize("emit", ["labels", "sparse_labels", "mask"])
def test_capacity_mesh_equals_the_one_window_monolith(emit):
    vol = capacity_volume()
    params = frangi.FrangiParams(**PARAMS)
    mono = capacity.segment_volume(vol, params, emit=emit, strategy="monolith",
                                   max_chunk_voxels=vol.size, device="cpu")
    got = capacity.segment_volume(vol, params, emit=emit, mesh=cpu_mesh(1, 4))
    assert got["strategy"] == "mesh" and got["emit"] == mono["emit"] == emit
    key = "mask_packed" if emit == "mask" else "labels"
    assert got[key].dtype == mono[key].dtype and np.array_equal(got[key], mono[key])
    for k in ("n_labels", "fg_count", "bytes_up", "bytes_down"):
        if k in mono:
            assert got[k] == mono[k], k
    assert emit == "mask" or got["n_labels"] > 0


def test_capacity_mesh_routes(monkeypatch, caplog):
    """No axis divides the z extent, or more than 65,535 components: the
    chunked strategy; past the sparse capacity: dense labels.  Each route
    is logged."""
    vol = capacity_volume()
    params = frangi.FrangiParams(**PARAMS)
    chunked = capacity.segment_volume(vol, params, emit="labels", strategy="chunked",
                                      device="cpu")
    mono = capacity.segment_volume(vol, params, emit="labels", strategy="monolith",
                                   max_chunk_voxels=vol.size, device="cpu")
    with caplog.at_level(logging.WARNING):
        got = capacity.segment_volume(vol, params, emit="labels", mesh=cpu_mesh(1, 7))
    assert got["strategy"] == "chunked" and "divides the mesh z extent" in caplog.text
    assert np.array_equal(got["labels"], chunked["labels"])

    label = cells.label
    monkeypatch.setattr(cells, "label", lambda mask, plan: (label(mask, plan)[0], 70_000))
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        got = capacity.segment_volume(vol, params, emit="labels", mesh=cpu_mesh(1, 4))
    assert got["strategy"] == "chunked" and "exceed the uint16 emit" in caplog.text
    monkeypatch.setattr(cells, "label", label)

    monkeypatch.setattr(capacity, "SPARSE_CAP_DIV", vol.size)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        got = capacity.segment_volume(vol, params, emit="sparse_labels", mesh=cpu_mesh(1, 4))
    assert got["emit"] == "labels" and "falling back to dense labels" in caplog.text
    assert np.array_equal(got["labels"], mono["labels"])
