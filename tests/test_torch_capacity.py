"""The port's capacity path (``nellie_tpu_torch.pipeline.capacity``) against
the JAX package's, on the CPU: the monolith strategy.

The same seeded uint16 volume goes through ``segment_volume`` of both
packages.  Labels, ``n_labels``, ``fg_count``, the mask bits and the
transfer byte counts must be equal, for each emit, with the raw volume
on the device and with per-window uploads; past 65,535 labels the
monolith reruns through the chunked strategy; the strategy choice and
its refusals.  The port's copies of ``utils/chunking.py`` and of the bit
packing of ``utils/transfer.py`` are held to the originals.  The chunked
strategy is in ``tests/test_torch_capacity_chunked.py``.
"""
import numpy as np
import pytest
import torch

from torch_port_data import one_torch_thread  # noqa: F401 — autouse
from nellie_tpu.kernels import frangi as j_frangi
from nellie_tpu.pipeline import capacity as j_cap
from nellie_tpu.utils import chunking as j_chunking
from nellie_tpu.utils import transfer as j_transfer
from nellie_tpu_torch.kernels import frangi
from nellie_tpu_torch.mesh import make_mesh
from nellie_tpu_torch.pipeline import capacity
from nellie_tpu_torch.utils import chunking, transfer

PARAMS = dict(sigmas=(0.75, 0.95), spacing=(0.5, 0.2, 0.2), z_ratio=2.5)
KW = dict(min_area=4, max_chunk_voxels=16 * 64 * 64)  # four vesselness windows
EMITS = ("labels", "sparse_labels", "mask")
KEYS = ("n_labels", "fg_count", "label_overflow", "emit", "strategy", "bytes_up", "bytes_down")


def tube_volume(shape=(24, 64, 64), seed=0):
    """One wavy tube on noise (the JAX package's chunked-capacity input)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    tube = 800.0 * np.exp(-(((z - 12) ** 2) * 0.3 + (y - 32 + 6 * np.sin(x / 8.0)) ** 2 / 2)
                          / (2 * 2.0 ** 2))
    return np.clip(tube + rng.normal(100, 5, shape), 0, 65535).astype(np.uint16)


def assert_same_result(ref, got):
    for key in KEYS:
        if key in ref:
            assert got[key] == ref[key], (key, got[key], ref[key])
    if "labels" in ref:
        assert got["labels"].dtype == ref["labels"].dtype
        np.testing.assert_array_equal(got["labels"], ref["labels"])
    else:
        np.testing.assert_array_equal(got["mask_packed"], ref["mask_packed"])


@pytest.fixture(scope="module")
def jax_monolith():
    vol = tube_volume()
    return {emit: j_cap.segment_volume(vol, j_frangi.FrangiParams(**PARAMS), emit=emit,
                                       strategy="monolith", **KW) for emit in EMITS}


@pytest.mark.parametrize("shape,max_vox,halo", [
    ((24, 64, 64), 16 * 64 * 64, (2, 5, 5)), ((37, 300, 260), 200_000, (3, 7, 7)),
    ((1024, 1024, 1024), int(3.2e7), (5, 5, 5)), ((130, 250), 5000, (4, 4)),
    ((12, 48, 48), None, (1, 1, 1))])
def test_chunking_windows_equal_jax(shape, max_vox, halo):
    chunk = chunking.compute_chunk_shape(shape, max_vox)
    assert chunk == j_chunking.compute_chunk_shape(shape, max_vox)
    assert (chunking.uniform_window_shapes(shape, chunk, halo)
            == j_chunking.uniform_window_shapes(shape, chunk, halo))
    assert (list(chunking.iter_uniform_windows(shape, chunk, halo))
            == list(j_chunking.iter_uniform_windows(shape, chunk, halo)))
    if np.prod(shape) < 1e7:
        vol = np.random.default_rng(0).random(shape, dtype=np.float32)
        core, _ = chunking.uniform_window_shapes(shape, chunk, halo)
        for _, ext, offset, _ in list(chunking.iter_uniform_windows(shape, chunk, halo))[:3]:
            np.testing.assert_array_equal(
                chunking.crop_core(torch.from_numpy(vol[ext]), offset, core).numpy(),
                np.asarray(j_chunking.crop_core(vol[ext], np.asarray(offset), core)))


def test_packbits_equals_jax():
    fg = np.random.default_rng(3).random(8 * 1001) < 0.3
    got = transfer.packbits(torch.from_numpy(fg)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_transfer.packbits(fg)))
    np.testing.assert_array_equal(np.unpackbits(got, bitorder="little").astype(bool), fg)
    assert transfer.SPARSE_CAP_DIV == j_transfer.SPARSE_CAP_DIV


@pytest.mark.parametrize("emit", EMITS)
def test_monolith_equals_jax(jax_monolith, emit):
    got = capacity.segment_volume(tube_volume(), frangi.FrangiParams(**PARAMS), emit=emit,
                                  strategy="monolith", device="cpu", **KW)
    assert got["raw_resident"] and got["n_labels" if emit != "mask" else "fg_count"] > 0
    assert_same_result(jax_monolith[emit], got)


def test_per_window_uploads_give_the_same_result(jax_monolith, monkeypatch):
    """Where the raw volume would not fit, windows are uploaded one by one:
    the same labels, with the halos' overlap in ``bytes_up``."""
    monkeypatch.setattr(capacity, "_raw_fits", lambda *args: False)
    vol = tube_volume()
    got = capacity.segment_volume(vol, frangi.FrangiParams(**PARAMS), emit="labels",
                                  strategy="monolith", device="cpu", **KW)
    assert not got["raw_resident"]
    np.testing.assert_array_equal(got["labels"], jax_monolith["labels"]["labels"])
    sigma = j_frangi.FrangiParams(**PARAMS).sigma_vec(max(PARAMS["sigmas"]))
    halo = tuple(int(np.ceil(3.0 * s)) for s in sigma)
    chunk = chunking.compute_chunk_shape(vol.shape, KW["max_chunk_voxels"])
    windows = list(chunking.iter_uniform_windows(vol.shape, chunk, halo))
    assert len(windows) > 1
    assert got["bytes_up"] == sum(vol[ext].nbytes for _, ext, _, _ in windows) > vol.nbytes


def test_monolith_past_65535_labels_reruns_chunked(jax_monolith, monkeypatch):
    """A label count past uint16 sends the monolith through the chunked
    strategy, whose host assembly holds any count."""
    original = capacity._segment_from_vessel

    def overflowing(*args):
        out, _ = original(*args)
        return out, 0x10000

    monkeypatch.setattr(capacity, "_segment_from_vessel", overflowing)
    got = capacity.segment_volume(tube_volume(), frangi.FrangiParams(**PARAMS), emit="labels",
                                  strategy="monolith", device="cpu", **KW)
    assert got["strategy"] == "chunked"
    np.testing.assert_array_equal(got["labels"], jax_monolith["labels"]["labels"])


def test_strategy_choice_and_refusals():
    vol = tube_volume(shape=(16, 32, 32), seed=2)
    params = frangi.FrangiParams(**PARAMS)
    assert capacity.segment_volume(vol, params, min_area=4, monolith_max_voxels=8 * 32 * 32,
                                   device="cpu")["strategy"] == "chunked"
    assert capacity.segment_volume(vol, params, min_area=4, device="cpu")["strategy"] == "monolith"
    # a mesh of one device changes nothing; of more, it takes the mesh strategy
    # (held to the monolith in tests/test_torch_mesh.py)
    assert capacity.segment_volume(vol, params, min_area=4, device="cpu",
                                   mesh=make_mesh(devices=["cpu"]))["strategy"] == "monolith"
    assert capacity.segment_volume(vol, params, min_area=4,
                                   mesh=make_mesh(devices=["cpu"] * 2))["strategy"] == "mesh"
    with pytest.raises(ValueError, match="strategy"):
        capacity.segment_volume(vol, params, strategy="tiled", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            capacity.segment_volume(vol, params)
