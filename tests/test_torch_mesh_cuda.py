"""The mesh path and the XLA pow mirror on the card, against one device and
against the CPU.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_mesh_cuda.py

* Logical shards: ``make_mesh(devices=["cuda:0"] * 4)`` lists the card
  four times; ``run(mesh=)`` on a small 3D series (2 x 2) and a small 2D
  series (1 x 4) writes every file of the one-device run byte for byte,
  and capacity's mesh strategy gives the one-window monolith's labels.
* Two cards (skipped below two): the same 3D run over a 2 x 1 mesh of
  ``cuda:0`` and ``cuda:1``.
* ``_fp.pow`` on the card equals ``_fp.pow`` on the CPU bit for bit at the
  Hu normalisation's exponents (10**6 values): the flow costs then agree
  across devices.
"""
import filecmp
import os

import numpy as np
import pytest
import torch

from nellie_tpu_torch.io import FileInfo, ome, tiff
from nellie_tpu_torch.kernels import _fp
from nellie_tpu_torch.kernels.frangi import FrangiParams
from nellie_tpu_torch.mesh import make_mesh
from nellie_tpu_torch.pipeline import capacity
from nellie_tpu_torch.pipeline.run import run


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def series(shape, seed=0):
    """Drifting tubes on noise: (T, Z, Y, X) or (T, Y, X) uint16."""
    rng = np.random.default_rng(seed)
    t_n, *frame = shape
    grid = np.mgrid[tuple(slice(0, s) for s in frame)].astype(np.float64)
    y, x = grid[-2], grid[-1]
    frames = []
    for t in range(t_n):
        r2 = (y - 0.3 * frame[-2] - t - 5 * np.sin(x / 9.0)) ** 2
        if len(frame) == 3:
            r2 = r2 + (grid[0] - frame[0] / 2) ** 2
        frames.append(np.clip(900.0 * np.exp(-r2 / (2 * 2.6 ** 2))
                              + rng.normal(100, 5, frame), 0, None))
    return np.stack(frames).astype(np.uint16)


def write(directory, data):
    axes = "TZYX" if data.ndim == 4 else "TYX"
    res = ({"X": 0.2, "Y": 0.2, "Z": 0.5, "T": 1.0} if data.ndim == 4
           else {"X": 0.1, "Y": 0.1, "Z": None, "T": 1.0})
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(str(directory), "series.ome.tif")
    tiff.imwrite(path, data, description=ome.build_ome_xml(axes, data.shape, "uint16",
                                                           dim_res=res))
    fi = FileInfo(path)
    fi.find_metadata()
    fi.load_metadata()
    return fi


def assert_same_files(a, b):
    fa = {k: p for k, p in a.pipeline_paths.items() if os.path.exists(p)}
    fb = {k: p for k, p in b.pipeline_paths.items() if os.path.exists(p)}
    assert fa and sorted(fa) == sorted(fb)
    differ = [k for k in fa if not filecmp.cmp(fa[k], fb[k], shallow=False)]
    assert not differ, differ


@pytest.mark.gpu
@pytest.mark.parametrize("shape, t, z", [((3, 12, 48, 48), 2, 2), ((3, 64, 64), 1, 4)])
def test_logical_shards_equal_one_device(cuda, tmp_path, shape, t, z):
    data = series(shape)
    one = run(write(tmp_path / "one", data), device=cuda)
    mesh = run(write(tmp_path / "mesh", data),
               mesh=make_mesh(devices=[cuda] * (t * z), t_axis=t))
    assert_same_files(one, mesh)


@pytest.mark.gpu
def test_two_cards_equal_one_device(cuda, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    data = series((3, 12, 48, 48))
    one = run(write(tmp_path / "one", data), device=cuda)
    mesh = run(write(tmp_path / "mesh", data), mesh=make_mesh(2, t_axis=2))
    assert_same_files(one, mesh)


@pytest.mark.gpu
def test_capacity_mesh_on_the_card(cuda):
    vol = series((1, 24, 64, 64))[0]
    params = FrangiParams(sigmas=(0.75, 0.95), spacing=(0.5, 0.2, 0.2), z_ratio=2.5)
    mono = capacity.segment_volume(vol, params, emit="labels", strategy="monolith",
                                   max_chunk_voxels=vol.size, device=cuda)
    got = capacity.segment_volume(vol, params, emit="labels",
                                  mesh=make_mesh(devices=[cuda] * 4))
    assert got["strategy"] == "mesh" and got["n_labels"] == mono["n_labels"] > 0
    np.testing.assert_array_equal(got["labels"], mono["labels"])


@pytest.mark.gpu
@pytest.mark.parametrize("exponent", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0])
def test_pow_card_equals_cpu(cuda, exponent):
    rng = np.random.default_rng(int(exponent * 10))
    x = torch.from_numpy((10 ** rng.uniform(-3, 9, 1_000_000)).astype(np.float32))
    x[:6] = torch.tensor([0.0, 1.0, 2.0, 1e-40, float("inf"), 3.4e38])
    cpu = _fp.pow(x, exponent)
    card = _fp.pow(x.to(cuda), exponent).cpu()
    assert torch.equal(card.view(torch.int32), cpu.view(torch.int32))
