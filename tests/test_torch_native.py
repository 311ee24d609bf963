"""The port's native TIFF codec (``nellie_tpu_torch/native``) against the
JAX package's and against the port's own Python decoders.

The cases of ``tests/test_native.py`` (LZW strips written by PIL, large
incompressible LZW, PackBits, the horizontal predictor, the threaded batch
strip decoder) decode byte for byte as the JAX package's native module
and the Python decoders decode them; whole LZW, PackBits and predictor
files read through the port's reader equal the JAX reader's.  The C++
source is a copy of the JAX package's; the library is built at first use
into ``nellie_tpu_torch/_build/`` and is never committed; without ``g++``
the reader falls back to its Python decoders with one warning.
"""
import logging
import os
import subprocess

import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

from nellie_tpu import native as j_native
from nellie_tpu.io import tiff as j_tiff
from nellie_tpu_torch import native
from nellie_tpu_torch.io import tiff

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def built():
    assert native.available(), native.status()
    assert j_native.available()
    return native


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _save(path, data, compression, predictor=False):
    info = TiffImagePlugin.ImageFileDirectory_v2()
    if predictor:
        info[317] = 2
    Image.fromarray(data).save(path, format="TIFF", compression=compression, tiffinfo=info)
    return path


def _strips(path, data):
    """(encoded strip, its decoded bytes) of every strip of ``path``."""
    strips = []
    with tiff.TiffFile(path) as tf:
        page = tf.pages[0]
        offs = tiff._as_tuple(page.tag_value(273))
        cnts = tiff._as_tuple(page.tag_value(279))
        rows_per_strip = int(page.tag_value(278, page.shape[0]))
    with open(path, "rb") as f:
        row = 0
        for o, c in zip(offs, cnts):
            f.seek(int(o))
            nrows = min(rows_per_strip, data.shape[0] - row)
            strips.append((f.read(int(c)), data[row:row + nrows].tobytes()))
            row += nrows
    return strips


def test_cpp_is_a_copy_of_the_original():
    with open(os.path.join(ROOT, "nellie_tpu", "native", "tiff_codec.cpp"), "rb") as f:
        original = f.read()
    with open(os.path.join(ROOT, "nellie_tpu_torch", "native", "tiff_codec.cpp"), "rb") as f:
        assert f.read() == original


def test_native_builds_into_the_build_directory(built):
    status = native.status()
    assert status["decoder"] == "native" and status["error"] is None
    path = status["library"]
    assert os.path.dirname(path) == os.path.join(ROOT, "nellie_tpu_torch", "_build")
    assert os.path.basename(path).startswith("libnellie_tiff_codec_") and os.path.exists(path)
    tracked = subprocess.run(["git", "ls-files", "nellie_tpu_torch"], cwd=ROOT,
                             capture_output=True, text=True).stdout.split()
    assert not [p for p in tracked if p.endswith(".so")]


@pytest.mark.parametrize("high, shape", [(16, (64, 80)), (256, (256, 300))])
def test_lzw_decoders_match(built, tmp_path, rng, high, shape):
    """PIL's strips (small values, then large random data that forces table
    resets and the widest codes): native = JAX native = Python = truth."""
    data = rng.integers(0, high, shape, dtype=np.uint8)
    for raw, truth in _strips(_save(tmp_path / "lzw.tif", data, "tiff_lzw"), data):
        got = native.lzw_decode(raw, len(truth))
        assert got == truth == j_native.lzw_decode(raw, len(truth)) == tiff._lzw_decode(raw)


def test_packbits_decoders_match(built, tmp_path, rng):
    raw = bytes([0, 5, 255, 7, 254, 9, 2, 1, 2, 3])
    py = tiff._packbits_decode(raw)
    assert native.packbits_decode(raw, len(py)) == j_native.packbits_decode(raw, len(py)) == py
    data = np.repeat(rng.integers(0, 4, (40, 10), dtype=np.uint8), 8, axis=1)
    for raw, truth in _strips(_save(tmp_path / "pb.tif", data, "packbits"), data):
        assert native.packbits_decode(raw, len(truth)) == tiff._packbits_decode(raw) == truth


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32])
def test_undo_predictor(built, dtype):
    original = np.random.default_rng(0).integers(0, 1000, (4, 100)).astype(dtype)
    diffed = original.copy()
    diffed[:, 1:] = np.diff(original, axis=1)
    ours, theirs = diffed.copy(), diffed.copy()
    assert native.undo_predictor(ours) and j_native.undo_predictor(theirs)
    np.testing.assert_array_equal(ours, original)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(np.cumsum(diffed, axis=1, dtype=dtype), original)


@pytest.mark.parametrize("compression, code", [("tiff_lzw", 5), ("packbits", 32773)])
def test_decode_strips_parallel(built, tmp_path, rng, compression, code):
    data = rng.integers(0, 8, (256, 128), dtype=np.uint8)
    strips = _strips(_save(tmp_path / "s.tif", data, compression), data)
    encoded = [raw for raw, _ in strips]
    sizes = [len(truth) for _, truth in strips]
    args = (b"".join(encoded), np.cumsum([0] + [len(e) for e in encoded[:-1]]),
            [len(e) for e in encoded])
    dst_args = (np.cumsum([0] + sizes[:-1]), sizes)
    ours, theirs = np.zeros(sum(sizes), np.uint8), np.zeros(sum(sizes), np.uint8)
    assert native.decode_strips(*args, ours, *dst_args, compression=code, n_threads=4)
    assert j_native.decode_strips(*args, theirs, *dst_args, compression=code, n_threads=4)
    assert ours.tobytes() == theirs.tobytes() == b"".join(t for _, t in strips)


CASES = {
    "lzw": (np.uint8, "tiff_lzw", False),
    "packbits": (np.uint8, "packbits", False),
    "lzw_predictor_u16": (np.uint16, "tiff_lzw", True),
    "lzw_predictor_u8": (np.uint8, "tiff_lzw", True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_reader_native_and_python_paths_equal(built, tmp_path, rng, monkeypatch, case):
    """Whole files through the port's reader: the native batch path, the
    Python strip loop and the JAX reader give the same array."""
    dtype, compression, predictor = CASES[case]
    data = (np.cumsum(rng.integers(0, 40, (96, 70)), axis=1) % 250).astype(dtype)
    path = _save(tmp_path / "f.tif", data, compression, predictor)
    before = native.status()["decoded"]["native"]
    fast = tiff.imread(path)
    assert native.status()["decoded"]["native"] > before
    np.testing.assert_array_equal(fast, data)
    np.testing.assert_array_equal(fast, j_tiff.imread(path))
    disabled = native._Codec()
    disabled.tried = True
    monkeypatch.setattr(native, "CODEC", disabled)
    slow = tiff.imread(path)
    assert native.status()["decoder"] == "python" and disabled.decoded["python"] > 0
    assert fast.tobytes() == slow.tobytes()


def test_without_gxx_the_reader_decodes_in_python(tmp_path, rng, monkeypatch, caplog):
    monkeypatch.setattr(native, "CODEC", native._Codec(build_dir=str(tmp_path / "build")))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    data = rng.integers(0, 16, (32, 40), dtype=np.uint8)
    path = _save(tmp_path / "f.tif", data, "tiff_lzw")
    with caplog.at_level(logging.WARNING, logger="nellie_tpu_torch"):
        np.testing.assert_array_equal(tiff.imread(path), data)
        np.testing.assert_array_equal(tiff.imread(path), data)
    warnings = [r for r in caplog.records if "native TIFF codec unavailable" in r.message]
    assert len(warnings) == 1
    status = native.status()
    assert status["decoder"] == "python" and "g++" in status["error"]
    assert status["decoded"]["python"] == 2


def test_decode_strips_checks_its_buffers(built):
    dst = np.zeros(8, np.uint8)
    with pytest.raises(ValueError):
        native.decode_strips(b"\x00" * 4, [0], [4], dst, [6], [4], 32773)
    with pytest.raises(ValueError):
        native.decode_strips(b"\x00" * 4, [2], [4], dst, [0], [4], 32773)
    with pytest.raises(ValueError):
        native.decode_strips(b"\x00" * 4, [0], [4], dst[::2], [0], [4], 32773)
