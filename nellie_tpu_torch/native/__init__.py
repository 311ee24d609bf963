"""Native (C++) TIFF codec of the port's reader, loaded with ctypes.

``tiff_codec.cpp`` (a copy of the JAX package's, held to it by
``tests/test_torch_native.py``) decodes TIFF LZW and PackBits strips,
undoes the horizontal predictor and decodes many strips on several
threads.  It is built at first use with ``g++ -O3 -std=c++17 -shared
-fPIC -pthread`` into ``nellie_tpu_torch/_build/``, under a name that
carries a hash of the source and the flags, so a changed source builds
anew and nothing built is committed.

Without ``g++``, or when the build fails, the reader keeps its Python
decoders, which give the same bytes: one warning is logged, and
:func:`status` says why and counts the strips each decoder took.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from nellie_tpu_torch.utils.logger import logger

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiff_codec.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


class _Codec:
    """The library, built and loaded once per process, with the reason it
    is missing and the strips each decoder took."""

    def __init__(self, build_dir: str = _BUILD_DIR):
        self.build_dir = build_dir
        self.lib = None
        self.error = None
        self.tried = False
        self.decoded = {"native": 0, "python": 0}
        self._lock = threading.Lock()

    def library_path(self) -> str:
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
        return os.path.join(self.build_dir, f"libnellie_tiff_codec_{digest}.so")

    def _build(self, path: str) -> None:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found")
        os.makedirs(self.build_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
        os.close(fd)
        try:
            proc = subprocess.run([gxx, *_FLAGS, "-o", tmp, _SRC], capture_output=True,
                                  text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {_SRC}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def load(self):
        """The loaded library, built first if needed; None when it cannot be
        built or loaded (the reason is kept in ``error``)."""
        with self._lock:
            if self.lib is not None or self.tried:
                return self.lib
            self.tried = True
            path = self.library_path()
            try:
                if not os.path.exists(path):
                    self._build(path)
                lib = ctypes.CDLL(path)
            except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
                self.error = f"{type(exc).__name__}: {exc}"
                logger.warning("native TIFF codec unavailable (%s); the reader decodes LZW "
                               "and PackBits strips in Python", self.error)
                return None
            ll, ptr = ctypes.c_longlong, ctypes.c_void_p
            lib.nellie_packbits_decode.restype = ll
            lib.nellie_packbits_decode.argtypes = [ctypes.c_char_p, ll, ptr, ll]
            lib.nellie_lzw_decode.restype = ll
            lib.nellie_lzw_decode.argtypes = [ctypes.c_char_p, ll, ptr, ll]
            lib.nellie_undo_predictor.restype = None
            lib.nellie_undo_predictor.argtypes = [ptr, ll, ll, ll, ctypes.c_int]
            lib.nellie_decode_strips.restype = ll
            lib.nellie_decode_strips.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ll), ctypes.POINTER(ll), ll, ptr,
                ctypes.POINTER(ll), ctypes.POINTER(ll), ctypes.c_int, ctypes.c_int]
            self.lib = lib
            return lib

    def record(self, decoder: str, strips: int) -> None:
        with self._lock:
            self.decoded[decoder] += strips


CODEC = _Codec()


def available() -> bool:
    return CODEC.load() is not None


def status() -> dict:
    """Which decoder the reader has: ``decoder`` is ``"native"`` or
    ``"python"``, ``library`` the built library (or None), ``error`` why
    there is none, and ``decoded`` the strips each decoder took so far."""
    lib = CODEC.load()
    return {"decoder": "python" if lib is None else "native",
            "library": None if lib is None else CODEC.library_path(),
            "error": CODEC.error, "decoded": dict(CODEC.decoded)}


def record(decoder: str, strips: int = 1) -> None:
    """Count ``strips`` decoded by ``decoder`` (``"native"`` or ``"python"``)."""
    CODEC.record(decoder, strips)


def _decode(fn_name: str, data: bytes, expected_size: int):
    lib = CODEC.load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(expected_size)
    n = getattr(lib, fn_name)(data, len(data), out, expected_size)
    if n < 0:
        return None
    CODEC.record("native", 1)
    return out.raw[:n]


def lzw_decode(data: bytes, expected_size: int):
    """The decoded bytes (at most ``expected_size``), or None."""
    return _decode("nellie_lzw_decode", data, expected_size)


def packbits_decode(data: bytes, expected_size: int):
    """The decoded bytes (at most ``expected_size``), or None."""
    return _decode("nellie_packbits_decode", data, expected_size)


def undo_predictor(arr: np.ndarray, samples: int = 1) -> bool:
    """In-place horizontal predictor undo on a C-contiguous (rows,
    cols * samples) array of 1-, 2- or 4-byte integers; False when the
    library is missing or the array does not qualify."""
    lib = CODEC.load()
    if (lib is None or not arr.flags.c_contiguous or arr.dtype.kind not in "iu"
            or arr.itemsize not in (1, 2, 4) or arr.ndim < 2):
        return False
    rows = arr.shape[0]
    cols = int(np.prod(arr.shape[1:])) // samples
    lib.nellie_undo_predictor(arr.ctypes.data_as(ctypes.c_void_p), rows, cols, samples,
                              arr.itemsize)
    return True


def decode_strips(src: bytes, offsets, lengths, dst: np.ndarray, dst_offsets, dst_lengths,
                  compression: int, n_threads: int = 0) -> bool:
    """Decode the strips ``src[offsets[i]:offsets[i] + lengths[i]]`` into
    the contiguous byte buffer ``dst`` at ``dst_offsets`` (at most
    ``dst_lengths`` bytes each), on ``n_threads`` threads (0: one per
    core).  False when the library is missing or a strip fails."""
    arrays = [np.ascontiguousarray(a, np.int64)
              for a in (offsets, lengths, dst_offsets, dst_lengths)]
    if len({a.shape for a in arrays}) != 1 or arrays[0].ndim != 1:
        raise ValueError("offsets, lengths, dst_offsets and dst_lengths must be 1-D and alike")
    if dst.dtype != np.uint8 or not dst.flags.c_contiguous or not dst.flags.writeable:
        raise ValueError("dst must be a writeable, C-contiguous uint8 buffer")
    for start, size, limit in ((arrays[0], arrays[1], len(src)),
                               (arrays[2], arrays[3], dst.size)):
        if start.size and (start.min() < 0 or size.min() < 0 or (start + size).max() > limit):
            raise ValueError("a strip lies outside its buffer")
    lib = CODEC.load()
    if lib is None:
        return False
    as_ll = [a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)) for a in arrays]
    rc = lib.nellie_decode_strips(src, as_ll[0], as_ll[1], len(arrays[0]),
                                  dst.ctypes.data_as(ctypes.c_void_p), as_ll[2], as_ll[3],
                                  compression, n_threads)
    if rc == 0:
        CODEC.record("native", len(arrays[0]))
    return rc == 0
