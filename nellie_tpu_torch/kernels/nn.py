"""Brute-force nearest-neighbour argmin: the CUDA kernel and its plain version.

``nn_argmin`` replaces the JAX package's only TPU kernel,
``nellie_tpu/kernels/pallas_nn.py::nn_argmin_pallas`` (body ``_nn_kernel``).
For each query it returns the minimum over the references of
d² = (|q|² + |r|²) − 2 q·r in float32 and the first index reaching it.

* On a CUDA tensor it launches the hand-written kernel
  ``csrc/nn_argmin.cu`` (built for ``sm_90a`` with ``nvcc`` on first use,
  into ``nellie_tpu_torch/_build/``, bound through ``ctypes``), or raises.
* On a CPU tensor it runs :func:`nn_argmin_plain`.

The kernel takes unpadded (Q, d<=8) and (M, d) tensors and masks its own
ragged edges: the TPU kernel's 8-wide padding and tile multiples are
layout artefacts and are not ported.  Its grid splits the reference axis
as well as the query axis, so that few queries still fill the card;
:func:`launch_plan` chooses the split.  ``NN_KERNEL.launches`` counts the
wrapper's calls of the kernel (one C call: pack the references, the
split kernel, unpack the result).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels._fp import row_sum_of_squares, sqrt

_CSRC = os.path.join(os.path.dirname(__file__), "csrc", "nn_argmin.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]
_PLAIN_CHUNK_ELEMS = 1 << 27  # bound on the (rows, M) distance block of the plain version

# the kernel's build constants (checked against the library at load time)
QPT = 12          # queries per thread
R_TILE = 128      # reference rows per shared-memory tile
MAX_THREADS = 128  # threads per block, at most
# the launch plan's targets
H100_SMS = 132
MIN_SPLIT_TILES = 3  # a reference split streams at least this many tiles
TARGET_WAVES = 4     # blocks to launch, in multiples of what the SMs hold at once
MAX_SPLITS = 65535   # the grid's y extent


@dataclass(frozen=True)
class NNPlan:
    """How the kernel covers Q queries and M references: ``q_tiles`` tiles
    of ``q_tile`` = ``threads * QPT`` queries times ``splits`` ranges of
    ``split_len`` references, each streamed in tiles of ``r_tile`` rows."""

    threads: int
    q_tile: int
    q_tiles: int
    splits: int
    split_len: int
    r_tile: int = R_TILE

    @property
    def blocks(self) -> int:
        return self.q_tiles * self.splits


def launch_plan(n_q: int, n_r: int, sms: int = H100_SMS, resident_warps: int = 16) -> NNPlan:
    """The kernel's grid for ``n_q`` queries and ``n_r`` references on a
    card of ``sms`` SMs that each hold ``resident_warps`` warps of the
    kernel at once (its register budget decides; the wrapper asks the
    library).

    Threads per block grow with Q, from one warp up to ``MAX_THREADS``,
    while there are at least 8 query tiles of the larger size.  The
    reference axis is then split so that the grid is about
    ``TARGET_WAVES`` full waves of blocks, with the last wave filled, and
    no split shorter than ``MIN_SPLIT_TILES`` tiles; the splits are equal
    but for the last, and none is empty."""
    if n_q < 1 or n_r < 1:
        raise ValueError(f"launch plan for {n_q} queries and {n_r} references")
    threads = 32
    while threads < MAX_THREADS and n_q >= 8 * 2 * threads * QPT:
        threads *= 2
    q_tile = threads * QPT
    q_tiles = -(-n_q // q_tile)
    resident = sms * max(1, min(32, resident_warps // (threads // 32)))
    max_splits = max(1, min(MAX_SPLITS, n_r // (MIN_SPLIT_TILES * R_TILE)))
    splits = min(max_splits, max(1, round(TARGET_WAVES * resident / q_tiles)))
    waves = -(-q_tiles * splits // resident)
    splits = min(max_splits, max(splits, waves * resident // q_tiles))
    split_len = -(-n_r // splits)
    return NNPlan(threads, q_tile, q_tiles, -(-n_r // split_len), split_len)


def nn_argmin_plain(queries: torch.Tensor, refs: torch.Tensor):
    """The same formula in plain torch: ((Q,) float32 d², (Q,) int32 argmin).

    |q|² and |r|² round every square and add them left to right, as XLA
    rounds the reference; the cross term is a float32 matmul (on the CPU a
    chain of fused multiply-adds in coordinate order, as in the reference
    and the kernel)."""
    q = queries.float()
    r = refs.float()
    r2 = row_sum_of_squares(r)
    rows = max(1, _PLAIN_CHUNK_ELEMS // max(r.shape[0], 1))
    d2_out, idx_out = [], []
    for s in range(0, q.shape[0], rows):
        qc = q[s:s + rows]
        q2 = row_sum_of_squares(qc)[:, None]
        d2 = (q2 + r2[None, :]) - 2.0 * (qc @ r.T)
        best, idx = d2.min(dim=1)
        d2_out.append(best)
        idx_out.append(idx.to(torch.int32))
    return torch.cat(d2_out), torch.cat(idx_out)


class _NNKernel:
    """The compiled kernel: built once per process, with a launch count.
    The build, the info cache and the count are guarded by one lock, so
    that threads launching it on several devices (a mesh) compile it once
    and lose no count."""

    def __init__(self):
        self.launches = 0
        self.build_seconds = None
        self._lib = None
        self._info = {}
        self._lock = threading.RLock()

    def count_launch(self):
        with self._lock:
            self.launches += 1

    def library_path(self) -> str:
        with open(_CSRC, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
        return os.path.join(_BUILD_DIR, f"libnn_argmin_{digest}.so")

    def build(self):
        """Compile the kernel with nvcc (if not already built) and load it."""
        with self._lock:
            if self._lib is None:
                self._lib = self._build()
            return self._lib

    def _build(self):
        path = self.library_path()
        if not os.path.exists(path):
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            if not os.path.exists(nvcc):
                raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                                   "nellie_tpu_torch/kernels/csrc/nn_argmin.cu")
            os.makedirs(_BUILD_DIR, exist_ok=True)
            start = time.perf_counter()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", tmp, _CSRC],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {_CSRC}:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            self.build_seconds = time.perf_counter() - start
        lib = ctypes.CDLL(path)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.nn_argmin_f32.argtypes = [ptr, ptr] + [i32] * 8 + [ptr] * 5
        lib.nn_argmin_f32.restype = i32
        lib.nn_argmin_info.argtypes = [i32] + [ctypes.POINTER(i32)] * 6
        lib.nn_argmin_info.restype = i32
        return lib

    def info(self, dim: int) -> dict:
        """The library's QPT, R_TILE and MAX_THREADS (checked against this
        module's), and its split kernel's registers per thread, spill bytes
        per thread and resident warps per SM at ``dim`` coordinates, on the
        current CUDA device."""
        key = (dim, torch.cuda.current_device())
        with self._lock:
            return self._info[key] if key in self._info else self._read_info(key)

    def _read_info(self, key) -> dict:
        dim = key[0]
        lib = self.build()
        vals = [ctypes.c_int() for _ in range(6)]
        err = lib.nn_argmin_info(dim, *[ctypes.byref(v) for v in vals])
        if err != 0:
            raise RuntimeError(f"nn_argmin_info failed with cudaError {err}")
        info = dict(zip(("qpt", "r_tile", "max_threads", "regs", "local_bytes",
                         "resident_warps"), (v.value for v in vals)))
        if (info["qpt"], info["r_tile"], info["max_threads"]) != (QPT, R_TILE, MAX_THREADS):
            raise RuntimeError(f"{self.library_path()} was built with {info}, "
                               f"this module expects QPT {QPT}, R_TILE {R_TILE}, "
                               f"MAX_THREADS {MAX_THREADS}")
        self._info[key] = info
        return info

    def __call__(self, queries: torch.Tensor, refs: torch.Tensor):
        if queries.dtype != torch.float32 or refs.dtype != torch.float32:
            raise TypeError("nn_argmin kernel takes float32 tensors")
        if queries.ndim != 2 or refs.ndim != 2 or queries.shape[1] != refs.shape[1]:
            raise ValueError(f"shapes {tuple(queries.shape)} and {tuple(refs.shape)}: "
                             "expected (Q, d) and (M, d)")
        if not 1 <= queries.shape[1] <= 8:
            raise ValueError(f"coordinate width {queries.shape[1]} outside 1..8")
        if refs.device != queries.device:
            raise ValueError("queries and refs must be on the same device")
        n_q, n_r = queries.shape[0], refs.shape[0]
        if n_q >= 2 ** 31 or n_r >= 2 ** 31:
            raise ValueError("more than 2**31 - 1 rows")
        lib = self.build()
        dim = queries.shape[1]
        q = queries.contiguous()
        r = refs.contiguous()
        dev = q.device
        with torch.cuda.device(dev):
            plan = launch_plan(n_q, n_r, torch.cuda.get_device_properties(dev).multi_processor_count,
                               self.info(dim)["resident_warps"])
            packed = torch.empty((n_r, 4 * ((dim + 4) // 4)), dtype=torch.float32, device=dev)
            keys = torch.empty(n_q, dtype=torch.int64, device=dev).fill_(-1)  # all ones
            d2 = torch.empty(n_q, dtype=torch.float32, device=dev)
            idx = torch.empty(n_q, dtype=torch.int32, device=dev)
            err = lib.nn_argmin_f32(q.data_ptr(), r.data_ptr(), n_q, n_r, dim, plan.threads,
                                    plan.splits, plan.split_len, QPT, plan.r_tile,
                                    packed.data_ptr(), keys.data_ptr(), d2.data_ptr(),
                                    idx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"nn_argmin_f32 launch failed with cudaError {err}")
        self.count_launch()
        return d2, idx


NN_KERNEL = _NNKernel()


def nn_argmin(queries: torch.Tensor, refs: torch.Tensor):
    """((Q,) float32 minimum d², (Q,) int32 first argmin) of queries vs refs.

    CUDA tensors go to the hand-written kernel (or raise); CPU tensors to
    :func:`nn_argmin_plain`.  Empty inputs give empty outputs (for an empty
    reference set: +inf distances and index 0)."""
    if queries.shape[0] == 0 or refs.shape[0] == 0:
        n = queries.shape[0]
        return (torch.full((n,), float("inf"), device=queries.device),
                torch.zeros(n, dtype=torch.int32, device=queries.device))
    if queries.device.type == "cuda":
        return NN_KERNEL(queries, refs)
    if queries.device.type == "cpu":
        return nn_argmin_plain(queries, refs)
    raise ValueError(f"nn_argmin: unsupported device {queries.device}")


def nearest_neighbors(queries: np.ndarray, refs: np.ndarray, m_chunk: int = 1 << 18,
                      device="cuda"):
    """Host loop (``pallas_nn.nearest_neighbors`` without its TPU tile
    sizes ``tq``/``tm``): nearest reference for every query, streaming the
    references in chunks of ``m_chunk``.  Returns numpy (distances, int64
    indices)."""
    dev = resolve_device(device)
    q_n, _ = queries.shape
    m_n = refs.shape[0]
    if q_n == 0 or m_n == 0:
        return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
    best_d = torch.full((q_n,), float("inf"), device=dev)
    best_i = torch.zeros(q_n, dtype=torch.int64, device=dev)
    for start in range(0, m_n, m_chunk):
        r = torch.from_numpy(np.ascontiguousarray(refs[start:start + m_chunk], np.float32)).to(dev)
        d2, idx = nn_argmin(q, r)
        better = d2 < best_d
        best_d = torch.where(better, d2, best_d)
        best_i = torch.where(better, idx.long() + start, best_i)
    dist = sqrt(torch.clamp(best_d, min=0.0)).cpu().numpy()
    return dist, best_i.cpu().numpy()
