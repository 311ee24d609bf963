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
layout artefacts and are not ported.  ``NN_KERNEL.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.kernels._fp import row_sum_of_squares, sqrt

_CSRC = os.path.join(os.path.dirname(__file__), "csrc", "nn_argmin.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]
_PLAIN_CHUNK_ELEMS = 1 << 27  # bound on the (rows, M) distance block of the plain version


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
    """The compiled kernel: built once per process, with a launch count."""

    def __init__(self):
        self.launches = 0
        self.build_seconds = None
        self._lib = None

    def library_path(self) -> str:
        with open(_CSRC, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
        return os.path.join(_BUILD_DIR, f"libnn_argmin_{digest}.so")

    def build(self):
        """Compile the kernel with nvcc (if not already built) and load it."""
        if self._lib is not None:
            return self._lib
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
        lib.nn_argmin_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_void_p]
        lib.nn_argmin_f32.restype = ctypes.c_int
        self._lib = lib
        return lib

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
        q = queries.contiguous()
        r = refs.contiguous()
        d2 = torch.empty(n_q, dtype=torch.float32, device=q.device)
        idx = torch.empty(n_q, dtype=torch.int32, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.nn_argmin_f32(q.data_ptr(), r.data_ptr(), n_q, n_r, q.shape[1],
                                    d2.data_ptr(), idx.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"nn_argmin_f32 launch failed with cudaError {err}")
        self.launches += 1
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
                      device="cpu"):
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
