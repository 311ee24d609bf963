"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file under ``kernels/csrc/`` with a plain C
interface.  It is compiled with ``nvcc`` for ``sm_90a`` on first use into
``nellie_tpu_torch/_build/`` (one directory for all kernels; the library
name carries a hash of the source, the ``csrc/`` headers it includes and
the flags, so a change to any of them rebuilds) and
bound with ``ctypes``.  :class:`CudaKernel` holds one such library: the
build, the launch count and whatever a subclass caches sit under one lock,
so that the threads of a mesh compile it once and lose no count.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Sequence

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
_QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def nvcc() -> str:
    path = shutil.which("nvcc") or DEFAULT_NVCC
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the "
                           "kernels of nellie_tpu_torch/kernels/csrc/")
    return path


class CudaKernel:
    """One CUDA library built from ``csrc/<source>`` with ``flags``.

    ``launches`` counts the wrapper's launches (:meth:`count_launch`);
    ``build_seconds`` is the nvcc time of this process's build (None when
    the library was already built).  A subclass binds the library's
    functions in :meth:`bind`."""

    source = ""
    flags: Sequence[str] = BASE_FLAGS

    def __init__(self):
        self.launches = 0
        self.build_seconds = None
        self._lib = None
        self._lock = threading.RLock()

    @property
    def source_path(self) -> str:
        return os.path.join(CSRC, self.source)

    def count_launch(self):
        with self._lock:
            self.launches += 1

    @staticmethod
    def on_device(dev):
        """A context that makes CUDA device ``dev`` current, or none when it
        already is (entering one costs more than a small launch)."""
        import torch

        if dev.index is None or dev.index == torch.cuda.current_device():
            return contextlib.nullcontext()
        return torch.cuda.device(dev)

    def headers(self) -> list:
        """The ``csrc/`` headers that the source includes by a quoted name."""
        with open(self.source_path) as f:
            names = _QUOTED_INCLUDE.findall(f.read())
        return [os.path.join(CSRC, n) for n in names if os.path.exists(os.path.join(CSRC, n))]

    def library_path(self) -> str:
        """The library's path under ``_build/``: its name carries a hash of
        the source, the headers it includes and the flags."""
        digest = hashlib.sha256()
        for path in [self.source_path, *self.headers()]:
            with open(path, "rb") as f:
                digest.update(f.read())
        digest.update(" ".join(self.flags).encode())
        digest = digest.hexdigest()[:16]
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")

    def compile_args(self, output: str) -> list:
        """nvcc's arguments that build the library into ``output``."""
        return [*self.flags, "-o", output, self.source_path]

    def build(self):
        """Compile the kernel with nvcc (if not already built) and load it."""
        with self._lock:
            if self._lib is None:
                self._lib = self._build()
            return self._lib

    def _build(self):
        path = self.library_path()
        if not os.path.exists(path):
            compiler = nvcc()
            os.makedirs(BUILD_DIR, exist_ok=True)
            start = time.perf_counter()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run([compiler, *self.compile_args(tmp)], capture_output=True,
                                      text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {self.source_path}:\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            self.build_seconds = time.perf_counter() - start
        lib = ctypes.CDLL(path)
        self.bind(lib)
        return lib

    def bind(self, lib) -> None:
        raise NotImplementedError


class CountedKernel(CudaKernel):
    """A :class:`CudaKernel` whose C entry point reports the CUDA kernels it
    launched: ``kernel_launches`` sums them over the wrapper's calls and
    ``last_stats`` holds the last call's (``cuda_kernels`` and what the
    wrapper adds, such as ``host_reads``)."""

    def __init__(self):
        super().__init__()
        self.kernel_launches = 0
        self.last_stats = None

    def count_call(self, kernels: int, **stats):
        """Count one call of the wrapper that launched ``kernels`` CUDA
        kernels."""
        with self._lock:
            self.launches += 1
            self.kernel_launches += kernels
            self.last_stats = {"cuda_kernels": kernels, **stats}


def on_card(x, name: str) -> bool:
    """Whether tensor ``x`` takes a hand kernel (a CUDA tensor) or its plain
    version (a CPU tensor); other devices raise."""
    if x.device.type in ("cuda", "cpu"):
        return x.device.type == "cuda"
    raise ValueError(f"{name}: unsupported device {x.device}")


def check_error(name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError {err}")
