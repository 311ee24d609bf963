"""Where the matcher's two kernels spend a call: timestamps by phase.

    python3 scripts/pair_kernel_phases.py

Needs a CUDA GPU and ``nvcc``; imports no JAX.  It copies
``kernels/csrc/pair_sums.cu``, ``pair_costs.cu`` and ``pair_gate.cuh`` to a
temporary directory, inserts a ``%globaltimer`` stamp (thread 0 of each
block) at each phase boundary, builds the copies with the kernels' own
flags and binds them in place of the built libraries, then calls
``matching.pair_stats`` and ``matching.pair_costs`` on seeded tiles shaped
like the 3D and 2D main paths' largest calls (338 x 332 markers with 22
features; 2,196 x 2,195 with 10, markers spread so that about 0.2 % of the
pairs are gated; both frames' markers in raster order, so that the gated
pairs crowd the windows near the diagonal, as on the paths).  For each launch it prints, in microseconds from the
launch's first stamp: the span, each phase's mean and largest duration over
the blocks, the latest block start, and the stamps of the block that ran
last; once on a warm L2 (the call repeated) and once on a cold one (the
256 MiB fill that ``chip_smoke.cold_times`` runs before each call).
Phases: level 1 and the costs: staging, gate, list, then the chains
(level 1) or the costs and keys (pair costs), then the fence and the last
block's final sum or decode; the later level: staging its window, the
chain, the last block's tail.  The stamps cost a few instructions a phase;
compare the spans with ``chip_smoke.py`` phase 17's times.  If a kernel's
source changes where a stamp goes, the script stops and names the line.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
sys.path.insert(0, REPO)

STAMPS = r'''
#include <cuda_runtime.h>
__device__ unsigned long long g_stamps[2][8192][8];
__device__ __forceinline__ void stamp_at(int which, int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[which][blockIdx.x][k] = t;
  }
}
#define stamp(k) stamp_at(0, k)
#define stamp2(k) stamp_at(1, k)
extern "C" int phase_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
extern "C" int phase_clear() {
  static unsigned long long zero[2][8192][8];
  return (int)cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));
}
'''

GATE = [
    ("  stage_pieces(pieces, t.aligned);\n  __syncthreads();\n",
     "  stage_pieces(pieces, t.aligned);\n  __syncthreads();\n  stamp(1);\n"),
    ("  __syncthreads();\n  // the list:", "  __syncthreads();\n  stamp(2);\n  // the list:"),
    ("  __syncthreads();\n  return pairs.first[MAX_K];",
     "  __syncthreads();\n  stamp(3);\n  return pairs.first[MAX_K];"),
]
SUMS = [
    ("  const pair_gate::Block b = pair_gate::block_of(t);\n  const int total = pair_gate::",
     "  const pair_gate::Block b = pair_gate::block_of(t);\n  stamp(0);\n"
     "  const int total = pair_gate::"),
    ("  if (threadIdx.x == 0) atomicAdd(job.count, (unsigned long long)block_count);\n"
     "  if (job.later || !last_block(job.done)) return;\n",
     "  stamp(4);\n  if (threadIdx.x == 0) atomicAdd(job.count, (unsigned long long)block_count);\n"
     "  if (job.later || !last_block(job.done)) return;\n  stamp(5);\n"),
    ("  final_sums(job, job.level1, t.win_rows, t.win_cols, job.ld1, smem, job.stage_floats);\n}",
     "  final_sums(job, job.level1, t.win_rows, t.win_cols, job.ld1, smem, job.stage_floats);\n"
     "  stamp(6);\n}"),
    ("  const float* x = job.level1 + (long long)q * vr * ld;\n",
     "  const float* x = job.level1 + (long long)q * vr * ld;\n  stamp2(0);\n"),
    ("    win4[k] = v;\n  }\n  __syncthreads();\n",
     "    win4[k] = v;\n  }\n  __syncthreads();\n  stamp2(1);\n"),
    ("  if (!last_block(job.done + 1)) return;",
     "  stamp2(2);\n  if (!last_block(job.done + 1)) return;\n  stamp2(3);"),
    ("  final_sums(job, src, svr, svc, sld, win, W * W);\n}",
     "  final_sums(job, src, svr, svc, sld, win, W * W);\n  stamp2(4);\n}"),
]
COSTS = [
    ("  const pair_gate::Block b = pair_gate::block_of(t);\n  for (int k",
     "  const pair_gate::Block b = pair_gate::block_of(t);\n  stamp(0);\n  for (int k"),
    ("    atomicMin(keys + W + c, key_of(cost, b.r0 + i));\n  }\n  __syncthreads();",
     "    atomicMin(keys + W + c, key_of(cost, b.r0 + i));\n  }\n  __syncthreads();\n"
     "  stamp(4);"),
    ("  if (!last) return;\n  __threadfence();\n  decode<D>(job, p, queue, &queued);",
     "  stamp(5);\n  if (!last) return;\n  __threadfence();\n  stamp(6);\n"
     "  decode<D>(job, p, queue, &queued);\n  stamp(7);"),
]


def patched(text, edits, name):
    for old, new in edits:
        if text.count(old) != 1:
            sys.exit(f"{name}: no single place for a stamp at {old.strip()[:60]!r}")
        text = text.replace(old, new)
    return text


def build(kernel, edits, directory):
    """``kernel``'s source with its stamps, built with its flags and bound
    in place of its library."""
    from nellie_tpu_torch.kernels import _cuda

    with open(os.path.join(_cuda.CSRC, "pair_gate.cuh")) as f:
        header = patched(f.read(), GATE, "pair_gate.cuh")
    with open(os.path.join(directory, "pair_gate.cuh"), "w") as f:
        f.write(header)
    with open(kernel.source_path) as f:
        text = STAMPS + patched(f.read(), edits, kernel.source)
    source = os.path.join(directory, kernel.source)
    with open(source, "w") as f:
        f.write(text)
    out = os.path.join(directory, kernel.source.replace(".cu", ".so"))
    subprocess.run([_cuda.nvcc(), *kernel.flags, "-o", out, source], check=True)
    lib = ctypes.CDLL(out)
    kernel.bind(lib)
    kernel._lib = lib
    return lib


def tile(n_post, n_pre, ndim, n_feat, sites, seed=0):
    """Earlier markers on a lattice of ``sites`` steps a side in raster
    order, later ones near them in the same order (as a frame's markers
    come, so that the gated pairs crowd the windows near the diagonal),
    normal features; float32 CUDA tensors."""
    rng = np.random.default_rng(seed)
    spacing = np.array([0.5, 0.2, 0.2][-ndim:])
    cq = rng.integers(0, sites, (n_pre, ndim))
    cq = (cq[np.lexsort(cq.T[::-1])] * spacing).astype(np.float32)
    cp = (cq[np.sort(rng.integers(0, n_pre, n_post))]
          + rng.normal(0, 0.2, (n_post, ndim))).astype(np.float32)
    feats = [rng.normal(0, 1, (n, n_feat)).astype(np.float32) for n in (n_post, n_pre)]
    return [torch.from_numpy(a).cuda() for a in (cp, cq, *feats)]


def report(what, st, phases, t0=None):
    """The span, each phase's mean and largest duration, and the last
    block's stamps, in microseconds from the launch's first stamp."""
    used = st[st[:, 0] > 0]
    t0 = used[:, 0].min() if t0 is None else t0
    print(f"{what}: {len(used)} blocks, span {(used[:, phases[-1]].max() - t0) / 1e3:.2f} us, "
          f"latest block start {(used[:, 0].max() - t0) / 1e3:.2f} us", flush=True)
    for a, b in zip(phases[:-1], phases[1:]):
        d = (used[:, b] - used[:, a]) / 1e3
        print(f"  phase {a} -> {b}: mean {d.mean():.2f} us, largest {d.max():.2f} us", flush=True)
    last = used[used[:, phases[-1] + 1] > 0] if phases[-1] + 1 < 8 else used[:0]
    for row in last:
        print("  last block: " + ", ".join(f"{(v - t0) / 1e3:.2f}" for v in row if v > 0)
              + " us", flush=True)
    return t0


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    import chip_smoke
    from nellie_tpu_torch.kernels import matching

    print(chip_smoke.gpu_line(), flush=True)
    with tempfile.TemporaryDirectory() as directory:
        lib_s = build(matching.PAIR_SUMS_KERNEL, SUMS, directory)
        lib_c = build(matching.PAIR_COSTS_KERNEL, COSTS, directory)
        for tag, (n_post, n_pre, ndim, n_feat, sites, padded, n_stats) in {
                "3D": (338, 332, 3, 22, 24, (1024, 1024), 4),
                "2D": (2196, 2195, 2, 10, 240, (4096, 4096), 3)}.items():
            cp, cq, fp, fq = tile(n_post, n_pre, ndim, n_feat, sites)
            mean, std = (torch.from_numpy(a) for a in chip_smoke.pair_moments(
                *(a.cpu().numpy() for a in (cp, cq, fp, fq)), 1.0))
            flush = torch.empty(chip_smoke.L2_FLUSH_BYTES // 2, dtype=torch.int16,
                                device="cuda")
            for (lib, call, name), l2 in ((c, l2) for c in (
                    (lib_s, lambda: matching.pair_stats(cp, cq, fp, fq, 1.0, padded), "sums"),
                    (lib_c, lambda: matching.pair_costs(cp, cq, fp, fq, 1.0, mean, std,
                                                        n_stats), "costs"))
                    for l2 in ("warm", "cold")):
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                lib.phase_clear()
                if l2 == "cold":
                    flush.fill_(1)
                call()
                torch.cuda.synchronize()
                st = np.zeros((2, 8192, 8), np.uint64)
                if lib.phase_stamps(st.ctypes.data):
                    sys.exit("could not read the stamps")
                st = st.astype(np.int64)
                tag_l2 = f"{tag} {l2} L2"
                if name == "sums":
                    t0 = report(f"{tag_l2} pair_sums level 1 (0 start, 1 staged, 2 gated, "
                                f"3 listed, 4 chains, 5 last block, 6 final)", st[0],
                                [0, 1, 2, 3, 4])
                    if st[1].any():
                        report(f"{tag_l2} pair_sums later level (0 start, 1 staged, 2 chain, "
                               f"3 last block, 4 tail)", st[1], [0, 1, 2], t0)
                else:
                    report(f"{tag_l2} pair_costs (0 start, 1 staged, 2 gated, 3 listed, 4 costs, "
                           f"5 keys flushed, 6 last block, 7 decoded)", st[0],
                           [0, 1, 2, 3, 4, 5])


if __name__ == "__main__":
    main()
