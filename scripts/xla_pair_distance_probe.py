"""How XLA rounds the reassigner's pair distance on the CPU.

    python scripts/xla_pair_distance_probe.py [--rows 8192 16384] [--dim 3]

Compiles the JAX package's production pair program
(``VoxelReassigner._pair_match_kernel``, ``use_pallas=False``) on the CPU
for frame tables of the given padded row counts (a multiple of the
interpolation tile, 8192; nothing runs) with ``XLA_FLAGS=--xla_dump_to``
into a temporary directory, and prints, for each row count:

- the optimised HLO fusion that ends in the distance's ``sqrt`` of the
  forward and backward matches (the prediction ``(c + v) * spacing`` is
  recomputed there, not read);
- the floating-point instructions of its LLVM IR after optimisation, by
  basic block: an ``fmul`` and the ``fsub``/``fadd`` that consumes it in
  the same block become one fused multiply-add (XLA's CPU backend allows
  contraction), while a product that reaches its consumer through a
  ``phi`` is rounded on its own;
- the same for the nearest-neighbour norms (``multiply_reduce`` fusions).

The port's ``stages/voxel_reassignment.py::_pair_distance`` and the
``fused_norms`` option of ``kernels/nn.py::nn_argmin`` mirror what these
lines show: over one tile the last axis's product is rounded before the
difference, over several every axis contracts; the norms contract.
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FLOAT_OPS = re.compile(r"\b(fmul|fadd|fsub|call .*@llvm\.(sqrt|fma)[^(]*)\b")


def compile_program(rows: int, dim: int, dump: str) -> str:
    """Compile the pair program in a child process (XLA reads its flags
    once per process) and return its optimised HLO."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import numpy as np, jax
jax.config.update("jax_platforms", "cpu")
from nellie_tpu.stages.voxel_reassignment import VoxelReassigner
n, d, m = {rows}, {dim}, 512
z = lambda *s: np.zeros(s, np.float32)
b = lambda k: np.zeros(k, bool)
args = (z(n, d), z(n, d), b(n), z(n, d), z(n, d), b(n), z(m, d), z(m, d), z(m, d), z(m), b(m),
        z(d), np.float32(1), np.float32(1))
print(VoxelReassigner._pair_match_kernel.lower(*args, use_pallas=False).compile().as_text())
"""
    env = dict(os.environ, XLA_FLAGS=f"--xla_dump_to={dump}", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         check=True)
    return out.stdout


def float_ops_by_block(path: str) -> list:
    """The IR's basic blocks that hold floating-point work, each as its
    label and the opcode of each such instruction."""
    blocks, label, ops = [], "entry", []
    for line in open(path):
        head = re.match(r"^([\w.]+):", line)
        if head:
            if ops:
                blocks.append((label, ops))
            label, ops = head.group(1), []
            continue
        hit = FLOAT_OPS.search(line)
        if hit:
            ops.append(hit.group(1).split(" ")[-1].replace("@llvm.", "llvm."))
        elif " phi float" in line or " phi <" in line:
            ops.append("phi")
    if ops:
        blocks.append((label, ops))
    return blocks


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, nargs="+", default=[8192, 16384],
                        help="padded frame-table rows (multiples of 8192)")
    parser.add_argument("--dim", type=int, default=3, choices=(2, 3))
    args = parser.parse_args()
    for rows in args.rows:
        with tempfile.TemporaryDirectory() as dump:
            hlo = compile_program(rows, args.dim, dump)
            print(f"=== {rows} rows, d = {args.dim}")
            for comp in re.split(r"\n(?=\S)", hlo):
                head = comp.split("\n", 1)[0]
                if "sqrt(" in comp and head.endswith(f"-> f32[{rows}] {{"):
                    print(comp)
            for pattern in ("*reduce_sqrt_fusion*ir-with-opt.ll",
                            "*multiply_reduce_fusion*ir-with-opt.ll"):
                for path in sorted(glob.glob(os.path.join(dump, pattern))):
                    print(f"--- {os.path.basename(path).split('.', 2)[-1]}")
                    for label, ops in float_ops_by_block(path):
                        print(f"  {label}: {' '.join(ops)}")


if __name__ == "__main__":
    main()
