"""How XLA's CPU code computes ``x ** y`` in the reference's Hu moments.

    python scripts/xla_pow_probe.py [--n 1000000] [--dump DIR]

Compiles the JAX package's tracker feature program (``hu_tracking.
_frame_features_fused``) on the CPU with ``XLA_FLAGS=--xla_dump_to`` and
counts, in its LLVM IR, the ``llvm.pow.f32`` calls whose exponent is a
constant and those whose exponent is formed at run time (the Hu
normalisation ``m00 ** ((i + j + 2) / 2)``), and the external ``powf`` the
object files call.  Then it sweeps ``n`` float32 values, log-uniform over
[2.7e3, 8.3e5] (the tracker's ``m00`` on the test inputs, 2.8e4 to 8.3e4,
a decade either side), through three lowerings of ``jnp.power`` at the
exponents 1, 1.5, ..., 4 and prints, per exponent, how many differ from
``nellie_tpu_torch.kernels._fp.pow`` and from ``torch.pow``:

* ``runtime``: the exponent formed in the program from i + j, as in the
  tracker (one scalar ``powf`` call per element);
* ``constant``: the exponent a constant LLVM sees (it folds 1 and 2 to
  ``x`` and ``x * x``);
* ``elementwise``: ``jax.jit(lambda a, b: a ** b)`` on two arrays.

One JSON line per lowering.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

EXPONENTS = (1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0)


def ir_counts(dump: str) -> dict:
    import numpy as np
    import jax

    from nellie_tpu.stages import hu_tracking

    rng = np.random.default_rng(0)
    shape = (12, 48, 48)
    coords = np.stack([rng.integers(0, s, 64) for s in shape], 1).astype(np.int32)
    out = hu_tracking._frame_features_fused(
        (rng.random(shape) * 500).astype(np.float32), rng.random(shape).astype(np.float32),
        (rng.random(shape) * 3).astype(np.float32), coords, np.ones(64, bool), r=12,
        no_z=False, chunk=64, scaling=(0.5, 0.2, 0.2))
    jax.block_until_ready(out)
    const = runtime = 0
    for path in glob.glob(os.path.join(dump, "*frame_features_fused*ir-with-opt.ll")):
        for exp in re.findall(r"llvm\.pow\.f32\(float %[\w.]+, float ([^)]+)\)", open(path).read()):
            if exp.startswith("%"):
                runtime += 1
            else:
                const += 1
    return {"pow_calls_runtime_exponent": runtime, "pow_calls_constant_exponent": const}


def sweep(n: int) -> list:
    import numpy as np
    import jax
    import jax.numpy as jnp
    import torch

    from nellie_tpu_torch.kernels import _fp

    rng = np.random.default_rng(1)
    x = (10 ** rng.uniform(np.log10(2.7e3), np.log10(8.3e5), n)).astype(np.float32)
    ipj = np.add.outer(np.arange(4), np.arange(4)).astype(np.int32)
    forms = {
        "runtime": np.asarray(jax.jit(
            lambda m, k: m[:, None, None] ** ((k[None] + 2) / 2.0))(x, ipj)),
        "constant": np.asarray(jax.jit(lambda m: m[:, None, None] ** (
            (jnp.arange(4)[:, None] + jnp.arange(4)[None, :] + 2)[None] / 2.0))(x)),
    }
    elementwise = jax.jit(lambda a, b: a ** b)
    lines = []
    for name in ("runtime", "constant", "elementwise"):
        row = {"lowering": name, "n": n, "fp_pow_mismatch": {}, "torch_pow_mismatch": {}}
        for e in EXPONENTS:
            i, j = np.argwhere((ipj + 2) / 2.0 == e)[0]
            want = (forms[name][:, i, j] if name in forms
                    else np.asarray(elementwise(x, np.full_like(x, e))))
            mine = _fp.pow(torch.from_numpy(x), e).numpy()
            plain = torch.from_numpy(x).pow(e).numpy()
            row["fp_pow_mismatch"][str(e)] = int((mine.view(np.int32) != want.view(np.int32)).sum())
            row["torch_pow_mismatch"][str(e)] = int((plain.view(np.int32)
                                                     != want.view(np.int32)).sum())
        lines.append(row)
    return lines


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=1_000_000)
    parser.add_argument("--dump", default=None, help="XLA dump directory (default: a temporary one)")
    args = parser.parse_args()
    dump = args.dump or tempfile.mkdtemp(prefix="xla_pow_probe_")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + f" --xla_dump_to={dump}").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps({"tracker_ir": ir_counts(dump)}), flush=True)
    for row in sweep(args.n):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
