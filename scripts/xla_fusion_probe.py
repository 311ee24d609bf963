"""Which frame shapes make XLA fuse the Hessian's inner gradient whole.

    python scripts/xla_fusion_probe.py 12x48x96 12x48x128 64x128 ...
    python scripts/xla_fusion_probe.py --widths 4 520 [--zy 12x48]

Compiles the JAX package's jitted ``vesselness_frame`` on the CPU for each
frame shape (nothing runs) and reads the optimised HLO: the inner
gradient along an axis is fused whole when one fused computation takes
the whole frame and computes the outer gradient's interior from it (two
subtractions), instead of reading a materialised concatenation.  Prints
one JSON line per shape with the axes where that happens: ``hzz`` (3D,
last axis) and ``hyy`` (3D axis 1, or the 2D last axis).  The port's
``hessian._fuses_inner_gradient`` mirrors the rule these lines show.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def fused_axes(shape) -> dict:
    import numpy as np
    import jax

    from nellie_tpu.kernels import frangi

    if len(shape) == 3:
        params = frangi.FrangiParams(sigmas=(0.625, 0.8333, 1.0417, 1.25),
                                     spacing=(0.5, 0.2, 0.2), z_ratio=2.5)
        axes = {"hzz": 2, "hyy": 1}
    else:
        params = frangi.FrangiParams(sigmas=(0.5, 0.75, 1.0), spacing=(0.1, 0.1))
        axes = {"hyy": 1}
    text = jax.jit(lambda x: frangi.vesselness_frame(x, params)).lower(
        np.zeros(shape, np.float32)).compile().as_text()
    frame = "f32[" + ",".join(map(str, shape)) + "]"
    computations = re.split(r"\n(?=\S)", text)
    out = {}
    for name, axis in axes.items():
        interior = list(shape)
        interior[axis] -= 2
        head_out = "-> f32[" + ",".join(map(str, interior)) + "] {"
        out[name] = any(
            c.startswith("%fused_computation") and c.split("\n", 1)[0].endswith(head_out)
            and frame in c.split("\n", 1)[0] and c.count("subtract(") >= 2
            for c in computations)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("shapes", nargs="*", help="frame shapes such as 12x48x128 or 64x128")
    parser.add_argument("--widths", nargs=2, type=int, metavar=("FIRST", "LAST"),
                        help="every last-axis width from FIRST to LAST")
    parser.add_argument("--zy", default="12x48", help="the leading axes for --widths")
    args = parser.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    shapes = [tuple(map(int, s.split("x"))) for s in args.shapes]
    if args.widths:
        lead = tuple(map(int, args.zy.split("x")))
        shapes += [lead + (w,) for w in range(args.widths[0], args.widths[1] + 1)]
    for shape in shapes:
        print(json.dumps({"shape": list(shape), **fused_axes(shape)}), flush=True)


if __name__ == "__main__":
    main()
