"""Which second derivatives XLA fuses whole, with and without the Frobenius mask.

    python scripts/xla_unmasked_probe.py 12x48x48 3x16x130 64x128 40x129 ...

Compiles the JAX package's jitted ``vesselness_frame`` on the CPU for each
frame shape, with ``apply_mask=True`` (the Filter's program) and
``apply_mask=False`` (``Filter.run(mask=False)``'s), and reads the
optimised HLO (nothing runs).  A diagonal Hessian component's inner
gradient is fused whole when one fused computation takes the frame alone
and computes the second derivative along that axis from it: it slices the
frame along that axis only and subtracts at least four times (a first
derivative alone takes three: interior and two edges), so each
difference of two inner-gradient values sees both products and LLVM
contracts the left one into a fused multiply-add.  Prints one JSON line per
shape and program with the axes where that happens.  The port's
``hessian.fused_axes`` (``_fuses_inner_gradient``) mirrors
these lines: with the mask only a last axis of exactly 128, except in a
small frame (no axis longer than 32: 9x20x30, 32x32x32, 20x30), which
fuses like the program without it; without it every axis but a last one
longer than 128.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

_SLICE = re.compile(r"slice\((%[\w.\-]+)\), slice=\{([^}]*)\}")


def _sliced_axes(spec: str, shape) -> set:
    """The axes along which a slice spec ``[a:b], [c:d], ...`` cuts."""
    bounds = re.findall(r"\[(\d+):(\d+)(?::\d+)?\]", spec)
    return {axis for axis, (lo, hi) in enumerate(bounds)
            if (int(lo), int(hi)) != (0, shape[axis])}


def fused_axes(shape, apply_mask: bool) -> list:
    import numpy as np
    import jax

    from nellie_tpu.kernels import frangi

    if len(shape) == 3:
        params = frangi.FrangiParams(sigmas=(0.625, 0.8333, 1.0417, 1.25),
                                     spacing=(0.5, 0.2, 0.2), z_ratio=2.5)
    else:
        params = frangi.FrangiParams(sigmas=(0.5, 0.75, 1.0), spacing=(0.1, 0.1))
    text = jax.jit(lambda x: frangi.vesselness_frame(x, params, apply_mask=apply_mask)).lower(
        np.zeros(shape, np.float32)).compile().as_text()
    frame = "f32[" + ",".join(map(str, shape)) + "]"
    axes = set()
    for comp in re.split(r"\n(?=\S)", text):
        head, _, body = comp.partition("\n")
        if not head.startswith("%fused_computation"):
            continue
        params_decl = re.findall(r"param_[\w.]+: (\w+\[[\d,]*\])", head)
        # a first derivative takes three subtractions (interior, two edges);
        # a second derivative fused whole takes four or more
        if params_decl != [frame] or body.count("subtract(") < 4:
            continue
        param = re.search(r"(%param_[\w.]+) = " + re.escape(frame), body)
        cut = {a for name, spec in _SLICE.findall(body) if name == param.group(1)
               for a in _sliced_axes(spec, shape)} if param else set()
        if len(cut) == 1:
            axes |= cut
    return sorted(axes)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("shapes", nargs="+", help="frame shapes such as 12x48x128 or 64x128")
    args = parser.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    for s in args.shapes:
        shape = tuple(map(int, s.split("x")))
        for apply_mask in (True, False):
            print(json.dumps({"shape": list(shape), "apply_mask": apply_mask,
                              "fused_whole": fused_axes(shape, apply_mask)}), flush=True)


if __name__ == "__main__":
    main()
