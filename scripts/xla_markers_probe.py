"""How XLA's CPU code computes Markers' LoG: the peak fusion and the pad fusions.

    python scripts/xla_markers_probe.py 5x48x48 --radius 5 --seed 9
    python scripts/xla_markers_probe.py 3x48x48 --radius 10 --seed 5 --base frangi

Compiles the JAX package's jitted ``markers_frame_distance`` (``--base
distance``, the stage's default) or ``markers_frame`` with a float base
(``--base frangi``) on the CPU for one frame of the Markers tests
(``chip_smoke.filter_frame`` thresholded at 300, as
``tests/test_torch_log_programs.py`` builds it), with ``XLA_FLAGS
--xla_dump_to`` into a temporary directory, and reads each fusion's
optimised LLVM IR (nothing is run but the compile).

The peak fusion (``convert_select_fusion``) recomputes every scale's LoG at
the voxel and compares it with that scale's maximum filter; the pad
fusions (``slice_concatenate_fusion.*``) compute the LoG that the maximum
filters read.  For each ``maximum(., 0)`` in a fusion's first loop (one a
scale; the vector loop where there is one) the script prints the clamped value as a formula of the
loads, with the contraction of XLA's CPU backend: a product with one use
that feeds an add or a subtract becomes a fused multiply-add (``FMA[x*w +
acc]``, the left product where both operands are products), the others
stay rounded products (``x*w``); ``D`` is the clamped distance computed
inline (a select), ``L`` a load.  Then it lists every first add of two
products by its taps' weights, in the IR's operand order (the left one is
contracted), and flags those whose left product is the voxel's own value
(``D`` computed inline), or has the larger weight (the taps of a Gaussian
grow toward the centre, so tap 1 or the centre came first): there the
centre tap is contracted and tap 0 rounded, the rule that
``nellie_tpu_torch.kernels.filters.log_program(peak=True)`` mirrors for an
axis-0 order-0 pass of three taps.  The IR comes before instruction
selection, which can fold a select into an add (a masked add on AVX-512)
and so change which products are contracted:
``scripts/xla_markers_machine_code.py`` reads and runs the machine code.
The last line is one JSON object: for
each fusion and scale, the first adds as [left weight, right weight,
centre first] and the factor that folds ``-...`` and ``* s**2``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import struct
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))

_DEF = re.compile(r"(%[\w.]+) = (.*)")
_MAX = re.compile(r"@llvm\.maximum\.\S+\(.*(zeroinitializer|float 0\.000000e\+00)\)")


def _const(text):
    """A float constant of the IR (hex double or decimal), or None."""
    m = re.search(r"splat \(float ([^)]+)\)", text) or \
        re.search(r", (0x[0-9A-F]{16}|-?[0-9.]+e[-+][0-9]+)$", text.strip())
    if not m:
        return None
    v = m.group(1)
    return struct.unpack("<d", struct.pack("<Q", int(v, 16)))[0] if v.startswith("0x") else \
        float(v)


class Body:
    """The first loop body of a fusion's IR that clamps a LoG at 0 (the
    vector loop where there is one), as a dataflow graph."""

    def __init__(self, path):
        blocks, block = [], []
        for line in open(path).read().split("\n"):
            if re.match(r"^[\w.]+:", line):
                blocks.append(block)
                block = []
            else:
                block.append(line.strip())
        blocks.append(block)
        # the first (vector, else scalar) loop body that clamps a LoG at 0
        body = next((b for b in blocks if any(_MAX.search(l) for l in b)), [])
        self.defs, self.uses, self.counted = {}, {}, set()
        for line in body:
            m = _DEF.match(line)
            if not m:
                continue
            self.defs[m.group(1)] = m.group(2)
            for u in re.findall(r"%[\w.]+", m.group(2)):
                self.uses[u] = self.uses.get(u, 0) + 1

    def op(self, v):
        return self.defs.get(v, "").split(" ")[0]

    def operands(self, v):
        return re.findall(r"%[\w.]+", self.defs.get(v, ""))

    def single_product(self, v):
        return self.op(v) == "fmul" and self.uses.get(v, 0) == 1

    def leaf(self, v):
        """Whether v is a load (a tap read from another fusion's output)."""
        return self.op(v) == "load" or self.op(v) in ("extractelement", "shufflevector") and \
            self.leaf(self.operands(v)[0])

    def formula(self, v, first_adds):
        """The value v as a string; first adds of two products appended to
        ``first_adds`` as (left weight, right weight, centre first)."""
        op = self.op(v)
        if op == "":
            return v
        if op in ("load", "extractelement", "shufflevector"):
            return "L"
        if op == "fmul":
            a = self.operands(v)[0]
            w = _const(self.defs[v])
            x = self.formula(a, first_adds)
            return f"{x}*{w:.4g}" if w is not None else f"{x}*({self.formula(self.operands(v)[1], first_adds)})"
        if op in ("fadd", "fsub"):
            a, b = self.operands(v)[:2]
            sign = "+" if op == "fadd" else "-"
            fa, fb = self.single_product(a), self.single_product(b)
            if fa and fb and v not in self.counted:
                self.counted.add(v)
                wa, wb = _const(self.defs[a]), _const(self.defs[b])
                centre = not self.leaf(self.operands(a)[0]) or (
                    wa is not None and wb is not None and abs(wa) > abs(wb))
                first_adds.append((wa, wb, centre))
            ea, eb = self.formula(a, first_adds), self.formula(b, first_adds)
            if fa:
                return f"FMA[{ea} {sign} {eb}]"
            if fb:
                return f"FMA[{eb} {sign} {ea}]" if sign == "+" else f"FMA[{ea} - {eb}]"
            return f"({ea} {sign} {eb})"
        if op in ("select", "tail", "call", "fcmp", "fneg"):
            return "D"
        return op

    def maxima(self):
        """The operands of the llvm.maximum(x, 0) calls: each scale's LoG
        times its factor, before the clamp."""
        return [self.operands(v)[0] for v, d in self.defs.items() if _MAX.search(d)]


def probe(shape, radius, seed, base):
    import numpy as np

    import chip_smoke
    import jax
    import jax.numpy as jnp
    import test_torch_log_programs as T
    from nellie_tpu.stages import mocap_marking as jm

    jax.config.update("jax_platforms", "cpu")
    frame = chip_smoke.filter_frame(shape, seed=seed)
    raw, mask = np.clip(frame, 0, 65535).astype(np.uint16), frame > 300
    params = T._marker_params(jm, radius)
    if base == "distance":
        jm.markers_frame_distance(jnp.asarray(raw), jnp.asarray(mask), params)
    else:
        other = chip_smoke.filter_frame(shape, seed=seed + 1, smooth=True).astype(np.float32)
        jm.markers_frame(jnp.asarray(raw), jnp.asarray(mask), jnp.asarray(other), params)
    return params


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("shape", help="frame shape, e.g. 5x48x48")
    parser.add_argument("--radius", type=float, default=5.0, help="max_radius_px (5 or 10)")
    parser.add_argument("--seed", type=int, default=9)
    parser.add_argument("--base", choices=("distance", "frangi"), default="distance")
    parser.add_argument("--formulas", action="store_true", help="print each scale's formula")
    args = parser.parse_args()
    shape = tuple(int(s) for s in args.shape.split("x"))
    dump = tempfile.mkdtemp(prefix="xla_markers_")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + f" --xla_dump_to={dump} "
                               "--xla_dump_hlo_as_text --xla_dump_hlo_pass_re=^$").strip()
    params = probe(shape, args.radius, args.seed, args.base)
    print(f"sigmas {params.sigmas}; IR in {dump}")
    summary = {}
    files = sorted(f for f in os.listdir(dump) if f.endswith(".ir-with-opt.ll") and
                   ("convert_select_fusion" in f or "slice_concatenate_fusion" in f))
    for name in files:
        body = Body(os.path.join(dump, name))
        fusion = name.split(".", 2)[-1].replace("_kernel_module.ir-with-opt.ll", "")
        fusion = fusion.split(".", 1)[1] if fusion.startswith("jit_") else fusion
        rows = []
        for v in body.maxima():
            first = []
            text = body.formula(v, first)
            factor = _const(body.defs[v]) if body.op(v) == "fmul" else None
            rows.append({"factor": factor, "first_adds": [
                [round(a, 6), round(b, 6), centre] for a, b, centre in first]})
            flagged = [f"{a:.4g} (contracted) + {b:.4g}" for a, b, centre in first if centre]
            print(f"{fusion}: scale factor {factor}, {len(first)} first adds of two products"
                  + (f"; centre contracted first: {', '.join(flagged)}" if flagged else ""))
            if args.formulas:
                print("   ", text)
        if rows:
            summary[fusion] = rows
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
