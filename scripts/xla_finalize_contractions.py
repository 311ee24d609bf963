"""Which contraction of the Filter finalize's percentile each opening term takes.

    python scripts/xla_finalize_contractions.py [--programs NAME ...] [--isa AVX2]
        [--shape-3d 64x256x256] [--shape-2d 1024x1024] [--capacity-step N]

The 1st percentile's last step, s[lo] (1 - frac) + s[hi] frac, rounds once
in either of two forms: A = fma(s[lo], 1 - frac, s[hi] frac) and
B = fma(s[hi], frac, s[lo] (1 - frac)).  XLA recomputes the expression in
every fusion that compares the frame with it: the fusions that build the
opening's six shifted masks (``frame > thr`` padded and sliced along one
axis, the erosion's side terms) and the last fusion, which computes the
unshifted mask inline at each of the dilation's seven positions.  LLVM's
backend contracts the one product it sees first, which need not be the
same in each fusion.

For each reference program that forms this percentile (the jitted
``finalize_frame`` and ``mask_volume`` at the main 3D and 2D frame shapes,
which the fused chain's per-frame loop dispatches at ``fused.py:292``; the
mesh's vmapped ``batched_filter_kernel``, also with its vesselness
replaced by the frame itself, as the CPU tests drive it; capacity's
``_segment_from_vessel`` and ``_pct_from_sample``) the script compiles
the program on the CPU with ``XLA_FLAGS --xla_dump_to``, lists the
fusions that recompute the percentile, links each one's object file and
runs its machine code (``xla_markers_machine_code.Program.run``'s call
frame) on operands that the program's own fusions computed from a frame
whose strided sample gives A != B: its input frame replaced by one whose
every voxel holds the larger of A and B (the side-term fusions) or a
lattice of such voxels among values below both (the last fusion, with its
side-term operands all true, so that each dilation position's inline mask
shows alone).  A kept voxel at max(A, B) means the fusion compared with
min(A, B).  Each element is counted by its form, and the counts are split
into the last axis's vector columns and its remainder.

Each program's rows end with whether the port's rule for that program's
caller (``frangi.FINALIZE_FORMS``, or form B everywhere for capacity's
chunked windows, ``frangi.masked_percentile``) gives every term the form
read here.  The last line is one
JSON object: "forms", program -> term -> form, where a term is
``centre@<dilation shift>`` or ``<axis><side>`` (the erosion's side term
read at index + side along that axis) and the form is "A", "B" or
"mixed" (the rows above give the counts), and "port_agrees", program ->
that verdict.  Imports the JAX package; runs on the CPU; about 5 minutes
for every program at the main shapes.
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import re
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

SHAPE_3D, SHAPE_2D = (64, 256, 256), (1024, 1024)  # the main paths' frames
_INST = re.compile(r"\s*(?:ROOT )?%([\w.\-]+) = (\(.*?\)|\w+\[[\d,]*\](?:\{[\d,]*\})?) "
                   r"([\w-]+)\((.*)$")
_DTYPES = {"f32": np.float32, "f16": np.float16, "s32": np.int32, "pred": np.uint8,
           "u8": np.uint8, "u32": np.uint32}


def capacity_step(shape):
    """Capacity's flat sample step at its default 10^6 sampled voxels."""
    return max(int(np.prod(shape)) // 1000000, 1)


def mesh_params(nd):
    from nellie_tpu.kernels import frangi

    return frangi.FrangiParams(sigmas=(0.75, 0.95), spacing=(0.5, 0.2, 0.2)[-nd:],
                               z_ratio=2.5 if nd == 3 else 1.0)


@contextlib.contextmanager
def frame_as_vesselness():
    """The reference's vesselness (and 2D blobness) replaced by the frame
    itself (and zeros) while a program is traced, so that its finalize reads
    a frame chosen by the caller."""
    import jax.numpy as jnp

    from nellie_tpu.kernels import frangi

    saved = frangi.vesselness_frame, frangi.log_blobness_2d
    frangi.vesselness_frame = lambda f, params, apply_mask=True: (f, None)
    frangi.log_blobness_2d = lambda f, m, params: jnp.zeros(f.shape, jnp.float32)
    try:
        yield
    finally:
        frangi.vesselness_frame, frangi.log_blobness_2d = saved


def mesh_finalize(max_samples=int(1e6)):
    """The mesh's ``batched_filter_kernel`` jitted anew with its vesselness
    the frame itself: fn(frame) -> the finalized frame (its batch of one)."""
    import jax

    from nellie_tpu.mesh import sharded

    fn = jax.jit(sharded.batched_filter_kernel.__wrapped__,
                 static_argnames=("params", "apply_mask", "max_samples", "remove_edges"))

    def run(f):
        with frame_as_vesselness():
            return fn(f[None], mesh_params(f.ndim), True, max_samples, False)[0]

    return run


def programs(names, shape_3d=SHAPE_3D, shape_2d=SHAPE_2D, step=None):
    """{name: (the jitted function of a frame, the frame's shape, capacity's
    flat sample step or None for the finalize's strided sample)} for the
    requested programs; ``step`` overrides capacity's own."""
    import jax.numpy as jnp

    from nellie_tpu.kernels import frangi
    from nellie_tpu.mesh import sharded
    from nellie_tpu.pipeline import capacity

    def mesh_fn(shape):
        params = mesh_params(len(shape))
        return lambda f: sharded.batched_filter_kernel(f[None].astype(jnp.uint16), params,
                                                      True, int(1e6), False)

    def seg_step(shape):
        return step or capacity_step(shape)

    def seg(f):
        return capacity._segment_from_vessel(f, 10, True, seg_step(f.shape), 256, int(1e6),
                                             "mask")

    table = {
        "finalize_frame 3D": (frangi.finalize_frame, shape_3d, None),
        "finalize_frame 2D": (frangi.finalize_frame, shape_2d, None),
        "mask_volume 3D": (frangi.mask_volume, shape_3d, None),
        "mask_volume 2D": (frangi.mask_volume, shape_2d, None),
        "mesh batched_filter_kernel 3D": (mesh_fn(shape_3d), shape_3d, None),
        "mesh batched_filter_kernel 2D": (mesh_fn(shape_2d), shape_2d, None),
        "mesh batched_filter_kernel, vesselness = frame 3D": (mesh_finalize(), shape_3d, None),
        "mesh batched_filter_kernel, vesselness = frame 2D": (mesh_finalize(), shape_2d, None),
        "capacity _segment_from_vessel 3D": (seg, shape_3d, seg_step(shape_3d)),
        "capacity _segment_from_vessel 2D": (seg, shape_2d, seg_step(shape_2d)),
        "capacity _pct_from_sample": (capacity._pct_from_sample, (1000000,), 1),
    }
    return {k: v for k, v in table.items() if not names or k in names}


class Module:
    """Every instruction of an optimised HLO module (nested computations
    too) by name, and the fusions' object files."""

    def __init__(self, path: str):
        self.dump = os.path.dirname(path)
        self.prefix = os.path.basename(path).rsplit(".cpu_after_optimizations.txt", 1)[0]
        self.text = open(path).read()
        self.inst, self.comps = {}, {}
        comp = None
        for line in self.text.split("\n"):
            head = re.match(r"(?:ENTRY )?%([\w.\-]+) \(", line)
            if head and not line.startswith(" "):
                comp = head.group(1)
                self.comps[comp] = []
                continue
            m = _INST.match(line)
            if not m or comp is None:
                continue
            name, ty, op, rest = m.groups()
            arr = re.match(r"(\w+)\[([\d,]*)\]", ty)
            calls = re.search(r"calls=%([\w.\-]+)", line)
            parts = re.search(r'outer_dimension_partitions":\[([^\]]*)\]', line)
            self.inst[name] = dict(
                comp=comp, op=op, line=line,
                dtype=arr.group(1) if arr and not ty.startswith("(") else None,
                shape=tuple(int(d) for d in arr.group(2).split(",") if d) if arr else None,
                operands=re.findall(r"%([\w.\-]+)", rest.split("), ")[0]),
                calls=calls.group(1) if calls else None,
                parts=[int(p) for p in re.findall(r'"(\d+)"', parts.group(1))] if parts else [])
            self.comps[comp].append(name)
        self._libs = {}

    def body(self, name: str) -> str:
        calls = self.inst[name]["calls"]
        i = self.text.find(f"\n%{calls} (") if calls else -1
        return "" if i < 0 else self.text[i:].split("\n}")[0]

    def percentile_fusions(self):
        """The fusions whose computation forms the interpolation
        s[lo] (1 - frac) + s[hi] frac and compares with it."""
        out = []
        for name, d in self.inst.items():
            if d["op"] != "fusion":
                continue
            b = self.body(name)
            if "floor(" in b and "dynamic-slice" in b and re.search(r"add\(%mul", b):
                out.append(name)
        return out

    def run(self, name: str, inputs):
        """The fusion's output on ``inputs``, by its machine code."""
        import ctypes
        import subprocess

        from xla_markers_machine_code import _Arg, _Dim, _Frame

        d = self.inst[name]
        obj = os.path.join(self.dump, f"{self.prefix}.obj-file.{name}_kernel_module.o")
        if obj not in self._libs:
            lib = obj[:-2] + ".so"
            subprocess.run(["ld", "-shared", "-z", "notext", "-o", lib, obj], check=True)
            self._libs[obj] = ctypes.CDLL(lib)
        fn = getattr(self._libs[obj], name)
        fn.restype, fn.argtypes = ctypes.c_void_p, [ctypes.POINTER(_Frame)]
        out = np.zeros(d["shape"], _DTYPES[d["dtype"]])
        arrays = [np.ascontiguousarray(a) for a in inputs] + [out]
        args = (_Arg * len(arrays))(*[_Arg(a.ctypes.data, a.nbytes) for a in arrays])
        # the outer dimensions' partitions, numbered as one
        parts = int(np.prod(d["parts"] or [1]))
        dims = _Dim(parts, 1, 1)
        for t in range(parts):
            thread = _Dim(t, 0, 0)
            if fn(ctypes.byref(_Frame(ctypes.pointer(dims), ctypes.pointer(thread),
                                      len(arrays), args))):
                raise RuntimeError(f"{name} returned an error")
        return out

    def evaluator(self, seeds):
        """get(name): the instruction's value from ``seeds`` (name: array),
        computed by the program's own machine code (fusions), numpy's
        stable sort (sort), or the literal (scalar constants)."""
        vals = dict(seeds)

        def get(name):
            if name in vals:
                return vals[name]
            d = self.inst[name]
            op = d["op"]
            if op == "fusion":
                v = self.run(name, [get(o) for o in d["operands"]])
            elif op == "sort":
                axis = int(re.search(r"dimensions=\{(\d+)\}", d["line"]).group(1))
                v = np.sort(get(d["operands"][0]), axis=axis, kind="stable")
            elif op == "constant":
                lit = re.search(r"constant\(([^)]*)\)", d["line"]).group(1)
                v = np.asarray({"true": 1, "false": 0}.get(lit, lit),
                               dtype=_DTYPES[d["dtype"]]).reshape(())
                if lit not in ("true", "false"):
                    v = np.asarray(float(lit)).astype(_DTYPES[d["dtype"]]).reshape(())
            elif op in ("copy", "bitcast"):
                v = get(d["operands"][0]).reshape(d["shape"])
            else:
                raise LookupError(f"{name}: {op} is not evaluated")
            vals[name] = v
            return v

        return get


def sample_frame(shape, rng, want_a_less: bool, flat_step=None):
    """A frame of ``shape`` whose positive sample gives A != B with A < B
    when ``want_a_less`` (else A > B): the finalize's strided sample, or
    every ``flat_step``-th voxel of the flat frame (capacity's); every
    voxel holds a value in [5, 6) but a random share of the sample's, which
    are 0 (their count sets frac).  Returns (frame, A, B)."""
    import chip_smoke
    from nellie_tpu_torch.kernels import thresholds

    size = int(np.prod(shape))
    if flat_step is not None:
        idx = np.arange(0, size, flat_step)
    else:
        strides = thresholds.sample_strides(shape, int(1e6))
        idx = np.arange(size).reshape(shape)[tuple(slice(None, None, s) for s in strides)]
        idx = idx.reshape(-1)
    while True:
        flat = rng.uniform(5, 6, size).astype(np.float32)
        flat[idx[rng.random(idx.size) < rng.uniform(0, 0.5)]] = 0
        a, b = chip_smoke.percentile_forms_of(flat[idx])
        if a != b and (a < b) == want_a_less:
            return flat.reshape(shape), a, b


def shifts(nd):
    """The opening's seven positions: the centre and ±1 along each axis."""
    out = [(0,) * nd]
    for axis in range(nd):
        for o in (1, -1):
            out.append(tuple(o if k == axis else 0 for k in range(nd)))
    return out


def term_name(shift):
    if not any(shift):
        return "0"
    axis = next(k for k, o in enumerate(shift) if o)
    return f"{axis}{'+' if shift[axis] > 0 else '-'}"


def classify(kept, a_less):
    """'A' where a voxel at max(A, B) was kept (the fusion compared with
    min(A, B) = A when A < B), else 'B'; and the reverse when A > B."""
    return np.where(kept, "A" if a_less else "B", "B" if a_less else "A")


def count_forms(forms, last_axis_vector):
    """Counts of each form, split into the last axis's vector columns and
    its remainder."""
    out = {}
    cols = forms.shape[-1]
    vec = cols - cols % last_axis_vector
    for region, part in (("vector", forms[..., :vec]), ("remainder", forms[..., vec:])):
        if part.size:
            out[region] = {f: int((part == f).sum()) for f in ("A", "B") if (part == f).any()}
    return out


def side_of(module, name, frame_shape, operands, frame_name):
    """(axis, side) of the erosion's side term that a side fusion builds,
    read off its output on a frame with one voxel at +inf (above any
    threshold) and the rest 0: a mask padded by one along an axis holds
    the voxel in place when the pad is at the end (the consumer reads
    index + 1) and one further on when it is at the start (index - 1); a
    mask sliced and padded back to the frame's shape holds it at
    index - side."""
    nd = len(frame_shape)
    one = np.zeros(module.inst[frame_name]["shape"], np.float32)
    mid = tuple(s // 2 for s in frame_shape)
    one[(0,) * (one.ndim - nd) + mid] = np.inf
    got = module.run(name, [one if o == frame_name else v for o, v in operands])
    at = np.argwhere(got.reshape(got.shape[-nd:]).astype(bool))[0]
    off = at - np.array(mid)
    out_shape = module.inst[name]["shape"][-nd:]
    if out_shape != tuple(frame_shape):
        axis = next(k for k, (o, s) in enumerate(zip(out_shape, frame_shape)) if o != s)
        return axis, 1 if off[axis] == 0 else -1
    axis = int(np.flatnonzero(off)[0])
    return axis, -int(off[axis])


def _unpad(mask, shape, axis, side):
    """The mask's own voxels of a side fusion's output: a pad at the end
    (side +) or at the start (side -) of a longer axis dropped, or, for an
    output of the frame's shape (the mask sliced and padded back), the face
    whose term reads past the frame's edge (the fill)."""
    index = [slice(None)] * len(shape)
    if mask.shape[axis] != shape[axis]:
        index[axis] = slice(0, shape[axis]) if side > 0 else slice(1, None)
    else:
        index[axis] = slice(0, shape[axis] - 1) if side > 0 else slice(1, None)
    return mask[tuple(index)]


def analyse(name, fn, shape, step, dump, rng, vector_width):
    """program term -> {fusion, region counts of each form}."""
    import jax
    import jax.numpy as jnp

    nd = len(shape)
    result, module = {}, None
    for a_less in (True, False):
        frame, a, b = sample_frame(shape, rng, a_less, step)
        before = set(glob.glob(os.path.join(dump, "*.cpu_after_optimizations.txt")))
        out = jax.block_until_ready(fn(jnp.asarray(frame)))
        if module is None:
            new = set(glob.glob(os.path.join(dump, "*.cpu_after_optimizations.txt"))) - before
            module = next(m for m in map(Module, sorted(new)) if m.percentile_fusions())
            fusions = module.percentile_fusions()
            result["fusions"] = fusions
        z = np.float32(max(a, b))
        if nd == 1:
            # the percentile alone: the program's value is the form
            v = np.float32(np.asarray(out))
            result.setdefault("value", []).append("A" if v == a else "B" if v == b else "neither")
            continue
        frame_name = next(o for f in fusions for o in module.inst[f]["operands"]
                          if module.inst[o]["dtype"] == "f32" and
                          module.inst[o]["shape"][-nd:] == tuple(shape))
        fshape = module.inst[frame_name]["shape"]
        get = module.evaluator({frame_name: frame.reshape(fshape)})
        final = [f for f in fusions if any(o in fusions for o in module.inst[f]["operands"])]
        sides = [f for f in fusions if f not in final]
        for f in sides:
            operands = [(o, None if o == frame_name else get(o)) for o in module.inst[f]["operands"]]
            axis, side = side_of(module, f, shape, operands, frame_name)
            full = np.full(fshape, z, np.float32)
            kept = module.run(f, [full if o == frame_name else v for o, v in operands])
            kept = kept.reshape(kept.shape[-nd:]).astype(bool)
            # the mask's own voxels, not the pad
            kept = _unpad(kept, shape, axis, side)
            entry = result.setdefault(f"{axis}{'+' if side > 0 else '-'}", {"fusion": f})
            merge(entry, count_forms(classify(kept, a_less), vector_width))
        for f in final:
            for offset in range(3):
                # voxels at z on a lattice of spacing 3 (offset along the
                # last axis), the rest at 1 (below both forms); the side
                # terms all true
                test = np.ones(shape, np.float32)
                grid = tuple(slice(1, None, 3) for _ in shape[:-1]) + \
                    (slice(1 + offset, None, 3),)
                test[grid] = z
                ops = [test.reshape(fshape) if o == frame_name else
                       np.ones(module.inst[o]["shape"], np.uint8) if o in sides else get(o)
                       for o in module.inst[f]["operands"]]
                got = module.run(f, ops)
                kept = got.reshape(got.shape[-nd:]) != 0
                lattice = np.argwhere(np.isin(np.arange(test.size).reshape(shape),
                                              np.flatnonzero(test == z)))
                for sh in shifts(nd):
                    # the voxel at w - sh reads w through the dilation's
                    # position sh
                    v = lattice - np.array(sh)
                    ok = np.all((v >= 0) & (v < np.array(shape)), axis=1)
                    forms = classify(kept[tuple(v[ok].T)], a_less)
                    cols = lattice[ok][:, -1]
                    vec = shape[-1] - shape[-1] % vector_width
                    counts = {"vector": {x: int(((forms == x) & (cols < vec)).sum())
                                         for x in "AB" if ((forms == x) & (cols < vec)).any()}}
                    if vec < shape[-1]:
                        counts["remainder"] = {x: int(((forms == x) & (cols >= vec)).sum())
                                               for x in "AB"
                                               if ((forms == x) & (cols >= vec)).any()}
                    merge(result.setdefault(f"centre@{term_name(sh)}", {"fusion": f}), counts)
    return result


def merge(into, counts):
    for region, c in counts.items():
        r = into.setdefault(region, {})
        for k, v in c.items():
            r[k] = r.get(k, 0) + v


def port_forms(name, nd):
    """(centre, sides): the forms of the port's rule for the caller that
    mirrors the program."""
    from nellie_tpu_torch.kernels import frangi

    if name == "capacity _pct_from_sample":
        return frangi.B, frangi.B  # the chunked windows: frangi.masked_percentile
    return frangi.FINALIZE_FORMS[nd]


def verdict(entry):
    if isinstance(entry, list):
        return entry[0] if len(set(entry)) == 1 else "mixed"
    forms = {k for region, c in entry.items() if region != "fusion" for k in c}
    return forms.pop() if len(forms) == 1 else "mixed"


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--programs", nargs="*", default=None)
    parser.add_argument("--isa", default=None, help="XLA's --xla_cpu_max_isa, e.g. AVX2")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--shape-3d", default="x".join(map(str, SHAPE_3D)))
    parser.add_argument("--shape-2d", default="x".join(map(str, SHAPE_2D)))
    parser.add_argument("--capacity-step", type=int, default=None,
                        help="capacity's flat sample step (default: its own at the shape)")
    args = parser.parse_args()
    dump = tempfile.mkdtemp(prefix="xla_finalize_")
    flags = f" --xla_dump_to={dump} --xla_dump_hlo_as_text --xla_dump_hlo_pass_re=^$"
    if args.isa:
        flags += f" --xla_cpu_max_isa={args.isa}"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + flags).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    rng = np.random.default_rng(args.seed)
    width = 8 if args.isa and not args.isa.upper().startswith("AVX512") else 16

    table, agree = {}, {}
    for name, (fn, shape, step) in programs(
            args.programs, tuple(int(v) for v in args.shape_3d.split("x")),
            tuple(int(v) for v in args.shape_2d.split("x")), args.capacity_step).items():
        res = analyse(name, fn, shape, step, dump, rng, width)
        fusions = res.pop("fusions")
        table[name] = {k: verdict(v) for k, v in res.items()}
        print(f"{name}: {len(fusions)} fusions form the percentile", flush=True)
        for k, v in res.items():
            print(f"  {k}: {verdict(v)} {v}", flush=True)
        centre, sides = port_forms(name, len(shape))
        want = {k: "AB"[centre if k.startswith("centre") else sides] for k in table[name]}
        if "value" in want:
            want["value"] = "AB"[centre]
        agree[name] = want == table[name]
        print(f"  the port's rule = the reference on every term: "
              f"{agree[name]}", flush=True)
    print(json.dumps({"forms": table, "port_agrees": agree}))


if __name__ == "__main__":
    main()
