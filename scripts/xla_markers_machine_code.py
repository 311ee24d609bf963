"""Which products XLA's CPU machine code contracts in Markers' sunk axis-0 pass.

    python scripts/xla_markers_machine_code.py 5x48x48 --seed 3
    python scripts/xla_markers_machine_code.py 3x24x122 --seed 3
    python scripts/xla_markers_machine_code.py 5x48x48 --seed 3 --isa AVX2

Compiles the JAX package's jitted ``markers_frame_distance`` on the CPU for
one frame of the Markers tests (``chip_smoke.filter_frame`` thresholded at
300) at 5 px, with ``XLA_FLAGS --xla_dump_to`` into a temporary directory,
which holds each fusion's object file beside its IR.  For the scale whose
axis-0 order-2 kernel has three taps and a negative centre weight (the
second, sigma 0.733 / 2.5), it takes the fusions that compute that pass
with the clamped distance inline (the centre a select whose other arm is
``0 * w = -0``) and:

1. disassembles each one's vector loop (``objdump -d``) and prints its
   floating-point instructions up to the first store: on AVX-512 the select
   folds into the first add as a masked ``vaddps ...{%k}`` of two rounded
   products, and the third tap is a ``vfmadd231ps``;
2. links each object file into a shared library (``ld -shared``), runs the
   fusion's machine code (XLA's kernel call frame: thread dims, thread, the
   arguments and the result) on the frame's mask and distance, and counts
   each element of its output as the rule of the vector loop (neither
   product of the first add contracted), of the scalar loops (tap 0
   contracted, the centre rounded) or neither, by region: the core rows in
   the vector columns, the last axis's remainder columns, and the rows the
   fusion pads by reflection.

``--isa AVX2`` compiles under ``--xla_cpu_max_isa=AVX2`` (no masked adds);
there every element takes the scalar loops' rule.
``nellie_tpu_torch.kernels.filters.log_program`` mirrors the default
(AVX-512) rule.  The last line is one JSON object: for each fusion, its
region counts.
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))


class _Arg(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("size", ctypes.c_size_t)]


class _Dim(ctypes.Structure):
    _fields_ = [("x", ctypes.c_uint64), ("y", ctypes.c_uint64), ("z", ctypes.c_uint64)]


class _Frame(ctypes.Structure):
    _fields_ = [("thread_dims", ctypes.POINTER(_Dim)), ("thread", ctypes.POINTER(_Dim)),
                ("num_args", ctypes.c_size_t), ("args", ctypes.POINTER(_Arg))]


_LINE = re.compile(r"\s*(?:ROOT )?%([\w.\-]+) = (\w+)\[([\d,]*)\]\S* (\w[\w-]*)\((.*)")


class Program:
    """The optimised HLO's entry instructions and the fusions' object files."""

    def __init__(self, dump: str, module: str):
        self.dump = dump
        path = glob.glob(os.path.join(dump, f"module_*.{module}.cpu_after_optimizations.txt"))[0]
        self.prefix = os.path.basename(path).rsplit(".cpu_after_optimizations.txt", 1)[0]
        self.text = open(path).read()
        self.inst = {}
        for line in self.text[self.text.index("ENTRY"):].split("\n")[1:]:
            m = _LINE.match(line)
            if not m:
                continue
            name, dtype, dims, op, rest = m.groups()
            parts = re.search(r'outer_dimension_partitions":\["(\d+)"', line)
            calls = re.search(r"calls=%([\w.\-]+)", line)
            self.inst[name] = dict(
                dtype=dtype, shape=tuple(int(d) for d in dims.split(",") if d), op=op,
                operands=re.findall(r"%([\w.\-]+)", rest.split("), ")[0]),
                parts=int(parts.group(1)) if parts else 1,
                calls=calls.group(1) if calls else None)
        self._libs = {}

    def body(self, name: str) -> str:
        calls = self.inst[name]["calls"]
        i = self.text.find(f"\n%{calls} (") if calls else -1
        return "" if i < 0 else self.text[i:].split("\n}")[0]

    def object_file(self, name: str) -> str:
        """The fusion's object file, or that of a fusion XLA compiled the same
        computation for (it emits one kernel for identical fusions)."""
        path = os.path.join(self.dump, f"{self.prefix}.obj-file.{name}_kernel_module.o")
        if os.path.exists(path):
            return path

        def norm(n):
            b = re.sub(r", metadata=\{[^}]*\}", "", self.body(n))
            return re.sub(r"\n%v \(.*?\) ->", "", re.sub(r"%[\w.\-]+", "%v", b))

        twin = next(n for n in self.inst if n != name and norm(n) == norm(name) and
                    self.inst[n]["shape"] == self.inst[name]["shape"] and
                    os.path.exists(os.path.join(self.dump,
                                                f"{self.prefix}.obj-file.{n}_kernel_module.o")))
        return self.object_file(twin)

    def run(self, name: str, inputs):
        """The fusion's output on ``inputs``, computed by its machine code."""
        d = self.inst[name]
        if d["op"] == "concatenate":
            axis = int(re.search(r"dimensions=\{(\d+)\}", self.text.split(f"%{name} = ")[1]
                                 .split("\n")[0]).group(1))
            return np.concatenate(inputs, axis=axis)
        obj = self.object_file(name)
        if obj not in self._libs:
            lib = os.path.join(self.dump, os.path.basename(obj)[:-2] + ".so")
            subprocess.run(["ld", "-shared", "-z", "notext", "-o", lib, obj], check=True)
            self._libs[obj] = ctypes.CDLL(lib)
        symbol = re.search(r"obj-file\.(.+)_kernel_module\.o$", obj).group(1)
        fn = getattr(self._libs[obj], symbol)
        fn.restype, fn.argtypes = ctypes.c_void_p, [ctypes.POINTER(_Frame)]
        out = np.zeros(d["shape"], {"f32": np.float32, "pred": np.uint8}[d["dtype"]])
        arrays = [np.ascontiguousarray(a) for a in inputs] + [out]
        args = (_Arg * len(arrays))(*[_Arg(a.ctypes.data, a.nbytes) for a in arrays])
        dims = _Dim(d["parts"], 1, 1)
        for t in range(d["parts"]):
            thread = _Dim(t, 0, 0)
            if fn(ctypes.byref(_Frame(ctypes.pointer(dims), ctypes.pointer(thread), len(arrays),
                                      args))):
                raise RuntimeError(f"{name} returned an error")
        return out


def vector_loop(obj: str, limit: int = 14):
    """The floating-point instructions of the object file's first loop of
    256-bit vectors that stores a result, up to that store."""
    asm = subprocess.run(["objdump", "-d", "--no-show-raw-insn", obj], check=True,
                         capture_output=True, text=True).stdout.split("\n")
    start = next((i for i, l in enumerate(asm) if "vmulps" in l and "ymm" in l), None)
    if start is None:
        return []
    out = []
    for line in asm[start:]:
        if re.search(r"\tv(mul|add|sub|fn?madd\d+)ps", line):
            out.append(line.split("\t", 1)[1].strip())
        if "vmovups %ymm" in line and "(" in line.split(",")[-1]:
            break
    return out[:limit]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("shape", help="frame shape, e.g. 5x48x48")
    parser.add_argument("--seed", type=int, default=3)
    parser.add_argument("--isa", default=None, help="XLA's --xla_cpu_max_isa, e.g. AVX2")
    args = parser.parse_args()
    shape = tuple(int(s) for s in args.shape.split("x"))
    dump = tempfile.mkdtemp(prefix="xla_markers_mc_")
    flags = f" --xla_dump_to={dump} --xla_dump_hlo_as_text --xla_dump_hlo_pass_re=^$"
    if args.isa:
        flags += f" --xla_cpu_max_isa={args.isa}"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + flags).strip()

    import jax
    import jax.numpy as jnp

    import chip_smoke
    import test_torch_log_programs as T
    from nellie_tpu.stages import mocap_marking as jm
    from nellie_tpu_torch.kernels import filters
    from nellie_tpu_torch.kernels._fp import f32, fma

    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    frame = chip_smoke.filter_frame(shape, seed=args.seed)
    raw, mask = np.clip(frame, 0, 65535).astype(np.uint16), frame > 300
    params = T._marker_params(jm, 5.0)
    jm.markers_frame_distance(jnp.asarray(raw), jnp.asarray(mask), params)
    dist = np.asarray(jm._clamped_distance(jnp.asarray(mask), params))
    prog = Program(dump, "jit_markers_frame_distance")

    weights = filters.gaussian_kernel1d(params.sigma_vec(params.sigmas[1])[0], 4.0, order=2)
    w0, w1 = f32(weights[0]), f32(weights[1])
    print(f"sigmas {params.sigmas}; the second scale's axis-0 order-2 taps {w0!r}, {w1!r}, "
          f"{w0!r}; dump in {dump}")
    d = torch.from_numpy(dist.copy())
    xp = filters.pad_symmetric(d, 0, 1, 1)
    x0, x1, x2 = xp[:-2], xp[1:-1], xp[2:]
    rules = {"vector": fma(x2, w0, x0 * w0 + x1 * w1).numpy(),
             "scalar": fma(x2, w0, fma(x0, w0, x1 * w1)).numpy()}
    vals = {"mask.1": mask.astype(np.uint8), "minimum_sqrt_fusion": dist}

    def get(name):
        if name not in vals:
            if prog.inst[name]["op"] not in ("fusion", "concatenate"):
                raise LookupError(f"{name} is not computed from the mask and the distance")
            vals[name] = prog.run(name, [get(o) for o in prog.inst[name]["operands"]])
        return vals[name]

    centre = "constant(%.9g)" % w1
    summary = {}
    for name, d_ in prog.inst.items():
        if d_["op"] != "fusion" or centre not in prog.body(name) or \
                "minimum(" not in prog.body(name) or len(d_["shape"]) != 3 or \
                d_["shape"][0] != shape[0] or d_["shape"][2] != shape[2]:
            continue
        try:
            out = get(name)
        except LookupError:
            continue  # reads the intensity (the peak fusion)
        pad = out.shape[1] - shape[1]
        off = next((o for o in range(pad + 1) if np.mean(
            (out[:, o:o + shape[1]] == rules["vector"]) |
            (out[:, o:o + shape[1]] == rules["scalar"])) > 0.99), None)
        if off is None:
            continue  # a fusion that only reads the pass
        core = out[:, off:off + shape[1]]
        vec_cols = shape[2] - shape[2] % 8
        regions = {"core, vector columns": (core[..., :vec_cols], rules["vector"][..., :vec_cols],
                                            rules["scalar"][..., :vec_cols]),
                   "core, remainder columns": (core[..., vec_cols:],
                                               rules["vector"][..., vec_cols:],
                                               rules["scalar"][..., vec_cols:])}
        rows = list(range(off - 1, -1, -1)) + list(range(off + shape[1], out.shape[1]))
        mirror = list(range(off)) + list(range(shape[1] - 1, shape[1] - 1 - (pad - off), -1))
        if rows:
            regions["reflected rows"] = (out[:, rows], rules["vector"][:, mirror],
                                         rules["scalar"][:, mirror])
        counts = {}
        for region, (got, vec, sca) in regions.items():
            if got.size:
                counts[region] = {"vector only": int(((got == vec) & (got != sca)).sum()),
                                  "scalar only": int(((got == sca) & (got != vec)).sum()),
                                  "neither": int(((got != vec) & (got != sca)).sum()),
                                  "elements": int(got.size)}
        summary[name] = counts
        print(f"{name} {d_['shape']}: the pass at rows {off}..{off + shape[1] - 1}")
        for line in vector_loop(prog.object_file(name)):
            print("   ", line)
        for region, c in counts.items():
            print(f"  {region}: {c}")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
