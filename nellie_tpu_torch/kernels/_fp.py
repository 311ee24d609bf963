"""float32 arithmetic that rounds where the reference rounds.

XLA compiles the JAX package's fused elementwise code with fused
multiply-add contraction: ``a*b + c`` is rounded once, not twice.  PyTorch
rounds after each operation.  :func:`fma` rounds once on every device: on
a CUDA tensor it launches the hand-written kernel ``csrc/fma_f32.cu``
(the hardware's ``fmaf``; built for ``sm_90a`` with ``nvcc`` on first use,
bound through ``ctypes``), or raises; on CPU tensors it runs
:func:`fma_plain`, which rounds to odd in float64 and then once to
float32.  ``FMA_KERNEL.launches`` counts the kernel's launches.

A straight-line program of such steps (:func:`chain`: at most 16 steps
``fma(x, y, z)``, ``x * y`` or ``x + y`` over four registers, tensor views
and constants) is one launch of the same library's chain entry point on the
card (``FMA_CHAIN_KERNEL.launches``) and the same steps one by one
(:func:`run_steps`) on the CPU: the sums of products and squares, the dot
product's lanes and the log and exp polynomials run so.

A sum of products ``p0 + p1 + ... `` is contracted by XLA with the LEFT
product of the first addition fused: ``fma(a0, b0, a1*b1)``, then
``fma(ai, bi, acc)`` for each further term.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from nellie_tpu_torch.kernels._cuda import BASE_FLAGS, CudaKernel, check_error

Operand = Union[torch.Tensor, float]


def f32(value: float) -> float:
    """A Python float rounded to the nearest float32 (a weak-typed constant)."""
    return float(np.float32(value))


def _hex_f32(*words: str) -> Tuple[float, ...]:
    return tuple(f32(float.fromhex(w)) for w in words)


# XLA's CPU log (Eigen's ``plog_float``, the Cephes polynomial), its
# constants as the float32 values in its code
_LOG_P = _hex_f32("0x1.2043760000000p-4", "-0x1.d7a3700000000p-4", "0x1.de4a340000000p-4",
                  "-0x1.fcba9e0000000p-4", "0x1.23d37e0000000p-3", "-0x1.555ca00000000p-3",
                  "0x1.999d580000000p-3", "-0x1.fffff80000000p-3", "0x1.5555540000000p-2")
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRT_HALF = f32(float.fromhex("0x1.6a09e60000000p-1"))


def _log_polynomial(r, e):
    """The chain of XLA's log after the reduction, from r = m - 1 and the
    exponent e: with r2 = r*r and r3 = r2*r,
    y = fma(fma(fma(y0, r3, y1), r3, y2), r3, e*q1) of the three Horner
    pairs y0, y1, y2, then fma(q2, e, fma(-0.5, r2, r) + y)."""
    p = _LOG_P
    return [(R0, FMA, r, p[0], p[1]), (R0, FMA, R0, r, p[2]),      # y0
            (R1, FMA, r, p[3], p[4]), (R1, FMA, R1, r, p[5]),      # y1
            (R2, MUL, r, r), (R3, MUL, R2, r),                      # r2, r3
            (R0, FMA, R0, R3, R1),
            (R1, FMA, r, p[6], p[7]), (R1, FMA, R1, r, p[8]),      # y2
            (R0, FMA, R0, R3, R1),
            (R1, MUL, e, f32(_LOG_Q1)), (R0, FMA, R0, R3, R1),      # y
            (R1, FMA, -0.5, R2, r), (R1, ADD, R1, R0),
            (R0, FMA, _LOG_Q2, e, R1)]


def log(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` as XLA computes it on the CPU, bit for bit: x = m·2**e
    with m in [√½, √2), a degree-8 polynomial in m - 1 with XLA's fused
    multiply-adds, e·ln 2 added as two parts; subnormal inputs flushed to
    zero (−inf), negative ones NaN.  PyTorch's ``log`` differs from it in
    the last bit on some inputs."""
    x = x.float()
    x = torch.where(x.abs() < _TINY, torch.zeros_like(x), x)
    bits = torch.clamp(x, min=_TINY).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)  # mantissa in [0.5, 1)
    small = m < _SQRT_HALF
    e = e - small.float()
    r = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    out = _LOG_CHAIN(r, e)
    out = torch.where(x < 0, torch.full_like(out, float("nan")), out)
    out = torch.where(x == 0, torch.full_like(out, -float("inf")), out)
    return torch.where(torch.isposinf(x) | torch.isnan(x), x, out)


def log10(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log10``: XLA's natural log times float32(1/ln 10)."""
    return log(x) * f32(1.0 / np.log(10.0))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as XLA computes ``jnp.sqrt``
    on the CPU; PyTorch's vectorised CPU ``sqrt`` is off by one ulp on
    about one input in 150.  The float64 root rounds correctly to float32."""
    return torch.sqrt(x.double()).float()


# XLA's CPU exp (the Cephes polynomial it emits for float32), its constants
# as the float32 values in its code
_EXP_LO, _EXP_HI = -87.8, 88.8
_EXP_LOG2E = 1.4426950216293335
_EXP_C1, _EXP_C2 = 0.693359375, -2.1219444170128554e-4
_EXP_P = (1.9875691214110702e-4, 1.398199936375022e-3, 8.333452045917511e-3,
          4.166579619050026e-2, 0.1666666567325592, 0.5)
_TINY = float(np.finfo(np.float32).tiny)


def _exp_polynomial(x, n):
    """The chain of XLA's exp from the clamped x and n: r = x - n ln 2 in two
    fused parts, z = the Horner polynomial in r, then 1 + fma(z, r*r, r)."""
    return [(R0, FMA, -_EXP_C1, n, x), (R0, FMA, -_EXP_C2, n, R0),  # r
            (R1, FMA, R0, _EXP_P[0], _EXP_P[1]),
            *[(R1, FMA, R1, R0, p) for p in _EXP_P[2:]],
            (R2, MUL, R0, R0), (R1, FMA, R1, R2, R0), (R1, ADD, 1.0, R1)]


def exp(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` as XLA computes it on the CPU, bit for bit: the argument
    split into n·ln 2 + r (n = floor(x·log2 e + ½), clamped to ±127), a
    degree-6 polynomial in r with XLA's fused multiply-adds, scaled by 2**n,
    and results below the smallest normal float32 flushed to zero as XLA's
    CPU code flushes them.  PyTorch's ``exp`` differs from it in the last
    bit on about one input in ten."""
    x = torch.clamp(x.float(), f32(_EXP_LO), f32(_EXP_HI))
    n = torch.clamp(torch.floor(fma(x, _EXP_LOG2E, 0.5)), -127.0, 127.0)
    z = _EXP_CHAIN(x, n)
    y = z * ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(y < _TINY, torch.zeros_like(y), y)


# glibc's float cosine (sysdeps/ieee754/flt-32/s_cosf.c and sincosf_data.c,
# in glibc since 2.28), which XLA's CPU code calls for ``jnp.cos``: the
# reduction constants and the cosine and sine polynomials, in double
_COS_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")  # 2/π · 2**24
_COS_HPI = float.fromhex("0x1.921FB54442D18p0")  # π/2
# π/2 split so that n·hi is exact for |n| < 2**7: x - n·π/2 as glibc's
# FMA build of ``cosf`` (the one x86-64 runs) rounds it, once
_COS_HPI_HI = float.fromhex("0x1.921FB54442C00p0")
_COS_HPI_LO = _COS_HPI - _COS_HPI_HI
_COS_C = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5", "-0x1.6c087e89a359dp-10",
    "0x1.99343027bf8c3p-16"))
_SIN_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"))


def _top12(x: torch.Tensor) -> torch.Tensor:
    return (x.abs().view(torch.int32) >> 20) & 0x7FF


_TOP12_PIO4 = int((np.float32(np.pi / 4).view(np.int32) >> 20) & 0x7FF)
_TOP12_TINY = int((np.float32(2.0 ** -12).view(np.int32) >> 20) & 0x7FF)


def _cos_poly(x2: torch.Tensor, sign: Operand) -> torch.Tensor:
    x4 = x2 * x2
    c2 = _COS_C[3] * sign + x2 * (_COS_C[4] * sign)
    c1 = _COS_C[0] * sign + x2 * (_COS_C[1] * sign)
    c = c1 + x4 * (_COS_C[2] * sign)
    return c + (x4 * x2) * c2


def _sin_poly(x: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    x3 = x * x2
    s1 = _SIN_S[1] + x2 * _SIN_S[2]
    return (x + x3 * _SIN_S[0]) + (x3 * x2) * s1


def cos(y: torch.Tensor) -> torch.Tensor:
    """``jnp.cos`` as XLA computes it on the CPU, bit for bit: glibc's
    ``cosf``.  In double: below |y| ≈ π/4 (glibc compares the top 12 bits)
    the cosine polynomial; otherwise n = round(y·2/π) by glibc's integer
    trick, y - n·π/2, and the sine or cosine polynomial with the
    quadrant's signs; one rounding to float32 at the end.  Held to
    ``jax.jit(jnp.cos)`` for |y| < 120, where glibc takes this path; NaN
    stays NaN.  Every step is an IEEE float64 add or multiply, so the card
    rounds it as the CPU does (glibc's FMA build of ``cosf`` gives the same
    float32 results on the sampled ranges)."""
    y = y.float()
    x = y.double()
    top = _top12(y)
    n = ((x * _COS_HPI_INV).to(torch.int32) + 0x800000) >> 24
    r = (x - n.double() * _COS_HPI_HI) - n.double() * _COS_HPI_LO
    quadrant = n & 3
    sign = torch.where((quadrant == 1) | (quadrant == 2), -1.0, 1.0).double()
    table = torch.where((n & 2) != 0, -1.0, 1.0).double()
    reduced = torch.where((n & 1) == 0, _cos_poly(r * r, table), _sin_poly(r * sign, r * r))
    small = top < _TOP12_PIO4
    out = torch.where(small, _cos_poly(x * x, 1.0), reduced).float()
    out = torch.where(small & (top < _TOP12_TINY), torch.ones_like(out), out)
    return torch.where(torch.isnan(y), y, out)


def _f32_bits(*words: int) -> Tuple[float, ...]:
    return tuple(float(v) for v in np.array(words, np.uint32).view(np.float32))


# glibc's float arctangent (fdlibm's s_atanf.c and e_atan2f.c, float
# arithmetic), which XLA's CPU code calls for ``jnp.arctan2``
_ATAN_HI = _f32_bits(0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA)
_ATAN_LO = _f32_bits(0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168)
_ATAN_T = _f32_bits(0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E, 0xBD9D8795,
                    0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221, 0x3C8569D7)
_PI, _PI_LO, _PI_O_2 = _f32_bits(0x40490FDB, 0xB3BBBD2E, 0x3FC90FDB)


def _atan_abs(x: torch.Tensor) -> torch.Tensor:
    """fdlibm's ``atanf`` of a finite x ≥ 0: one of five argument
    reductions by the bits of x, the odd and even halves of the aT
    polynomial, and atan(c) as a hi/lo pair."""
    ix = x.view(torch.int32)
    one = torch.ones_like(x)
    band = ((ix >= 0x3EE00000).int() + (ix >= 0x3F300000).int() + (ix >= 0x3F980000).int()
            + (ix >= 0x401C0000).int())  # 0: |x| < 7/16, then atan(0.5|1|1.5|inf) bands
    xr = torch.where(band == 0, x, -one / x)
    xr = torch.where(band == 1, (2.0 * x - one) / (2.0 + x), xr)
    xr = torch.where(band == 2, (x - one) / (x + one), xr)
    xr = torch.where(band == 3, (x - 1.5) / (one + 1.5 * x), xr)
    z = xr * xr
    w = z * z
    s1 = torch.full_like(w, _ATAN_T[10])
    for k in (8, 6, 4, 2, 0):
        s1 = _ATAN_T[k] + w * s1
    s2 = torch.full_like(w, _ATAN_T[9])
    for k in (7, 5, 3, 1):
        s2 = _ATAN_T[k] + w * s2
    poly = xr * (z * s1 + w * s2)
    hi = lo = torch.zeros_like(x)
    for i in range(4):
        hi = torch.where(band == i + 1, _ATAN_HI[i], hi)
        lo = torch.where(band == i + 1, _ATAN_LO[i], lo)
    out = torch.where(band == 0, xr - poly, hi - ((poly - lo) - xr))
    return torch.where(ix >= 0x4C000000, f32(_ATAN_HI[3] + _ATAN_LO[3]), out)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jnp.arctan2`` as XLA computes it on the CPU, bit for bit: glibc's
    ``atan2f`` (fdlibm), in float32 adds, multiplies and divides, which
    the card rounds as the CPU does.  For finite arguments; NaN gives NaN."""
    y, x = y.float(), x.float()
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    k = (iy - ix) >> 23
    z = _atan_abs((y / x).abs())
    z = torch.where(k > 60, f32(_PI_O_2 + f32(0.5 * _PI_LO)), z)
    z = torch.where((hx < 0) & (k < -60), 0.0, z)
    quadrant = ((hy >> 31) & 1) | ((hx >> 30) & 2)  # 2·sign(x) + sign(y)
    out = torch.where(quadrant == 0, z, -z)
    out = torch.where(quadrant == 2, _PI - (z - _PI_LO), out)
    out = torch.where(quadrant == 3, (z - _PI_LO) - _PI, out)
    at_one = _atan_abs(y.abs())  # x == 1.0 returns atanf(y)
    out = torch.where(hx == 0x3F800000, torch.where(hy < 0, -at_one, at_one), out)
    y_zero = iy == 0
    out = torch.where(y_zero, torch.where(quadrant < 2, y, torch.where(quadrant == 2, _PI, -_PI)),
                      out)
    out = torch.where((ix == 0) & ~y_zero, torch.where(hy < 0, -_PI_O_2, _PI_O_2), out)
    return torch.where(torch.isnan(x) | torch.isnan(y), x + y, out)


def acos(x: torch.Tensor) -> torch.Tensor:
    """``jnp.arccos`` as XLA lowers it: ``atan2(sqrt((1 - x)(1 + x)), x)``."""
    x = x.float()
    one = torch.ones_like(x)
    return atan2(sqrt((one - x) * (one + x)), x)


def flush(x: torch.Tensor) -> torch.Tensor:
    """A subnormal float32 result flushed to a zero of its sign, as XLA's
    CPU code runs with flush-to-zero; other values, NaN included, pass."""
    return torch.where(x.abs() < _TINY, x * 0.0, x)


def _wide(x: Operand):
    """A float64 operand that holds a float32 value: tensors through
    float32 (float16 values are exact in it), numbers rounded to float32 as
    XLA rounds a weak-typed constant."""
    if isinstance(x, torch.Tensor):
        return (x if x.dtype == torch.float32 else x.float()).double()
    return f32(x)


def fma_plain(a: Operand, b: Operand, c: Operand) -> torch.Tensor:
    """``a*b + c`` rounded once to float32, in plain torch on any device.

    The product of two float32 values is exact in float64; the sum is
    rounded to odd: a two-sum gives its rounding error, and where that is
    not 0 and the float64 sum's last bit is even, the sum steps one ulp
    toward the error.  Rounding that to float32 is then correct, since
    53 >= 24 + 2 bits; infinities and NaN pass through."""
    a, b, c = (_wide(x) for x in (a, b, c))
    if not isinstance(c, torch.Tensor) and not isinstance(a, torch.Tensor) \
            and not isinstance(b, torch.Tensor):
        c = torch.tensor(c, dtype=torch.float64)
    p = a * b
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)  # NaN where s is not finite
    bits = s.view(torch.int64)
    # away from zero where err has the sum's sign, toward it otherwise
    step = torch.where((err > 0) == (s > 0), 1, -1)
    fix = ((bits & 1) == 0) & ((err > 0) | (err < 0))
    return torch.where(fix, bits + step, bits).view(torch.float64).float()


# the largest number of axes fma_f32.cu walks with strides
_FMA_MAX_DIMS = 4


def _merge_axes(shape, strides):
    """(sizes, strides by operand) with size-1 axes dropped and each axis
    merged into the one before it where every operand steps across the
    pair as across one axis."""
    sizes, merged = [], [[] for _ in strides]
    for axis, size in enumerate(shape):
        if size == 1:
            continue
        if sizes and all(st[-1] == s[axis] * size for st, s in zip(merged, strides)):
            sizes[-1] *= size
            for st, s in zip(merged, strides):
                st[-1] = s[axis]
            continue
        sizes.append(size)
        for st, s in zip(merged, strides):
            st.append(s[axis])
    if not sizes:
        return [1], [[0] for _ in strides]
    return sizes, merged


class _FmaKernel(CudaKernel):
    """The compiled fused multiply-add (``csrc/fma_f32.cu``), built once
    per process, with a launch count; the library also holds the chain
    entry point (:data:`FMA_CHAIN_KERNEL`)."""

    source = "fma_f32.cu"
    flags = (*BASE_FLAGS, "-fmad=false")

    def bind(self, lib):
        ptr, f = ctypes.c_void_p, ctypes.c_float
        lib.fma_f32.argtypes = [ptr, ctypes.c_longlong, ctypes.c_int, ptr, ptr, ptr, ptr, ptr]
        lib.fma_f32.restype = ctypes.c_int
        lib.fma_f32_flat.argtypes = [ptr, ctypes.c_longlong, ptr, ptr, ptr, f, f, f,
                                     ctypes.c_int, ptr]
        lib.fma_f32_flat.restype = ctypes.c_int
        lib.fma_chain.argtypes = [ptr, ctypes.c_longlong, ptr, ptr, ptr, ptr]
        lib.fma_chain.restype = ctypes.c_int

    @staticmethod
    def _flat_operands(ops):
        """(device, shape, pointers, values, broadcast bits) when every
        tensor operand is a float32 CUDA tensor of one device, contiguous
        of one shape or 0-dim (read once, bit k of the bits set), and the
        others numbers; else None: the call that needs no layout work."""
        dev = shape = None
        ptrs, values, broadcast = [], [], 0
        for k, x in enumerate(ops):
            if isinstance(x, torch.Tensor):
                if x.device.type != "cuda" or x.dtype != torch.float32 or \
                        (dev is not None and x.device != dev):
                    return None
                dev = x.device
                if x.dim() == 0:
                    broadcast |= 1 << k
                elif not x.is_contiguous() or (shape is not None and x.shape != shape):
                    return None
                else:
                    shape = x.shape
                ptrs.append(x.data_ptr())
                values.append(0.0)
            else:
                ptrs.append(None)
                values.append(x)
        return dev, (torch.Size(()) if shape is None else shape), ptrs, values, broadcast

    def __call__(self, a: Operand, b: Operand, c: Operand) -> torch.Tensor:
        """``a*b + c`` as a new C-contiguous float32 tensor on the operands'
        CUDA device.  Operands are CUDA tensors of one device, numbers, or
        0-dim CPU tensors (taken as numbers); they broadcast.  Float32
        tensors are read in place, strided or broadcast views included;
        other float types are first copied to float32, and the views are
        copied to contiguous tensors only when more than four axes remain
        after merging.  Contiguous float32 operands of one shape (and 0-dim
        ones) take a direct call."""
        flat = self._flat_operands((a, b, c))
        if flat is not None:
            dev, shape, ptrs, values, broadcast = flat
            lib = self._lib or self.build()
            with self.on_device(dev):
                out = torch.empty(shape, dtype=torch.float32, device=dev)
                if out.numel():
                    err = lib.fma_f32_flat(out.data_ptr(), out.numel(), *ptrs, *values, broadcast,
                                           torch.cuda.current_stream(dev).cuda_stream)
                    check_error("fma_f32 launch", err)
                    self.count_launch()
            return out
        dev = next(x.device for x in (a, b, c)
                   if isinstance(x, torch.Tensor) and x.device.type == "cuda")
        ops = [_cuda_operand(x, dev, "fma") for x in (a, b, c)]
        shapes = [x.shape for x in ops if isinstance(x, torch.Tensor)]
        shape = shapes[0] if all(sh == shapes[0] for sh in shapes) else \
            torch.broadcast_shapes(*shapes)
        views = [(x if x.shape == shape else x.expand(shape))
                 if isinstance(x, torch.Tensor) else None for x in ops]
        lib = self._lib or self.build()
        with self.on_device(dev):
            out = torch.empty(shape, dtype=torch.float32, device=dev)
            n = out.numel()
            if n == 0:
                return out
            sizes, strides = _merge_axes(shape, [v.stride() if v is not None else
                                                 (0,) * len(shape) for v in views])
            if len(sizes) > _FMA_MAX_DIMS:
                views = [v.contiguous() if v is not None else None for v in views]
                sizes, strides = [n], [[1 if v is not None else 0] for v in views]
            pad = (0,) * (_FMA_MAX_DIMS - len(sizes))
            err = lib.fma_f32(
                out.data_ptr(), n, len(sizes), _FmaShape(*sizes, *pad),
                _FmaPointers(*(v.data_ptr() if v is not None else None for v in views)),
                _FmaValues(*(0.0 if v is not None else x for v, x in zip(views, ops))),
                _FmaStrides(*(s for st in strides for s in (*st, *pad))),
                torch.cuda.current_stream().cuda_stream)
        check_error("fma_f32 launch", err)
        self.count_launch()
        return out


def _cuda_operand(x, dev, name):
    """An operand for a kernel on CUDA device ``dev``: a float32 tensor on
    it (other float types copied) or a float32 number (from a number or a
    0-dim CPU tensor)."""
    if isinstance(x, torch.Tensor):
        if x.device != dev:
            if x.device.type != "cpu" or x.dim() != 0:
                raise ValueError(f"{name} operands on {x.device} and {dev}")
            return f32(float(x))
        if not x.dtype.is_floating_point:
            raise TypeError(f"{name} takes floating-point operands, not {x.dtype}")
        return x if x.dtype == torch.float32 else x.float()
    return f32(x)


_FmaShape = ctypes.c_longlong * _FMA_MAX_DIMS
_FmaPointers = ctypes.c_void_p * 3
_FmaValues = ctypes.c_float * 3
_FmaStrides = ctypes.c_longlong * (3 * _FMA_MAX_DIMS)
FMA_KERNEL = _FmaKernel()


def fma(a: Operand, b: Operand, c: Operand) -> torch.Tensor:
    """``a*b + c`` rounded once to float32, as XLA's contracted
    multiply-add: the hand-written kernel when an operand is a CUDA tensor
    (or it raises), :func:`fma_plain` on CPU tensors."""
    devices = {x.device.type for x in (a, b, c) if isinstance(x, torch.Tensor)}
    if "cuda" in devices:
        return FMA_KERNEL(a, b, c)
    if devices <= {"cpu"}:
        return fma_plain(a, b, c)
    raise ValueError(f"fma: unsupported devices {sorted(devices)}")


# ---------------------------------------------------------------------------
# chains: straight-line programs of multiply-adds, one launch on the card
# ---------------------------------------------------------------------------


class Reg(int):
    """A register of a chain program (0 to ``CHAIN_REGS - 1``)."""


R0, R1, R2, R3 = (Reg(i) for i in range(4))
FMA, MUL, ADD = 0, 1, 2  # a step's operation: fma(x, y, z), x * y, x + y
CHAIN_REGS, CHAIN_STEPS, CHAIN_LOADS, CHAIN_SLOTS = 4, 16, 16, 8
_SRC_LOAD, _SRC_CONST = CHAIN_REGS, CHAIN_REGS + CHAIN_LOADS
# fma_chain's int64 header: ndim, 4 sizes, slots, 8 x 4 strides, loads,
# 16 load slots, 16 load offsets, steps, 5 codes a step, then the kind
_META_LEN = 73 + 5 * CHAIN_STEPS
# the kinds of program fma_f32.cu runs: any program (its codes read from
# the header), one accumulator, and the programs it compiles in full
KIND_GENERAL, KIND_ACCUMULATE, KIND_LOG, KIND_EXP, KIND_LANES = range(5)


def run_steps(steps, fma_fn=None) -> torch.Tensor:
    """The chain ``steps`` one operation at a time: the plain version with
    :func:`fma_plain` (the default), or the per-call composition with
    :func:`fma`.  A step is ``(destination register, FMA, x, y, z)``,
    ``(register, MUL, x, y)`` or ``(register, ADD, x, y)``; a source is a
    :class:`Reg`, a tensor or a number.  Returns the last step's value."""
    fma_fn = fma_plain if fma_fn is None else fma_fn
    regs = [None] * CHAIN_REGS
    out = None
    for dst, op, *args in steps:
        v = [regs[a] if isinstance(a, Reg) else a for a in args]
        if op == FMA:
            out = fma_fn(v[0], v[1], v[2])
        elif op == MUL:
            out = v[0] * v[1]
        else:
            out = v[0] + v[1]
        regs[dst] = out
    return out


def chain(steps) -> torch.Tensor:
    """A straight-line program of multiply-adds (see :func:`run_steps`),
    as its steps round: one launch of the chain kernel when a source is a
    CUDA tensor and every tensor source is float32, the per-call
    composition (one ``fma_f32`` launch an ``FMA`` step) for other float
    types on the card, the plain version on CPU tensors."""
    program = _chain_program(steps)
    devices = {t.device.type for t in program[1]}
    if "cuda" in devices:
        if all(t.dtype == torch.float32 for t in program[1]):
            return FMA_CHAIN_KERNEL(steps, program)
        return run_steps(steps, fma)
    if devices <= {"cpu"}:
        return run_steps(steps)
    raise ValueError(f"chain: unsupported devices {sorted(devices)}")


def accumulate(first, pairs) -> torch.Tensor:
    """``acc = first`` (steps that leave it in R0 and read no register),
    then for each ``(a, b)`` of ``pairs`` ``acc = fma(a, b, acc)``, or
    ``acc = acc + b`` where ``a`` is None, as chains that each keep to the
    kernel's limits (the running sum carried from one to the next)."""
    def step(a, b, acc):
        return (R0, ADD, acc, b) if a is None else (R0, FMA, a, b, acc)

    steps = list(first)
    reads = _Reads(steps)
    for a, b in pairs:
        if len(steps) == CHAIN_STEPS or not reads.fits((a, b)):
            steps = [step(a, b, chain(steps))]
            reads = _Reads(steps)
        else:
            steps.append(step(a, b, R0))
    return chain(steps)


class _Reads:
    """The tensors a chain reads so far, against the kernel's limits: at
    most ``CHAIN_LOADS`` distinct tensors and ``CHAIN_SLOTS`` distinct
    (base tensor, strides, shape) among them (an upper bound on its
    slots)."""

    def __init__(self, steps):
        self.ids, self.slots = set(), set()
        for step in steps:
            self.fits(step[2:])

    def fits(self, sources) -> bool:
        """Add ``sources`` if the chain can still take them."""
        new = {id(x): x for x in sources if isinstance(x, torch.Tensor) and id(x) not in self.ids}
        slots = {(id(_root(x)), x.stride(), x.shape) for x in new.values()}
        if len(self.ids) + len(new) > CHAIN_LOADS or len(self.slots | slots) > CHAIN_SLOTS:
            return False
        self.ids.update(new)
        self.slots |= slots
        return True


class _FmaChainKernel(CudaKernel):
    """The chain entry point of ``csrc/fma_f32.cu`` (the library of
    :data:`FMA_KERNEL`), with its own launch count."""

    source = "fma_f32.cu"
    flags = _FmaKernel.flags

    def __init__(self):
        super().__init__()
        self._layouts = {}  # program and operand layout: (header, constants, slot sources)

    def build(self):
        return FMA_KERNEL.build()

    def __call__(self, steps, program=None) -> torch.Tensor:
        """The program ``steps`` (see :func:`run_steps`, or a function that
        returns them; ``program``: their :func:`_chain_program`, when the
        caller has it) as one launch: its
        value as a new C-contiguous float32 tensor on the sources' CUDA
        device.  Sources broadcast; tensors are read in place (views of one
        tensor with the same strides are one slot at several offsets).  The
        kernel's argument block is cached by the program and its sources'
        shapes, strides and storage sharing, so a repeated call builds only
        its slot pointers."""
        if program is None:
            _check_length(steps)
            program = _chain_program(steps)
        program, tensors = program
        dev = next((t.device for t in tensors if t.device.type == "cuda"), None)
        if dev is None:
            raise TypeError("the chain kernel takes a CUDA tensor source")
        if any(t.device != dev or t.dtype != torch.float32 for t in tensors):
            # 0-dim CPU tensors become numbers, other float types float32
            ops = {id(t): _cuda_operand(t, dev, "chain") for t in tensors}
            steps = [(dst, op, *(ops[id(x)] if isinstance(x, torch.Tensor) else x
                                 for x in args)) for dst, op, *args in _steps(steps)]
            program, tensors = _chain_program(steps)
        first, layout = {}, []
        for i, t in enumerate(tensors):
            g = first.setdefault(id(_root(t)), i)
            layout.append((t.shape, t.stride(), g, t.data_ptr() - tensors[g].data_ptr()))
        key = (program, tuple(layout))
        cached = self._layouts.get(key)
        if cached is None:
            steps = _check_length(_steps(steps))
            shapes = [t.shape for t in tensors]
            shape = shapes[0] if all(sh == shapes[0] for sh in shapes) else \
                torch.broadcast_shapes(*shapes)
            n = shape.numel()
            prog = [(dst, op, [x if isinstance(x, (torch.Tensor, Reg)) else f32(x)
                               for x in args]) for dst, op, *args in steps]
            meta, _, konst, reps = _chain_layout(prog, shape, n) if n else (None, None, None, [])
            cached = (meta, konst, reps, shape, n)
            with self._lock:
                if len(self._layouts) > 4096:
                    self._layouts.clear()
                self._layouts[key] = cached
        meta, konst, reps, shape, n = cached
        lib = FMA_KERNEL._lib or FMA_KERNEL.build()
        with self.on_device(dev):
            out = torch.empty(shape, dtype=torch.float32, device=dev)
            if n == 0:
                return out
            bases = _ChainBases(*(tensors[i].data_ptr() for i in reps))
            err = lib.fma_chain(out.data_ptr(), n, meta, bases, konst,
                                torch.cuda.current_stream(dev).cuda_stream)
        check_error("fma_chain launch", err)
        self.count_launch()
        return out


_REG_KEYS = ("r0", "r1", "r2", "r3")


def _steps(steps):
    return steps() if callable(steps) else steps


def _check_length(steps):
    if not 1 <= len(steps) <= CHAIN_STEPS:
        raise ValueError(f"a chain takes 1 to {CHAIN_STEPS} steps, not {len(steps)}")
    return steps


class ChainTemplate:
    """A chain whose steps are fixed and whose tensor sources are given at
    each call (``build(*sources)`` returns the steps): its program key is
    read off stand-in sources once, so that a call on the card lays out its
    sources and builds no steps unless the layout is new."""

    def __init__(self, build, n_sources: int):
        self.build = build
        self.n_sources = n_sources
        self._key = None

    def key(self):
        """(the program, the order in which its steps first read each
        source)."""
        if self._key is None:
            stand_ins = [torch.zeros(1) for _ in range(self.n_sources)]
            program, tensors = _chain_program(self.build(*stand_ins))
            order = [next(i for i, s in enumerate(stand_ins) if s is t) for t in tensors]
            self._key = (program, order)
        return self._key

    def __call__(self, *sources) -> torch.Tensor:
        if all(isinstance(x, torch.Tensor) and x.device.type == "cuda" and
               x.dtype == torch.float32 for x in sources):
            program, order = self.key()
            return FMA_CHAIN_KERNEL(lambda: self.build(*sources),
                                    (program, [sources[i] for i in order]))
        return chain(self.build(*sources))


def _root(x: torch.Tensor) -> torch.Tensor:
    """The tensor whose storage ``x`` views (``x`` itself if not a view):
    views of one root may share a slot of the chain kernel."""
    return x if x._base is None else x._base
_ChainBases = ctypes.c_void_p * CHAIN_SLOTS


def _chain_program(steps):
    """(the program with its tensor sources numbered by first use, those
    tensors): a key of the steps that holds every constant and register."""
    ids, tensors, program = {}, [], []
    for step in steps:
        dst, op, *args = step
        if op not in (FMA, MUL, ADD) or len(args) != (3 if op == FMA else 2) or \
                not 0 <= dst < CHAIN_REGS:
            raise ValueError(f"bad chain step {step}")
        key = [int(dst), op]
        for x in args:
            if isinstance(x, Reg):
                key.append(_REG_KEYS[x])
            elif isinstance(x, torch.Tensor):
                j = ids.get(id(x))
                if j is None:
                    j = ids[id(x)] = len(tensors)
                    tensors.append(x)
                key.append(-1 - j)
            else:
                key.append(float(x))
        program.append(tuple(key))
    return tuple(program), tensors


def _chain_layout(prog, shape, n, kind=None):
    """fma_chain's (int64 header, slot pointers, constants) for ``prog``
    (steps as ``(dst, op, sources)`` with tensors on the device), and the
    positions among the distinct tensor sources (by first use) of the
    slots' base views; the kind of program is :func:`_chain_kind`'s unless
    given."""
    views = {}  # id of a source tensor: its view broadcast to the output
    for _, _, srcs in prog:
        for x in srcs:
            if isinstance(x, torch.Tensor) and id(x) not in views:
                views[id(x)] = x if x.shape == shape else x.expand(shape)
    # a slot: views of one root tensor with one set of strides
    slot_of, slots, loads, load_of, reps = {}, [], [], {}, []
    for i, (key, v) in enumerate(views.items()):
        skey = (id(_root(v)), v.stride())
        if skey not in slot_of:
            if len(slots) == CHAIN_SLOTS:
                raise ValueError(f"a chain reads at most {CHAIN_SLOTS} strided tensors")
            slot_of[skey] = len(slots)
            slots.append(v)
            reps.append(i)
        s = slot_of[skey]
        lkey = (s, (v.data_ptr() - slots[s].data_ptr()) // 4)
        if lkey not in load_of:
            load_of[lkey] = len(loads)
            loads.append(lkey)
        views[key] = load_of[lkey]
    if len(loads) > CHAIN_LOADS:
        raise ValueError(f"a chain reads at most {CHAIN_LOADS} tensor sources")
    contiguous = all(v.is_contiguous() for v in slots)
    if contiguous:
        ndim, sizes, strides = 0, [n], [[1] for _ in slots]
    else:
        sizes, strides = _merge_axes(shape, [v.stride() for v in slots])
        if len(sizes) > _FMA_MAX_DIMS:
            raise ValueError("a chain's views keep more than four axes after merging")
        ndim = len(sizes)
    pad = [0] * (_FMA_MAX_DIMS - len(sizes))
    meta = [ndim, *sizes, *([1] * len(pad)), len(slots)]
    for k in range(CHAIN_SLOTS):
        meta += (strides[k] + pad) if k < len(slots) else [0] * _FMA_MAX_DIMS
    meta.append(len(loads))
    meta += [s for s, _ in loads] + [0] * (CHAIN_LOADS - len(loads))
    meta += [o for _, o in loads] + [0] * (CHAIN_LOADS - len(loads))
    meta.append(len(prog))
    konst = []
    for dst, op, srcs in prog:
        codes = []
        for x in srcs:
            if isinstance(x, Reg):
                codes.append(int(x))
                konst.append(0.0)
            elif isinstance(x, torch.Tensor):
                codes.append(_SRC_LOAD + views[id(x)])
                konst.append(0.0)
            else:
                codes.append(_SRC_CONST)
                konst.append(x)
        codes += [_SRC_CONST] * (3 - len(codes))
        konst += [0.0] * (3 - len(srcs))
        meta += [op, int(dst), *codes]
    meta += [0] * (_META_LEN - 1 - len(meta))
    meta.append(_chain_kind(prog, meta[72:]) if kind is None else kind)
    return ((ctypes.c_longlong * _META_LEN)(*meta), _ChainBases(*[v.data_ptr() for v in slots]),
            (ctypes.c_float * (3 * CHAIN_STEPS))(*konst), reps)


def _chain_kind(prog, codes) -> int:
    """Which of fma_f32.cu's kernels runs ``prog`` (its codes as the header
    holds them): a program compiled in full where the codes are one of its
    tables, the accumulating kernel where only R0 is written, the first
    step reads no register and every later one is ``fma(x, y, R0)`` or
    ``R0 + x`` of loads and constants, else the general one."""
    fixed = _fixed_codes().get(tuple(codes[:5 * len(prog)]))
    if fixed is not None:
        return fixed
    def accumulates(op, srcs):
        if op == FMA:
            return isinstance(srcs[2], Reg) and int(srcs[2]) == 0 and \
                not any(isinstance(x, Reg) for x in srcs[:2])
        return op == ADD and isinstance(srcs[0], Reg) and int(srcs[0]) == 0 and \
            not isinstance(srcs[1], Reg)

    if all(int(dst) == 0 for dst, _, _ in prog) and \
            not any(isinstance(x, Reg) for x in prog[0][2]) and \
            all(accumulates(op, srcs) for _, op, srcs in prog[1:]):
        return KIND_ACCUMULATE
    return KIND_GENERAL


_FIXED_CODES = {}


def _fixed_codes():
    """{codes of a program fma_f32.cu compiles in full: its kind}, from the
    functions that build them, on stand-in tensors (loads numbered by first
    use)."""
    if not _FIXED_CODES:
        a, b, c, d = (torch.zeros(1) for _ in range(4))
        for kind, steps in ((KIND_LOG, _log_polynomial(a, b)), (KIND_EXP, _exp_polynomial(a, b)),
                            (KIND_LANES, _lane_sum(a, b, c, d))):
            prog = [(dst, op, [x if isinstance(x, (torch.Tensor, Reg)) else f32(x)
                               for x in args]) for dst, op, *args in steps]
            meta = list(_chain_layout(prog, (1,), 1, kind=KIND_GENERAL)[0])
            _FIXED_CODES[tuple(meta[72:72 + 5 * len(prog)])] = kind
    return _FIXED_CODES


def _lane_sum(s0, s1, s2, s3):
    """(s0 + s1) + (s2 + s3): the combination of the dot product's lanes."""
    return [(R0, ADD, s0, s1), (R1, ADD, s2, s3), (R0, ADD, R0, R1)]


FMA_CHAIN_KERNEL = _FmaChainKernel()
_LOG_CHAIN = ChainTemplate(_log_polynomial, 2)
_EXP_CHAIN = ChainTemplate(_exp_polynomial, 2)


def sum_of_products(pairs: Sequence[Tuple[Operand, Operand]]) -> torch.Tensor:
    """``a0*b0 + a1*b1 + ...`` with XLA's contraction order, as one chain."""
    (a0, b0), rest = pairs[0], pairs[1:]
    if not rest:
        return a0 * b0
    (a1, b1), rest = rest[0], rest[1:]
    return accumulate([(R0, MUL, a1, b1), (R0, FMA, a0, b0, R0)], rest)


def reduce_sum_of_squares(diff: torch.Tensor) -> torch.Tensor:
    """``sum(diff * diff, axis=-1)`` as XLA's reduction loop rounds it: the
    accumulator starts at ``x0*x0`` and takes ``fma(xk, xk, acc)``; one
    chain."""
    if diff.shape[-1] == 1:
        return diff[..., 0] * diff[..., 0]
    cols = [diff[..., k] for k in range(diff.shape[-1])]
    return accumulate([(R0, MUL, cols[0], cols[0])], [(x, x) for x in cols[1:]])


def row_sum_of_squares(x: torch.Tensor) -> torch.Tensor:
    """``sum(x * x, axis=-1)`` over a short minor axis of a 2-D array as XLA
    rounds it there: every square rounded, then added left to right."""
    acc = x[..., 0] * x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k] * x[..., k]
    return acc


def contract(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...k,kp->...p", x, w)`` rounded as XLA's CPU dot rounds it:
    four partial sums over k mod 4, each the first product followed by
    fused multiply-adds in k order, combined as (s0 + s1) + (s2 + s3).
    The four lanes run side by side, as one chain over k and one that
    combines them; zero padding of k to a multiple of 4 adds fma(0, 0, s)
    steps, as XLA's padded loop does."""
    k = x.shape[-1]
    pad = -k % 4
    x4 = torch.nn.functional.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, 4)
    w4 = torch.nn.functional.pad(w, (0, 0, 0, pad)).reshape(-1, 4, w.shape[-1])
    acc = accumulate([(R0, MUL, x4[..., 0, :, None], w4[0])],
                     [(x4[..., i, :, None], w4[i]) for i in range(1, w4.shape[0])])
    return chain(_lane_sum(*(acc[..., lane, :] for lane in range(4))))


REDUCE_WINDOW = 32  # XLA's CPU tree-reduction window


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """``sum(x, axis=-1)`` as XLA's CPU code rounds a long reduction: it
    sums windows of 32 consecutive elements left to right, then reduces
    the window sums the same way until at most 32 remain, which it adds
    left to right."""
    m = x.shape[-1]
    if m > REDUCE_WINDOW:
        n_win = -(-m // REDUCE_WINDOW)
        padded = torch.nn.functional.pad(x, (0, n_win * REDUCE_WINDOW - m))
        x = padded.reshape(*x.shape[:-1], n_win, REDUCE_WINDOW)
        acc = x[..., 0]
        for k in range(1, REDUCE_WINDOW):
            acc = acc + x[..., k]
        return tree_sum(acc)
    acc = x[..., 0]
    for k in range(1, m):
        acc = acc + x[..., k]
    return acc


# XLA's CPU reduce-window kernel over 32 rows by c columns, where c (4 or
# 8) is the whole last axis, loads 32 floats at a time: LLVM vectorises it
# across 32 / c rows (its dump of a padded 2,048 x 128 tile's
# ``wrapped_reduce-window`` kernel).  Wider windows run as scalar loops.
_WINDOW_LANES = {4: 8, 8: 4}


def _window_sums_2d(x: torch.Tensor) -> torch.Tensor:
    """One level of XLA's CPU tree reduction over the last two axes.

    Each 32 x 32 window (zero padded at the ends) is summed one element
    at a time in row-major order, except where the last axis is 4 or 8
    long and the rows more than 32 (:data:`_WINDOW_LANES`): there lane l
    sums the rows l, l + lanes, ... of its 32-row window, each row's
    columns in order (lane 0 starts at +0, the others at -0), and the
    lanes are then added in halves (l + l + lanes/2, ...), as LLVM's
    vector reduction does."""
    w = REDUCE_WINDOW
    lanes = _WINDOW_LANES.get(x.shape[-1]) if x.shape[-2] > w else None
    if lanes is None:
        x = torch.nn.functional.pad(x, (0, -x.shape[-1] % w, 0, -x.shape[-2] % w))
        acc = x[..., 0::w, 0::w]
        for i in range(w):
            for j in range(w):
                if i or j:
                    acc = acc + x[..., i::w, j::w]
        return acc
    cols = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, 0, 0, -x.shape[-2] % w))
    x = x.reshape(*x.shape[:-2], x.shape[-2] // w, w // lanes, lanes, cols)
    acc = torch.full(x.shape[:-3] + (lanes,), -0.0, dtype=x.dtype, device=x.device)
    acc[..., 0] = 0.0
    for step in range(w // lanes):
        for c in range(cols):
            acc = acc + x[..., step, :, c]
    while lanes > 1:
        lanes //= 2
        acc = acc[..., :lanes] + acc[..., lanes:]
    return acc


def tree_sum_2d(x: torch.Tensor) -> torch.Tensor:
    """``sum`` over the last two axes as XLA's CPU code rounds it: windows
    of 32 x 32 (:func:`_window_sums_2d`) while either axis is longer than
    32, then what remains one element at a time in row-major order."""
    while x.shape[-2] > REDUCE_WINDOW or x.shape[-1] > REDUCE_WINDOW:
        x = _window_sums_2d(x)
    flat = x.reshape(*x.shape[:-2], -1)
    acc = flat[..., 0]
    for k in range(1, flat.shape[-1]):
        acc = acc + flat[..., k]
    return acc


# glibc's float power (sysdeps/ieee754/flt-32/e_powf.c with its tables in
# e_powf_log2_data.c and e_exp2f_data.c, in glibc since 2.28), which XLA's
# CPU code calls for a scalar ``jnp.power``: log2 x from a 16-entry table
# and a degree-5 polynomial, then 2**(y log2 x) from a 32-entry table and a
# cubic, all in double, rounded once to float32
_POWF_OFF = 0x3F330000
_POWF_TAB = tuple(float.fromhex(h) for h in (
    "0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2", "0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2",
    "0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2", "0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2",
    "0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2", "0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3",
    "0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3", "0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4",
    "0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5", "0x1.0000000000000p+0", "0x0.0p+0",
    "0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4", "0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3",
    "0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3", "0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2",
    "0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2", "0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"))
_POWF_A = tuple(float.fromhex(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
_EXP2F_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f, 0x3fef9301d0125b51,
    0x3fef72b83c7d517b, 0x3fef54873168b9aa, 0x3fef387a6e756238, 0x3fef1e9df51fdee1,
    0x3fef06fe0a31b715, 0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429, 0x3feea47eb03a5585,
    0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74, 0x3feea11473eb0187, 0x3feea589994cce13,
    0x3feeace5422aa0db, 0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c, 0x3fef3720dcef9069,
    0x3fef5818dcfba487, 0x3fef7c97337b9b5f, 0x3fefa4afa2a490da, 0x3fefd0765b6e4540)
_EXP2F_SHIFT = float.fromhex("0x1.8p+47")  # rounds to multiples of 1/32
_EXP2F_C = tuple(float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_VELTKAMP = float(2 ** 27 + 1)


def _fma64(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a*b + c`` in double with the product's rounding error kept
    (Dekker's exact product), as the fused multiply-adds of glibc's FMA
    build round it except at double ties."""
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    p = a * b
    ah = a * _VELTKAMP
    ah = ah - (ah - a)
    bh = b * _VELTKAMP
    bh = bh - (bh - b)
    err = ((ah * bh - p) + ah * (b - bh) + (a - ah) * bh) + (a - ah) * (b - bh)
    s = p + c
    bp = s - p
    t = (p - (s - bp)) + (c - bp)
    return s + (t + err)


def pow(x: torch.Tensor, y) -> torch.Tensor:  # noqa: A001 — the jnp name
    """``x ** y`` for a float32 tensor and an exponent that XLA's CPU code
    does not see as a constant, bit for bit: a call to glibc's ``powf``
    (its FMA build, which x86-64 with FMA runs) under XLA's flush of
    subnormal inputs and results to zero.  That is how the reference's
    tracker computes the Hu normalisation ``m00 ** ((i + j + 2) / 2)``: the
    exponent is formed in the fused loop, so even 1 and 2 go through
    ``powf``; and how its Label computes ``10.0 ** t`` of a traced
    threshold.  ``y`` is a number or a float32 tensor that broadcasts with
    ``x``.  Covers x >= 0, 0 -> 0 and inf -> inf for y > 0, overflow to
    inf and underflow to 0; negative x gives NaN except at integer y.
    PyTorch's ``pow`` differs from it in the last bit, on the card and on
    the CPU."""
    x = x.float()
    x = torch.where(x.abs() < _TINY, torch.zeros_like(x), x)
    if isinstance(y, torch.Tensor):
        y = y.float()
        y = torch.where(y.abs() < _TINY, torch.zeros_like(y), y).double()
    else:
        y = float(np.float32(y))
    dev = x.device
    ax = x.abs()
    ix = ax.view(torch.int32).to(torch.int64)
    tmp = ix - _POWF_OFF
    i = (tmp >> 19) & 15
    top = tmp & -0x800000  # 0xff800000 as a signed mask
    iz = (ix - top).to(torch.int32).view(torch.float32).double()
    k = (top >> 23).double()
    tab = torch.tensor(_POWF_TAB, dtype=torch.float64, device=dev).reshape(16, 2)
    invc, logc = tab[i, 0], tab[i, 1]
    r = _fma64(iz, invc, -1.0)
    y0 = logc + k
    r2 = r * r
    a = _fma64(r, _POWF_A[0], _POWF_A[1])
    p = _fma64(r, _POWF_A[2], _POWF_A[3])
    r4 = r2 * r2
    q = _fma64(r, _POWF_A[4], y0)
    q = _fma64(p, r2, q)
    logx = _fma64(a, r4, q)
    ylogx = logx * y
    # exp2: ylogx = k/32 + r, 2**(k/32) from the table scaled by 2**(k//32)
    kd = ylogx + _EXP2F_SHIFT
    kd = kd - _EXP2F_SHIFT
    r = ylogx - kd
    ki = torch.round(kd * 32.0).to(torch.int64)
    t = torch.tensor(_EXP2F_TAB, dtype=torch.int64, device=dev)[ki & 31] + (ki << 47)
    s = t.view(torch.float64)
    z = _fma64(r, _EXP2F_C[0], _EXP2F_C[1])
    r2 = r * r
    out = _fma64(r, _EXP2F_C[2], 1.0)
    out = (_fma64(z, r2, out) * s).float()
    out = torch.where(out.abs() < _TINY, torch.zeros_like(out), out)
    out = torch.where(ylogx > float.fromhex("0x1.fffffffd1d571p+6"),
                      torch.full_like(out, float("inf")), out)
    out = torch.where(ylogx <= -150.0, torch.zeros_like(out), out)
    y = torch.as_tensor(y, dtype=torch.float64, device=dev)
    positive = y > 0
    out = torch.where(positive & (ax == 0), torch.zeros_like(out), out)
    out = torch.where(positive & torch.isinf(ax), ax.expand_as(out), out)
    integer = y == torch.floor(y)
    odd = integer & (torch.remainder(y, 2.0) == 1.0)
    out = torch.where((x < 0) & odd, -out, out)
    out = torch.where((x < 0) & ~integer, torch.full_like(out, float("nan")), out)
    return torch.where(torch.isnan(x), x.expand_as(out), out)
