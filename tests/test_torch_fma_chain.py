"""The multiply-add chains (``kernels/_fp.py::chain``) against the per-call
compositions they replace.

``sum_of_products``, ``reduce_sum_of_squares``, ``contract`` and the log
and exp polynomials now build one straight-line program each
(``accumulate``, ``_log_polynomial``, ``_exp_polynomial``), which the card
runs as one launch of ``fma_f32.cu``'s chain entry point and the CPU step
by step (``run_steps`` with ``fma_plain``).  Each is held bit for bit (NaN
where NaN) to the composition it replaced, copied here: one ``fma`` call
a contracted step, on ``chip_smoke.fma_operands`` and on subnormal,
infinite and NaN inputs, with programs long enough to be split across
chains.  ``chip_smoke.chain_model`` decodes the kernel's argument block
(``_chain_layout``: slots of views, loads at offsets, codes and constants)
and evaluates it with ``fma_plain``; it equals the steps.  No card is
needed: the dispatch to the kernel is followed with a stand-in.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import _fp
from nellie_tpu_torch.kernels._fp import ADD, FMA, MUL, R0, R1, R2, R3, fma_plain
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)

N = 20_000
SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -3e-39, 1.17e-38, 3e38, -1.0,
                    0.5, 2.0, 7.25, 1e-30], np.float32)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert chip_smoke.same_bits(got, want).all(), int((~chip_smoke.same_bits(got, want)).sum())


@pytest.fixture(scope="module")
def ops():
    """fma_operands and, for the special cases, every triple of SPECIAL."""
    a, b, c = (torch.from_numpy(x) for x in chip_smoke.fma_operands(N, seed=7))
    g = np.stack(np.meshgrid(SPECIAL, SPECIAL, SPECIAL, indexing="ij")).reshape(3, -1)
    s = [torch.from_numpy(np.ascontiguousarray(x)) for x in g]
    return {"operands": (a, b, c), "special": tuple(s)}


# the compositions the chains replaced, one fma_plain a contracted step

def sum_of_products_calls(pairs):
    (a0, b0), rest = pairs[0], pairs[1:]
    if not rest:
        return a0 * b0
    (a1, b1), rest = rest[0], rest[1:]
    acc = fma_plain(a0, b0, a1 * b1)
    for a, b in rest:
        acc = fma_plain(a, b, acc)
    return acc


def reduce_sum_of_squares_calls(diff):
    acc = diff[..., 0] * diff[..., 0]
    for k in range(1, diff.shape[-1]):
        acc = fma_plain(diff[..., k], diff[..., k], acc)
    return acc


def contract_calls(x, w):
    k = x.shape[-1]
    pad = -k % 4
    x4 = torch.nn.functional.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, 4)
    w4 = torch.nn.functional.pad(w, (0, 0, 0, pad)).reshape(-1, 4, w.shape[-1])
    acc = x4[..., 0, :, None] * w4[0]
    for i in range(1, w4.shape[0]):
        acc = fma_plain(x4[..., i, :, None], w4[i], acc)
    return (acc[..., 0, :] + acc[..., 1, :]) + (acc[..., 2, :] + acc[..., 3, :])


def log_calls(r, e):
    p = _fp._LOG_P
    r2 = r * r
    r3 = r2 * r
    y = fma_plain(fma_plain(r, p[0], p[1]), r, p[2])
    y1 = fma_plain(fma_plain(r, p[3], p[4]), r, p[5])
    y2 = fma_plain(fma_plain(r, p[6], p[7]), r, p[8])
    y = fma_plain(fma_plain(fma_plain(y, r3, y1), r3, y2), r3, e * _fp.f32(_fp._LOG_Q1))
    return fma_plain(_fp._LOG_Q2, e, fma_plain(-0.5, r2, r) + y)


def exp_calls(x, n):
    r = fma_plain(-_fp._EXP_C1, n, x)
    r = fma_plain(-_fp._EXP_C2, n, r)
    z = fma_plain(r, _fp._EXP_P[0], _fp._EXP_P[1])
    for p in _fp._EXP_P[2:]:
        z = fma_plain(z, r, p)
    return 1.0 + fma_plain(z, r * r, r)


@pytest.mark.parametrize("kind", ["operands", "special"])
@pytest.mark.parametrize("n_pairs", [1, 2, 3, 5, 9])
def test_sum_of_products(ops, kind, n_pairs):
    a, b, c = ops[kind]
    pool = [a, b, c, -a, c * 0.5, b, 3.0]
    pairs = [(pool[i % len(pool)], pool[(3 * i + 1) % len(pool)]) for i in range(n_pairs)]
    if n_pairs == 9:  # nine distinct tensors a pair: two chains
        pairs = [(a + i, b - i) for i in range(n_pairs)]
    _same(_fp.sum_of_products(pairs), sum_of_products_calls(pairs))


@pytest.mark.parametrize("kind", ["operands", "special"])
@pytest.mark.parametrize("d", [1, 2, 3, 20])
def test_reduce_sum_of_squares(ops, kind, d):
    a, b, c = ops[kind]
    cols = [(a, b, c)[k % 3] * (1.0 + k) for k in range(d)]
    diff = torch.stack(cols, dim=-1)
    _same(_fp.reduce_sum_of_squares(diff), reduce_sum_of_squares_calls(diff))
    if d > 1:  # a strided view of another tensor
        wide = torch.stack(cols + cols, dim=-1)[..., ::2]
        _same(_fp.reduce_sum_of_squares(wide), reduce_sum_of_squares_calls(wide))


@pytest.mark.parametrize("k", [1, 4, 5, 13, 70])
def test_contract(ops, k):
    a, b, c = ops["operands"]
    x = torch.stack([(a, b, c)[i % 3][i * 97:i * 97 + 600] for i in range(k)], -1)
    x = x.reshape(20, 30, k)
    w = torch.stack([(c, a, b)[i % 3][i * 31:i * 31 + 5] for i in range(k)], 0)
    _same(_fp.contract(x, w), contract_calls(x, w))
    _same(_fp.contract(x.transpose(0, 1), w), contract_calls(x.transpose(0, 1), w))


def test_contract_special(ops):
    s = ops["special"][0][:1200].reshape(100, 12)
    w = ops["special"][1][:36].reshape(12, 3)
    _same(_fp.contract(s, w), contract_calls(s, w))


@pytest.mark.parametrize("kind", ["operands", "special"])
def test_log_and_exp_polynomials(ops, kind):
    a, b, _ = ops[kind]
    e = torch.round(torch.nan_to_num(b, nan=3.0, posinf=60.0, neginf=-60.0).clamp(-60, 60))
    _same(_fp.chain(_fp._log_polynomial(a, e)), log_calls(a, e))
    _same(_fp.chain(_fp._exp_polynomial(a, e)), exp_calls(a, e))


def test_log_and_exp_on_values(ops):
    """``_fp.log`` and ``_fp.exp`` whole, on every operand and special value
    (subnormal inputs flushed, infinities, NaN, signs), equal the same
    functions with the old composition of their polynomials."""
    x = torch.cat([*ops["operands"], torch.from_numpy(SPECIAL)])

    def log_old(x):
        x = x.float()
        x = torch.where(x.abs() < _fp._TINY, torch.zeros_like(x), x)
        bits = torch.clamp(x, min=_fp._TINY).view(torch.int32)
        e = ((bits >> 23) - 127).float() + 1.0
        m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)
        small = m < _fp._SQRT_HALF
        e = e - small.float()
        r = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
        out = log_calls(r, e)
        out = torch.where(x < 0, torch.full_like(out, float("nan")), out)
        out = torch.where(x == 0, torch.full_like(out, -float("inf")), out)
        return torch.where(torch.isposinf(x) | torch.isnan(x), x, out)

    def exp_old(x):
        x = torch.clamp(x.float(), _fp.f32(_fp._EXP_LO), _fp.f32(_fp._EXP_HI))
        n = torch.clamp(torch.floor(fma_plain(x, _fp._EXP_LOG2E, 0.5)), -127.0, 127.0)
        z = exp_calls(x, n)
        y = z * ((n.to(torch.int32) + 127) << 23).view(torch.float32)
        return torch.where(y < _fp._TINY, torch.zeros_like(y), y)

    _same(_fp.log(x), log_old(x))
    _same(_fp.exp(x / 1e30), exp_old(x / 1e30))
    _same(_fp.exp(x.clamp(-100, 100)), exp_old(x.clamp(-100, 100)))


def _programs(ops):
    a, b, c = ops["operands"]
    m = a.reshape(100, 200)
    return {
        "log": _fp._log_polynomial(a, b),
        "exp": _fp._exp_polynomial(a, c),
        "broadcast": [(R0, FMA, m, b[:200], 0.25), (R1, MUL, m[:, :1], R0),
                      (R1, ADD, R1, c[:200]), (R0, FMA, R1, R0, m)],
        "views": [(R0, MUL, m[:, 0:50], m[:, 1:51]), (R0, FMA, m[:, 2:52], m[:, 3:53], R0),
                  (R2, ADD, m.t()[:50].t(), R0), (R3, FMA, -1.5, R2, R0), (R0, ADD, R3, R3)],
        "sixteen": [(R0, MUL, a, b)] + [(R0, FMA, (a, b, c)[i % 3], R0, float(i))
                                         for i in range(15)],
    }


@pytest.mark.parametrize("name", ["log", "exp", "broadcast", "views", "sixteen"])
def test_kernel_argument_block_model(ops, name):
    """``_chain_layout``'s argument block, decoded and run by
    ``chip_smoke.chain_model``, equals the steps run one by one."""
    steps = _programs(ops)[name]
    want = _fp.run_steps(steps)
    prog = [(dst, op, [_fp.f32(x) if not isinstance(x, (torch.Tensor, _fp.Reg)) else x
                       for x in args]) for dst, op, *args in steps]
    shape = want.shape
    meta, bases, konst, _ = _fp._chain_layout(prog, shape, want.numel())
    slots = {}
    for _, _, srcs in prog:
        for x in srcs:
            if isinstance(x, torch.Tensor):
                slots.setdefault(x.data_ptr(), x)
    got = chip_smoke.chain_model(list(meta), list(bases), list(konst), shape, slots.values())
    _same(got, want)


def test_layout_groups_views_of_one_tensor(ops):
    a = ops["operands"][0].reshape(-1, 4)[:1000]
    cols = [a[:, k] for k in range(4)]
    prog = [(R0, MUL, [cols[0], cols[0]])] + [(R0, FMA, [x, x, R0]) for x in cols[1:]]
    meta, bases, _, reps = _fp._chain_layout(prog, (1000,), 1000)
    meta = list(meta)
    assert meta[0] == 1 and meta[5] == 1 and meta[38] == 4  # one strided slot, four loads
    assert meta[55:59] == [0, 1, 2, 3] and meta[6] == 4
    assert bases[0] == a.data_ptr() and reps == [0]


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to follow the dispatch."""

    @property
    def device(self):
        return torch.device("cuda")


def test_dispatch(monkeypatch):
    """A float32 CUDA source sends the whole program to the chain kernel;
    another float type on the card runs the steps with ``fma`` (one
    ``fma_f32`` launch a contracted step); CPU sources run the plain steps;
    other devices raise."""
    seen = []
    monkeypatch.setattr(_fp, "FMA_CHAIN_KERNEL",
                        lambda steps, program=None: seen.append(steps) or "chain")
    x = torch.ones(3).as_subclass(_OnCuda)
    steps = [(R0, MUL, x, 2.0), (R0, FMA, x, 3.0, R0)]
    assert _fp.chain(steps) == "chain" and seen == [steps]
    calls = []
    monkeypatch.setattr(_fp, "fma", lambda a, b, c: calls.append(1) or a * b + c)
    half = torch.ones(3, dtype=torch.float16).as_subclass(_OnCuda)
    _fp.chain([(R0, MUL, half, 2.0), (R0, FMA, half, 3.0, R0)])
    assert calls == [1] and len(seen) == 1
    assert torch.equal(_fp.chain([(R0, MUL, torch.ones(3), 2.0)]), torch.full((3,), 2.0))
    with pytest.raises(ValueError, match="unsupported devices"):
        _fp.chain([(R0, MUL, torch.zeros(3, device="meta"), 1.0)])


def test_accumulate_keeps_to_the_limits(monkeypatch):
    """Long sums become several chains, none over 16 steps or 16 tensor
    sources, the running sum carried as a source."""
    lengths = []
    real = _fp.chain

    def counting(steps):
        program, tensors = _fp._chain_program(steps)
        assert len(steps) <= _fp.CHAIN_STEPS and len(tensors) <= _fp.CHAIN_LOADS
        lengths.append(len(steps))
        return real(steps)

    monkeypatch.setattr(_fp, "chain", counting)
    xs = [torch.full((4,), float(i)) for i in range(40)]
    got = _fp.accumulate([(R0, MUL, xs[0], xs[1])], [(x, x) for x in xs[2:]])
    assert len(lengths) > 2 and sum(lengths) == 39  # each step once
    _same(got, _fp.run_steps([(R0, MUL, xs[0], xs[1])] + [(R0, FMA, x, x, R0) for x in xs[2:]]))


def test_chain_kernel_refuses_what_it_cannot_take():
    kernel = _fp._FmaChainKernel()
    with pytest.raises(ValueError, match="steps"):
        kernel([(R0, MUL, torch.ones(2), 1.0)] * 17)
    with pytest.raises(TypeError, match="CUDA tensor"):
        kernel([(R0, MUL, torch.ones(2), 1.0)])


def _kind(steps):
    prog = [(dst, op, [_fp.f32(x) if not isinstance(x, (torch.Tensor, _fp.Reg)) else x
                       for x in args]) for dst, op, *args in steps]
    shape = _fp.run_steps(steps).shape
    return list(_fp._chain_layout(prog, shape, int(np.prod(shape))))[0][-1]


def test_programs_take_their_kernels(ops):
    """The log and exp polynomials and the lane sum go to the kernels
    compiled in full, the sums to the accumulating kernel, anything else
    to the general one."""
    a, b, c = ops["operands"]
    assert _kind(_fp._log_polynomial(a, b)) == _fp.KIND_LOG
    assert _kind(_fp._exp_polynomial(a, b)) == _fp.KIND_EXP
    assert _kind(_fp._lane_sum(a, b, c, a + 1)) == _fp.KIND_LANES
    assert _kind([(R0, MUL, a, b), (R0, FMA, c, 2.0, R0)]) == _fp.KIND_ACCUMULATE
    assert _kind([(R0, FMA, a, b, c), (R0, FMA, c, a, R0)]) == _fp.KIND_ACCUMULATE
    assert _kind([(R0, MUL, a, b), (R0, FMA, R0, a, R0)]) == _fp.KIND_GENERAL
    assert _kind(_fp._log_polynomial(a, a)) == _fp.KIND_GENERAL  # r and e one load
    assert _kind(_programs(ops)["views"]) == _fp.KIND_GENERAL


def test_compiled_tables_equal_the_programs():
    """The step tables that fma_f32.cu compiles in full (``Fixed<KIND>``)
    are the codes of ``_log_polynomial``, ``_exp_polynomial`` and
    ``_lane_sum`` as the wrapper encodes them."""
    import re

    with open(_fp.FMA_KERNEL.source_path) as f:
        text = f.read()
    ops = {"OP_FMA": _fp.FMA, "OP_MUL": _fp.MUL, "OP_ADD": _fp.ADD}

    def src(tok):
        tok = tok.strip()
        m = re.fullmatch(r"L\((\d+)\)", tok)
        return _fp._SRC_LOAD + int(m.group(1)) if m else (
            _fp._SRC_CONST if tok == "K" else int(tok))

    tables = {}
    for kind, body in re.findall(r"struct Fixed<KIND_(\w+)>[^{]*\{(.*?)\n\};", text, re.S):
        codes = []
        for op, dst, a, b, c in re.findall(r"STEP\((\w+), (\d+), ([^,]+), ([^,]+), ([^)]+\)?)\)",
                                           body):
            codes += [ops[op], int(dst), src(a), src(b), src(c)]
        tables[getattr(_fp, "KIND_" + kind)] = tuple(codes)
    assert set(tables) == {_fp.KIND_LOG, _fp.KIND_EXP, _fp.KIND_LANES}
    assert {v: k for k, v in _fp._fixed_codes().items()} == tables
