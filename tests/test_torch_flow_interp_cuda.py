"""The hand-written CUDA flow interpolation kernel against its plain body.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_flow_interp_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)  Inputs are
``chip_smoke.interp_inputs`` (phase 17's).  The kernel equals the plain
body on the card and on CPU copies bit for bit (NaN where NaN), with no
row allowed to differ (``chip_smoke.check_interp``): on the path where
each query lists its rows in the radius, on the three-pass path of a
query whose list overflows, with the row table in shared memory and
streamed through shared tiles, in 128- and 512-thread blocks, and from
several host threads at once.
"""
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.stages import flow_interpolation as fi


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(inputs, dev):
    return tuple(torch.from_numpy(a).to(dev) for a in inputs[:4]) + (inputs[4],)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n_m", [1, 20, 33, 700, 1500, 40000])
def test_kernel_equals_plain_body(cuda, n_m, d):
    args = _args(chip_smoke.interp_inputs(2048, n_m, d, seed=n_m), cuda)
    before = fi.FLOW_INTERP_KERNEL.launches
    fi._interp_all_kernel(*args)
    torch.cuda.synchronize()
    assert fi.FLOW_INTERP_KERNEL.launches == before + 1
    differ, _ = chip_smoke.check_interp(f"M={n_m} d={d}", args, against_cpu=n_m <= 1500)
    assert differ == 0


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2, 3])
def test_overflowing_lists_take_the_three_pass_path(cuda, d):
    """A radius of 3 puts hundreds of rows inside: most queries overflow
    their list of ``INTERP_LIST_LEN`` rows."""
    q, f, v, c, _ = chip_smoke.interp_inputs(2048, 3000, d, seed=d)
    args = _args((q, f, v, c, 3.0), cuda)
    assert chip_smoke.interp_overflows(args[0], args[1], 3.0) > 1000
    assert chip_smoke.check_interp(f"radius 3 d={d}", args, against_cpu=True)[0] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("radius", [1.0, 2.5])
def test_rows_streamed_through_shared_tiles(cuda, d, radius):
    """More rows than the shared table holds, with and without overflowing
    lists."""
    q, f, v, c, _ = chip_smoke.interp_inputs(3000, chip_smoke.INTERP_TILED_ROWS, d, seed=7)
    chip_smoke.check_interp(f"tiled d={d} radius {radius}", _args((q, f, v, c, radius), cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("n_q", [1, 31, 33, 5000, 100_000])
def test_query_counts_off_the_blocks(cuda, n_q):
    """Queries that fill no warp, part of one, and more than every resident
    warp holds, with a table in 128-thread blocks (M = 700) and one in
    512-thread blocks (M = 4,391)."""
    for n_m, d in ((700, 3), (4391, 2)):
        args = _args(chip_smoke.interp_inputs(n_q, n_m, d, seed=n_m), cuda)
        got = fi.FLOW_INTERP_KERNEL(*args)
        assert chip_smoke.same_bits(got.cpu().numpy(),
                                    fi._interp_all_plain(*args).cpu().numpy()).all()


@pytest.mark.gpu
def test_many_queries_and_tiles(cuda):
    """More queries than one block's and rows than one shared tile, with a
    larger radius so that many rows lie inside."""
    q, f, v, c, _ = chip_smoke.interp_inputs(20000, 5000, 3, seed=9)
    chip_smoke.check_interp("20000 x 5000, radius 2", _args((q, f, v, c, 2.0), cuda))


@pytest.mark.gpu
def test_kernel_output_and_errors(cuda):
    q, f, v, c, r = _args(chip_smoke.interp_inputs(64, 10, 2), cuda)
    out = fi._interp_all_kernel(q, f, v, c, r)
    assert out.shape == q.shape and out.dtype == torch.float32 and out.device == q.device
    assert fi._interp_all_kernel(q[:0], f, v, c, r).shape == (0, 2)
    assert torch.isnan(fi._interp_all_kernel(q, f[:0], v[:0], c[:0], r)).all()
    with pytest.raises(TypeError):
        fi._interp_all_kernel(q.double(), f, v, c, r)
    with pytest.raises(ValueError):
        fi._interp_all_kernel(q, f, v[:, :1], c, r)


@pytest.mark.gpu
def test_concurrent_calls_with_changing_tables(cuda):
    """Host threads calling at once with tables of different sizes (so
    different shared-memory sizes and block sizes, as the reassigner and
    the Hierarchy do on a mesh of shards): every call launches and equals
    the plain body."""
    from concurrent.futures import ThreadPoolExecutor

    cases = [_args(chip_smoke.interp_inputs(4096, n_m, 3, seed=n_m), cuda)
             for n_m in (646, 648, 1500, 4391, 20000)]
    wants = [fi._interp_all_plain(*args) for args in cases]
    torch.cuda.synchronize()
    before = fi.FLOW_INTERP_KERNEL.launches

    def call(k):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            got = fi.FLOW_INTERP_KERNEL(*cases[k % len(cases)])
        stream.synchronize()
        return k % len(cases), got

    with ThreadPoolExecutor(8) as pool:
        results = list(pool.map(call, range(200)))
    assert fi.FLOW_INTERP_KERNEL.launches == before + 200
    for k, got in results:
        assert chip_smoke.same_bits(got.cpu().numpy(), wants[k].cpu().numpy()).all()
