"""How ``kernels/_cuda.py::CudaKernel`` names a built library: a hash of
the ``.cu`` source, of every ``csrc/`` header it includes by a quoted
name, and of the flags, so that a change to any of them builds anew.  No
``nvcc`` is needed: the name is computed before any build.  The four
persistent cooperative kernels share one grid barrier and launch shape
(``csrc/coop_grid.cuh``), the two union-find kernels one ``find`` and
``unite`` (``csrc/union_find.cuh``), and ``CountedKernel.count_call``
keeps a wrapper's counts.
"""
import shutil

import pytest

from nellie_tpu_torch.kernels import _cuda, ccl, edt, filters, frangi, skeleton

SOURCES = ["frangi_tail.cu", "gauss_axis.cu", "fma_f32.cu", "nn_argmin.cu", "ccl_union_find.cu",
           "flow_interp.cu", "ccl_merge.cu"]


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the kernels read instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, copy)
    monkeypatch.setattr(_cuda, "CSRC", str(copy))
    return copy


def test_the_tail_includes_its_math_header():
    assert [p.split("/")[-1] for p in frangi.FRANGI_TAIL_KERNEL.headers()] == ["xla_cpu_math.cuh"]
    assert filters.GAUSS_AXIS_KERNEL.headers() == []


def test_a_header_change_renames_the_library(csrc):
    kernel = frangi._FrangiTailKernel()
    before = kernel.library_path()
    header = csrc / "xla_cpu_math.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    after = kernel.library_path()
    assert after != before and after.startswith(_cuda.BUILD_DIR)
    assert filters._GaussAxisKernel().library_path() == filters.GAUSS_AXIS_KERNEL.library_path()


@pytest.mark.parametrize("source", SOURCES)
def test_a_source_or_flag_change_renames_the_library(csrc, source):
    class Kernel(_cuda.CudaKernel):
        pass

    Kernel.source = source
    kernel = Kernel()
    before = kernel.library_path()
    assert before.split("/")[-1].startswith("lib" + source.rsplit(".", 1)[0] + "_")
    Kernel.flags = (*_cuda.BASE_FLAGS, "-DSOMETHING")
    flagged = kernel.library_path()
    (csrc / source).write_text((csrc / source).read_text() + "\n// changed\n")
    assert len({before, flagged, kernel.library_path()}) == 3


def test_an_unrelated_header_does_not_rename(csrc):
    before = frangi._FrangiTailKernel().library_path()
    (csrc / "unused.cuh").write_text("// not included\n")
    assert frangi._FrangiTailKernel().library_path() == before


COOPERATIVE = {"thin26.cu": skeleton.THIN26_KERNEL, "nearest_seed.cu": edt.NEAREST_SEED_KERNEL,
               "thin2d.cu": skeleton.THIN2D_KERNEL,
               "masked_percentile.cu": frangi.MASKED_PERCENTILE_KERNEL}


@pytest.mark.parametrize("source", list(COOPERATIVE))
def test_cooperative_kernels_share_one_barrier(source):
    kernel = COOPERATIVE[source]
    assert kernel.source == source
    assert [p.split("/")[-1] for p in kernel.headers()] == ["coop_grid.cuh"]
    with open(kernel.source_path) as f:
        text = f.read()
    for own in ("__device__ __forceinline__ void grid_barrier", "cudaError_t launch_shape",
                "cudaOccupancyMaxActiveBlocksPerMultiprocessor", "atomic_ref"):
        assert own not in text
    assert "coop_grid::launch_shape<" in text and "coop_grid::barrier(" in text


UNION_FIND = {"ccl_union_find.cu": ccl.CCL_KERNEL, "ccl_merge.cu": ccl.MERGE_KERNEL}


@pytest.mark.parametrize("source", list(UNION_FIND))
def test_union_find_kernels_share_one_header(csrc, source):
    """Both keep no copy of ``find_halving`` and ``unite``, and a change to
    the header they include builds both anew."""
    kernel = UNION_FIND[source]
    assert kernel.source == source
    assert [p.split("/")[-1] for p in kernel.headers()] == ["union_find.cuh"]
    with open(kernel.source_path) as f:
        text = f.read()
    for own in ("int find_halving(", "void unite(", "atomicMin(parent"):
        assert own not in text
    before = type(kernel)().library_path()
    header = csrc / "union_find.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    assert type(kernel)().library_path() != before


def test_count_call():
    class Kernel(_cuda.CountedKernel):
        source = "thin2d.cu"

    kernel = Kernel()
    assert (kernel.launches, kernel.kernel_launches, kernel.last_stats) == (0, 0, None)
    kernel.count_call(2, host_reads=0)
    kernel.count_call(3)
    assert (kernel.launches, kernel.kernel_launches) == (2, 5)
    assert kernel.last_stats == {"cuda_kernels": 3}
