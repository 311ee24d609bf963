"""The Hierarchy's device functions on the card against the port's CPU path.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_hierarchy_cuda.py

Bars: counts, min and max exact (selections and float64 counts); sums,
means and standard deviations at rtol 1e-6 (float64 sums in another
order); the motility columns at rtol 1e-4 and atol 1e-4, NaN where the
CPU has NaN (the card's float32 square roots and divisions round
differently, and a ulp can move a near-tie reference voxel; the feature
bar of the CSVs covers that).
"""
import numpy as np
import pytest
import torch

from nellie_tpu_torch.kernels import segstats
from nellie_tpu_torch.stages import hierarchical as hier


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _nan_close(got, want, rtol, atol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_segment_nanstats_on_card(cuda):
    rng = np.random.default_rng(0)
    values = rng.normal(5, 2, (11, 200_000)).astype(np.float32)
    values[rng.random(values.shape) < 0.1] = np.nan
    seg = rng.integers(-1, 3100, 200_000)
    cpu = segstats.segment_nanstats(torch.from_numpy(values), seg, 3000)
    card = segstats.segment_nanstats(torch.from_numpy(values).to(cuda), seg, 3000)
    for key in segstats.STAT_KEYS:
        if key in ("min", "max"):
            np.testing.assert_array_equal(card[key], cpu[key])
        else:
            _nan_close(card[key], cpu[key], 1e-6, 0)


@pytest.mark.gpu
def test_node_agg_scan_kernel_on_card(cuda):
    rng = np.random.default_rng(1)
    shape = (16, 64, 64)
    coords = np.argwhere(rng.random(shape) < 0.2).astype(np.int32)
    nodes = coords[rng.permutation(len(coords))[:700]]
    radius = rng.uniform(0.5, 4.0, len(nodes))
    lo = np.clip((nodes - radius[:, None]).astype(int), 0, shape).astype(np.int32)
    hi = np.clip((nodes + radius[:, None]).astype(int) + 1, 0, shape).astype(np.int32)
    vec01 = rng.normal(0, 0.3, coords.shape).astype(np.float32)
    vec12 = rng.normal(0, 0.3, coords.shape).astype(np.float32)
    vec01[rng.random(len(coords)) < 0.2] = np.nan
    stats = rng.normal(3, 1, (11, len(coords))).astype(np.float32)
    stats[rng.random(stats.shape) < 0.1] = np.nan
    arrays = (lo, hi, nodes.astype(np.float32), coords, vec01, vec12, stats)
    chunk = 5000
    cpu = hier._node_agg_scan_kernel(*map(torch.from_numpy, arrays), chunk)
    card = hier._node_agg_scan_kernel(*(torch.from_numpy(a).to(cuda) for a in arrays), chunk)
    (node_cpu, stat_cpu), (node_card, stat_card) = [(a.cpu().numpy(), b.cpu().numpy())
                                                    for a, b in (cpu, card)]
    for i in (0, 2, 4):
        np.testing.assert_array_equal(node_card[i], node_cpu[i])
    np.testing.assert_allclose(node_card, node_cpu, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(stat_card[[0, 2, 3]], stat_cpu[[0, 2, 3]])
    np.testing.assert_allclose(stat_card, stat_cpu, rtol=1e-6, atol=1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize("has01", [True, False])
def test_motility_kernel_on_card(cuda, has01):
    rng = np.random.default_rng(2)
    n = 50_000
    coords = rng.permutation(np.argwhere(np.ones((20, 60, 60))))[:n].astype(np.float32)
    vec12 = rng.normal(0, 1, (n, 3)).astype(np.float32)
    vec01 = rng.normal(0, 1, (n, 3)).astype(np.float32) if has01 else np.full((n, 3), np.nan,
                                                                                np.float32)
    vec12[rng.random(n) < 0.1] = np.nan
    labels = rng.integers(-1, 400, n).astype(np.int64)
    spacing = np.array([0.5, 0.2, 0.2], np.float32)
    arrays = (coords, vec01, vec12, labels, spacing)
    cpu = hier._motility_kernel(*map(torch.from_numpy, arrays), 2.0, has01=has01, num_labels=400)
    card = hier._motility_kernel(*(torch.from_numpy(a).to(cuda) for a in arrays), 2.0,
                                 has01=has01, num_labels=400)
    _nan_close(card.cpu().numpy(), cpu.numpy(), 1e-4, 1e-4)
