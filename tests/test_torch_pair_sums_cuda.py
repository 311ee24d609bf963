"""The hand-written CUDA pair sums against their plain body.

Needs a CUDA GPU and skips without one; imports no JAX.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_pair_sums_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
``matching.pair_stats`` on CUDA tensors launches ``kernels/csrc/pair_sums.cu``
once (a memset and one CUDA kernel, two where a later window level
follows), returns its sums on the host, and equals ``pair_stats_plain``,
the count exactly and the sums bit for bit (NaN bits too on the card), on
the card and on CPU copies: the tiles of ``chip_smoke.PAIR_CASES`` (one
window level, a second general level over 4,096 x 4,096, the 4- and
8-column lanes of a padded 2,048 x 128 and 2,048 x 256 tile, no gated
pair, NaN and subnormal features, a window row whose gated terms are all
+0, every window of a 1,024-wide tile real), 1-D coordinates, no features,
a tile of one real pair, a third level
(a padded 64 x 131,072 tile) and a tile whose features start off 16 bytes,
and ``match_frames_device`` end to end with its two host reads; arguments
it does not take raise.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nellie_tpu_torch.kernels import matching


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(case, dev, seed=0):
    n_post, n_pre, ndim, n_feat, padded, max_d, shift, kind = case
    arrays = chip_smoke.pair_tile(n_post, n_pre, ndim, n_feat, seed=seed, shift=shift,
                                  kind=kind)
    return (*(torch.from_numpy(a).to(dev) for a in arrays), max_d, padded)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(chip_smoke.PAIR_CASES))
def test_cases(cuda, name):
    case = chip_smoke.PAIR_CASES[name]
    count, _ = chip_smoke.check_pair_sums(name, _args(case, cuda),
                                          against_cpu=case[0] * case[1] < 10 ** 6)
    assert (count == 0) == (name == "no gated pair")


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(70, 50, 1, 4, (128, 128), 1.0, 0.0, "normal"),
                                  (70, 50, 3, 0, (128, 128), 1.0, 0.0, "normal"),
                                  (1, 1, 3, 22, (128, 128), 1.0, 0.0, "normal"),
                                  (33, 65, 2, 10, (128, 256), 0.7, 0.0, "normal"),
                                  (40, 3000, 2, 10, (64, 131072), 4.0, 0.0, "normal")])
def test_small_shapes(cuda, case):
    chip_smoke.check_pair_sums(str(case), _args(case, cuda, seed=3), against_cpu=True)


@pytest.mark.gpu
def test_features_off_16_bytes(cuda):
    """Features that start 4 bytes past an aligned address take the
    kernel's scalar loads."""
    cp, cq, fp, fq, max_d, padded = _args(chip_smoke.PAIR_CASES["3D 1024 tile"], cuda)
    fp = torch.cat([fp.reshape(-1)[:1], fp.reshape(-1)])[1:].view(fp.shape)
    assert fp.data_ptr() % 16
    chip_smoke.check_pair_sums("features off 16 bytes", (cp, cq, fp, fq, max_d, padded))


@pytest.mark.gpu
def test_match_frames_device(cuda):
    cp, cq, fp, fq = (torch.from_numpy(a) for a in chip_smoke.pair_tile(300, 280, 3, 22))
    want = matching.match_frames_device(cp, fp, cq, fq, 1.0, 4)
    before = matching.PAIR_SUMS_KERNEL.launches, matching.PAIR_COSTS_KERNEL.launches
    on_card = [a.to(cuda) for a in (cp, fp, cq, fq)]
    torch.cuda.synchronize()
    got, reads = chip_smoke.host_reads(lambda: matching.match_frames_device(*on_card, 1.0, 4))
    assert (matching.PAIR_SUMS_KERNEL.launches, matching.PAIR_COSTS_KERNEL.launches) == \
        (before[0] + 1, before[1] + 1)
    assert reads == 2
    assert got[0] == want[0] and got[1] == want[1] and len(want[0]) > 0
    np.testing.assert_array_equal(np.asarray(got[2], np.float32),
                                  np.asarray(want[2], np.float32))


@pytest.mark.gpu
def test_refuses(cuda):
    args = _args(chip_smoke.PAIR_CASES["no gated pair"], cuda)
    with pytest.raises(ValueError):
        matching.pair_stats(*args[:5], (100, 128))  # not a multiple of 32
    with pytest.raises(ValueError):
        matching.pair_stats(*args[:5], (64, 128))  # fewer rows than the pairs
    with pytest.raises(TypeError):
        matching.pair_stats(args[0].double(), *args[1:])
    wide = torch.zeros(args[0].shape[0], 64, device=cuda)
    with pytest.raises(ValueError):  # 63 features at most
        matching.pair_stats(args[0], args[1], wide, wide[:args[1].shape[0]], *args[4:])
