"""The port's 2D Zhang–Suen thinning against the JAX package.

``skeleton.skeletonize_2d_plain`` (the CPU path of ``skeletonize_2d``, and
the body that ``csrc/thin2d.cu`` is held to on the card) equals the
reference's jitted ``skeletonize_2d`` exactly on ``chip_smoke.thin2d_masks``
(the 2D path's tubes, blobs, one-pixel lines, a cross and a block touching
the frame's edges, noise, an empty and a full frame) at even, odd and
one-row shapes, and on a 2D main-path frame's tubes; the dispatcher takes
the plain body on a CPU tensor.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from nellie_tpu.kernels import skeleton as j_skeleton
from nellie_tpu_torch.kernels import skeleton
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)

SHAPES = [(48, 64), (33, 47), (1, 12), (7, 5)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


@pytest.mark.parametrize("shape", SHAPES)
def test_masks_against_reference(shape):
    for name, m in chip_smoke.thin2d_masks(shape, seed=sum(shape)).items():
        want = np.asarray(j_skeleton.skeletonize_2d(jnp.asarray(m)))
        got = skeleton.skeletonize_2d_plain(torch.from_numpy(m))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        np.testing.assert_array_equal(skeleton.skeletonize_2d(torch.from_numpy(m)).numpy(), want,
                                      err_msg=name)


def test_main_path_tubes():
    """The 2D path's frame at a quarter of its width: many passes."""
    m = chip_smoke.make_frame_2d((256, 256), seed=3) > 250
    want = np.asarray(j_skeleton.skeletonize_2d(jnp.asarray(m)))
    got = skeleton.skeletonize_2d_plain(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < m.sum()


def test_edge_cases_keep_their_shape():
    masks = chip_smoke.thin2d_masks((33, 47))
    assert not skeleton.skeletonize_2d_plain(torch.from_numpy(masks["empty"])).any()
    lines = torch.from_numpy(masks["lines"])
    # one-pixel lines lose at most their ends
    assert int(skeleton.skeletonize_2d_plain(lines).sum()) >= int(lines.sum()) - 8
    full = skeleton.skeletonize_2d_plain(torch.from_numpy(masks["full"]))
    assert 0 < int(full.sum()) < full.numel()
