"""The port's 3D thinning against the JAX package, and the thinning kernel's
round structure in numpy against the plain body.

``skeleton.skeletonize_3d_plain`` (the CPU path of ``skeletonize_3d``)
equals the reference's jitted ``skeletonize_3d`` exactly with its default
``packed`` backend (the one Network and the fused chain call) and with
``lut``, on ``chip_smoke.thin_masks``: tubes, blobs, a one-voxel sheet,
noise, a cross touching every face, empty and full, at an even and an odd
shape.  ``chip_smoke.thin26_model`` (``kernels/csrc/thin26.cu`` in numpy:
the starting foreground as a list, phases that write only buffers they do
not read, each direction stopping at the round that commits nothing, one
launch and one host read a call) and the plain body's own rounds driven
K at a time both equal the plain body.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from nellie_tpu.kernels import skeleton as j_skeleton
from nellie_tpu_torch.kernels import skeleton
from nellie_tpu_torch.kernels.simple_point import get_simple26_lut
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)

SHAPES = [(10, 18, 20), (9, 17, 21)]
NAMES = list(chip_smoke.thin_masks(SHAPES[0]))


@pytest.fixture(scope="module")
def masks():
    return {shape: chip_smoke.thin_masks(shape, seed=sum(shape)) for shape in SHAPES}


@pytest.fixture(scope="module")
def plain(masks):
    return {(shape, name): skeleton.skeletonize_3d_plain(torch.from_numpy(m)).numpy()
            for shape, by_name in masks.items() for name, m in by_name.items()}


@pytest.fixture(scope="module")
def reference():
    return {backend: jax.jit(lambda m, b=backend: j_skeleton.skeletonize_3d(m, backend=b))
            for backend in ("packed", "lut")}


@pytest.mark.parametrize("backend", ["packed", "lut"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_equals_reference(masks, plain, reference, shape, backend):
    for name, m in masks[shape].items():
        want = np.asarray(reference[backend](jnp.asarray(m)))
        np.testing.assert_array_equal(plain[(shape, name)], want, err_msg=name)


def test_masks_thin(masks, plain):
    """The masks exercise the loop: every non-empty mask loses voxels and
    keeps some, the full volume included."""
    for shape, by_name in masks.items():
        for name, m in by_name.items():
            got = plain[(shape, name)]
            assert (got <= m).all()
            if m.any():
                assert 0 < got.sum() < m.sum(), (shape, name)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_model_equals_plain(masks, plain, shape, name):
    """The persistent kernel's model: one launch and one host read a call,
    a direction's rounds up to and including the first that commits
    nothing."""
    m = masks[shape][name]
    got, (rounds, reads, sweeps, kernels) = chip_smoke.thin26_model(m, get_simple26_lut())
    np.testing.assert_array_equal(got, plain[(shape, name)])
    assert (sweeps == 0) == (not m.any()) and reads == kernels == int(m.any())
    assert rounds >= 6 * sweeps


def test_model_rounds_are_the_plain_rounds(masks):
    """A direction of the model runs the plain body's rounds (which stop
    at the first round that commits nothing) plus one empty round where
    the border has no candidate, which the plain body skips."""
    shape = SHAPES[1]
    lut = torch.from_numpy(get_simple26_lut())
    lower = skeleton.lower_parity(shape, "cpu")
    for name in ("tubes", "blobs", "every face"):
        m = masks[shape][name]
        fg = torch.from_numpy(m)
        rounds = 0
        while True:
            before = fg
            for d in range(6):
                remaining = skeleton.border_candidates(fg, d, lut)
                go = True
                while go:
                    fg, remaining, commit = skeleton.thin_round(fg, remaining, lut, lower)
                    rounds += 1
                    go = bool(commit.any())
            if torch.equal(fg, before):
                break
        _, stats = chip_smoke.thin26_model(m, get_simple26_lut())
        assert stats[0] == rounds, name


@pytest.mark.parametrize("rounds_per_read", [2, 5])
def test_plain_rounds_past_the_end_change_nothing(masks, plain, rounds_per_read):
    """The plain body's own rounds, read every ``rounds_per_read`` rounds
    and swept once more after the sweep that changed nothing, give the
    plain body's result: a round after an empty commit leaves fg and
    remaining as they were."""
    shape = SHAPES[1]
    lut = torch.from_numpy(get_simple26_lut())
    lower = skeleton.lower_parity(shape, "cpu")
    for name, m in masks[shape].items():
        fg = torch.from_numpy(m)
        quiet_sweeps = 0
        while quiet_sweeps < 2:
            before = fg
            for d in range(6):
                remaining = skeleton.border_candidates(fg, d, lut)
                go = True
                while go:
                    flags = []
                    for _ in range(rounds_per_read):
                        state = (fg, remaining)
                        fg, remaining, commit = skeleton.thin_round(fg, remaining, lut, lower)
                        flags.append(bool(commit.any()))
                        if len(flags) > 1 and not flags[-2]:
                            assert torch.equal(fg, state[0]) and torch.equal(remaining, state[1])
                    go = flags[-1]
            quiet_sweeps = quiet_sweeps + 1 if torch.equal(fg, before) else 0
        np.testing.assert_array_equal(fg.numpy(), plain[(shape, name)], err_msg=name)


def test_cpu_tensor_takes_the_plain_body(masks, plain):
    shape = SHAPES[0]
    before = skeleton.THIN26_KERNEL.launches
    for name in ("tubes", "every face"):
        got = skeleton.skeletonize_3d(torch.from_numpy(masks[shape][name]))
        np.testing.assert_array_equal(got.numpy(), plain[(shape, name)])
        np.testing.assert_array_equal(
            skeleton.skeletonize(torch.from_numpy(masks[shape][name])).numpy(), got.numpy())
    assert skeleton.THIN26_KERNEL.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(TypeError):
        skeleton.THIN26_KERNEL(torch.zeros((3, 4, 5), dtype=torch.bool),
                               torch.zeros(1 << 23, dtype=torch.uint8))
