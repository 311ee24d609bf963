"""The port's object-constrained nearest seed against the JAX package, and
the nearest-seed kernel's design in torch against the plain body.

``edt.nearest_seed_plain`` (the CPU path of ``nearest_seed``) equals the
reference's jitted ``nearest_seed`` (JFA+1) with labels exact and
distances bit for bit: 2D and 3D, anisotropic sampling (0.5, 0.2, 0.2) and
(0.5, 0.2), with and without objects, ``max_radius_px`` set and unset,
seeds in object 0, and ties (seeds on a lattice at unit sampling).
``nearest_seed_model`` (``kernels/csrc/nearest_seed.cu``'s schedule in
torch: the list of the voxels outside object 0 made in the launch when no
seed lies in object 0, the map from voxels to list slots, the state by slot
in two buffers, the candidate's object read at its source) equals the plain
body in 1-D, 2D and 3D, with the volume split over one block or several.
"""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from nellie_tpu.kernels import edt as j_edt
from nellie_tpu_torch.kernels import _fp, edt
from torch_port_data import one_torch_thread  # noqa: F401  (module fixture)


def nearest_seed_model(seeds, objects, sampling, max_radius_px=None, blocks=5):
    """``kernels/csrc/nearest_seed.cu``'s schedule in torch on the CPU.

    Phase 0: the volume in ``blocks`` chunks of ceil(n / blocks) voxels;
    whether a seed lies in object 0, and each chunk's voxels outside object
    0.  Phase 1: with objects and no seed in object 0, each chunk's voxels
    outside object 0 go, in raster order, to the slots from the prefix of
    the counts (the list), the map gives each voxel its slot (-1 off the
    list) and the state is kept by slot; otherwise every voxel runs at its
    own slot.  The passes, one a (step, offset): each slot reads its
    source's slot through the map (off the list: rejected, its object is
    0) and the candidate's object at the source, from one state buffer, and
    writes the other.  Labels and distances at the end; the voxels off the
    list keep label 0 and +inf.  Returns (labels, distances, list or None)."""
    seeds = torch.as_tensor(seeds)
    shape, ndim, n = tuple(seeds.shape), seeds.ndim, seeds.numel()
    samp = [_fp.f32(s) for s in sampling]
    strides = [int(np.prod(shape[a + 1:], dtype=np.int64)) for a in range(ndim)]
    flat_seeds = seeds.reshape(-1).to(torch.int32)
    obj = None if objects is None else torch.as_tensor(objects).reshape(-1).to(torch.int32)
    # phase 0
    chunk = -(-n // blocks)
    counts, in_zero = [], False
    for b in range(blocks):
        lo, hi = min(n, b * chunk), min(n, (b + 1) * chunk)
        if obj is not None:
            counts.append(int((obj[lo:hi] != 0).sum()))
            in_zero |= bool(((obj[lo:hi] == 0) & (flat_seeds[lo:hi] > 0)).any())
    # phase 1
    compact = obj is not None and not in_zero
    if compact:
        voxel_list = torch.empty(sum(counts), dtype=torch.int64)
        slot_map = torch.full((n,), -1, dtype=torch.int64)
        offset = 0
        for b in range(blocks):
            lo, hi = min(n, b * chunk), min(n, (b + 1) * chunk)
            mine = lo + torch.nonzero(obj[lo:hi] != 0).reshape(-1)
            voxel_list[offset:offset + len(mine)] = mine
            slot_map[mine] = torch.arange(offset, offset + len(mine))
            offset += len(mine)
        assert offset == sum(counts)
    else:
        voxel_list = torch.arange(n)
        slot_map = torch.arange(n)
    voxels = voxel_list
    state = torch.where(flat_seeds[voxels] > 0, voxels.to(torch.int32), -1)
    coords = [torch.div(voxels, strides[a], rounding_mode="floor") % shape[a]
              for a in range(ndim)]

    def dist(c, idx):
        q = [torch.div(idx.clamp(min=0), strides[a], rounding_mode="floor") % shape[a]
             for a in range(ndim)]
        diffs = [((c[a] - q[a]).to(torch.int32).float() * samp[a],) * 2 for a in range(ndim)]
        return torch.where(idx >= 0, _fp.sum_of_products(diffs), float("inf"))

    for step in edt.jump_steps(shape, max_radius_px):
        for off in itertools.product((-1, 0, 1), repeat=ndim):
            if not any(off):
                continue
            target = [c + o * step for c, o in zip(coords, off)]
            inside = torch.ones(voxels.shape, dtype=torch.bool)
            for a in range(ndim):
                inside &= (target[a] >= 0) & (target[a] < shape[a])
            source = sum(t.clamp(0, shape[a] - 1) * strides[a] for a, t in enumerate(target))
            ok = inside
            if obj is not None:
                ok &= obj[source] == obj[voxels]
            slot = slot_map[source]
            ok &= slot >= 0
            cand = torch.where(ok, state[slot.clamp(min=0)], -1)
            take = torch.where(cand >= 0, dist(coords, cand), float("inf")) < dist(coords, state)
            state = torch.where(take, cand, state)  # a new buffer: every slot read the old one
    labels = torch.zeros(n, dtype=torch.int32)
    distances = torch.full((n,), float("inf"))
    labels[voxels] = torch.where(state >= 0, flat_seeds[state.clamp(min=0).long()], 0)
    distances[voxels] = _fp.sqrt(dist(coords, state))
    return (labels.reshape(shape).to(seeds.dtype), distances.reshape(shape),
            voxel_list if compact else None)


SAMPLING = {3: (0.5, 0.2, 0.2), 2: (0.5, 0.2), 1: (0.3,)}
SHAPES = {3: (10, 24, 28), 2: (40, 44), 1: (400,)}


def _lattice(shape):
    """Seeds every 4 voxels on every axis in one object: many voxels lie at
    the same distance from two or more seeds at unit sampling."""
    seeds = np.zeros(shape, np.int32)
    seeds[tuple(slice(1, None, 4) for _ in shape)] = 1
    seeds[seeds > 0] = np.arange(1, int(seeds.sum()) + 1) % 7 + 1
    return seeds, np.ones(shape, np.int32)


def _case(name, ndim):
    shape = SHAPES[ndim]
    if name == "ties":
        seeds, objects = _lattice(shape)
        return seeds, objects, (1.0,) * ndim
    seeds, objects = chip_smoke.seed_inputs(shape, seed=ndim)
    if name == "seeds in object 0":
        rng = np.random.default_rng(ndim)
        seeds = np.where((objects == 0) & (rng.random(shape) < 0.002), 9, seeds).astype(np.int32)
    return seeds, (None if name == "no objects" else objects), SAMPLING[ndim]


CASES = [(name, ndim, radius) for ndim in (3, 2, 1)
         for name in ("objects", "no objects", "seeds in object 0", "ties")
         for radius in (None, 3)]


@pytest.fixture(scope="module")
def results():
    """{case: (inputs, the plain body's (labels, distances))}."""
    out = {}
    for name, ndim, radius in CASES:
        seeds, objects, sampling = _case(name, ndim)
        obj = None if objects is None else torch.from_numpy(objects)
        out[(name, ndim, radius)] = ((seeds, objects, sampling), edt.nearest_seed_plain(
            torch.from_numpy(seeds), obj, sampling, radius))
    return out


def _assert_same(got, want, what):
    labels, dist = got
    np.testing.assert_array_equal(np.asarray(labels), want[0].numpy(), err_msg=what)
    assert chip_smoke.same_bits(np.asarray(dist), want[1].numpy()).all(), what


@pytest.mark.parametrize("name,ndim,radius", CASES)
def test_plain_equals_reference(results, name, ndim, radius):
    (seeds, objects, sampling), want = results[(name, ndim, radius)]
    obj = None if objects is None else jnp.asarray(objects)
    got = j_edt.nearest_seed(jnp.asarray(seeds), obj, sampling, radius)
    _assert_same(got, want, f"{name} {ndim}D radius {radius}")
    assert (want[0].numpy() > 0).any() and np.isfinite(want[1].numpy()).any()


@pytest.mark.parametrize("blocks", [1, 7])
@pytest.mark.parametrize("name,ndim,radius", CASES)
def test_kernel_model_equals_plain(results, name, ndim, radius, blocks):
    """The kernel's schedule, split over 1 or 7 blocks, equals the plain
    body; its list is the voxels outside object 0 in raster order, made
    only where objects are given and no seed lies in object 0."""
    (seeds, objects, sampling), want = results[(name, ndim, radius)]
    labels, dist, voxel_list = nearest_seed_model(seeds, objects, sampling, radius, blocks)
    _assert_same((labels, dist), want, f"{name} {ndim}D radius {radius} blocks {blocks}")
    compact = objects is not None and not ((seeds > 0) & (objects == 0)).any()
    assert (voxel_list is not None) == compact
    if compact:
        np.testing.assert_array_equal(voxel_list.numpy(),
                                      np.flatnonzero(objects.reshape(-1) != 0))


def test_background_is_inert(results):
    """With objects and no seed in object 0, the voxels of object 0 keep no
    seed: label 0 at distance +inf, as the restricted kernel leaves them."""
    (seeds, objects, _), (labels, dist) = results[("objects", 3, None)]
    outside = objects == 0
    assert outside.any()
    assert (labels.numpy()[outside] == 0).all() and np.isposinf(dist.numpy()[outside]).all()


@pytest.mark.parametrize("ndim", [3, 2, 1])
def test_no_seeds_and_every_voxel_a_seed(ndim):
    """No seed: label 0 at +inf everywhere; every voxel a seed: its own
    value at distance 0; the kernel's model agrees."""
    shape = SHAPES[ndim]
    objects = np.ones(shape, np.int32)
    for seeds in (np.zeros(shape, np.int32),
                  np.arange(1, objects.size + 1, dtype=np.int32).reshape(shape)):
        want = edt.nearest_seed_plain(torch.from_numpy(seeds), torch.from_numpy(objects),
                                      SAMPLING[ndim])
        got = j_edt.nearest_seed(jnp.asarray(seeds), jnp.asarray(objects), SAMPLING[ndim], None)
        _assert_same(got, want, "reference")
        for objs in (objects, None):
            got = nearest_seed_model(seeds, objs, SAMPLING[ndim], blocks=3)[:2]
            _assert_same(got, want, "model")
        if seeds.any():
            np.testing.assert_array_equal(want[0].numpy(), seeds)
            assert not want[1].numpy().any()
        else:
            assert not want[0].numpy().any() and np.isposinf(want[1].numpy()).all()


def test_jump_steps():
    assert edt.jump_steps((64, 256, 256)) == [128, 64, 32, 16, 8, 4, 2, 1, 1]
    assert edt.jump_steps((1024, 1024)) == [512, 256, 128, 64, 32, 16, 8, 4, 2, 1, 1]
    assert edt.jump_steps((10, 24, 28), max_radius_px=3) == [2, 1, 1]
    assert edt.jump_steps((1,)) == [1, 1]


def test_cpu_tensor_takes_the_plain_body(results):
    (seeds, objects, sampling), want = results[("objects", 3, None)]
    before = edt.NEAREST_SEED_KERNEL.launches
    got = edt.nearest_seed(torch.from_numpy(seeds), torch.from_numpy(objects), sampling)
    _assert_same(got, want, "nearest_seed on the CPU")
    assert edt.NEAREST_SEED_KERNEL.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(TypeError):
        edt.NEAREST_SEED_KERNEL(torch.zeros((4, 5), dtype=torch.int32))
