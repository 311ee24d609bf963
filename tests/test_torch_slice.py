"""The whole ported slice (Filter -> VoxelReassigner) against the JAX package.

The port's ``run(..., device="cpu")`` and the JAX stage classes, run one
after the other, each on its own copy of the same input.  Every artifact
of the six stages is held to the bars of the per-stage tests.  One
exception is allowed and counted: reassigned-label voxels may differ on at
most 0.1% of the foreground, where a float near-tie in the nearest
neighbour or the vote falls the other way (none do on this input today).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_data as D
from nellie_tpu.kernels import frangi as j_frangi
from nellie_tpu.plugin.config import SettingsConfig
from nellie_tpu.stages import mocap_marking as j_markers
from nellie_tpu.stages.filtering import Filter as JFilter
from nellie_tpu.stages.hu_tracking import HuMomentTracking as JTracking
from nellie_tpu.stages.labelling import Label as JLabel
from nellie_tpu.stages.mocap_marking import Markers as JMarkers
from nellie_tpu.stages.networking import Network as JNetwork
from nellie_tpu.stages.voxel_reassignment import VoxelReassigner as JReassigner
from nellie_tpu_torch.kernels import frangi
from nellie_tpu_torch.pipeline.run import params_from_config, run
from nellie_tpu_torch.stages import mocap_marking
from nellie_tpu_torch.stages.filtering import Filter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEAR_TIE_SHARE = 1e-3  # reassigned-label voxels allowed to differ (share of foreground)
# See tests/test_torch_tracking.py.  Here the costs also inherit the
# last-bit differences of im_preprocessed (XLA's CPU exp, acos, cos and
# sqrt are not PyTorch's); the largest difference on this input is 9.8e-5.
FLOW_COST_ATOL = 1e-4


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    data = D.tube_series()
    ref = D.open_im_info(D.write_input(tmp_path_factory.mktemp("jax"), data))
    for stage in (JFilter, JLabel, JNetwork, JMarkers, JTracking, JReassigner):
        stage(ref, device="cpu").run()
    fi = D.file_info(D.write_input(tmp_path_factory.mktemp("port"), data))
    port, timings = run(fi, device="cpu", return_timings=True)
    return ref, port, timings


def test_slice_runs_all_six_stages(slice_runs):
    _, _, timings = slice_runs
    assert list(timings) == ["filter", "label", "network", "markers", "tracking",
                             "reassign", "total"]


@pytest.mark.parametrize("name", sorted(D.SEGMENTATION_ARTIFACTS))
def test_slice_segmentation_artifacts(slice_runs, name):
    ref, port, _ = slice_runs
    D.assert_artifact_equal(ref, port, name, D.SEGMENTATION_ARTIFACTS[name])


def test_slice_flow_vectors(slice_runs):
    ref, port, _ = slice_runs
    a, b = D.read(ref, "flow_vector_array"), D.read(port, "flow_vector_array")
    assert a.shape == b.shape and a.shape[0] > 0
    np.testing.assert_array_equal(b[:, :7], a[:, :7])
    np.testing.assert_allclose(b[:, 7], a[:, 7], rtol=0, atol=FLOW_COST_ATOL)


@pytest.mark.parametrize("name", ["im_branch_label_reassigned", "im_obj_label_reassigned"])
def test_slice_reassigned_labels(slice_runs, name):
    ref, port, _ = slice_runs
    a, b = D.read(ref, name), D.read(port, name)
    assert a.dtype == b.dtype == np.int32 and a.shape == b.shape
    near_ties = int((a != b).sum())
    foreground = int((D.read(ref, "im_instance_label") > 0).sum())
    assert near_ties <= NEAR_TIE_SHARE * foreground, f"{near_ties} of {foreground} voxels differ"
    assert (b[1:] > 0).sum() > 0


def test_slice_voxel_matches(slice_runs):
    ref, port, _ = slice_runs
    a, b = D.read(ref, "voxel_matches"), D.read(port, "voxel_matches")
    assert len(a) == len(b) == 2
    for pair_ref, pair_got in zip(a, b):
        for x, y in zip(pair_ref, pair_got):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


def test_port_imports_without_jax():
    """The card's machine has no JAX: every submodule of the port, and
    chip_smoke.py, import with ``jax`` blocked, and the plain NN runs."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import nellie_tpu_torch\n"
        "for m in pkgutil.walk_packages(nellie_tpu_torch.__path__, 'nellie_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "import torch\n"
        "from nellie_tpu_torch.kernels.nn import nn_argmin_plain\n"
        "d2, idx = nn_argmin_plain(torch.rand(50, 3), torch.rand(70, 3))\n"
        "assert idx.shape == (50,)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_cuda_request_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for machines without it")
    fi = D.file_info(D.write_input(tmp_path, D.tube_series()))
    with pytest.raises(RuntimeError, match="cuda"):
        run(fi, device="cuda")
    assert not list(tmp_path.rglob("*im_preprocessed*")), "a stage ran after all"


def test_params_round_trip_from_jax_dataclasses():
    j_params = j_frangi.FrangiParams(sigmas=(0.6, 0.8), spacing=(0.5, 0.2, 0.2), z_ratio=2.5,
                                     frob_thresh=0.3, max_threshold_samples=1234)
    p_params = frangi.FrangiParams(**dataclasses.asdict(j_params))
    assert dataclasses.asdict(p_params) == dataclasses.asdict(j_params)
    j_mk = j_markers.MarkerParams(sigmas=(1.25, 1.45), z_ratio=2.5, max_radius_px=5.0,
                                  peak_min_distance=2, no_z=False)
    p_mk = mocap_marking.MarkerParams(**dataclasses.asdict(j_mk))
    assert dataclasses.asdict(p_mk) == dataclasses.asdict(j_mk)


def test_params_from_config(tmp_path):
    cfg = SettingsConfig(preprocessing_min_radius_um=0.3, segmentation_label_threshold=150.0,
                         mocap_peak_min_distance=3, remove_edges=True)
    kw = params_from_config(cfg)
    assert kw["filter"]["min_radius_um"] == 0.3 and kw["filter"]["remove_edges"] is True
    assert kw["label"]["threshold"] == 150.0
    assert kw["markers"]["peak_min_distance"] == 3
    im_info = D.open_im_info(D.write_input(tmp_path, D.tube_series()))
    Filter(im_info, device="cpu", **kw["filter"])
    with pytest.raises(NotImplementedError):
        Filter(im_info, device="cpu", **params_from_config(
            SettingsConfig(preprocessing_carry_dtype="float16"))["filter"])
    with pytest.raises(NotImplementedError):
        params_from_config(SettingsConfig(segmentation_label_low_memory=True))
