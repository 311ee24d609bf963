"""The whole port (Filter -> Hierarchy) against the JAX package.

The port's ``run(..., device="cpu")`` and the JAX stage classes, run one
after the other, each on its own copy of the same input.  Every artifact
of the seven stages is held to the bars of the per-stage tests, the
feature CSVs and ``adjacency_maps.pkl`` included.  One exception is
allowed and counted: reassigned-label voxels may differ on at most 0.1% of
the foreground, where a float near-tie in the nearest neighbour or the
vote falls the other way (none do on this input today).
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
from nellie_tpu.stages.hierarchical import Hierarchy as JHierarchy
from nellie_tpu.stages.hu_tracking import HuMomentTracking as JTracking
from nellie_tpu.stages.labelling import Label as JLabel
from nellie_tpu.stages.mocap_marking import Markers as JMarkers
from nellie_tpu.stages.networking import Network as JNetwork
from nellie_tpu.stages.voxel_reassignment import VoxelReassigner as JReassigner
from nellie_tpu_torch.kernels import frangi
from nellie_tpu_torch.pipeline.run import params_from_config, run
from nellie_tpu_torch.stages import mocap_marking
from nellie_tpu_torch.stages import hierarchical as hier
from nellie_tpu_torch.stages.filtering import Filter
from nellie_tpu_torch.stages.labelling import Label

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEAR_TIE_SHARE = 1e-3  # reassigned-label voxels allowed to differ (share of foreground)
# See tests/test_torch_tracking.py.  Here the costs also inherit any
# last-bit difference of im_preprocessed; with XLA's CPU exp, acos, cos and
# sqrt mirrored (kernels/_fp.py) the costs on this input are the
# reference's exactly.
FLOW_COST_ATOL = 1e-4


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    data = D.tube_series()
    ref = D.open_im_info(D.write_input(tmp_path_factory.mktemp("jax"), data))
    for stage in (JFilter, JLabel, JNetwork, JMarkers, JTracking, JReassigner):
        stage(ref, device="cpu").run()
    JHierarchy(ref, skip_nodes=False, device="cpu").run()
    fi = D.file_info(D.write_input(tmp_path_factory.mktemp("port"), data))
    port, timings = run(fi, device="cpu", return_timings=True)
    return ref, port, timings


def test_slice_runs_all_six_stages(slice_runs):
    """All seven stages run, in order, Hierarchy last: the first four as
    the fused chain, ``run``'s default."""
    _, _, timings = slice_runs
    assert list(timings) == ["seg_fused", "tracking", "reassign", "hierarchy", "total"]


@pytest.fixture(scope="module")
def near_tie_branches(slice_runs):
    """{t: branch labels} whose reference voxel differs between the runs,
    each checked to be a near-tie."""
    ref, port, _ = slice_runs
    return D.near_tie_branches(ref, port, [D.DIM_RES["Z"], D.DIM_RES["Y"], D.DIM_RES["X"]])


@pytest.mark.parametrize("table", D.FEATURE_TABLES)
def test_slice_feature_tables(slice_runs, near_tie_branches, table):
    """Every column of every row at the features bar, the rel_* columns
    included: the flow is the reference's bit for bit, so no branch takes
    another reference voxel and no row is excused."""
    ref, port, _ = slice_runs
    assert not any(near_tie_branches.values()), near_tie_branches
    assert D.assert_features_equal_but_near_ties(ref, port, table, near_tie_branches) == 0


def test_slice_adjacency(slice_runs):
    ref, port, _ = slice_runs
    want = D.read_adjacency(ref.pipeline_paths["adjacency_maps"])
    assert len(want["v_n"]) == 3
    D.assert_adjacency_equal(want, D.read_adjacency(port.pipeline_paths["adjacency_maps"]))


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
    """The card's machine has no JAX, pandas or pyarrow (nor Qt, which the
    napari plugin's modules meet in ``tests/qt_stubs.py``): every submodule
    of the port, and chip_smoke.py, import with them blocked, the plain NN
    runs and the Hierarchy's writer writes a one-frame CSV."""
    code = (
        "import sys, pkgutil, importlib, tempfile, os\n"
        "for name in ('jax', 'pandas', 'pyarrow'):\n"
        "    sys.modules[name] = None\n"
        "sys.path.insert(0, 'tests')\n"
        "import qt_stubs\n"
        "qt_stubs.install()\n"
        "import nellie_tpu_torch\n"
        "for m in pkgutil.walk_packages(nellie_tpu_torch.__path__, 'nellie_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "import numpy as np, torch\n"
        "from nellie_tpu_torch.kernels.nn import nn_argmin_plain\n"
        "from nellie_tpu_torch.stages.hierarchical import _CsvStream, _AsyncWorker\n"
        "d2, idx = nn_argmin_plain(torch.rand(50, 3), torch.rand(70, 3))\n"
        "assert idx.shape == (50,)\n"
        "path = os.path.join(tempfile.mkdtemp(), 'features.csv')\n"
        "worker, seconds = _AsyncWorker(), {'csv': 0.0}\n"
        "_CsvStream(path, worker, seconds).write(0, np.arange(3), {'x_raw': np.array([0.5, np.nan, 2.0])})\n"
        "worker.close()\n"
        "assert open(path).read() == 't,label,x_raw\\n0,0,0.5\\n0,1,\\n0,2,2.0\\n'\n"
        "blocked = ('jax', 'pandas', 'pyarrow')\n"
        "assert not any(k.split('.')[0] in blocked for k, v in sys.modules.items() if v)\n"
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
    assert not list(tmp_path.rglob("*.csv")) and not list(tmp_path.rglob("*.pkl"))


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
    f16 = Filter(im_info, device="cpu", **params_from_config(
        SettingsConfig(preprocessing_carry_dtype="float16"))["filter"])
    f16._set_default_sigmas()
    assert f16._params.carry_dtype == "float16"
    low = params_from_config(SettingsConfig(segmentation_label_low_memory=True,
                                            segmentation_label_max_chunk_voxels=4608,
                                            segmentation_label_chunk_z=3))["label"]
    assert (low["low_memory"], low["max_chunk_voxels"], low["chunk_z"]) == (True, 4608, 3)
    assert Label(im_info, device="cpu", **low).chunk_z == 3


def test_params_from_config_hierarchy(tmp_path):
    kw = params_from_config(SettingsConfig(feature_max_node_mask_elems=1234))
    assert kw["hierarchy"] == {"low_memory": False, "enable_motility": True,
                               "enable_adjacency": True, "max_node_mask_elems": 1234,
                               "skip_nodes": True}
    assert kw["remove_intermediates"] is False
    assert params_from_config(SettingsConfig(analyze_node_level=True))["hierarchy"]["skip_nodes"] is False
    assert params_from_config(SettingsConfig(feature_skip_nodes=False,
                                             feature_node_chunk_size=512))["hierarchy"] == {
        "low_memory": False, "enable_motility": True, "enable_adjacency": True,
        "max_node_mask_elems": int(5e7), "skip_nodes": False, "node_chunk_size": 512}
    low = params_from_config(SettingsConfig(feature_low_memory=True))["hierarchy"]
    assert low["low_memory"] is True
    im_info = D.open_im_info(D.write_input(tmp_path, D.tube_series()))
    hier.Hierarchy(im_info, device="cpu", **kw["hierarchy"])
    assert hier.Hierarchy(im_info, device="cpu", **low).low_memory


def test_run_default_and_config_toggles(tmp_path):
    """``run()`` analyses nodes by default, as the JAX package's run()
    does, and a config's ``remove_intermediates`` deletes every artifact
    but the feature CSVs."""
    data = D.tube_series(shape=(2, 10, 32, 32))
    default = run(D.file_info(D.write_input(tmp_path / "default", data)), device="cpu")
    assert os.path.exists(default.pipeline_paths["features_nodes"])
    cfg = SettingsConfig(remove_intermediates=True, voxel_reassign=False)
    im_info, timings = run(D.file_info(D.write_input(tmp_path / "cfg", data)), device="cpu",
                           config=cfg, return_timings=True)
    assert "reassign" not in timings and "hierarchy" in timings
    pp = im_info.pipeline_paths
    assert not os.path.exists(pp["features_nodes"])
    for table in ("voxels", "branches", "organelles", "image"):
        assert os.path.exists(pp[f"features_{table}"])
    for name in ("im_preprocessed", "im_instance_label", "flow_vector_array", "adjacency_maps"):
        assert not os.path.exists(pp[name]), name


def test_params_from_config_2d(tmp_path):
    """A config's parameters reach the stages of a 2D series, which take
    their 2D spacing and no Z ratio."""
    from nellie_tpu_torch.stages.hu_tracking import HuMomentTracking
    from nellie_tpu_torch.stages.labelling import Label
    from nellie_tpu_torch.stages.mocap_marking import Markers
    from nellie_tpu_torch.stages.networking import Network

    cfg = SettingsConfig(preprocessing_min_radius_um=0.3, segmentation_label_threshold=150.0,
                         mocap_peak_min_distance=3, remove_edges=True, analyze_node_level=True)
    kw = params_from_config(cfg)
    im_info = D.open_im_info(D.write_input(tmp_path, D.tube_series_2d(), D.DIM_RES_2D, "TYX"))
    assert im_info.no_z and not im_info.no_t
    filt = Filter(im_info, device="cpu", **kw["filter"])
    filt._set_default_sigmas()
    assert filt._params.spacing == (0.1, 0.1) and filt.z_ratio == 1.0 and filt.remove_edges
    assert filt.sigmas[0] == pytest.approx(1.5)  # 0.3 µm / 0.1 µm / 2
    label = Label(im_info, device="cpu", **kw["label"])
    assert label.threshold == 150.0 and label.min_area_pixels == 20  # ceil(π 0.25² / 0.1²)
    markers = Markers(im_info, device="cpu", **kw["markers"])
    markers._set_default_sigmas()
    assert markers.peak_min_distance == 3 and markers._params.sigma_vec(2.0) == (2.0, 2.0)
    assert Network(im_info, device="cpu", **kw["network"]).scaling == (0.1, 0.1)
    assert HuMomentTracking(im_info, device="cpu", **kw["tracking"]).scaling == (0.1, 0.1)
    h = hier.Hierarchy(im_info, device="cpu", **kw["hierarchy"])
    assert h.spacing == (0.1, 0.1) and h.skip_nodes is False
