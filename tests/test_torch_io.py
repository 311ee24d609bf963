"""The port's copies of the JAX package's host layers against the originals.

``nellie_tpu_torch`` keeps its own ``io`` (TIFF/OME codec, ``FileInfo``,
``ImInfo``), ``config``, ``kernels.simple_point`` (the thinning table),
``utils.regionprops`` and logger.  The same inputs, made from a seed, go
through both packages; the outputs must be equal: file bytes, parsed
metadata, artifact paths, the table byte for byte, region properties and
each stage's kwargs.
"""
import dataclasses
import os

import numpy as np
import pytest

from nellie_tpu.io import ome as jax_ome
from nellie_tpu.io import tiff as jax_tiff
from nellie_tpu.io.verifier import FileInfo as JaxFileInfo
from nellie_tpu.io.verifier import ImInfo as JaxImInfo
from nellie_tpu.kernels import simple_point as jax_simple_point
from nellie_tpu.plugin import config as jax_config
from nellie_tpu.utils.regionprops import regionprops as jax_regionprops
from nellie_tpu_torch import config as port_config
from nellie_tpu_torch.io import FileInfo, ImInfo, ome, tiff
from nellie_tpu_torch.kernels import simple_point
from nellie_tpu_torch.utils.logger import logger
from nellie_tpu_torch.utils.regionprops import regionprops

DIM_RES = {"X": 0.2, "Y": 0.2, "Z": 0.5, "T": 2.0}
WRITE_CASES = {
    "uint16 TZYX with OME description": dict(
        data=("uint16", (2, 3, 20, 24)), description=("TZYX", DIM_RES)),
    "float32 ZYX, OME built from axes": dict(
        data=("float32", (4, 16, 8)), metadata={"axes": "ZYX"}, dim_res=DIM_RES),
    "int32 YX, default axes": dict(data=("int32", (31, 17))),
    "empty uint8 TYX from shape and dtype": dict(shape=(3, 10, 12), dtype="uint8"),
    "plain-text description": dict(data=("uint16", (2, 9, 7)), text="No description."),
}


def _write(mod, path, case, seed=0):
    kwargs = {k: case[k] for k in ("metadata", "dim_res", "shape", "dtype") if k in case}
    data = None
    if "data" in case:
        dtype, shape = case["data"]
        data = (np.random.default_rng(seed).random(shape) * 1000).astype(dtype)
        if "description" in case:
            axes, res = case["description"]
            kwargs["description"] = jax_ome.build_ome_xml(axes, shape, dtype, dim_res=res)
        if "text" in case:
            kwargs["description"] = case["text"]
    mod.imwrite(str(path), data, **kwargs)
    return data


@pytest.mark.parametrize("name", list(WRITE_CASES))
def test_imwrite_gives_identical_bytes(tmp_path, name):
    _write(jax_tiff, tmp_path / "jax.tif", WRITE_CASES[name])
    _write(tiff, tmp_path / "port.tif", WRITE_CASES[name])
    assert (tmp_path / "jax.tif").read_bytes() == (tmp_path / "port.tif").read_bytes()


@pytest.mark.parametrize("writer,reader", [(jax_tiff, tiff), (tiff, jax_tiff)],
                         ids=["port reads jax", "jax reads port"])
@pytest.mark.parametrize("name", list(WRITE_CASES))
def test_each_package_reads_the_others_file(tmp_path, writer, reader, name):
    path = str(tmp_path / "im.tif")
    data = _write(writer, path, WRITE_CASES[name], seed=3)
    got = reader.imread(path)
    if data is not None:
        np.testing.assert_array_equal(got, data)
    else:
        assert got.shape == WRITE_CASES[name]["shape"] and not got.any()
    with reader.TiffFile(path) as a, writer.TiffFile(path) as b:
        assert a.series[0].axes == b.series[0].axes
        assert tuple(a.series[0].shape) == tuple(b.series[0].shape)
        assert a.series[0].dtype == b.series[0].dtype
        assert a.ome_metadata == b.ome_metadata
        assert a.contiguous_offset() == b.contiguous_offset()
    np.testing.assert_array_equal(np.asarray(reader.memmap(path, "r")), got)
    assert reader.tiffcomment(path) == writer.tiffcomment(path)


def test_packbits_decoding_agrees():
    rng = np.random.default_rng(5)
    stream = bytearray()
    for _ in range(200):  # literal runs (n >= 0) and repeats (n < 0), and the no-op -128
        n = int(rng.integers(-127, 128))
        if n >= 0:
            stream += bytes([n]) + rng.integers(0, 256, n + 1, dtype=np.uint8).tobytes()
        else:
            stream += bytes([n & 0xFF, int(rng.integers(0, 256))])
        if rng.random() < 0.05:
            stream += b"\x80"
    assert tiff._packbits_decode(bytes(stream)) == jax_tiff._packbits_decode(bytes(stream))
    assert tiff._decompress(bytes(stream), 32773) == jax_tiff._packbits_decode(bytes(stream))


@pytest.mark.parametrize("axes,shape,dtype,dim_res,description", [
    ("TZYX", (3, 12, 48, 48), "uint16", DIM_RES, None),
    ("ZYX", (5, 7, 9), "float32", {"X": 0.1, "Y": 0.1, "Z": None, "T": None}, "im_distance"),
    ("TYX", (4, 10, 11), "int32", None, "No description."),
    ("TCZYX", (2, 2, 3, 4, 5), "float64", DIM_RES, "a & <b>"),
    ("YX", (6, 8), "uint8", None, None),
])
def test_build_ome_xml_equal(axes, shape, dtype, dim_res, description):
    got = ome.build_ome_xml(axes, shape, dtype, dim_res=dim_res, description=description)
    want = jax_ome.build_ome_xml(axes, shape, dtype, dim_res=dim_res, description=description)
    assert got == want
    assert ome.from_xml(got).to_xml() == jax_ome.from_xml(want).to_xml()


def _open(file_info_cls, im_info_cls, path):
    fi = file_info_cls(path)
    fi.find_metadata()
    fi.load_metadata()
    return fi, im_info_cls(fi)


FILE_INFO_ATTRS = ("metadata_type", "axes", "shape", "dim_res", "good_dims", "good_axes",
                   "validation_errors", "ch", "t_start", "t_end", "dtype", "extension")
IM_INFO_ATTRS = ("axes", "new_axes", "shape", "dim_res", "file_axes", "file_shape", "no_z",
                 "no_t")


@pytest.mark.parametrize("shape,axes", [((3, 6, 20, 22), "TZYX"), ((2, 18, 16), "TYX")])
def test_file_info_and_im_info_agree(tmp_path, shape, axes):
    data = (np.random.default_rng(1).random(shape) * 4000).astype(np.uint16)
    desc = jax_ome.build_ome_xml(axes, shape, "uint16", dim_res=DIM_RES)
    roots, infos = {}, {}
    for name, classes in (("jax", (JaxFileInfo, JaxImInfo)), ("port", (FileInfo, ImInfo))):
        roots[name] = tmp_path / name
        roots[name].mkdir()
        jax_tiff.imwrite(str(roots[name] / "cells.ome.tif"), data, description=desc)
        infos[name] = _open(*classes, str(roots[name] / "cells.ome.tif"))
    (jfi, jim), (pfi, pim) = infos["jax"], infos["port"]
    for attr in FILE_INFO_ATTRS:
        assert getattr(pfi, attr) == getattr(jfi, attr), attr
    for attr in IM_INFO_ATTRS:
        assert getattr(pim, attr) == getattr(jim, attr), attr

    def rel(paths, root):
        return {k: os.path.relpath(v, root) for k, v in paths.items()}

    assert rel(pim.pipeline_paths, roots["port"]) == rel(jim.pipeline_paths, roots["jax"])
    assert os.path.relpath(pim.im_path, roots["port"]) == os.path.relpath(jim.im_path,
                                                                         roots["jax"])
    assert open(pim.im_path, "rb").read() == open(jim.im_path, "rb").read()
    np.testing.assert_array_equal(np.asarray(pim.im), np.asarray(jim.im))

    label = (np.random.default_rng(2).random(pim.shape) * 9).astype(np.int32)
    for im in (jim, pim):  # one artifact from data, one allocated empty
        im.allocate_memory(im.pipeline_paths["im_instance_label"], dtype="int32", data=label,
                           description="labels")
        im.allocate_memory(im.pipeline_paths["im_distance"], dtype="float",
                           description="distances")
    for artifact in ("im_instance_label", "im_distance"):
        assert (open(pim.pipeline_paths[artifact], "rb").read()
                == open(jim.pipeline_paths[artifact], "rb").read()), artifact
        np.testing.assert_array_equal(pim.get_memmap(pim.pipeline_paths[artifact], "r"),
                                      jim.get_memmap(jim.pipeline_paths[artifact], "r"))


def test_simple26_lut_equals_the_jax_package_table():
    lut = simple_point.get_simple26_lut()
    want = np.load(os.path.join(os.path.dirname(jax_simple_point.__file__),
                                "_simple26_lut.npy"))
    assert lut.dtype == want.dtype == np.uint8 and lut.shape == want.shape == (1 << 23,)
    assert lut.tobytes() == want.tobytes()
    assert lut.flags.writeable
    assert simple_point.OFFSETS_26 == jax_simple_point.OFFSETS_26


@pytest.mark.slow
def test_simple26_lut_rebuilds_from_its_source():
    """The compressed table is what the port's builder makes (about 1.5 min)."""
    assert simple_point.build_simple26_lut().tobytes() == simple_point.get_simple26_lut().tobytes()


@pytest.mark.parametrize("ndim,spacing,solidity", [(3, (0.5, 0.2, 0.2), True),
                                                   (3, None, False), (2, (0.3, 0.2), True)])
def test_regionprops_agree(ndim, spacing, solidity):
    rng = np.random.default_rng(4)
    shape = (10, 24, 24)[-ndim:]
    labels = np.zeros(shape, np.int32)
    for lab in range(1, 12):  # overlapping random boxes, one label 6 left out
        if lab == 6:
            continue
        lo = [int(rng.integers(0, s - 3)) for s in shape]
        hi = [int(lo[d] + rng.integers(1, max(2, shape[d] // 2))) for d in range(ndim)]
        box = tuple(slice(a, b) for a, b in zip(lo, hi))
        labels[box] = np.where(rng.random(labels[box].shape) < 0.8, lab, labels[box])
    got = regionprops(labels, spacing=spacing, compute_solidity=solidity)
    want = jax_regionprops(labels, spacing=spacing, compute_solidity=solidity)
    assert [r.label for r in got] == [r.label for r in want] and len(got) >= 8
    for a, b in zip(got, want):
        for field in dataclasses.fields(b):
            x, y = getattr(a, field.name), getattr(b, field.name)
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=field.name)


NON_DEFAULT = dict(
    remove_edges=True, voxel_reassign=False, analyze_node_level=True, skip_vox=3,
    preprocessing_num_t=2, preprocessing_min_radius_um=0.3, preprocessing_frob_thresh=1.5,
    preprocessing_device="cpu", segmentation_label_threshold=0.4,
    segmentation_label_otsu_thresh_intensity=True, segmentation_label_chunk_z=4,
    segmentation_network_max_radius_um=1.5, mocap_use_im="frangi", mocap_num_sigma=3,
    tracking_max_distance_um=2.0, tracking_mode="dense", reassign_max_refine_iterations=5,
    reassign_store_running_matches=False, feature_skip_nodes=True, feature_node_chunk_size=64,
    feature_enable_motility=False, not_a_field="ignored")
PARAMS = ("preprocessing_params", "segmentation_label_params", "segmentation_network_params",
          "mocap_params", "tracking_params", "reassign_params", "feature_params")


@pytest.mark.parametrize("fn", PARAMS)
@pytest.mark.parametrize("settings", [{}, NON_DEFAULT], ids=["default", "non-default"])
def test_stage_params_equal(fn, settings):
    port_cfg = port_config.SettingsConfig.from_dict(settings)
    jax_cfg = jax_config.SettingsConfig.from_dict(settings)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    assert getattr(port_config, fn)(port_cfg) == getattr(jax_config, fn)(jax_cfg)


def test_settings_load_from_a_json_file(tmp_path):
    path = tmp_path / "settings.json"
    path.write_text(jax_config.SettingsConfig.from_dict(NON_DEFAULT).to_json())
    assert (dataclasses.asdict(port_config.SettingsConfig.load(str(path)))
            == dataclasses.asdict(jax_config.SettingsConfig.load(str(path))))
    assert port_config._prune_none({"a": None, "b": 0}) == jax_config._prune_none(
        {"a": None, "b": 0})


def test_logger_is_the_ports_own():
    import logging

    from nellie_tpu.utils.base_logger import logger as jax_logger

    assert logger.name == "nellie_tpu_torch" and logger is not jax_logger
    assert logger.level == jax_logger.level == logging.INFO
    assert ([h.formatter._fmt for h in logger.handlers]
            == [h.formatter._fmt for h in jax_logger.handlers])
