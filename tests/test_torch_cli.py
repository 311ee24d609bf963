"""The port's batch CLI (``nellie_tpu_torch.pipeline.cli``) on the CPU.

The directory of ``tests/test_cli.py``: two 2D ``YX`` files whose names
match the substring filter and one that does not.  ``main`` runs in this
process; its outputs land in ``<directory>/nellie_output``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from nellie_tpu_torch.io import ome as ome_mod
from nellie_tpu_torch.io import tiff as tifffile
from nellie_tpu_torch.pipeline import cli

MATCHING = ("mito_a", "mito_b")


@pytest.fixture
def directory(tmp_path):
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:48, 0:48]
    for name in MATCHING:
        line = 700 * np.exp(-((y - 24 + 5 * np.sin(x / 6)) ** 2) / (2 * 2.0 ** 2))
        data = np.clip(line + rng.normal(80, 5, (48, 48)), 0, None).astype(np.uint16)
        desc = ome_mod.build_ome_xml("YX", data.shape, "uint16",
                                     dim_res={"X": 0.1, "Y": 0.1, "Z": None, "T": None})
        tifffile.imwrite(tmp_path / f"{name}.ome.tif", data, description=desc)
    tifffile.imwrite(tmp_path / "er_c.ome.tif", np.zeros((48, 48), np.uint16))
    return tmp_path


def _outputs(directory, suffix):
    out = directory / "nellie_output"
    if not out.exists():
        return []
    return sorted(f for f in os.listdir(out) if f.endswith(suffix))


def test_cli_runs_matching_2d_files_on_the_cpu(directory, capsys):
    cli.main(["--directory", str(directory), "--substring", "mito", "--device", "cpu",
              "--timeit"])
    csvs = _outputs(directory, "features_organelles.csv")
    for name in MATCHING:
        assert [f for f in csvs if f.startswith(name)], name
    assert not [f for f in os.listdir(directory / "nellie_output") if f.startswith("er_c")]
    printed = capsys.readouterr().out
    assert "Processing file 2 of 2" in printed and "Failed" not in printed
    for name in csvs:
        with open(directory / "nellie_output" / name) as f:
            header = f.readline().rstrip("\n").split(",")
            rows = f.readlines()
        assert header[:2] == ["t", "label"] and rows
        z = header.index("z_raw")
        assert all(row.rstrip("\n").split(",")[z] == "" for row in rows)


def test_cli_cuda_without_gpu_raises_before_any_file(directory, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for machines without it")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--directory", str(directory), "--substring", "mito"])
    assert "Processing file" not in capsys.readouterr().out
    assert not (directory / "nellie_output").exists()


def test_cli_config_reaches_the_stages(directory, capsys):
    """A config's toggles apply to every file, and a stage option the port
    refuses fails each file alone while the batch goes on."""
    config = directory / "settings.json"
    config.write_text(json.dumps({"remove_intermediates": True, "analyze_node_level": True}))
    cli.main(["--directory", str(directory), "--substring", "mito", "--device", "cpu",
              "--config", str(config)])
    assert len(_outputs(directory, "features_nodes.csv")) == 2
    assert not (directory / "nellie_output" / "nellie_necessities").exists() or not os.listdir(
        directory / "nellie_output" / "nellie_necessities")
    config.write_text(json.dumps({"preprocessing_carry_dtype": "float16"}))
    cli.main(["--directory", str(directory), "--substring", "mito_a", "--device", "cpu",
              "--config", str(config)])
    printed = capsys.readouterr().out
    assert "Failed to run" in printed and "carry_dtype" in printed


def test_cli_refuses_low_memory(directory, monkeypatch):
    """``--low_memory`` runs: without a config it reaches ``run``, with one
    it sets every ``*_low_memory`` field of the config."""
    seen = []
    original = cli.run_path

    def spy(path, **kwargs):
        seen.append(kwargs)
        return original(path, **kwargs)

    monkeypatch.setattr(cli, "run_path", spy)
    cli.main(["--directory", str(directory), "--substring", "mito_a", "--device", "cpu",
              "--low_memory"])
    assert seen[-1]["low_memory"] is True
    assert _outputs(directory, "features_organelles.csv")
    config = directory / "settings.json"
    config.write_text(json.dumps({"remove_intermediates": True}))
    cli.main(["--directory", str(directory), "--substring", "mito_b", "--device", "cpu",
              "--low_memory", "--config", str(config)])
    cfg = seen[-1]["config"]
    lows = [f.name for f in dataclasses.fields(cfg) if f.name.endswith("_low_memory")]
    assert len(lows) == 7 and all(getattr(cfg, name) for name in lows)
    assert [f for f in _outputs(directory, "features_organelles.csv") if f.startswith("mito_b")]
