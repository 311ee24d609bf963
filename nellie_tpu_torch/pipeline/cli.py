"""Batch CLI of the port: every matching TIFF of a directory through
:func:`nellie_tpu_torch.pipeline.run.run_path`.

Port of ``nellie_tpu/pipeline/cli.py`` (``main``, ``process_files``,
``process_directory``).  ``--device`` is ``cuda`` (the default) or
``cpu``; it is resolved once, before the first file, so a missing GPU
stops the run instead of failing every file.  A file that fails is
reported and the batch goes on, as in the reference.

    python -m nellie_tpu_torch.pipeline.cli --directory DIR [--substring S]
        [--device cuda|cpu] [--config settings.json] [--remove_edges] [--low_memory]
        [--mesh N|TxZ] [--timeit]

``--low_memory`` passes ``low_memory=True`` to ``run``; with ``--config``
it sets every ``*_low_memory`` field of the config instead, as the
reference's CLI does.  ``--mesh "N"`` (N rows of data parallelism) or
``"TxZ"`` (T rows of Z spatial shards) builds a mesh over the visible GPUs
(or the CPU with ``--device cpu``), listing them again as logical shards
when the mesh has more places than there are devices; with T > 1 and more
than one file, and no ``--config``, the files run through
:func:`nellie_tpu_torch.pipeline.batch.run_files`.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import traceback

import torch

from nellie_tpu_torch.config import SettingsConfig
from nellie_tpu_torch.device import resolve_device
from nellie_tpu_torch.pipeline.run import run_path


def parse_mesh(spec, device="cuda"):
    """``"N"`` (t = N, z = 1) or ``"TxZ"`` -> a mesh over the visible GPUs
    (``cli.py:16-27``), each listed again as a logical shard when the mesh
    has more places; None for no spec."""
    if not spec:
        return None
    from nellie_tpu_torch.mesh import make_mesh

    if "x" in spec.lower():
        t_axis, z_axis = (int(v) for v in spec.lower().split("x"))
        n = t_axis * z_axis
    else:
        n = t_axis = int(spec)
    dev = resolve_device(device)
    visible = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    return make_mesh(n, t_axis=t_axis, devices=[visible[i % len(visible)] for i in range(n)])


def _prepare_file_info(path, ch, num_t, output_dir):
    from nellie_tpu_torch.io import FileInfo

    fi = FileInfo(path, output_dir=output_dir)
    fi.find_metadata()
    fi.load_metadata()
    if ch and "C" in (fi.axes or ""):
        fi.change_selected_channel(ch)
    if num_t is not None and "T" in (fi.axes or ""):
        fi.select_temporal_range(0, num_t - 1)
    errors = fi.get_validation_errors()
    if errors:
        raise ValueError(f"Metadata incomplete for {path}: {errors}")
    return fi


def process_files(files, ch, num_t, output_dir, device="cuda", timeit=False, mesh=None,
                  **kwargs):
    """Run each file; a file that fails is printed and skipped.  With a
    mesh of t extent above 1, several files and no config, the files run
    as one mesh batch (``cli.py:46-71``)."""
    if (mesh is not None and int(mesh.shape.get("t", 1)) > 1 and len(files) > 1
            and kwargs.get("config") is None):
        from nellie_tpu_torch.pipeline.batch import run_files

        file_infos = []
        for path in files:
            try:
                file_infos.append(_prepare_file_info(path, ch, num_t, output_dir))
            except Exception as exc:  # noqa: BLE001 - one bad file must not stop the batch
                print(f"Failed to prepare {path}: {exc}")
        if file_infos:
            run_files(file_infos, mesh=mesh, timeit=timeit, **kwargs)
        return
    dev = resolve_device(device) if mesh is None else mesh.flat()[0]
    if mesh is not None:
        kwargs["mesh"] = mesh
    for file_num, path in enumerate(files):
        print(f"Processing file {file_num + 1} of {len(files)}, channel {ch}")
        try:
            run_path(path, ch=ch, t_end=(num_t - 1 if num_t is not None else None),
                     output_dir=output_dir, device=dev, timeit=timeit, **kwargs)
        except Exception as exc:  # noqa: BLE001 - one bad file must not stop the batch
            print(f"Failed to run {path}: {exc}")
            traceback.print_exc()


def process_directory(directory, substring, output_dir, ch, num_t, **kwargs):
    """The TIFFs of ``directory`` whose names contain ``substring``, sorted."""
    files = sorted(os.path.join(directory, f) for f in os.listdir(directory)
                   if substring in f and f.endswith((".tif", ".tiff")))
    process_files(files, ch, num_t, output_dir, **kwargs)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Process TIFF images in a directory with the PyTorch port of Nellie.")
    parser.add_argument("--directory", required=True, help="Directory with TIFF files")
    parser.add_argument("--substring", default="", help="Substring filter for filenames")
    parser.add_argument("--output_directory", default=None,
                        help="Output directory (default: <input>/nellie_output)")
    parser.add_argument("--ch", type=int, default=0, help="Channel to process")
    parser.add_argument("--num_t", type=int, default=None, help="Number of timepoints")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="Compute device (cuda raises without a GPU)")
    parser.add_argument("--remove_edges", action="store_true")
    parser.add_argument("--low_memory", action="store_true",
                        help="Start the stages in their low-memory (windowed) mode")
    parser.add_argument("--timeit", action="store_true", help="Print per-stage wall time")
    parser.add_argument("--mesh", default=None,
                        help='Device mesh: "N" (N rows, frames and files in parallel) or "TxZ" '
                             "(T rows of Z spatial shards) over the visible GPUs")
    parser.add_argument("--config", default=None,
                        help="Path to a SettingsConfig JSON driving every stage's kwargs; "
                             "--low_memory and --remove_edges override its fields")
    args = parser.parse_args(argv)

    kwargs = {"remove_edges": args.remove_edges, "low_memory": args.low_memory}
    if args.config is not None:
        config = SettingsConfig.load(args.config)
        if args.remove_edges:
            config = dataclasses.replace(config, remove_edges=True)
        if args.low_memory:
            config = dataclasses.replace(config, **{
                f.name: True for f in dataclasses.fields(config) if f.name.endswith("_low_memory")})
        kwargs = {"config": config}
    process_directory(args.directory, args.substring, args.output_directory, args.ch,
                      args.num_t, device=args.device, timeit=args.timeit,
                      mesh=parse_mesh(args.mesh, args.device), **kwargs)


if __name__ == "__main__":
    main()
