"""File verification and image metadata handling for microscopy images.

The PyTorch port's copy of ``nellie_tpu/io/verifier.py``, the rebuild of
the reference's ``FileInfo``/``ImInfo``
(the original Nellie's ``nellie/im_info/verifier.py:18-1070``): same public
API, same canonicalisation semantics (TZYX working copy, singleton-Z
squeeze, 17 pipeline artifact paths), implemented on top of this
package's own TIFF/OME codec (``nellie_tpu_torch.io.tiff`` /
``nellie_tpu_torch.io.ome``).

Every artifact written through ``allocate_memory`` is a contiguous
BigTIFF, so the pipeline streams frames via ``np.memmap`` with zero-copy
host reads.  Paths, names, dtypes and OME metadata are the JAX package's.
"""
from __future__ import annotations

import json
import os

import numpy as np

from nellie_tpu_torch.io import ome as ome_mod
from nellie_tpu_torch.io import tiff as tifffile
from nellie_tpu_torch.utils.logger import logger


def _read_nd2(filepath):
    """ND2 support is gated on the optional `nd2` package."""
    try:
        import nd2  # type: ignore
    except ImportError as exc:
        raise ImportError(
            "Reading .nd2 files requires the optional 'nd2' package, which is "
            "not installed in this environment. Convert the file to OME-TIFF, "
            "or install nd2."
        ) from exc
    return nd2


class FileInfo:
    """File metadata extraction, validation and user-editable axis/resolution
    state for a single microscopy file.

    Mirrors the reference ``FileInfo`` (``verifier.py:18-695``): detects
    OME / ImageJ / raw-TIFF-tag / ND2 metadata, lets the user repair axes,
    per-dimension resolutions, channel and temporal range, and materialises
    a canonical T-first OME-TIFF working copy.
    """

    def __init__(self, filepath, output_dir=None, output_naming="detailed"):
        self.filepath = filepath
        self.metadata = None
        self.metadata_type = None
        self.axes = None
        self.shape = None
        self.dim_res = None

        self.input_dir = os.path.dirname(filepath)
        self.basename = os.path.basename(filepath)
        self.filename_no_ext = os.path.splitext(self.basename)[0]
        self.extension = os.path.splitext(filepath)[1].lower()
        self.output_naming = output_naming
        self.output_dir = output_dir or os.path.join(self.input_dir, "nellie_output")
        os.makedirs(self.output_dir, exist_ok=True)

        self.nellie_necessities_dir = os.path.join(self.output_dir, "nellie_necessities")
        os.makedirs(self.nellie_necessities_dir, exist_ok=True)

        self.ome_output_path = None
        self.good_dims = False
        self.good_axes = False
        self.validation_errors = []

        self.ch = 0
        self.t_start = 0
        self.t_end = None
        self.dtype = None

    # -- metadata discovery --------------------------------------------------
    def _find_tif_metadata(self):
        with tifffile.TiffFile(self.filepath) as tif:
            if tif.is_ome or tif.ome_metadata is not None:
                metadata = ome_mod.from_xml(tif.ome_metadata)
                metadata_type = "ome"
            elif tif.is_imagej:
                metadata = tif.imagej_metadata
                metadata_type = "imagej"
                if "physicalsizex" not in metadata:
                    metadata_type = "imagej_tif_tags"
                    metadata = [metadata, tif.pages[0].tags._dict]
            else:
                metadata = tif.pages[0].tags._dict
                metadata_type = None

            self.metadata = metadata
            self.metadata_type = metadata_type
            self.axes = tif.series[0].axes
            self.shape = tuple(tif.series[0].shape)
            self._normalize_time_axis()
        return metadata, metadata_type

    def _find_nd2_metadata(self):
        nd2 = _read_nd2(self.filepath)
        with nd2.ND2File(self.filepath) as nd2_file:
            metadata = {
                "root": nd2_file.metadata,
                "recorded_data": nd2_file.events(orient="list"),
            }
            self.metadata = metadata
            self.metadata_type = "nd2"
            self.axes = "".join(nd2_file.sizes.keys())
            self.shape = tuple(nd2_file.sizes.values())
            self._normalize_time_axis()

    def find_metadata(self):
        if self.extension in (".tiff", ".tif"):
            self._find_tif_metadata()
        elif self.extension == ".nd2":
            self._find_nd2_metadata()
        else:
            raise ValueError("File type not supported")

    def _normalize_time_axis(self):
        if self.axes is None or self.shape is None:
            return
        if "T" in self.axes:
            return
        if len(self.shape) == len(self.axes) + 1 and self.shape[0] == 1:
            self.axes = "T" + self.axes

    # -- per-format resolution extraction -------------------------------------
    def _get_imagej_metadata(self, metadata):
        self.dim_res["X"] = metadata.get("physicalsizex")
        self.dim_res["Y"] = metadata.get("physicalsizey")
        self.dim_res["Z"] = metadata.get("spacing")
        self.dim_res["T"] = metadata.get("finterval")

    def _get_ome_metadata(self, metadata):
        pixels = metadata.images[0].pixels
        self.dim_res["X"] = pixels.physical_size_x
        self.dim_res["Y"] = pixels.physical_size_y
        self.dim_res["Z"] = pixels.physical_size_z
        self.dim_res["T"] = pixels.time_increment

    def _get_tif_tags_metadata(self, metadata):
        tag_names = {tag_value.name: tag_code for tag_code, tag_value in metadata.items()}

        # some writers emit XResolution=(0, 1) for "unknown", or a
        # ResolutionUnit tag with no X/YResolution at all — guard both
        # so a readable file doesn't crash metadata discovery
        if "XResolution" in tag_names:
            value = metadata[tag_names["XResolution"]].value
            if value[0]:
                self.dim_res["X"] = value[1] / value[0]
        if "YResolution" in tag_names:
            value = metadata[tag_names["YResolution"]].value
            if value[0]:
                self.dim_res["Y"] = value[1] / value[0]
        if "ResolutionUnit" in tag_names:
            unit = metadata[tag_names["ResolutionUnit"]].value
            scale = (1e4 if unit == tifffile.RESUNIT.CENTIMETER
                     else 25400 if unit == tifffile.RESUNIT.INCH else None)
            if scale is not None:
                for d in ("X", "Y"):
                    if self.dim_res.get(d) is not None:
                        self.dim_res[d] *= scale
        if "Z" in self.axes and "ZResolution" in tag_names:
            value = metadata[tag_names["ZResolution"]].value
            if value[0]:
                self.dim_res["Z"] = 1 / value[0]
        if "T" in self.axes and "FrameRate" in tag_names:
            value = metadata[tag_names["FrameRate"]].value
            if value[0]:
                self.dim_res["T"] = 1 / value[0]

    def _get_nd2_metadata(self, metadata):
        recorded_data = {}
        root_metadata = None
        if isinstance(metadata, dict):
            recorded_data = metadata.get("recorded_data") or {}
            root_metadata = metadata.get("root")
        else:
            recorded_data = getattr(metadata, "recorded_data", {}) or {}
            root_metadata = metadata

        timestamps = recorded_data.get("Time [s]")
        if timestamps is not None:
            if len(timestamps) >= 2:
                self.dim_res["T"] = float(np.median(np.diff(timestamps)))
            else:
                self.dim_res["T"] = None

        axes_calibration = None
        if root_metadata is not None:
            volume = (
                root_metadata.get("volume")
                if isinstance(root_metadata, dict)
                else getattr(root_metadata, "volume", None)
            )
            axes_calibration = getattr(volume, "axesCalibration", None)

        if axes_calibration is None and root_metadata is not None:
            channels = (
                root_metadata.get("channels")
                if isinstance(root_metadata, dict)
                else getattr(root_metadata, "channels", None)
            )
            if channels:
                channel = channels[0]
                channel_volume = (
                    channel.get("volume")
                    if isinstance(channel, dict)
                    else getattr(channel, "volume", None)
                )
                axes_calibration = getattr(channel_volume, "axesCalibration", None)

        if axes_calibration is not None:
            if len(axes_calibration) > 0:
                self.dim_res["X"] = axes_calibration[0]
            if len(axes_calibration) > 1:
                self.dim_res["Y"] = axes_calibration[1]
            if len(axes_calibration) > 2:
                self.dim_res["Z"] = axes_calibration[2]

    def load_metadata(self):
        self.dim_res = {"X": None, "Y": None, "Z": None, "T": None}
        if self.metadata_type == "ome":
            self._get_ome_metadata(self.metadata)
        elif self.metadata_type == "imagej":
            self._get_imagej_metadata(self.metadata)
        elif self.metadata_type == "imagej_tif_tags":
            self._get_imagej_metadata(self.metadata[0])
            self._get_tif_tags_metadata(self.metadata[1])
        elif self.metadata_type == "nd2":
            self._get_nd2_metadata(self.metadata)
        elif self.metadata_type is None:
            self._get_tif_tags_metadata(self.metadata)
        self._validate()

    # -- validation ------------------------------------------------------------
    def _check_axes(self):
        errors = self._axis_errors()
        self.good_axes = not errors
        return errors

    def _check_dim_res(self):
        errors = self._dim_errors()
        self.good_dims = not errors
        return errors

    def _axis_errors(self):
        errors = []
        if self.axes is None or self.shape is None:
            errors.append("Axes or shape metadata not loaded")
            return errors
        if len(self.shape) != len(self.axes):
            errors.append("Axes length does not match data shape")
        allowed_axes = {"T", "Z", "Y", "X", "C"}
        if [axis for axis in self.axes if axis not in allowed_axes]:
            errors.append("Axes must only use T, Z, C, Y, X")
        if len(set(self.axes)) != len(self.axes):
            errors.append("Axes must not contain duplicates")
        if "X" not in self.axes or "Y" not in self.axes:
            errors.append("Axes must include both X and Y")
        return errors

    def _dim_errors(self):
        errors = []
        if self.axes is None or self.dim_res is None:
            return errors
        for dim in ["X", "Y", "Z", "T"]:
            if dim in self.axes and self.dim_res.get(dim) is None:
                errors.append(f"Missing {dim} resolution")
        return errors

    def _time_range_errors(self):
        errors = []
        if self.axes is None or self.shape is None:
            return errors
        if "T" not in self.axes:
            return errors
        if self.t_start is None or self.t_end is None:
            return errors
        if self.t_start < 0 or self.t_end < 0:
            errors.append("Temporal range must be >= 0")
        t_index = self.axes.index("T")
        max_t = self.shape[t_index] - 1
        if self.t_start > self.t_end:
            errors.append("Start frame must be <= end frame")
        if self.t_start > max_t or self.t_end > max_t:
            errors.append("Temporal range out of bounds")
        return errors

    def get_validation_errors(self):
        return self._axis_errors() + self._dim_errors() + self._time_range_errors()

    # -- user edits --------------------------------------------------------------
    def change_axes(self, new_axes):
        self.good_axes = False
        self.axes = new_axes
        self._validate()

    def change_dim_res(self, dim, new_size):
        if self.dim_res is None:
            raise ValueError("Dimension resolutions are not initialized")
        if dim not in self.dim_res:
            raise ValueError(f"Invalid dimension '{dim}'")
        self.dim_res[dim] = new_size
        self._validate()

    def change_selected_channel(self, ch):
        if not self.good_dims or not self.good_axes:
            raise ValueError("Must have both valid axes and dimensions to change channel")
        if "C" not in self.axes:
            raise KeyError("No channel dimension to change")
        if ch < 0 or ch >= self.shape[self.axes.index("C")]:
            raise IndexError("Invalid channel index")
        self.ch = ch
        self._get_output_path()

    def select_temporal_range(self, start=0, end=None):
        if self.axes is None or self.shape is None:
            raise ValueError("Axes or shape metadata not loaded")
        if len(self.axes) != len(self.shape):
            raise ValueError("Axes and shape length mismatch")
        if "T" not in self.axes:
            raise KeyError("No time dimension to select")
        if start < 0:
            raise IndexError("Start frame must be >= 0")
        t_index = self.axes.index("T")
        max_t = self.shape[t_index] - 1
        if end is None:
            end = max_t
        if end < 0:
            raise IndexError("End frame must be >= 0")
        if start > end:
            raise ValueError("Start frame must be <= end frame")
        if start > max_t or end > max_t:
            raise IndexError("Temporal range out of bounds")
        self.t_start = start
        self.t_end = end
        self._get_output_path()

    def _validate(self):
        axis_errors = self._check_axes()
        dim_errors = self._check_dim_res()
        if self.good_axes and "T" in self.axes and self.shape is not None:
            if self.t_start is None:
                self.t_start = 0
            t_index = self.axes.index("T")
            if self.t_end is None:
                self.t_end = self.shape[t_index] - 1
        time_errors = self._time_range_errors()
        self.validation_errors = axis_errors + dim_errors + time_errors
        if time_errors:
            raise ValueError(time_errors[0])
        self._get_output_path()

    # -- reading / canonical output ------------------------------------------------
    def read_file(self):
        if self.extension == ".nd2":
            nd2 = _read_nd2(self.filepath)
            data = nd2.imread(self.filepath)
        elif self.extension in (".tif", ".tiff"):
            try:
                data = tifffile.memmap(self.filepath)
            except Exception:
                try:
                    data = tifffile.imread(self.filepath)
                except Exception as read_exc:
                    message = f"Failed to read TIFF file {self.filepath}: {read_exc}"
                    logger.error(message)
                    raise ValueError(message) from read_exc
        else:
            message = f"Filetype {self.extension} not supported. Please convert to .nd2 or .tif."
            logger.error(message)
            raise ValueError(message)
        self.dtype = data.dtype
        return data

    def _get_output_path(self):
        if self.output_naming not in ("detailed", "stable"):
            raise ValueError(f"Unsupported output naming strategy '{self.output_naming}'")

        if self.output_naming == "stable":
            output_name = f"{self.filename_no_ext}"
        else:
            t_text = f"-t{self.t_start}_to_{self.t_end}" if "T" in self.axes else ""
            dim_texts = []
            for axis in self.axes:
                if axis not in self.dim_res:
                    continue
                dim_res = self.dim_res[axis]
                dim_res = "None" if dim_res is None else str(round(dim_res, 4))
                dim_texts.append(f"{axis}{dim_res.replace('.', 'p')}")
            dim_text = f"-{'_'.join(dim_texts)}"
            output_name = f"{self.filename_no_ext}-{self.axes}{dim_text}-ch{self.ch}{t_text}"
        self.user_output_path_no_ext = os.path.join(self.output_dir, output_name)
        self.nellie_necessities_output_path_no_ext = os.path.join(
            self.nellie_necessities_dir, output_name
        )
        self.ome_output_path = self.nellie_necessities_output_path_no_ext + ".ome.tif"

    def save_ome_tiff(self):
        """Materialise the canonical T-first, single-channel OME-TIFF copy."""
        if not self.good_axes or not self.good_dims:
            raise ValueError("Cannot save file with invalid axes or dimensions")

        axes = self.axes
        data = self.read_file()
        if data.ndim != len(axes):
            if "T" in axes and data.ndim == len(axes) - 1:
                data = np.expand_dims(data, axis=axes.index("T"))
            else:
                message = "Data dimensions do not match axes"
                logger.error(message)
                raise ValueError(message)
        if "T" not in self.axes:
            data = data[np.newaxis, ...]
            axes = "T" + self.axes
        else:
            t_index = self.axes.index("T")
            data = np.take(data, range(self.t_start, self.t_end + 1), axis=t_index)
        if "C" in axes:
            data = np.take(data, self.ch, axis=axes.index("C"))
            axes = axes.replace("C", "")

        if "T" in axes:
            t_index = axes.index("T")
            data = np.moveaxis(data, t_index, 0)
            axes = "T" + axes.replace("T", "")

        def _normalize_value(value):
            return value.item() if isinstance(value, np.generic) else value

        provenance = {
            "source_axes": self.axes,
            "output_axes": axes,
            "dim_res": {key: _normalize_value(val) for key, val in self.dim_res.items()},
            "channel": self.ch,
            "t_start": self.t_start,
            "t_end": self.t_end,
        }
        description = ome_mod.build_ome_xml(
            axes,
            data.shape,
            data.dtype.name,
            dim_res=self.dim_res,
            description=json.dumps(provenance, sort_keys=True),
        )
        tifffile.imwrite(
            self.ome_output_path,
            np.ascontiguousarray(data),
            bigtiff=True,
            description=description,
        )


class ImInfo:
    """Owns the canonical memmap, axis convention and every artifact path
    for one pipeline run (reference: ``verifier.py:698-1070``).

    Canonical in-memory layout is T-first with singleton Z squeezed
    (TZYX or TYX); 17 artifacts live under ``nellie_output/`` +
    ``nellie_output/nellie_necessities/``.
    """

    def __init__(self, file_info: FileInfo):
        self.file_info = file_info
        self.im_path = file_info.ome_output_path
        needs_regen = not os.path.exists(self.im_path)
        if not needs_regen:
            with tifffile.TiffFile(self.im_path) as tif:
                existing_axes = tif.series[0].axes
            if "T" not in existing_axes and file_info.axes is not None and "T" in file_info.axes:
                # a selected range of ONE timepoint legitimately reads
                # back without a T axis (size-1 dims are dropped) — only
                # a multi-frame expectation marks the copy stale, else
                # every init would rewrite the canonical file
                t_extent = None
                if file_info.shape is not None:
                    t_extent = file_info.shape[file_info.axes.index("T")]
                    if file_info.t_end is not None:
                        t_extent = file_info.t_end - (file_info.t_start or 0) + 1
                needs_regen = t_extent is None or t_extent > 1
        if needs_regen:
            file_info.save_ome_tiff()
        self.im = tifffile.memmap(self.im_path)

        self.screenshot_dir = os.path.join(self.file_info.output_dir, "screenshots")
        self.graph_dir = os.path.join(self.file_info.output_dir, "graphs")

        self.dim_res = {"X": None, "Y": None, "Z": None, "T": None}
        self.axes = None
        self.new_axes = None
        self.shape = None
        self.ome_metadata = None
        self.file_axes = None
        self.file_shape = None
        self._get_ome_metadata()

        self.no_z = True
        self.no_t = True
        self._check_axes_exist()

        self.pipeline_paths = {}
        self._create_output_paths()
        # (path, mode) -> normalised memmap: every get_memmap call
        # re-parsed the whole TIFF page table (~27 ms/call, profiled at
        # 0.1-0.2 s/frame across the per-frame stage loops); the mapping
        # itself is shared OS pages, so reuse is free and write-coherent
        self._memmap_cache = {}

    def _check_axes_exist(self):
        if "Z" in self.axes and self.shape[self.axes.index("Z")] > 1:
            self.no_z = False
        if "T" in self.axes and self.shape[self.axes.index("T")] > 1:
            self.no_t = False

    def create_output_path(self, pipeline_path: str, ext: str = ".ome.tif", for_nellie=True):
        if for_nellie:
            output_path = f"{self.file_info.nellie_necessities_output_path_no_ext}-{pipeline_path}{ext}"
        else:
            output_path = f"{self.file_info.user_output_path_no_ext}-{pipeline_path}{ext}"
        self.pipeline_paths[pipeline_path] = output_path
        return self.pipeline_paths[pipeline_path]

    def _create_output_paths(self):
        # the 17 pipeline artifacts (reference verifier.py:837-854)
        self.create_output_path("im_preprocessed")
        self.create_output_path("im_instance_label")
        self.create_output_path("im_skel")
        self.create_output_path("im_skel_relabelled")
        self.create_output_path("im_pixel_class")
        self.create_output_path("im_marker")
        self.create_output_path("im_distance")
        self.create_output_path("im_border")
        self.create_output_path("flow_vector_array", ext=".npy")
        self.create_output_path("voxel_matches", ext=".npy")
        self.create_output_path("im_branch_label_reassigned")
        self.create_output_path("im_obj_label_reassigned")
        self.create_output_path("features_voxels", ext=".csv", for_nellie=False)
        self.create_output_path("features_nodes", ext=".csv", for_nellie=False)
        self.create_output_path("features_branches", ext=".csv", for_nellie=False)
        self.create_output_path("features_organelles", ext=".csv", for_nellie=False)
        self.create_output_path("features_image", ext=".csv", for_nellie=False)
        self.create_output_path("adjacency_maps", ext=".pkl")

    def remove_intermediates(self):
        all_paths = [self.pipeline_paths[p] for p in self.pipeline_paths]
        for pipeline_path in all_paths + [self.im_path]:
            if "csv" in pipeline_path:
                continue
            if os.path.exists(pipeline_path):
                self._invalidate_memmap(pipeline_path)
                os.remove(pipeline_path)

    def _get_ome_metadata(self):
        with tifffile.TiffFile(self.im_path) as tif:
            self.file_axes = tif.series[0].axes
            self.file_shape = tuple(tif.series[0].shape)
        self.im, self.axes = self._normalize_axes(self.im, self.file_axes)
        self.new_axes = self.axes
        self.shape = self.im.shape
        self.ome_metadata = ome_mod.from_xml(tifffile.tiffcomment(self.im_path))
        pixels = self.ome_metadata.images[0].pixels
        self.dim_res["X"] = pixels.physical_size_x
        self.dim_res["Y"] = pixels.physical_size_y
        self.dim_res["Z"] = pixels.physical_size_z
        self.dim_res["T"] = pixels.time_increment

    def _normalize_axes(self, data, axes):
        """Normalize axes to canonical order (T, Z, Y, X), squeeze singleton Z."""
        if axes is None:
            raise ValueError("Axes metadata is not initialized")
        axes_list = list(axes)
        if "T" not in axes_list:
            data = data[np.newaxis, ...]
            axes_list = ["T"] + axes_list
        else:
            t_index = axes_list.index("T")
            if t_index != 0:
                data = np.moveaxis(data, t_index, 0)
                axes_list = ["T"] + [ax for i, ax in enumerate(axes_list) if i != t_index]
        if "Z" in axes_list:
            z_index = axes_list.index("Z")
            if data.shape[z_index] == 1:
                data = np.squeeze(data, axis=z_index)
                axes_list.pop(z_index)
        allowed_axes = {"T", "Z", "Y", "X"}
        extra_axes = [ax for ax in axes_list if ax not in allowed_axes]
        if extra_axes:
            raise ValueError(f"Unsupported axes found: {extra_axes}")
        if "Y" not in axes_list or "X" not in axes_list:
            raise ValueError("Axes must include both Y and X")
        target_axes = ["T"]
        if "Z" in axes_list:
            target_axes.append("Z")
        target_axes.extend(["Y", "X"])
        if axes_list != target_axes:
            order = [axes_list.index(ax) for ax in target_axes]
            data = np.transpose(data, order)
            axes_list = target_axes
        if data.ndim != len(axes_list):
            raise ValueError("Data dimensions do not match normalized axes")
        return data, "".join(axes_list)

    def _normalize_memmap(self, memmap, file_axes):
        if file_axes is None:
            return memmap
        data = memmap
        axes_list = list(file_axes)
        if "T" not in axes_list:
            data = data[np.newaxis, ...]
            axes_list = ["T"] + axes_list
        else:
            t_index = axes_list.index("T")
            if t_index != 0:
                data = np.moveaxis(data, t_index, 0)
                axes_list = ["T"] + [ax for i, ax in enumerate(axes_list) if i != t_index]
        if "Z" in axes_list and "Z" not in self.axes:
            z_index = axes_list.index("Z")
            if data.shape[z_index] == 1:
                data = np.squeeze(data, axis=z_index)
                axes_list.pop(z_index)
            else:
                raise ValueError("Z axis present with size > 1, but ImInfo expects no Z axis")
        target_axes = list(self.axes)
        if set(axes_list) != set(target_axes):
            extra = sorted(set(axes_list) - set(target_axes))
            missing = sorted(set(target_axes) - set(axes_list))
            raise ValueError(f"Axes mismatch. Extra: {extra}, missing: {missing}")
        if axes_list != target_axes:
            order = [axes_list.index(ax) for ax in target_axes]
            data = np.transpose(data, order)
        return data

    def get_memmap(self, file_path, read_mode="r+"):
        key = (str(file_path), read_mode)
        cached = self._memmap_cache.get(key)
        if cached is not None:
            return cached
        memmap = tifffile.memmap(file_path, mode=read_mode)
        try:
            with tifffile.TiffFile(file_path) as tif:
                file_axes = tif.series[0].axes
        except Exception:
            file_axes = None
        out = self._normalize_memmap(memmap, file_axes)
        self._memmap_cache[key] = out
        return out

    def _invalidate_memmap(self, file_path):
        p = str(file_path)
        for key in [k for k in self._memmap_cache if k[0] == p]:
            del self._memmap_cache[key]

    def allocate_memory(
        self,
        output_path,
        dtype="float",
        data=None,
        description="No description.",
        return_memmap=False,
        read_mode="r+",
    ):
        """Create an artifact BigTIFF (empty or from data) with OME metadata."""
        axes = self.new_axes or self.axes
        if axes is None:
            raise ValueError("Axes metadata is not initialized")
        if data is not None and len(axes) != data.ndim:
            if axes.startswith("T") and data.ndim == len(axes) - 1:
                data = data[np.newaxis, ...]
            elif "T" not in axes and data.ndim == len(axes) + 1:
                axes = "T" + axes
            else:
                raise ValueError("Data dimensions do not match axes")

        if dtype == "float":
            np_dtype = np.dtype("float32")
        elif dtype == "double":
            np_dtype = np.dtype("float64")
        else:
            np_dtype = np.dtype(dtype)

        if data is None:
            if len(axes) != len(self.shape):
                raise ValueError("Shape does not match axes")
            shape = self.shape
            dtype_name = np_dtype.name
        else:
            data = np.asarray(data)
            shape = data.shape
            dtype_name = data.dtype.name

        ome_xml = ome_mod.build_ome_xml(
            axes, shape, dtype_name, dim_res=self.dim_res, description=description
        )
        if data is None:
            tifffile.imwrite(
                output_path, shape=shape, dtype=np_dtype, bigtiff=True, description=ome_xml
            )
        else:
            tifffile.imwrite(output_path, data, bigtiff=True, description=ome_xml)
        self._invalidate_memmap(output_path)  # the file was just recreated
        if return_memmap:
            return self.get_memmap(output_path, read_mode=read_mode)
