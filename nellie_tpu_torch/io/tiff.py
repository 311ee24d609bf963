"""Self-contained TIFF / BigTIFF / OME-TIFF codec.

The reference pipeline stores every artifact as a (Big)TIFF and streams
frames through ``tifffile.memmap`` (the original Nellie's ``nellie/im_info/
verifier.py:541-572,967-1070``).  ``tifffile`` is not a dependency, so
this module implements the subset of TIFF that the
pipeline needs, designed so that *all output files are memmap-able*:

* reader: classic TIFF + BigTIFF, little/big endian, strip-based, with
  ``none``/``deflate``/``packbits``/``LZW`` compression and horizontal
  predictor; OME-XML and ImageJ metadata detection.
* writer: BigTIFF with one strip per plane and a contiguous pixel-data
  region, so ``memmap()`` maps the whole series zero-copy.  The OME-XML
  description lives in a reserved, padded region so ``tiffcomment`` can
  rewrite it in place.
* ``memmap(path)``: numpy memmap over the contiguous series data.

API names deliberately mirror the tifffile functions the reference uses
(``imread``/``imwrite``/``memmap``/``tiffcomment``/``TiffFile``) so the
IO layer reads naturally to users of the reference.
"""
from __future__ import annotations

import enum
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# --------------------------------------------------------------------------
# TIFF constants
# --------------------------------------------------------------------------

TAG_NAMES = {
    254: "NewSubfileType",
    256: "ImageWidth",
    257: "ImageLength",
    258: "BitsPerSample",
    259: "Compression",
    262: "PhotometricInterpretation",
    270: "ImageDescription",
    273: "StripOffsets",
    277: "SamplesPerPixel",
    278: "RowsPerStrip",
    279: "StripByteCounts",
    282: "XResolution",
    283: "YResolution",
    284: "PlanarConfiguration",
    296: "ResolutionUnit",
    305: "Software",
    317: "Predictor",
    322: "TileWidth",
    323: "TileLength",
    324: "TileOffsets",
    325: "TileByteCounts",
    339: "SampleFormat",
}

# TIFF data types: code -> (struct char, size)
TYPE_FORMATS = {
    1: ("B", 1),   # BYTE
    2: ("s", 1),   # ASCII
    3: ("H", 2),   # SHORT
    4: ("I", 4),   # LONG
    5: ("II", 8),  # RATIONAL (two LONGs)
    6: ("b", 1),   # SBYTE
    7: ("B", 1),   # UNDEFINED
    8: ("h", 2),   # SSHORT
    9: ("i", 4),   # SLONG
    10: ("ii", 8), # SRATIONAL
    11: ("f", 4),  # FLOAT
    12: ("d", 8),  # DOUBLE
    16: ("Q", 8),  # LONG8 (BigTIFF)
    17: ("q", 8),  # SLONG8
    18: ("Q", 8),  # IFD8
}


class RESUNIT(enum.IntEnum):
    NONE = 1
    INCH = 2
    CENTIMETER = 3


class COMPRESSION(enum.IntEnum):
    NONE = 1
    LZW = 5
    PACKBITS = 32773
    DEFLATE = 8
    ADOBE_DEFLATE = 32946


_SAMPLEFORMAT_DTYPES = {
    (1, 8): "u1", (1, 16): "u2", (1, 32): "u4", (1, 64): "u8",
    (2, 8): "i1", (2, 16): "i2", (2, 32): "i4", (2, 64): "i8",
    (3, 16): "f2", (3, 32): "f4", (3, 64): "f8",
    (4, 8): "u1",  # "undefined" treated as uint
}

_DTYPE_SAMPLEFORMAT = {"u": 1, "i": 2, "f": 3, "b": 1}


# --------------------------------------------------------------------------
# Decompressors
# --------------------------------------------------------------------------

def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        header = data[i]
        i += 1
        if header < 128:
            count = header + 1
            out += data[i : i + count]
            i += count
        elif header > 128:
            count = 257 - header
            out += data[i : i + 1] * count
            i += 1
        # header == 128: no-op
    return bytes(out)


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first, early code change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: List[bytes] = []

    def reset_table():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset_table()
    bitpos = 0
    nbits = 9
    prev: Optional[bytes] = None
    total_bits = len(data) * 8
    while bitpos + nbits <= total_bits:
        byte_idx = bitpos >> 3
        chunk = data[byte_idx : byte_idx + 4]
        val = int.from_bytes(chunk.ljust(4, b"\0"), "big")
        code = (val >> (32 - (bitpos & 7) - nbits)) & ((1 << nbits) - 1)
        bitpos += nbits
        if code == EOI:
            break
        if code == CLEAR:
            reset_table()
            nbits = 9
            prev = None
            continue
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # TIFF early code change: bump width one code early
        if len(table) >= (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    return bytes(out)


def _decompress(data: bytes, compression: int, expected_size: int = 0) -> bytes:
    if compression == COMPRESSION.NONE:
        return data
    if compression in (COMPRESSION.DEFLATE, COMPRESSION.ADOBE_DEFLATE):
        return zlib.decompress(data)
    if compression not in (COMPRESSION.PACKBITS, COMPRESSION.LZW):
        raise ValueError(f"Unsupported TIFF compression: {compression}")
    # the native codec (nellie_tpu_torch/native) where it is built; the
    # Python decoders give the same bytes
    from nellie_tpu_torch import native

    packbits = compression == COMPRESSION.PACKBITS
    if expected_size:
        decode = native.packbits_decode if packbits else native.lzw_decode
        out = decode(data, expected_size)
        if out is not None:
            return out
    native.record("python")
    return _packbits_decode(data) if packbits else _lzw_decode(data)


# --------------------------------------------------------------------------
# Reader
# --------------------------------------------------------------------------

@dataclass
class TiffTag:
    code: int
    dtype: int
    count: int
    value: object
    # file position of this 20/12-byte IFD entry (for in-place rewriting)
    entry_offset: int = 0
    # file position where out-of-line values live (0 = inline)
    value_offset: int = 0

    @property
    def name(self) -> str:
        return TAG_NAMES.get(self.code, str(self.code))


class TagDict(dict):
    """dict keyed by tag code, with a `_dict` alias for reference parity."""

    @property
    def _dict(self):
        return self


@dataclass
class TiffPage:
    index: int
    tags: TagDict
    shape: Tuple[int, ...] = ()
    dtype: Optional[np.dtype] = None
    offset: int = 0  # file offset of the IFD

    def tag_value(self, code, default=None):
        tag = self.tags.get(code)
        return default if tag is None else tag.value

    @property
    def description(self) -> Optional[str]:
        val = self.tag_value(270)
        if val is None:
            return None
        if isinstance(val, bytes):
            val = val.decode("utf-8", "replace")
        return val.rstrip("\x00")

    @property
    def compression(self) -> int:
        return int(self.tag_value(259, 1))

    @property
    def predictor(self) -> int:
        return int(self.tag_value(317, 1))


@dataclass
class TiffSeries:
    shape: Tuple[int, ...]
    axes: str
    dtype: np.dtype
    pages: List[TiffPage] = field(default_factory=list)


def _as_tuple(value) -> tuple:
    if isinstance(value, tuple):
        return value
    return (value,)


class TiffFile:
    """Parse TIFF/BigTIFF structure and expose pages/series/metadata."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self._fh = open(self.path, "rb")
        self.byteorder = "<"
        self.bigtiff = False
        self.pages: List[TiffPage] = []
        self.first_ifd_offset_pos = 4  # header slot holding the first IFD offset
        self._parse_header()
        self._parse_pages()
        self._series: Optional[List[TiffSeries]] = None

    # -- context manager ----------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- parsing ------------------------------------------------------------
    def _parse_header(self):
        head = self._fh.read(8)
        if len(head) < 8:
            raise ValueError(f"Not a TIFF file: {self.path}")
        if head[:2] == b"II":
            self.byteorder = "<"
        elif head[:2] == b"MM":
            self.byteorder = ">"
        else:
            raise ValueError(f"Not a TIFF file: {self.path}")
        magic = struct.unpack(self.byteorder + "H", head[2:4])[0]
        if magic == 42:
            self.bigtiff = False
            self.first_ifd = struct.unpack(self.byteorder + "I", head[4:8])[0]
            self.first_ifd_offset_pos = 4
        elif magic == 43:
            self.bigtiff = True
            rest = self._fh.read(8)
            offsize, zero = struct.unpack(self.byteorder + "HH", head[4:8])
            if offsize != 8 or zero != 0:
                raise ValueError("Invalid BigTIFF header")
            self.first_ifd = struct.unpack(self.byteorder + "Q", rest)[0]
            self.first_ifd_offset_pos = 8
        else:
            raise ValueError(f"Invalid TIFF magic: {magic}")

    def _read_tag_value(self, dtype, count, raw, inline_size):
        fmt_char, size = TYPE_FORMATS.get(dtype, ("B", 1))
        nbytes = size * count
        if nbytes <= inline_size:
            data = raw[:nbytes]
            value_offset = 0
        else:
            offfmt = "Q" if self.bigtiff else "I"
            value_offset = struct.unpack(self.byteorder + offfmt, raw[: 8 if self.bigtiff else 4])[0]
            pos = self._fh.tell()
            self._fh.seek(value_offset)
            data = self._fh.read(nbytes)
            self._fh.seek(pos)
        if dtype == 2:  # ASCII
            return data.rstrip(b"\x00").decode("utf-8", "replace"), value_offset
        if dtype in (5, 10):  # RATIONAL
            sub = "I" if dtype == 5 else "i"
            vals = struct.unpack(self.byteorder + sub * (2 * count), data)
            pairs = tuple(tuple(vals[2 * i : 2 * i + 2]) for i in range(count))
            return (pairs[0] if count == 1 else pairs), value_offset
        vals = struct.unpack(self.byteorder + fmt_char * count, data[: size * count])
        return (vals[0] if count == 1 else vals), value_offset

    def _parse_ifd(self, offset: int, index: int) -> Tuple[TiffPage, int]:
        fh = self._fh
        fh.seek(offset)
        if self.bigtiff:
            (nentries,) = struct.unpack(self.byteorder + "Q", fh.read(8))
            entry_size, inline = 20, 8
        else:
            (nentries,) = struct.unpack(self.byteorder + "H", fh.read(2))
            entry_size, inline = 12, 4
        entries_start = fh.tell()
        raw_entries = fh.read(nentries * entry_size)
        next_pos = fh.tell()
        if self.bigtiff:
            (next_ifd,) = struct.unpack(self.byteorder + "Q", fh.read(8))
        else:
            (next_ifd,) = struct.unpack(self.byteorder + "I", fh.read(4))

        tags = TagDict()
        for i in range(nentries):
            entry = raw_entries[i * entry_size : (i + 1) * entry_size]
            if self.bigtiff:
                code, dtype = struct.unpack(self.byteorder + "HH", entry[:4])
                (count,) = struct.unpack(self.byteorder + "Q", entry[4:12])
                raw_val = entry[12:20]
            else:
                code, dtype = struct.unpack(self.byteorder + "HH", entry[:4])
                (count,) = struct.unpack(self.byteorder + "I", entry[4:8])
                raw_val = entry[8:12]
            try:
                value, value_offset = self._read_tag_value(dtype, count, raw_val, inline)
            except Exception:
                continue
            tags[code] = TiffTag(
                code=code, dtype=dtype, count=count, value=value,
                entry_offset=entries_start + i * entry_size,
                value_offset=value_offset,
            )
        page = TiffPage(index=index, tags=tags, offset=offset)
        self._set_page_shape_dtype(page)
        self._ifd_next_positions = getattr(self, "_ifd_next_positions", [])
        self._ifd_next_positions.append(next_pos)
        return page, next_ifd

    def _set_page_shape_dtype(self, page: TiffPage):
        width = int(page.tag_value(256, 0))
        length = int(page.tag_value(257, 0))
        spp = int(page.tag_value(277, 1))
        bits = page.tag_value(258, 8)
        if isinstance(bits, tuple):
            bits = bits[0]
        fmt = page.tag_value(339, 1)
        if isinstance(fmt, tuple):
            fmt = fmt[0]
        key = (int(fmt), int(bits))
        dtype_str = _SAMPLEFORMAT_DTYPES.get(key)
        if dtype_str is None:
            dtype_str = "u1" if bits <= 8 else "u2"
        page.dtype = np.dtype(self.byteorder + dtype_str)
        page.shape = (length, width, spp) if spp > 1 else (length, width)

    def _parse_pages(self, max_pages: int = 10_000_000):
        offset = self.first_ifd
        index = 0
        seen = set()
        while offset and offset not in seen and index < max_pages:
            seen.add(offset)
            page, offset = self._parse_ifd(offset, index)
            self.pages.append(page)
            index += 1

    # -- metadata -----------------------------------------------------------
    @property
    def _description(self) -> str:
        if not self.pages:
            return ""
        return self.pages[0].description or ""

    @property
    def is_ome(self) -> bool:
        d = self._description
        return "<OME" in d and "openmicroscopy.org" in d

    @property
    def ome_metadata(self) -> Optional[str]:
        return self._description if self.is_ome else None

    @property
    def is_imagej(self) -> bool:
        return self._description.startswith("ImageJ=")

    @property
    def imagej_metadata(self) -> Optional[dict]:
        if not self.is_imagej:
            return None
        meta = {}
        for line in self._description.splitlines():
            if "=" not in line:
                continue
            key, _, val = line.partition("=")
            val = val.strip()
            for cast in (int, float):
                try:
                    val = cast(val)
                    break
                except ValueError:
                    continue
            meta[key.strip()] = val
        return meta

    # -- series -------------------------------------------------------------
    @property
    def series(self) -> List[TiffSeries]:
        if self._series is None:
            self._series = [self._build_series()]
        return self._series

    def _build_series(self) -> TiffSeries:
        pages = self.pages
        if not pages:
            raise ValueError("TIFF file contains no pages")
        p0 = pages[0]
        # group only pages matching the first page's shape/dtype
        same = [p for p in pages if p.shape == p0.shape and p.dtype == p0.dtype]
        npages = len(same)
        base_axes = "YXS" if len(p0.shape) == 3 else "YX"

        if self.is_ome:
            try:
                from nellie_tpu_torch.io import ome as ome_mod

                meta = ome_mod.from_xml(self.ome_metadata)
                px = meta.images[0].pixels
                order = px.dimension_order  # e.g. 'XYCZT' (X fastest)
                extra = [ax for ax in reversed(order) if ax in "TZC"]  # slowest first
                sizes = {"T": px.size_t, "Z": px.size_z, "C": px.size_c}
                dims, axes = [], ""
                for ax in extra:
                    if sizes[ax] > 1:
                        dims.append(sizes[ax])
                        axes += ax
                expected = int(np.prod(dims)) if dims else 1
                if expected == npages:
                    return TiffSeries(
                        shape=tuple(dims) + p0.shape,
                        axes=axes + base_axes,
                        dtype=p0.dtype,
                        pages=same,
                    )
            except Exception:
                pass

        if self.is_imagej:
            meta = self.imagej_metadata or {}
            frames = int(meta.get("frames", 1))
            slices = int(meta.get("slices", 1))
            channels = int(meta.get("channels", 1))
            dims, axes = [], ""
            for n, ax in ((frames, "T"), (slices, "Z"), (channels, "C")):
                if n > 1:
                    dims.append(n)
                    axes += ax
            expected = int(np.prod(dims)) if dims else 1
            if expected == npages:
                return TiffSeries(
                    shape=tuple(dims) + p0.shape,
                    axes=axes + base_axes,
                    dtype=p0.dtype,
                    pages=same,
                )
            if expected > npages == 1:
                # ImageJ "truncated" / raw big-stack layout: ONE IFD and
                # all frames stored contiguously after the first page's
                # data — honoring only the IFD would silently read 1 of
                # N frames
                try:
                    off = int(_as_tuple(p0.tag_value(273))[0])
                    frame_bytes = int(np.prod(p0.shape)) * p0.dtype.itemsize
                    fits = (p0.compression == COMPRESSION.NONE
                            and off + expected * frame_bytes
                            <= os.path.getsize(self.path))
                except Exception:  # noqa: BLE001 — malformed page tags
                    fits = False
                if fits:
                    return TiffSeries(
                        shape=tuple(dims) + p0.shape,
                        axes=axes + base_axes,
                        dtype=p0.dtype,
                        pages=same,
                    )

        if npages == 1:
            return TiffSeries(shape=p0.shape, axes=base_axes, dtype=p0.dtype, pages=same)
        return TiffSeries(
            shape=(npages,) + p0.shape, axes="Q" + base_axes, dtype=p0.dtype, pages=same
        )

    # -- pixel data ---------------------------------------------------------
    def _page_data(self, page: TiffPage) -> np.ndarray:
        offsets = _as_tuple(page.tag_value(273))
        counts = _as_tuple(page.tag_value(279))
        if offsets[0] is None:
            raise ValueError("Page has no strip offsets")
        rows_per_strip = int(page.tag_value(278, page.shape[0]))
        compression = page.compression
        height, width = page.shape[0], page.shape[1]
        spp = page.shape[2] if len(page.shape) == 3 else 1
        row_bytes = width * spp * page.dtype.itemsize
        out = np.empty(page.shape, dtype=page.dtype)
        flat = out.reshape(height, -1).view(np.uint8)
        if self._native_page_data(page, offsets, counts, rows_per_strip, flat, row_bytes):
            return out
        row = 0
        for off, cnt in zip(offsets, counts):
            self._fh.seek(int(off))
            raw = self._fh.read(int(cnt))
            nrows = min(rows_per_strip, height - row)
            data = _decompress(raw, compression, expected_size=nrows * row_bytes)
            need = nrows * row_bytes
            strip = np.frombuffer(data[:need], dtype=np.uint8).reshape(nrows, row_bytes)
            if page.predictor == 2:
                arr = strip.view(page.dtype.newbyteorder(self.byteorder)).reshape(
                    nrows, width, spp
                )
                arr = np.cumsum(arr, axis=1, dtype=arr.dtype)
                strip = arr.reshape(nrows, -1).view(np.uint8)
            flat[row : row + nrows] = strip
            row += nrows
        return out

    def _native_page_data(self, page, offsets, counts, rows_per_strip, flat, row_bytes) -> bool:
        """An LZW or PackBits page's strips decoded by the native codec's
        batch decoder straight into ``flat`` (height, row bytes), then the
        horizontal predictor undone in place; False (``flat`` untouched
        or to be overwritten) where the codec is not built or a strip
        fails, and the strip loop decodes the page instead."""
        from nellie_tpu_torch import native

        if page.compression not in (COMPRESSION.LZW, COMPRESSION.PACKBITS) or not native.available():
            return False
        height = flat.shape[0]
        raws = []
        for off, cnt in zip(offsets, counts):
            self._fh.seek(int(off))
            raws.append(self._fh.read(int(cnt)))
        lengths = np.array([len(r) for r in raws], np.int64)
        starts = np.arange(len(raws), dtype=np.int64) * rows_per_strip
        nrows = np.minimum(rows_per_strip, height - starts)
        if len(raws) * rows_per_strip < height or nrows.min() <= 0:
            return False
        dst = flat.reshape(-1)
        if not native.decode_strips(b"".join(raws), np.cumsum(lengths) - lengths, lengths, dst,
                                    starts * row_bytes, nrows * row_bytes, page.compression):
            return False
        if page.predictor == 2:
            spp = page.shape[2] if len(page.shape) == 3 else 1
            rows = flat.view(page.dtype.newbyteorder(self.byteorder))
            if not (rows.dtype.isnative and native.undo_predictor(rows, spp)):
                arr = rows.reshape(height, -1, spp)
                rows[:] = np.cumsum(arr, axis=1, dtype=arr.dtype).reshape(height, -1)
        return True

    def asarray(self) -> np.ndarray:
        series = self.series[0]
        if len(series.pages) == 1:
            data = self._page_data(series.pages[0])
            n_expected = int(np.prod(series.shape))
            if data.size != n_expected:
                # ImageJ truncated layout: one IFD, N contiguous frames
                offset = self.contiguous_offset()
                self._fh.seek(offset)
                raw = self._fh.read(n_expected * series.dtype.itemsize)
                return np.frombuffer(raw, series.dtype).reshape(series.shape).copy()
            return data.reshape(series.shape)
        planes = [self._page_data(p) for p in series.pages]
        return np.stack(planes).reshape(series.shape)

    # -- memmap support -----------------------------------------------------
    def contiguous_offset(self) -> Optional[int]:
        """Return the file offset of series data if stored contiguously."""
        series = self.series[0]
        expected = None
        start = None
        for page in series.pages:
            if page.compression != COMPRESSION.NONE:
                return None
            offsets = _as_tuple(page.tag_value(273))
            counts = _as_tuple(page.tag_value(279))
            for off, cnt in zip(offsets, counts):
                off, cnt = int(off), int(cnt)
                if start is None:
                    start = off
                    expected = off
                if off != expected:
                    return None
                expected += cnt
        return start


# --------------------------------------------------------------------------
# Convenience functions
# --------------------------------------------------------------------------

def imread(path) -> np.ndarray:
    with TiffFile(path) as tif:
        return tif.asarray()


def memmap(path, mode: str = "r+") -> np.memmap:
    """Memory-map the image series of a contiguous, uncompressed TIFF."""
    with TiffFile(path) as tif:
        series = tif.series[0]
        offset = tif.contiguous_offset()
        if offset is None:
            raise ValueError(f"TIFF data is not contiguous; cannot memmap: {path}")
        dtype = series.dtype
    return np.memmap(path, dtype=dtype, mode=mode, offset=offset, shape=series.shape)


# --------------------------------------------------------------------------
# Writer
# --------------------------------------------------------------------------

_DESC_MIN_CAPACITY = 32768


def _sample_format(dtype: np.dtype) -> int:
    return _DTYPE_SAMPLEFORMAT.get(dtype.kind, 1)


def imwrite(
    path,
    data: Optional[np.ndarray] = None,
    *,
    shape: Optional[Tuple[int, ...]] = None,
    dtype=None,
    bigtiff: bool = True,
    metadata: Optional[dict] = None,
    photometric: str = "minisblack",
    description: Optional[str] = None,
    dim_res: Optional[dict] = None,
):
    """Write a BigTIFF with contiguous pixel data (memmap-able).

    Either ``data`` or ``shape``+``dtype`` must be given; the latter
    creates an empty (sparse, all-zero) file for incremental memmap writes,
    mirroring the reference's ``ImInfo.allocate_memory``
    (``verifier.py:992-1070``).

    ``metadata={'axes': 'TZYX'}`` embeds OME-XML built from the axes.
    """
    del photometric  # only minisblack is produced
    if not bigtiff:
        raise NotImplementedError(
            "only BigTIFF output is supported (bigtiff=True)")
    path = os.fspath(path)
    if data is not None:
        data = np.asarray(data)
        shape = data.shape
        dtype = data.dtype
    if shape is None or dtype is None:
        raise ValueError("imwrite requires data or shape+dtype")
    dtype = np.dtype(dtype)
    if dtype.byteorder == ">":
        dtype = dtype.newbyteorder("<")
        if data is not None:
            data = data.astype(dtype)

    shape = tuple(int(s) for s in shape)
    if len(shape) < 2:
        raise ValueError("Image must be at least 2D")
    if any(s <= 0 for s in shape):
        # a zero-page file would get a header pointing at no IFD —
        # corrupt on read; fail fast instead
        raise ValueError(f"Image shape {shape} has a zero/negative extent")
    height, width = shape[-2], shape[-1]
    npages = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    page_bytes = height * width * dtype.itemsize

    axes = None
    if metadata:
        axes = metadata.get("axes")
    if description is None:
        from nellie_tpu_torch.io import ome as ome_mod

        if axes is None:
            axes = _default_axes(shape)
        description = ome_mod.build_ome_xml(axes, shape, dtype.name, dim_res=dim_res)

    desc_bytes = description.encode("utf-8") + b"\x00"
    # the ImageDescription tag always stores an offset; BigTIFF readers
    # treat counts <= 8 as inline values, so keep the payload > 8 bytes
    if len(desc_bytes) <= 8:
        desc_bytes = desc_bytes.ljust(9, b"\x00")
    desc_cap = max(_DESC_MIN_CAPACITY, 2 * len(desc_bytes))

    # ---- layout: header | description area | IFDs | pixel data ----
    header_size = 16  # BigTIFF header
    desc_offset = header_size
    ifds_offset = desc_offset + desc_cap

    n_entries_first = 11
    n_entries_rest = 10
    ifd_size_first = 8 + n_entries_first * 20 + 8
    ifd_size_rest = 8 + n_entries_rest * 20 + 8
    ifds_total = ifd_size_first + (npages - 1) * ifd_size_rest
    data_offset = _align(ifds_offset + ifds_total, 16)

    def ifd_pos(i: int) -> int:
        return ifds_offset if i == 0 else ifds_offset + ifd_size_first + (i - 1) * ifd_size_rest

    def strip_pos(i: int) -> int:
        return data_offset + i * page_bytes

    sample_fmt = _sample_format(dtype)
    bits = dtype.itemsize * 8

    buf = bytearray()
    # BigTIFF header
    buf += b"II" + struct.pack("<HHHQ", 43, 8, 0, ifd_pos(0))
    # description area
    buf += desc_bytes.ljust(desc_cap, b"\x00")
    # IFDs
    for i in range(npages):
        entries = [
            (256, 4, 1, width),
            (257, 4, 1, height),
            (258, 3, 1, bits),
            (259, 3, 1, 1),
            (262, 3, 1, 1),
        ]
        if i == 0:
            entries.append((270, 2, len(desc_bytes), desc_offset))
        entries += [
            (273, 16, 1, strip_pos(i)),
            (277, 3, 1, 1),
            (278, 4, 1, height),
            (279, 16, 1, page_bytes),
            (339, 3, 1, sample_fmt),
        ]
        next_ifd = ifd_pos(i + 1) if i + 1 < npages else 0
        buf += struct.pack("<Q", len(entries))
        for code, ttype, count, value in entries:
            # every entry's value slot holds either the inline value or
            # an offset (code 270's description is always out-of-line)
            buf += struct.pack("<HHQQ", code, ttype, count, value)
        buf += struct.pack("<Q", next_ifd)
    # pad to data_offset
    buf += b"\x00" * (data_offset - len(buf))

    with open(path, "wb") as fh:
        fh.write(buf)
        if data is not None:
            fh.write(np.ascontiguousarray(data).tobytes())
        else:
            fh.truncate(data_offset + npages * page_bytes)
    return path


def _default_axes(shape) -> str:
    known = ["Q", "T", "Z"]
    extra = len(shape) - 2
    if extra == 0:
        return "YX"
    if extra == 1:
        return "QYX"
    # >3 leading dims: pad with Q so the string always covers ndim
    # (a short string would mis-pair Y/X in build_ome_xml's zip)
    lead = "".join(known[:extra])
    return "Q" * (extra - len(lead)) + lead + "YX"


def _align(value: int, alignment: int) -> int:
    return (value + alignment - 1) // alignment * alignment


# --------------------------------------------------------------------------
# tiffcomment: read/replace the first page's ImageDescription
# --------------------------------------------------------------------------

def tiffcomment(path, comment: Optional[str] = None) -> Optional[str]:
    path = os.fspath(path)
    with TiffFile(path) as tif:
        page = tif.pages[0]
        tag = page.tags.get(270)
        byteorder = tif.byteorder
        bigtiff = tif.bigtiff
        first_ifd = tif.first_ifd
        if comment is None:
            return page.description
        if tag is None:
            raise ValueError("TIFF has no ImageDescription tag to replace")
        entry_offset = tag.entry_offset
        value_offset = tag.value_offset
        old_count = tag.count

    data = comment.encode("utf-8") + b"\x00"
    filesize = os.path.getsize(path)

    with open(path, "r+b") as fh:
        inline = 8 if bigtiff else 4
        if value_offset != 0 and len(data) <= inline:
            # an out-of-line value whose count drops to <= the inline
            # threshold would be re-read as inline data (the stale offset
            # bytes in the entry slot) — pad past the threshold
            data = data.ljust(inline + 1, b"\x00")
        if value_offset == 0 and len(data) > inline:
            # previously inline; must relocate
            capacity = 0
        elif value_offset == 0:
            capacity = inline
        elif value_offset < first_ifd:
            # our writer's header|desc|IFD layout: the IFD bounds the
            # reserved description region
            capacity = first_ifd - value_offset
        else:
            # foreign layout (description after the IFD): only the old
            # value region is provably free — in-place only if it fits
            capacity = old_count

        if len(data) <= capacity:
            write_offset = value_offset
            if value_offset == 0:
                # inline write into the entry's value slot
                write_offset = entry_offset + (12 if bigtiff else 8)
            fh.seek(write_offset)
            fh.write(data)
        else:
            # append to EOF (word-aligned) and point the tag there
            write_offset = _align(filesize, 2)
            fh.seek(write_offset)
            fh.write(data)
            fh.seek(entry_offset + (12 if bigtiff else 8))
            fh.write(struct.pack(byteorder + ("Q" if bigtiff else "I"), write_offset))
        # update count
        fh.seek(entry_offset + 4)
        fh.write(struct.pack(byteorder + ("Q" if bigtiff else "I"), len(data)))
        # zero-pad remainder of old region so stale text doesn't linger
        if len(data) < old_count and write_offset == value_offset and value_offset != 0:
            fh.seek(write_offset + len(data))
            fh.write(b"\x00" * (old_count - len(data)))
    return None
