"""Minimal OME-XML data model (2016-06 schema subset).

The reference uses the ``ome_types`` package to read/write OME metadata
(the original Nellie's ``nellie/im_info/verifier.py:232-244,668-695``).  That
package is not available here, and we only need a small subset of the
schema: per-image pixel sizes, time increment, pixel type, dimension order
and a free-form description.  This module implements exactly that subset
with the same attribute spelling the reference code relies on
(``ome.images[0].pixels.physical_size_x`` etc.) so stage code reads
naturally to users of the reference.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import List, Optional

OME_NS = "http://www.openmicroscopy.org/Schemas/OME/2016-06"

# OME pixel type names <-> numpy dtype names
_OME_TO_NUMPY = {
    "int8": "int8",
    "int16": "int16",
    "int32": "int32",
    "uint8": "uint8",
    "uint16": "uint16",
    "uint32": "uint32",
    "float": "float32",
    "double": "float64",
    "complex": "complex64",
    "double-complex": "complex128",
    "bit": "bool",
}
_NUMPY_TO_OME = {v: k for k, v in _OME_TO_NUMPY.items()}


def ome_pixel_type(dtype_name: str) -> str:
    """numpy dtype name -> OME pixel type string."""
    if dtype_name in _OME_TO_NUMPY:  # already an OME name
        return dtype_name
    try:
        return _NUMPY_TO_OME[dtype_name]
    except KeyError as exc:
        raise ValueError(f"No OME pixel type for dtype '{dtype_name}'") from exc


def numpy_dtype_name(ome_type: str) -> str:
    """OME pixel type string -> numpy dtype name."""
    try:
        return _OME_TO_NUMPY[ome_type]
    except KeyError as exc:
        raise ValueError(f"Unknown OME pixel type '{ome_type}'") from exc


@dataclass
class Pixels:
    dimension_order: str = "XYCZT"
    type: str = "uint16"
    size_x: int = 1
    size_y: int = 1
    size_z: int = 1
    size_c: int = 1
    size_t: int = 1
    physical_size_x: Optional[float] = None
    physical_size_y: Optional[float] = None
    physical_size_z: Optional[float] = None
    physical_size_x_unit: str = "µm"
    physical_size_y_unit: str = "µm"
    physical_size_z_unit: str = "µm"
    time_increment: Optional[float] = None
    time_increment_unit: str = "s"


@dataclass
class Image:
    id: str = "Image:0"
    name: str = "Image0"
    description: Optional[str] = None
    pixels: Pixels = field(default_factory=Pixels)


@dataclass
class OME:
    images: List[Image] = field(default_factory=list)
    creator: str = "nellie_tpu"

    # -- serialisation -----------------------------------------------------
    def to_xml(self) -> str:
        ET.register_namespace("", OME_NS)
        root = ET.Element(f"{{{OME_NS}}}OME", attrib={"Creator": self.creator})
        for image in self.images:
            im_el = ET.SubElement(root, f"{{{OME_NS}}}Image", attrib={"ID": image.id, "Name": image.name})
            if image.description is not None:
                desc_el = ET.SubElement(im_el, f"{{{OME_NS}}}Description")
                desc_el.text = image.description
            px = image.pixels
            attrib = {
                "ID": "Pixels:0",
                "DimensionOrder": px.dimension_order,
                "Type": px.type,
                "SizeX": str(px.size_x),
                "SizeY": str(px.size_y),
                "SizeZ": str(px.size_z),
                "SizeC": str(px.size_c),
                "SizeT": str(px.size_t),
            }
            if px.physical_size_x is not None:
                attrib["PhysicalSizeX"] = repr(float(px.physical_size_x))
                attrib["PhysicalSizeXUnit"] = px.physical_size_x_unit
            if px.physical_size_y is not None:
                attrib["PhysicalSizeY"] = repr(float(px.physical_size_y))
                attrib["PhysicalSizeYUnit"] = px.physical_size_y_unit
            if px.physical_size_z is not None:
                attrib["PhysicalSizeZ"] = repr(float(px.physical_size_z))
                attrib["PhysicalSizeZUnit"] = px.physical_size_z_unit
            if px.time_increment is not None:
                attrib["TimeIncrement"] = repr(float(px.time_increment))
                attrib["TimeIncrementUnit"] = px.time_increment_unit
            px_el = ET.SubElement(im_el, f"{{{OME_NS}}}Pixels", attrib=attrib)
            ET.SubElement(px_el, f"{{{OME_NS}}}Channel", attrib={"ID": "Channel:0:0", "SamplesPerPixel": "1"})
            td = ET.SubElement(px_el, f"{{{OME_NS}}}TiffData", attrib={"IFD": "0"})
            td.set("PlaneCount", str(px.size_t * px.size_z * px.size_c))
        xml = ET.tostring(root, encoding="unicode")
        return '<?xml version="1.0" encoding="UTF-8"?>' + xml


def _float_or_none(value: Optional[str]) -> Optional[float]:
    return None if value is None else float(value)


def from_xml(xml: str) -> OME:
    """Parse an OME-XML string into the minimal model.

    Tolerant of unknown elements/attributes; only the subset in ``Pixels``
    and ``Image`` is extracted.
    """
    root = ET.fromstring(xml)
    # namespace-agnostic tag matching (handles any OME schema year)
    def local(tag: str) -> str:
        return tag.rsplit("}", 1)[-1]

    ome = OME()
    for im_el in root:
        if local(im_el.tag) != "Image":
            continue
        image = Image(id=im_el.get("ID", "Image:0"), name=im_el.get("Name", "Image0"))
        for child in im_el:
            tag = local(child.tag)
            if tag == "Description":
                image.description = child.text
            elif tag == "Pixels":
                px = Pixels(
                    dimension_order=child.get("DimensionOrder", "XYCZT"),
                    type=child.get("Type", "uint16"),
                    size_x=int(child.get("SizeX", "1")),
                    size_y=int(child.get("SizeY", "1")),
                    size_z=int(child.get("SizeZ", "1")),
                    size_c=int(child.get("SizeC", "1")),
                    size_t=int(child.get("SizeT", "1")),
                    physical_size_x=_float_or_none(child.get("PhysicalSizeX")),
                    physical_size_y=_float_or_none(child.get("PhysicalSizeY")),
                    physical_size_z=_float_or_none(child.get("PhysicalSizeZ")),
                    time_increment=_float_or_none(child.get("TimeIncrement")),
                )
                px.physical_size_x_unit = child.get("PhysicalSizeXUnit", "µm")
                px.physical_size_y_unit = child.get("PhysicalSizeYUnit", "µm")
                px.physical_size_z_unit = child.get("PhysicalSizeZUnit", "µm")
                px.time_increment_unit = child.get("TimeIncrementUnit", "s")
                image.pixels = px
        ome.images.append(image)
    return ome


def build_ome_xml(shape_axes: str, shape, dtype_name: str, dim_res=None, description=None) -> str:
    """Construct OME-XML for an array with the given axes string (e.g. 'TZYX')."""
    sizes = {"T": 1, "Z": 1, "C": 1, "Y": 1, "X": 1}
    for ax, n in zip(shape_axes, shape):
        sizes[ax] = int(n)
    px = Pixels(
        dimension_order="XYCZT",
        type=ome_pixel_type(dtype_name),
        size_x=sizes["X"],
        size_y=sizes["Y"],
        size_z=sizes["Z"],
        size_c=sizes["C"],
        size_t=sizes["T"],
    )
    if dim_res:
        px.physical_size_x = dim_res.get("X")
        px.physical_size_y = dim_res.get("Y")
        px.physical_size_z = dim_res.get("Z")
        px.time_increment = dim_res.get("T")
    image = Image(description=description, pixels=px)
    return OME(images=[image]).to_xml()
