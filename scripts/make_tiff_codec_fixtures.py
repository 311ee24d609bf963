"""Write the TIFF codec fixtures that ``chip_smoke.py`` (phase 14) decodes.

    python scripts/make_tiff_codec_fixtures.py

Small TIFF files of 16-row strips, written by PIL's TIFF encoder from
seeded numpy arrays:
LZW (small values, and incompressible bytes that force table resets and
12-bit codes), PackBits, and LZW with the horizontal predictor in uint8
and uint16.  ``manifest.json`` lists each file's compression, predictor,
shape, dtype and the SHA-256 of its pixels, so that a machine without
PIL can check what it decodes.  Needs PIL; the files are committed.
"""
import hashlib
import json
import os

import numpy as np
from PIL import Image, TiffImagePlugin

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "fixtures", "tiff_codec")


def cases():
    rng = np.random.default_rng(0)
    yield "lzw_small", rng.integers(0, 16, (64, 80), dtype=np.uint8), "tiff_lzw", False
    yield "lzw_incompressible", rng.integers(0, 256, (128, 300), dtype=np.uint8), "tiff_lzw", False
    runs = np.repeat(rng.integers(0, 4, (48, 12), dtype=np.uint8), 8, axis=1)
    yield "packbits", runs, "packbits", False
    ramp = np.cumsum(rng.integers(0, 40, (96, 70)), axis=1)
    yield "lzw_predictor_u8", (ramp % 250).astype(np.uint8), "tiff_lzw", True
    yield "lzw_predictor_u16", (ramp * 37 % 60000).astype(np.uint16), "tiff_lzw", True


def main():
    os.makedirs(OUT, exist_ok=True)
    manifest = {}
    for name, data, compression, predictor in cases():
        info = TiffImagePlugin.ImageFileDirectory_v2()
        info[278] = 16  # rows per strip: several strips a file
        if predictor:
            info[317] = 2
        path = os.path.join(OUT, f"{name}.tif")
        Image.fromarray(data).save(path, format="TIFF", compression=compression, tiffinfo=info)
        manifest[f"{name}.tif"] = {
            "compression": compression, "predictor": predictor, "shape": list(data.shape),
            "dtype": data.dtype.str, "sha256": hashlib.sha256(data.tobytes()).hexdigest()}
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
