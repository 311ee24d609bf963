"""Host layers shared with the JAX package.

File metadata (``FileInfo``), the artifact store (``ImInfo``) and the
OME-TIFF codec (``ome``, ``tiff``) of ``nellie_tpu.io`` import only numpy
and the standard library, so the port reuses them as they are: its
artifacts get the reference's names, dtypes and OME metadata by
construction.
"""
from nellie_tpu.io import ome, tiff  # noqa: F401
from nellie_tpu.io.verifier import FileInfo, ImInfo  # noqa: F401
