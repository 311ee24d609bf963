"""Host IO of the port: file metadata (``FileInfo``), the artifact store
(``ImInfo``) and the OME-TIFF codec (``ome``, ``tiff``).

Copies of ``nellie_tpu/io``'s modules, in numpy and the standard library,
so that the port's artifacts keep the JAX package's names, dtypes, paths
and OME metadata.
"""
from nellie_tpu_torch.io import ome, tiff  # noqa: F401
from nellie_tpu_torch.io.verifier import FileInfo, ImInfo  # noqa: F401
