"""nellie_tpu_torch — the PyTorch/CUDA port of ``nellie_tpu`` for NVIDIA Hopper.

The JAX package ``nellie_tpu`` stays the reference; this package mirrors
its layout (``kernels/``, ``stages/``, ``pipeline/run.py``) with the same
function names, dataclass fields, artifact names and dtypes, so each
counterpart is easy to find.  It imports ``torch`` and never ``jax``.

It imports nothing of ``nellie_tpu`` either: the host layers it shares
with the JAX package are copies of their own, in numpy and the standard
library, and behave as the originals do: :mod:`nellie_tpu_torch.io`
(file metadata, OME-TIFF codec, artifact store),
:mod:`nellie_tpu_torch.config` (the Settings tree and each stage's
kwargs), :mod:`nellie_tpu_torch.kernels.simple_point` (the thinning
table, shipped compressed), :mod:`nellie_tpu_torch.utils.logger`, and
the region morphology of the feature tables,
:mod:`nellie_tpu_torch.utils.regionprops` with
:mod:`nellie_tpu_torch.utils.convexhull` (numpy, and scipy's Qhull when
present).

Ported so far: all seven stages, Filter -> Label -> Network -> Markers ->
HuMomentTracking -> VoxelReassigner -> Hierarchy, whole-frame and
single-device.  The nearest-neighbour argmin that the JAX package runs as
a Pallas TPU kernel is a CUDA kernel here (``kernels/csrc/nn_argmin.cu``),
called by the reassigner and by the Hierarchy's border distance;
everything else is plain torch.  The port imports neither pandas nor
pyarrow: the feature CSVs are written with numpy and the standard library.
"""

__version__ = "0.1.0"

from nellie_tpu_torch.device import resolve_device  # noqa: F401
