"""nellie_tpu_torch — the PyTorch/CUDA port of ``nellie_tpu`` for NVIDIA Hopper.

The JAX package ``nellie_tpu`` stays the reference; this package mirrors
its layout (``kernels/``, ``stages/``, ``pipeline/run.py``) with the same
function names, dataclass fields, artifact names and dtypes, so each
counterpart is easy to find.  It imports ``torch`` and never ``jax``.

Host layers are reused as they are, because they import only numpy and
the standard library: ``nellie_tpu.io`` (file metadata, OME-TIFF codec,
artifact store; re-exported as :mod:`nellie_tpu_torch.io`),
``nellie_tpu.utils.base_logger``, ``nellie_tpu.kernels.simple_point``
(the thinning LUT) and ``nellie_tpu.plugin.config``.

Ported so far: Filter -> Label -> Network -> Markers -> HuMomentTracking
-> VoxelReassigner, whole-frame and single-device.  The nearest-neighbour
argmin that the JAX package runs as a Pallas TPU kernel is a CUDA kernel
here (``kernels/csrc/nn_argmin.cu``); everything else is plain torch.
"""

__version__ = "0.1.0"

from nellie_tpu_torch.device import resolve_device  # noqa: F401
