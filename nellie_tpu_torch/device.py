"""Device resolution for the PyTorch port.

Every public entry point takes an explicit ``device`` and resolves it
here.  There is no hidden global device and no fallback: ``"cuda"`` on a
machine without a GPU raises, and the CPU is used only when asked for.

float32 matrix products and convolutions run in full float32: the JAX
reference asks for ``Precision.HIGHEST`` (``nellie_tpu/kernels/
pallas_nn.py:46-47``), so TF32 is switched off and checked every time a
device is resolved.
"""
from __future__ import annotations

import torch


def _full_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 could not be disabled")


def resolve_device(device) -> torch.device:
    """``"cuda"``, ``"cuda:N"``, ``"cpu"`` or a ``torch.device`` -> device.

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable and
    ``ValueError`` for any other device type.
    """
    dev = torch.device(device)
    _full_float32()
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' explicitly to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev
