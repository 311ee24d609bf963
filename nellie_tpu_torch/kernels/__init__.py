"""Image-processing primitives of the port, as functions on torch tensors.

Each module mirrors the JAX module of the same name in
``nellie_tpu/kernels``.  Arithmetic follows the reference operation by
operation in float32; where XLA on the CPU contracts a multiply and an add
into one fused multiply-add, :mod:`nellie_tpu_torch.kernels._fp` does the
same, so that thresholds, peaks and ties land where the reference puts
them.
"""
