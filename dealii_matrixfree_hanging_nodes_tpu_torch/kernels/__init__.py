"""The port's device kernels, one module each: a wrapper that launches the
hand-written CUDA kernel (``csrc/<name>.cu``) on CUDA tensors and takes the
plain PyTorch version in the same module on CPU tensors, with a launch count
on the wrapper (``<wrapper>.launches``)."""

from . import brick_apply, cell_apply, cols_overlap_add, dss_surface  # noqa: F401

KERNEL_MODULES = (brick_apply, cell_apply, cols_overlap_add, dss_surface)
