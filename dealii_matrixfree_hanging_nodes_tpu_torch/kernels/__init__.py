"""The port's device kernels, one module each: a wrapper that launches the
hand-written CUDA kernel (``csrc/<name>.cu``) on CUDA tensors and takes the
plain PyTorch version in the same module on CPU tensors, with a launch count
on the wrapper (``<wrapper>.launches``)."""

from . import (  # noqa: F401
    brick_apply,
    cell_apply,
    corr_compact,
    dss_surface,
    hn_cell,
    masked_quad,
    plane_fill,
    plane_fold,
    refill_update,
)

KERNEL_MODULES = (brick_apply, cell_apply, dss_surface, hn_cell, corr_compact, refill_update,
                  masked_quad, plane_fill, plane_fold)
