"""The port's device kernels, one module each: a wrapper that launches the
hand-written CUDA kernel (``csrc/<name>.cu``) on CUDA tensors and takes the
plain PyTorch version in the same module on CPU tensors, with a launch count
on the wrapper (``<wrapper>.launches``)."""

from . import (  # noqa: F401
    brick_apply,
    brick_deformed,
    brick_elasticity,
    brick_transfer,
    cell_apply,
    cell_elasticity,
    cell_laplace,
    cell_transfer,
    chain_halo,
    constraints_slow,
    corr_compact,
    dof_embed,
    dof_scatter,
    dss_pools,
    dss_surface,
    halo_pack,
    hn_cell,
    hn_interp,
    masked_quad,
    plane_fill,
    plane_fold,
    refill_update,
)

KERNEL_MODULES = (brick_apply, cell_apply, dss_surface, hn_cell, corr_compact, refill_update,
                  masked_quad, plane_fill, plane_fold, hn_interp, cell_laplace, dof_scatter,
                  constraints_slow, brick_transfer, dof_embed, cell_transfer, cell_elasticity,
                  brick_elasticity, brick_deformed, halo_pack, dss_pools, chain_halo)
