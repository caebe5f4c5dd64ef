"""Matrix-free Laplace operator of the index engine, the port of
``dealii_matrixfree_hanging_nodes_tpu.models.laplace`` (benchmark_03.h:
210-358 analog).

``laplace_cell_kernel(mf)`` is the per-cell quadrature kernel (u_loc, a) ->
v_loc: evaluate(gradients) -> submit_gradient(geo * get_gradient) ->
integrate(gradients), sum-factorized, with the Cartesian factors or the
deformed metric, in 3-D and 2-D. Its ``fused`` method, which
``MatrixFree.cell_loop`` calls, runs the whole loop in the kernels
(``cell_laplace``, then ``dof_scatter``); called on cell rows it runs
``cell_laplace`` on them (the DG path). The reference's TPU knob
``matmul_precision`` is not ported: the port computes in exact float32 or
float64.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import cell_laplace
from ..matrix_free import MatrixFree, TORCH_DTYPES, resolve_device

__all__ = ["LaplaceCellKernel", "LaplaceOperator", "laplace_cell_kernel"]


class LaplaceCellKernel:
    """The Laplace cell kernel of one MatrixFree (Cartesian or deformed, as
    its geometry tables say)."""

    def __init__(self, mf: MatrixFree):
        self.mf = mf

    def __call__(self, u: torch.Tensor, a) -> torch.Tensor:
        """Rows u [n_cells, n_loc] -> their Laplace rows (a new tensor); a:
        the device tables (``mf.device_tables``)."""
        return cell_laplace.cell_laplace(u, None, None, a["P"], a["S"], a["Dc"], a["quad_w"],
                                         a["geo"], hn_in=False, quad=True, hn_out=False,
                                         factors=self.mf.kernel_factors)

    def fused(self, mf: MatrixFree, src: torch.Tensor, *, constraints: bool, slow: bool,
              plain: bool) -> torch.Tensor:
        """``mf.cell_loop`` of this kernel: cell_laplace (gather, HN,
        quadrature, HN^T in one launch), then dof_scatter; the slow path adds
        constraints_slow before and after. plain=True runs the plain
        versions."""
        if mf is not self.mf:
            raise ValueError("the Laplace cell kernel belongs to another MatrixFree")
        dev, dt = mf.check_input(src)
        x = mf.distribute_slow(src, plain) if constraints and slow else src
        fn = cell_laplace.cell_laplace_plain if plain else cell_laplace.cell_laplace
        rows = fn(x, *mf.cell_laplace_args(dev, dt, slow, constraints), factors=mf.kernel_factors)
        dst = mf.distribute_local_to_global_plain(rows, slow=slow, plain=plain)
        return mf.compress_slow(dst, plain) if constraints and slow else dst


def laplace_cell_kernel(mf: MatrixFree) -> LaplaceCellKernel:
    return LaplaceCellKernel(mf)


class LaplaceOperator(nn.Module):
    """vmult = cell_loop(laplace kernel), on the fast or the slow (legacy
    AffineConstraints) constraint path, or without constraints. Runs on
    ``device``: the card unless the caller asks for the CPU (no card and no
    ``device="cpu"`` raises). ``vmult(src, plain=True)`` runs every
    kernel's plain PyTorch version on the operator's device."""

    def __init__(self, mf: MatrixFree, constraints: bool = True, slow: bool = False,
                 device=None):
        super().__init__()
        self.mf = mf
        self.constraints = bool(constraints)
        self.slow = bool(slow)
        self.device = resolve_device(device)
        self.dtype = TORCH_DTYPES[mf.dtype]
        self.kernel = laplace_cell_kernel(mf)

    def vmult(self, src, plain: bool = False) -> torch.Tensor:
        """A global vector (a tensor on the operator's device, or NumPy,
        moved there in the operator's type) -> a new global vector."""
        if not isinstance(src, torch.Tensor):
            src = torch.as_tensor(src).to(self.device, self.dtype)
        if src.device != self.device or src.shape != (self.mf.n_dofs,):
            raise ValueError(f"expected a [{self.mf.n_dofs}] vector on {self.device}, got "
                             f"{tuple(src.shape)} on {src.device}")
        return self.mf.cell_loop(self.kernel, src, constraints=self.constraints, slow=self.slow,
                                 plain=plain)

    def forward(self, src, plain: bool = False) -> torch.Tensor:
        return self.vmult(src, plain)
