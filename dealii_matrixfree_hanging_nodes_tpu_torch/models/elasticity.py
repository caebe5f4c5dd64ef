"""Vector-valued linear elasticity on the index engine, the port of
``dealii_matrixfree_hanging_nodes_tpu.models.elasticity``:

    a(u, v) = int 2 mu eps(u):eps(v) + lam (div u)(div v)

on the AMR mesh with the hanging-node constraints applied per component,
in 3-D and 2-D. The displacement is a global vector [n_dofs, dim], one
component a column, as in the reference. A vmult is two launches:
``cell_elasticity`` (the dim components read through the DoF map, each
interpolated by the cell's mask, the coupled operator, the transposed
interpolation; component-major cell rows [dim, n_cells, n_loc]) and
``dof_scatter`` on its component axis (the rows summed into [n_dofs,
dim]). Without constraints the same fast DoF map with no interpolation (the
reference's ``read_dof_values_plain``), also two. The reference's
Cartesian-only and cube-only refusals are kept."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..kernels import cell_elasticity, dof_scatter
from ..matrix_free import MatrixFree, TORCH_DTYPES, resolve_device

__all__ = ["ElasticityOperator", "check_elastic_mesh"]


def check_elastic_mesh(mf: MatrixFree, what: str) -> None:
    """The reference's refusals (models/elasticity.py:24-37)."""
    if mf.high_order_mapping:
        raise NotImplementedError(f"{what} currently uses the Cartesian mapping")
    geo = np.asarray(mf._np["geo"])
    if not np.allclose(geo, geo[:, :1]):
        # the mixed strain terms fold the per-axis factors as sqrt(geo_a geo_c) == geo,
        # valid only when all axes share one factor (cube cells)
        raise NotImplementedError(f"{what} requires equal-axis (cube) cells; anisotropic "
                                  f"mappings need per-pair geometric factors")


class ElasticityOperator(nn.Module):
    """vmult of the elasticity operator on the index engine, with the
    hanging-node constraints (constraints=True) or without. Runs on
    ``device``: the card unless the caller asks for the CPU.
    ``vmult(src, plain=True)`` runs the kernels' plain PyTorch versions on
    the operator's device."""

    def __init__(self, mf: MatrixFree, mu: float = 1.0, lam: float = 1.0,
                 constraints: bool = True, device=None):
        super().__init__()
        check_elastic_mesh(mf, "ElasticityOperator")
        self.mf = mf
        self.mu = float(mu)
        self.lam = float(lam)
        self.constraints = bool(constraints)
        self.device = resolve_device(device)
        self.dtype = TORCH_DTYPES[mf.dtype]
        self.kernel_factors = mf.kernel_factors  # cell_elasticity's launch parameters

    def vmult(self, src, plain: bool = False) -> torch.Tensor:
        """src [n_dofs, dim] (a tensor on the operator's device, or NumPy,
        moved there in the operator's type) -> a new [n_dofs, dim]."""
        mf = self.mf
        if not isinstance(src, torch.Tensor):
            src = torch.as_tensor(np.asarray(src)).to(self.device, self.dtype)
        if src.device != self.device or src.shape != (mf.n_dofs, mf.dim):
            raise ValueError(f"expected a [{mf.n_dofs}, {mf.dim}] displacement on {self.device}, "
                             f"got {tuple(src.shape)} on {src.device}")
        dev, dt = mf.check_input(src)
        src = src.contiguous()
        dofmap, codes, P, S, Dc, quad_w, geo = mf.cell_laplace_args(dev, dt,
                                                                    hn=self.constraints)
        args = (src, dofmap, codes, P, S, Dc, quad_w, geo, self.mu, self.lam)
        if plain:
            rows = cell_elasticity.cell_elasticity_plain(*args)
        else:
            rows = cell_elasticity.cell_elasticity(*args, factors=self.kernel_factors)
        scatter = dof_scatter.dof_scatter_plain if plain else dof_scatter.dof_scatter
        return scatter(rows, *mf.scatter_tables(False, dev))

    def forward(self, src, plain: bool = False) -> torch.Tensor:
        return self.vmult(src, plain)
