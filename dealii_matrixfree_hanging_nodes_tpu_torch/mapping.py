"""Cartesian geometry factors (capability C11), copied from
``dealii_matrixfree_hanging_nodes_tpu.mapping``. The reference geometries are
axis-aligned refinements of a hyper_cube, so the MappingQ1 analog reduces to
per-cell Cartesian factors. The deformed (MappingQCache) mapping is not part
of this port yet.
"""

from __future__ import annotations

import numpy as np

from .mesh import Triangulation

__all__ = ["cartesian_laplace_factors"]


def cartesian_laplace_factors(tria: Triangulation) -> np.ndarray:
    """Per-cell per-axis Laplace geometry factor detJ / h_d^2, [n_cells, dim].

    With x = lower + h * x_ref on [0,1]^dim:
    ∫ ∇u·∇v = Σ_q w_q detJ Σ_d (1/h_d²) ∂̂_d u ∂̂_d v.
    """
    h = tria.cell_size()
    detj = h**tria.dim
    return np.repeat((detj / h**2)[:, None], tria.dim, axis=1)
