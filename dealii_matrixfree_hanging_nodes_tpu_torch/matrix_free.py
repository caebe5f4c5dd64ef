"""Host part of ``dealii_matrixfree_hanging_nodes_tpu.matrix_free.MatrixFree``
(capabilities C4, C6): from (Triangulation, degree) it builds the DoF
handler, the hanging-node constraints and the NumPy tables (``_np``) that the
brick operator's setup reads. It holds no device tensors; the index engine's
tables and execution side (dofmaps, cell_loop and its runners) are not part
of this port yet.
"""

from __future__ import annotations

import numpy as np

from .constraints import build_constraints
from .dof_handler import DoFHandler
from .elements import shape_info
from .mapping import cartesian_laplace_factors
from .mesh import Triangulation

__all__ = ["MatrixFree"]


class MatrixFree:
    """high_order_mapping marks the reference's deformed (MappingQCache)
    mapping, which the port records and its brick operator refuses: its
    geometry tables are Cartesian."""

    def __init__(self, tria: Triangulation, degree: int, dtype=np.float64,
                 high_order_mapping: bool = False):
        self.tria = tria
        self.degree = degree
        self.dim = tria.dim
        self.dtype = np.dtype(dtype)
        self.high_order_mapping = bool(high_order_mapping)
        self.shape = shape_info(degree)
        self.dof_handler = DoFHandler(tria, degree)
        self.constraints = build_constraints(self.dof_handler)
        self.n_dofs = self.dof_handler.n_dofs
        self.n_cells = tria.n_active_cells

        # the compressed constraint masks (read by the brick setup) and the
        # per-cell Cartesian geometry factors detJ / h^2
        self._np = dict(
            masks=self.constraints.masks.astype(np.int32),
            geo=cartesian_laplace_factors(tria).astype(self.dtype),
        )
