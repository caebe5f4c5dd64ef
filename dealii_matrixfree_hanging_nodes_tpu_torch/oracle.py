"""Sparse-assembly correctness oracle (scipy), copied from
``dealii_matrixfree_hanging_nodes_tpu.oracle``: the Laplace operator assembled
as an explicit sparse matrix with the same quadrature as the matrix-free
path, plus the constraint expansion, vmult = C^T A C."""

from __future__ import annotations

import numpy as np

from .constraints import build_constraints
from .dof_handler import DoFHandler
from .elements import shape_info
from .mesh import Triangulation

__all__ = ["local_laplace_matrices", "assemble_laplace", "vmult_oracle"]


def local_laplace_matrices(tria: Triangulation, degree: int) -> np.ndarray:
    """Dense per-cell element stiffness matrices [n_cells, n_loc, n_loc]."""
    si = shape_info(degree)
    dim = tria.dim
    w = si.quad_w
    M1 = np.einsum("q,qi,qj->ij", w, si.S, si.S)  # 1D mass
    K1 = np.einsum("q,qi,qj->ij", w, si.D, si.D)  # 1D stiffness
    # x-fastest flattening => kron from slowest axis (z) outward, x innermost
    out = []
    for d in range(dim):
        facs = [K1 if t == d else M1 for t in range(dim)]
        A = facs[dim - 1]
        for t in range(dim - 2, -1, -1):
            A = np.kron(A, facs[t])
        out.append(A)
    h = tria.cell_size()
    detj = h**dim
    fac = detj / h**2  # per-axis Cartesian factor (equal axes)
    n_loc = (degree + 1) ** dim
    loc = np.zeros((tria.n_active_cells, n_loc, n_loc))
    for d in range(dim):
        loc += fac[:, None, None] * out[d][None, :, :]
    return loc


def assemble_laplace(tria: Triangulation, degree: int):
    """Returns (A, C, dof_handler, constraints): scipy CSR global stiffness
    (no constraints) and the expansion matrix C; vmult oracle = C^T A C."""
    import scipy.sparse as sp

    dh = DoFHandler(tria, degree)
    ci = build_constraints(dh)
    loc = local_laplace_matrices(tria, degree)
    cd = dh.cell_dofs
    n_loc = cd.shape[1]
    rows = np.repeat(cd, n_loc, axis=1).ravel()
    cols = np.tile(cd, (1, n_loc)).ravel()
    A = sp.csr_matrix(
        (loc.ravel(), (rows, cols)), shape=(dh.n_dofs, dh.n_dofs)
    )
    C = ci.expansion_matrix()
    return A, C, dh, ci


def vmult_oracle(tria: Triangulation, degree: int, src: np.ndarray) -> np.ndarray:
    A, C, _, _ = assemble_laplace(tria, degree)
    return C.T @ (A @ (C @ src))
