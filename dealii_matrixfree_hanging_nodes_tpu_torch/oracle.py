"""Sparse-assembly correctness oracle (scipy), copied from
``dealii_matrixfree_hanging_nodes_tpu.oracle``: the Laplace operator assembled
as an explicit sparse matrix with the same quadrature as the matrix-free
path, plus the constraint expansion, vmult = C^T A C. ``elasticity_oracle``
does the same for linear elasticity (the dense C^T A C assembly of the
reference's elasticity tests), components fastest."""

from __future__ import annotations

import numpy as np

from .constraints import build_constraints
from .dof_handler import DoFHandler, local_lattice
from .elements import shape_info
from .mesh import Triangulation

__all__ = ["local_laplace_matrices", "assemble_laplace", "vmult_oracle", "elasticity_oracle"]


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


def _reference_gradients(degree: int, dim: int):
    """(G [dim, n_q, n_loc], w [n_q]): dN_i/dref_d at the Gauss points of the
    unit cell, lattice order (x fastest), and the tensor quadrature weights."""
    si = shape_info(degree)
    lat = local_lattice(degree, dim)
    n_loc = (degree + 1) ** dim
    G = np.zeros((dim, n_loc, n_loc))
    for d in range(dim):
        Gd = np.ones((n_loc, n_loc))
        for t in range(dim):
            Gd = Gd * (si.D if t == d else si.S)[np.ix_(lat[:, t], lat[:, t])]
        G[d] = Gd
    return G, si.quad_weights_tensor(dim)


def elasticity_oracle(tria: Triangulation, degree: int, mu: float, lam: float,
                      src: np.ndarray) -> np.ndarray:
    """C^T A C src for a(u, v) = int 2 mu eps(u):eps(v) + lam div u div v,
    A assembled cell by cell as a dense-block scipy matrix over the DoF
    components (component fastest) and C the hanging-node expansion, one
    copy a component. src, result: [n_dofs, dim]. On a cube cell of side h
    the physical gradients are G / h and detJ = h^dim, so each cell's block
    is h^(dim-2) times the unit cell's."""
    import scipy.sparse as sp

    dim = tria.dim
    dh = DoFHandler(tria, degree)
    ci = build_constraints(dh)
    G, w = _reference_gradients(degree, dim)
    n_loc = G.shape[1]
    A_ref = np.zeros((n_loc, dim, n_loc, dim))
    for c in range(dim):
        for e in range(dim):
            term = np.zeros((n_loc, n_loc))
            if c == e:
                for ax in range(dim):
                    term += mu * np.einsum("q,qi,qj->ij", w, G[ax], G[ax])
            term += mu * np.einsum("q,qi,qj->ij", w, G[e], G[c])
            term += lam * np.einsum("q,qi,qj->ij", w, G[c], G[e])
            A_ref[:, c, :, e] = term
    A_ref = A_ref.reshape(n_loc * dim, n_loc * dim)
    scale = tria.cell_size() ** (dim - 2)
    gid = dh.cell_dofs.astype(np.int64)
    big = (gid[:, :, None] * dim + np.arange(dim)[None, None, :]).reshape(len(gid), -1)
    m = big.shape[1]
    rows = np.repeat(big, m, axis=1).ravel()
    cols = np.tile(big, (1, m)).ravel()
    vals = (scale[:, None, None] * A_ref[None]).ravel()
    N = dh.n_dofs * dim
    A = sp.csr_matrix((vals, (rows, cols)), shape=(N, N))
    C = sp.kron(ci.expansion_matrix(), sp.eye(dim), format="csr")
    return (C.T @ (A @ (C @ np.asarray(src, dtype=np.float64).ravel()))).reshape(dh.n_dofs, dim)
