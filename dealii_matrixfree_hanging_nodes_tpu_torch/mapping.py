"""Mappings and geometry factors (capability C11), copied from
``dealii_matrixfree_hanging_nodes_tpu.mapping``. The reference geometries are
axis-aligned refinements of a hyper_cube, so the default MappingQ1 analog
reduces to per-cell Cartesian factors. The MappingQCache analog (high-order
deformed mapping built from a point transform, benchmark_01.h:227-242)
produces per-quadrature-point symmetric metric tensors instead; the index
engine (``matrix_free.MatrixFree``, ``models.laplace``) reads them, the brick
engine does not.
"""

from __future__ import annotations

import numpy as np

from .dof_handler import local_lattice
from .elements import ShapeInfo
from .mesh import Triangulation

__all__ = ["cartesian_laplace_factors", "deformed_laplace_factors", "default_deformation"]


def cartesian_laplace_factors(tria: Triangulation) -> np.ndarray:
    """Per-cell per-axis Laplace geometry factor detJ / h_d^2, [n_cells, dim].

    With x = lower + h * x_ref on [0,1]^dim:
    ∫ ∇u·∇v = Σ_q w_q detJ Σ_d (1/h_d²) ∂̂_d u ∂̂_d v.
    """
    h = tria.cell_size()
    detj = h**tria.dim
    return np.repeat((detj / h**2)[:, None], tria.dim, axis=1)


def default_deformation(points: np.ndarray, amplitude: float = 0.02) -> np.ndarray:
    """Sin-product perturbation in the style of the reference's high-order
    mapping test (benchmark_01.h:227-239): x -> x + a * prod_d sin(pi x_d)."""
    disp = amplitude * np.prod(np.sin(np.pi * points), axis=-1, keepdims=True)
    return points + disp


def deformed_laplace_factors(
    tria: Triangulation, shape: ShapeInfo, transform=default_deformation
) -> np.ndarray:
    """Per-cell, per-quad-point symmetric metric for a deformed mapping.

    Returns geo [n_cells, n_q, dim*(dim+1)//2]: the packed upper triangle of
    w_q * detJ * J^{-1} J^{-T} at every quadrature point, where J is the
    Jacobian of (transform ∘ cartesian_map) evaluated with the mapping
    represented isoparametrically on the cell's own lattice (MappingQCache
    analog). J is computed by sum-factorized differentiation of the mapped
    lattice points, i.e. the mapping is the degree-p interpolant of the
    transform.
    """
    dim = tria.dim
    n = shape.n_1d
    lat_1d = shape.nodes
    lat = local_lattice(shape.degree, dim)  # [n_loc, dim]
    lower = tria.cell_lower()
    h = tria.cell_size()
    pts = lower[:, None, :] + h[:, None, None] * lat_1d[lat][None, :, :]
    pts = transform(pts)  # [n_cells, n_loc, dim]

    # reference derivative of the interpolated mapping at quadrature points
    S, D = shape.S, shape.D
    n_cells = pts.shape[0]
    v = pts.reshape(n_cells, *([n] * dim), dim)

    def sweep_np(u, M, t):
        ax = u.ndim - 2 - t  # spatial axis (last axis is the dim component)
        u = np.moveaxis(u, ax, -2)
        u = np.einsum("qi,...ic->...qc", M, u)
        return np.moveaxis(u, -2, ax)

    J = np.zeros((n_cells, n**dim, dim, dim))  # J[c,q,phys,ref]
    for t in range(dim):
        g = v
        for tt in range(dim):
            g = sweep_np(g, D if tt == t else S, tt)
        J[:, :, :, t] = g.reshape(n_cells, -1, dim)

    detJ = np.linalg.det(J)
    Jinv = np.linalg.inv(J)
    G = np.einsum("cqde,cqfe->cqdf", Jinv, Jinv)  # J^{-1} J^{-T}
    w = shape.quad_weights_tensor(dim)
    G = G * (w[None, :, None, None] * detJ[:, :, None, None])
    iu = np.triu_indices(dim)
    return G[:, :, iu[0], iu[1]]
