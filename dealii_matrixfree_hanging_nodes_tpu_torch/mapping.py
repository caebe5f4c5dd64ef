"""Mappings and geometry factors (capability C11), copied from
``dealii_matrixfree_hanging_nodes_tpu.mapping``. The reference geometries are
axis-aligned refinements of a hyper_cube, so the default MappingQ1 analog
reduces to per-cell Cartesian factors. The MappingQCache analog (high-order
deformed mapping built from a point transform, benchmark_01.h:227-242)
produces per-quadrature-point symmetric metric tensors instead; the index
engine (``matrix_free.MatrixFree``, ``models.laplace``) and the brick engine
(``bricks.BrickLaplaceMM``, at the cells' brick-cell rows) read them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .dof_handler import local_lattice
from .elements import ShapeInfo
from .mesh import Triangulation

__all__ = ["cartesian_laplace_factors", "deformed_laplace_factors", "default_deformation"]

METRIC_CHUNK = 16384  # cells a chunk of the deformed metric
METRIC_CHUNK_DEVICE = 65536  # cells a chunk of the metric on the card (~1.2 GB of f64 at p=4)


def cartesian_laplace_factors(tria: Triangulation) -> np.ndarray:
    """Per-cell per-axis Laplace geometry factor detJ / h_d^2, [n_cells, dim].

    With x = lower + h * x_ref on [0,1]^dim:
    ∫ ∇u·∇v = Σ_q w_q detJ Σ_d (1/h_d²) ∂̂_d u ∂̂_d v.
    """
    h = tria.cell_size()
    detj = h**tria.dim
    return np.repeat((detj / h**2)[:, None], tria.dim, axis=1)


def default_deformation(points, amplitude: float = 0.02):
    """Sin-product perturbation in the style of the reference's high-order
    mapping test (benchmark_01.h:227-239): x -> x + a * prod_d sin(pi x_d),
    on a NumPy array or a tensor (on its device)."""
    if isinstance(points, torch.Tensor):
        return points + amplitude * torch.prod(torch.sin(math.pi * points), dim=-1, keepdim=True)
    disp = amplitude * np.prod(np.sin(np.pi * points), axis=-1, keepdims=True)
    return points + disp


def deformed_laplace_factors(
    tria: Triangulation, shape: ShapeInfo, transform=default_deformation,
    chunk: int | None = METRIC_CHUNK, device=None,
) -> np.ndarray:
    """Per-cell, per-quad-point symmetric metric for a deformed mapping.

    Returns geo [n_cells, n_q, dim*(dim+1)//2]: the packed upper triangle of
    w_q * detJ * J^{-1} J^{-T} at every quadrature point, where J is the
    Jacobian of (transform ∘ cartesian_map) evaluated with the mapping
    represented isoparametrically on the cell's own lattice (MappingQCache
    analog). J is computed by sum-factorized differentiation of the mapped
    lattice points, i.e. the mapping is the degree-p interpolant of the
    transform.

    The cells are independent, so they go through in chunks of ``chunk``
    cells (None: all at once) into the one output array: every value is
    the same bit for bit, and the host holds the Jacobians of one chunk at
    a time instead of all of them (2.4 GB for each such array at quadrant
    nref=7, p=4).

    device: None computes it with NumPy on the host; a torch device
    computes it there in float64 with the same steps (``_metric_cells_torch``:
    einsum, ``torch.linalg.det`` and ``inv``), chunk by chunk, and copies
    each chunk into the host array, the bits then depending on the chunks;
    on the card the chunk's tensors are freed and the caching allocator's
    blocks released once the metric is built. The transform must then take
    a tensor (``default_deformation`` takes either). Both forms agree to
    rounding (about 1e-14 relative).
    """
    n_cells = tria.n_active_cells
    iu = np.triu_indices(tria.dim)
    out = np.empty((n_cells, shape.n_1d**tria.dim, len(iu[0])))
    step = n_cells if chunk is None else max(1, int(chunk))
    lower, h = tria.cell_lower(), tria.cell_size()
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda":
            step = max(step, METRIC_CHUNK_DEVICE)
        const = _torch_constants(shape, tria.dim, device)
        host = torch.from_numpy(out)
        for s in range(0, n_cells, step):
            e = min(s + step, n_cells)
            host[s:e] = _metric_cells_torch(lower[s:e], h[s:e], tria.dim, const, transform,
                                            device).cpu()
        del const
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return out
    for s in range(0, n_cells, step):
        e = min(s + step, n_cells)
        out[s:e] = _metric_cells(lower[s:e], h[s:e], tria.dim, shape, transform)
    return out


def _metric_cells(lower, h, dim, shape, transform):
    """``deformed_laplace_factors`` of the cells with these lower corners and
    sizes."""
    n = shape.n_1d
    lat_1d = shape.nodes
    lat = local_lattice(shape.degree, dim)  # [n_loc, dim]
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


def _torch_constants(shape, dim, device):
    """The float64 tensors ``_metric_cells_torch`` reads on device: the 1-D
    nodes, the cell lattice, S, D and the tensor quadrature weights."""
    f64 = dict(dtype=torch.float64, device=device)
    return dict(nodes=torch.as_tensor(shape.nodes, **f64),
                lattice=torch.as_tensor(local_lattice(shape.degree, dim), device=device),
                S=torch.as_tensor(shape.S, **f64), D=torch.as_tensor(shape.D, **f64),
                w=torch.as_tensor(shape.quad_weights_tensor(dim), **f64), n=shape.n_1d)


def _metric_cells_torch(lower, h, dim, const, transform, device):
    """``_metric_cells`` in PyTorch on device (float64): a tensor [cells, n_q,
    dim (dim+1) / 2]."""
    n = const["n"]
    lower = torch.as_tensor(lower, dtype=torch.float64, device=device)
    h = torch.as_tensor(h, dtype=torch.float64, device=device)
    pts = lower[:, None, :] + h[:, None, None] * const["nodes"][const["lattice"]][None, :, :]
    pts = transform(pts)  # [n_cells, n_loc, dim]
    n_cells = pts.shape[0]
    v = pts.reshape(n_cells, *([n] * dim), dim)

    def sweep(u, M, t):
        ax = u.dim() - 2 - t  # spatial axis (last axis is the dim component)
        u = torch.movedim(u, ax, -2)
        u = torch.einsum("qi,...ic->...qc", M, u)
        return torch.movedim(u, -2, ax)

    J = torch.empty((n_cells, n**dim, dim, dim), dtype=torch.float64, device=device)
    for t in range(dim):
        g = v
        for tt in range(dim):
            g = sweep(g, const["D"] if tt == t else const["S"], tt)
        J[:, :, :, t] = g.reshape(n_cells, -1, dim)
    detJ = torch.linalg.det(J)
    Jinv = torch.linalg.inv(J)
    G = torch.einsum("cqde,cqfe->cqdf", Jinv, Jinv)  # J^{-1} J^{-T}
    G = G * (const["w"][None, :, None, None] * detJ[:, :, None, None])
    iu = np.triu_indices(dim)
    return G[:, :, torch.as_tensor(iu[0], device=device), torch.as_tensor(iu[1], device=device)]
