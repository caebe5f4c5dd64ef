"""Sum-factorized cell evaluation (capability C1), the plain PyTorch form of
``dealii_matrixfree_hanging_nodes_tpu.ops.sum_factorization``: batched 1-D
contractions over the (p+1)^dim cell lattice, cells on the leading axis.

Values at quadrature points take dim sweeps of the 1-D interpolation matrix
S, then each gradient component one sweep of the collocation derivative Dc;
``integrate_*`` are the exact transposes.

Convention: local flat index l = ix + n*iy + n^2*iz, so a cell tensor
reshaped to [..., n, n, n] has axes (z, y, x); spatial axis t lives at array
axis ``ndim - 1 - t``. On the card the same sweeps run inside the
``cell_laplace`` kernel (``csrc/cell_laplace.cu``).
"""

from __future__ import annotations

import torch

__all__ = [
    "sweep",
    "evaluate_values",
    "evaluate_gradients",
    "integrate_values",
    "integrate_gradients",
]


def sweep(u: torch.Tensor, M: torch.Tensor, t: int) -> torch.Tensor:
    """Contract 1D matrix M [q, i] over spatial axis t of u [cells, *lattice]."""
    ax = u.dim() - 1 - t
    u = torch.movedim(u, ax, -1)
    u = torch.einsum("qi,...i->...q", M, u)
    return torch.movedim(u, -1, ax)


def _to_lattice(u: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    return u.reshape(u.shape[0], *([n] * dim))


def evaluate_values(u, S, dim):
    """Nodal coefficients -> values at quadrature points. u: [cells, n^dim]."""
    v = _to_lattice(u, dim, S.shape[1])
    for t in range(dim):
        v = sweep(v, S, t)
    return v.reshape(u.shape[0], -1)


def evaluate_gradients(u, S, Dc, dim):
    """Nodal coefficients -> reference-space gradients at quadrature points,
    [cells, dim, n_q] (component d = d/d x_d on the unit cell)."""
    v = _to_lattice(u, dim, S.shape[1])
    for t in range(dim):
        v = sweep(v, S, t)  # collocation values at quad points
    return torch.stack([sweep(v, Dc, t).reshape(u.shape[0], -1) for t in range(dim)], dim=1)


def integrate_values(q, S, dim):
    """Adjoint of evaluate_values. q: [cells, n_q] -> [cells, n^dim]."""
    v = _to_lattice(q, dim, S.shape[1])
    for t in reversed(range(dim)):
        v = sweep(v, S.T, t)
    return v.reshape(q.shape[0], -1)


def integrate_gradients(qg, S, Dc, dim):
    """Adjoint of evaluate_gradients. qg: [cells, dim, n_q] -> [cells, n^dim]."""
    n = S.shape[1]
    acc = None
    for t in range(dim):
        g = sweep(_to_lattice(qg[:, t, :], dim, n), Dc.T, t)
        acc = g if acc is None else acc + g
    for t in reversed(range(dim)):
        acc = sweep(acc, S.T, t)
    return acc.reshape(qg.shape[0], -1)
