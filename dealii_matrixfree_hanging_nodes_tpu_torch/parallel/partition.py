"""Weighted space-filling-curve partitioning, the port's copy of
``dealii_matrixfree_hanging_nodes_tpu.parallel.partition`` (capability C8).

The analog of p4est's weighted SFC repartition (tria.signals.weight.connect
+ repartition(), benchmark_02.cc:63-87): cells are stored in Morton order, so
a partition over R ranks is R contiguous ranges of balanced accumulated
weight. Constrained cells can be up-weighted as the reference's
hanging_nodes_weighting() does (benchmark_02.cc:17-34). NumPy on the host.
"""

from __future__ import annotations

import numpy as np

__all__ = ["hanging_nodes_weighting", "partition_cells", "dof_owners"]


def hanging_nodes_weighting(is_constrained: np.ndarray, weight: float) -> np.ndarray:
    """Per-cell weights in the reference's form: constrained cells get
    10 * weight + 1, regular cells 10 + 1 (benchmark_02.cc:17-34)."""
    return np.where(is_constrained, 10.0 * weight + 1.0, 10.0 + 1.0)


def partition_cells(n_cells: int, n_ranks: int, weights=None) -> np.ndarray:
    """Rank id per cell: contiguous Morton ranges with balanced weight."""
    if weights is None:
        weights = np.ones(n_cells)
    w = np.asarray(weights, dtype=np.float64)
    cum = np.cumsum(w)
    total = cum[-1]
    # boundary k at the first cell whose cumulative weight exceeds k/R of the total
    targets = total * (np.arange(1, n_ranks) / n_ranks)
    cuts = np.searchsorted(cum, targets, side="right")
    rank = np.zeros(n_cells, dtype=np.int32)
    for r, c in enumerate(cuts):
        rank[c:] = r + 1
    return rank


def dof_owners(cell_dofs: np.ndarray, rank_of_cell: np.ndarray, n_dofs: int):
    """Owner rank per DoF: the rank of the first (Morton-lowest) cell
    containing it, deterministic and contiguous along the SFC."""
    owner = np.full(n_dofs, np.iinfo(np.int32).max, dtype=np.int32)
    flat = cell_dofs.ravel()
    ranks = np.repeat(rank_of_cell.astype(np.int32), cell_dofs.shape[1])
    np.minimum.at(owner, flat, ranks)
    return owner
