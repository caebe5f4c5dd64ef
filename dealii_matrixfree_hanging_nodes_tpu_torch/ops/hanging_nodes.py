"""Composite hanging-node interpolation matrices (capability C2), copied from
``dealii_matrixfree_hanging_nodes_tpu.ops.hanging_nodes.hn_composite_matrix``.

For sweep axis t = 0..dim-1, every lattice node on a constrained face plane
with normal != t, or on a constrained edge along t, is replaced by the 1D
subface interpolation P_{s_t} applied along t. The brick operator applies the
composite of the sweeps as one [n_loc, n_loc] matrix per distinct mask.
"""

from __future__ import annotations

import numpy as np

from ..dof_handler import local_lattice

__all__ = ["hn_composite_matrix"]


def hn_composite_matrix(mask: int, P: np.ndarray, dim: int) -> np.ndarray:
    """Dense composite of the masked interpolation sweeps, built host-side.

    Returns Q [n_loc, n_loc] with  forward(u) = u @ Q  and, since the sweeps
    are exact adjoints, transpose(u) = u @ Q.T.
    """
    P = np.asarray(P, dtype=np.float64)
    n = P.shape[-1]
    p = n - 1
    lat = local_lattice(p, dim)
    n_loc = n**dim
    sub = [(mask >> d) & 1 for d in range(dim)]
    face = [(mask >> (dim + d)) & 1 for d in range(dim)]
    edge = [(mask >> (2 * dim + d)) & 1 for d in range(dim)] if dim == 3 else None

    v = np.eye(n_loc).reshape(n_loc, *([n] * dim))  # rows: input basis index
    for t in range(dim):
        mm = np.zeros(n_loc, dtype=bool)
        for d in range(dim):
            if d == t:
                continue
            if face[d]:
                mm |= lat[:, d] == sub[d] * p
        if dim == 3 and edge[t]:
            line = np.ones(n_loc, dtype=bool)
            for a2 in range(dim):
                if a2 != t:
                    line &= lat[:, a2] == sub[a2] * p
            mm |= line
        mmt = mm.reshape(*([n] * dim))
        ax = v.ndim - 1 - t
        vt = np.moveaxis(v, ax, -1)
        swept = np.moveaxis(np.einsum("ij,...j->...i", P[sub[t]], vt), -1, ax)
        v = np.where(mmt[None], swept, v)
    return v.reshape(n_loc, n_loc)
