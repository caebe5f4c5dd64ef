"""In-register hanging-node interpolation (capabilities C2, C12), the port of
``dealii_matrixfree_hanging_nodes_tpu.ops.hanging_nodes``: a pure function of
(1D subface matrices P, 9-bit compressed masks, cell-local values).

For sweep axis t = 0..dim-1, every lattice node on a constrained face plane
with normal != t, or on a constrained edge along t, is replaced by the 1D
subface interpolation P_{s_t} applied along t. The node set of sweep t
depends only on the coordinates other than t, so a line along t is replaced
whole or not at all. ``transpose=True`` applies the exact adjoint (reversed
sweep order, P^T against the masked input).

``apply_hanging_node_constraints`` is the index engine's function: its plain
PyTorch form here is the spec, and on a CUDA tensor it runs the
``hn_interp`` kernel on a copy. ``hn_composite_matrix`` gives the composite
of the sweeps as one [n_loc, n_loc] matrix per mask (the brick operator's
tables and the index engine's ``matrix`` runner).
"""

from __future__ import annotations

import numpy as np

import torch

from ..dof_handler import local_lattice

__all__ = ["apply_hanging_node_constraints", "hn_composite_matrix", "masked_sweeps"]


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


def _bits(masks: torch.Tensor, shift: int) -> torch.Tensor:
    return (masks >> shift) & 1


def masked_sweeps(values: torch.Tensor, masks: torch.Tensor, P: torch.Tensor,
                  transpose: bool = False) -> torch.Tensor:
    """The 3-D sweeps on cell rows, plain PyTorch (a new tensor): values [m,
    (p+1)^3], masks int [m] (0: identity), P [2, p+1, p+1] of values' dtype.
    As the reference computes it: per sweep, the per-cell node mask and a
    batched contraction with P[sub_t] (P^T, on the masked input, when
    transposed)."""
    dim = 3
    n = P.shape[-1]
    p = n - 1
    m = values.shape[0]
    masks = masks.to(torch.int64)
    lat = torch.from_numpy(local_lattice(p, dim)).to(values.device)
    sub = [_bits(masks, d) for d in range(dim)]
    face = [_bits(masks, dim + d) for d in range(dim)]
    edge = [_bits(masks, 2 * dim + d) for d in range(dim)]

    def node_mask(t: int) -> torch.Tensor:
        mm = torch.zeros((m, n**dim), dtype=torch.bool, device=values.device)
        for d in range(dim):
            if d != t:
                mm |= (face[d][:, None] == 1) & (lat[None, :, d] == sub[d][:, None] * p)
        line = edge[t][:, None] == 1
        for a in range(dim):
            if a != t:
                line = line & (lat[None, :, a] == sub[a][:, None] * p)
        return (mm | line).reshape(m, n, n, n)

    def batched_sweep(v, M, t):
        ax = v.dim() - 1 - t
        v = torch.movedim(v, ax, -1)
        v = torch.einsum("mji,mabj->mabi" if transpose else "mij,mabj->mabi", M, v)
        return torch.movedim(v, -1, ax)

    v = values.reshape(m, n, n, n)
    for t in (reversed(range(dim)) if transpose else range(dim)):
        Mt = P[sub[t]]  # [m, n, n] per-cell subface matrix
        mk = node_mask(t)
        if transpose:
            v = batched_sweep(torch.where(mk, v, 0.0), Mt, t) + torch.where(mk, 0.0, v)
        else:
            v = torch.where(mk, batched_sweep(v, Mt, t), v)
    return v.reshape(m, -1)


def apply_hanging_node_constraints(values: torch.Tensor, masks: torch.Tensor, P,
                                   dim: int, transpose: bool = False,
                                   n_components: int = 1) -> torch.Tensor:
    """Apply (or transpose-apply) the hanging-node interpolation to cell
    rows, returning a new tensor.

    values [m, n_components * (p+1)^dim] (component-major blocks), masks [m]
    (0 = unconstrained), P [2, p+1, p+1] (ShapeInfo.P; a tensor or an
    array, taken to values' device and dtype). Each component block gets the
    cell's mask. A copy of values, then ``hn_interp`` in place on it (every
    row, its own mask): on a CUDA tensor the kernel, on a CPU tensor its
    plain version."""
    from ..kernels import hn_interp

    if dim != 3:
        raise NotImplementedError("the port's index engine supports dim=3")
    m = values.shape[0]
    if n_components > 1:
        out = apply_hanging_node_constraints(
            values.reshape(m * n_components, -1),
            torch.repeat_interleave(masks, n_components), P, dim, transpose)
        return out.reshape(m, -1)
    P = torch.as_tensor(P).to(values.device, values.dtype)
    masks = torch.as_tensor(masks).to(values.device, torch.int32)
    return hn_interp.hn_interp(values.clone(), masks, P, transpose)
