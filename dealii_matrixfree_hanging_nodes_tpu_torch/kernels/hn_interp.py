"""Kernel 12, ``hn_interp``: the index engine's hanging-node interpolation on
cell rows values [m, n_loc], in place on rows the caller owns. Item i of
codes [n_items] works on row ``rows[i]`` (or ``first + i`` without a row
list):

* sweeps (Q None): codes[i] is the row's 9-bit mask (0: identity); for t =
  0, 1, 2 (2, 1, 0 transposed) every masked line along t becomes P_s x (P_s^T
  x), s the mask's subcell bit along t;
* matrix (Q [nQ, n_loc, n_loc], ``hn_composite_matrix``'s convention
  forward(u) = u @ Q): codes[i] is the row's group (-1: identity), and the
  row becomes row @ Q[g] (row @ Q[g]^T transposed).

``MatrixFree.apply_hanging_node_constraints`` gives its four runners as
these arguments: all (every row, its mask), sorted (first = the first
constrained row of the mask-sorted cells), compact (the list hn_idx and its
masks) and matrix (hn_idx and each one's group).

Replaces the reference's ``apply_hanging_node_constraints``
(ops/hanging_nodes.py:87-154: per sweep a node mask, an einsum with P[sub]
and a where) and the runners of ``MatrixFree.apply_hanging_node_constraints``
(matrix_free.py:211-248). CUDA source: ``csrc/hn_interp.cu`` (the sweeps in
``csrc/hanging_nodes.cuh``, shared with ``cell_laplace``)."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from ..dof_handler import local_lattice
from ..ops.hanging_nodes import masked_sweeps

NAME = "hn_interp"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/ops/hanging_nodes.py:87"
DEGREES = (1, 2, 3, 4, 5, 6)


def matrix_rows(x, groups, Q, transpose):
    """x @ Q[g] (x @ Q[g]^T transposed) for the rows of each group g >= 0;
    rows of group -1 pass through. A new tensor."""
    out = x.clone()
    for g in torch.unique(groups).tolist():
        if g >= 0:
            sel = torch.nonzero(groups == g)[:, 0]
            out[sel] = x[sel] @ (Q[g].T if transpose else Q[g])
    return out


def hn_interp_plain(values, codes, P, transpose, rows=None, first=0, Q=None):
    """Plain PyTorch version: the chosen rows read, interpolated
    (``masked_sweeps`` or ``matrix_rows``) and written back. Updates values
    in place and returns it."""
    sel = rows.long() if rows is not None else torch.arange(
        first, first + codes.numel(), device=values.device)
    x = values[sel]
    values[sel] = (masked_sweeps(x, codes, P, transpose) if Q is None
                   else matrix_rows(x, codes, Q, transpose))
    return values


_ARGS = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def hn_interp(values, codes, P, transpose, rows=None, first=0, Q=None):
    """values [m, n_loc] (updated in place and returned); codes int32
    [n_items]; rows int32 [n_items] or None (then rows first .. first +
    n_items - 1); P [2, p+1, p+1] and Q [nQ, n_loc, n_loc] (or None) of
    values' dtype, on values' device."""
    if values.device.type == "cpu":
        return hn_interp_plain(values, codes, P, transpose, rows, first, Q)
    tensors = dict(values=values, codes=codes, P=P)
    if rows is not None:
        tensors["rows"] = rows
    if Q is not None:
        tensors["Q"] = Q
    dev = _build.check_cuda(NAME, values.dtype, **tensors)
    n = P.shape[-1]
    n_loc, n_items = n**3, codes.numel()
    if codes.dtype != torch.int32 or (rows is not None and rows.dtype != torch.int32):
        raise TypeError(f"{NAME}: codes and rows must be int32")
    if (n - 1 not in DEGREES or P.shape != (2, n, n) or values.dim() != 2
            or values.shape[1] != n_loc or values.numel() >= 2**31
            or (rows is not None and rows.shape != (n_items,))
            or (rows is None and first + n_items > values.shape[0])
            or (Q is not None and (Q.dim() != 3 or Q.shape[1:] != (n_loc, n_loc)))):
        raise ValueError(f"{NAME}: shapes values {tuple(values.shape)}, codes "
                         f"{tuple(codes.shape)}, P {tuple(P.shape)}, first {first}")
    if n_items == 0:
        return values
    ptrs = (ctypes.c_void_p * 5)(values.data_ptr(), None if rows is None else rows.data_ptr(),
                                 codes.data_ptr(), P.data_ptr(),
                                 None if Q is None else Q.data_ptr())
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(values.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, ptrs, n_items, int(first), n - 1, int(bool(transpose)))
    hn_interp.launches += 1
    return values


hn_interp.launches = 0


def masked_lines(masks: np.ndarray, p: int) -> np.ndarray:
    """[len(masks)] the number of lines that the three sweeps replace for
    each mask (a line along t is masked whole or not at all)."""
    lat = local_lattice(p, 3)
    masks = np.asarray(masks, dtype=np.int64)
    out = np.zeros(len(masks), dtype=np.int64)
    for mv in np.unique(masks):
        sub = [(mv >> d) & 1 for d in range(3)]
        face = [(mv >> (3 + d)) & 1 for d in range(3)]
        edge = [(mv >> (6 + d)) & 1 for d in range(3)]
        total = 0
        for t in range(3):
            on = lat[:, t] == 0  # one node per line along t
            mm = np.zeros(len(lat), dtype=bool)
            for d in range(3):
                if d != t and face[d]:
                    mm |= lat[:, d] == sub[d] * p
            if edge[t]:
                mm |= np.all([lat[:, a] == sub[a] * p for a in range(3) if a != t], axis=0)
            total += int((mm & on).sum())
        out[masks == mv] = total
    return out


def bytes_and_flops(values, codes, P, transpose, rows=None, first=0, Q=None):
    """Least traffic: each row that changes read once and written once, the
    codes and row list read once, P (or the Q table) read once. Operations:
    2 n^2 a masked line in the sweeps, 2 n_loc^2 a row in the matrix mode."""
    n = P.shape[-1]
    n_loc, isz = n**3, values.element_size()
    c = codes.cpu().numpy()
    if Q is None:
        active = int((c != 0).sum())
        flops = 2 * n * n * int(masked_lines(c, n - 1).sum())
        table = P.numel()
    else:
        active = int((c >= 0).sum())
        flops = 2 * n_loc * n_loc * active
        table = Q.numel()
    nbytes = (2 * active * n_loc + table) * isz + 4 * codes.numel() * (1 if rows is None else 2)
    return nbytes, flops
