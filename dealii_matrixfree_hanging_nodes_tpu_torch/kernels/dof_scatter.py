"""Kernel 14, ``dof_scatter``: the index engine's scatter-add of cell rows
into a global vector, written by destination. With the transposed DoF map
(``transpose_map``: ptr [n_dofs+1] into the flat (cell, slot) positions of
each DoF, ascending), every DoF i gets

    dst[i] = sum of rows_flat[ent[e]] over e = ptr[i] .. ptr[i+1]   (0 where empty)

A DoF that no cell row names (a hanging DoF under the fast map, whose slots
hold coarse masters) gets 0, so the kernel writes every DoF and needs no
memset; one owner per DoF sums in a fixed order, so there are no atomics.

Replaces the reference's ``distribute_local_to_global(_plain)``
(matrix_free.py:281-297: ``zeros.at[dofmap].add(rows)``).
CUDA source: ``csrc/dof_scatter.cu``."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

NAME = "dof_scatter"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/matrix_free.py:281"


def transpose_map(dofmap: np.ndarray, n_dofs: int):
    """(ptr int32 [n_dofs+1], ent int32 [n_cells*n_loc]): the flat positions
    of each DoF in dofmap, ascending (a stable sort by DoF)."""
    flat = np.asarray(dofmap).reshape(-1)
    if flat.size >= 2**31 or n_dofs >= 2**31:
        raise NotImplementedError(f"{NAME}: cell-row positions exceed int32")
    ent = np.argsort(flat, kind="stable").astype(np.int32)
    ptr = np.zeros(n_dofs + 1, dtype=np.int64)
    np.cumsum(np.bincount(flat, minlength=n_dofs), out=ptr[1:])
    return ptr.astype(np.int32), ent


def dof_scatter_plain(rows, ptr, ent):
    """Plain PyTorch version: each entry's row value added at its DoF."""
    n = ptr.numel() - 1
    dof = torch.repeat_interleave(torch.arange(n, device=rows.device), (ptr[1:] - ptr[:-1]).long())
    return torch.zeros(n, dtype=rows.dtype, device=rows.device).index_add_(
        0, dof, rows.reshape(-1)[ent.long()])


_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p]


def dof_scatter(rows, ptr, ent):
    """rows [n_cells, n_loc]; ptr [n_dofs+1], ent int32 -> new [n_dofs]."""
    if rows.device.type == "cpu":
        return dof_scatter_plain(rows, ptr, ent)
    dev = _build.check_cuda(NAME, rows.dtype, rows=rows, ptr=ptr, ent=ent)
    if ptr.dtype != torch.int32 or ent.dtype != torch.int32:
        raise TypeError(f"{NAME}: ptr and ent must be int32")
    if ptr.dim() != 1 or ent.dim() != 1 or rows.numel() >= 2**31:
        raise ValueError(f"{NAME}: shapes rows {tuple(rows.shape)}, ptr {tuple(ptr.shape)}, "
                         f"ent {tuple(ent.shape)}")
    n = ptr.numel() - 1
    dst = torch.empty(n, dtype=rows.dtype, device=rows.device)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(rows.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(rows), _build.ptr(ptr), _build.ptr(ent),
                  _build.ptr(dst), n)
    dof_scatter.launches += 1
    return dst


dof_scatter.launches = 0


def bytes_and_flops(rows, ptr, ent):
    """Least traffic of the function (distribute_local_to_global): the rows
    read once, one int32 DoF index per (cell, slot) entry read once (the DoF
    map's size, what ``index_add_`` reads), dst written once. ptr is left out:
    it exists only because of the transposed layout this kernel chose. An add
    per entry."""
    n = ptr.numel() - 1
    nbytes = (rows.numel() + n) * rows.element_size() + 4 * ent.numel()
    return nbytes, ent.numel()
