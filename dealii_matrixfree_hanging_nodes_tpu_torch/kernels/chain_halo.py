"""Kernel 22, ``chain_halo``: the distributed brick engine's hanging-node
fold and fill chains on its chain buffer (the halo exchange's need buffer
[N_need+1, n_loc], or the replicated exchange's gathered buffer [R
n_chain_max, n_loc]), all levels in one launch:

    out_flat[i] = sum of w[e] * x_flat[src[e]] over e = ptr[i] .. ptr[i+1]

``compose`` builds (ptr, src, w) on the host from the per-level tables, in
the reference's order of operations: the fold runs the levels finest first
(save the level-zeroed rows, add fine rows x T into the coarse rows, restore
them), the fill coarsest first (zero the level's rows, add coarse rows x
T^T into the fine rows). The chain is linear, so the composed map is exact;
its sums run in another order than the level-by-level one.

Replaces the reference's ``_chain_fold_halo`` and ``_chain_fill_halo``
(dealii_matrixfree_hanging_nodes_tpu/parallel/bricks_distributed.py:955-997)
and the replicated step's level loops (:1061-1092, :1145-1162). CUDA source:
``csrc/chain_halo.cu``."""

from __future__ import annotations

import ctypes

import numpy as np
import scipy.sparse as sp
import torch

from . import _build

NAME = "chain_halo"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/parallel/bricks_distributed.py:955"


def level_map(n_rows, n_loc, transfers, zero_pos, zero_keep, fill: bool):
    """One level's map on the flat buffer [n_rows * n_loc] (scipy CSR,
    float64). transfers: (fine [k], coarse [k], T [k, n_loc, n_loc] or one
    [n_loc, n_loc] for all, mask [k]) row lists; zero_pos [z] the level's
    rows, zero_keep [z, n_loc]. Fold: y = x + A x, then the level's rows set
    to keep * x; fill: the level's rows scaled by keep, then y += A^T y."""
    N = n_rows * n_loc
    rows, cols, vals = [], [], []
    for fine, coarse, T, mask in transfers:
        fine, coarse = np.asarray(fine, np.int64), np.asarray(coarse, np.int64)
        sel = np.nonzero(np.asarray(mask) != 0)[0]
        if not len(sel):
            continue
        T = np.broadcast_to(np.asarray(T, dtype=np.float64), (len(fine), n_loc, n_loc))[sel]
        k, i, j = np.nonzero(T)
        # fold: coarse slot j += fine slot i * T[i, j]
        rows.append(coarse[sel][k] * n_loc + j)
        cols.append(fine[sel][k] * n_loc + i)
        vals.append(T[k, i, j])
    A = sp.csr_matrix((np.concatenate(vals) if vals else np.zeros(0),
                       (np.concatenate(rows) if rows else np.zeros(0, np.int64),
                        np.concatenate(cols) if cols else np.zeros(0, np.int64))), shape=(N, N))
    zpos = (np.asarray(zero_pos, np.int64)[:, None] * n_loc + np.arange(n_loc)).reshape(-1)
    keep = np.ones(N)
    is_zero = np.zeros(N, dtype=bool)
    is_zero[zpos] = True
    keep[zpos] = np.asarray(zero_keep, dtype=np.float64).reshape(-1)
    I = sp.identity(N, format="csr")
    if fill:
        return (I + A.T.tocsr()) @ sp.diags(keep)
    pass_rows = sp.diags((~is_zero).astype(np.float64))
    return pass_rows @ (I + A) + sp.diags(np.where(is_zero, keep, 0.0))


def compose(n_rows, n_loc, levels, fill: bool):
    """(ptr, src, w): the chain's levels (a list of ``level_map`` argument
    tuples (transfers, zero_pos, zero_keep), finest first for the fold,
    coarsest first for the fill, as they run) composed into one map, by
    destination, entries in ascending source order, zero weights dropped."""
    N = n_rows * n_loc
    M = sp.identity(N, format="csr")
    for transfers, zero_pos, zero_keep in levels:
        M = level_map(n_rows, n_loc, transfers, zero_pos, zero_keep, fill) @ M
    M = sp.csr_matrix(M)
    M.eliminate_zeros()
    M.sort_indices()
    if M.nnz >= 2**31:
        raise NotImplementedError(f"{NAME}: the composed chain has {M.nnz} entries, past int32")
    return M.indptr.astype(np.int32), M.indices.astype(np.int32), M.data


def chain_halo_plain(x, ptr, src, w):
    """Plain PyTorch version: the entries' products summed by destination
    (``index_add_`` in list order) into a zero buffer."""
    n = ptr.numel() - 1
    dst = torch.repeat_interleave(torch.arange(n, device=x.device), (ptr[1:] - ptr[:-1]).long())
    out = torch.zeros(n, dtype=x.dtype, device=x.device)
    return out.index_add_(0, dst, w * x.reshape(-1)[src.long()]).view(x.shape)


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]


def chain_halo(x, ptr, src, w):
    """x [rows, n_loc] (the chain buffer), ptr int32 [x.numel()+1], src int32,
    w of x's dtype -> new [rows, n_loc]."""
    if x.device.type == "cpu":
        return chain_halo_plain(x, ptr, src, w)
    dev = _build.check_cuda(NAME, x.dtype, x=x, ptr=ptr, src=src, w=w)
    if ptr.dtype != torch.int32 or src.dtype != torch.int32:
        raise TypeError(f"{NAME}: ptr and src must be int32")
    if ptr.shape != (x.numel() + 1,) or src.shape != w.shape or x.numel() >= 2**31:
        raise ValueError(f"{NAME}: shapes x {tuple(x.shape)}, ptr {tuple(ptr.shape)}, src "
                         f"{tuple(src.shape)}, w {tuple(w.shape)}")
    out = torch.empty_like(x)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(x.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(x), _build.ptr(ptr), _build.ptr(src), _build.ptr(w),
                  _build.ptr(out), x.numel())
    chain_halo.launches += 1
    return out


chain_halo.launches = 0


def bytes_and_flops(x, ptr, src, w):
    """Least traffic of the function: the buffer read once and written once,
    the map (its entries' sources and weights, one row pointer a value)
    read once; a multiply and an add an entry."""
    isz = x.element_size()
    return 2 * x.numel() * isz + src.numel() * (4 + isz) + 4 * ptr.numel(), 2 * src.numel()
