"""Kernel 17, ``dof_embed``: the brick GMG's DoF embedding S (a global DoF
vector into a brick vector) and its exact transpose, each one sparse gather
by destination:

    out[i] = sum of w[e] * x[idx[e]] over e = ptr[i] .. ptr[i+1]   (0 where empty)

``tables`` composes the reference's two steps (the slaves interpolated from
their masters, then every valid brick node set to its DoF) into one map M on
the host, [nb N3p, n_dofs], and builds both modes from it:

* embed (x a DoF vector, out [nb, N3p]): row i is a brick node; a valid node
  of a free DoF reads that DoF (w = 1), a valid node of a slave reads the
  slave's masters with their weights (the masters' values before any slave
  is set, as the reference's ``x.at[slave].set(upd)`` reads them); holes and
  padding have no entry and get 0. One launch.
* embed_t (x a brick vector, out [n_dofs]): M^T, rows by DoF, entries in
  ascending node order: a free DoF sums its node copies, and each master adds
  w times the node copies of each slave it serves; a slave's own copies go
  nowhere (a master that is also a slave starts from 0, as the transpose of
  ``.at[slave].set`` gives). The slave fold is composed into the lists, so
  this mode too is one launch.

Each destination has one owner that sums its entries in list order: no
atomics, bit-identical calls. The owner is a thread for a row of at most
``LONG_ROW`` entries and a warp for a longer one: ``tables`` lists each
mode's long rows (``long_rows``), which the kernel's first blocks take.

Replaces the reference's ``DofEmbed.embed`` (models/multigrid_bricks.py:89-
105) and its ``jax.linear_transpose`` inside ``BrickTransfer._restrict_impl``
(:252-255). ``DofEmbed.extract`` (the owner-copy read) stays a PyTorch index.
CUDA source: ``csrc/dof_embed.cu``."""

from __future__ import annotations

import ctypes

import numpy as np
import scipy.sparse as sp
import torch

from . import _build

NAME = "dof_embed"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/models/multigrid_bricks.py:89"
MODES = ("embed", "embed_t")
# a row of more entries is long: a warp sums it (csrc/dof_embed.cu). At 8, embed's slave rows
# (3-D p=4: 25 entries) took warps and ran slower than a thread each
LONG_ROW = 32


def embedding_matrix(node_dof, slave, row_ptr, col, weight, n_dofs, N3, N3p):
    """M [nb N3p, n_dofs] (scipy CSR, float64): the embedding as one map.
    node_dof [nb N3] (-1 at holes), the constraint CSR (slave, row_ptr, col,
    weight)."""
    node_dof = np.asarray(node_dof, dtype=np.int64)
    nb = node_dof.size // N3
    slave = np.asarray(slave, dtype=np.int64)
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    # D [n_dofs, n_dofs]: identity on the free DoFs, the constraint rows on the slaves
    is_slave = np.zeros(n_dofs, dtype=bool)
    is_slave[slave] = True
    free = np.nonzero(~is_slave)[0]
    D = sp.csr_matrix(
        (np.concatenate([np.ones(len(free)), np.asarray(weight, dtype=np.float64)]),
         (np.concatenate([free, np.repeat(slave, np.diff(row_ptr))]),
          np.concatenate([free, np.asarray(col, dtype=np.int64)]))),
        shape=(n_dofs, n_dofs))
    valid = np.nonzero(node_dof >= 0)[0]
    padded = (valid // N3) * N3p + valid % N3
    S = sp.csr_matrix((np.ones(len(valid)), (padded, node_dof[valid])), shape=(nb * N3p, n_dofs))
    M = (S @ D).tocsr()
    M.sort_indices()
    return M


def long_rows(ptr, split=LONG_ROW):
    """The rows of more than `split` entries (int32, ascending): the ones a
    warp sums."""
    return np.nonzero(np.diff(np.asarray(ptr, dtype=np.int64)) > split)[0].astype(np.int32)


def _csr(M):
    if M.nnz >= 2**31 or M.shape[0] >= 2**31:
        raise NotImplementedError(f"{NAME}: entries exceed int32")
    return (M.indptr.astype(np.int32), M.indices.astype(np.int32), M.data.astype(np.float64),
            long_rows(M.indptr))


def tables(node_dof, slave, row_ptr, col, weight, n_dofs, N3, N3p):
    """{"embed": (ptr, idx, w, long), "embed_t": (ptr, idx, w, long)} as
    NumPy arrays (int32 indices, float64 weights; ``long_rows`` of ptr)."""
    M = embedding_matrix(node_dof, slave, row_ptr, col, weight, n_dofs, N3, N3p)
    Mt = M.T.tocsr()
    Mt.sort_indices()
    return {"embed": _csr(M), "embed_t": _csr(Mt)}


def dof_embed_plain(x, ptr, idx, w, long, shape):
    """Plain PyTorch version: every entry's w * x[idx] added at its row, in
    list order (a new tensor of `shape`); the long-row list is not read."""
    n = ptr.numel() - 1
    row = torch.repeat_interleave(torch.arange(n, device=x.device), (ptr[1:] - ptr[:-1]).long())
    out = torch.zeros(n, dtype=x.dtype, device=x.device)
    out.index_add_(0, row, w * x.reshape(-1)[idx.long()])
    return out.reshape(shape)


_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def dof_embed(x, ptr, idx, w, long, shape):
    """x (any shape, contiguous), ptr int32 [n+1], idx int32, w of x's dtype,
    long int32 (``long_rows(ptr)``: the rows of more than LONG_ROW entries)
    -> new tensor of `shape` (n elements)."""
    if x.device.type == "cpu":
        return dof_embed_plain(x, ptr, idx, w, long, shape)
    dev = _build.check_cuda(NAME, x.dtype, x=x, ptr=ptr, idx=idx, w=w, long=long)
    if ptr.dtype != torch.int32 or idx.dtype != torch.int32 or long.dtype != torch.int32:
        raise TypeError(f"{NAME}: ptr, idx and long must be int32")
    n = ptr.numel() - 1
    if (ptr.dim() != 1 or idx.shape != w.shape or idx.dim() != 1 or long.dim() != 1
            or long.numel() > n or int(np.prod(shape)) != n or x.numel() >= 2**31
            or n >= 2**31):
        raise ValueError(f"{NAME}: shapes x {tuple(x.shape)}, ptr {tuple(ptr.shape)}, idx "
                         f"{tuple(idx.shape)}, w {tuple(w.shape)}, long {tuple(long.shape)}, out "
                         f"{tuple(shape)}")
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(x.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(x), _build.ptr(ptr), _build.ptr(idx), _build.ptr(w),
                  _build.ptr(long), _build.ptr(out), n, long.numel(), LONG_ROW)
    dof_embed.launches += 1
    return out


dof_embed.launches = 0


def bytes_and_flops(x, ptr, idx, w, long, shape):
    """Least traffic: the x values the entries name read once, ptr, idx and w
    read once, out written once (the long-row list is the kernel's schedule,
    not the function's input: not counted). Operations: a multiply and an
    add an entry."""
    n_read = int(torch.unique(idx).numel())
    nbytes = (n_read + w.numel() + ptr.numel() - 1) * x.element_size() + 4 * (
        ptr.numel() + idx.numel())
    return nbytes, 2 * idx.numel()
