"""Kernel 16, ``brick_transfer``: the brick GMG's transfer between two levels
of global coarsening, from brick vector to brick vector. A fine brick-cell
row r (fine brick r // C, slot r % C, C = B^dim) is covered by the coarse
row src_lin[r] and embeds it with E[r] [dim, n, n] (x first); own[r, j]
bit 0 marks the one writer of each fine node (the smallest covering row),
bit 1 that writer where the fine level's dot mask W_f is 1 (``tables``).
dim is 3, or 2 on 2-D bricks (read from E's axis 1).

* prolongate (xc [nb_c, N3p] -> new [nb_f, N3p]): one block a fine brick;
  for each of its present rows (``p_ptr``, ``p_rows``) the coarse cell's
  (p+1)^dim nodes are read straight from the coarse bricks, go through the
  sweeps along x, y(, z), and the owned nodes are written; a node no row
  owns (holes) and the padding are 0.
* restrict, its exact adjoint with W_f (rf [nb_f, N3p] -> new [nb_c,
  N3p]): one block a coarse brick; each present coarse cell (``r_ptr``
  [nb_c, 2^dim + 1]: its brick's cells in 2^dim parity classes, slots
  ``r_slot``) sums its fine rows (``c_ptr``, ``c_rows``, ascending), each
  read from the fine bricks, times bit 1, through the E^T sweeps along
  (z,) y, x; the cells of a class share no node, so their rows are added
  into the brick's nodes class by class without atomics.

Replaces the reference's ``BrickTransfer._pb`` (models/multigrid_bricks.py:
217-233, either dimension: ``_extract_cols``, the ``src_lin`` gather, the E
einsums, the
``own_w`` product and ``_scatter_cols``) and its ``jax.linear_transpose`` in
``_restrict_impl`` (:242-250, with ``yw = rf_b * wf``).
CUDA source: ``csrc/brick_transfer.cu`` (the sweeps in ``csrc/transfer.cuh``)."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .cell_apply import cell_nodes
from .cell_transfer import embed_rows

NAME = "brick_transfer"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/models/multigrid_bricks.py:217"
MODES = ("prolongate", "restrict")
OWN, OWN_WEIGHTED = 1, 2  # the bits of own


def tables(src_lin, own_w, wf, n_bricks_c, B, p, N3):
    """Host tables of both modes (NumPy, int32 / uint8) from the reference's
    ``src_lin`` [nlin_f], ``own_w`` [nlin_f, n_loc] (0/1) and the fine dot
    mask wf [nb_f, >= N3] (N3 = NB^dim, which gives the dimension): own
    (bit 0 own_w, bit 1 own_w * wf at the node), p_ptr / p_rows (each fine
    brick's rows that own a node), r_ptr [nb_c, 2^dim + 1] / r_slot (the
    coarse cells that cover such rows, by brick in 2^dim parity classes),
    c_ptr / c_rows (each listed coarse cell's rows, ascending). A row that
    owns no node adds exactly 0 in both modes (the reference's absent rows:
    src_lin 0, E = I, own_w 0), so the lists leave it out."""
    n = p + 1
    NB = B * p + 1
    dim = {NB**2: 2, NB**3: 3}.get(int(N3))
    if dim is None:
        raise ValueError(f"{NAME}: N3={N3} is no brick of {NB}^2 or {NB}^3 nodes")
    C, ncls = B**dim, 2**dim
    src_lin = np.asarray(src_lin, dtype=np.int64)
    nlin_f = len(src_lin)
    own_w = np.asarray(own_w) != 0
    rows = np.nonzero(own_w.any(axis=1))[0]
    lat = np.stack([(np.arange(n**dim) // n**a) % n for a in range(dim)], axis=1)
    slot_lat = np.stack([(np.arange(C) // B**a) % B for a in range(dim)], axis=1)
    slot_idx = ((slot_lat[:, None, :] * p + lat[None, :, :]) * NB ** np.arange(dim)).sum(-1)
    wf = np.asarray(wf)[:, :N3].reshape(-1) != 0
    nodes_f = (np.arange(nlin_f) // C)[:, None] * N3 + slot_idx[np.arange(nlin_f) % C]
    own = (own_w * OWN + (own_w & wf[nodes_f]) * OWN_WEIGHTED).astype(np.uint8)
    nb_f = nlin_f // C
    p_ptr = np.searchsorted(rows // C, np.arange(nb_f + 1)).astype(np.int32)
    # coarse cells with fine rows, by coarse brick, parity class and slot
    parent = src_lin[rows]
    grouped = rows[np.argsort(parent, kind="stable")]  # by coarse cell, each ascending
    cells, counts = np.unique(parent, return_counts=True)
    first = np.concatenate([[0], np.cumsum(counts)])
    sl = cells % C
    cls = sum(((sl // B**a) % 2) << a for a in range(dim))
    key = (cells // C) * ncls + cls
    eo = np.lexsort((sl, key))
    c_ptr = np.concatenate([[0], np.cumsum(counts[eo])])
    c_rows = (np.concatenate([grouped[first[e]:first[e + 1]] for e in eo]) if len(eo)
              else grouped)
    r_ptr = np.searchsorted(key[eo], np.arange(n_bricks_c)[:, None] * ncls
                            + np.arange(ncls + 1)[None, :])
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    return dict(src_lin=i32(src_lin), own=own, p_ptr=p_ptr, p_rows=i32(rows),
                r_ptr=i32(r_ptr), r_slot=i32(sl[eo]), c_ptr=i32(c_ptr), c_rows=i32(c_rows))


def _mode(mode):
    if mode not in MODES:
        raise ValueError(f"{NAME}: unknown mode {mode!r}")
    return mode


def brick_transfer_plain(x, src_lin, E, own, p_ptr, p_rows, r_ptr, r_slot, c_ptr, c_rows,
                         brick_size, mode="prolongate"):
    """Plain PyTorch version (a new tensor). x: the coarse bricks
    (prolongate) or the fine bricks (restrict)."""
    n = E.shape[-1]
    p, B, N3p = n - 1, brick_size, x.shape[1]
    dev = x.device
    if _mode(mode) == "prolongate":
        rows = p_rows.long()
        u = x.reshape(-1)[cell_nodes(src_lin[rows], B, p, N3p, dev)]
        u = embed_rows(u, E[rows], False)
        sel = (own[rows] & OWN) != 0
        out = torch.zeros((p_ptr.numel() - 1) * N3p, dtype=x.dtype, device=dev)
        out[cell_nodes(rows, B, p, N3p, dev)[sel]] = u[sel]
        return out.reshape(-1, N3p)
    rows = c_rows.long()
    u = x.reshape(-1)[cell_nodes(rows, B, p, N3p, dev)] * ((own[rows] & OWN_WEIGHTED) != 0)
    u = embed_rows(u, E[rows], True)
    n_ent = r_slot.numel()
    entry = torch.repeat_interleave(torch.arange(n_ent, device=dev),
                                    (c_ptr[1:] - c_ptr[:-1]).long())
    dim = E.shape[1]
    cell_rows = torch.zeros((n_ent, n**dim), dtype=x.dtype, device=dev).index_add_(0, entry, u)
    nb_c = r_ptr.shape[0]
    brick = torch.repeat_interleave(torch.arange(nb_c, device=dev),
                                    (r_ptr[:, -1] - r_ptr[:, 0]).long())
    nodes = cell_nodes(brick * B**dim + r_slot.long(), B, p, N3p, dev)
    out = torch.zeros(nb_c * N3p, dtype=x.dtype, device=dev)
    return out.index_add_(0, nodes.reshape(-1), cell_rows.reshape(-1)).reshape(nb_c, N3p)


_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def brick_transfer(x, src_lin, E, own, p_ptr, p_rows, r_ptr, r_slot, c_ptr, c_rows, brick_size,
                   mode="prolongate"):
    """prolongate: x the coarse bricks [nb_c, N3p] -> new fine bricks [nb_f,
    N3p] (nb_f = p_ptr.numel() - 1); restrict: x the fine bricks -> new
    coarse bricks [nb_c, N3p] (nb_c = r_ptr.shape[0]). E [nlin_f, dim, n, n]
    of x's dtype (dim 3, or 2 on 2-D bricks); own uint8 [nlin_f, n^dim]; the
    lists int32."""
    args = (x, src_lin, E, own, p_ptr, p_rows, r_ptr, r_slot, c_ptr, c_rows)
    restrict = _mode(mode) == "restrict"
    if x.device.type == "cpu":
        return brick_transfer_plain(*args, brick_size, mode=mode)
    names = ("x", "src_lin", "E", "own", "p_ptr", "p_rows", "r_ptr", "r_slot", "c_ptr", "c_rows")
    dev = _build.check_cuda(NAME, x.dtype, **dict(zip(names, args)))
    if any(t.dtype != torch.int32 for t in args[4:] + (src_lin,)) or own.dtype != torch.uint8:
        raise TypeError(f"{NAME}: the lists must be int32 and own uint8")
    n, dim = E.shape[-1], E.shape[1]
    p, B = n - 1, int(brick_size)
    nlin_f, C = src_lin.numel(), B**dim
    nb_f, nb_c = p_ptr.numel() - 1, r_ptr.shape[0]
    N3p = x.shape[1]
    if (p not in _build.BRICK_DEGREES.get(dim, ()) or E.shape != (nlin_f, dim, n, n)
            or own.shape != (nlin_f, n**dim) or nb_f * C != nlin_f
            or r_ptr.shape != (nb_c, 2**dim + 1) or x.dim() != 2
            or _build.brick_dim(NAME, B * p + 1, N3p) != dim
            or x.shape[0] != (nb_f if restrict else nb_c) or max(nb_f, nb_c) * N3p >= 2**31):
        raise ValueError(f"{NAME}: shapes x {tuple(x.shape)}, E {tuple(E.shape)}, own "
                         f"{tuple(own.shape)}, p_ptr {tuple(p_ptr.shape)}, r_ptr "
                         f"{tuple(r_ptr.shape)}")
    out = torch.empty((nb_c if restrict else nb_f, N3p), dtype=x.dtype, device=x.device)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(x.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, *(_build.ptr(t) for t in args), _build.ptr(out), nb_f, nb_c, p,
                  B, N3p, int(restrict), dim)
    brick_transfer.launches += 1
    return out


brick_transfer.launches = 0


def read_nodes(x, src_lin, E, own, p_ptr, p_rows, r_ptr, r_slot, c_ptr, c_rows, brick_size,
               mode="prolongate"):
    """The nodes of x (flat indices, ascending) that the function's output
    depends on: prolongate, the coarse cells' nodes of the rows that own a
    node; restrict, the fine nodes where bit 1 of own is set (W_f is 1)."""
    n = E.shape[-1]
    p, B, N3p = n - 1, brick_size, x.shape[1]
    if _mode(mode) == "prolongate":
        read = cell_nodes(src_lin[p_rows.long()], B, p, N3p, x.device)
    else:
        rows = c_rows.long()
        read = cell_nodes(rows, B, p, N3p, x.device)[(own[rows] & OWN_WEIGHTED) != 0]
    return torch.unique(read)


def bytes_and_flops(x, src_lin, E, own, p_ptr, p_rows, r_ptr, r_slot, c_ptr, c_rows,
                    brick_size, mode="prolongate"):
    """Least traffic: the input's nodes that the output depends on
    (``read_nodes``), read once; the output bricks written once (padding
    included); E, src_lin and own (at one bit a slot) of the rows used, and
    the mode's lists, read once.
    Operations: the dim sweeps of 2 n^(dim+1) a row (restrict: and an add a
    slot for the row sum and the overlap-add)."""
    n, dim = E.shape[-1], E.shape[1]
    N3p = x.shape[1]
    isz = x.element_size()
    if mode == "prolongate":
        rows = p_rows
        n_out = (p_ptr.numel() - 1) * N3p
        lists = src_lin.numel() + p_ptr.numel() + p_rows.numel()
    else:
        rows = c_rows
        n_out = r_ptr.shape[0] * N3p
        lists = r_ptr.numel() + r_slot.numel() + c_ptr.numel() + c_rows.numel()
    n_read = read_nodes(x, src_lin, E, own, p_ptr, p_rows, r_ptr, r_slot, c_ptr, c_rows,
                        brick_size, mode).numel()
    nbytes = ((n_read + n_out + len(rows) * dim * n * n) * isz + (len(rows) * n**dim + 7) // 8
              + 4 * lists)
    flops = len(rows) * (dim * 2 * n ** (dim + 1) + (2 * n**dim if mode == "restrict" else 0))
    return nbytes, flops
