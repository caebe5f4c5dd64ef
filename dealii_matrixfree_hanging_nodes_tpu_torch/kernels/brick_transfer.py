"""Kernel 16, ``brick_transfer``: the brick GMG's transfer between two levels
of global coarsening, from brick vector to brick vector. A fine brick-cell
row r (fine brick r // C, slot r % C, C = B^dim) is covered by the coarse
row src_lin[r] and embeds it with E[r] [dim, n, n] (x first); own[r, j]
bit 0 marks the one writer of each fine node (the smallest covering row),
bit 1 that writer where the fine level's dot mask W_f is 1 (``tables``).
dim is 3, or 2 on 2-D bricks (read from E's axis 1).

* prolongate (xc [nb_c, N3p] -> new [nb_f, N3p]): one block a fine brick,
  which takes its present rows (those that own a node) in rounds of a host
  schedule (``p_sched``, ``p_bround``): a round's distinct parent coarse
  cells (``p_par``) are read from the coarse bricks once into shared
  memory, every row of the round sweeps its parent (``p_slot``) along x,
  y(, z) at once, and the owned nodes are written into the brick; a node no
  row owns (holes) and the padding are 0. At 3-D p=4 a fine brick's rows
  (at most 64) and parents fit one round.
* restrict, its exact adjoint with W_f (rf [nb_f, N3p] -> new [nb_c,
  N3p]): a thread block cluster of 2^dim blocks a coarse brick, one block a
  parity class (``r_ptr`` [nb_c, 2^dim + 1]: its brick's cells in 2^dim
  parity classes, slots ``r_slot``). A block reads its class's fine rows
  (``c_ptr``, ``c_rows`` ascending a cell) times bit 1, as many at once as
  its shared memory holds, through the E^T sweeps along (z,) y, x, and sums
  each cell's rows in ascending order into a brick-sized accumulator of its
  own (the cells of a class share no node). After the cluster's barrier
  each block sums its share of the brick's nodes over the 2^dim
  accumulators in class order, through distributed shared memory, and
  stores it: every node sums from 0 in class order, then each cell's rows
  ascending, the plain version's order on the CPU.

The kernel's instances take B = ``bricks.auto_brick_size(p, dim)`` (the
only size the brick engine makes) as a compile-time constant.

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
# a block's dynamic shared memory on an H100, which sets the rows a round (csrc/brick_transfer.cu)
SMEM_BYTES = 232448 - 1024


def round_rows(dim, p, B, mode):
    """The most fine rows one round of a block takes (and in prolongate the
    most parents): as many as fit SMEM_BYTES in float64 beside the brick's
    accumulator, at most the C = B^dim rows of a brick. The host's copy of
    csrc/brick_transfer.cu's Cfg::PROWS, RROWS, which ``plan`` reads from
    the build (the card tests and chip_smoke.py hold the two equal; a round
    the host makes larger stops the kernel)."""
    n = p + 1
    NL, EL, C = n**dim, dim * n * n, B**dim
    N3p = -(-((B * p + 1) ** dim) // 128) * 128
    if mode == "restrict":  # and the class's cells' row pointers and first nodes
        fixed, per_row = 8 * C // 2**dim + 4, 8 * (NL + EL) + 8
    else:
        fixed, per_row = 0, 8 * (2 * NL + EL) + 16
    return min(C, (SMEM_BYTES - 8 * N3p - 4 * NL - fixed) // per_row)


def prolongate_schedule(rows, parent, C, nb_f, cap):
    """Rounds of the prolongation: rows (each fine row that owns a node) and
    its parent coarse row, -> (p_rows: the rows by fine brick, then parent,
    then ascending; p_par: each round's distinct parents; p_slot: each row's
    parent's position in its round's p_par; p_sched [n_rounds + 1, 2]: each
    round's first row and first parent; p_bround [nb_f + 1]: each fine
    brick's first round). A round holds whole parent groups, at most `cap`
    rows and `cap` parents (``round_rows``)."""
    rows, parent = np.asarray(rows, dtype=np.int64), np.asarray(parent, dtype=np.int64)
    brick = rows // C
    order = np.lexsort((rows, parent, brick))
    rows, parent, brick = rows[order], parent[order], brick[order]
    m = len(rows)
    start = np.ones(m, dtype=bool)
    start[1:] = (brick[1:] != brick[:-1]) | (parent[1:] != parent[:-1])
    g_first = np.nonzero(start)[0]  # parent groups: a brick's rows of one parent
    g_size = np.diff(np.append(g_first, m))
    if len(g_size) and g_size.max() > cap:
        raise ValueError(f"{NAME}: {g_size.max()} rows of one parent exceed a round's {cap}")
    g_brick = brick[g_first]
    g_round = np.empty(len(g_first), dtype=np.int64)
    r, cur, n_rows, n_par = -1, -1, 0, 0
    for g, (b, size) in enumerate(zip(g_brick.tolist(), g_size.tolist())):
        if b != cur or n_rows + size > cap or n_par + 1 > cap:
            r, cur, n_rows, n_par = r + 1, b, 0, 0
        n_rows, n_par = n_rows + size, n_par + 1
        g_round[g] = r
    n_rounds = r + 1
    first_group = np.searchsorted(g_round, np.arange(n_rounds + 1))
    row_start = np.append(g_first, m)[first_group]
    group = np.cumsum(start) - 1
    p_slot = group - first_group[g_round[group]]
    p_sched = np.stack([row_start, first_group], axis=1)
    p_bround = np.searchsorted(g_brick[first_group[:-1]], np.arange(nb_f + 1))
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    return (i32(rows), i32(parent[g_first]), i32(p_slot), i32(p_sched), i32(p_bround))


def tables(src_lin, own_w, wf, n_bricks_c, B, p, N3):
    """Host tables of both modes (NumPy, int32 / uint8) from the reference's
    ``src_lin`` [nlin_f], ``own_w`` [nlin_f, n_loc] (0/1) and the fine dot
    mask wf [nb_f, >= N3] (N3 = NB^dim, which gives the dimension): own
    (bit 0 own_w, bit 1 own_w * wf at the node), p_ptr / p_rows (each fine
    brick's rows that own a node, by parent), r_ptr [nb_c, 2^dim + 1] /
    r_slot (the coarse cells that cover such rows, by brick in 2^dim parity
    classes), c_ptr / c_rows (each listed coarse cell's rows, ascending),
    and the prolongation's rounds
    (``prolongate_schedule``: p_par, p_slot, p_sched, p_bround). A row that
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
    p_rows, p_par, p_slot, p_sched, p_bround = prolongate_schedule(
        rows, src_lin[rows], C, nb_f, round_rows(dim, p, B, "prolongate"))
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
    return dict(src_lin=i32(src_lin), own=own, p_ptr=p_ptr, p_rows=p_rows, r_ptr=i32(r_ptr),
                r_slot=i32(sl[eo]), c_ptr=i32(c_ptr), c_rows=i32(c_rows), p_par=p_par,
                p_slot=p_slot, p_sched=p_sched, p_bround=p_bround)


# the tables after x, E and own in the functions' arguments, in order (BrickTransfer.tables)
LISTS = ("p_ptr", "p_rows", "r_ptr", "r_slot", "c_ptr", "c_rows", "p_par", "p_slot", "p_sched",
         "p_bround")


def _mode(mode):
    if mode not in MODES:
        raise ValueError(f"{NAME}: unknown mode {mode!r}")
    return mode


def brick_transfer_plain(x, src_lin, E, own, p_ptr, p_rows, r_ptr, r_slot, c_ptr, c_rows,
                         p_par, p_slot, p_sched, p_bround, brick_size, mode="prolongate"):
    """Plain PyTorch version (a new tensor). x: the coarse bricks
    (prolongate) or the fine bricks (restrict). The prolongation's rounds
    (p_par, p_slot, p_sched, p_bround) are not read."""
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


_ARGS = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
_PROLONGATE_LISTS = ("p_rows", "p_sched", "p_bround", "p_par", "p_slot")
_RESTRICT_LISTS = ("r_ptr", "r_slot", "c_ptr", "c_rows")


def brick_transfer(x, src_lin, E, own, p_ptr, p_rows, r_ptr, r_slot, c_ptr, c_rows, p_par,
                   p_slot, p_sched, p_bround, brick_size, mode="prolongate"):
    """prolongate: x the coarse bricks [nb_c, N3p] -> new fine bricks [nb_f,
    N3p] (nb_f = p_ptr.numel() - 1); restrict: x the fine bricks -> new
    coarse bricks [nb_c, N3p] (nb_c = r_ptr.shape[0]). E [nlin_f, dim, n, n]
    of x's dtype (dim 3, or 2 on 2-D bricks); own uint8 [nlin_f, n^dim]; the
    lists int32 (``tables``); brick_size ``auto_brick_size(p, dim)``."""
    args = (x, src_lin, E, own, p_ptr, p_rows, r_ptr, r_slot, c_ptr, c_rows, p_par, p_slot,
            p_sched, p_bround)
    restrict = _mode(mode) == "restrict"
    if x.device.type == "cpu":
        return brick_transfer_plain(*args, brick_size, mode=mode)
    names = ("x", "src_lin", "E", "own") + LISTS
    tabs = dict(zip(names, args))
    dev = _build.check_cuda(NAME, x.dtype, **tabs)
    if any(tabs[k].dtype != torch.int32 for k in LISTS + ("src_lin",)) or own.dtype != torch.uint8:
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
            or p_bround.shape != p_ptr.shape or p_sched.dim() != 2 or p_sched.shape[1] != 2
            or r_slot.dim() != 1 or c_ptr.shape != (r_slot.numel() + 1,)
            or p_slot.shape != p_rows.shape
            or x.shape[0] != (nb_f if restrict else nb_c) or max(nb_f, nb_c) * N3p >= 2**31):
        raise ValueError(f"{NAME}: shapes x {tuple(x.shape)}, E {tuple(E.shape)}, own "
                         f"{tuple(own.shape)}, p_ptr {tuple(p_ptr.shape)}, r_ptr "
                         f"{tuple(r_ptr.shape)}, p_sched {tuple(p_sched.shape)}")
    out = torch.empty((nb_c if restrict else nb_f, N3p), dtype=x.dtype, device=x.device)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(x.dtype)}", _ARGS)
    ptrs = [_build.ptr(tabs[k]) for k in ("x", "E", "own") + _PROLONGATE_LISTS + _RESTRICT_LISTS]
    _build.launch(NAME, fn, dev, *ptrs, _build.ptr(out), nb_f, nb_c, p, B, N3p, int(restrict),
                  dim, None)
    brick_transfer.launches += 1
    return out


brick_transfer.launches = 0


def plan(dtype, p, dim, mode, device=None):
    """(threads, shared-memory bytes, blocks per SM, clusters resident at
    once, rows a round) of a launch at degree p in dim dimensions
    (prolongate: clusters 0; rows a round: the kernel's compiled constant,
    which ``round_rows`` mirrors); launches nothing."""
    info = (ctypes.c_int * 5)()
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(dtype)}", _ARGS)
    _build.launch(NAME, fn, torch.device("cuda") if device is None else device,
                  *([None] * 13), 0, 0, p, 0, 0, int(_mode(mode) == "restrict"), dim, info)
    return tuple(info)


def read_nodes(x, src_lin, E, own, p_ptr, p_rows, r_ptr, r_slot, c_ptr, c_rows, p_par, p_slot,
               p_sched, p_bround, brick_size, mode="prolongate"):
    """The nodes of x (flat indices, ascending) that the function's output
    depends on: prolongate, the coarse cells' nodes of the rows that own a
    node; restrict, the fine nodes where bit 1 of own is set (W_f is 1)."""
    n, B = E.shape[-1], brick_size
    p, N3p = n - 1, x.shape[1]
    if _mode(mode) == "prolongate":
        read = cell_nodes(src_lin[p_rows.long()], B, p, N3p, x.device)
    else:
        rows = c_rows.long()
        read = cell_nodes(rows, B, p, N3p, x.device)[(own[rows] & OWN_WEIGHTED) != 0]
    return torch.unique(read)


def bytes_and_flops(x, src_lin, E, own, p_ptr, p_rows, r_ptr, r_slot, c_ptr, c_rows, p_par,
                    p_slot, p_sched, p_bround, brick_size, mode="prolongate"):
    """Least traffic: the input's nodes that the output depends on
    (``read_nodes``), read once; the output bricks written once (padding
    included); E, src_lin and own (at one bit a slot) of the rows used, and
    the mode's lists (prolongate p_ptr, p_rows; restrict r_ptr, r_slot,
    c_ptr, c_rows), read once. The prolongation's rounds (p_par, p_slot,
    p_sched, p_bround) are the kernel's schedule, not the function's input:
    not counted.
    Operations: the dim sweeps of 2 n^(dim+1) a row (restrict: and an add a
    slot for the row sum and the overlap-add)."""
    args = (x, src_lin, E, own, p_ptr, p_rows, r_ptr, r_slot, c_ptr, c_rows, p_par, p_slot,
            p_sched, p_bround)
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
    n_read = read_nodes(*args, brick_size, mode=mode).numel()
    nbytes = ((n_read + n_out + len(rows) * dim * n * n) * isz + (len(rows) * n**dim + 7) // 8
              + 4 * lists)
    flops = len(rows) * (dim * 2 * n ** (dim + 1) + (2 * n**dim if mode == "restrict" else 0))
    return nbytes, flops
