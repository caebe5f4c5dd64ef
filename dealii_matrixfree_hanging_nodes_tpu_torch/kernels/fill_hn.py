"""Kernel 6, ``fill_hn``: the compact fill chain on the constrained rows.
Row h is cell hn_sub[h] of the subset bricks u_sub [n_sub, N3p]:

    out[h, j] = (keep[h, j] ? u(cell, j) : 0) + sum of u_flat[src] over the
                entries of (h, j)

where the entries are the master nodes that the chain copies into slot j.

Replaces the reference's ``_fill_hn_compact`` (bricks.py:2728-2773) fed by
``_extract_cols``: the masked gather of the constrained rows, the stage-1
one-hot transfer matmuls, their scatter-add and the tail stages. The chain
is linear in u and its transfers are 0/1 partial permutations, so
``bricks.kernel_tables`` composes every stage on the host into these lists
(row_ptr [n_hn+1] into entries sorted by (row, slot); ent_slot, ent_src
int32, ent_src a flat index into u_sub). CUDA source: ``csrc/fill_hn.cu``."""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .cell_apply import brick_slot_index

NAME = "fill_hn"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:2728"


def gather_sums(src_flat, row_ptr, ent_slot, ent_src, n_loc):
    """[n_rows, n_loc] sums of src_flat[ent_src] by (row, slot): the
    entries' part, summed in entry order (shared with corr_compact)."""
    n_rows = row_ptr.numel() - 1
    rows = torch.repeat_interleave(torch.arange(n_rows, device=src_flat.device),
                                   (row_ptr[1:] - row_ptr[:-1]).long())
    acc = torch.zeros(n_rows * n_loc, dtype=src_flat.dtype, device=src_flat.device)
    acc.index_add_(0, rows * n_loc + ent_slot.long(), src_flat[ent_src.long()])
    return acc.view(n_rows, n_loc)


def cell_nodes(cells, brick_size, p, N3p, device):
    """[len(cells), n_loc] flat index into [*, N3p] bricks of each cell's nodes."""
    C = brick_size**3
    cells = cells.long()
    return (cells // C)[:, None] * N3p + brick_slot_index(brick_size, p, device)[cells % C]


def fill_hn_plain(u_sub, hn_sub, keep, row_ptr, ent_slot, ent_src, brick_size):
    """Plain PyTorch version on the same lists: masked gather, then the
    entries' sums added."""
    n_loc = keep.shape[1]
    p = round(n_loc ** (1.0 / 3.0)) - 1
    flat = u_sub.reshape(-1)
    base = torch.where(keep, flat[cell_nodes(hn_sub, brick_size, p, u_sub.shape[1],
                                             u_sub.device)], 0.0)
    return base + gather_sums(flat, row_ptr, ent_slot, ent_src, n_loc)


_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def fill_hn(u_sub, hn_sub, keep, row_ptr, ent_slot, ent_src, brick_size):
    """u_sub [n_sub, N3p]; hn_sub [n_hn], row_ptr [n_hn+1], ent_slot and
    ent_src int32; keep [n_hn, n_loc] bool -> new [n_hn, n_loc] tensor."""
    if u_sub.device.type == "cpu":
        return fill_hn_plain(u_sub, hn_sub, keep, row_ptr, ent_slot, ent_src, brick_size)
    dev = _build.check_cuda(NAME, u_sub.dtype, u_sub=u_sub, hn_sub=hn_sub, keep=keep,
                            row_ptr=row_ptr, ent_slot=ent_slot, ent_src=ent_src)
    n_hn, n_loc = keep.shape
    B, p = int(brick_size), round(n_loc ** (1.0 / 3.0)) - 1
    if any(t.dtype != torch.int32 for t in (hn_sub, row_ptr, ent_slot, ent_src)):
        raise TypeError(f"{NAME}: hn_sub, row_ptr, ent_slot and ent_src must be int32")
    if (keep.dtype != torch.bool or (p + 1) ** 3 != n_loc or hn_sub.shape != (n_hn,)
            or row_ptr.shape != (n_hn + 1,) or ent_slot.shape != ent_src.shape
            or u_sub.dim() != 2 or u_sub.shape[1] < (B * p + 1) ** 3):
        raise ValueError(f"{NAME}: shapes u_sub {tuple(u_sub.shape)}, keep "
                         f"{tuple(keep.shape)}, row_ptr {tuple(row_ptr.shape)}")
    out = torch.empty((n_hn, n_loc), dtype=u_sub.dtype, device=u_sub.device)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(u_sub.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(u_sub), _build.ptr(hn_sub), _build.ptr(keep),
                  _build.ptr(row_ptr), _build.ptr(ent_slot), _build.ptr(ent_src),
                  _build.ptr(out), n_hn, p, B, u_sub.shape[1])
    fill_hn.launches += 1
    return out


fill_hn.launches = 0


def bytes_and_flops(u_sub, hn_sub, keep, row_ptr, ent_src, brick_size):
    """Least traffic: each distinct brick node the rows read (kept own
    nodes and entry sources) read once, out written once, the keep mask
    at one bit a slot, hn_sub and the lists read once; one add per entry."""
    n_hn, n_loc = keep.shape
    p = round(n_loc ** (1.0 / 3.0)) - 1
    own = cell_nodes(hn_sub, brick_size, p, u_sub.shape[1], u_sub.device)[keep]
    n_read = torch.unique(torch.cat([own, ent_src.long()])).numel()
    n_ent = ent_src.numel()
    nbytes = ((n_read + n_hn * n_loc) * u_sub.element_size() + (keep.numel() + 7) // 8
              + 4 * (n_hn + row_ptr.numel() + 2 * n_ent))
    return nbytes, n_ent
