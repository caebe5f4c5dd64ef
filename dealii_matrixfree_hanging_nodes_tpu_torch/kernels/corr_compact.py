"""Kernel 7, ``corr_compact``: the compact fold chain and the sparse delta of
the subset cell rows. With acc[r, j] the sum of sub_raw_flat[src] over the
entries of (r, j), every row r of dcols [n_sub*B^3, n_loc] is

    cell_code[r] = h >= 0 (constrained row h):
        keep[h, j] ? (sub_raw[h, j] + acc[r, j]) - plain[r, j] : -plain[r, j]
    cell_code[r] = -2 (absent cell):      -plain[r, j]
    otherwise (fold targets, the rest):   acc[r, j]

Replaces the reference's ``_corr_compact`` (bricks.py:2775-2849) with the
``plain_rows[hn_sub]`` gather before it (bricks.py:2465): stage-1 one-hot
transfer matmuls, the scatter-adds into the hn and non-hn rows, the tails
on ``sub_raw + acc``, the keep mask and ``final - plain``. As for the fill,
``bricks.kernel_tables`` composes the stages on the host into the lists
(row_ptr [n_sub*B^3 + 1], ent_slot, ent_src int32, ent_src a flat index
into sub_raw). CUDA source: ``csrc/corr_compact.cu``."""

from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "corr_compact"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:2775"


def gather_sums(src_flat, row_ptr, ent_slot, ent_src, n_loc):
    """[n_rows, n_loc] sums of src_flat[ent_src] by (row, slot): the
    entries' part, summed in entry order (shared with the fill's plain
    version, ``hn_cell.fill_hn_plain``)."""
    n_rows = row_ptr.numel() - 1
    rows = torch.repeat_interleave(torch.arange(n_rows, device=src_flat.device),
                                   (row_ptr[1:] - row_ptr[:-1]).long())
    acc = torch.zeros(n_rows * n_loc, dtype=src_flat.dtype, device=src_flat.device)
    acc.index_add_(0, rows * n_loc + ent_slot.long(), src_flat[ent_src.long()])
    return acc.view(n_rows, n_loc)


def corr_compact_plain(plain, sub_raw, cell_code, keep, row_ptr, ent_slot, ent_src):
    """Plain PyTorch version on the same lists: the entries' sums, then
    the constrained and absent rows written over them."""
    n_loc = plain.shape[1]
    dcols = gather_sums(sub_raw.reshape(-1), row_ptr, ent_slot, ent_src, n_loc)
    absent = torch.nonzero(cell_code == -2)[:, 0]
    dcols[absent] = -plain[absent]
    hn = torch.nonzero(cell_code >= 0)[:, 0]
    h = cell_code[hn].long()
    dcols[hn] = torch.where(keep[h], (sub_raw[h] + dcols[hn]) - plain[hn], -plain[hn])
    return dcols


_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def corr_compact(plain, sub_raw, cell_code, keep, row_ptr, ent_slot, ent_src):
    """plain [n_rows, n_loc], sub_raw [n_hn, n_loc]; cell_code [n_rows],
    row_ptr [n_rows+1], ent_slot, ent_src int32; keep [n_hn, n_loc] bool
    -> new dcols [n_rows, n_loc]."""
    if plain.device.type == "cpu":
        return corr_compact_plain(plain, sub_raw, cell_code, keep, row_ptr, ent_slot, ent_src)
    dev = _build.check_cuda(NAME, plain.dtype, plain=plain, sub_raw=sub_raw,
                            cell_code=cell_code, keep=keep, row_ptr=row_ptr,
                            ent_slot=ent_slot, ent_src=ent_src)
    n_rows, n_loc = plain.shape
    if any(t.dtype != torch.int32 for t in (cell_code, row_ptr, ent_slot, ent_src)):
        raise TypeError(f"{NAME}: cell_code, row_ptr, ent_slot and ent_src must be int32")
    if (keep.dtype != torch.bool or keep.shape != sub_raw.shape or sub_raw.shape[1:] != (n_loc,)
            or cell_code.shape != (n_rows,) or row_ptr.shape != (n_rows + 1,)
            or ent_slot.shape != ent_src.shape):
        raise ValueError(f"{NAME}: shapes plain {tuple(plain.shape)}, sub_raw "
                         f"{tuple(sub_raw.shape)}, row_ptr {tuple(row_ptr.shape)}")
    out = torch.empty_like(plain)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(plain.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(plain), _build.ptr(sub_raw), _build.ptr(cell_code),
                  _build.ptr(keep), _build.ptr(row_ptr), _build.ptr(ent_slot),
                  _build.ptr(ent_src), _build.ptr(out), n_rows, n_loc)
    corr_compact.launches += 1
    return out


corr_compact.launches = 0


def bytes_and_flops(plain, sub_raw, cell_code, row_ptr, ent_src):
    """Least traffic: sub_raw read once, plain read at the constrained and
    absent rows only, dcols written once, cell_code, the keep mask (one bit
    a slot) and the lists read once; an add per entry and two operations
    per constrained slot."""
    n_rows, n_loc = plain.shape
    n_read_plain = int((cell_code != -1).sum()) * n_loc
    n_ent = ent_src.numel()
    nbytes = ((sub_raw.numel() + n_read_plain + n_rows * n_loc) * plain.element_size()
              + (sub_raw.numel() + 7) // 8 + 4 * (n_rows + row_ptr.numel() + 2 * n_ent))
    return nbytes, n_ent + 2 * sub_raw.numel()
