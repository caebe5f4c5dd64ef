"""Kernel 5, ``hn_apply``: the hanging-node interpolation on the constrained
rows, out[r] = rows[r] @ Q (forward, the fill) or rows[r] @ Q^T (transposed,
HN^T), with one composite Q per mask range (rows of an identity range pass
through).

Replaces the reference's ``_hn_apply`` (bricks.py:2244-2258), which runs one
dense [n_loc, n_loc] matmul per mask range. Each Q holds a few hundred
nonzeros of n_loc^2 (389 of 15,625 for a face mask at p=4), so the port
keeps them as per-output-slot lists (``bricks.kernel_tables``): q [n_hn]
the row's Q (-1: identity), ptr [nQ, n_loc+1] int32 into col int32 and w.
CUDA source: ``csrc/hn_apply.cu``."""

from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "hn_apply"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:2244"


def hn_apply_plain(rows, q, ptr, col, w):
    """Plain PyTorch version on the same lists: for each Q, gather the
    weighted inputs of every entry and sum them by output slot."""
    out = rows.clone()
    n_loc = rows.shape[1]
    for qi in range(ptr.shape[0]):
        sel = torch.nonzero(q == qi)[:, 0]
        if not sel.numel():
            continue
        e0, e1 = int(ptr[qi, 0]), int(ptr[qi, -1])
        slot = torch.repeat_interleave(torch.arange(n_loc, device=rows.device),
                                       (ptr[qi, 1:] - ptr[qi, :-1]).long())
        vals = rows[sel][:, col[e0:e1].long()] * w[e0:e1]
        out[sel] = torch.zeros((len(sel), n_loc), dtype=rows.dtype,
                               device=rows.device).index_add_(1, slot, vals)
    return out


_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def hn_apply(rows, q, ptr, col, w):
    """rows [n_hn, n_loc]; q [n_hn], ptr [nQ, n_loc+1], col int32; w of the
    rows' dtype -> new [n_hn, n_loc] tensor."""
    if rows.device.type == "cpu":
        return hn_apply_plain(rows, q, ptr, col, w)
    dev = _build.check_cuda(NAME, rows.dtype, rows=rows, q=q, ptr=ptr, col=col, w=w)
    n_hn, n_loc = rows.shape
    if any(t.dtype != torch.int32 for t in (q, ptr, col)):
        raise TypeError(f"{NAME}: q, ptr and col must be int32")
    if q.shape != (n_hn,) or ptr.dim() != 2 or ptr.shape[1] != n_loc + 1 or col.shape != w.shape:
        raise ValueError(f"{NAME}: q [{n_hn}], ptr [nQ, {n_loc + 1}], col and w [nnz]")
    out = torch.empty_like(rows)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(rows.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(rows), _build.ptr(q), _build.ptr(ptr),
                  _build.ptr(col), _build.ptr(w), _build.ptr(out), n_hn, n_loc)
    hn_apply.launches += 1
    return out


hn_apply.launches = 0


def bytes_and_flops(q, ptr, col, n_loc, itemsize):
    """Least traffic: rows read once, out written once, the lists read
    once; a multiply and an add per nonzero of each row's Q."""
    n_hn = q.numel()
    nnz = ptr[:, -1] - ptr[:, 0]
    per_row = torch.where(q >= 0, nnz[q.long().clamp(min=0)], 0)
    nbytes = (2 * n_hn * n_loc + col.numel()) * itemsize + 4 * (n_hn + ptr.numel() + col.numel())
    return nbytes, 2 * int(per_row.sum())
