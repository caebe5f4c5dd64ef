"""Kernel 11, ``plane_fold``: the face-plane fold of the degree <= 2 schedule,
in place on v [nb, N3p], the transpose of ``plane_fill``'s map. Every target
node tgt[t] (flat brick * N3p + node; no target is covered) adds

    sum of w[e] * v_flat[src[e]] over e = ptr[t] .. ptr[t+1]   (src covered, ascending)

and then every covered node cov[k] becomes 0 (reduced outputs). Each target
has one owner that sums its entries in a fixed order: a coarse node on the
boundary of the quarter faces that fold into it gets the 2-4 of them
without atomics. Two launches: the sums read the covered nodes that the
second zeroes.

Replaces the reference's ``_plane_corr`` (bricks.py:3104-3167): per level,
fine level first, the covered fine face nodes through P1^T into the coarse
quarter face (a scatter-add with repeated ids) and zeroed; the host
composes the levels into one map (``bricks._plane_tables``).
CUDA source: ``csrc/plane_fold.cu``."""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .plane_fill import segment_sums

NAME = "plane_fold"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:3104"
LAUNCHES = 2  # the sums, then the zeros


def plane_fold_plain(v, tgt, ptr, src, w, cov):
    """Plain PyTorch version: the targets' sums added, then the covered
    nodes zeroed. Updates v in place and returns it."""
    flat = v.view(-1)
    flat[tgt.long()] += segment_sums(flat, ptr, src, w)
    flat[cov.long()] = 0.0
    return v


_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def plane_fold(v, tgt, ptr, src, w, cov):
    """v [nb, N3p] (updated in place and returned); tgt [n_t], ptr
    [n_t+1], src, cov int32; w of v's dtype."""
    if v.device.type == "cpu":
        return plane_fold_plain(v, tgt, ptr, src, w, cov)
    dev = _build.check_cuda(NAME, v.dtype, v=v, tgt=tgt, ptr=ptr, src=src, w=w, cov=cov)
    if any(t.dtype != torch.int32 for t in (tgt, ptr, src, cov)):
        raise TypeError(f"{NAME}: tgt, ptr, src and cov must be int32")
    if ptr.shape != (tgt.numel() + 1,) or src.shape != w.shape or v.numel() > 2**31 - 1:
        raise ValueError(f"{NAME}: shapes tgt {tuple(tgt.shape)}, ptr {tuple(ptr.shape)}, "
                         f"src {tuple(src.shape)}, w {tuple(w.shape)}")
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(v.dtype)}", _ARGS)
    for mode in range(LAUNCHES):
        _build.launch(NAME, fn, dev, _build.ptr(v), _build.ptr(tgt), _build.ptr(ptr),
                      _build.ptr(src), _build.ptr(w), _build.ptr(cov), tgt.numel(), cov.numel(),
                      mode)
        plane_fold.launches += 1
    return v


plane_fold.launches = 0


def bytes_and_flops(v, tgt, ptr, src, w, cov):
    """Least traffic: each target read and written once, each covered node
    read once and written once (its zero), the tables read once; a
    multiply and an add per entry."""
    nbytes = (2 * tgt.numel() + 2 * cov.numel() + w.numel()) * v.element_size() + 4 * (
        tgt.numel() + ptr.numel() + src.numel() + cov.numel())
    return nbytes, 2 * src.numel()
