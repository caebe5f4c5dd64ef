"""Kernel 3, ``cols_overlap_add``: add per-cell rows back into their bricks,
v[b, node] += sum of cols[(b, slot), j] over the 1-8 (cell slot, local
node) pairs that sit on that node — in place on v [m, N3p], cols
[m*B^3, (p+1)^3].

Replaces the reference's ``_scatter_cols`` / ``_col2im_sep`` overlap-add
(bricks.py:2196-2241) together with the merge into the leading subset
slice ``v.at[:n_sub].add(corr)`` (bricks.py:2082-2083, 2553-2559).
CUDA source: ``csrc/cols_overlap_add.cu``."""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .cell_apply import brick_slot_index

NAME = "cols_overlap_add"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:2196"


def _check_shapes(v, cols, B):
    n_loc = cols.shape[1]
    p = round(n_loc ** (1.0 / 3.0)) - 1
    m = v.shape[0]
    if (p + 1) ** 3 != n_loc or cols.shape[0] != m * B**3 or v.shape[1] < (B * p + 1) ** 3:
        raise ValueError(f"{NAME}: shapes v {tuple(v.shape)}, cols {tuple(cols.shape)}, B={B}")
    return p


def overlap_add_index(m, B, p, N3p, device=None):
    """Flat index into v [m, N3p] of every entry of cols [m*B^3, n_loc]."""
    idx = brick_slot_index(B, p, device).reshape(-1)
    return (torch.arange(m, device=device)[:, None] * N3p + idx[None, :]).reshape(-1)


def cols_overlap_add_plain(v, cols, brick_size):
    """Plain PyTorch version: one ``index_add_`` of every cols entry into
    its brick node. Adds into v (contiguous) in place and returns it."""
    p = _check_shapes(v, cols, brick_size)
    idx = overlap_add_index(v.shape[0], brick_size, p, v.shape[1], v.device)
    v.view(-1).index_add_(0, idx, cols.reshape(-1))
    return v


_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def cols_overlap_add(v, cols, brick_size):
    """v [m, N3p] += overlap-add of cols [m*B^3, n_loc]; in place, returns v."""
    if v.device.type == "cpu":
        return cols_overlap_add_plain(v, cols, brick_size)
    dev = _build.check_cuda(NAME, v.dtype, v=v, cols=cols)
    p = _check_shapes(v, cols, brick_size)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(v.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(v), _build.ptr(cols), v.shape[0],
                  int(brick_size), p, v.shape[1])
    cols_overlap_add.launches += 1
    return v


cols_overlap_add.launches = 0


def bytes_and_flops(m, B, p, N3p, itemsize):
    """Least traffic: cols read once, v read and written once (its N3
    nodes); one add per cols entry."""
    NB = B * p + 1
    n_cols = m * B**3 * (p + 1) ** 3
    return (n_cols + 2 * m * NB**3) * itemsize, n_cols
