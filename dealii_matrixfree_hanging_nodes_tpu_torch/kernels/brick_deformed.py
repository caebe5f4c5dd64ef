"""Kernel 19, ``brick_deformed``: the Laplace under a deformed (high-order)
mapping on every brick of a [n_bricks, N3p] vector,

    v_b = sum over the present cells c of brick b of E_c^T K_c E_c u_b,

K_c the cell's stiffness at its Gauss points with its packed metric
geo[b*B^3 + c] [n_q, 6] (``cell_laplace``'s deformed layout: w detJ J^-1
J^-T, components xx, xy, xz, yy, yz, zz), E_c the gather of the cell's
(p+1)^3 nodes from its brick; the present cells come as bits (present [nb,
ceil(B^3/32)] int32, bit s % 32 of word s // 32 for slot s). On the first m
bricks the overlap-add of their cell rows dcols [m*B^3, (p+1)^3] follows,
as brick_apply's epilogue adds them.

Replaces the reference's ``_deformed_brick_apply`` (bricks.py:2978-3032),
the block-diagonal quadrature sweeps over whole bricks with the metric on
the brick-quad lattice (zero at absent slots), which per cell is
``_deformed_cell_apply`` (2959-2976) summed over the present cells
(2985-2989), and in the epilogue ``_scatter_cols`` (2196-2241) with the
merge ``v.at[:n_sub].add(corr)`` (2553-2559). CUDA source:
``csrc/brick_deformed.cu`` (the quadrature in ``csrc/laplace_quad.cuh``)."""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .brick_apply import _rows_of, overlap_add_index
from .cell_apply import cell_nodes
from .cell_laplace import laplace_rows
from .refill_update import valid_mask

NAME = "brick_deformed"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:2978"
SUPPORTED = {(1, 16), (2, 8), (3, 4), (4, 4), (5, 2), (6, 2)}  # (p, B)


def present_cells(present, brick_size):
    """[n_present] brick-cell ids (brick * B^3 + slot) of the set bits, in
    order."""
    return torch.nonzero(valid_mask(present, brick_size**3).reshape(-1))[:, 0]


def brick_deformed_plain(bv, geo, present, S, Dc, dcols=None, brick_size=None):
    """Plain PyTorch version: the present cells' rows gathered from the
    bricks, their quadrature (``laplace_rows`` with their metric), one
    ``index_add_`` into a zero vector; then dcols, as brick_apply's plain
    version adds them."""
    B = int(brick_size)
    p = S.shape[1] - 1
    nb, N3p = bv.shape
    cells = present_cells(present, B)
    nodes = cell_nodes(cells, B, p, N3p, bv.device)
    rows = laplace_rows(bv.reshape(-1)[nodes], S, Dc, None, geo[cells])
    v = torch.zeros_like(bv)
    v.view(-1).index_add_(0, nodes.reshape(-1), rows.reshape(-1))
    if dcols is not None:
        m, _ = _rows_of(dcols, B, nb, N3p, 3)
        v.view(-1).index_add_(0, overlap_add_index(m, B, p, N3p, v.device), dcols.reshape(-1))
    return v


_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2


def brick_deformed(bv, geo, present, S, Dc, dcols=None, brick_size=None):
    """bv [nb, N3p], geo [nb*B^3, (p+1)^3, 6], present [nb, ceil(B^3/32)]
    int32, S, Dc [p+1, p+1], dcols [m*B^3, (p+1)^3] or None -> new v [nb,
    N3p] (the padded tail zero)."""
    if bv.device.type == "cpu":
        return brick_deformed_plain(bv, geo, present, S, Dc, dcols, brick_size)
    extra = {} if dcols is None else {"dcols": dcols}
    dev = _build.check_cuda(NAME, bv.dtype, bv=bv, geo=geo, present=present, S=S, Dc=Dc,
                            **extra)
    B, p = int(brick_size), S.shape[1] - 1
    nb, N3p = bv.shape if bv.dim() == 2 else (-1, -1)
    n_loc, C = (p + 1) ** 3, B**3
    if ((p, B) not in SUPPORTED or S.shape != (p + 1, p + 1) or Dc.shape != S.shape
            or geo.shape != (nb * C, n_loc, 6) or present.shape != (nb, -(-C // 32))
            or present.dtype != torch.int32 or N3p < (B * p + 1) ** 3):
        raise ValueError(f"{NAME}: shapes bv {tuple(bv.shape)}, geo {tuple(geo.shape)}, present "
                         f"{tuple(present.shape)}, S {tuple(S.shape)} at B={B}")
    m = 0
    if dcols is not None:
        m, pc = _rows_of(dcols, B, nb, N3p, 3)
        if pc != p:
            raise ValueError(f"{NAME}: dcols of p={pc} for p={p}")
    out = torch.empty_like(bv)
    ptrs = (ctypes.c_void_p * 6)(*(None if t is None else t.data_ptr()
                                   for t in (bv, geo, present, S, Dc, dcols)))
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(bv.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, ptrs, _build.ptr(out), nb, m, p, B, N3p, None)
    brick_deformed.launches += 1
    return out


brick_deformed.launches = 0


def plan(dtype, p, B, device=None):
    """(threads, shared-memory bytes, blocks per SM) of a launch at degree p,
    brick size B; launches nothing."""
    info = (ctypes.c_int * 3)()
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(dtype)}", _ARGS)
    _build.launch(NAME, fn, torch.device("cuda") if device is None else device,
                  (ctypes.c_void_p * 6)(), None, 1, 0, p, B, 0, info)
    return tuple(info)


def bytes_and_flops(bv, geo, present, S, Dc, dcols=None, brick_size=None):
    """Least traffic: u's NB^3 nodes read once, v with its padding written
    once, the metric of the present cells, the bits, S and Dc, and the
    cell rows. Operations: per present cell 12 sweeps of 2 n^4 and 15 a
    point; one add a node entry of a cell into the brick; one a cell-row
    entry."""
    B, n = int(brick_size), S.shape[1]
    nb, N3p = bv.shape
    n_cells = int(present_cells(present, B).numel())
    n_loc, NB = n**3, B * (n - 1) + 1
    n_rows = 0 if dcols is None else dcols.numel()
    nbytes = ((nb * NB**3 + nb * N3p + n_cells * n_loc * 6 + 2 * n * n + n_rows)
              * bv.element_size() + 4 * present.numel())
    flops = n_cells * (12 * 2 * n**4 + 16 * n_loc) + n_rows
    return nbytes, flops
