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

2-D bricks (rows of NB^2 nodes, B^2 cells of (p+1)^2 values, B = 16 at
p <= 3 and 8 at p = 4..6): the metric packs 3 values a point (xx, xy, yy),
the present bits cover B^2 slots; the dimension is read from the row width
(``_build.brick_dim``).

Replaces the reference's ``_deformed_brick_apply`` (bricks.py:2978-3032,
2-D branch 3009-3020), the block-diagonal quadrature sweeps over whole
bricks with the metric on the brick-quad lattice (zero at absent slots),
which per cell is ``_deformed_cell_apply`` (2959-2976) summed over the
present cells (2985-2989), and in the epilogue ``_scatter_cols``
(2196-2241) with the merge ``v.at[:n_sub].add(corr)`` (2553-2559). CUDA
source: ``csrc/brick_deformed.cu`` (the column phases in
``csrc/laplace_cols.cuh``, shared with ``cell_laplace``). The kernel owns a
z-column of a cell a thread (2-D: a y-column) and computes the same
operator with D = Dc S, every sweep even-odd: the even-odd splits of S, D
and their transposes (``_even_odd.factor_tables``,
``BrickLaplaceMM.kernel_factors``) travel as the launch's parameters
(``factors=``, required on the card). The plain version runs the
collocation form."""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._even_odd import check_factors
from .brick_apply import _rows_of, overlap_add_index
from .cell_apply import cell_nodes
from .cell_laplace import laplace_rows
from .refill_update import valid_mask

NAME = "brick_deformed"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:2978"
# (p, B, dim) of the kernel's instances: the brick size rule's, 3-D (B = 16, 8, 4, 4, 2, 2 at
# p = 1..6) and 2-D (B = 16 at p = 1..3, 8 at p = 4..6)
SUPPORTED = ({(1, 16, 3), (2, 8, 3), (3, 4, 3), (4, 4, 3), (5, 2, 3), (6, 2, 3)}
             | {(1, 16, 2), (2, 16, 2), (3, 16, 2), (4, 8, 2), (5, 8, 2), (6, 8, 2)})


def present_cells(present, C):
    """[n_present] brick-cell ids (brick * C + slot) of the set bits, in
    order; C = B^dim cell slots a brick."""
    return torch.nonzero(valid_mask(present, C).reshape(-1))[:, 0]


def brick_deformed_plain(bv, geo, present, S, Dc, dcols=None, brick_size=None, factors=None):
    """Plain PyTorch version: the present cells' rows gathered from the
    bricks, their quadrature (``laplace_rows`` with their metric), one
    ``index_add_`` into a zero vector; then dcols, as brick_apply's plain
    version adds them. It reads S and Dc, and takes the kernel's factors
    only to share the wrapper's signature."""
    B = int(brick_size)
    p = S.shape[1] - 1
    nb, N3p = bv.shape
    dim = _build.brick_dim(NAME, B * p + 1, N3p)
    cells = present_cells(present, B**dim)
    v = torch.zeros_like(bv)
    if cells.numel():  # a distributed rank's slab may hold pad rows alone
        nodes = cell_nodes(cells, B, p, N3p, bv.device)
        rows = laplace_rows(bv.reshape(-1)[nodes], S, Dc, None, geo[cells], dim)
        v.view(-1).index_add_(0, nodes.reshape(-1), rows.reshape(-1))
    if dcols is not None:
        m, _ = _rows_of(dcols, B, nb, N3p, dim)
        v.view(-1).index_add_(0, overlap_add_index(m, B, p, N3p, v.device), dcols.reshape(-1))
    return v


_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                                      ctypes.c_void_p]
_PTRS = 7  # u, geo, present, S, Dc, dcols (device), the factors (host)


def brick_deformed(bv, geo, present, S, Dc, dcols=None, brick_size=None, factors=None):
    """bv [nb, N3p], geo [nb*B^3, (p+1)^3, 6], present [nb, ceil(B^3/32)]
    int32, S, Dc [p+1, p+1], dcols [m*B^3, (p+1)^3] or None -> new v [nb,
    N3p] (the padded tail zero). 2-D: geo [nb*B^2, (p+1)^2, 3], present [nb,
    ceil(B^2/32)], dcols [m*B^2, (p+1)^2]. factors: the kernel's launch
    parameters, ``factor_tables(S, Dc)`` (float64 NumPy,
    ``BrickLaplaceMM.kernel_factors``), required on the card."""
    if bv.device.type == "cpu":
        return brick_deformed_plain(bv, geo, present, S, Dc, dcols, brick_size)
    extra = {} if dcols is None else {"dcols": dcols}
    dev = _build.check_cuda(NAME, bv.dtype, bv=bv, geo=geo, present=present, S=S, Dc=Dc,
                            **extra)
    B, p = int(brick_size), S.shape[1] - 1
    if bv.dim() != 2:
        raise ValueError(f"{NAME}: bv must be [nb, N3p], got {tuple(bv.shape)}")
    nb, N3p = bv.shape
    dim = _build.brick_dim(NAME, B * p + 1, N3p)
    n_loc, C = (p + 1) ** dim, B**dim
    if ((p, B, dim) not in SUPPORTED or S.shape != (p + 1, p + 1) or Dc.shape != S.shape
            or geo.shape != (nb * C, n_loc, dim * (dim + 1) // 2)
            or present.shape != (nb, -(-C // 32)) or present.dtype != torch.int32):
        raise ValueError(f"{NAME}: shapes bv {tuple(bv.shape)}, geo {tuple(geo.shape)}, present "
                         f"{tuple(present.shape)}, S {tuple(S.shape)} at B={B}, {dim}-D")
    m = 0
    if dcols is not None:
        m, pc = _rows_of(dcols, B, nb, N3p, dim)
        if pc != p:
            raise ValueError(f"{NAME}: dcols of p={pc} for p={p}")
    if dim == 3 and geo.data_ptr() % (2 * geo.element_size()):
        raise ValueError(f"{NAME}: the 3-D kernel reads the metric in aligned pairs; geo starts "
                         f"{geo.data_ptr() % 16} bytes past a 16-byte boundary")
    check_factors(NAME, factors, p + 1)
    out = torch.empty_like(bv)
    ptrs = (ctypes.c_void_p * _PTRS)(*(None if t is None else t.data_ptr()
                                       for t in (bv, geo, present, S, Dc, dcols)),
                                     factors.ctypes.data)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(bv.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, ptrs, _build.ptr(out), nb, m, p, B, N3p, None, dim)
    brick_deformed.launches += 1
    return out


brick_deformed.launches = 0


def plan(dtype, p, B, dim, device=None):
    """(threads, shared-memory bytes, blocks per SM) of a launch at degree p,
    brick size B, in dim dimensions; launches nothing."""
    info = (ctypes.c_int * 3)()
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(dtype)}", _ARGS)
    _build.launch(NAME, fn, torch.device("cuda") if device is None else device,
                  (ctypes.c_void_p * _PTRS)(), None, 1, 0, p, B, 0, info, dim)
    return tuple(info)


def bytes_and_flops(bv, geo, present, S, Dc, dcols=None, brick_size=None):
    """Least traffic: u's NB^3 nodes read once, v with its padding written
    once, the metric of the present cells, the bits, S and Dc, and the
    cell rows. Operations: per present cell 12 sweeps of 2 n^4 and 15 a
    point (2-D: 8 sweeps of 2 n^3 and 7 a point); one add a node entry of a
    cell into the brick; one a cell-row entry."""
    B, n = int(brick_size), S.shape[1]
    nb, N3p = bv.shape
    NB = B * (n - 1) + 1
    dim = _build.brick_dim(NAME, NB, N3p)
    n_cells = int(present_cells(present, B**dim).numel())
    n_loc = n**dim
    n_rows = 0 if dcols is None else dcols.numel()
    nbytes = ((nb * NB**dim + nb * N3p + n_cells * n_loc * dim * (dim + 1) // 2 + 2 * n * n
               + n_rows) * bv.element_size() + 4 * present.numel())
    per_cell = 12 * 2 * n**4 + 16 * n_loc if dim == 3 else 8 * 2 * n**3 + 8 * n_loc
    return nbytes, n_cells * per_cell + n_rows
