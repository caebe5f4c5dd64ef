"""Kernel 2, ``cell_apply``: the local stiffness on cell rows, out[r] =
scale[r] * (K x_r), with K the Kronecker sum of the 1-D factors K1 and M1
(``K1⊗M1⊗M1 + M1⊗K1⊗M1 + M1⊗M1⊗K1``, x fastest), applied by sum
factorization. The kernel reads x_r, the (p+1)^3 nodes of cell r, from its
brick (``brick_size=B``): src [m, N3p] -> out [m*B^3, n_loc] — the
reference's ``_extract_cols`` (bricks.py:2178-2194) fused with ``cols @ K.T
* geo_cell_sub`` (bricks.py:2449-2453). The plain version also takes rows
(``brick_size=None``): src [m, n_loc] -> out [m, n_loc] — the reference's
``u_hat @ K.T * geo_cell_sub[hn_sub]`` (bricks.py:2469-2471), which on the
card runs inside ``hn_cell``.

With a right-hand-side axis (``BrickLaplaceMM.vmult_multi``: src [k, m,
N3p] with any stride between its RHS, the subset view ``bvk[:, :n_sub]``)
each RHS goes through the same factors in one launch (grid.y): out [k,
m*B^3, n_loc], each RHS bit-identical to a call on it alone (the
reference's ``_extract_cols`` and ``cols_u @ K.T * geo`` on the k-major
layout, bricks.py:3470-3477).

The deformed mode (``deformed=(S, Dc, geo)``, a deformed mapping; K1, M1
and scale unread) replaces K by each row's own stiffness at its Gauss
points: the sweeps of S and Dc with the packed metric geo [m*B^3, n_q, 6]
of the rows (zero at absent slots, whose rows come out exact zeros), no
scale (``cell_laplace``'s ``laplace_rows``): the reference's
``_deformed_cell_apply(cols_u, Gq_sub)`` (bricks.py:2444-2447, 2959-2976).
One RHS only; in 2-D the metric [m*B^2, n_q, 3] (xx, xy, yy).

2-D bricks (rows of NB^2 nodes, B^2 cells of (p+1)^2 values, p = 1..3 at
B = 16, 4..6 at B = 8): K = M1⊗K1 + K1⊗M1, two sweeps; the dimension is
read from the row width (``_build.brick_dim``) or, for rows, their width.
The instances at p <= 3 serve the distributed brick step (its subset's
plain rows at every degree).

CUDA source: ``csrc/cell_apply.cu`` (the sweeps in
``csrc/sum_factorization.cuh``, shared with ``hn_cell``; the deformed
mode's in ``csrc/laplace_quad.cuh``)."""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .cell_laplace import laplace_rows

NAME = "cell_apply"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:2178"


def cell_degree(K1) -> int:
    if K1.dim() != 2 or K1.shape[0] != K1.shape[1] or K1.shape[0] < 2:
        raise ValueError(f"K1 must be [p+1, p+1], got {tuple(K1.shape)}")
    return K1.shape[0] - 1


def brick_slot_index(B: int, p: int, device=None, dim: int = 3) -> torch.Tensor:
    """[B^dim, (p+1)^dim] brick node of (cell slot, local node), both x
    fastest (the reference's ``slot_idx``, the one-hot E as an index map)."""
    n, NB = p + 1, B * p + 1
    loc = torch.arange(n**dim, device=device)
    slot = torch.arange(B**dim, device=device)
    axis = lambda i, w, a: (i // w**a) % w
    return sum(
        ((axis(slot, B, a) * p)[:, None] + axis(loc, n, a)[None, :]) * NB**a
        for a in range(dim)
    )


def cell_nodes(cells, brick_size, p, N3p, device):
    """[len(cells), n_loc] flat index into [*, N3p] bricks of each cell's
    nodes; the dimension is read from the row width N3p."""
    dim = _build.brick_dim(NAME, brick_size * p + 1, N3p)
    C = brick_size**dim
    cells = cells.long()
    return (cells // C)[:, None] * N3p + brick_slot_index(brick_size, p, device, dim)[cells % C]


def cell_apply_plain(src, K1, M1, scale, brick_size=None, *, deformed=None):
    """Plain PyTorch version: gather the cell rows, then the sweeps of the
    1-D factors on the [rows, z, y, x] view (x: M1, K1; y: M1 on both, K1
    on the M1 branch; z: on the two sums; 2-D [rows, y, x]: x then y), then
    the scale; deformed: the rows' quadrature with their metric. The
    dimension comes from the shapes: src [m, N3p] rows of NB^2 or NB^3
    nodes, or rows of (p+1)^2 or (p+1)^3 values. A RHS axis: each RHS so."""
    if src.dim() == 3:
        return torch.stack([cell_apply_plain(s, K1, M1, scale, brick_size, deformed=deformed)
                            for s in src])
    if deformed is not None:
        S, Dc, geo = deformed
        p = S.shape[1] - 1
        dim = _build.brick_dim(NAME, brick_size * p + 1, src.shape[1])
        rows = src[:, brick_slot_index(brick_size, p, src.device, dim).reshape(-1)]
        return laplace_rows(rows.reshape(geo.shape[0], -1), S, Dc, None, geo, dim)
    n = cell_degree(K1) + 1
    if brick_size is not None:
        dim = _build.brick_dim(NAME, brick_size * (n - 1) + 1, src.shape[1])
        idx = brick_slot_index(brick_size, n - 1, src.device, dim)
        src = src[:, idx.reshape(-1)]
    else:
        dim = _build.lattice_dim(NAME, n, src.shape[1])
    if dim == 2:  # K = M1y⊗K1x + K1y⊗M1x on the [rows, y, x] view
        x = src.reshape(-1, n, n)
        along = lambda A, t, ax: torch.einsum({0: "ij,ryj->ryi", 1: "ij,rjx->rix"}[ax], A, t)
        out = along(M1, along(K1, x, 0), 1) + along(K1, along(M1, x, 0), 1)
        return out.reshape(-1, n * n) * scale[:, None]
    x = src.reshape(-1, n, n, n)
    along = lambda A, t, ax: torch.einsum(
        {0: "ij,rzyj->rzyi", 1: "ij,rzjx->rzix", 2: "ij,rjyx->riyx"}[ax], A, t)
    a, b = along(M1, x, 0), along(K1, x, 0)
    c1 = along(M1, b, 1) + along(K1, a, 1)
    c2 = along(M1, a, 1)
    out = along(M1, c1, 2) + along(K1, c2, 2)
    return out.reshape(-1, n**3) * scale[:, None]


_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_int]
         + [ctypes.c_void_p])
# (p, B, dim) of the kernel's instances, the brick size rule's B at every degree: 3-D (B = 16,
# 8, 4, 4 at p = 1..4, 2 at p = 5..8) and 2-D (B = 16 at p = 1..3, 8 at p = 4..6); the
# single-device engine runs p >= 4 (its degree <= 3 schedule reads no plain rows), the
# distributed brick step every degree
SUPPORTED = {(1, 16, 3), (2, 8, 3), (3, 4, 3), (4, 4, 3), (5, 2, 3), (6, 2, 3), (7, 2, 3),
             (8, 2, 3), (1, 16, 2), (2, 16, 2), (3, 16, 2), (4, 8, 2), (5, 8, 2), (6, 8, 2)}


_DEFORMED_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# (p, B, dim) of the deformed mode's instances: the brick size rule's at p = 1..6, 3-D and 2-D
DEFORMED_SUPPORTED = ({(1, 16, 3), (2, 8, 3), (3, 4, 3), (4, 4, 3), (5, 2, 3), (6, 2, 3)}
                      | {(1, 16, 2), (2, 16, 2), (3, 16, 2), (4, 8, 2), (5, 8, 2), (6, 8, 2)})


def cell_apply(src, K1, M1, scale, brick_size, *, deformed=None):
    """Launch the kernel on CUDA tensors; the plain version on CPU ones.
    The kernel takes K1 and M1 by value, as launch parameters: on the
    kernel path they must be CPU tensors (``BrickLaplaceMM.factors_host``);
    factors on the card raise rather than cost a synchronising copy.
    src [m, N3p] -> out [m*B^3, n_loc]; a RHS axis: src [k, m, N3p] (any
    stride between RHS) -> out [k, m*B^3, n_loc]. deformed = (S, Dc, geo):
    the deformed mode, src [m, N3p] -> out [m*B^3, n_loc]; K1, M1, scale
    may be None."""
    if src.device.type == "cpu":
        return cell_apply_plain(src, K1, M1, scale, brick_size, deformed=deformed)
    if deformed is not None:
        return _deformed(src, *deformed, int(brick_size))
    k, stride, src1 = _build.rhs_axis(NAME, src, 2)
    dev = _build.check_cuda(NAME, src.dtype, src=src1, scale=scale)
    p = cell_degree(K1)
    B = int(brick_size)
    dim = _build.brick_dim(NAME, B * p + 1, src1.shape[1])
    n_loc = (p + 1) ** dim
    if (p, B, dim) not in SUPPORTED:
        raise ValueError(f"{NAME}: no {dim}-D instance at p={p}, B={B}")
    if M1.shape != K1.shape:
        raise ValueError(f"{NAME}: M1 must be {tuple(K1.shape)}, got {tuple(M1.shape)}")
    if K1.device.type != "cpu" or M1.device.type != "cpu":
        raise ValueError(f"{NAME}: the kernel takes K1 and M1 as host tensors "
                         f"(op.factors_host), got them on {K1.device} and {M1.device}")
    K1, M1 = (f.detach().to(src.dtype).contiguous() for f in (K1, M1))
    rows, N3p = src1.shape[0] * B**dim, src1.shape[1]
    if scale.shape != (rows,):
        raise ValueError(f"{NAME}: scale must be [{rows}], got {tuple(scale.shape)}")
    out = torch.empty((*src.shape[:-2], rows, n_loc), dtype=src.dtype, device=src.device)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(src.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(src), _build.ptr(K1), _build.ptr(M1),
                  _build.ptr(scale), _build.ptr(out), rows, p, B, N3p, k, stride, dim)
    cell_apply.launches += 1
    return out


cell_apply.launches = 0


def _deformed(src, S, Dc, geo, B):
    """The deformed mode's launch."""
    dev = _build.check_cuda(NAME, src.dtype, src=src, S=S, Dc=Dc, geo=geo)
    if src.dim() != 2:
        raise ValueError(f"{NAME}: the deformed mode takes src [m, N3p], got {tuple(src.shape)}")
    p = S.shape[1] - 1
    dim = _build.brick_dim(NAME, B * p + 1, src.shape[1])
    n_loc = (p + 1) ** dim
    rows = src.shape[0] * B**dim
    if ((p, B, dim) not in DEFORMED_SUPPORTED or S.shape != (p + 1, p + 1)
            or Dc.shape != S.shape or geo.shape != (rows, n_loc, dim * (dim + 1) // 2)):
        raise ValueError(f"{NAME}: deformed mode shapes src {tuple(src.shape)}, S "
                         f"{tuple(S.shape)}, geo {tuple(geo.shape)} at B={B}, {dim}-D")
    out = torch.empty((rows, n_loc), dtype=src.dtype, device=src.device)
    fn = _build.function(NAME, f"{NAME}_deformed_{_build.suffix(src.dtype)}", _DEFORMED_ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(src), _build.ptr(geo), _build.ptr(S), _build.ptr(Dc),
                  _build.ptr(out), rows, p, B, src.shape[1], dim)
    cell_apply.launches += 1
    return out


def bytes_and_flops(src_elems, rows, n_loc, itemsize, k=1, deformed=False):
    """Least traffic (src read once, out written once, K1, M1 and scale) and
    the sum-factorized operation count: 7 sweeps of 2 n^4 and the scale,
    per row (2-D, n_loc = n^2: 4 sweeps of 2 n^3). k right-hand sides
    (src_elems and rows those of one): the bricks and rows k times, the
    factors and scale once. deformed: src, the rows' metric, S, Dc and out;
    12 sweeps of 2 n^4 and 15 operations a point a row (2-D: the metric's 3
    values a point, 8 sweeps of 2 n^3 and 7 operations a point)."""
    p, dim = _build.cell_shape(NAME, n_loc)
    n = p + 1
    if deformed:
        n_pairs = dim * (dim + 1) // 2
        per_row = 12 * 2 * n**4 + 15 * n_loc if dim == 3 else 8 * 2 * n**3 + 7 * n_loc
        return ((src_elems + rows * n_loc * (1 + n_pairs) + 2 * n * n) * itemsize,
                rows * per_row)
    if dim == 2:
        return ((k * (src_elems + rows * n_loc) + 2 * n * n + rows) * itemsize,
                k * rows * (4 * 2 * n**3 + n**2))
    nbytes = (k * (src_elems + rows * n_loc) + 2 * n * n + rows) * itemsize
    return nbytes, k * rows * (7 * 2 * n**4 + n**3)
