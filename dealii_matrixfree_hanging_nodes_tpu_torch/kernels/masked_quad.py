"""Kernel 9, ``masked_quad``: the masked removal of the degree <= 3 schedule,
in place on the first bricks of v [nb, N3p]:

    v[b] -= sum over the selected cells c of brick b of geo[b] E_c^T K E_c u[b]

with E_c the gather of cell c's (p+1)^3 nodes from its brick and K the
Kronecker sum of the 1-D factors K1, M1 (``cell_apply``'s). The selected
cells come as lists (``bricks._masked_lists``): the bricks that hold one
(brick [n_blk]), each brick's selected slots (slot, int32) in 8 parity
classes, x%2 + 2 (y%2) + 4 (z%2) of the cell's place in the brick, no two
cells of a class sharing a node, and ptr [n_blk, 9] each class's range.

Replaces the reference's ``_masked_quad_apply`` (bricks.py:3169-3244) with
its subtraction from the subset bricks (``corr = -masked_quad(u_sub,
qmask)``, bricks.py:2426-2429, 2934-2938): block-diagonal quadrature
sweeps (Sqb, Dqb) over whole subset bricks with the geo-premultiplied cell
mask as the metric. With p+1 Gauss points per axis the quadrature
integrates the cell stiffness exactly, so the function is a sum of cell
stiffnesses over the selected cells, which the kernel visits alone.
2-D bricks: 4 parity classes (x%2 + 2 (y%2)), ptr [n_blk, 5], cells of
(p+1)^2 values in NB^2-node bricks (B = 16 at p = 1..3; ``list_dim``).
CUDA source: ``csrc/masked_quad.cu``.

With a right-hand-side axis (``BrickLaplaceMM.vmult_multi`` with
face_planes=False: v [k, nb, N3p], u [k, >= n_sub, N3p] with any stride
between its RHS) each RHS goes through the same lists in one launch
(grid.y), bit-identical to a call on it alone."""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .cell_apply import cell_apply_plain, cell_degree, cell_nodes

NAME = "masked_quad"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:3169"
# (p, B, dim): the degree <= 3 schedule's brick sizes, 3-D and 2-D
SUPPORTED = {(3, 4, 3), (2, 8, 3), (1, 16, 3), (3, 16, 2), (2, 16, 2), (1, 16, 2)}


def list_dim(ptr) -> int:
    """The dimension of cell lists whose ptr [n_blk, 2^dim + 1] gives 2^dim
    parity classes a brick (9 columns in 3-D, 5 in 2-D)."""
    if ptr.dim() != 2 or ptr.shape[1] not in (5, 9):
        raise ValueError(f"{NAME}: ptr must be [n_blk, 5] (2-D) or [n_blk, 9] (3-D), got "
                         f"{tuple(ptr.shape)}")
    return 2 if ptr.shape[1] == 5 else 3


def selected_cells(brick, ptr, slot, brick_size):
    """[n_cells] brick-cell id (brick * B^dim + slot) of every list entry, in
    list order."""
    n = (ptr[:, -1] - ptr[:, 0]).long()
    return torch.repeat_interleave(brick.long(), n) * brick_size ** list_dim(ptr) + slot.long()


def masked_quad_plain(v, u, brick, ptr, slot, K1, M1, geo, brick_size):
    """Plain PyTorch version: the selected cells' rows gathered from u,
    their stiffness (``cell_apply_plain``) times their brick's geo, then
    subtracted from v with one ``index_add_``. Updates v in place and
    returns it. A RHS axis: each RHS so."""
    if v.dim() == 3:
        for vj, uj in zip(v, u):
            masked_quad_plain(vj, uj, brick, ptr, slot, K1, M1, geo, brick_size)
        return v
    p, dim = cell_degree(K1), list_dim(ptr)
    cells = selected_cells(brick, ptr, slot, brick_size)
    nodes = cell_nodes(cells, brick_size, p, u.shape[1], u.device)
    rows = cell_apply_plain(u.reshape(-1)[nodes], K1, M1, geo[cells // brick_size**dim])
    v.view(-1).index_add_(0, nodes.reshape(-1), rows.reshape(-1), alpha=-1)
    return v


_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
         + [ctypes.c_int, ctypes.c_void_p])


def masked_quad(v, u, brick, ptr, slot, K1, M1, geo, brick_size):
    """v [nb, N3p] (updated in place and returned), u [>= n_sub, N3p] of
    v's dtype, geo [nb]; brick [n_blk], ptr [n_blk, 9], slot int32. A RHS
    axis: v [k, nb, N3p] contiguous, u [k, >= n_sub, N3p] with any stride
    between RHS. The kernel takes K1 and M1 by value, as launch parameters:
    on the kernel path they must be CPU tensors (``op.factors_host``)."""
    if v.device.type == "cpu":
        return masked_quad_plain(v, u, brick, ptr, slot, K1, M1, geo, brick_size)
    k, v_stride, v1 = _build.rhs_axis(NAME, v, 2)
    ku, u_stride, u1 = _build.rhs_axis(NAME, u, 2)
    if ku != k or u.dim() != v.dim() or not v.is_contiguous():
        raise ValueError(f"{NAME}: v {tuple(v.shape)} (contiguous) and u {tuple(u.shape)} must "
                         f"have one RHS axis")
    dev = _build.check_cuda(NAME, v.dtype, v=v1, u=u1, brick=brick, ptr=ptr, slot=slot, geo=geo)
    p, B, dim = cell_degree(K1), int(brick_size), list_dim(ptr)
    if (p, B, dim) not in SUPPORTED or M1.shape != K1.shape:
        raise ValueError(f"{NAME}: unsupported degree {p} with B={B} in {dim}-D")
    if K1.device.type != "cpu" or M1.device.type != "cpu":
        raise ValueError(f"{NAME}: the kernel takes K1 and M1 as host tensors "
                         f"(op.factors_host), got them on {K1.device} and {M1.device}")
    if any(t.dtype != torch.int32 for t in (brick, ptr, slot)):
        raise TypeError(f"{NAME}: brick, ptr and slot must be int32")
    nb, N3p = v1.shape
    if (u1.shape[1] != N3p or _build.brick_dim(NAME, B * p + 1, N3p) != dim
            or geo.shape != (nb,) or ptr.shape[0] != brick.shape[0] or nb * N3p > 2**31 - 1):
        raise ValueError(f"{NAME}: shapes v {tuple(v.shape)}, u {tuple(u.shape)}, ptr "
                         f"{tuple(ptr.shape)}, geo {tuple(geo.shape)}")
    K1, M1 = (f.detach().to(v.dtype).contiguous() for f in (K1, M1))
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(v.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(u), _build.ptr(v), _build.ptr(brick), _build.ptr(ptr),
                  _build.ptr(slot), _build.ptr(geo), _build.ptr(K1), _build.ptr(M1),
                  brick.shape[0], p, B, N3p, k, u_stride, v_stride, dim)
    masked_quad.launches += 1
    return v


masked_quad.launches = 0


def bytes_and_flops(v, u, brick, ptr, slot, K1, M1, geo, brick_size):
    """Least traffic: the distinct nodes of the selected cells read once from
    u, and read and written once in v; the lists, geo and K1, M1.
    Operations: the 7 sweeps of 2 n^4, the scale and one subtraction per
    cell node, per selected cell. A RHS axis: the nodes and the operations
    k times, the lists, geo and factors once."""
    k = v.shape[0] if v.dim() == 3 else 1
    n, dim = cell_degree(K1) + 1, list_dim(ptr)
    cells = selected_cells(brick, ptr, slot, brick_size)
    nodes = cell_nodes(cells, brick_size, n - 1, u.shape[-1], u.device)
    n_nodes = torch.unique(nodes).numel()
    nbytes = (3 * k * n_nodes + brick.numel() + 2 * n * n) * v.element_size() + 4 * (
        brick.numel() + ptr.numel() + slot.numel())
    per_cell = 7 * 2 * n**4 + 2 * n**3 if dim == 3 else 4 * 2 * n**3 + 2 * n**2
    return nbytes, k * cells.numel() * per_cell
