"""Kernel 8, ``refill_update``: the write-back of ``refill``. For every brick
node of v [nb, N3p]:

    out = node_valid ? v + invden[b, pos(node)] * sum (u_hat[h, j] - v) : 0

where the sum runs over the constrained rows h of brick b's cells (b <
n_sub) that hold the node as their slot j, in cell-slot order, and
pos(node) = refill_pos[node] >= 0 marks the nodes the fill writes (no
update elsewhere). u_hat [n_hn, n_loc] are the filled constrained rows;
invden [n_sub, n_pos] is the coverage divisor (every writer of a node
carries the same value, so the mean restores it).

Replaces the write-back of the reference's ``_refill_impl``
(bricks.py:2884-2899) through ``_fill_chain_efx`` (bricks.py:2851-2865):
the zeroed [n_sub*B^3, n_loc] delta, the EFX product, the Es / EsI
scatters and the node_valid mask. CUDA source: ``csrc/refill_update.cu``."""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .cell_apply import cell_nodes

NAME = "refill_update"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:2884"


def refill_update_plain(v, u_hat, node_valid, cell_code, refill_pos, invden, brick_size):
    """Plain PyTorch version on the same tables: the differences summed
    per node with one ``index_add_`` in cell-slot order, scaled, added."""
    n_loc = u_hat.shape[1]
    p = round(n_loc ** (1.0 / 3.0)) - 1
    n_sub, N3p = invden.shape[0], v.shape[1]
    cells = torch.nonzero(cell_code >= 0)[:, 0]  # ascending: cell-slot order
    nodes = cell_nodes(cells, brick_size, p, N3p, v.device)
    flat = v[:n_sub].reshape(-1)
    written = refill_pos[nodes % N3p] >= 0
    diff = u_hat[cell_code[cells].long()] - flat[nodes]
    acc = torch.zeros_like(flat).index_add_(0, nodes[written], diff[written])
    pos = refill_pos.long()
    scale = torch.where(pos >= 0, invden[:, pos.clamp(min=0)], 0.0)
    out = v.clone()
    out[:n_sub] += acc.view(n_sub, N3p) * scale
    return torch.where(node_valid, out, 0.0)


_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def refill_update(v, u_hat, node_valid, cell_code, refill_pos, invden, brick_size):
    """v [nb, N3p]; u_hat [n_hn, n_loc]; node_valid [nb, N3p] bool;
    cell_code [n_sub*B^3], refill_pos [N3p] int32; invden [n_sub, n_pos]
    -> new [nb, N3p] tensor."""
    if v.device.type == "cpu":
        return refill_update_plain(v, u_hat, node_valid, cell_code, refill_pos, invden,
                                   brick_size)
    dev = _build.check_cuda(NAME, v.dtype, v=v, u_hat=u_hat, node_valid=node_valid,
                            cell_code=cell_code, refill_pos=refill_pos, invden=invden)
    nb, N3p = v.shape
    n_hn, n_loc = u_hat.shape
    n_sub, n_pos = invden.shape
    B, p = int(brick_size), round(n_loc ** (1.0 / 3.0)) - 1
    if cell_code.dtype != torch.int32 or refill_pos.dtype != torch.int32:
        raise TypeError(f"{NAME}: cell_code and refill_pos must be int32")
    if (node_valid.dtype != torch.bool or node_valid.shape != v.shape or (p + 1) ** 3 != n_loc
            or cell_code.shape != (n_sub * B**3,) or refill_pos.shape != (N3p,)
            or n_sub > nb or N3p < (B * p + 1) ** 3):
        raise ValueError(f"{NAME}: shapes v {tuple(v.shape)}, u_hat {tuple(u_hat.shape)}, "
                         f"invden {tuple(invden.shape)}, cell_code {tuple(cell_code.shape)}")
    out = torch.empty_like(v)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(v.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(v), _build.ptr(u_hat), _build.ptr(node_valid),
                  _build.ptr(cell_code), _build.ptr(refill_pos), _build.ptr(invden),
                  _build.ptr(out), nb, n_sub, n_pos, N3p, n_loc, p, B)
    refill_update.launches += 1
    return out


refill_update.launches = 0


def bytes_and_flops(v, u_hat, cell_code, refill_pos, invden, brick_size):
    """Least traffic: v read once and out written once, the node_valid
    pattern at one bit a node, u_hat, invden, cell_code and
    refill_pos read once. Operations: a subtract and an add per writer of a
    written node, a multiply and an add per written node of a subset brick."""
    n_sub, N3p = invden.shape[0], v.shape[1]
    p = round(u_hat.shape[1] ** (1.0 / 3.0)) - 1
    nodes = cell_nodes(torch.nonzero(cell_code >= 0)[:, 0], brick_size, p, N3p, v.device)
    n_writers = int((refill_pos[nodes % N3p] >= 0).sum())
    nbytes = ((2 * v.numel() + u_hat.numel() + invden.numel()) * v.element_size()
              + (v.numel() + 7) // 8 + 4 * (cell_code.numel() + refill_pos.numel()))
    return nbytes, 2 * n_writers + 2 * int((refill_pos >= 0).sum()) * n_sub
