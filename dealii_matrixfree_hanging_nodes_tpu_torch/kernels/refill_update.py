"""Kernel 8, ``refill_update``: the write-back of ``refill``. For every brick
node of v [nb, N3p]:

    out = valid ? v + invden[b, w] * sum (u_hat[h, j] - v) : 0

where valid is the node's bit in valid_bits [nb, N3p/32] (bit k of a brick
in word k // 32 at position k % 32), and the update runs only at the
written nodes w of the subset bricks (b < n_sub): nodes[w] is the brick
node the fill writes, holders[w] the cells of a brick that hold it as
slot << 16 | j (slot the cell's place in its brick, j the node's local
index in that cell) in ascending slot order, -1 padded to 8, and the sum
runs over those whose cell is a constrained row h = cell_code[b*B^3 + slot]
>= 0. u_hat [n_hn, n_loc] are the filled constrained rows; invden [n_sub,
n_w] is the coverage divisor at each written node (every writer of a node
carries the same value, so the mean restores it).

Replaces the write-back of the reference's ``_refill_impl``
(bricks.py:2884-2899) through ``_fill_chain_efx`` (bricks.py:2851-2865):
the zeroed [n_sub*B^3, n_loc] delta, the EFX product, the Es / EsI
scatters and the node_valid mask. The tables are ``bricks.kernel_tables``'
(``BrickLaplaceMM.refill_tables()``). 2-D bricks (B^2 cells, at most 4
holders a node) take the same tables; the cells a brick, C, come from
u_hat's cell size. CUDA source: ``csrc/refill_update.cu``."""

from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "refill_update"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:2884"
MAX_HOLDERS = 8  # the cells of a brick that share a node: 2 an axis (4 in 2-D, padded to 8)


def valid_mask(valid_bits, N3p):
    """[nb, N3p] bool from the one-bit-a-node table."""
    k = torch.arange(N3p, device=valid_bits.device)
    return ((valid_bits[:, k >> 5] >> (k & 31)) & 1).bool()


def refill_update_plain(v, u_hat, valid_bits, cell_code, nodes, holders, invden, brick_size):
    """Plain PyTorch version on the same tables: the masked copy, then at
    the written nodes of the subset bricks the differences summed holder by
    holder in ascending cell-slot order, scaled, added."""
    nb, N3p = v.shape
    n_sub = invden.shape[0]
    valid = valid_mask(valid_bits, N3p)
    out = torch.where(valid, v, 0.0)
    if not (n_sub and nodes.numel()):
        return out
    w_node = nodes.long()
    val = v[:n_sub, w_node]
    codes = cell_code.view(n_sub, -1).long()
    acc = torch.zeros_like(val)
    for k in range(holders.shape[1]):
        hv = holders[:, k].long()
        real = hv >= 0
        h = torch.where(real, codes[:, torch.where(real, hv >> 16, 0)], -1)
        term = u_hat[h.clamp(min=0), torch.where(real, hv & 0xFFFF, 0)] - val
        acc = torch.where(h >= 0, acc + term, acc)
    out[:n_sub, w_node] = torch.where(valid[:n_sub, w_node], val + acc * invden, 0.0)
    return out


_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def refill_update(v, u_hat, valid_bits, cell_code, nodes, holders, invden, brick_size):
    """v [nb, N3p]; u_hat [n_hn, n_loc]; valid_bits [nb, N3p/32],
    cell_code [n_sub*B^3], nodes [n_w], holders [n_w, 8] int32; invden
    [n_sub, n_w] -> new [nb, N3p] tensor."""
    if v.device.type == "cpu":
        return refill_update_plain(v, u_hat, valid_bits, cell_code, nodes, holders, invden,
                                   brick_size)
    dev = _build.check_cuda(NAME, v.dtype, v=v, u_hat=u_hat, valid_bits=valid_bits,
                            cell_code=cell_code, nodes=nodes, holders=holders, invden=invden)
    nb, N3p = v.shape
    n_sub, n_w = invden.shape
    C = int(brick_size) ** _build.cell_shape(NAME, u_hat.shape[-1])[1]
    if not (valid_bits.dtype == cell_code.dtype == nodes.dtype == holders.dtype == torch.int32):
        raise TypeError(f"{NAME}: valid_bits, cell_code, nodes and holders must be int32")
    if (valid_bits.shape != (nb, N3p // 32) or N3p % 32 or C > 4096 or n_sub > nb
            or cell_code.shape != (n_sub * C,) or nodes.shape != (n_w,)
            or holders.shape != (n_w, MAX_HOLDERS) or u_hat.dim() != 2):
        raise ValueError(f"{NAME}: shapes v {tuple(v.shape)}, valid_bits "
                         f"{tuple(valid_bits.shape)}, invden {tuple(invden.shape)}, nodes "
                         f"{tuple(nodes.shape)}, holders {tuple(holders.shape)}")
    if v.data_ptr() % 16 or holders.data_ptr() % 16:
        raise ValueError(f"{NAME}: v and holders must start 16-byte aligned (16-byte loads)")
    out = torch.empty_like(v)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(v.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(v), _build.ptr(u_hat), _build.ptr(valid_bits),
                  _build.ptr(cell_code), _build.ptr(nodes), _build.ptr(holders),
                  _build.ptr(invden), _build.ptr(out), nb, n_sub, n_w, N3p, u_hat.shape[1], C)
    refill_update.launches += 1
    return out


refill_update.launches = 0


def bytes_and_flops(v, u_hat, valid_bits, cell_code, nodes, holders, invden, brick_size):
    """Least traffic: out written once at every node; v read once at the
    valid nodes only (an invalid node is written 0 without it); the
    validity at one bit a node; invden at the valid written nodes, and the
    u_hat entries that some valid written node reads; cell_code, nodes and
    holders read once. Operations: a subtract and an add per holder term, a
    multiply and an add per valid written node of a subset brick."""
    n_sub = invden.shape[0]
    valid = valid_mask(valid_bits, v.shape[1])
    w_valid = valid[:n_sub, nodes.long()]  # [n_sub, n_w]
    hv = holders.long()
    real = hv >= 0
    codes = cell_code.view(n_sub, -1).long()[:, (hv >> 16).clamp(min=0)]
    used = real & (codes >= 0) & w_valid[..., None]  # [n_sub, n_w, 8]
    entries = codes[used] * u_hat.shape[1] + (hv & 0xFFFF).expand_as(codes)[used]
    n_read = torch.unique(entries).numel()
    n_w_valid = int(w_valid.sum())
    nbytes = ((v.numel() + int(valid.sum()) + n_read + n_w_valid) * v.element_size()
              + 4 * (valid_bits.numel() + cell_code.numel() + nodes.numel() + holders.numel()))
    return nbytes, 2 * int(used.sum()) + 2 * n_w_valid
