"""Kernel 21, ``dss_pools``: the distributed brick engine's cross-brick
direct-stiffness summation on a rank's slab v [nb, N3p], in two launches
around the exchange of the pools that the rank shares with others:

* accumulate: ``dss_pools(v, surf_node, ent_off, pool_off, pool_ptr,
  pool_src, n_slots, mode="accumulate")`` -> a new pools buffer [n_slots]
  (n_slots = pool_off[-1], a host int, so the launch reads nothing back
  from the card): pool q
  holds the values pool_off[q] .. pool_off[q+1] (its size, a face's, an
  edge's or 1), and position j of it sums, over its contributors c =
  pool_src[pool_ptr[q] .. pool_ptr[q+1]] (brick << 5 | entity, in ascending
  slab order), v[brick, surf_node[ent_off[entity] + j]]. The buffer's
  regions come from the host plan (``DistributedBrickLaplace``): the boundary
  pools first (the replicated exchange sums them over the ranks with one
  all_reduce; the halo exchange's touched pools and trash value travel by
  halo_pack), then the rank's internal pools.
* read (in place): ``dss_pools(v, pools, node_ent, read_base, valid_bits,
  mode="read")`` -> v: a node whose bit in valid_bits [nb, N3p/32] is clear
  becomes 0, a valid surface node (node_ent[node] = entity << 16 | j, -1 off
  the surface) takes pools[read_base[brick, entity] + j].

Entities (``surface_entities``): in 3-D the 6 faces, 12 edges and 8 corners
of ``dss_surface.surface_nodes``' order, in 2-D its 4 sides and 4 corners.

Replaces the reference's ``_dss_local`` and ``_dss_local_halo`` with the
step's surface extract and write-back
(dealii_matrixfree_hanging_nodes_tpu/parallel/bricks_distributed.py:793-931,
1097-1107). CUDA source: ``csrc/dss_pools.cu``."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .dss_surface import surface_nodes

NAME = "dss_pools"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/parallel/bricks_distributed.py:793"
MODES = ("accumulate", "read")


def surface_entities(NB: int, dim: int):
    """(surf_node int32 [n_surf], ent_off int32 [n_ent+1], node_ent int32
    [N3]): the surface nodes in the reference's Es order, the first surface
    position of each entity (faces, edges in 3-D, corners), and each brick
    node's entity << 16 | position (-1 inside)."""
    surf = surface_nodes(NB, dim)
    M = NB - 2
    sizes = [M ** (dim - 1)] * (2 * dim) + ([M] * 12 if dim == 3 else []) + [1] * 2**dim
    ent_off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    node_ent = np.full(NB**dim, -1, dtype=np.int32)
    for k in range(len(sizes)):
        node_ent[surf[ent_off[k]:ent_off[k + 1]]] = (k << 16) | np.arange(sizes[k])
    return surf.astype(np.int32), ent_off, node_ent


def valid_mask(valid_bits, N3p):
    k = torch.arange(N3p, device=valid_bits.device)
    return ((valid_bits[:, k >> 5] >> (k & 31)) & 1).bool()


def dss_pools_plain(v, *tables, mode="accumulate"):
    """Plain PyTorch version of each mode (accumulate: a new buffer, every
    pool value's contributors added in list order into 0; read: v in place)."""
    if mode == "accumulate":
        surf_node, ent_off, pool_off, pool_ptr, pool_src = (t.long() for t in tables[:5])
        n_slots, N3p = int(tables[5]), v.shape[1]
        t = torch.arange(n_slots, device=v.device)
        q = torch.searchsorted(pool_off, t, right=True) - 1
        j = t - pool_off[q]
        cnt = pool_ptr[q + 1] - pool_ptr[q]
        slot = torch.repeat_interleave(t, cnt)
        first = torch.repeat_interleave(pool_ptr[q], cnt)
        run0 = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
        c = pool_src[first + torch.arange(slot.numel(), device=v.device) - run0]
        node = surf_node[ent_off[c & 31] + j[slot]]
        vals = v.reshape(-1)[(c >> 5) * N3p + node]
        return torch.zeros(n_slots, dtype=v.dtype, device=v.device).index_add_(0, slot, vals)
    if mode == "read":
        pools, node_ent, read_base, valid_bits = tables
        nb, N3p = v.shape
        valid = valid_mask(valid_bits, N3p)
        code = node_ent.long()
        surf = torch.nonzero(code >= 0)[:, 0]
        k, j = code[surf] >> 16, code[surf] & 0xFFFF
        vals = pools[read_base.long()[:, k] + j[None, :]]  # [nb, n_surf]
        v[:, surf] = vals
        v.masked_fill_(~valid, 0.0)
        return v
    raise ValueError(f"{NAME}: unknown mode {mode!r}")


_ACC_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_READ_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def dss_pools(v, *tables, mode="accumulate"):
    """Launch the mode's kernel on CUDA tensors (contiguous, on one card,
    index tables int32); the plain version on CPU tensors. v [nb, N3p]."""
    if mode not in MODES:
        raise ValueError(f"{NAME}: unknown mode {mode!r}")
    if v.device.type == "cpu":
        return dss_pools_plain(v, *tables, mode=mode)
    if v.dim() != 2 or v.numel() >= 2**31:
        raise ValueError(f"{NAME}: v must be [nb, N3p], got {tuple(v.shape)}")
    nb, N3p = v.shape
    sfx = _build.suffix(v.dtype)
    if mode == "accumulate":
        surf_node, ent_off, pool_off, pool_ptr, pool_src, n_slots = tables
        dev = _build.check_cuda(NAME, v.dtype, v=v, surf_node=surf_node, ent_off=ent_off,
                                pool_off=pool_off, pool_ptr=pool_ptr, pool_src=pool_src)
        if any(t.dtype != torch.int32 for t in tables[:5]):
            raise TypeError(f"{NAME}: the accumulate tables must be int32")
        n_pools = pool_off.numel() - 1
        if pool_ptr.shape != pool_off.shape or n_pools < 0:
            raise ValueError(f"{NAME}: pool_off {tuple(pool_off.shape)}, pool_ptr "
                             f"{tuple(pool_ptr.shape)}")
        out = torch.empty(int(n_slots), dtype=v.dtype, device=v.device)
        fn = _build.function(NAME, f"{NAME}_accumulate_{sfx}", _ACC_ARGS)
        _build.launch(NAME, fn, dev, _build.ptr(v), *(_build.ptr(t) for t in tables[:5]),
                      _build.ptr(out), int(n_slots), n_pools, N3p)
    else:
        pools, node_ent, read_base, valid_bits = tables
        dev = _build.check_cuda(NAME, v.dtype, v=v, pools=pools, node_ent=node_ent,
                                read_base=read_base, valid_bits=valid_bits)
        if any(t.dtype != torch.int32 for t in (node_ent, read_base, valid_bits)):
            raise TypeError(f"{NAME}: node_ent, read_base and valid_bits must be int32")
        if (node_ent.shape != (N3p,) or read_base.dim() != 2 or read_base.shape[0] != nb
                or N3p % 32 or valid_bits.shape != (nb, N3p // 32)):
            raise ValueError(f"{NAME}: shapes v {tuple(v.shape)}, node_ent "
                             f"{tuple(node_ent.shape)}, read_base {tuple(read_base.shape)}, "
                             f"valid_bits {tuple(valid_bits.shape)}")
        fn = _build.function(NAME, f"{NAME}_read_{sfx}", _READ_ARGS)
        _build.launch(NAME, fn, dev, _build.ptr(v), _build.ptr(pools), _build.ptr(node_ent),
                      _build.ptr(read_base), _build.ptr(valid_bits), nb, read_base.shape[1], N3p)
        out = v
    dss_pools.launches += 1
    return out


dss_pools.launches = 0


def bytes_and_flops(v, *tables, mode="accumulate"):
    """Least traffic of each mode. accumulate: each contributing surface
    copy read once, the lists read once, the pools written once; an add a
    copy. read: every node of the slab written once where it changes (the
    valid surface nodes, the invalid nodes), the pools they read once, the
    node tables read once."""
    isz = v.element_size()
    if mode == "accumulate":
        surf_node, ent_off, pool_off, pool_ptr, pool_src, n_slots = tables
        sizes = (pool_off[1:] - pool_off[:-1]).long()
        copies = int((sizes * (pool_ptr[1:] - pool_ptr[:-1]).long()).sum())
        nbytes = (copies + int(n_slots)) * isz + 4 * (pool_off.numel() + pool_ptr.numel()
                                                            + pool_src.numel())
        return nbytes, copies
    pools, node_ent, read_base, valid_bits = tables
    nb, N3p = v.shape
    valid = valid_mask(valid_bits, N3p)
    surf = node_ent >= 0
    n_write = int((valid & surf[None, :]).sum()) + int((~valid).sum())
    nbytes = (n_write + pools.numel()) * isz + 4 * (node_ent.numel() + read_base.numel()
                                                   + valid_bits.numel())
    return nbytes, 0
