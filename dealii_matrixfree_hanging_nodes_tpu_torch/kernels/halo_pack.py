"""Kernel 20, ``halo_pack``: the distributed engines' halo buffers, in three
modes over index lists that the host plan builds (one wrapper, one CUDA
library):

* pack: ``halo_pack(x, idx, valid, mode="pack")`` -> a new tensor shaped as
  idx, out[i] = x_flat[idx[i]] * valid[i] (0 where valid is 0; nothing is
  read there): a send buffer [R, m], or any gather of values by a flat list
  (the chain block from the cell rows or from the slab);
* set: ``halo_pack(own, recv, map, mode="set")`` -> a new 1-D tensor of
  own.numel() + map.numel() values: own first, then recv_flat[map[j]] (0
  where map[j] is -1): the chain exchange's need buffer, the index halo's
  ``[own | ghosts]`` vector;
* add: ``halo_pack(x, recv, dst, ptr, src, w, mode="add")`` -> x, updated in
  place: x_flat[dst[q]] += sum of recv_flat[src[e]] * w[e] over e = ptr[q]
  .. ptr[q+1], by destination (``transpose_lists`` builds the runs from the
  [R, m] send lists in ascending (rank, slot) order), so a DoF or a pool that
  several ranks send back is summed in one fixed order, without atomics.
  With no destination (one rank, or a rank that shares nothing) nothing is
  launched and nothing counted.

Replaces the reference's halo gathers and scatters
(dealii_matrixfree_hanging_nodes_tpu/parallel/distributed.py:261-284,
bricks_distributed.py:846-953): ``src_own[send_idx] * send_valid``, the
``[src_own; recv]`` concatenation and ``own.at[send_idx].add(back * valid)``;
``bflat[dsend_idx] * dsend_valid`` and ``bflat.at[dsend_idx].add(recv *
dsend_valid)``; ``bflat[send_scal] * send_scal_valid`` with
``buf.at[recv_scal].set(recv)`` and ``buf.at[:n_own].set(block)``. CUDA source:
``csrc/halo_pack.cu``."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

NAME = "halo_pack"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/parallel/distributed.py:261"
MODES = ("pack", "set", "add")


def transpose_lists(idx, valid):
    """The add mode's runs from send lists idx, valid [R, m] (a pad entry has
    valid 0): (dst, ptr, src, w) int32 / float64, dst the distinct flat
    targets ascending, each run's entries (flat positions s * m + j in the
    received [R, m] buffer) in ascending order."""
    idx = np.asarray(idx).reshape(-1).astype(np.int64)
    valid = np.asarray(valid, dtype=np.float64).reshape(-1)
    ent = np.nonzero(valid != 0)[0]
    order = np.argsort(idx[ent], kind="stable")
    ent = ent[order]
    dst, counts = np.unique(idx[ent], return_counts=True)
    ptr = np.zeros(len(dst) + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return (dst.astype(np.int32), ptr.astype(np.int32), ent.astype(np.int32), valid[ent])


def set_map(n_buf, n_own, recv_pos, valid):
    """The set mode's map [n_buf - n_own] from the buffer positions recv_pos
    [R, m] of the received values, valid [R, m] marking the real ones:
    map[j] = the flat index of the received value that lands at n_own + j,
    else -1. Raises where a real value lands outside [n_own, n_buf) or two
    land on one position."""
    pos = np.asarray(recv_pos).reshape(-1).astype(np.int64)
    keep = np.nonzero(np.asarray(valid).reshape(-1) != 0)[0]
    if len(keep) and (pos[keep].min() < n_own or pos[keep].max() >= n_buf
                      or len(np.unique(pos[keep])) != len(keep)):
        raise ValueError(f"{NAME}: received values land outside the buffer's tail or together")
    m = np.full(n_buf - n_own, -1, dtype=np.int32)
    m[pos[keep] - n_own] = keep
    return m


def halo_pack_plain(x, *tables, mode="pack"):
    """Plain PyTorch version of each mode (pack and set: a new tensor; add: x
    in place, its runs added entry by entry in list order)."""
    if mode == "pack":
        idx, valid = tables
        out = torch.zeros(idx.shape, dtype=x.dtype, device=x.device)
        sel = valid != 0
        out[sel] = x.reshape(-1)[idx[sel].long()] * valid[sel]
        return out
    if mode == "set":
        recv, m = tables
        tail = torch.zeros(m.shape, dtype=x.dtype, device=x.device)
        sel = m >= 0
        tail[sel] = recv.reshape(-1)[m[sel].long()]
        return torch.cat([x.reshape(-1), tail])
    if mode == "add":
        recv, dst, ptr, src, w = tables
        target = torch.repeat_interleave(dst.long(), (ptr[1:] - ptr[:-1]).long())
        x.view(-1).index_add_(0, target, recv.reshape(-1)[src.long()] * w)
        return x
    raise ValueError(f"{NAME}: unknown mode {mode!r}")


_PACK_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
_SET_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
_ADD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]


def _int32(*tensors):
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError(f"{NAME}: index lists must be int32")


def halo_pack(x, *tables, mode="pack"):
    """Launch the mode's kernel on CUDA tensors (contiguous, on one card,
    floating ones in x's dtype); the plain version on CPU tensors. See the
    module's docstring for each mode's arguments."""
    if mode not in MODES:
        raise ValueError(f"{NAME}: unknown mode {mode!r}")
    if x.device.type == "cpu":
        return halo_pack_plain(x, *tables, mode=mode)
    if mode == "add" and tables[1].numel() == 0:
        return x  # no destination (a rank that shares nothing): no launch
    sfx = _build.suffix(x.dtype)
    if mode == "pack":
        idx, valid = tables
        dev = _build.check_cuda(NAME, x.dtype, x=x, idx=idx, valid=valid)
        _int32(idx)
        if valid.shape != idx.shape or x.numel() >= 2**31:
            raise ValueError(f"{NAME}: shapes x {tuple(x.shape)}, idx {tuple(idx.shape)}, "
                             f"valid {tuple(valid.shape)}")
        out = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
        fn = _build.function(NAME, f"{NAME}_pack_{sfx}", _PACK_ARGS)
        _build.launch(NAME, fn, dev, _build.ptr(x), _build.ptr(idx), _build.ptr(valid),
                      _build.ptr(out), idx.numel())
    elif mode == "set":
        recv, m = tables
        dev = _build.check_cuda(NAME, x.dtype, own=x, recv=recv, map=m)
        _int32(m)
        if m.dim() != 1 or recv.numel() >= 2**31:
            raise ValueError(f"{NAME}: shapes recv {tuple(recv.shape)}, map {tuple(m.shape)}")
        out = torch.empty(x.numel() + m.numel(), dtype=x.dtype, device=x.device)
        fn = _build.function(NAME, f"{NAME}_set_{sfx}", _SET_ARGS)
        _build.launch(NAME, fn, dev, _build.ptr(x), _build.ptr(recv), _build.ptr(m),
                      _build.ptr(out), x.numel(), out.numel())
    else:
        recv, dst, ptr, src, w = tables
        dev = _build.check_cuda(NAME, x.dtype, x=x, recv=recv, dst=dst, ptr=ptr, src=src, w=w)
        _int32(dst, ptr, src)
        if (ptr.shape != (dst.numel() + 1,) or src.shape != w.shape or src.dim() != 1
                or x.numel() >= 2**31 or recv.numel() >= 2**31):
            raise ValueError(f"{NAME}: shapes dst {tuple(dst.shape)}, ptr {tuple(ptr.shape)}, "
                             f"src {tuple(src.shape)}, w {tuple(w.shape)}")
        fn = _build.function(NAME, f"{NAME}_add_{sfx}", _ADD_ARGS)
        _build.launch(NAME, fn, dev, _build.ptr(x), _build.ptr(recv), _build.ptr(dst),
                      _build.ptr(ptr), _build.ptr(src), _build.ptr(w), dst.numel())
        out = x
    halo_pack.launches += 1
    return out


halo_pack.launches = 0


def bytes_and_flops(x, *tables, mode="pack"):
    """Least traffic of each mode: its lists read once, the values that a
    real entry names read once (each distinct one once), the output written
    once (add: each destination read and written once). One multiply an
    entry (pack), a multiply and an add an entry (add)."""
    isz = x.element_size()
    if mode == "pack":
        idx, valid = tables
        sel = valid != 0
        n_read = int(torch.unique(idx[sel]).numel())
        return (n_read + 2 * idx.numel()) * isz + 4 * idx.numel(), int(sel.sum())
    if mode == "set":
        recv, m = tables
        n_read = int((m >= 0).sum())
        return (2 * x.numel() + n_read + m.numel()) * isz + 4 * m.numel(), 0
    recv, dst, ptr, src, w = tables
    n_read = int(torch.unique(src).numel())
    nbytes = (2 * dst.numel() + n_read + w.numel()) * isz + 4 * (dst.numel() + ptr.numel()
                                                                  + src.numel())
    return nbytes, 2 * src.numel()
