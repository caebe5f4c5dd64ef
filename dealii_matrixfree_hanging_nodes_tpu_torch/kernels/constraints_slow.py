"""Kernel 15, ``constraints_slow``: the index engine's constraint CSR on a
global vector (the slow, AffineConstraints-style path), written by
destination. Over a target list with entries ptr/idx/w,

    base(i)         = 0 if i is in zero_bits else x[i]
    out[i]          = base(i)                                (i not a target)
    out[targets[k]] = (base(targets[k]) if accumulate else 0)
                      + sum of w[e] * x[idx[e]] over e = ptr[k] .. ptr[k+1]

reading the original x throughout. Two modes of one kernel:

* distribute (u[slave] <- sum w u[master]): targets the slaves, idx the
  masters, no zeros, accumulate off;
* compress (C^T with the slaves zeroed): targets the masters, idx the slave
  of each entry, zero_bits the slaves, accumulate on; a master that is also
  a slave starts from 0, as the reference's set-then-add gives.

``tables`` builds both from the constraint CSR. Each target has one owner
thread that sums its entries in ascending order; no atomics.

Replaces the reference's ``distribute_slow`` and ``compress_slow``
(matrix_free.py:251-268: segment_sum, ``.at[].set`` and ``.at[].add``).
CUDA source: ``csrc/constraints_slow.cu``."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

NAME = "constraints_slow"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/matrix_free.py:251"


def dof_bits(dofs: np.ndarray, n: int) -> np.ndarray:
    """int32 [ceil(n/32)]: bit i % 32 of word i // 32 set for each dof."""
    bits = np.zeros((n + 31) // 32, dtype=np.uint32)
    dofs = np.asarray(dofs, dtype=np.int64)
    np.bitwise_or.at(bits, dofs >> 5, (np.uint32(1) << (dofs & 31).astype(np.uint32)))
    return bits.view(np.int32)


def tables(slave, row_ptr, col, w, n_dofs):
    """{"distribute": (targets, ptr, idx, w, target_bits, zero_bits,
    accumulate), "compress": (...)} as NumPy arrays (int32 indices) from the
    constraint CSR: slave [n_s], row_ptr [n_s+1], col (the masters), w."""
    slave = np.asarray(slave, dtype=np.int64)
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    if n_dofs >= 2**31 or len(col) >= 2**31:
        raise NotImplementedError(f"{NAME}: DoFs or entries exceed int32")
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    row = np.repeat(np.arange(len(slave)), np.diff(row_ptr))
    order = np.argsort(col, kind="stable")
    masters, counts = np.unique(col, return_counts=True)
    mptr = np.zeros(len(masters) + 1, dtype=np.int64)
    np.cumsum(counts, out=mptr[1:])
    slave_bits = dof_bits(slave, n_dofs)
    return {
        "distribute": (i32(slave), i32(row_ptr), i32(col), np.asarray(w), slave_bits, None,
                       False),
        "compress": (i32(masters), i32(mptr), i32(slave[row[order]]), np.asarray(w)[order],
                     dof_bits(masters, n_dofs), slave_bits, True),
    }


def bit_set(bits, n):
    """[n] bool from an int32 bit table."""
    i = torch.arange(n, device=bits.device)
    return ((bits.long()[i >> 5] >> (i & 31)) & 1).bool()


def constraints_slow_plain(x, targets, ptr, idx, w, target_bits, zero_bits, accumulate):
    """Plain PyTorch version (a new vector)."""
    out = x.clone()
    if zero_bits is not None:
        out[bit_set(zero_bits, x.numel())] = 0.0
    t = targets.long()
    k = torch.repeat_interleave(torch.arange(t.numel(), device=x.device),
                                (ptr[1:] - ptr[:-1]).long())
    sums = torch.zeros(t.numel(), dtype=x.dtype, device=x.device).index_add_(
        0, k, w * x[idx.long()])
    out[t] = (out[t] + sums) if accumulate else sums
    return out


_ARGS = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def constraints_slow(x, targets, ptr, idx, w, target_bits, zero_bits, accumulate):
    """x [n]; targets [n_t], ptr [n_t+1], idx int32, w of x's dtype;
    target_bits, zero_bits (or None) int32 bit tables -> new [n]."""
    if x.device.type == "cpu":
        return constraints_slow_plain(x, targets, ptr, idx, w, target_bits, zero_bits,
                                      accumulate)
    tensors = dict(x=x, targets=targets, ptr=ptr, idx=idx, w=w, target_bits=target_bits)
    if zero_bits is not None:
        tensors["zero_bits"] = zero_bits
    dev = _build.check_cuda(NAME, x.dtype, **tensors)
    n, n_t = x.numel(), targets.numel()
    words = (n + 31) // 32
    if any(t.dtype != torch.int32 for k, t in tensors.items() if k not in ("x", "w")):
        raise TypeError(f"{NAME}: the index tables must be int32")
    if (x.dim() != 1 or ptr.shape != (n_t + 1,) or idx.shape != w.shape
            or target_bits.shape != (words,)
            or (zero_bits is not None and zero_bits.shape != (words,))):
        raise ValueError(f"{NAME}: shapes x {tuple(x.shape)}, targets {tuple(targets.shape)}, "
                         f"ptr {tuple(ptr.shape)}, idx {tuple(idx.shape)}")
    out = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * 8)(x.data_ptr(), targets.data_ptr(), ptr.data_ptr(),
                                 idx.data_ptr(), w.data_ptr(), target_bits.data_ptr(),
                                 None if zero_bits is None else zero_bits.data_ptr(),
                                 out.data_ptr())
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(x.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, ptrs, n, n_t, int(bool(accumulate)))
    constraints_slow.launches += 1
    return out


constraints_slow.launches = 0


def bytes_and_flops(x, targets, ptr, idx, w, target_bits, zero_bits, accumulate):
    """Least traffic: x read once (each DoF; the entries' sources are DoFs
    of x), out written once, the tables and bit tables read once; a
    multiply and an add per entry."""
    isz = x.element_size()
    n_bits = target_bits.numel() + (0 if zero_bits is None else zero_bits.numel())
    nbytes = (2 * x.numel() + w.numel()) * isz + 4 * (
        targets.numel() + ptr.numel() + idx.numel() + n_bits)
    return nbytes, 2 * idx.numel()
