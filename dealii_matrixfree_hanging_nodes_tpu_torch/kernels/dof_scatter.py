"""Kernel 14, ``dof_scatter``: the index engine's scatter-add of cell rows
into a global vector, written by destination. With the transposed DoF map
(``transpose_map``: ptr [n_dofs+1] into the flat (cell, slot) positions of
each DoF, ascending), every DoF i gets

    dst[i] = sum of rows_flat[ent[e]] over e = ptr[i] .. ptr[i+1]   (0 where empty)

A DoF that no cell row names (a hanging DoF under the fast map, whose slots
hold coarse masters) gets 0, so the kernel writes every DoF and needs no
memset; one owner per DoF sums in a fixed order, so there are no atomics.

With a component axis (rows [k, n_cells, n_loc], k = 2 or 3,
component-major, as ``cell_elasticity`` writes them in 2-D and 3-D) dst is
[n_dofs, k], DoF-major: each
component summed as a scalar call on rows[c] would sum it, written beside
the others, so the transpose back to the reference's displacement layout
rides the scatter.

The kernel reads the rows in chunks of consecutive cells (``schedule``):
the DoFs whose entries all lie in one chunk are summed from the chunk's
rows staged in shared memory (their entries as offsets in the schedule),
the others from device memory, each in the same order; the plain version
takes the schedule and ignores it.

Replaces the reference's ``distribute_local_to_global(_plain)``
(matrix_free.py:281-297: ``zeros.at[dofmap].add(rows)``), with a component
axis the k of elasticity's ``_vmult`` and their stack
(models/elasticity.py:92-98). CUDA source: ``csrc/dof_scatter.cu``."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

NAME = "dof_scatter"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/matrix_free.py:281"


CHUNK_VALUES = 8192  # values a chunk's rows hold at most (the kernel's shared memory / K)
MAX_CHUNK_CELLS = 256


def chunk_cells(n_loc: int) -> int:
    """The most cells a chunk of the kernel holds for cells of n_loc
    values: CHUNK_VALUES values at most (f64 with 3 components: 192 KB of
    shared memory), MAX_CHUNK_CELLS cells at most."""
    return max(1, min(MAX_CHUNK_CELLS, CHUNK_VALUES // n_loc))


def schedule(ptr, ent, n_cells: int, n_loc: int, chunk: int | None = None) -> np.ndarray:
    """The kernel's block schedule, int32 [3 n_chunks + 2 + 2 n_dofs + 1 +
    ceil(n_ent / 2)], n_ent = ent's length. In order:
    * cstart [n_chunks + 1]: chunk j is cells cstart[j] .. cstart[j+1],
      ``chunk`` cells each (default ``chunk_cells(n_loc)``);
    * dptr [2 n_chunks + 1]: block b's DoFs are ids[dptr[b] .. dptr[b+1]];
    * ids [n_dofs]: each DoF once, ascending in each block. Block 2j takes
      the DoFs whose every entry lies in chunk j (local), block 2j+1 those
      whose last entry lies in chunk j and whose first does not (crossing);
      a DoF with no entry goes to a crossing block by its place among the
      DoFs (DoF i to block 2 (i n_chunks // n_dofs) + 1);
    * lptr [n_dofs + 1]: the local DoF at position q of ids has its entries
      at loff[lptr[q] .. lptr[q+1]] (none for a crossing DoF);
    * loff: the local DoFs' entries in ids' order, each ascending, as
      16-bit offsets into their chunk's values (ent - cstart[j] n_loc), two
      a word (little-endian), ceil(n_ent / 2) words, zero past the last.
    The kernel reads a local DoF's entries from lptr and loff, in block
    order, and a crossing DoF's from ptr and ent."""
    ptr = np.asarray(ptr, dtype=np.int64)
    ent = np.asarray(ent, dtype=np.int64)
    C = chunk_cells(n_loc) if chunk is None else int(chunk)
    if not 1 <= C <= chunk_cells(n_loc) or C * n_loc > 2**15:
        raise ValueError(f"{NAME}: a chunk of {C} cells; cells of {n_loc} values take 1 to "
                         f"{chunk_cells(n_loc)}")
    n_dofs = ptr.size - 1
    n_chunks = max(1, -(-n_cells // C))
    counts = np.diff(ptr)
    has = counts > 0
    span = C * n_loc
    first = ent[ptr[:-1][has]] // span
    last = ent[ptr[1:][has] - 1] // span
    chunk_of = np.arange(n_dofs, dtype=np.int64) * n_chunks // max(n_dofs, 1)
    chunk_of[has] = last
    crossing = np.ones(n_dofs, dtype=bool)
    crossing[has] = first != last
    block = 2 * chunk_of + crossing
    ids = np.argsort(block, kind="stable")
    dptr = np.zeros(2 * n_chunks + 1, dtype=np.int64)
    np.cumsum(np.bincount(block, minlength=2 * n_chunks), out=dptr[1:])
    cstart = np.minimum(np.arange(n_chunks + 1, dtype=np.int64) * C, n_cells)
    # the local DoFs' entries, in ids' order, as offsets into their chunk
    local = ~crossing[ids]
    n_pos = np.where(local, counts[ids], 0)
    lptr = np.zeros(n_dofs + 1, dtype=np.int64)
    np.cumsum(n_pos, out=lptr[1:])
    n_loc_ent = int(lptr[-1])
    within = np.arange(n_loc_ent) - np.repeat(lptr[:-1], n_pos)
    offsets = ent[np.repeat(ptr[ids], n_pos) + within] - np.repeat(
        cstart[chunk_of[ids]] * n_loc, n_pos)
    loff = np.zeros(2 * (-(-ent.size // 2)), dtype="<u2")
    loff[:n_loc_ent] = offsets
    head = np.concatenate([cstart, dptr, ids, lptr]).astype(np.int32)
    return np.concatenate([head, loff.view("<i4")])


def schedule_parts(sched, n_dofs: int, n_ent: int):
    """(cstart, dptr, ids, lptr, loff) of a schedule for n_dofs DoFs and
    n_ent entries (NumPy or torch; loff as int16, the offsets being below
    2^15); raises where its length fits no number of chunks."""
    n_words = -(-n_ent // 2)
    n_chunks, rem = divmod(sched.shape[0] - 2 * n_dofs - 3 - n_words, 3)
    if rem or n_chunks < 1:
        raise ValueError(f"{NAME}: a schedule of {sched.shape[0]} entries fits no chunks for "
                         f"{n_dofs} DoFs and {n_ent} entries")
    a = n_chunks + 1
    b = a + 2 * n_chunks + 1
    c = b + n_dofs
    d = c + n_dofs + 1
    words = sched[d:]
    loff = words.view(np.int16) if isinstance(words, np.ndarray) else words.view(torch.int16)
    return sched[:a], sched[a:b], sched[b:c], sched[c:d], loff


def transpose_map(dofmap: np.ndarray, n_dofs: int, chunk: int | None = None):
    """(ptr int32 [n_dofs+1], ent int32 [n_cells*n_loc], sched int32): the
    flat positions of each DoF in dofmap [n_cells, n_loc], ascending (a
    stable sort by DoF), and the kernel's block schedule (``schedule``)."""
    dofmap = np.asarray(dofmap)
    if dofmap.ndim != 2:
        raise ValueError(f"{NAME}: the DoF map must be [n_cells, n_loc], got {dofmap.shape}")
    flat = dofmap.reshape(-1)
    if flat.size >= 2**31 or n_dofs >= 2**31:
        raise NotImplementedError(f"{NAME}: cell-row positions exceed int32")
    ent = np.argsort(flat, kind="stable").astype(np.int32)
    ptr = np.zeros(n_dofs + 1, dtype=np.int64)
    np.cumsum(np.bincount(flat, minlength=n_dofs), out=ptr[1:])
    return ptr.astype(np.int32), ent, schedule(ptr, ent, *dofmap.shape, chunk)


def dof_scatter_plain(rows, ptr, ent, sched=None):
    """Plain PyTorch version: each entry's row value added at its DoF (a
    component axis: each component so, stacked on the last axis); the
    schedule is not read."""
    if rows.dim() == 3:
        return torch.stack([dof_scatter_plain(r, ptr, ent) for r in rows], dim=1)
    n = ptr.numel() - 1
    dof = torch.repeat_interleave(torch.arange(n, device=rows.device), (ptr[1:] - ptr[:-1]).long())
    return torch.zeros(n, dtype=rows.dtype, device=rows.device).index_add_(
        0, dof, rows.reshape(-1)[ent.long()])


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_void_p]


def dof_scatter(rows, ptr, ent, sched):
    """rows [n_cells, n_loc] or [k, n_cells, n_loc] (k = 2, 3); ptr
    [n_dofs+1], ent, sched int32 (``transpose_map``) -> new [n_dofs] or
    [n_dofs, k]."""
    if rows.device.type == "cpu":
        return dof_scatter_plain(rows, ptr, ent)
    dev = _build.check_cuda(NAME, rows.dtype, rows=rows, ptr=ptr, ent=ent, sched=sched)
    if ptr.dtype != torch.int32 or ent.dtype != torch.int32 or sched.dtype != torch.int32:
        raise TypeError(f"{NAME}: ptr, ent and sched must be int32")
    k = rows.shape[0] if rows.dim() == 3 else 1
    if (ptr.dim() != 1 or ent.dim() != 1 or sched.dim() != 1 or rows.numel() // k >= 2**31
            or rows.dim() not in (2, 3) or k not in (1, 2, 3)
            or ent.numel() != rows.numel() // k):
        raise ValueError(f"{NAME}: shapes rows {tuple(rows.shape)}, ptr {tuple(ptr.shape)}, "
                         f"ent {tuple(ent.shape)}, sched {tuple(sched.shape)}")
    n = ptr.numel() - 1
    n_loc = rows.shape[-1]
    n_chunks = schedule_parts(sched, n, ent.numel())[0].numel() - 1
    dst = torch.empty((n, k) if rows.dim() == 3 else (n,), dtype=rows.dtype, device=rows.device)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(rows.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(rows), _build.ptr(ptr), _build.ptr(ent),
                  _build.ptr(sched), _build.ptr(dst), n, n_loc, n_chunks, chunk_cells(n_loc), k,
                  rows.numel() // k)
    dof_scatter.launches += 1
    return dst


dof_scatter.launches = 0


def bytes_and_flops(rows, ptr, ent, sched=None):
    """Least traffic of the function (distribute_local_to_global, for each
    component of a component axis): the rows read once, one int32 DoF index
    per (cell, slot) entry read once (the DoF map's size, what ``index_add_``
    reads), dst written once. ptr and the schedule are left out: they exist
    only because of the layout this kernel chose. An add per entry and
    component."""
    n = ptr.numel() - 1
    k = rows.shape[0] if rows.dim() == 3 else 1
    nbytes = (rows.numel() + k * n) * rows.element_size() + 4 * ent.numel()
    return nbytes, k * ent.numel()
