"""Kernel 18, ``cell_transfer``: the index engine's GMG transfer between two
levels of global coarsening, on cell rows of n^dim values (dim 2 or 3, the
length of E's axis 1). Each fine cell f has its covering coarse cell
cover[f] and an embedding E[f] [dim, n, n] (one matrix an axis, x first;
``models.multigrid.covering_embedding``), and each fine DoF one owner (f,
slot) (``own``, the first writer in cell order).

* prolongate: x the coarse cell rows [n_c, n^dim] (``read_dof_values`` of
  the coarse vector: HN-resolved), out a fine DoF vector:
      u_f = (E[f,2] (x) E[f,1] (x) E[f,0]) x[cover[f]]    (sweeps along x, y, z;
                                                           2-D: along x, y)
      out[cdf[f, j]] = u_f[j] where own[f, j]
  Every fine DoF has exactly one owner, so every entry of out is written
  once: no sum, no memset.
* restrict (its exact adjoint, before HN^T and the scatter): x a fine DoF
  vector, out the coarse cell rows [n_c, n^dim]:
      out[c] = sum over the fine cells f of c (ascending) of
               E^T-sweeps (z, y, x; 2-D: y, x) of (own[f] * x[cdf[f]])
  from a CSR list of each coarse cell's children (child_ptr, child). The
  coarse ``distribute_local_to_global`` (cell_laplace's HN^T, dof_scatter)
  follows.

The restrict takes whole families (a coarse cell and its children) a
block, by a host schedule ``blocks`` (``schedule``: where each block starts
in the coarse cells, the child lists and the fine cells; about 256 lines a
block), the prolongate consecutive fine cells; the plain version takes the
schedule and ignores it.

Replaces the reference's ``Transfer.prolongate`` and ``Transfer.restrict``
(models/multigrid.py:274-296: the cover gather, ``_embed`` / ``_embed_t``
einsums, ``.at[cdf].add`` and ``.at[cover].add``).
CUDA source: ``csrc/cell_transfer.cu`` (the sweeps in ``csrc/transfer.cuh``)."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

NAME = "cell_transfer"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/models/multigrid.py:274"
MODES = ("prolongate", "restrict")
DEGREES = (1, 2, 3, 4, 5, 6)  # the index engine's


LINE_BUDGET = 256  # lines a block: the most refined families within it, at least one


def block_shape(n: int, dim: int):
    """(lines a fine cell, the most fine cells a block) of the kernel's
    instance for n = p+1 nodes a side (transfer.cuh's Families)."""
    lines = n ** (dim - 1)
    family = 2**dim * lines
    return lines, family * max(1, LINE_BUDGET // family) // lines


def schedule(child_ptr, child, n: int, dim: int) -> np.ndarray:
    """The restrict's blocks: int32 [n_blocks+1, 3], each block's first
    coarse cell, its first position in the child lists and its first fine
    cell where its children are consecutive fine cells (else -1); the last
    row (n_c, n_f, -1) closes the ranges. Whole families (a coarse cell and
    its children, child_ptr's ranges) are packed in order, a block taking
    the next family while its fine cells stay within the instance's most
    (``block_shape``) and its coarse cells too (a childless coarse cell
    counts one). Raises where a family alone exceeds it."""
    child_ptr = np.asarray(child_ptr, dtype=np.int64)
    child = np.asarray(child, dtype=np.int64)
    counts = np.diff(child_ptr)
    _, maxf = block_shape(n, dim)
    if counts.size and counts.max() > maxf:
        raise ValueError(f"{NAME}: a family of {int(counts.max())} fine cells exceeds a block's "
                         f"{maxf}")
    bounds, nf, nc = [0], 0, 0
    for c, k in enumerate(counts.tolist()):
        if nc and (nf + k > maxf or nc == maxf):
            bounds.append(c)
            nf, nc = 0, 0
        nf += k
        nc += 1
    if nc:
        bounds.append(counts.size)
    c0 = np.asarray(bounds, dtype=np.int64)
    p0 = child_ptr[c0]
    # breaks[i]: the steps other than +1 among the child list's positions 0 .. i; a block's
    # children are consecutive fine cells where none lies inside its range
    breaks = np.concatenate([[0], np.cumsum(np.diff(child) != 1)])
    lo, hi = p0[:-1], p0[1:]
    run = hi > lo
    run[run] = breaks[hi[run] - 1] == breaks[lo[run]]
    first = np.full(c0.size, -1, dtype=np.int64)
    first[:-1][run] = child[lo[run]]
    return np.stack([c0, p0, first], axis=1).astype(np.int32)


def embed_rows(u, E, transpose):
    """Rows u [m, n^dim] (x fastest) through the per-row embedding E [m, dim,
    n, n]: E[:, 0] along x, then E[:, 1] along y (then E[:, 2] along z);
    transposed: the transposes in reverse order (a new tensor)."""
    m, dim, n = E.shape[0], E.shape[1], E.shape[-1]
    v = u.reshape(m, *([n] * dim))  # spatial axis t at array axis dim - t
    for t in (reversed(range(dim)) if transpose else range(dim)):
        v = torch.movedim(v, dim - t, -1)
        v = torch.einsum("mji,m...j->m...i" if transpose else "mij,m...j->m...i", E[:, t], v)
        v = torch.movedim(v, -1, dim - t)
    return v.reshape(u.shape)


def _mode(mode):
    if mode not in MODES:
        raise ValueError(f"{NAME}: unknown mode {mode!r}")
    return mode


def cell_transfer_plain(x, E, cdf, own, cover, child_ptr, child, n_fine_dofs, blocks=None,
                        mode="prolongate"):
    """Plain PyTorch version (a new tensor); the schedule is not read."""
    if _mode(mode) == "prolongate":
        u = embed_rows(x[cover.long()], E, False)
        out = torch.zeros(n_fine_dofs, dtype=x.dtype, device=x.device)
        out[cdf.long()[own]] = u[own]
        return out
    n_c = child_ptr.numel() - 1
    rows = child.long()
    u = torch.where(own[rows], x[cdf.long()[rows]], 0.0)
    u = embed_rows(u, E[rows], True)
    parent = torch.repeat_interleave(torch.arange(n_c, device=x.device),
                                     (child_ptr[1:] - child_ptr[:-1]).long())
    return torch.zeros((n_c, cdf.shape[1]), dtype=x.dtype, device=x.device).index_add_(
        0, parent, u)


_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def cell_transfer(x, E, cdf, own, cover, child_ptr, child, n_fine_dofs, blocks,
                  mode="prolongate"):
    """prolongate: x [n_c, n^dim] -> new [n_fine_dofs]; restrict: x
    [n_fine_dofs] -> new [n_c, n^dim]. E [n_f, dim, n, n] of x's dtype (dim
    2 or 3), cdf int32 [n_f, n^dim], own bool [n_f, n^dim], cover int32
    [n_f], child_ptr int32 [n_c+1], child int32 [n_f] (cover's inverse,
    ascending in each family), blocks int32 [n_blocks+1, 3] (``schedule(
    child_ptr, child, n, dim)``)."""
    args = (x, E, cdf, own, cover, child_ptr, child, n_fine_dofs)
    restrict = _mode(mode) == "restrict"
    if x.device.type == "cpu":
        return cell_transfer_plain(*args, mode=mode)
    dev = _build.check_cuda(NAME, x.dtype, x=x, E=E, cdf=cdf, own=own, cover=cover,
                            child_ptr=child_ptr, child=child, blocks=blocks)
    if any(t.dtype != torch.int32 for t in (cdf, cover, child_ptr, child, blocks)) or (
            own.dtype != torch.bool):
        raise TypeError(f"{NAME}: cdf, cover, child_ptr, child and blocks must be int32, "
                        f"own bool")
    n_f, n_loc = cdf.shape
    n, dim = E.shape[-1], E.shape[1]
    n_c = child_ptr.numel() - 1
    if (n - 1 not in DEGREES or dim not in _build.DIMS or n**dim != n_loc
            or E.shape != (n_f, dim, n, n)
            or own.shape != cdf.shape or cover.shape != (n_f,) or child.shape != (n_f,)
            or x.shape != ((n_fine_dofs,) if restrict else (n_c, n_loc))
            or blocks.dim() != 2 or blocks.shape[1] != 3
            or not 1 <= blocks.shape[0] <= n_c + 1
            or n_f * n_loc >= 2**31):
        raise ValueError(f"{NAME}: shapes x {tuple(x.shape)}, E {tuple(E.shape)}, cdf "
                         f"{tuple(cdf.shape)}, cover {tuple(cover.shape)}, child_ptr "
                         f"{tuple(child_ptr.shape)}, blocks {tuple(blocks.shape)}")
    out = torch.empty((n_c, n_loc) if restrict else (n_fine_dofs,), dtype=x.dtype,
                      device=x.device)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(x.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, *(_build.ptr(t) for t in (x, E, cdf, own, cover, child_ptr,
                                                           child, blocks, out)),
                  n_f, blocks.shape[0] - 1, n - 1, int(restrict), dim)
    cell_transfer.launches += 1
    return out


cell_transfer.launches = 0


def bytes_and_flops(x, E, cdf, own, cover, child_ptr, child, n_fine_dofs, blocks=None,
                    mode="prolongate"):
    """Least traffic: x read once, out written once, E and the lists read
    once (own at one bit a slot; cover in prolongate, child_ptr and child in
    restrict), cdf only at the owned slots (one a fine DoF). Operations: the
    dim sweeps of 2 n^(dim+1) a fine cell (and an add a slot in restrict)."""
    n_f, n_loc = cdf.shape
    n, dim = E.shape[-1], E.shape[1]
    isz = x.element_size()
    n_c = child_ptr.numel() - 1
    nbytes = (x.numel() + (n_fine_dofs if mode == "prolongate" else n_c * n_loc)
              + E.numel()) * isz + 4 * int(own.sum()) + (own.numel() + 7) // 8
    nbytes += 4 * (n_f if mode == "prolongate" else child_ptr.numel() + child.numel())
    return nbytes, n_f * (dim * 2 * n ** (dim + 1) + (n_loc if mode == "restrict" else 0))
