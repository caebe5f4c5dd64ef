"""Kernel 13, ``cell_laplace``: the index engine's cell kernel, one launch
from a global vector (or cell rows) to cell rows [n_cells, n_loc]. For each
cell c, in this order:

1. read: src[dofmap[c]] (a global vector through the fast or plain DoF map)
   or the row src[c] (the DG path, dofmap None);
2. HN: the hanging-node interpolation of the row (``hn_in``) by its mask
   through the sweeps (mask 0: none); codes None skips 2 and 4. The four
   runners of ``MatrixFree`` compute this one function, so their vmults share
   this kernel;
3. Laplace (``quad``): gradients by S and Dc, times geo[c, d] * quad_w at
   each point (Cartesian geo [n_cells, 3]) or the packed symmetric metric
   (deformed geo [n_cells, n_q, 6], which holds w * detJ), integrated back;
4. HN^T (``hn_out``);
5. write the row.

Replaces the reference's ``read_dof_values(_plain)`` (matrix_free.py:
270-279: the dofmap gather and the forward runner), the Laplace cell kernel
``laplace_cell_kernel`` (models/laplace.py:20-49, with
ops/sum_factorization.py:57-89) and the transposed runner inside
``distribute_local_to_global`` (matrix_free.py:295). The scatter-add is
``dof_scatter``. CUDA source: ``csrc/cell_laplace.cu`` (the HN sweeps in
``csrc/hanging_nodes.cuh``)."""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..ops.hanging_nodes import masked_sweeps
from ..ops.sum_factorization import evaluate_gradients, integrate_gradients
from .hn_interp import DEGREES, masked_lines

NAME = "cell_laplace"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/models/laplace.py:20"
PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))  # the packed metric's order


def laplace_rows(u, S, Dc, quad_w, geo):
    """The Laplace cell kernel on rows u [cells, n_loc] (the reference's
    ``laplace_cell_kernel``): Cartesian geo [cells, 3] with quad_w, or the
    deformed metric [cells, n_q, 6]."""
    g = evaluate_gradients(u, S, Dc, 3)  # [c, 3, nq]
    if geo.dim() == 2:
        g = g * geo[:, :, None] * quad_w[None, None, :]
    else:
        out = [torch.zeros_like(g[:, 0]) for _ in range(3)]
        for k, (x, y) in enumerate(PAIRS):
            out[x] = out[x] + geo[:, :, k] * g[:, y]
            if x != y:
                out[y] = out[y] + geo[:, :, k] * g[:, x]
        g = torch.stack(out, dim=1)
    return integrate_gradients(g, S, Dc, 3)


def hn_rows(u, codes, P, transpose):
    """The rows' interpolation by their masks (a new tensor)."""
    out = u.clone()
    sel = torch.nonzero(codes != 0)[:, 0]
    out[sel] = masked_sweeps(u[sel], codes[sel], P, transpose)
    return out


def cell_laplace_plain(src, dofmap, codes, P, S, Dc, quad_w, geo, *, hn_in=True, quad=True,
                       hn_out=True):
    """Plain PyTorch version: the steps one after another (a new tensor)."""
    u = src[dofmap.long()] if dofmap is not None else src.clone()
    if codes is not None and hn_in:
        u = hn_rows(u, codes, P, False)
    if quad:
        u = laplace_rows(u, S, Dc, quad_w, geo)
    if codes is not None and hn_out:
        u = hn_rows(u, codes, P, True)
    return u


_ARGS = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
HN_IN, QUAD, HN_OUT, DEFORMED = 1, 2, 4, 8


def cell_laplace(src, dofmap, codes, P, S, Dc, quad_w, geo, *, hn_in=True, quad=True,
                 hn_out=True):
    """src [n_dofs] with dofmap int32 [n_cells, n_loc], or rows [n_cells,
    n_loc] with dofmap None; codes int32 [n_cells] (masks) or None; P [2,
    n, n], S, Dc [n, n], quad_w [n^3], geo [n_cells, 3] or [n_cells, n^3,
    6], all of src's dtype on its device
    (geo, S, Dc, quad_w are not read without quad) -> new [n_cells, n_loc]."""
    args = (src, dofmap, codes, P, S, Dc, quad_w, geo)
    flags = dict(hn_in=hn_in, quad=quad, hn_out=hn_out)
    if src.device.type == "cpu":
        return cell_laplace_plain(*args, **flags)
    n = P.shape[-1]
    n_loc = n**3
    n_cells = dofmap.shape[0] if dofmap is not None else src.shape[0]
    names = ("src", "dofmap", "codes", "P", "S", "Dc", "quad_w", "geo")
    dev = _build.check_cuda(NAME, src.dtype, **{k: t for k, t in zip(names, args)
                                                if t is not None})
    if any(t is not None and t.dtype != torch.int32 for t in (dofmap, codes)):
        raise TypeError(f"{NAME}: dofmap and codes must be int32")
    deformed = quad and geo.dim() == 3
    bad = (n - 1 not in DEGREES or P.shape != (2, n, n)
           or (dofmap is not None and (dofmap.shape != (n_cells, n_loc) or src.dim() != 1))
           or (dofmap is None and src.shape != (n_cells, n_loc))
           or n_cells * n_loc >= 2**31
           or (codes is not None and codes.shape != (n_cells,))
           or (quad and (S.shape != (n, n) or Dc.shape != (n, n) or quad_w.shape != (n_loc,)
                         or geo.shape != ((n_cells, n_loc, 6) if deformed else (n_cells, 3)))))
    if bad:
        raise ValueError(f"{NAME}: shapes src {tuple(src.shape)}, dofmap "
                         f"{None if dofmap is None else tuple(dofmap.shape)}, P {tuple(P.shape)}, "
                         f"geo {None if geo is None else tuple(geo.shape)}")
    out = torch.empty((n_cells, n_loc), dtype=src.dtype, device=src.device)
    if n_cells == 0:
        return out
    ptrs = (ctypes.c_void_p * 9)(*(None if t is None else t.data_ptr() for t in args),
                                  out.data_ptr())
    bits = ((HN_IN if hn_in else 0) | (QUAD if quad else 0) | (HN_OUT if hn_out else 0)
            | (DEFORMED if deformed else 0))
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(src.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, ptrs, n_cells, n - 1, bits)
    cell_laplace.launches += 1
    return out


cell_laplace.launches = 0


def bytes_and_flops(src, dofmap, codes, P, S, Dc, quad_w, geo, *, hn_in=True, quad=True,
                    hn_out=True):
    """Least traffic: the distinct source values read once (the DoFs that
    dofmap names, or every row), dofmap, codes and geo read once, the rows
    written once, the factors read once. Operations: the interpolation's
    (2 n^2 a masked line) in each direction asked for; the Laplace's 12 sweeps of 2 n^4 a cell and
    its point work (3 multiplies a point Cartesian times 2, 15 deformed)."""
    n = P.shape[-1]
    n_loc, isz = n**3, src.element_size()
    n_cells = dofmap.shape[0] if dofmap is not None else src.shape[0]
    n_src = (int(torch.unique(dofmap).numel()) if dofmap is not None else src.numel())
    nbytes = (n_src + n_cells * n_loc + 2 * n * n + 2 * n * n) * isz
    nbytes += 4 * (0 if dofmap is None else dofmap.numel())
    flops = 0
    if codes is not None and (hn_in or hn_out):
        nbytes += 4 * n_cells
        per_dir = 2 * n * n * int(masked_lines(codes.cpu().numpy(), n - 1).sum())
        flops += per_dir * (int(hn_in) + int(hn_out))
    if quad:
        nbytes += (geo.numel() + (0 if geo.dim() == 3 else n_loc)) * isz
        flops += n_cells * (12 * 2 * n**4 + (15 if geo.dim() == 3 else 6) * n_loc)
    return nbytes, flops
