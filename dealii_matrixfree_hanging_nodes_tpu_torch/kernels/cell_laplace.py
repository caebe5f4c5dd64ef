"""Kernel 13, ``cell_laplace``: the index engine's cell kernel, one launch
from a global vector (or cell rows) to cell rows [n_cells, n_loc], n_loc =
(p+1)^dim in 2-D or 3-D. For each cell c, in this order:

1. read: src[dofmap[c]] (a global vector through the fast or plain DoF map)
   or the row src[c] (the DG path, dofmap None);
2. HN: the hanging-node interpolation of the row (``hn_in``) by its mask
   through the sweeps (mask 0: none); codes None skips 2 and 4. The four
   runners of ``MatrixFree`` compute this one function, so their vmults share
   this kernel;
3. Laplace (``quad``): gradients by S and Dc, times geo[c, d] * quad_w at
   each point (Cartesian geo [n_cells, dim]) or the packed symmetric metric
   (deformed geo [n_cells, n_q, dim (dim+1) / 2], the upper triangle row by
   row: xx, xy, xz, yy, yz, zz in 3-D, xx, xy, yy in 2-D; it holds w *
   detJ), integrated back;
4. HN^T (``hn_out``);
5. write the row.

Replaces the reference's ``read_dof_values(_plain)`` (matrix_free.py:
270-279: the dofmap gather and the forward runner), the Laplace cell kernel
``laplace_cell_kernel`` (models/laplace.py:20-49, with
ops/sum_factorization.py:57-89) and the transposed runner inside
``distribute_local_to_global`` (matrix_free.py:295). The scatter-add is
``dof_scatter``. CUDA source: ``csrc/cell_laplace.cu`` (the HN sweeps in
``csrc/hanging_nodes.cuh``). With the quadrature the kernel owns a z-column
of a cell a thread (2-D: a y-column) and computes the same operator with
the basis derivatives D = Dc S, every sweep even-odd; the even-odd splits of
S, D and their transposes (``_even_odd.factor_tables``, ``MatrixFree.kernel_factors``)
travel as the launch's parameters (``factors=``). The plain version runs
the collocation form."""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._even_odd import check_factors
from ..ops.hanging_nodes import masked_sweeps
from ..ops.sum_factorization import evaluate_gradients, integrate_gradients
from .hn_interp import DEGREES, masked_lines

NAME = "cell_laplace"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/models/laplace.py:20"


def metric_pairs(dim):
    """The packed metric's order: the upper triangle row by row."""
    return [(x, y) for x in range(dim) for y in range(x, dim)]


def cell_dim(src, dofmap, P):
    """The dimension of a cell_laplace call: the d in (2, 3) with (p+1)^d
    == n_loc, the rows' width."""
    n_loc = dofmap.shape[-1] if dofmap is not None else src.shape[-1]
    return _build.lattice_dim(NAME, P.shape[-1], n_loc)


def is_deformed(geo, n_cells, n, dim):
    """Which geometry geo is, from its shape checked in full against dim:
    Cartesian [n_cells, dim] (False) or the packed metric [n_cells, n^dim,
    dim (dim+1) / 2] (True); raises for anything else."""
    if tuple(geo.shape) == (n_cells, dim):
        return False
    if tuple(geo.shape) == (n_cells, n**dim, dim * (dim + 1) // 2):
        return True
    raise ValueError(f"{NAME}: geo {tuple(geo.shape)} is neither the Cartesian factors "
                     f"({n_cells}, {dim}) nor the packed metric ({n_cells}, {n**dim}, "
                     f"{dim * (dim + 1) // 2}) of dim={dim}")


def laplace_rows(u, S, Dc, quad_w, geo, dim=3):
    """The Laplace cell kernel on rows u [cells, n_loc] (the reference's
    ``laplace_cell_kernel``): Cartesian geo [cells, dim] with quad_w, or the
    deformed metric [cells, n_q, dim (dim+1) / 2]."""
    g = evaluate_gradients(u, S, Dc, dim)  # [c, dim, nq]
    if not is_deformed(geo, u.shape[0], S.shape[-1], dim):
        g = g * geo[:, :, None] * quad_w[None, None, :]
    else:
        out = [torch.zeros_like(g[:, 0]) for _ in range(dim)]
        for k, (x, y) in enumerate(metric_pairs(dim)):
            out[x] = out[x] + geo[:, :, k] * g[:, y]
            if x != y:
                out[y] = out[y] + geo[:, :, k] * g[:, x]
        g = torch.stack(out, dim=1)
    return integrate_gradients(g, S, Dc, dim)


def hn_rows(u, codes, P, transpose, dim=3):
    """The rows' interpolation by their masks (a new tensor)."""
    out = u.clone()
    sel = torch.nonzero(codes != 0)[:, 0]
    out[sel] = masked_sweeps(u[sel], codes[sel], P, transpose, dim)
    return out


def cell_laplace_plain(src, dofmap, codes, P, S, Dc, quad_w, geo, *, hn_in=True, quad=True,
                       hn_out=True, factors=None):
    """Plain PyTorch version: the steps one after another (a new tensor);
    it reads S and Dc, and takes the kernel's factors only to share the
    wrapper's signature."""
    dim = cell_dim(src, dofmap, P)
    u = src[dofmap.long()] if dofmap is not None else src.clone()
    if codes is not None and hn_in:
        u = hn_rows(u, codes, P, False, dim)
    if quad:
        u = laplace_rows(u, S, Dc, quad_w, geo, dim)
    if codes is not None and hn_out:
        u = hn_rows(u, codes, P, True, dim)
    return u


_ARGS = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
HN_IN, QUAD, HN_OUT, DEFORMED = 1, 2, 4, 8


def cell_laplace(src, dofmap, codes, P, S, Dc, quad_w, geo, *, hn_in=True, quad=True,
                 hn_out=True, factors=None):
    """src [n_dofs] with dofmap int32 [n_cells, n_loc], or rows [n_cells,
    n_loc] with dofmap None (n_loc = n^dim, dim 2 or 3, read from n_loc);
    codes int32 [n_cells] (masks) or None; P [2, n, n], S, Dc [n, n],
    quad_w [n^dim], geo [n_cells, dim] or [n_cells, n^dim, dim (dim+1) / 2],
    all of src's dtype on its device (geo, S, Dc, quad_w are not read
    without quad; the kernel reads S and Dc through ``factors``). factors:
    the kernel's launch parameters, ``factor_tables(S, Dc)`` (float64 NumPy,
    ``MatrixFree.kernel_factors``), required on the kernel path with quad
    -> new [n_cells, n_loc]."""
    args = (src, dofmap, codes, P, S, Dc, quad_w, geo)
    flags = dict(hn_in=hn_in, quad=quad, hn_out=hn_out)
    if src.device.type == "cpu":
        return cell_laplace_plain(*args, **flags)
    n = P.shape[-1]
    dim = cell_dim(src, dofmap, P)
    n_loc = n**dim
    n_cells = dofmap.shape[0] if dofmap is not None else src.shape[0]
    names = ("src", "dofmap", "codes", "P", "S", "Dc", "quad_w", "geo")
    dev = _build.check_cuda(NAME, src.dtype, **{k: t for k, t in zip(names, args)
                                                if t is not None})
    if any(t is not None and t.dtype != torch.int32 for t in (dofmap, codes)):
        raise TypeError(f"{NAME}: dofmap and codes must be int32")
    deformed = quad and is_deformed(geo, n_cells, n, dim)
    bad = (n - 1 not in DEGREES or P.shape != (2, n, n)
           or (dofmap is not None and (dofmap.shape != (n_cells, n_loc) or src.dim() != 1))
           or (dofmap is None and src.shape != (n_cells, n_loc))
           or n_cells * n_loc >= 2**31
           or (codes is not None and codes.shape != (n_cells,))
           or (quad and (S.shape != (n, n) or Dc.shape != (n, n) or quad_w.shape != (n_loc,))))
    if bad:
        raise ValueError(f"{NAME}: shapes src {tuple(src.shape)}, dofmap "
                         f"{None if dofmap is None else tuple(dofmap.shape)}, P {tuple(P.shape)}, "
                         f"geo {None if geo is None else tuple(geo.shape)}")
    if quad:
        check_factors(NAME, factors, n)
    out = torch.empty((n_cells, n_loc), dtype=src.dtype, device=src.device)
    if n_cells == 0:
        return out
    ptrs = (ctypes.c_void_p * 10)(*(None if t is None else t.data_ptr() for t in args),
                                   out.data_ptr(), factors.ctypes.data if quad else None)
    bits = ((HN_IN if hn_in else 0) | (QUAD if quad else 0) | (HN_OUT if hn_out else 0)
            | (DEFORMED if deformed else 0))
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(src.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, ptrs, n_cells, n - 1, bits, dim)
    cell_laplace.launches += 1
    return out


cell_laplace.launches = 0


def bytes_and_flops(src, dofmap, codes, P, S, Dc, quad_w, geo, *, hn_in=True, quad=True,
                    hn_out=True):
    """Least traffic: the distinct source values read once (the DoFs that
    dofmap names, or every row), dofmap, codes and geo read once, the rows
    written once, the factors read once. Operations: the interpolation's
    (2 n^2 a masked line) in each direction asked for; the Laplace's 4 dim
    sweeps of 2 n^(dim+1) a cell (dim of S and dim of Dc, and their
    transposes) and its point work (2 dim multiplies a point Cartesian; 15
    deformed in 3-D, 6 in 2-D)."""
    n = P.shape[-1]
    dim = cell_dim(src, dofmap, P)
    n_loc, isz = n**dim, src.element_size()
    n_cells = dofmap.shape[0] if dofmap is not None else src.shape[0]
    n_src = (int(torch.unique(dofmap).numel()) if dofmap is not None else src.numel())
    nbytes = (n_src + n_cells * n_loc + 2 * n * n + 2 * n * n) * isz
    nbytes += 4 * (0 if dofmap is None else dofmap.numel())
    flops = 0
    if codes is not None and (hn_in or hn_out):
        nbytes += 4 * n_cells
        per_dir = 2 * n * n * int(masked_lines(codes.cpu().numpy(), n - 1, dim).sum())
        flops += per_dir * (int(hn_in) + int(hn_out))
    if quad:
        deformed = is_deformed(geo, n_cells, n, dim)
        nbytes += (geo.numel() + (0 if deformed else n_loc)) * isz
        point = (15 if dim == 3 else 6) if deformed else 2 * dim
        flops += n_cells * (4 * dim * 2 * n ** (dim + 1) + point * n_loc)
    return nbytes, flops
