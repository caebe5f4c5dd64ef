"""The Chebyshev-smoothed global-coarsening GMG over ranks (BASELINE row 4),
the port of ``dealii_matrixfree_hanging_nodes_tpu.parallel.
multigrid_distributed``: every level's operator is a ``DistributedLaplace``
with Dirichlet rows masked in the padded owner-major numbering, the
Chebyshev smoother runs on the rank's blocks with group norms, and the
level transfers read the coarse (or fine) blocks through one all_gather,
embed the rank's fine cells' values (``cell_laplace``'s read and HN, then
``cell_transfer``; restriction: ``cell_transfer``, then ``cell_laplace``'s
HN^T) and return the contributions through ``dof_scatter`` and one
psum_scatter, the collective pattern of the operator's ghost exchange
(benchmark_02.cc:122-133).

A rank's vectors are its padded block; the group dot (the rank's sum over
its whole block, pads included, then an all_reduce) is the global dot of
the reference's padded vectors, so ``solve_cg(op, b, M, dot=op.dot)`` runs
on them as the reference's solve_cg runs on its sharded arrays; the
smoother's power iteration starts from row r of the reference's
default_rng(7) draw at the padded shape [R, n_own_max].
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..kernels import cell_laplace, cell_transfer, dof_scatter
from ..matrix_free import MatrixFree
from ..mesh import create_geometry
from ..models.multigrid import (ChebyshevSmoother, DirichletLaplace, covering_embedding,
                                first_owners, operator_diagonal, solve_cg)
from . import comm
from .distributed import DistributedLaplace

__all__ = ["DistributedDirichletLaplace", "DistributedTransfer", "DistributedGMGPreconditioner",
           "transfer_plan"]


def _pad_cells(arr, rank_of_cell, R, fill=0):
    """Per-rank padded stack of a per-cell array: [R, m_max, ...] (the
    reference's layout of the transfer tables)."""
    counts = np.bincount(rank_of_cell, minlength=R)
    m = max(int(counts.max()), 1)
    out = np.full((R, m) + arr.shape[1:], fill, dtype=arr.dtype)
    for r in range(R):
        out[r, : counts[r]] = arr[rank_of_cell == r]
    return out


class DistributedDirichletLaplace(nn.Module):
    """``DistributedLaplace`` with homogeneous Dirichlet rows acting as the
    identity (the GMG stack's SPD operator), on the rank's padded block."""

    def __init__(self, mf: MatrixFree, group=None, device=None, weights=None):
        super().__init__()
        self.mf = mf
        self.dop = DistributedLaplace(mf, group=group, device=device, weights=weights)
        self.device, self.dtype, self.group = self.dop.device, self.dop.dtype, self.dop.group
        mask = np.zeros(self.dop.n_padded, dtype=bool)
        mask[self.dop.padded_id[mf.dof_handler.boundary_dofs()]] = True
        n, r = self.dop.n_own_max, self.dop.rank
        self.register_buffer("bmask", torch.from_numpy(mask[r * n:(r + 1) * n]).to(self.device))

    def vmult(self, src):
        out = self.dop.vmult(torch.where(self.bmask, 0.0, src))
        return torch.where(self.bmask, src, out)

    def project_rhs(self, b):
        return torch.where(self.bmask, 0.0, b)

    def scatter_vector(self, u):
        return self.dop.scatter_vector(u)

    def gather_vector(self, v):
        return self.dop.gather_vector(v)

    def dot(self, u, v) -> torch.Tensor:
        """The global dot of two padded vectors: the rank's sum over its block,
        then an all_reduce (every rank calls it)."""
        return comm.psum(torch.dot(u, v).reshape(1), self.group)[0]

    def norm(self, u) -> torch.Tensor:
        return torch.sqrt(self.dot(u, u))


def transfer_plan(mf_coarse: MatrixFree, mf_fine: MatrixFree, dop_c, dop_f) -> dict:
    """The reference's transfer tables of all ranks ([R, m_max, ...], NumPy):
    each fine cell's covering coarse cell's DoFs in the coarse padded
    numbering (covmap), its own plain DoFs in the fine padded numbering
    (cdf), the covering cell's masks, the embedding E and the owner mask,
    padded per rank by the fine operator's partition."""
    cover, E = covering_embedding(mf_coarse, mf_fine)
    cdf_plain = np.asarray(mf_fine.dof_handler.cell_dofs)
    rank_f, R = dop_f.rank_of_cell, dop_f.n_ranks
    covmap = dop_c.padded_id[np.asarray(mf_coarse._np["dofmap"])[cover]].astype(np.int32)
    cdf = dop_f.padded_id[np.asarray(mf_fine._np["dofmap_plain"])].astype(np.int32)
    masks = np.asarray(mf_coarse._np["masks"])[cover].astype(np.int32)
    own = first_owners(cdf_plain)
    return dict(covmap=_pad_cells(covmap, rank_f, R), cdf=_pad_cells(cdf, rank_f, R),
                cov_masks=_pad_cells(masks, rank_f, R), E=_pad_cells(E, rank_f, R),
                own=_pad_cells(own.astype(E.dtype), rank_f, R),
                n_cells_r=np.bincount(rank_f, minlength=R))


class DistributedTransfer(nn.Module):
    """Prolongation and restriction between two distributed levels: each
    rank handles the fine cells its fine operator owns. Prolongate: the
    coarse blocks gathered, cell_laplace reads each fine cell's covering
    coarse cell through the padded numbering and interpolates its hanging
    nodes, cell_transfer embeds the rows and writes the values the rank's
    cells own (one a fine DoF, globally), dof_scatter puts them into the
    padded fine vector, psum_scatter returns the blocks. Restrict, its exact
    adjoint: the fine blocks gathered, cell_transfer's restrict on the
    rank's cells (own * x[cdf], E^T), cell_laplace's HN^T, dof_scatter into
    the padded coarse vector, psum_scatter."""

    def __init__(self, mf_coarse: MatrixFree, mf_fine: MatrixFree, dop_c, dop_f):
        super().__init__()
        dop_c = getattr(dop_c, "dop", dop_c)
        dop_f = getattr(dop_f, "dop", dop_f)
        self.group, self.device, self.dtype = dop_f.group, dop_f.device, dop_f.dtype
        r = dop_f.rank
        t = transfer_plan(mf_coarse, mf_fine, dop_c, dop_f)
        n = int(t["n_cells_r"][r])
        covmap, cdf = t["covmap"][r, :n], t["cdf"][r, :n]
        own = t["own"][r, :n] > 0
        dev = self.device
        i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
        self.n_cells = n
        self.n_padded_c, self.n_padded_f = dop_c.n_padded, dop_f.n_padded
        # the values the rank's cells own, numbered in (cell, slot) order
        n_owned = int(own.sum())
        cdf_local = np.zeros(cdf.shape, dtype=np.int64)
        cdf_local[own] = np.arange(n_owned)
        self.n_owned = n_owned
        self.register_buffer("P", torch.from_numpy(np.asarray(mf_coarse._sources["P"])).to(
            dev, self.dtype))
        self.register_buffer("covmap", i32(covmap))
        self.register_buffer("cov_masks", i32(t["cov_masks"][r, :n]))
        self.register_buffer("E", torch.from_numpy(np.ascontiguousarray(
            t["E"][r, :n], dtype=np.float64)).to(dev, self.dtype))
        self.register_buffer("own", torch.from_numpy(own).to(dev))
        self.register_buffer("cdf", i32(cdf))
        self.register_buffer("cdf_local", i32(cdf_local))
        ident = np.arange(n)
        self.register_buffer("ident", i32(ident))
        self.register_buffer("ident_ptr", i32(np.arange(n + 1)))
        # every fine cell a family of one: cell_transfer's blocks take about 256 lines of them
        self.register_buffer("blocks", i32(cell_transfer.schedule(
            np.arange(n + 1), ident, self.E.shape[-1], self.E.shape[1])))
        owned_ids = cdf[own].reshape(-1, 1)
        self.prolong_map = tuple(i32(a) for a in dof_scatter.transpose_map(owned_ids,
                                                                           self.n_padded_f))
        self.restrict_map = tuple(i32(a) for a in dof_scatter.transpose_map(covmap,
                                                                            self.n_padded_c))

    def _hn(self, x, rows_in, **flags):
        return cell_laplace.cell_laplace(x, rows_in, self.cov_masks, self.P, None, None, None,
                                         None, quad=False, **flags)

    def prolongate(self, xc: torch.Tensor) -> torch.Tensor:
        """The rank's coarse block -> its fine block (every rank calls it)."""
        full = comm.all_gather(xc, self.group)
        rows = self._hn(full, self.covmap, hn_in=True, hn_out=False)
        vals = cell_transfer.cell_transfer(rows, self.E, self.cdf_local, self.own, self.ident,
                                           self.ident_ptr, self.ident, self.n_owned,
                                           self.blocks, mode="prolongate")
        contrib = dof_scatter.dof_scatter(vals.view(-1, 1), *self.prolong_map)
        return comm.psum_scatter(contrib, self.group)

    def restrict(self, xf: torch.Tensor) -> torch.Tensor:
        """The exact adjoint of prolongate: the rank's fine block -> its
        coarse block (every rank calls it)."""
        full = comm.all_gather(xf, self.group)
        rows = cell_transfer.cell_transfer(full, self.E, self.cdf, self.own, self.ident,
                                           self.ident_ptr, self.ident, self.n_padded_f,
                                           self.blocks, mode="restrict")
        rows = self._hn(rows, None, hn_in=False, hn_out=True)
        contrib = dof_scatter.dof_scatter(rows, *self.restrict_map)
        return comm.psum_scatter(contrib, self.group)


class DistributedGMGPreconditioner:
    """The global-coarsening GMG V-cycle over the ranks of ``group``: each
    level's operator, smoother and transfer, and the coarse CG, on the
    rank's blocks, on ``device`` (default ``cuda:<LOCAL_RANK>``). The
    diagonals are probed once on the single-device engine (host setup, as
    the reference's), then each rank keeps its block."""

    def __init__(self, geometry: str, dim: int, n_refinements: int, degree: int, group=None,
                 device=None, dtype=np.float64, n_smooth: int = 3, min_level: int = 1,
                 weights_fn=None):
        device = comm.rank_device(device)
        self.levels, self.ops = [], []
        for lv in range(min_level, n_refinements + 1):
            mf = MatrixFree(create_geometry(geometry, dim, lv), degree, dtype=dtype)
            self.levels.append(mf)
            self.ops.append(DistributedDirichletLaplace(
                mf, group=group, device=device, weights=weights_fn(mf) if weights_fn else None))
        self.smoothers = []
        for op, mf in zip(self.ops, self.levels):
            single = DirichletLaplace(mf, device=device)
            diag = operator_diagonal(single, mf).cpu().numpy().copy()
            diag[mf.dof_handler.boundary_dofs()] = 1.0
            d = op.dop
            x0 = np.random.default_rng(7).standard_normal((d.n_ranks, d.n_own_max))[d.rank]
            self.smoothers.append(ChebyshevSmoother(
                op, op.scatter_vector(diag), degree=n_smooth,
                x_init=torch.from_numpy(x0).to(device, op.dtype), dot=op.dot))
        self.transfers = [DistributedTransfer(self.levels[i], self.levels[i + 1], self.ops[i],
                                              self.ops[i + 1])
                          for i in range(len(self.levels) - 1)]

    def _vcycle(self, lvl: int, b):
        op = self.ops[lvl]
        if lvl == 0:
            x, _, _ = solve_cg(op, b, tol=1e-10, max_iter=200, dot=op.dot)
            return x
        sm = self.smoothers[lvl]
        x = sm.apply(b)
        r = op.project_rhs(b - op.vmult(x))
        rc = self.ops[lvl - 1].project_rhs(self.transfers[lvl - 1].restrict(r))
        xc = self._vcycle(lvl - 1, rc)
        x = x + op.project_rhs(self.transfers[lvl - 1].prolongate(xc))
        return sm.apply(b, x0=x)

    def __call__(self, b):
        return self._vcycle(len(self.levels) - 1, b)

    @property
    def fine_op(self):
        return self.ops[-1]

    @property
    def fine_mf(self):
        return self.levels[-1]
