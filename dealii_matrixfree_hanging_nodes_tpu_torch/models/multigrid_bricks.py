"""Geometric multigrid on the brick engine, the counterpart of
``dealii_matrixfree_hanging_nodes_tpu.models.multigrid_bricks``: the
Chebyshev-smoothed global-coarsening V-cycle of ``models.multigrid`` with
every level operator, smoother application and transfer on brick vectors
(``bricks.BrickLaplaceMM``), and a GMG-preconditioned CG whose vectors and
scalars stay on the device (``make_device_solver``).

- ``DofEmbed``: DoF vector <-> brick vector on the device. ``embed`` (the
  ``dof_embed`` kernel) interpolates the slaves from their masters and sets
  every valid node to its DoF, ``embed_t`` is its exact transpose (one
  launch each), ``extract`` reads each DoF's owner copy (a PyTorch index).
- ``BrickDirichletLaplace``: homogeneous Dirichlet rows on brick vectors. A
  pointwise mask breaks the hanging-node invariant at constrained copies, so
  every mask is followed by ``BrickLaplaceMM.refill``.
- ``BrickTransfer``: prolongation on the ``brick_transfer`` kernel (the
  embedded coarse field is continuous, so every fine copy, hanging ones
  included, gets its consistent value); restriction is the exact adjoint on
  the reduced space, written out: rc = S_c(S_c^T(P_b^T(W_f r))) =
  brick_transfer's restrict mode, then dof_embed's embed_t and embed.
- ``BrickChebyshev``: the Chebyshev smoother with a refill after each
  diagonal scaling.
- ``BrickGMGPreconditioner``: the V-cycle, the host-computed diagonals and a
  dense inverse on the coarsest level (one ``torch.matmul``).

The reference's TPU knob ``matmul_precision`` is not ported (the port
computes in exact float32 / float64), nor are its jit idioms (``_params``,
the ``_*_p`` twins): the host-stepped solve and the device solver share one
code path. The levels' operators run with ``face_planes=False``, as the
reference's do.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..bricks import BrickLaplaceMM
from ..kernels import brick_transfer, dof_embed
from ..matrix_free import MatrixFree, resolve_device
from ..mesh import create_geometry
from ..oracle import assemble_laplace
from .multigrid import ChebyshevSmoother, covering_embedding, laplace_diagonal_host, solve_cg

__all__ = [
    "BrickDirichletLaplace",
    "BrickTransfer",
    "BrickChebyshev",
    "BrickGMGPreconditioner",
    "DofEmbed",
]


# --------------------------------------------------------------------------
class DofEmbed(nn.Module):
    """DoF vector <-> brick vector [nb, N3p] on the device for one brick
    level (the device counterparts of from_dof_vector / to_dof_vector)."""

    def __init__(self, mm: BrickLaplaceMM | None):
        super().__init__()
        if mm is None:  # from_tables fills the tables in
            return
        bs, ci = mm.bs, mm.mf.constraints
        self._load(bs.node_dof, ci.slave_dofs, ci.row_ptr, ci.col, ci.weight,
                   bs.owner_node_of_dof, mm.mf.n_dofs, mm.N3, mm.N3p, mm.device, mm.dtype)

    @classmethod
    def from_tables(cls, node_dof, slave, row_ptr, col, weight, owner, n_dofs, N3, N3p,
                    device=None, dtype=torch.float64) -> "DofEmbed":
        """From host tables: node_dof [nb N3] (-1 at holes), the constraint
        CSR, each DoF's owner node [n_dofs] (an index into [nb N3])."""
        de = cls(None)
        de._load(node_dof, slave, row_ptr, col, weight, owner, n_dofs, N3, N3p,
                 resolve_device(device), dtype)
        return de

    def _load(self, node_dof, slave, row_ptr, col, weight, owner, n_dofs, N3, N3p, device,
              dtype):
        t = dof_embed.tables(node_dof, slave, row_ptr, col, weight, n_dofs, N3, N3p)
        for mode, (ptr, idx, w, long) in t.items():
            self.register_buffer(f"{mode}_ptr", torch.from_numpy(ptr).to(device))
            self.register_buffer(f"{mode}_idx", torch.from_numpy(idx).to(device))
            self.register_buffer(f"{mode}_w", torch.from_numpy(w).to(device, dtype))
            self.register_buffer(f"{mode}_long", torch.from_numpy(long).to(device))
        owner = np.asarray(owner, dtype=np.int64)
        self.register_buffer("owner", torch.from_numpy((owner // N3) * N3p + owner % N3).to(
            device))
        self.n_dofs = int(n_dofs)
        self.shape = (np.asarray(node_dof).size // N3, N3p)

    def tables(self, mode: str):
        """dof_embed's ptr, idx, w and long-row list of a mode ("embed",
        "embed_t")."""
        return tuple(getattr(self, f"{mode}_{k}") for k in ("ptr", "idx", "w", "long"))

    def embed(self, x_dof: torch.Tensor) -> torch.Tensor:
        """DoF vector -> a new brick vector (slaves interpolated)."""
        return dof_embed.dof_embed(x_dof, *self.tables("embed"), self.shape)

    def embed_t(self, bv: torch.Tensor) -> torch.Tensor:
        """The transpose of embed: brick vector -> a new DoF vector."""
        return dof_embed.dof_embed(bv, *self.tables("embed_t"), (self.n_dofs,))

    def extract(self, bv: torch.Tensor) -> torch.Tensor:
        """Brick vector -> DoF vector, each DoF read at its owner copy."""
        return bv.reshape(-1)[self.owner]


# --------------------------------------------------------------------------
class BrickDirichletLaplace(nn.Module):
    """Laplace with homogeneous Dirichlet rows (identity there) on brick
    vectors, SPD on the reduced space (the brick counterpart of
    ``models.multigrid.DirichletLaplace``)."""

    def __init__(self, mm: BrickLaplaceMM):
        super().__init__()
        self.mm = mm
        mf, bs = mm.mf, mm.bs
        bd = mf.dof_handler.boundary_dofs()
        bmark = np.zeros(mf.n_dofs, dtype=bool)
        bmark[bd] = True
        nb = np.zeros((bs.n_bricks, mm.N3p), dtype=bool)
        nb[:, : mm.N3] = (bmark[np.where(bs.node_dof >= 0, bs.node_dof, 0)]
                          & bs.node_valid).reshape(bs.n_bricks, mm.N3)
        self.register_buffer("bd_mask", torch.from_numpy(nb).to(mm.device))
        self._bdofs = bd

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        mm = self.mm
        v = mm.vmult(mm.refill(torch.where(self.bd_mask, 0.0, u)))
        return mm.refill(torch.where(self.bd_mask, u, v))

    def project_rhs(self, b: torch.Tensor) -> torch.Tensor:
        """Zero the Dirichlet rows of a right-hand side (brick layout)."""
        return self.mm.refill(torch.where(self.bd_mask, 0.0, b))

    def dot(self, u, v):
        return self.mm.dot(u, v)


# --------------------------------------------------------------------------
def brick_transfer_tables(mm_c: BrickLaplaceMM, mm_f: BrickLaplaceMM) -> dict:
    """The reference's host tables of one brick transfer (models/
    multigrid_bricks.py:166-196, NumPy): src_lin [nlin_f], E_rows [nlin_f,
    dim, n, n] (identity at absent rows), own_w [nlin_f, n_loc] (one writer
    a fine node: the smallest covering row), and the fine dot mask wf [nb_f,
    N3]."""
    mf_c, mf_f = mm_c.mf, mm_f.mf
    bs_c, bs_f = mm_c.bs, mm_f.bs
    dim = bs_f.dim
    C = bs_f.B**dim
    n = mf_f.degree + 1
    n_loc = n**dim
    cover, E = covering_embedding(mf_c, mf_f)
    nlin_f = bs_f.n_bricks * C
    cell_at_f = np.full(nlin_f, -1, dtype=np.int64)
    cell_at_f[bs_f.cell_lin] = np.arange(mf_f.n_cells)
    src_lin = np.zeros(nlin_f, dtype=np.int64)
    E_rows = np.broadcast_to(np.eye(n), (nlin_f, dim, n, n)).copy()
    present = cell_at_f >= 0
    fc = cell_at_f[present]
    src_lin[present] = bs_c.cell_lin[cover[fc]]
    E_rows[present] = E[fc]
    nnode_f = bs_f.n_bricks * bs_f.NB**dim
    writer = np.full(nnode_f, -1, dtype=np.int64)
    flat_nodes = (bs_f.brick_of_cell.astype(np.int64)[:, None] * bs_f.NB**dim
                  + bs_f.cell_node_index_range(0, mf_f.n_cells))
    lin_of_cell = bs_f.cell_lin
    order = np.argsort(-lin_of_cell, kind="stable")
    writer[flat_nodes[order].ravel()] = (lin_of_cell[order, None] * n_loc
                                         + np.arange(n_loc)[None, :]).ravel()
    own = np.zeros(nlin_f * n_loc, dtype=bool)
    own[writer[writer >= 0]] = True
    return dict(src_lin=src_lin, E_rows=E_rows, own_w=own.reshape(nlin_f, n_loc),
                wf=bs_f.dot_mask.reshape(bs_f.n_bricks, mm_f.N3))


class BrickTransfer(nn.Module):
    """Brick-layout prolongation and its exact adjoint between two
    global-coarsening levels (each with its own BrickLaplaceMM)."""

    def __init__(self, mm_c: BrickLaplaceMM | None, mm_f: BrickLaplaceMM | None = None):
        super().__init__()
        if mm_c is None:  # from_tables fills the tables in
            return
        self._load(brick_transfer_tables(mm_c, mm_f), DofEmbed(mm_c), mm_c.B, mm_c.n_bricks,
                   mm_c.N3, mm_f.device, mm_f.dtype)

    @classmethod
    def from_tables(cls, tables: dict, embed_c: DofEmbed, B: int, n_bricks_c: int, N3: int,
                    device=None, dtype=torch.float64) -> "BrickTransfer":
        """From the host tables of ``brick_transfer_tables`` (the reference's
        ``src_lin``, ``E_rows``, ``own_w`` and the fine dot mask) and the
        coarse level's DofEmbed."""
        tr = cls(None)
        tr._load(tables, embed_c, B, n_bricks_c, N3, resolve_device(device), dtype)
        return tr

    def _load(self, t, embed_c, B, n_bricks_c, N3, device, dtype):
        E = np.array(t["E_rows"], dtype=np.float64)
        p = E.shape[-1] - 1
        k = brick_transfer.tables(t["src_lin"], t["own_w"], t["wf"], n_bricks_c, B, p, N3)
        self.register_buffer("E_rows", torch.from_numpy(E).to(device, dtype))
        for name, a in k.items():
            self.register_buffer(name, torch.from_numpy(a).to(device))
        self.embed_c = embed_c
        self.B = int(B)

    def tables(self):
        """brick_transfer's arguments after x."""
        return (self.src_lin, self.E_rows, self.own,
                *(getattr(self, k) for k in brick_transfer.LISTS), self.B)

    def prolongate(self, xc_b: torch.Tensor) -> torch.Tensor:
        """Coarse brick vector -> fine brick vector."""
        return brick_transfer.brick_transfer(xc_b, *self.tables(), mode="prolongate")

    def restrict(self, rf_b: torch.Tensor) -> torch.Tensor:
        """The exact adjoint on the reduced space: S_c(S_c^T(P_b^T(W_f r)))."""
        z = brick_transfer.brick_transfer(rf_b, *self.tables(), mode="restrict")
        return self.embed_c.embed(self.embed_c.embed_t(z))


# --------------------------------------------------------------------------
class BrickChebyshev(ChebyshevSmoother):
    """The Chebyshev smoother on brick vectors: each D^{-1} application is
    refilled; the power iteration starts from the reference's vector
    (``from_dof_vector`` of default_rng(7)'s normals)."""

    def __init__(self, op: BrickDirichletLaplace, inv_diag_b, degree: int = 3,
                 eig_ratio: float = 1.2, n_power_iters: int = 12):
        mm = op.mm
        self._mm = mm  # the hooks need it during the power iteration
        rng = np.random.default_rng(7)
        x0 = mm.from_dof_vector(rng.standard_normal(mm.mf.n_dofs).astype(mm.mf.dtype))
        super().__init__(op, degree=degree, eig_ratio=eig_ratio, n_power_iters=n_power_iters,
                         inv_diag=inv_diag_b, x_init=x0)

    def _prec(self, r):
        return self._mm.refill(self.inv_diag * r)

    def _norm(self, v):
        return torch.sqrt(self._mm.dot(v, v))


# --------------------------------------------------------------------------
class BrickGMGPreconditioner:
    """Global-coarsening GMG V-cycle with brick-engine level operators.
    Runs on ``device``: the card unless the caller asks for the CPU."""

    def __init__(self, geometry: str, dim: int, n_refinements: int, degree: int,
                 dtype=np.float64, n_smooth: int = 3, min_level: int = 1,
                 coarse: str = "direct", device=None):
        if coarse not in ("direct", "cg"):
            raise ValueError(f"unknown coarse solver {coarse!r}")
        device = resolve_device(device)
        self.levels = [MatrixFree(create_geometry(geometry, dim, r), degree, dtype=dtype)
                       for r in range(min_level, n_refinements + 1)]
        # host phase: the diagonals (Dirichlet rows 1) and the coarse inverse
        self._coarse_direct = coarse == "direct"
        inv_diags = []
        for mf in self.levels:
            diag = laplace_diagonal_host(mf)
            diag[mf.dof_handler.boundary_dofs()] = 1.0
            safe = np.where(diag > 0, diag, 1.0)
            inv_diags.append(np.where(diag > 0, 1.0 / safe, 0.0))
        if self._coarse_direct:
            mf0 = self.levels[0]
            A, Cm, _, _ = assemble_laplace(mf0.tria, degree)
            M = np.asarray((Cm.T @ A @ Cm).todense())
            fixed = np.zeros(mf0.n_dofs, dtype=bool)
            fixed[mf0.dof_handler.boundary_dofs()] = True
            fixed |= mf0.constraints.constrained_dof_marker()
            M[fixed, :] = 0.0
            M[:, fixed] = 0.0
            M[fixed, fixed] = 1.0
            Minv = np.linalg.inv(M)
        # device phase
        self.mms = [BrickLaplaceMM(mf, device=device, face_planes=False) for mf in self.levels]
        self.ops = [BrickDirichletLaplace(mm) for mm in self.mms]
        self.smoothers = [
            BrickChebyshev(op, mm.from_dof_vector(inv.astype(mf.dtype)), degree=n_smooth)
            for op, mm, mf, inv in zip(self.ops, self.mms, self.levels, inv_diags)]
        self.transfers = [BrickTransfer(self.mms[i], self.mms[i + 1])
                          for i in range(len(self.mms) - 1)]
        if self._coarse_direct:  # the first transfer's coarse embedding is level 0's
            self._embed0 = self.transfers[0].embed_c if self.transfers else DofEmbed(self.mms[0])
            self._MinvT = torch.from_numpy(np.ascontiguousarray(Minv.T)).to(
                device, self.mms[0].dtype)

    def _coarse(self, b):
        """The coarsest level's direct solve: extract, one dense product, embed."""
        return self._embed0.embed(torch.matmul(self._embed0.extract(b), self._MinvT))

    def _vcycle(self, lvl: int, b):
        op = self.ops[lvl]
        if lvl == 0:
            if self._coarse_direct:
                return self._coarse(b)
            x, _, _ = solve_cg(op, b, tol=1e-10, max_iter=200, dot=op.mm.dot)
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

    def make_device_solver(self, tol: float = 1e-5, max_iter: int = 100):
        """GMG-preconditioned CG with its vectors and scalars on the device:
        solve(b) -> (x, n_iters, res_norm), the recurrence of the reference's
        ``lax.while_loop`` (multigrid_bricks.py:490-520). The loop's test
        dot(r, r) > tol^2 dot(b, b) is read once an iteration, the one host
        sync of an iteration."""
        if not self._coarse_direct:
            raise NotImplementedError("the device solve needs coarse='direct'")
        L = len(self.mms) - 1
        op, dot = self.ops[L], self.mms[L].dot

        def solve(b):
            b2 = dot(b, b)
            tol2 = torch.tensor(tol, dtype=b.dtype, device=b.device) ** 2 * b2
            z = self._vcycle(L, b)
            x, r, p, rz, it = torch.zeros_like(b), b, z, dot(b, z), 0
            while it < max_iter and bool(dot(r, r) > tol2):
                Ap = op.vmult(p)
                alpha = rz / dot(p, Ap)
                x = x + alpha * p
                r = r - alpha * Ap
                z = self._vcycle(L, r)
                rz_new = dot(r, z)
                p = z + (rz_new / rz) * p
                rz = rz_new
                it += 1
            return x, it, float(torch.sqrt(dot(r, r)))

        return solve

    @property
    def fine_op(self):
        return self.ops[-1]

    @property
    def fine_mm(self):
        return self.mms[-1]

    @property
    def fine_mf(self):
        return self.levels[-1]
