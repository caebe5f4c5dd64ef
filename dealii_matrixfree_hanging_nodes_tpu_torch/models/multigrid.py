"""Solvers of the port, the counterpart of
``dealii_matrixfree_hanging_nodes_tpu.models.multigrid``: conjugate
gradients, Chebyshev smoothing and the global-coarsening geometric multigrid
V-cycle on the index engine, all matrix-free on the engine's kernels.

Level l is the mesh made with l refinements, so every active cell of level
l+1 is an active cell of level l or a descendant of one. Prolongation embeds
the covering coarse cell's values with per-axis chains of the subface
matrices P0/P1 (``covering_embedding``), restriction is its exact adjoint;
both run in the ``cell_transfer`` kernel. The diagonal is probed through the
engine's cell loop (``operator_diagonal``) or computed on the host
(``laplace_diagonal_host``). Every piece runs in 3-D and 2-D, as the index
engine does. The vector updates of CG and Chebyshev are PyTorch elementwise
ops; every scalar the reference keeps on the host (``lmax``, ``lmin``, the
residual test) is a host float here too, so both packages smooth with the
same polynomial and stop at the same iteration.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..elements import shape_info
from ..kernels import cell_transfer
from ..matrix_free import TORCH_DTYPES, MatrixFree, resolve_device
from ..mesh import create_geometry
from ..ops.hanging_nodes import hn_composite_matrix
from .laplace import laplace_cell_kernel

__all__ = [
    "operator_diagonal",
    "laplace_diagonal_host",
    "ChebyshevSmoother",
    "covering_embedding",
    "Transfer",
    "GMGPreconditioner",
    "solve_cg",
    "DirichletLaplace",
]


# --------------------------------------------------------------------------
def operator_diagonal(op, mf: MatrixFree) -> torch.Tensor:
    """Matrix-free diagonal of C^T A C by unit-vector probing per local DoF
    (MatrixFreeTools::compute_diagonal): for each local index l, the cell
    rows e_l go through the hanging-node interpolation, the cell kernel and
    its transpose, and entry l is kept; the kept rows are scattered through
    the fast DoF map. On op's device: 125 probes at p=4, run once at setup."""
    n_loc = (mf.degree + 1) ** mf.dim
    dev, dt = op.device, op.dtype
    a = mf.device_tables(dev, dt)
    acc = torch.zeros((mf.n_cells, n_loc), dtype=dt, device=dev)
    for l in range(n_loc):
        e = torch.zeros((mf.n_cells, n_loc), dtype=dt, device=dev)
        e[:, l] = 1.0
        u = mf.apply_hanging_node_constraints(e, False)
        v = op.cell_kernel(u, a)
        v = mf.apply_hanging_node_constraints(v, True)
        acc[:, l] = v[:, l]
    return mf.distribute_local_to_global_plain(acc)


def laplace_diagonal_host(mf: MatrixFree) -> np.ndarray:
    """The host NumPy equal of operator_diagonal for the Cartesian Laplace:
    for each distinct mask m the slot diagonal of Q_m K Q_m^T (Q_m the
    composite in-cell interpolation, forward u @ Q), times geo, summed at
    the fast DoF map."""
    if mf.high_order_mapping:
        raise NotImplementedError("host diagonal assumes Cartesian mapping")
    si, dim, p = mf.shape, mf.dim, mf.degree
    n_loc = (p + 1) ** dim
    M1 = np.einsum("q,qi,qj->ij", si.quad_w, si.S, si.S)
    K1 = np.einsum("q,qi,qj->ij", si.quad_w, si.D, si.D)
    K = np.zeros((n_loc, n_loc))
    for d in range(dim):
        facs = [K1 if t == d else M1 for t in range(dim)]
        A = facs[dim - 1]
        for t in range(dim - 2, -1, -1):
            A = np.kron(A, facs[t])
        K += A

    masks = np.asarray(mf._np["masks"])
    geo = np.asarray(mf._np["geo"])[:, 0].astype(np.float64)
    uniq, inv = np.unique(masks, return_inverse=True)
    dtab = np.empty((len(uniq), n_loc))
    for i, mv in enumerate(uniq):
        if mv == 0:
            dtab[i] = np.diag(K)
        else:
            Q = np.asarray(hn_composite_matrix(int(mv), si.P, dim), np.float64)
            dtab[i] = np.einsum("ki,ij,kj->k", Q, K, Q)
    diag = np.zeros(mf.n_dofs)
    dofmap = np.asarray(mf._np["dofmap"])
    step = max(1, 40_000_000 // n_loc)
    for s in range(0, mf.n_cells, step):
        e = min(s + step, mf.n_cells)
        np.add.at(diag, dofmap[s:e].ravel(), (geo[s:e, None] * dtab[inv[s:e]]).ravel())
    return diag


# --------------------------------------------------------------------------
class ChebyshevSmoother:
    """Chebyshev iteration preconditioned by the operator diagonal. The
    ``_prec`` / ``_norm`` hooks set the vector layout (BrickChebyshev refills
    the hanging copies after every D^{-1}); the eigenvalue estimate and the
    three-term recurrence are shared."""

    def __init__(self, op, diag: torch.Tensor = None, degree: int = 4, eig_ratio: float = 1.2,
                 n_power_iters: int = 12, inv_diag: torch.Tensor = None,
                 x_init: torch.Tensor = None, dot=None):
        """dot: the inner product of the vectors (None: the local one); a
        rank-local vector of the distributed operators passes the group's
        (the rank's sum, then an all_reduce), so every norm is global."""
        self.op = op
        self.degree = degree
        self._dot = dot
        if inv_diag is None:
            safe = torch.where(diag > 0, diag, 1.0)
            inv_diag = torch.where(diag > 0, 1.0 / safe, 0.0)
        self.inv_diag = inv_diag
        # power iteration for lambda_max of D^{-1} A, from the reference's start vector
        x = x_init if x_init is not None else torch.as_tensor(
            np.random.default_rng(7).standard_normal(tuple(inv_diag.shape))).to(
                inv_diag.device, inv_diag.dtype)
        lam = 1.0
        for _ in range(n_power_iters):
            y = self._prec(self.op.vmult(x))
            ny = self._norm(y)
            lam = ny / self._norm(x)
            x = y / ny
        self.lmax = float(lam) * 1.1
        self.lmin = self.lmax / (eig_ratio * 10.0)

    def _prec(self, r):
        """One D^{-1} application (hook)."""
        return self.inv_diag * r

    def _norm(self, v):
        if self._dot is not None:
            return torch.sqrt(self._dot(v, v))
        return torch.linalg.vector_norm(v.reshape(-1))

    def apply(self, b: torch.Tensor, x0=None) -> torch.Tensor:
        """The three-term Chebyshev recurrence on D^{-1}(b - A x)."""
        theta = 0.5 * (self.lmax + self.lmin)
        delta = 0.5 * (self.lmax - self.lmin)
        x = torch.zeros_like(b) if x0 is None else x0
        r = b - self.op.vmult(x) if x0 is not None else b
        sigma = theta / delta
        rho = 1.0 / sigma
        d = self._prec(r) / theta
        for _ in range(self.degree):
            x = x + d
            r = b - self.op.vmult(x)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + 2.0 * rho_new / delta * self._prec(r)
            rho = rho_new
        return x


# --------------------------------------------------------------------------
def covering_embedding(mf_coarse: MatrixFree, mf_fine: MatrixFree):
    """Each fine active cell's covering coarse active cell and its per-axis
    embedding chain: (cover int64 [n_f], E float64 [n_f, dim, n, n]), E the
    product of the subface matrices P0/P1 along the refinement path. Shared
    by the index engine's Transfer and the brick engine's BrickTransfer."""
    tc, tf = mf_coarse.tria, mf_fine.tria
    dim, p = tf.dim, mf_fine.degree
    si = shape_info(p)
    n = p + 1

    key_order = np.argsort(tc.pack(tc.level, tc.coord), kind="stable")
    keys_sorted = np.sort(tc.pack(tc.level, tc.coord))

    n_f = tf.n_active_cells
    cover = np.full(n_f, -1, dtype=np.int64)
    diff = np.zeros(n_f, dtype=np.int64)
    lvl = tf.level.copy()
    crd = tf.coord.copy()
    for up in range(0, int(tf.level.max()) + 1):
        missing = cover < 0
        if not missing.any():
            break
        kk = tc.pack(lvl[missing], crd[missing])
        pos = np.searchsorted(keys_sorted, kk)
        pos_c = np.clip(pos, 0, len(keys_sorted) - 1)
        hit = keys_sorted[pos_c] == kk
        idx = np.nonzero(missing)[0]
        cover[idx[hit]] = key_order[pos_c[hit]]
        diff[idx[hit]] = up
        lvl[missing] = lvl[missing] - 1
        crd[missing] = crd[missing] >> np.int64(1)
    if (cover < 0).any():
        raise ValueError("the fine mesh does not refine the coarse mesh")

    # E = P_{b_deep} @ ... @ P_{b_1} per axis, the subcell bit at depth k
    # (from the coarse side) being (coord >> (diff - 1 - k)) & 1
    P = si.P
    E = np.broadcast_to(np.eye(n), (n_f, dim, n, n)).copy()
    maxdiff = int(diff.max()) if n_f else 0
    for k in range(maxdiff):
        act = diff > k
        if not act.any():
            continue
        shift = (diff[act] - 1 - k).astype(np.int64)
        for d in range(dim):
            bits = (tf.coord[act, d] >> shift) & 1
            E[act, d] = np.matmul(P[bits], E[act, d])
    return cover, E


def first_owners(cell_dofs: np.ndarray) -> np.ndarray:
    """bool [n_cells, n_loc]: the first (cell, slot) in flat order that names
    each DoF (its one writer)."""
    flat = np.asarray(cell_dofs).ravel()
    order = np.argsort(flat, kind="stable")
    _, start = np.unique(flat[order], return_index=True)
    own = np.zeros(flat.size, dtype=bool)
    own[order[start]] = True
    return own.reshape(np.asarray(cell_dofs).shape)


class Transfer(nn.Module):
    """Prolongation and restriction between two meshes where the fine one
    refines the coarse one (global coarsening), on the index engine: the
    ``cell_transfer`` kernel between the coarse level's read_dof_values and
    distribute_local_to_global. Its tables are buffers on ``device`` (the
    card unless the caller asks for the CPU)."""

    def __init__(self, mf_coarse: MatrixFree | None, mf_fine: MatrixFree | None = None,
                 device=None):
        super().__init__()
        self.mfc = mf_coarse
        if mf_fine is None:  # from_tables fills the tables in
            return
        cover, E = covering_embedding(mf_coarse, mf_fine)
        cd_f = np.asarray(mf_fine.dof_handler.cell_dofs)
        self._load(dict(cover=cover, E=E, own=first_owners(cd_f), cdf=cd_f), mf_fine.n_dofs,
                   resolve_device(device), TORCH_DTYPES[mf_fine.dtype])

    @classmethod
    def from_tables(cls, mf_coarse: MatrixFree, tables: dict, n_fine_dofs: int, device=None,
                    dtype=torch.float64) -> "Transfer":
        """A transfer from host tables (NumPy: cover [n_f], E [n_f, dim, n, n],
        own [n_f, n_loc] bool, cdf [n_f, n_loc], the reference's ``cover``,
        ``E``, ``own_mask`` and ``cdf``) on the coarse level's engine."""
        tr = cls(mf_coarse)
        tr._load(tables, n_fine_dofs, resolve_device(device), dtype)
        return tr

    def _load(self, t, n_fine_dofs, device, dtype):
        cover = np.asarray(t["cover"], dtype=np.int64)
        n_c = self.mfc.n_cells
        own = np.array(t["own"], dtype=bool)
        cdf = np.asarray(t["cdf"])
        if (cover.min(initial=0) < 0 or cover.max(initial=-1) >= n_c
                or (np.bincount(cdf[own], minlength=n_fine_dofs) != 1).any()):
            raise ValueError("Transfer: cover must name coarse cells and own one (cell, slot) "
                             "for each fine DoF")
        child = np.argsort(cover, kind="stable")
        child_ptr = np.zeros(n_c + 1, dtype=np.int64)
        np.cumsum(np.bincount(cover, minlength=n_c), out=child_ptr[1:])
        i32 = lambda a: torch.from_numpy(np.array(a, dtype=np.int32)).to(device)
        self.register_buffer("E", torch.from_numpy(np.array(t["E"], np.float64)).to(device, dtype))
        self.register_buffer("cdf", i32(cdf))
        self.register_buffer("own", torch.from_numpy(own).to(device))
        self.register_buffer("cover", i32(cover))
        self.register_buffer("child_ptr", i32(child_ptr))
        self.register_buffer("child", i32(child))
        n, dim = self.E.shape[-1], self.E.shape[1]
        self.register_buffer("blocks", i32(cell_transfer.schedule(child_ptr, child, n, dim)))
        self.n_fine_dofs = int(n_fine_dofs)

    def tables(self):
        """cell_transfer's arguments after x (the block schedule last)."""
        return (self.E, self.cdf, self.own, self.cover, self.child_ptr, self.child,
                self.n_fine_dofs, self.blocks)

    def prolongate(self, xc: torch.Tensor) -> torch.Tensor:
        """Coarse DoF vector -> fine DoF vector (the consistent embedding;
        hanging fine DoFs get their interpolated values)."""
        uc = self.mfc.read_dof_values(xc)
        return cell_transfer.cell_transfer(uc, *self.tables(), mode="prolongate")

    def restrict(self, xf: torch.Tensor) -> torch.Tensor:
        """The exact adjoint of prolongate."""
        rows = cell_transfer.cell_transfer(xf, *self.tables(), mode="restrict")
        return self.mfc.distribute_local_to_global(rows)


# --------------------------------------------------------------------------
def solve_cg(op, b, M=None, tol=1e-8, max_iter=500, dot=None):
    """(Preconditioned) conjugate gradients; returns (x, n_iters, res_norm).

    ``dot`` overrides the inner product (e.g. BrickLaplaceMM.dot, which
    weighs each DoF once across its brick copies). The residual test reads
    one host float an iteration, as the reference's does."""
    dot = dot if dot is not None else (lambda u, v: torch.dot(u.reshape(-1), v.reshape(-1)))
    x = torch.zeros_like(b)
    r = b
    z = M(r) if M is not None else r
    p = z
    rz = dot(r, z)
    b_norm = float(torch.sqrt(dot(b, b)))
    if b_norm == 0:
        return x, 0, 0.0
    it = 0
    for it in range(1, max_iter + 1):
        Ap = op.vmult(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        res = float(torch.sqrt(dot(r, r)))
        if res < tol * b_norm:
            break
        z = M(r) if M is not None else r
        rz_new = dot(r, z)
        beta = rz_new / rz
        rz = rz_new
        p = z + beta * p
    return x, it, float(torch.sqrt(dot(r, r)))


# --------------------------------------------------------------------------
class DirichletLaplace(nn.Module):
    """Laplace with homogeneous Dirichlet rows (identity there), SPD for the
    CG / GMG stack, on the index engine's cell loop. Runs on ``device``: the
    card unless the caller asks for the CPU."""

    def __init__(self, mf: MatrixFree, device=None):
        super().__init__()
        self.mf = mf
        self.device = resolve_device(device)
        self.dtype = TORCH_DTYPES[mf.dtype]
        self.cell_kernel = laplace_cell_kernel(mf)
        self.bdofs = mf.dof_handler.boundary_dofs()
        bmask = np.zeros(mf.n_dofs, dtype=bool)
        bmask[self.bdofs] = True
        self.register_buffer("bmask", torch.from_numpy(bmask).to(self.device))

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        """out = A (src with its Dirichlet entries zeroed), with the Dirichlet
        entries of src in place (the reference's set-then-add)."""
        out = self.mf.cell_loop(self.cell_kernel, torch.where(self.bmask, 0.0, src))
        return torch.where(self.bmask, src, out)

    def project_rhs(self, b: torch.Tensor) -> torch.Tensor:
        """Zero the Dirichlet rows of a right-hand side."""
        return torch.where(self.bmask, 0.0, b)


class GMGPreconditioner:
    """Global-coarsening geometric multigrid V-cycle on the index engine:
    per level a DirichletLaplace, its probed diagonal and a Chebyshev
    smoother, Transfers between levels, CG on the coarsest level."""

    def __init__(self, geometry: str, dim: int, n_refinements: int, degree: int,
                 dtype=np.float64, n_smooth: int = 3, min_level: int = 1, device=None):
        if dim not in (2, 3):
            raise NotImplementedError("the port's index engine supports dim=2 and dim=3")
        device = resolve_device(device)
        self.levels = [MatrixFree(create_geometry(geometry, dim, r), degree, dtype=dtype)
                       for r in range(min_level, n_refinements + 1)]
        self.ops = [DirichletLaplace(mf, device=device) for mf in self.levels]
        self.smoothers = []
        for op, mf in zip(self.ops, self.levels):
            diag = operator_diagonal(op, mf).masked_fill(op.bmask, 1.0)  # Dirichlet rows: 1
            self.smoothers.append(ChebyshevSmoother(op, diag, degree=n_smooth))
        self.transfers = [Transfer(self.levels[i], self.levels[i + 1], device=device)
                          for i in range(len(self.levels) - 1)]

    def _vcycle(self, lvl: int, b):
        op = self.ops[lvl]
        if lvl == 0:
            x, _, _ = solve_cg(op, b, tol=1e-10, max_iter=200)
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
