"""Vector-valued linear elasticity on the brick engine, the port of
``dealii_matrixfree_hanging_nodes_tpu.models.elasticity_bricks``:

    a(u, v) = int 2 mu eps(u):eps(v) + lam (div u)(div v)

On Cartesian cube cells every block (c, k) of the dim x dim component
operator is a short sum of Kronecker products of the brick's assembled 1-D
factors Kb, Mb, Gb = D^T W S and Gb^T, and every factor scales with the
cell size as h^(dim-2), so the brick's scalar ``geo`` multiplies every
term. The coupled operator rides the scalar engine's brick structure,
hanging-node chains, DSS and subset tables (a ``BrickLaplaceMM`` with the
per-cell tables at every degree and no face planes), with the components
on a leading axis: brick vectors [dim, n_bricks, N3p], cell rows [dim,
rows, n_loc] (the reference carries them on a trailing row axis). dim is
the mesh's, 3 or 2 (2-D bricks of B^2 cells, two components; the
reference's 2-D branches).

vmult = cell_elasticity (every subset cell's geo_c Kel u_c from the bricks)
      -> hn_cell, elastic mode (the constrained rows: fill, Q, the coupled
         operator, Q^T)
      -> corr_compact on its component axis (the fold, the sparse delta)
      -> brick_elasticity (the coupled brick operator times geo; its
         epilogue adds the deltas into the subset bricks)
      -> dss_surface on its component axis: 5 launches.
vmult_plain = the same without hn_cell, with the absent cells' rows only: 4.
Outputs are reduced, as in the reference: hanging copies carry no meaning.
The reference's ``matmul_precision`` is a TPU knob and is not ported."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..bricks import BrickLaplaceMM
from ..elements import shape_info
from ..kernels import brick_elasticity, cell_elasticity, corr_compact, dss_surface, hn_cell
from ..matrix_free import MatrixFree, resolve_device
from .elasticity import check_elastic_mesh

__all__ = ["BrickElasticity"]


class BrickElasticity(nn.Module):
    """Coupled elasticity vmult on component brick vectors [dim, n_bricks,
    N3p], on ``device`` (the card unless the caller asks for the CPU).
    ``vmult(bv, plain=True)`` runs the kernels' plain PyTorch versions on
    the operator's device."""

    def __init__(self, mf: MatrixFree | None, mu: float = 1.0, lam: float = 1.0, device=None,
                 dtype=None):
        super().__init__()
        self.mf = mf
        self.mu, self.lam = float(mu), float(lam)
        if mf is None:  # from_tables fills the operator in
            return
        check_elastic_mesh(mf, "BrickElasticity")
        # the scalar engine's tables: the per-cell schedule at every degree, no face planes
        self._setup(BrickLaplaceMM(mf, device=device, dtype=dtype, face_planes=False,
                                   assembled=False))

    @classmethod
    def from_tables(cls, arrays: dict, meta: dict, mu: float = 1.0, lam: float = 1.0,
                    device=None, dtype=torch.float32) -> "BrickElasticity":
        """Operator from host tables alone (``bricks.operator_tables``
        layout, or ``convert.reference_tables``); the per-cell schedule is
        used whatever meta["assembled"] says. vmult and vmult_plain work; the
        DoF-vector conversions need the mesh setup and are absent."""
        if len(arrays["hn_sub"]) and "keep_hn" not in arrays:
            raise NotImplementedError("constrained elasticity requires the compact chain "
                                      "schedules")
        op = cls(None, mu, lam)
        op._setup(BrickLaplaceMM.from_tables(arrays, dict(meta, assembled=False),
                                             resolve_device(device), dtype))
        return op

    @classmethod
    def on_operator(cls, mm: BrickLaplaceMM, mu: float = 1.0,
                    lam: float = 1.0) -> "BrickElasticity":
        """Elasticity on an existing scalar brick operator's tables (its
        device and type), which must be the per-cell schedule without face
        planes: a BrickLaplaceMM at p >= 4 with its defaults, or one built
        with face_planes=False, assembled=False."""
        if mm.assembled or mm.planes:
            raise ValueError("elasticity needs the per-cell tables without face planes")
        if mm.mf is not None:
            check_elastic_mesh(mm.mf, "BrickElasticity")
        op = cls(None, mu, lam)
        op.mf = mm.mf
        op._setup(mm)
        return op

    def _setup(self, mm: BrickLaplaceMM):
        if mm.deformed:  # the reference's refusal (models/elasticity_bricks.py:72)
            raise NotImplementedError("BrickElasticity uses the Cartesian brick factorization")
        self.mm = mm
        p, dev, dt = mm.p, mm.device, mm.dtype
        si = shape_info(p)
        w = si.quad_w
        cell = {"K": np.einsum("q,qi,qj->ij", w, si.D, si.D),
                "M": np.einsum("q,qi,qj->ij", w, si.S, si.S),
                "G": np.einsum("q,qi,qj->ij", w, si.D, si.S)}
        fb = brick_elasticity.brick_factors(cell["K"], cell["M"], cell["G"], mm.B)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
        for name in ("K", "M", "G"):
            self.register_buffer(f"{name}b", t(fb[name]))
        self.packed_host = torch.from_numpy(brick_elasticity.pack(fb, p)).to(dt)
        self.register_buffer("S", t(si.S))
        self.register_buffer("Dc", t(si.Dc))
        # the two kernels' launch parameters, built once on the host
        self.brick_kernel_factors = brick_elasticity.cell_factor_tables(cell["K"], cell["M"],
                                                                        cell["G"])
        self.cell_kernel_factors = cell_elasticity.factor_tables(si.S, si.Dc)
        self.register_buffer("quad_w", t(si.quad_weights_tensor(mm.dim)))

    @property
    def device(self) -> torch.device:
        return self.mm.device

    @property
    def dim(self) -> int:
        return self.mm.dim

    @property
    def dtype(self) -> torch.dtype:
        return self.mm.dtype

    # ------------------------------------------------------------ conversions
    def from_dof_vector(self, u) -> torch.Tensor:
        """[n_dofs, dim] (NumPy or tensor) -> [dim, n_bricks, N3p] on the
        operator's device, each component's hanging entries distributed."""
        if isinstance(u, torch.Tensor):
            u = u.detach().cpu().numpy()
        u = np.asarray(u)
        return torch.stack([self.mm.from_dof_vector(u[:, c]) for c in range(self.dim)])

    def to_dof_vector(self, bv: torch.Tensor, zero_hanging: bool = False) -> torch.Tensor:
        """[dim, n_bricks, N3p] -> [n_dofs, dim] (a tensor on the device):
        each component refilled (hn_cell's fill mode, refill_update) unless
        zero_hanging asks for zero hanging entries."""
        return torch.stack([self.mm.to_dof_vector(bv[c], zero_hanging)
                            for c in range(self.dim)], dim=1)

    # ---------------------------------------------------------------- vmult
    def _check(self, bv):
        mm = self.mm
        if bv.shape != (mm.dim, mm.n_bricks, mm.N3p):
            raise ValueError(f"expected a [{mm.dim}, {mm.n_bricks}, {mm.N3p}] brick vector, got "
                             f"{tuple(bv.shape)}")
        if bv.dtype != self.dtype or bv.device != self.device:
            raise ValueError(f"expected {self.dtype} on {self.device}, got {bv.dtype} on "
                             f"{bv.device}")

    def _fn(self, mod, plain):
        return getattr(mod, f"{mod.NAME}_plain" if plain else mod.NAME)

    def cell_rows(self, bv, plain: bool = False) -> torch.Tensor:
        """Every subset cell's geo_c Kel u_c, [dim, n_sub*B^dim, n_loc]
        (cell_elasticity from the bricks; the reference's plain3)."""
        mm = self.mm
        args = (bv, None, None, None, self.S, self.Dc, self.quad_w, mm.geo_cell_sub, self.mu,
                self.lam)
        if plain:
            return cell_elasticity.cell_elasticity_plain(*args, brick_size=mm.B)
        return cell_elasticity.cell_elasticity(*args, brick_size=mm.B,
                                               factors=self.cell_kernel_factors)

    def elastic_tables(self):
        """hn_cell's elastic-mode argument: (S, Dc, quad_w, mu, lam)."""
        return (self.S, self.Dc, self.quad_w, self.mu, self.lam)

    def hn_rows(self, bv, plain: bool = False) -> torch.Tensor:
        """The constrained rows [dim, n_hn, n_loc]: fill, Q, the coupled
        operator times geo, Q^T (hn_cell's elastic mode)."""
        mm = self.mm
        return self._fn(hn_cell, plain)(bv, *mm.hn_tables(), None, None, mm.geo_hn, mm.B,
                                        mode="elastic", elastic=self.elastic_tables())

    def brick_apply(self, bv, dcols, plain: bool = False) -> torch.Tensor:
        mm = self.mm
        factors = (dict(K=self.Kb, M=self.Mb, G=self.Gb) if plain or bv.device.type == "cpu"
                   else self.brick_kernel_factors)
        return self._fn(brick_elasticity, plain)(bv, factors, mm.geo, mm.p, self.mu, self.lam,
                                                 dcols=dcols, brick_size=mm.B)

    def vmult(self, bv: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """v = A bv (reference ``_vmult_impl``): the subset's cell rows and
        constrained rows, their fold, the coupled brick operator with the
        deltas in its epilogue, the DSS. A new [dim, n_bricks, N3p]."""
        self._check(bv)
        mm = self.mm
        dcols = None
        if mm.n_sub:
            sub_raw = (self.hn_rows(bv, plain) if mm.n_hn
                       else bv.new_empty((mm.dim, 0, mm.n_loc)))
            dcols = self._fn(corr_compact, plain)(self.cell_rows(bv, plain), sub_raw,
                                                  *mm.corr_tables())
        return self._fn(dss_surface, plain)(self.brick_apply(bv, dcols, plain),
                                            *mm.dss_tables())

    def vmult_plain(self, bv: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """The unconstrained operator (the reference's ``vmult_plain``): the
        coupled brick operator with the absent cells' contributions removed
        (their cell rows negated by corr_compact with no fold), the DSS; no
        hanging-node interpolation. The HN overhead is vmult over this."""
        self._check(bv)
        mm = self.mm
        dcols = None
        if mm.n_sub and mm.n_absent:
            dcols = self._fn(corr_compact, plain)(
                self.cell_rows(bv, plain), bv.new_empty((mm.dim, 0, mm.n_loc)), mm.plain_code,
                mm.keep_hn[:0], mm.corr_seg_ptr[:1], mm.corr_seg_dst[:0], mm.corr_ent_src[:0],
                mm.plain_blocks)
        return self._fn(dss_surface, plain)(self.brick_apply(bv, dcols, plain),
                                            *mm.dss_tables())

    def forward(self, bv, plain: bool = False) -> torch.Tensor:
        return self.vmult(bv, plain)
