"""The index engine's Laplace vmult distributed over ranks on
``torch.distributed`` (capability C9), the port of
``dealii_matrixfree_hanging_nodes_tpu.parallel.distributed``: the replacement
of the reference's MPI stack (LinearAlgebra::distributed::Vector with the
partitioner's ghost exchange inside MatrixFree::cell_loop,
benchmark_02.cc:122-209).

- cells are partitioned into contiguous weighted Morton ranges, one a rank
  (``partition``);
- global DoFs are renumbered owner-major, so each rank's owned DoFs are one
  contiguous block of an equal padded length n_own_max;
- vmult, "allgather": the ghost update gathers every rank's block
  (``comm.all_gather``), ``cell_laplace`` reads the rank's cells through its
  DoF map in that numbering and runs HN, quadrature and HN^T, ``dof_scatter``
  writes the padded global vector by destination, and the reverse-halo
  compress(add) is ``comm.psum_scatter``; under ``sm_group_size`` both
  collectives run in two stages over the node and cross-node groups;
- vmult, "halo": ``halo_pack`` packs the DoFs each other rank reads, one
  ``comm.all_to_all`` exchanges them, ``halo_pack`` lays out [own | ghosts],
  the cell kernels run on it, a second all_to_all returns the ghosts'
  contributions and ``halo_pack`` adds them to their owners by destination.

``DistributedLaplacePlan`` is the host plan of all ranks, built from (mf,
n_ranks, weights) alone, the same in every process and without a process
group: the reference's ``_setup`` and ``_build_halo_plan`` with their
[R, ...] tables, which the tests hold against the reference's. A rank puts
on its device only the constants and its own cells' tables (no pad cells).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..kernels import cell_laplace, dof_scatter, halo_pack
from ..matrix_free import TORCH_DTYPES, MatrixFree
from . import comm
from .partition import dof_owners, partition_cells

__all__ = ["DistributedLaplace", "DistributedLaplacePlan"]

EXCHANGES = ("allgather", "halo")


class DistributedLaplacePlan:
    """The host plan of a distributed Laplace over n_ranks ranks (NumPy, the
    reference's attributes and [R, ...] tables): rank_of_cell, n_own,
    n_own_max, padded_id (old DoF -> padded global id), n_padded,
    n_cell_max, dofmap_r, masks_r, geo_r (pad cells geo 0), the ghost /
    import statistics n_ghost, n_import and, for the halo exchange, halo
    (send_idx, send_valid, dm_local, local_size) and halo_max_pair."""

    def __init__(self, mf: MatrixFree, n_ranks: int, weights=None, exchange: str = "allgather"):
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange mode {exchange!r}")
        self.mf = mf
        self.n_ranks = int(n_ranks)
        self.exchange = exchange
        self._setup(weights)

    def _setup(self, weights):
        mf, R = self.mf, self.n_ranks
        n_cells, n_dofs = mf.n_cells, mf.n_dofs
        dofmap = np.asarray(mf._np["dofmap"])
        masks = np.asarray(mf._np["masks"])
        geo = np.asarray(mf._np["geo"])
        plain = np.asarray(mf._np["dofmap_plain"])

        self.rank_of_cell = partition_cells(n_cells, R, weights)
        owner = dof_owners(plain, self.rank_of_cell, n_dofs)
        if owner.max() >= R:
            raise ValueError("a DoF is referenced by no cell")

        # owner-major renumbering with equal padding per rank
        order = np.lexsort((np.arange(n_dofs), owner))
        n_own = np.bincount(owner, minlength=R)
        self.n_own = n_own
        self.n_own_max = n_own_max = int(n_own.max())
        slot_in_rank = np.concatenate([np.arange(c) for c in n_own])
        padded_id = np.empty(n_dofs, dtype=np.int64)
        padded_id[order] = owner[order] * n_own_max + slot_in_rank
        self.padded_id = padded_id
        self.n_padded = R * n_own_max

        counts = np.bincount(self.rank_of_cell, minlength=R)
        self.n_cells_r = counts
        self.n_cell_max = n_cell_max = int(counts.max())
        n_loc = dofmap.shape[1]
        dm = np.zeros((R, n_cell_max, n_loc), dtype=np.int32)
        mk = np.zeros((R, n_cell_max), dtype=np.int32)
        ge = np.zeros((R, n_cell_max) + geo.shape[1:], dtype=geo.dtype)
        self.local_index_of_cell = np.zeros(n_cells, dtype=np.int64)
        for r in range(R):
            sel = np.nonzero(self.rank_of_cell == r)[0]
            dm[r, : len(sel)] = padded_id[dofmap[sel]]
            mk[r, : len(sel)] = masks[sel]
            ge[r, : len(sel)] = geo[sel]  # pad cells keep geo=0
            self.local_index_of_cell[sel] = np.arange(len(sel))
        self.dofmap_r, self.masks_r, self.geo_r = dm, mk, ge

        # ghost / import statistics (benchmark_02.cc:136-165 analog)
        self.n_ghost = np.zeros(R, dtype=np.int64)
        referenced_by = [set() for _ in range(R)]
        for r in range(R):
            refs = np.unique(plain[self.rank_of_cell == r])
            self.n_ghost[r] = int(np.count_nonzero(owner[refs] != r))
            for rr in np.unique(owner[refs]):
                if rr != r:
                    referenced_by[rr].update(refs[owner[refs] == rr].tolist())
        self.n_import = np.array([len(s) for s in referenced_by], dtype=np.int64)
        if self.exchange == "halo":
            self._build_halo_plan(owner)

    def _build_halo_plan(self, owner):
        """Per (receiver r, sender s) the padded list of s-owned DoFs that r's
        cells read: one all_to_all of [R, max_pair] buffers a direction."""
        mf, R = self.mf, self.n_ranks
        dofmap = np.asarray(mf._np["dofmap"])
        n_own_max = self.n_own_max
        ghost = [[np.zeros(0, np.int64)] * R for _ in range(R)]
        for r in range(R):
            refs = np.unique(dofmap[self.rank_of_cell == r])
            for s in range(R):
                if s != r:
                    ghost[r][s] = refs[owner[refs] == s]
        max_pair = max(max((len(ghost[r][s]) for r in range(R) for s in range(R)), default=1), 1)
        self.halo_max_pair = max_pair
        # send_idx[r, s, :]: the slots of r's block that s reads
        send_idx = np.zeros((R, R, max_pair), dtype=np.int32)
        send_valid = np.zeros((R, R, max_pair), dtype=bool)
        for r in range(R):
            for s in range(R):
                loc = self.padded_id[ghost[s][r]] - r * n_own_max
                if not ((loc >= 0).all() and (loc < n_own_max).all()):
                    raise AssertionError("a ghost DoF lies outside its owner's block")
                send_idx[r, s, : len(loc)] = loc
                send_valid[r, s, : len(loc)] = True
        # local DoF maps: padded global id -> [own | ghost blocks] position
        local_size = n_own_max + R * max_pair
        dm_local = np.zeros((R, self.n_cell_max, dofmap.shape[1]), dtype=np.int32)
        for r in range(R):
            lut = {}
            for s in range(R):
                for j, d in enumerate(ghost[r][s]):
                    lut[int(self.padded_id[d])] = n_own_max + s * max_pair + j
            sel = np.nonzero(self.rank_of_cell == r)[0]
            pad_ids = self.padded_id[dofmap[sel]]
            own_lo, own_hi = r * n_own_max, (r + 1) * n_own_max
            local = np.empty_like(pad_ids, dtype=np.int64)
            own_mask = (pad_ids >= own_lo) & (pad_ids < own_hi)
            local[own_mask] = pad_ids[own_mask] - own_lo
            local[~own_mask] = np.array([lut[int(x)] for x in pad_ids[~own_mask]],
                                        dtype=np.int64)
            dm_local[r, : len(sel)] = local
        self.halo = dict(send_idx=send_idx, send_valid=send_valid.astype(np.float32),
                         dm_local=dm_local, local_size=local_size)

    def rank_tables(self, r: int) -> dict:
        """Rank r's kernel tables (NumPy): its real cells' DoF map (the padded
        global numbering, or the halo's local one), masks and geo, the DoF
        map transposed for dof_scatter with its schedule, and for the halo the
        send lists, their by-destination add runs and the [own | ghosts] set
        map."""
        n = int(self.n_cells_r[r])
        t = dict(masks=self.masks_r[r, :n], geo=self.geo_r[r, :n])
        if self.exchange == "halo":
            h = self.halo
            dm = h["dm_local"][r, :n]
            t.update(send_idx=h["send_idx"][r], send_valid=h["send_valid"][r].astype(np.float64),
                     set_map=np.arange(self.n_ranks * self.halo_max_pair, dtype=np.int32))
            t["add"] = halo_pack.transpose_lists(t["send_idx"], t["send_valid"])
            size = h["local_size"]
        else:
            dm = self.dofmap_r[r, :n]
            size = self.n_padded
        t["dofmap"] = dm
        t["scatter"] = dof_scatter.transpose_map(dm, size)
        return t


class DistributedLaplace(nn.Module):
    """The Laplace vmult of the rank that constructs it, over the ranks of
    ``group`` (default: the WORLD group; each rank one process), on
    ``device`` (default: ``cuda:<LOCAL_RANK>``; no card and no device
    raises). Vectors are the rank's owned block [n_own_max] of the padded
    owner-major numbering (``scatter_vector`` / ``gather_vector``).

    exchange: "allgather" (default) or "halo"; sm_group_size: the two-stage
    exchange over nodes of that many ranks (the reference's MPI-3
    shared-memory communicator analog, benchmark_02.cc:122-123), allgather
    only; perform_communication=False: the reference's no-comm ablation
    (the local block tiled in place of the gather, the leading block in
    place of the sum; the halo exchange always communicates, as the
    reference's does)."""

    def __init__(self, mf: MatrixFree, group=None, device=None, weights=None,
                 perform_communication: bool = True, sm_group_size: int | None = None,
                 exchange: str = "allgather"):
        super().__init__()
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange mode {exchange!r}")
        if exchange == "halo" and sm_group_size:
            raise ValueError("halo exchange and sm groups are exclusive")
        self.device = comm.rank_device(device)
        self.group = comm.default_group(group)
        self.mf = mf
        self.exchange = exchange
        self.perform_communication = bool(perform_communication)
        self.n_ranks = comm.size(self.group)
        self.rank = comm.rank(self.group)
        self.sm_group_size = sm_group_size
        if sm_group_size:
            self.intra, self.inter = comm.sm_groups(sm_group_size, self.group)
        self.plan = DistributedLaplacePlan(mf, self.n_ranks, weights, exchange)
        for k in ("n_own_max", "n_padded", "padded_id", "rank_of_cell", "n_ghost", "n_import"):
            setattr(self, k, getattr(self.plan, k))
        self.dtype = TORCH_DTYPES[mf.dtype]
        t = self.plan.rank_tables(self.rank)
        dev, dt = self.device, self.dtype
        i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
        f = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).to(dev, dt)
        src = mf._sources
        self.register_buffer("dofmap", i32(t["dofmap"]))
        self.register_buffer("codes", i32(t["masks"]) if mf.n_hn_cells else None)
        for k in ("P", "S", "Dc", "quad_w"):
            self.register_buffer(k, f(src[k]))
        self.kernel_factors = mf.kernel_factors  # cell_laplace's launch parameters
        self.register_buffer("geo", f(t["geo"]))
        self.register_buffer("scatter_ptr", i32(t["scatter"][0]))
        self.register_buffer("scatter_ent", i32(t["scatter"][1]))
        self.register_buffer("scatter_sched", i32(t["scatter"][2]))
        if exchange == "halo":
            self.local_size = self.plan.halo["local_size"]
            self.register_buffer("send_idx", i32(t["send_idx"]))
            self.register_buffer("send_valid", f(t["send_valid"]))
            self.register_buffer("set_map", i32(t["set_map"]))
            dst, ptr, srcs, w = t["add"]
            self.add_tables = (i32(dst), i32(ptr), i32(srcs), f(w))

    def scatter_tables(self):
        """dof_scatter's tables after the rows: (ptr, ent, sched)."""
        return (self.scatter_ptr, self.scatter_ent, self.scatter_sched)

    def cell_args(self):
        """cell_laplace's positional arguments after the source vector."""
        return (self.dofmap, self.codes, self.P, self.S, self.Dc, self.quad_w, self.geo)

    def _check(self, src):
        if src.shape != (self.n_own_max,) or src.dtype != self.dtype or src.device != self.device:
            raise ValueError(f"expected a [{self.n_own_max}] {self.dtype} block on {self.device}, "
                             f"got {tuple(src.shape)} {src.dtype} on {src.device}")

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        """The rank's owned block of A src (src the rank's block): a new
        tensor. Every rank of the group calls it together."""
        self._check(src)
        if self.exchange == "halo":
            return self._vmult_halo(src)
        c, sm, g = self.perform_communication, self.sm_group_size, self.group
        if c and sm:
            full = comm.all_gather(comm.all_gather(src, self.intra), self.inter)
        else:
            full = comm.all_gather(src, g, c)
        rows = cell_laplace.cell_laplace(full, *self.cell_args(), factors=self.kernel_factors)
        contrib = dof_scatter.dof_scatter(rows, *self.scatter_tables())
        if c and sm:
            return comm.psum_scatter(comm.psum_scatter(contrib, self.inter), self.intra)
        return comm.psum_scatter(contrib, g, c)

    def _vmult_halo(self, src):
        send = halo_pack.halo_pack(src, self.send_idx, self.send_valid, mode="pack")
        recv = comm.all_to_all(send, self.group)
        local = halo_pack.halo_pack(src, recv, self.set_map, mode="set")
        rows = cell_laplace.cell_laplace(local, *self.cell_args(), factors=self.kernel_factors)
        acc = dof_scatter.dof_scatter(rows, *self.scatter_tables())
        own = acc[: self.n_own_max]
        back = comm.all_to_all(acc[self.n_own_max:].view(self.n_ranks, -1), self.group)
        return halo_pack.halo_pack(own, back, *self.add_tables, mode="add")

    def forward(self, src):
        return self.vmult(src)

    # ------------------------------------------------------------ vectors
    def scatter_vector(self, u) -> torch.Tensor:
        """Old-numbering global vector (NumPy) -> this rank's block
        [n_own_max] on its device (pads zero)."""
        out = np.zeros(self.n_padded)
        out[self.padded_id] = np.asarray(u, dtype=np.float64)
        r = self.rank
        block = out[r * self.n_own_max:(r + 1) * self.n_own_max]
        return torch.from_numpy(block).to(self.device, self.dtype)

    def gather_vector(self, v: torch.Tensor) -> np.ndarray:
        """The ranks' blocks -> the old-numbering global vector (NumPy) on
        every rank: a collective (an all_gather), every rank calls it."""
        full = comm.all_gather(v.contiguous(), self.group)
        return full.cpu().numpy()[self.padded_id]
