"""The brick engine's Laplace vmult distributed over ranks on
``torch.distributed``, the port of
``dealii_matrixfree_hanging_nodes_tpu.parallel.bricks_distributed``: the
analog of the reference's distributed cell_loop on the fast hanging-node
path (benchmark_02.cc:122-209) on the brick layout.

- bricks are partitioned into contiguous weighted ranges along the Morton
  curve of their origins (benchmark_02.cc:63-87); each rank owns a slab
  [nb_max, N3p] (pad rows zero and masked);
- the main operator and the hole cells' removal are brick-local;
- the cross-brick sum splits each kind of interface pool (faces, edges in
  3-D, corners) into rank-internal pools and boundary pools, the only DSS
  traffic (LinearAlgebra::distributed::Vector semantics,
  benchmark_02.cc:164-165);
- the hanging-node chain (HN^T, chained coarse-fine folds, the fill)
  couples only the "chain cells".

exchange="halo" (default), the analog of the partitioner's point-to-point
ghost exchange (benchmark_02.cc:136-165): the partial sums of the pools two
ranks share travel in one all_to_all, the chain rows' read slots in one
all_to_all a pass, and the chain runs on each rank's need buffer.
exchange="replicated": the boundary pools are summed by one all_reduce and
the chain block is gathered to every rank and run there (the reference's
baseline and cross-check).

The step on the port's kernels (the reference's one-hot products, ``Es``,
``Ssub``, ``_extract_cols`` and ``_scatter_cols`` are TPU workarounds and are
not ported: the kernels read and write slab nodes directly):

  cell_apply (the subset cells' rows: geo K, or the deformed mode's metric)
  -> halo_pack (the chain block) -> hn_interp (HN^T on the own block; under
  "replicated" after the gather, on every constrained row) -> halo_pack,
  all_to_all, halo_pack's set (the need buffer) -> chain_halo (the folds)
  -> corr_compact (dcols: the folded chain rows minus their plain rows, the
  holes' plain rows negated) -> brick_apply (main x geo, dcols in its
  epilogue; deformed: brick_deformed) -> dss_pools (accumulate) -> the
  pools' exchange (all_reduce; or halo_pack, all_to_all, halo_pack's add) ->
  dss_pools (read, node_valid zeroing) -> halo_pack (the fill block from the
  slab) -> the exchange -> chain_halo (the fills) -> hn_interp (HN on the
  own constrained rows) -> refill_update (the coverage-divided write-back).

``DistributedBrickPlan`` is the host plan of all ranks, built from (mf,
n_ranks, weights, exchange) alone, the same in every process and without a
process group: the reference's ``_setup`` and ``_build_halo`` with their
[R, ...] tables (the tests hold them against the reference's), and
``rank_tables(r)``, rank r's kernel tables. A rank's slab rows are its
subset bricks first (the reference's subset order), then its other bricks,
then the pads: the subset is a leading slice, as cell_apply and brick_apply's
epilogue take it. A rank puts on its device only the constants and its own
rows of the tables.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from ..bricks import BrickStructure, _brick_factors, _cell_factors, _pack_bits, brick_constants
from ..kernels import (brick_apply, brick_deformed, cell_apply, chain_halo, corr_compact,
                       dss_pools, halo_pack, hn_interp, refill_update)
from ..kernels._even_odd import factor_tables
from ..kernels.dss_pools import surface_entities
from ..matrix_free import TORCH_DTYPES, MatrixFree
from ..mesh import _interleave_bits
from . import comm

__all__ = ["DistributedBrickLaplace", "DistributedBrickPlan"]

EXCHANGES = ("halo", "replicated")


def _pad_rows(rows, fill, dtype=None) -> np.ndarray:
    """Stack variable-length 1D arrays into [R, max_len] with fill."""
    m = max(max((len(r) for r in rows), default=0), 1)
    out = np.full((len(rows), m), fill, dtype=dtype or np.asarray(rows[0]).dtype)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


class DistributedBrickPlan:
    """The host plan of a distributed brick Laplace over n_ranks ranks
    (NumPy): the reference's ``_setup`` (:105-413) and ``_build_halo``
    (:415-769) with their attributes and [R, ...] tables (rank_of_brick,
    bricks_r, slab_brick, sub_ids_r, chain_src_r, pools_f/e/c, the halo's
    fold / fill chain tables and dsend_idx, n_ghost, n_import, ...), then
    ``rank_tables(r)``. setup_s: host seconds by step."""

    def __init__(self, mf: MatrixFree, n_ranks: int, weights=None, exchange: str = "halo"):
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange mode {exchange!r}")
        if mf.dim not in (2, 3):
            raise NotImplementedError("the port's brick engine supports dim=2 and dim=3")
        t0 = time.perf_counter()
        self.mf = mf
        self.n_ranks = int(n_ranks)
        self.exchange = exchange
        self.bs = BrickStructure(mf, face_planes=False)
        t1 = time.perf_counter()
        c = brick_constants(mf, self.bs)
        # the kernels' factors, as the single-device engine derives them (bricks.kernel_tables)
        self.const = dict(c, **_cell_factors(c["Kb"], c["Mb"], c["K"], self.bs.p, mf.dim),
                          **_brick_factors(c["Kb"], c["Mb"], self.bs.p))
        t2 = time.perf_counter()
        self._setup(weights)
        t3 = time.perf_counter()
        if exchange == "halo":
            self._build_halo()
        self.setup_s = dict(structure=t1 - t0, constants=t2 - t1, setup=t3 - t2,
                            halo=time.perf_counter() - t3)

    # ------------------------------------------------------------- partition
    def _setup(self, weights):
        bs, mf, R = self.bs, self.mf, self.n_ranks
        B, dim, C = bs.B, bs.dim, bs.B**bs.dim
        N3p = self.const["N3p"]
        nb = bs.n_bricks

        # Morton order of the level-anchored brick origins
        lmax = int(bs.brick_level.max())
        anchored = bs.brick_coord << (lmax - bs.brick_level[:, None])
        order = np.lexsort((bs.brick_level, _interleave_bits(anchored, lmax + 1)))
        self.brick_order = order
        cell_w = np.ones(mf.n_cells) if weights is None else np.asarray(weights, np.float64)
        bw = np.zeros(nb)
        np.add.at(bw, bs.brick_of_cell, cell_w)
        cum = np.cumsum(bw[order])
        cuts = np.searchsorted(cum, cum[-1] * (np.arange(1, R) / R), side="right")
        rank_of_pos = np.zeros(nb, dtype=np.int32)
        for r, c in enumerate(cuts):
            rank_of_pos[c:] = r + 1
        rank_of_brick = np.empty(nb, dtype=np.int32)
        rank_of_brick[order] = rank_of_pos
        self.rank_of_brick = rank_of_brick
        self.rank_of_cell = rank_of_brick[bs.brick_of_cell]

        bricks_r = [order[rank_of_pos == r] for r in range(R)]
        self.bricks_r = bricks_r
        self.nb_r = np.array([len(b) for b in bricks_r])
        self.nb_max = nb_max = max(int(self.nb_r.max()), 1)
        self.slab_brick = _pad_rows(bricks_r, 0, np.int64)  # pad -> brick 0, masked
        self.slab_valid = slab_valid = _pad_rows([np.ones(len(b), bool) for b in bricks_r],
                                                 False, bool)
        self.slabpos_of_brick = np.full(nb, -1, dtype=np.int64)
        for r in range(R):
            self.slabpos_of_brick[bricks_r[r]] = np.arange(len(bricks_r[r]))

        dt = mf.dtype
        geo_g, nv_g = self.const["geo"], self.const["node_valid"]
        geo_r = np.zeros((R, nb_max), dtype=dt)
        nv_r = np.zeros((R, nb_max, N3p), dtype=bool)
        for r in range(R):
            k = len(bricks_r[r])
            geo_r[r, :k] = geo_g[bricks_r[r]]
            nv_r[r, :k] = nv_g[bricks_r[r]]
        self.geo_r, self.node_valid_r = geo_r, nv_r

        # ---- DSS pools: internal (local sum) vs boundary (exchanged) -----
        def split_pools(pool_id):
            n_pools = int(pool_id.max()) + 1 if pool_id.size else 0
            owner_min = np.full(n_pools, R, dtype=np.int64)
            owner_max = np.full(n_pools, -1, dtype=np.int64)
            rk = np.broadcast_to(rank_of_brick[:, None], pool_id.shape)
            np.minimum.at(owner_min, pool_id.reshape(-1), rk.reshape(-1))
            np.maximum.at(owner_max, pool_id.reshape(-1), rk.reshape(-1))
            is_bnd = owner_min != owner_max
            bnd_ids = np.cumsum(is_bnd) - 1
            n_bnd = int(is_bnd.sum())
            int_id_r = np.zeros((R, nb_max, pool_id.shape[1]), np.int32)
            bnd_id_r = np.full((R, nb_max, pool_id.shape[1]), n_bnd, np.int32)
            bnd_flag_r = np.ones((R, nb_max, pool_id.shape[1]), dtype=dt)
            n_int_max = 1
            for r in range(R):
                pids = pool_id[bricks_r[r]]
                internal = ~is_bnd[pids]
                upool, local = np.unique(pids[internal], return_inverse=True)
                n_int_max = max(n_int_max, len(upool))
                li = np.zeros(pids.shape, np.int32)
                li[internal] = local.astype(np.int32)
                k = len(bricks_r[r])
                int_id_r[r, :k] = li
                bi = np.full(pids.shape, n_bnd, np.int32)
                bi[~internal] = bnd_ids[pids[~internal]].astype(np.int32)
                bnd_id_r[r, :k] = bi
                bnd_flag_r[r, :k] = (~internal).astype(dt)
            return dict(int_id=int_id_r, bnd_id=bnd_id_r, bnd_flag=bnd_flag_r, n_int=n_int_max,
                        n_bnd=n_bnd)

        self.pools_f = split_pools(bs.face_pool_id)
        self.pools_c = split_pools(bs.corner_pool_id)
        self.pools_e = split_pools(bs.edge_pool_id) if dim == 3 else None

        # ---- exceptional subset per rank: bricks holding absent / chain cells
        absent_lin = np.nonzero(~bs.present)[0]
        chain_lin = set(bs.hn_lin.tolist())
        for g in bs.transfer_groups:
            chain_lin.update(g.coarse_cells.tolist())
        exc_bricks_g = sorted(set((absent_lin // C).tolist()) | {int(x) // C for x in chain_lin})
        exc_arr = np.asarray(exc_bricks_g, dtype=np.int64)
        sub_r = [self.slabpos_of_brick[exc_arr[rank_of_brick[exc_arr] == r]] for r in range(R)]
        self.sub_r = sub_r
        sub_slot_of_brick = np.full(nb, -1, dtype=np.int64)
        for r in range(R):
            if len(sub_r[r]):
                sub_slot_of_brick[self.slab_brick[r, sub_r[r]]] = np.arange(len(sub_r[r]))
        self.n_sub_max = n_sub_max = max(max((len(s) for s in sub_r), default=0), 1)
        self.sub_ids_r = _pad_rows(sub_r, 0, np.int32)
        geo_cell_sub_r = np.zeros((R, n_sub_max * C), dtype=dt)
        absent_keep_r = np.ones((R, n_sub_max * C, 1), dtype=dt)
        for r in range(R):
            for j, slab_row in enumerate(sub_r[r]):
                gb = self.slab_brick[r, slab_row]
                geo_cell_sub_r[r, j * C:(j + 1) * C] = geo_g[gb]
                absent_keep_r[r, j * C:(j + 1) * C, 0] = bs.present[gb * C:(gb + 1) * C]
        self.geo_cell_sub_r, self.absent_keep_r = geo_cell_sub_r, absent_keep_r

        # ---- chain rows: the replicated buffer's layout -----------------
        xfer = bs.hn_lin  # mask-sorted brick-cell ids
        extra = sorted(chain_lin - set(xfer.tolist()))
        chain_cells_g = np.concatenate([xfer, np.array(extra, dtype=np.int64)])
        rank_of_chain = rank_of_brick[chain_cells_g // C]
        chain_r = [chain_cells_g[rank_of_chain == r] for r in range(R)]
        self.n_chain_max = n_chain_max = max(max((len(c) for c in chain_r), default=0), 1)
        gid_of_lin = {}
        for r in range(R):
            for j, lin in enumerate(chain_r[r]):
                gid_of_lin[int(lin)] = r * n_chain_max + j
        chain_src_r = np.zeros((R, n_chain_max), dtype=np.int32)
        chain_valid_r = np.zeros((R, n_chain_max, 1), dtype=dt)
        for r in range(R):
            for j, lin in enumerate(chain_r[r]):
                chain_src_r[r, j] = sub_slot_of_brick[int(lin) // C] * C + int(lin) % C
                chain_valid_r[r, j, 0] = 1.0
        self.chain_src_r, self.chain_valid_r = chain_src_r, chain_valid_r
        self.hn_sub_g = np.array([gid_of_lin[int(x)] for x in xfer], dtype=np.int32)
        self._levels = levels = sorted({g.level for g in bs.transfer_groups})
        n_loc = (bs.p + 1) ** dim
        groups_g = {lv: [] for lv in levels}
        for g in bs.transfer_groups:
            T = np.zeros((n_loc, n_loc))
            T[g.src_slots, g.dst_slots] = 1.0
            groups_g[g.level].append(dict(
                fine=np.array([gid_of_lin[int(x)] for x in g.fine_cells], dtype=np.int32),
                coarse=np.array([gid_of_lin[int(x)] for x in g.coarse_cells], dtype=np.int32),
                T=T))
        xfer_levels = np.asarray(mf.tria.level[bs.xfer_cells])
        level_zero_g = {lv: dict(lin=self.hn_sub_g[xfer_levels == lv],
                                 keep=1.0 - bs.hn_closure[xfer_levels == lv].astype(np.float64))
                        for lv in levels}
        # fill coverage per rank: the rank's constrained cells holding each subset node
        hn_rank = rank_of_brick[bs.hn_lin // C]
        slot_idx = self.const["slot_idx"]
        fill_invden_r = np.zeros((R, n_sub_max, N3p))
        for r in range(R):
            den = np.zeros((n_sub_max, N3p))
            for lin in bs.hn_lin[hn_rank == r]:
                den[sub_slot_of_brick[int(lin) // C], slot_idx[int(lin) % C]] += 1.0
            fill_invden_r[r] = np.where(den > 0, 1.0 / np.maximum(den, 1.0), 0.0)
        self.fill_invden_r = fill_invden_r

        self.has_chain = len(chain_cells_g) > 0 and len(xfer) > 0
        self._chain_cells_g = chain_cells_g
        self._chain_r = chain_r
        self._rank_of_chain = rank_of_chain
        self.rep = dict(hn_sub_g=self.hn_sub_g, transfers=groups_g, level_zero=level_zero_g)

        # ghost / import statistics (benchmark_02.cc:136-165 analog)
        NB = bs.NB
        fsize, esize = (NB - 2) ** (dim - 1), (NB - 2 if dim == 3 else 0)
        self.n_ghost = np.zeros(R, dtype=np.int64)
        self.n_import = np.zeros(R, dtype=np.int64)
        for pools, size in ((self.pools_f, fsize), (self.pools_e, esize), (self.pools_c, 1)):
            if pools is None:
                continue
            for r in range(R):
                nb_bnd = int((pools["bnd_flag"][r][slab_valid[r]] > 0).sum())
                self.n_ghost[r] += nb_bnd * size
                self.n_import[r] += nb_bnd * size
        n_chain_of_rank = np.array([len(c) for c in chain_r], dtype=np.int64)
        self.n_ghost += (len(chain_cells_g) - n_chain_of_rank) * n_loc
        self.n_import += n_chain_of_rank * (R - 1) * n_loc

    # ------------------------------------------------------------- halo plan
    def _build_halo(self):
        """The neighbour-wise exchange's plan (the reference's ``_build_halo``):
        DSS: each rank's partial sums of the boundary pools it touches, in a
        flat buffer (faces | edges | corners | trash), exchanged pairwise with
        exactly the ranks that share them (one index table serves both
        directions). Chain: the fold needs the descendants whose values flow
        into own rows, the fill the ancestors that flow into own constrained
        rows; only the read slots of remote needed rows travel."""
        bs, R = self.bs, self.n_ranks
        dim, NB = bs.dim, bs.NB
        C = bs.B**dim
        dt = self.mf.dtype
        nb_max = self.nb_max
        rank_of_brick = self.rank_of_brick
        fsize, esize = (NB - 2) ** (dim - 1), (NB - 2 if dim == 3 else 0)
        classes = [("fp", bs.face_pool_id, bs.n_face_pools, fsize)]
        if dim == 3:
            classes.append(("ep", bs.edge_pool_id, bs.n_edge_pools, esize))
        classes.append(("cp", bs.corner_pool_id, bs.n_corner_pools, 1))

        touched, ntouch, halo = {}, {}, {}
        for name, pid, n_pools, size in classes:
            rk = np.repeat(rank_of_brick, pid.shape[1])
            upr = np.unique(np.stack([pid.reshape(-1), rk], axis=1), axis=0)
            is_bnd = np.bincount(upr[:, 0], minlength=n_pools) > 1
            per_rank = []
            for r in range(R):
                pl = np.sort(upr[upr[:, 1] == r, 0])
                per_rank.append(pl[is_bnd[pl]])
            touched[name] = per_rank
            nt = max(max((len(p) for p in per_rank), default=0), 1)
            ntouch[name] = nt
            bl = np.full((R, nb_max, pid.shape[1]), nt, np.int32)
            for r in range(R):
                pids = pid[self.bricks_r[r]]
                loc = np.full(pids.shape, nt, np.int32)
                bmask = is_bnd[pids]
                if bmask.any():
                    loc[bmask] = np.searchsorted(per_rank[r], pids[bmask]).astype(np.int32)
                bl[r, : len(self.bricks_r[r])] = loc
            halo[name + "_loc"] = bl
        self.halo_ntouch = ntouch
        offs, off = {}, 0
        for name, _, _, size in classes:
            offs[name] = off
            off += ntouch[name] * size
        self.halo_nflat = n_flat = off

        pair_scal = [[np.zeros(0, np.int64)] * R for _ in range(R)]
        for r in range(R):
            for s in range(R):
                if s == r:
                    continue
                pieces = []
                for name, _, _, size in classes:
                    shared = np.intersect1d(touched[name][r], touched[name][s])
                    if len(shared):
                        loc = np.searchsorted(touched[name][r], shared)
                        pieces.append((offs[name] + loc[:, None] * size
                                       + np.arange(size)[None, :]).reshape(-1))
                if pieces:
                    pair_scal[r][s] = np.concatenate(pieces)
        max_pair = max(max(max((len(pair_scal[r][s]) for s in range(R)), default=1)
                           for r in range(R)), 1)
        dsend_idx = np.full((R, R, max_pair), n_flat, np.int32)
        dsend_valid = np.zeros((R, R, max_pair), dtype=dt)
        for r in range(R):
            for s in range(R):
                ps = pair_scal[r][s]
                dsend_idx[r, s, : len(ps)] = ps
                dsend_valid[r, s, : len(ps)] = 1.0
        halo["dsend_idx"], halo["dsend_valid"] = dsend_idx, dsend_valid
        n_ghost = np.array([sum(len(pair_scal[r][s]) for s in range(R)) for r in range(R)],
                           dtype=np.int64)
        n_import = n_ghost.copy()  # the DSS exchange is symmetric
        self.n_ghost_dss = n_ghost.copy()

        n_loc = (bs.p + 1) ** dim
        if self.has_chain:
            import scipy.sparse as sp

            lin_list = self._chain_cells_g
            nch = len(lin_list)
            idx_of = {int(l): i for i, l in enumerate(lin_list)}
            levels = self._levels
            xfer_n = len(bs.hn_lin)
            xfer_levels = np.asarray(self.mf.tria.level[bs.xfer_cells])
            rank_of = self._rank_of_chain
            own_idx = [np.nonzero(rank_of == r)[0] for r in range(R)]
            own_pos_of_idx = np.zeros((R, nch), np.int64)
            for r in range(R):
                own_pos_of_idx[r, own_idx[r]] = np.arange(len(own_idx[r]))
            n_own_max = self.n_chain_max

            T_halo, gidx_by_level = {}, {}
            for lv in levels:
                gl = [g for g in bs.transfer_groups if g.level == lv]
                Ts = np.zeros((len(gl), n_loc, n_loc), dtype=dt)
                fidx, cidx = [], []
                for gi, g in enumerate(gl):
                    Ts[gi][g.src_slots, g.dst_slots] = 1.0
                    fidx.append(np.asarray([idx_of[int(x)] for x in g.fine_cells], np.int64))
                    cidx.append(np.asarray([idx_of[int(x)] for x in g.coarse_cells], np.int64))
                T_halo[lv] = Ts
                gidx_by_level[lv] = (fidx, cidx)
            self.rep["T_halo"] = T_halo

            # fold DAG: values flow fine -> coarse; M[f, c] = 1
            ef_all = np.concatenate([f for lv in levels for f in gidx_by_level[lv][0]])
            ec_all = np.concatenate([c for lv in levels for c in gidx_by_level[lv][1]])
            M = sp.csr_matrix((np.ones(len(ef_all)), (ef_all, ec_all)), shape=(nch, nch))
            Mt = M.T.tocsr()

            def pred_closure(M_, start):
                S = start.copy()
                while True:
                    newS = S | ((M_ @ S) > 0)
                    if (newS == S).all():
                        return newS
                    S = newS

            def chain_tables(tag, in_need, keep_by, slot_mask):
                need_remote = [np.nonzero(in_need[r] & (rank_of != r))[0] for r in range(R)]
                n_rem_max = max(max((len(x) for x in need_remote), default=0), 1)
                N_need = n_own_max + n_rem_max  # trash row = N_need
                pos = np.full((R, nch), N_need, np.int64)
                for r in range(R):
                    pos[r, own_idx[r]] = np.arange(len(own_idx[r]))
                    pos[r, need_remote[r]] = n_own_max + np.arange(len(need_remote[r]))
                cpx = [[np.zeros(0, np.int64)] * R for _ in range(R)]
                for r in range(R):
                    for s_ in range(R):
                        if s_ != r:
                            cpx[r][s_] = own_idx[r][in_need[s_][own_idx[r]]]
                slot_list = [np.nonzero(slot_mask[i])[0] for i in range(nch)]
                nsc = np.array([len(x) for x in slot_list], np.int64)
                spair = max(max(max((int(nsc[cpx[r][s_]].sum()) for s_ in range(R)), default=1)
                                for r in range(R)), 1)
                send_scal = np.zeros((R, R, spair), np.int32)
                send_scal_valid = np.zeros((R, R, spair), dtype=dt)
                recv_scal = np.full((R, R, spair), N_need * n_loc, np.int32)
                for r in range(R):
                    for s_ in range(R):
                        if s_ == r:
                            continue
                        ss = (np.concatenate([own_pos_of_idx[r, f] * n_loc + slot_list[f]
                                              for f in cpx[r][s_]])
                              if len(cpx[r][s_]) else np.zeros(0, np.int64))
                        send_scal[r, s_, : len(ss)] = ss
                        send_scal_valid[r, s_, : len(ss)] = 1.0
                        rcv = cpx[s_][r]
                        rr = (np.concatenate([pos[r, f] * n_loc + slot_list[f] for f in rcv])
                              if len(rcv) else np.zeros(0, np.int64))
                        recv_scal[r, s_, : len(rr)] = rr
                own_masks = np.zeros((R, n_own_max), np.int32)
                own_is_xfer = np.zeros((R, n_own_max, 1), dtype=dt)
                for r in range(R):
                    ox = own_idx[r][own_idx[r] < xfer_n]
                    own_masks[r, own_pos_of_idx[r, ox]] = bs.hn_masks[ox]
                    own_is_xfer[r, own_pos_of_idx[r, ox]] = 1.0
                ctrans, clz = {}, {}
                for lv in levels:
                    fidx, cidx = gidx_by_level[lv]
                    G = len(fidx)
                    sel_per = [[np.nonzero(in_need[r][cidx[gi] if keep_by == "coarse"
                                                      else fidx[gi]])[0] for gi in range(G)]
                               for r in range(R)]
                    m_max = max(max((len(s2) for sr in sel_per for s2 in sr), default=0), 1)
                    fine = np.full((R, G, m_max), N_need, np.int32)
                    coarse = np.full((R, G, m_max), N_need, np.int32)
                    tmask = np.zeros((R, G, m_max, 1), dtype=dt)
                    for gi in range(G):
                        for r in range(R):
                            s2 = sel_per[r][gi]
                            fine[r, gi, : len(s2)] = pos[r, fidx[gi][s2]]
                            coarse[r, gi, : len(s2)] = pos[r, cidx[gi][s2]]
                            tmask[r, gi, : len(s2)] = 1.0
                    ctrans[lv] = dict(fine=fine, coarse=coarse, mask=tmask)
                    lz_sel = [np.nonzero(in_need[r, :xfer_n] & (xfer_levels == lv))[0]
                              for r in range(R)]
                    z_max = max(max((len(s2) for s2 in lz_sel), default=0), 1)
                    lz_pos = np.full((R, z_max), N_need, np.int32)
                    lz_keep = np.zeros((R, z_max, n_loc), dtype=dt)
                    for r in range(R):
                        s2 = lz_sel[r]
                        lz_pos[r, : len(s2)] = pos[r, s2]
                        lz_keep[r, : len(s2)] = 1.0 - bs.hn_closure[s2].astype(np.float64)
                    clz[lv] = dict(pos=lz_pos, keep=lz_keep)
                halo[tag] = dict(send_scal=send_scal, send_scal_valid=send_scal_valid,
                                 recv_scal=recv_scal, own_masks=own_masks,
                                 own_is_xfer=own_is_xfer, ctrans=ctrans, clz=clz,
                                 n_need=N_need)
                n_rem = np.array([int(nsc[need_remote[r]].sum()) for r in range(R)], np.int64)
                n_imp = np.array([sum(int(nsc[cpx[r][s_]].sum()) for s_ in range(R))
                                  for r in range(R)], np.int64)
                return n_rem, n_imp

            in_need_fold = np.zeros((R, nch), dtype=bool)
            in_need_fill = np.zeros((R, nch), dtype=bool)
            for r in range(R):
                start = np.zeros(nch, dtype=bool)
                start[own_idx[r]] = True
                in_need_fold[r] = pred_closure(M, start)
                start2 = np.zeros(nch, dtype=bool)
                start2[own_idx[r][own_idx[r] < xfer_n]] = True
                S2 = pred_closure(Mt, start2)
                S2[own_idx[r]] = True  # own rows always live in the buffer
                in_need_fill[r] = S2
            fold_slots = np.zeros((nch, n_loc), dtype=bool)
            fill_slots = np.zeros((nch, n_loc), dtype=bool)
            for lv in levels:
                fidx, cidx = gidx_by_level[lv]
                gl = [g for g in bs.transfer_groups if g.level == lv]
                for gi, g in enumerate(gl):
                    fold_slots[np.ix_(fidx[gi], g.src_slots)] = True
                    fill_slots[np.ix_(cidx[gi], g.dst_slots)] = True
            g_fold, i_fold = chain_tables("fold", in_need_fold, "coarse", fold_slots)
            g_fill, i_fill = chain_tables("fill", in_need_fill, "fine", fill_slots)
            self.n_ghost_chain = g_fold + g_fill
            n_ghost = n_ghost + self.n_ghost_chain
            n_import = n_import + i_fold + i_fill
        self.halo = halo
        self.n_ghost = n_ghost
        self.n_import = n_import

    # ------------------------------------------------------ a rank's tables
    def rank_order(self, r: int) -> np.ndarray:
        """Rank r's device rows as slab positions: its subset bricks (the
        reference's subset order), its other bricks (slab order), the pads."""
        nb_r, sub = int(self.nb_r[r]), self.sub_r[r]
        rest = np.setdiff1d(np.arange(nb_r), sub)
        return np.concatenate([sub, rest, np.arange(nb_r, self.nb_max)]).astype(np.int64)

    def _dss_tables(self, r, perm):
        """dss_pools' tables of rank r: the pools buffer's regions (boundary
        pools of each kind, the halo's trash value, internal pools of each
        kind), each pool's contributors (device row << 5 | entity) in slab
        order, every (row, entity)'s read base, and the size of the
        exchanged prefix."""
        bs, R = self.bs, self.n_ranks
        dim, NB = bs.dim, bs.NB
        fsize, esize = (NB - 2) ** (dim - 1), NB - 2
        kinds = [("fp", self.pools_f, fsize)]
        if dim == 3:
            kinds.append(("ep", self.pools_e, esize))
        kinds.append(("cp", self.pools_c, 1))
        halo = self.exchange == "halo"
        nb_r = int(self.nb_r[r])
        devrow = np.empty(self.nb_max, dtype=np.int64)
        devrow[perm] = np.arange(self.nb_max)
        sizes, pool_of, ent_base = [], [], 0
        regions = {}
        for name, pools, size in kinds:  # the exchanged boundary pools first
            n = self.halo_ntouch[name] if halo else pools["n_bnd"] + 1
            regions[name, "bnd"] = len(sizes)
            sizes += [size] * n
        if halo:  # the flat buffer's trash value
            sizes.append(1)
        n_prefix = int(np.sum(sizes))
        for name, pools, size in kinds:
            flag = pools["bnd_flag"][r, :nb_r] > 0
            ids = pools["int_id"][r, :nb_r]
            n = int(ids[~flag].max()) + 1 if (~flag).any() else 0
            regions[name, "int"] = len(sizes)
            sizes += [size] * n
        pool_off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        codes, pools_of_entry = [], []
        read_base = np.zeros((self.nb_max, 0), dtype=np.int64)
        for name, pools, size in kinds:
            k = pools["int_id"].shape[2]
            flag = pools["bnd_flag"][r, :nb_r] > 0
            bnd = (self.halo[name + "_loc"][r, :nb_r] if halo else pools["bnd_id"][r, :nb_r])
            q = np.where(flag, regions[name, "bnd"] + bnd, regions[name, "int"]
                         + pools["int_id"][r, :nb_r]).astype(np.int64)  # [nb_r, k]
            pools_of_entry.append(q.reshape(-1))
            ent = ent_base + np.arange(k)
            codes.append(((devrow[:nb_r, None] << 5) | ent[None, :]).reshape(-1))
            rb = np.zeros((self.nb_max, k), dtype=np.int64)
            rb[devrow[:nb_r]] = pool_off[q]
            read_base = np.concatenate([read_base, rb], axis=1)
            ent_base += k
        q_all, c_all = np.concatenate(pools_of_entry), np.concatenate(codes)
        order = np.argsort(q_all, kind="stable")  # per pool: slab order, then entity
        pool_ptr = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(np.bincount(q_all, minlength=len(sizes)), out=pool_ptr[1:])
        surf_node, ent_off, node_ent = surface_entities(NB, dim)
        N3p = self.const["N3p"]
        node_ent_p = np.full(N3p, -1, dtype=np.int32)
        node_ent_p[: len(node_ent)] = node_ent
        if pool_off[-1] >= 2**31 or self.nb_max * N3p >= 2**31:
            raise NotImplementedError("a rank's pools or slab exceed int32")
        return dict(surf_node=surf_node, ent_off=ent_off, pool_off=pool_off.astype(np.int32),
                    pool_ptr=pool_ptr.astype(np.int32), pool_src=c_all[order].astype(np.int32),
                    n_slots=int(pool_off[-1]), n_prefix=n_prefix, node_ent=node_ent_p,
                    read_base=read_base.astype(np.int32))

    def _chain_maps(self, r):
        """The fold and fill chains of rank r composed for chain_halo
        ((ptr, src, w) each): on its need buffers (halo), or on the gathered
        buffer (replicated: the same for every rank, built once)."""
        n_loc = (self.bs.p + 1) ** self.bs.dim
        if self.exchange == "replicated":
            if getattr(self, "_rep_maps", None) is None:
                rep, rows = self.rep, self.n_ranks * self.n_chain_max
                lv_args = {lv: ([(g["fine"], g["coarse"], g["T"], np.ones(len(g["fine"])))
                                 for g in rep["transfers"][lv]], rep["level_zero"][lv]["lin"],
                                rep["level_zero"][lv]["keep"]) for lv in self._levels}
                self._rep_maps = tuple(
                    chain_halo.compose(rows, n_loc, [lv_args[lv] for lv in
                                                     sorted(self._levels, reverse=not fill)],
                                       fill) for fill in (False, True))
            return self._rep_maps
        maps = []
        for tag, fill in (("fold", False), ("fill", True)):
            t = self.halo[tag]
            args = []
            for lv in sorted(self._levels, reverse=not fill):
                ct, lz = t["ctrans"][lv], t["clz"][lv]
                args.append(([(ct["fine"][r, g], ct["coarse"][r, g], self.rep["T_halo"][lv][g],
                               ct["mask"][r, g, :, 0]) for g in range(ct["fine"].shape[1])],
                             lz["pos"][r], lz["keep"][r]))
            maps.append(chain_halo.compose(t["n_need"] + 1, n_loc, args, fill))
        return tuple(maps)

    def rank_tables(self, r: int) -> dict:
        """Rank r's kernel tables (NumPy, float64 where floating): the device
        row order ``perm``, the subset's size, geo by row and cell, the node
        validity bits, the DSS tables, the cell codes of corr_compact (holes
        -2 on the Cartesian mapping, own chain rows their block row), and
        with a chain: the block gathers (from the cell rows, from the slab),
        the HN rows and masks, the exchange lists, the composed fold and fill,
        and refill_update's codes, nodes, holders and divisors."""
        bs, cst = self.bs, self.const
        C, n_loc, N3p = bs.B**bs.dim, (bs.p + 1) ** bs.dim, cst["N3p"]
        R, ncm = self.n_ranks, self.n_chain_max
        deformed = self.mf.high_order_mapping
        perm = self.rank_order(r)
        n_sub = len(self.sub_r[r])
        real = perm < self.nb_r[r]
        gb = self.slab_brick[r, perm]
        t = dict(perm=perm, n_sub=n_sub, geo=self.geo_r[r][perm].astype(np.float64),
                 geo_cell_sub=self.geo_cell_sub_r[r][: n_sub * C].astype(np.float64),
                 valid_bits=_pack_bits(self.node_valid_r[r][perm]), dss=self._dss_tables(r, perm))
        if deformed:
            rows = (gb[:, None] * C + np.arange(C)[None, :]).reshape(-1)
            metric = cst["metric"][rows]
            metric[np.repeat(~real, C)] = 0.0
            present = bs.present[rows].reshape(-1, C) & real[:, None]
            t.update(metric=metric, present_bits=_pack_bits(present))
        code = np.full(n_sub * C, -1, dtype=np.int32)
        if not deformed:
            code[self.absent_keep_r[r, : n_sub * C, 0] == 0] = -2
        n_own = len(self._chain_r[r])
        src = self.chain_src_r[r][:n_own].astype(np.int64)
        if self.has_chain:
            if (code[src] != -1).any():
                raise AssertionError("a chain cell is absent")
            code[src] = np.arange(n_own)
        t["cell_code"] = code
        t["corr_blocks"] = corr_compact.schedule(np.zeros(n_sub * C, np.int64), n_loc)
        if self.exchange == "halo":
            d = self.halo
            t["dss_send"] = (d["dsend_idx"][r], d["dsend_valid"][r].astype(np.float64))
            t["dss_add"] = halo_pack.transpose_lists(*t["dss_send"])
        if not self.has_chain:
            return t
        valid = np.repeat(self.chain_valid_r[r][:, :1].astype(np.float64), n_loc, axis=1)
        csrc = self.chain_src_r[r].astype(np.int64)
        t["block_idx"] = (csrc[:, None] * n_loc + np.arange(n_loc)[None, :]).astype(np.int32)
        t["fill_idx"] = ((csrc // C)[:, None] * N3p + cst["slot_idx"][csrc % C]).astype(np.int32)
        t["block_valid"] = valid
        hn_set = set(bs.hn_lin.tolist())
        is_xfer = np.array([int(x) in hn_set for x in self._chain_r[r]], dtype=bool)
        fcode = np.full(n_sub * C, -1, dtype=np.int32)
        fcode[src[is_xfer]] = np.nonzero(is_xfer)[0]
        nodes = np.unique(cst["slot_idx"][src[is_xfer] % C].reshape(-1)) if is_xfer.any() \
            else np.zeros(0, np.int64)
        flat = cst["slot_idx"].reshape(-1)
        order = np.argsort(flat, kind="stable")
        holders = np.full((len(nodes), refill_update.MAX_HOLDERS), -1, dtype=np.int64)
        for i, w in enumerate(nodes):
            ent = order[np.searchsorted(flat[order], w):np.searchsorted(flat[order], w,
                                                                        side="right")]
            holders[i, : len(ent)] = ((ent // n_loc) << 16) | (ent % n_loc)
        t.update(fill_code=fcode, refill_nodes=nodes.astype(np.int32),
                 refill_holders=holders.astype(np.int32),
                 refill_invden=self.fill_invden_r[r][:n_sub][:, nodes])
        t["fold_map"], t["fill_map"] = self._chain_maps(r)
        if self.exchange == "halo":
            masks = self.halo["fold"]["own_masks"][r]
            hn_rows = np.nonzero(masks != 0)[0]
            t.update(hnT_rows=hn_rows, hnT_codes=masks[hn_rows], hn_rows=hn_rows,
                     hn_codes=masks[hn_rows])
            for tag in ("fold", "fill"):
                h = self.halo[tag]
                n_buf = (h["n_need"] + 1) * n_loc
                t[tag] = dict(send_idx=h["send_scal"][r],
                              send_valid=h["send_scal_valid"][r].astype(np.float64),
                              set_map=halo_pack.set_map(n_buf, ncm * n_loc, h["recv_scal"][r],
                                                        h["send_scal_valid"][:, r]),
                              n_need=h["n_need"])
        else:
            own = (self.hn_sub_g // ncm) == r
            t.update(hnT_rows=self.hn_sub_g, hnT_codes=bs.hn_masks, hn_rows=self.hn_sub_g[own],
                     hn_codes=bs.hn_masks[own])
        return t


class DistributedBrickLaplace(nn.Module):
    """The brick engine's Laplace vmult of the rank that constructs it, over
    the ranks of ``group`` (default: the WORLD group; one process a rank), on
    ``device`` (default: ``cuda:<LOCAL_RANK>``; no card and no device
    raises). Vectors are the rank's slab [nb_max, N3p] (``from_dof_vector``
    / ``to_dof_vector``), its rows in ``perm``'s order (subset first).

    exchange: "halo" (default) or "replicated"; weights: per-cell weights
    (a brick weighs the sum of its cells'); perform_communication=False:
    the reference's no-comm ablation (``recv = send``, the own block tiled,
    no sum of the boundary pools). Both mappings run at every degree of
    the brick engine."""

    def __init__(self, mf: MatrixFree, group=None, device=None, weights=None,
                 perform_communication: bool = True, exchange: str = "halo"):
        super().__init__()
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange mode {exchange!r}")
        self.device = comm.rank_device(device)
        self.group = comm.default_group(group)
        self.mf = mf
        self.exchange = exchange
        self.perform_communication = bool(perform_communication)
        self.n_ranks = comm.size(self.group)
        self.rank = comm.rank(self.group)
        self.plan = DistributedBrickPlan(mf, self.n_ranks, weights, exchange)
        pl, bs = self.plan, self.plan.bs
        self.bs = bs
        self.B, self.p, self.dim, self.NB = bs.B, bs.p, bs.dim, bs.NB
        self.C, self.n_loc = bs.B**bs.dim, (bs.p + 1) ** bs.dim
        self.N3, self.N3p = pl.const["N3"], pl.const["N3p"]
        self.nb_max, self.n_chain_max = pl.nb_max, pl.n_chain_max
        self.has_chain = pl.has_chain
        self.deformed = bool(mf.high_order_mapping)
        self.n_ghost, self.n_import = pl.n_ghost, pl.n_import
        self.dtype = TORCH_DTYPES[mf.dtype]
        t0 = time.perf_counter()
        t = pl.rank_tables(self.rank)
        t1 = time.perf_counter()
        self.n_sub = t["n_sub"]
        self.perm = t["perm"]
        dev, dt = self.device, self.dtype
        i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
        f = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).to(dev, dt)
        host = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).to(dt)
        c = pl.const
        # cell_apply and brick_apply take their factors by value: host tensors
        self.factors_host = (host(c["K1"]), host(c["M1"]))
        self.brick_factors_host = (host(c["Kb_packed"]), host(c["Mb_packed"]))
        for k in ("P", "S", "Dc"):
            self.register_buffer(k, f(c[k]))
        self.register_buffer("geo", f(t["geo"]))
        self.register_buffer("geo_cell_sub", f(t["geo_cell_sub"]))
        self.register_buffer("valid_bits", i32(t["valid_bits"]))
        if self.deformed:
            self.register_buffer("metric", f(t["metric"]))
            self.register_buffer("present_bits", i32(t["present_bits"]))
            # brick_deformed's launch parameters (BrickLaplaceMM.kernel_factors)
            self.kernel_factors = factor_tables(c["S"], c["Dc"])
        d = t["dss"]
        self.dss_acc = (i32(d["surf_node"]), i32(d["ent_off"]), i32(d["pool_off"]),
                        i32(d["pool_ptr"]), i32(d["pool_src"]), d["n_slots"])
        self.dss_read = (i32(d["node_ent"]), i32(d["read_base"]), self.valid_bits)
        self.n_prefix = d["n_prefix"]
        if exchange == "halo":
            self.dss_send = (i32(t["dss_send"][0]), f(t["dss_send"][1]))
            dst, ptr, src, w = t["dss_add"]
            self.dss_add = (i32(dst), i32(ptr), i32(src), f(w))
        no_runs = (i32(np.zeros(1)), i32(np.zeros(0)), i32(np.zeros(0)))
        self.register_buffer("cell_code", i32(t["cell_code"]))
        self.corr_runs = no_runs + (i32(t["corr_blocks"]),)
        # corr_compact's keep mask: every slot of the folded chain rows
        self.keep = torch.ones((self.n_chain_max if self.has_chain else 0, self.n_loc),
                               dtype=torch.bool, device=dev)
        if self.has_chain:
            self.block = (i32(t["block_idx"]), f(t["block_valid"]))
            self.fill_block = (i32(t["fill_idx"]), self.block[1])
            self.hnT = (i32(t["hnT_codes"]), i32(t["hnT_rows"]))
            self.hn = (i32(t["hn_codes"]), i32(t["hn_rows"]))
            self.fold_map = (i32(t["fold_map"][0]), i32(t["fold_map"][1]), f(t["fold_map"][2]))
            self.fill_map = (i32(t["fill_map"][0]), i32(t["fill_map"][1]), f(t["fill_map"][2]))
            self.refill = (self.valid_bits, i32(t["fill_code"]), i32(t["refill_nodes"]),
                           i32(t["refill_holders"]), f(t["refill_invden"]), self.B)
            if exchange == "halo":
                self.xch = {tag: (i32(t[tag]["send_idx"]), f(t[tag]["send_valid"]),
                                  i32(t[tag]["set_map"]), t[tag]["n_need"])
                            for tag in ("fold", "fill")}
        self.empty = torch.empty((0, self.n_loc), dtype=dt, device=dev)
        self.setup_s = dict(pl.setup_s, rank_tables=t1 - t0,
                            transfer=time.perf_counter() - t1)
        dm = np.zeros((bs.n_bricks, self.N3p), dtype=bool)
        dm[:, : self.N3] = bs.dot_mask.reshape(bs.n_bricks, self.N3)
        rows = pl.slab_brick[self.rank, self.perm]
        dm = dm[rows] & (self.perm < pl.nb_r[self.rank])[:, None]
        self.register_buffer("dot_mask_b", torch.from_numpy(dm).to(dev))

    # ---------------------------------------------------------------- pieces
    def _exchange(self, block, tag):
        """The chain block [n_chain_max, n_loc] -> the chain buffer: the halo's
        pack, all_to_all and set into [N_need+1, n_loc], or the gathered
        [R n_chain_max, n_loc]."""
        c = self.perform_communication
        if self.exchange == "replicated":
            return comm.all_gather(block, self.group, c)
        idx, valid, m, n_need = self.xch[tag]
        recv = comm.all_to_all(halo_pack.halo_pack(block, idx, valid, mode="pack"), self.group,
                               c)
        return halo_pack.halo_pack(block, recv, m, mode="set").view(n_need + 1, self.n_loc)

    def _own_rows(self, buf):
        """The rank's own rows of a chain buffer: the need buffer's leading
        block, or the rank's block of the gathered buffer (a view)."""
        if self.exchange == "replicated":
            return buf[self.rank * self.n_chain_max:(self.rank + 1) * self.n_chain_max]
        return buf[: self.n_chain_max]

    def vmult(self, bv: torch.Tensor) -> torch.Tensor:
        """The rank's slab of A bv (bv the rank's slab, reduced as the
        reference's vmult takes it): a new tensor. Every rank of the group
        calls it together."""
        if bv.shape != (self.nb_max, self.N3p) or bv.dtype != self.dtype or (
                bv.device != self.device):
            raise ValueError(f"expected a [{self.nb_max}, {self.N3p}] {self.dtype} slab on "
                             f"{self.device}, got {tuple(bv.shape)} {bv.dtype} on {bv.device}")
        B, n_sub = self.B, self.n_sub
        plain = None
        if n_sub and (self.has_chain or not self.deformed):
            u_sub = bv[:n_sub]
            if self.deformed:
                plain = cell_apply.cell_apply(u_sub, None, None, None, B, deformed=(
                    self.S, self.Dc, self.metric[: n_sub * self.C]))
            else:
                plain = cell_apply.cell_apply(u_sub, *self.factors_host, self.geo_cell_sub, B)
        sub_raw = self.empty
        if self.has_chain:
            block = halo_pack.halo_pack(self.empty if plain is None else plain, *self.block,
                                        mode="pack")
            if self.exchange == "halo":
                hn_interp.hn_interp(block, self.hnT[0], self.P, True, rows=self.hnT[1])
                buf = self._exchange(block, "fold")
            else:
                buf = self._exchange(block, "fold")
                hn_interp.hn_interp(buf, self.hnT[0], self.P, True, rows=self.hnT[1])
            sub_raw = self._own_rows(chain_halo.chain_halo(buf, *self.fold_map))
        dcols = None
        if plain is not None:
            dcols = corr_compact.corr_compact(plain, sub_raw, self.cell_code, self.keep,
                                              *self.corr_runs)
        if self.deformed:
            v = brick_deformed.brick_deformed(bv, self.metric, self.present_bits, self.S, self.Dc,
                                              dcols=dcols, brick_size=B,
                                              factors=self.kernel_factors)
        else:
            v = brick_apply.brick_apply(bv, *self.brick_factors_host, self.geo, self.p,
                                        dcols=dcols, brick_size=B)
        pools = dss_pools.dss_pools(v, *self.dss_acc, mode="accumulate")
        c = self.perform_communication
        if self.exchange == "replicated":
            comm.psum(pools[: self.n_prefix], self.group, c)
        else:
            recv = comm.all_to_all(halo_pack.halo_pack(pools, *self.dss_send, mode="pack"),
                                   self.group, c)
            halo_pack.halo_pack(pools, recv, *self.dss_add, mode="add")
        dss_pools.dss_pools(v, pools, *self.dss_read, mode="read")
        if self.has_chain:
            block2 = halo_pack.halo_pack(v, *self.fill_block, mode="pack")
            buf2 = chain_halo.chain_halo(self._exchange(block2, "fill"), *self.fill_map)
            hn_interp.hn_interp(buf2, self.hn[0], self.P, False, rows=self.hn[1])
            if n_sub:
                v = refill_update.refill_update(v, self._own_rows(buf2), *self.refill)
        return v

    def forward(self, bv):
        return self.vmult(bv)

    # ------------------------------------------------------------ vectors
    def from_dof_vector(self, u) -> torch.Tensor:
        """Global DoF vector (NumPy) -> this rank's slab [nb_max, N3p] on its
        device, the hanging entries distributed (pads zero)."""
        bs, pl, r = self.bs, self.plan, self.rank
        u_dist = self.mf.constraints.distribute(np.asarray(u, dtype=np.float64))
        rows = pl.slab_brick[r, self.perm]
        real = self.perm < pl.nb_r[r]
        nd = bs.node_dof.reshape(bs.n_bricks, self.N3)[rows]
        vals = np.where(nd >= 0, u_dist[np.maximum(nd, 0)], 0.0)
        vals[~real] = 0.0
        out = np.zeros((self.nb_max, self.N3p))
        out[:, : self.N3] = vals
        return torch.from_numpy(out).to(self.device, self.dtype)

    def to_dof_vector(self, bv: torch.Tensor, zero_hanging: bool = False) -> np.ndarray:
        """The ranks' slabs -> the global DoF vector (NumPy, owner-copy
        reads, no refill, as the reference's) on every rank: a collective (an
        all_gather), every rank calls it. zero_hanging zeroes the hanging
        DoFs."""
        pl, bs = self.plan, self.bs
        full = comm.all_gather(bv.contiguous(), self.group).cpu().numpy()
        glob = np.zeros((bs.n_bricks, self.N3), dtype=full.dtype)
        for r in range(self.n_ranks):
            perm = pl.rank_order(r)
            real = perm < pl.nb_r[r]
            glob[pl.slab_brick[r, perm[real]]] = full[r * self.nb_max:(r + 1) * self.nb_max][
                real, : self.N3]
        u = glob.reshape(-1)[bs.owner_node_of_dof]
        if zero_hanging:
            u = u.copy()
            u[self.mf.constraints.constrained_dof_marker()] = 0.0
        return u

    def dot(self, u, v) -> torch.Tensor:
        """The reduced-space dot (each DoF's owner copy once) over all ranks:
        the rank's sum, then an all_reduce (every rank calls it)."""
        s = torch.sum(torch.where(self.dot_mask_b, u * v, 0.0)).reshape(1)
        return comm.psum(s, self.group)[0]

    def norm(self, u) -> torch.Tensor:
        return torch.sqrt(self.dot(u, u))
