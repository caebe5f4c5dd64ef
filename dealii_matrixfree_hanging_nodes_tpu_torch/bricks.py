"""Brick engine of the PyTorch port: the constrained Cartesian Laplace vmult
on per-brick node arrays, held against ``dealii_matrixfree_hanging_nodes_tpu
.bricks.BrickLaplaceMM`` (degree >= 4 defaults: compact fold chains,
input-side hanging-node fill, pooled cross-brick summation).

Layout (as in the reference, so vectors compare one to one): cells are
grouped into Morton-aligned, level-uniform bricks of B^3 cells; a brick
stores the NB^3 (NB = B*p+1) nodes of its cell block, padded to N3p, as one
row of a [n_bricks, N3p] tensor. Bricks holding holes or constrained cells
(the "subset") come first, so every subset access is a leading slice.

vmult = brick_apply (separable operator x geo, every brick)
      + on the subset: cell_apply (cells read from the bricks, times K),
        the fill / HN / fold chain on the constrained rows (plain PyTorch),
        cols_overlap_add (per-cell deltas summed back into the bricks)
      -> dss_surface (sum each shared face/edge/corner over its pool,
        zero the hole nodes).

The reference expresses the data movement with one-hot matmuls because the
TPU gathers slowly; here every one-hot operator is an index map (``slot_idx``
for E, the surface node list for Es, X-node / position maps for EsI, EscX
and EFX), and the four device steps are hand-written CUDA kernels
(``kernels/``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .constraints import _active_lookup, decompress_mask
from .dof_handler import local_lattice
from .elements import shape_info
from .kernels import brick_apply, cell_apply, cols_overlap_add, dss_surface
from .kernels.dss_surface import surface_nodes
from .matrix_free import MatrixFree
from .ops.hanging_nodes import hn_composite_matrix

__all__ = ["BrickStructure", "BrickLaplaceMM", "auto_brick_size", "operator_tables"]


def _entity_slot_partition(mask: int, dim: int, p: int, lat: np.ndarray):
    """Partition the constrained-closure slots of a cell with this compressed
    mask among its constrained entities (faces first, then edges): each slot
    is claimed by exactly one entity so the fold/fill row transfers neither
    miss nor double-count. Returns list of (kind, axis, slots ndarray)."""
    sub, face, edge = decompress_mask(np.array([mask]), dim)
    sub, face, edge = int(sub[0]), int(face[0]), int(edge[0])
    claimed = np.zeros(len(lat), dtype=bool)
    out = []
    for d in range(dim):
        if (face >> d) & 1:
            s_d = (sub >> d) & 1
            sel = (lat[:, d] == s_d * p) & ~claimed
            out.append(("face", d, np.nonzero(sel)[0]))
            claimed |= sel
    if dim == 3:
        for e in range(3):
            if (edge >> e) & 1:
                a, b = [x for x in range(3) if x != e]
                s_a, s_b = (sub >> a) & 1, (sub >> b) & 1
                sel = (lat[:, a] == s_a * p) & (lat[:, b] == s_b * p) & ~claimed
                out.append(("edge", e, np.nonzero(sel)[0]))
                claimed |= sel
    return out


def _mirror_slots(kind: str, axis: int, slots: np.ndarray, mask: int,
                  dim: int, p: int, lat: np.ndarray) -> np.ndarray:
    """Destination slots on the coarse neighbor for a fold transfer: same
    tangential lattice indices, opposite side along the entity's normal(s)."""
    sub, _, _ = decompress_mask(np.array([mask]), dim)
    sub = int(sub[0])
    n = p + 1
    coords = lat[slots].copy()
    if kind == "face":
        s_d = (sub >> axis) & 1
        coords[:, axis] = (1 - s_d) * p
    else:  # edge along `axis`
        a, b = [x for x in range(3) if x != axis]
        s_a, s_b = (sub >> a) & 1, (sub >> b) & 1
        coords[:, a] = (1 - s_a) * p
        coords[:, b] = (1 - s_b) * p
    # lexicographic x fastest: slot = sum coords[d] * n^d
    flat = sum(coords[:, d] * (n**d) for d in range(dim))
    return flat.astype(np.int64)


@dataclass
class _TransferGroup:
    fine_cells: np.ndarray  # brick-cell linear ids [m]
    coarse_cells: np.ndarray  # brick-cell linear ids [m]
    src_slots: np.ndarray  # [k]
    dst_slots: np.ndarray  # [k]
    level: int = 0  # refinement level of the fine cells


def _pool_contrib_table(pool_id, n_pools, include_self):
    """Per-slot contributor lists for a pool assignment.

    pool_id: [nb, k] slot -> pool map. Returns an int32 table
    [nb*k, maxc] (or [nb*k, maxc-1] when include_self=False) whose row r
    lists the flat slot indices sharing r's pool in pool-canonical order,
    padded with the sentinel nb*k. Every copy of a shared interface reads
    its contributors directly, in one order, so all copies come out
    bit-identical."""
    flat = pool_id.reshape(-1).astype(np.int64)
    ns = flat.shape[0]
    if ns == 0:
        return np.zeros((0, 1), dtype=np.int32)
    order = np.argsort(flat, kind="stable")
    sorted_p = flat[order]
    starts = np.searchsorted(sorted_p, np.arange(n_pools))
    maxc = int(np.bincount(flat, minlength=n_pools).max())
    table = np.full((n_pools, maxc), ns, dtype=np.int64)
    rank = np.arange(ns) - starts[sorted_p]
    table[sorted_p, rank] = order
    full = table[flat]  # [ns, maxc], each row contains r itself once
    if include_self:
        return full.astype(np.int32)
    selfpos = np.argmax(full == np.arange(ns)[:, None], axis=1)
    keep = np.ones((ns, maxc), dtype=bool)
    keep[np.arange(ns), selfpos] = False
    return full[keep].reshape(ns, maxc - 1).astype(np.int32)


def auto_brick_size(degree: int, dim: int = 3) -> int:
    """The reference's brick size rule: the largest B in (2, 4, 8, 16)
    with (B*p+1)^dim within the cap (B=4 at p=4, B=2 at p=5..8)."""
    cap = 5100 if dim == 3 else 2600
    best = 2
    for B in (2, 4, 8, 16):
        if (B * degree + 1) ** dim <= cap:
            best = B
    return best


class BrickStructure:
    """Static brick layout + exchange plan derived from a MatrixFree object
    (the reference's ``BrickStructure`` without face planes)."""

    def __init__(self, mf: MatrixFree):
        if mf.dim != 3:
            raise NotImplementedError("the port's brick engine supports dim=3")
        self.mf = mf
        self.B = B = auto_brick_size(mf.degree, mf.dim)
        self.p = p = mf.degree
        self.dim = dim = mf.dim
        self.NB = NB = B * p + 1
        tria = mf.tria
        lat = local_lattice(p, dim)
        self._lat = lat
        n = p + 1
        n_loc = n**dim

        logB = int(np.log2(B))
        assert 2**logB == B

        # ---- brick membership -------------------------------------------
        lvl = tria.level
        bc = tria.coord >> np.int64(logB)
        bkey = lvl.astype(np.int64)
        for d in range(dim):
            bkey = (bkey << np.int64(16)) | bc[:, d]
        ukeys, brick_of_cell = np.unique(bkey, return_inverse=True)
        self.n_bricks = len(ukeys)
        self.brick_level = (ukeys >> np.int64(16 * dim)).astype(np.int64)
        self.brick_coord = np.stack(
            [(ukeys >> np.int64(16 * (dim - 1 - d))) & 0xFFFF for d in range(dim)],
            axis=1,
        ).astype(np.int64)
        lc = (tria.coord & (B - 1)).astype(np.int64)
        slot = sum(lc[:, d] * B**d for d in range(dim))

        # vertex-only cross-level contacts: a cell whose full-diagonal
        # neighbor slot (across the parent corner) is covered by an active
        # one-level-coarser cell, with NO constrained face/edge (mask 0). It
        # shares exactly one master vertex with the coarse level and needs
        # fold/fill transfers with identity weights.
        masks = mf._np["masks"]
        find = _active_lookup(tria)
        s_bits = (tria.coord & 1).astype(np.int64)
        nc = tria.coord + (2 * s_bits - 1)
        lim = np.int64(1) << tria.level
        inside = np.all((nc >= 0) & (nc < lim[:, None]), axis=1)
        valid = inside & (tria.level >= 1)
        vdiag = find(tria.level - 1, nc >> np.int64(1), valid)
        self.vertex_contact = (vdiag >= 0) & (masks == 0)
        self.vertex_diag = vdiag

        # ---- subset-first brick order -------------------------------------
        # Exceptional bricks (holes, constrained cells, or fold/fill coarse
        # targets) are renumbered to the front, so every subset access is a
        # leading slice. Chain bricks (touched by any constraint/fill/fold
        # index) form the first tier, hole-only bricks the second.
        C = B**dim
        ci = mf.constraints
        chain = np.zeros(self.n_bricks, dtype=bool)
        resid = masks != 0
        xsel = resid | self.vertex_contact
        chain[brick_of_cell[xsel]] = True
        mcells = np.nonzero(resid)[0]
        for nbr in (ci.face_neighbor[mcells], ci.edge_neighbor[mcells]):
            v = nbr[nbr >= 0]
            chain[brick_of_cell[v]] = True
        vd = vdiag[self.vertex_contact]
        if len(vd):
            chain[brick_of_cell[vd]] = True
        exc = (np.bincount(brick_of_cell, minlength=self.n_bricks) < C) | chain
        tier = np.where(chain, 0, np.where(exc, 1, 2))
        old_order = np.argsort(tier, kind="stable")  # chain, hole-only, rest
        rank = np.empty(self.n_bricks, dtype=np.int64)
        rank[old_order] = np.arange(self.n_bricks)
        self.brick_level = self.brick_level[old_order]
        self.brick_coord = self.brick_coord[old_order]
        brick_of_cell = rank[brick_of_cell]
        self.exc_brick = exc[old_order]
        self.n_exc_bricks = int(exc.sum())
        self.n_chain_bricks = int(chain.sum())
        assert self.exc_brick[: self.n_exc_bricks].all()

        self.brick_of_cell = brick_of_cell
        self.cell_lin = brick_of_cell * (B**dim) + slot  # brick-cell linear id
        self.present = np.zeros(self.n_bricks * C, dtype=bool)
        self.present[self.cell_lin] = True

        # transfer-active subset: constrained cells + vertex-contact cells,
        # stable-sorted by mask so each distinct mask forms one contiguous
        # range (one composite [n_loc, n_loc] matmul per range)
        xfer_sel = (masks != 0) | self.vertex_contact
        xfer_cells = np.nonzero(xfer_sel)[0]
        order = np.argsort(masks[xfer_cells], kind="stable")
        self.xfer_cells = xfer_cells[order]
        self.hn_lin = self.cell_lin[self.xfer_cells]
        self.hn_masks = masks[self.xfer_cells].astype(np.int32)

        # constrained-closure slot mask (slots whose fast-map entry was
        # replaced by a coarse master)
        sub_b, face_b, edge_b = decompress_mask(self.hn_masks, dim)
        m = len(self.hn_masks)
        closure = np.zeros((m, n_loc), dtype=bool)
        for d in range(dim):
            has = ((face_b >> d) & 1) == 1
            side = ((sub_b >> d) & 1) * p
            closure |= has[:, None] & (lat[None, :, d] == side[:, None])
        for e in range(3):
            a, b = [x for x in range(3) if x != e]
            has = ((edge_b >> e) & 1) == 1
            sa = ((sub_b >> a) & 1) * p
            sb = ((sub_b >> b) & 1) * p
            closure |= (
                has[:, None]
                & (lat[None, :, a] == sa[:, None])
                & (lat[None, :, b] == sb[:, None])
            )
        # vertex-contact cells (mask 0): closure = the parent-corner slot
        vsel = self.vertex_contact[self.xfer_cells]
        if vsel.any():
            sb = s_bits[self.xfer_cells[vsel]]
            corner = sum(sb[:, d] * p * (n**d) for d in range(dim))
            rows = np.nonzero(vsel)[0]
            closure[rows, corner] = True
        self.hn_closure = closure  # [n_hn, n_loc]

        # ---- node -> dof maps --------------------------------------------
        # brick node index of (cell slot, local lattice): per axis lc*p + il
        self._cni_off = sum(
            lat[:, d][None, :] * NB**d for d in range(dim)
        ).astype(np.int32)  # [1, n_loc]
        self._cni_base = sum(lc[:, d] * p * NB**d for d in range(dim)).astype(
            np.int32
        )  # [n_cells]

        nnode = self.n_bricks * NB**dim
        if nnode > np.iinfo(np.int32).max:
            raise NotImplementedError("brick node count exceeds int32")
        node_dof = np.full(nnode, -1, dtype=np.int32)
        cd32 = np.asarray(mf.dof_handler.cell_dofs, dtype=np.int32)
        bo_n = brick_of_cell.astype(np.int32)
        cstep = max(1, 40_000_000 // n_loc)
        for s in range(0, tria.n_active_cells, cstep):
            e = min(s + cstep, tria.n_active_cells)
            fn_ = bo_n[s:e, None] * np.int32(NB**dim) + self.cell_node_index_range(s, e)
            node_dof[fn_.ravel()] = cd32[s:e].ravel()
        self.node_dof = node_dof  # -1 at holes
        self.node_valid = node_dof >= 0

        # per-dof owner node (first covering brick node): scatter node
        # indices in descending order so the surviving write for each dof is
        # its smallest covering node
        owner = np.empty(mf.n_dofs, dtype=np.int32)
        val = np.nonzero(node_dof >= 0)[0][::-1]
        owner[node_dof[val]] = val.astype(np.int32)
        self.owner_node_of_dof = owner
        assert (node_dof[owner] == np.arange(mf.n_dofs)).all()

        hanging = mf.constraints.constrained_dof_marker()
        # dot-product weights: 1 at the owner node of each non-hanging dof
        wmask = np.zeros(nnode, dtype=bool)
        wmask[self.owner_node_of_dof[~hanging]] = True
        self.dot_mask = wmask

        # ---- same-level DSS pools (face / edge / corner interfaces) -----
        self._build_pools()
        # ---- coarse-fine fold/fill transfer groups -----------------------
        self._build_transfers()

    # ------------------------------------------------------------ node index
    def cell_node_index_range(self, s, e):
        """Brick node index of (cell slot, local lattice) for cells [s, e)."""
        return self._cni_base[s:e, None] + self._cni_off

    # ----------------------------------------------------------------- pools
    def _face_key(self, lvlb, bcb, d, side):
        """Geometric key of a brick face (canonical: lower brick, +d face)."""
        dim = self.dim
        c = bcb.copy()
        c[:, d] = c[:, d] + side  # face plane index in units of brick grid
        k = (lvlb << np.int64(16 * dim + 4)) | (np.int64(d) << np.int64(16 * dim))
        for dd in range(dim):
            k = k | (c[:, dd] << np.int64(16 * (dim - 1 - dd)))
        return k

    def _build_pools(self):
        nb = self.n_bricks
        lvlb, bcb = self.brick_level, self.brick_coord
        dim = self.dim

        # FACE pools carry the face interiors (1..NB-2)^2, EDGE pools the
        # edge interiors, CORNER pools the 8 corners: each node in exactly
        # one pool class
        keys = []
        for d in range(dim):
            for side in (0, 1):
                keys.append(self._face_key(lvlb, bcb, d, side))
        keys = np.concatenate(keys)
        uk, inv = np.unique(keys, return_inverse=True)
        self.face_pool_id = inv.reshape(2 * dim, nb).T.copy()  # [nb, 2*dim]
        self.n_face_pools = len(uk)

        edge_keys = []
        for e in range(3):
            a, b = [x for x in range(3) if x != e]
            for sa in (0, 1):
                for sb in (0, 1):
                    c = bcb.copy()
                    c[:, a] += sa
                    c[:, b] += sb
                    k = ((lvlb << np.int64(50)) | (np.int64(e) << np.int64(48))
                         | (c[:, 0] << np.int64(32)) | (c[:, 1] << np.int64(16))
                         | c[:, 2])
                    edge_keys.append(k)
        ek = np.concatenate(edge_keys)
        uek, einv = np.unique(ek, return_inverse=True)
        self.edge_pool_id = einv.reshape(12, nb).T.copy()  # [nb, 12]
        self.n_edge_pools = len(uek)

        ck = []
        for combo in range(2**dim):
            off = np.array([(combo >> d) & 1 for d in range(dim)])
            c = bcb + off
            k = lvlb << np.int64(16 * dim)
            for d in range(dim):
                k = k | (c[:, d] << np.int64(16 * (dim - 1 - d)))
            ck.append(k)
        ckk = np.concatenate(ck)
        uck, cinv = np.unique(ckk, return_inverse=True)
        self.corner_pool_id = cinv.reshape(2**dim, nb).T.copy()  # [nb, 2^dim]
        self.n_corner_pools = len(uck)

        # gather-only pair tables: a face slot has one partner (or the
        # sentinel); edge and corner copies sum their full contributor list
        # in pool-canonical order
        self.face_other = _pool_contrib_table(
            self.face_pool_id, self.n_face_pools, include_self=False
        )
        assert self.face_other.shape[1] <= 1
        self.edge_contrib = _pool_contrib_table(
            self.edge_pool_id, self.n_edge_pools, include_self=True
        )
        self.corner_contrib = _pool_contrib_table(
            self.corner_pool_id, self.n_corner_pools, include_self=True
        )

    # ------------------------------------------------------------- transfers
    def _build_transfers(self):
        """Mask-grouped fold/fill row transfers between fine constrained cells
        and their coarse neighbors, in the cols [*, n_loc] domain."""
        mf = self.mf
        dim, p = self.dim, self.p
        n = p + 1
        lat = self._lat
        ci = mf.constraints
        masks = mf._np["masks"]
        hn_cells = np.nonzero(masks != 0)[0]
        groups = []
        for mval in np.unique(masks[hn_cells]):
            cells = hn_cells[masks[hn_cells] == mval]
            for kind, axis, slots in _entity_slot_partition(int(mval), dim, p, lat):
                if len(slots) == 0:
                    continue
                if kind == "face":
                    nbr = ci.face_neighbor[cells, axis]
                else:
                    nbr = ci.edge_neighbor[cells, axis]
                assert (nbr >= 0).all()
                dst = _mirror_slots(kind, axis, slots, int(mval), dim, p, lat)
                for lv in np.unique(mf.tria.level[cells]):
                    lsel = mf.tria.level[cells] == lv
                    groups.append(
                        _TransferGroup(
                            fine_cells=self.cell_lin[cells[lsel]],
                            coarse_cells=self.cell_lin[nbr[lsel]],
                            src_slots=slots.astype(np.int64),
                            dst_slots=dst,
                            level=int(lv),
                        )
                    )
        # vertex-contact groups (identity weight), grouped by subcell combo
        vcells = np.nonzero(self.vertex_contact)[0]
        if len(vcells):
            sb = (mf.tria.coord[vcells] & 1).astype(np.int64)
            combo = sum(sb[:, d] << d for d in range(dim))
            for cv in np.unique(combo):
                sel = vcells[combo == cv]
                bits = [(cv >> d) & 1 for d in range(dim)]
                src = np.array(
                    [sum(bits[d] * p * (n**d) for d in range(dim))], dtype=np.int64
                )
                dst = np.array(
                    [sum((1 - bits[d]) * p * (n**d) for d in range(dim))],
                    dtype=np.int64,
                )
                for lv in np.unique(mf.tria.level[sel]):
                    lsel = mf.tria.level[sel] == lv
                    groups.append(
                        _TransferGroup(
                            fine_cells=self.cell_lin[sel[lsel]],
                            coarse_cells=self.cell_lin[self.vertex_diag[sel[lsel]]],
                            src_slots=src,
                            dst_slots=dst,
                            level=int(lv),
                        )
                    )
        self.transfer_groups = groups


# ===========================================================================
def _stage_chain(direction, levels, groups, n_loc):
    """Dependency-staged fold/fill chain schedule (the reference's
    ``_stage_chain``): stage 1 holds every transfer pair that reads no slot
    another pair writes, bucketed by pair count into padded [G, m] grids
    with one stacked T per grid row; later stages (true multi-level chains)
    are per-pair tails. Returns (src, dst, mask, T stacks, segs, tails)."""
    order = levels if direction == "fill" else list(reversed(levels))
    stagemap = {}  # row -> int[n_loc] max stage writing each slot
    pair_stage = {lv: [] for lv in levels}
    for lv in order:
        for g in groups[lv]:
            T = g["T"]
            if direction == "fill":
                read = np.abs(T).sum(axis=0) > 0
                write = np.abs(T).sum(axis=1) > 0
                src_rows, dst_rows = g["coarse"], g["fine"]
            else:
                read = np.abs(T).sum(axis=1) > 0
                write = np.abs(T).sum(axis=0) > 0
                src_rows, dst_rows = g["fine"], g["coarse"]
            stages = np.ones(len(src_rows), dtype=np.int64)
            for k, s in enumerate(src_rows):
                sm = stagemap.get(int(s))
                if sm is not None:
                    st = int(sm[read].max()) if read.any() else 0
                    stages[k] = st + 1
            for k, d in enumerate(dst_rows):
                sm = stagemap.setdefault(int(d), np.zeros(n_loc, dtype=np.int64))
                sm[write] = np.maximum(sm[write], stages[k])
            pair_stage[lv].append(stages)
    n_stages = max(
        (int(s.max()) for lv in levels for s in pair_stage[lv] if len(s)),
        default=1,
    )
    items = []  # (m1, lv, gi, srcs, dsts)
    for lv in levels:
        for gi, g in enumerate(groups[lv]):
            sel1 = pair_stage[lv][gi] == 1
            m1 = int(sel1.sum())
            if m1 == 0:
                continue
            srcs = (g["coarse"] if direction == "fill" else g["fine"])[sel1]
            dsts = (g["fine"] if direction == "fill" else g["coarse"])[sel1]
            items.append((m1, lv, gi, srcs, dsts))
    items.sort(key=lambda it: -it[0])
    buckets = []
    for it in items:
        if buckets and it[0] * 1.25 >= buckets[-1][0][0]:
            buckets[-1].append(it)
        else:
            buckets.append([it])
    src_all, dst_all, mask_all, T_stacks, segs = [], [], [], [], []
    off = 0
    for si, bucket in enumerate(buckets):
        G = len(bucket)
        m_max = bucket[0][0]
        src_pad = np.zeros((G, m_max), dtype=np.int64)
        dst_pad = np.zeros((G, m_max), dtype=np.int64)
        mask_pad = np.zeros((G, m_max), dtype=bool)
        T_stack = np.zeros((G, n_loc, n_loc))
        for bi, (m1, lv, gi, srcs, dsts) in enumerate(bucket):
            src_pad[bi, :m1] = srcs
            dst_pad[bi, :m1] = dsts
            mask_pad[bi, :m1] = True
            T = groups[lv][gi]["T"]
            T_stack[bi] = T.T if direction == "fill" else T
        src_all.append(src_pad.reshape(-1))
        dst_all.append(dst_pad.reshape(-1))
        mask_all.append(mask_pad.reshape(-1))
        T_stacks.append(T_stack)
        segs.append((si, off, G, m_max))
        off += G * m_max
    cat = lambda xs, dt: np.concatenate(xs).astype(dt) if xs else np.zeros(0, dt)
    tails = []
    for s in range(2, n_stages + 1):
        t_src, t_dst, t_T = [], [], []
        for lv in levels:
            for gi, g in enumerate(groups[lv]):
                sel = pair_stage[lv][gi] == s
                if not sel.any():
                    continue
                srcs = (g["coarse"] if direction == "fill" else g["fine"])[sel]
                dsts = (g["fine"] if direction == "fill" else g["coarse"])[sel]
                T = g["T"].T if direction == "fill" else g["T"]
                for sr, dr in zip(srcs, dsts):
                    t_src.append(int(sr))
                    t_dst.append(int(dr))
                    t_T.append(T)
        tails.append((np.asarray(t_src, np.int64), np.asarray(t_dst, np.int64),
                      np.stack(t_T)))
    return (cat(src_all, np.int64), cat(dst_all, np.int64),
            cat(mask_all, bool), T_stacks, segs, tails)


def operator_tables(mf: MatrixFree, bs: BrickStructure):
    """Host tables of the constrained p >= 4 Cartesian vmult, as index maps.

    Returns (arrays, meta): ``arrays`` maps buffer names to float64 / int64 /
    int32 / bool NumPy arrays (``BrickLaplaceMM`` buffer names), ``meta``
    holds the static sizes and schedules. The reference builds the same
    tables in ``BrickLaplaceMM.__init__`` (bricks.py:1186-1741) with one-hot
    matrices where these hold indices; ``convert.from_reference`` derives
    this dict from those."""
    p, B, NB, dim = bs.p, bs.B, bs.NB, bs.dim
    n = p + 1
    n_loc = n**dim
    N3 = NB**dim
    N3p = ((N3 + 127) // 128) * 128
    C = B**dim

    si = shape_info(p)
    w = si.quad_w
    M1 = np.einsum("q,qi,qj->ij", w, si.S, si.S)
    K1 = np.einsum("q,qi,qj->ij", w, si.D, si.D)
    K = np.zeros((n_loc, n_loc))
    for d in range(dim):
        facs = [K1 if t == d else M1 for t in range(dim)]
        A = facs[dim - 1]
        for t in range(dim - 2, -1, -1):
            A = np.kron(A, facs[t])
        K += A

    # per-slot node indices within a brick (the one-hot E as an index map)
    lat = local_lattice(p, dim)
    slot_lat = local_lattice(B - 1, dim)
    node_off = sum(lat[:, d] * NB**d for d in range(dim))
    slot_idx = np.zeros((C, n_loc), dtype=np.int64)
    for sl in range(C):
        slot_idx[sl] = sum(int(slot_lat[sl, d]) * p * NB**d for d in range(dim)) + node_off

    # 1-D assembled brick factors: A_brick = sum_d prod_t (Kb if t==d else Mb)
    Kb = np.zeros((NB, NB))
    Mb = np.zeros((NB, NB))
    for c in range(B):
        csl = slice(c * p, c * p + n)
        Kb[csl, csl] += K1
        Mb[csl, csl] += M1

    surf_idx = surface_nodes(NB)  # the one-hot Es as an index map
    n_surf = len(surf_idx)

    # the subset is the leading slice of bricks (BrickStructure's order), so
    # brick-cell ids are subset cell rows
    n_sub = bs.n_exc_bricks
    absent_sub = np.nonzero(~bs.present)[0].astype(np.int64)
    hn_sub = bs.hn_lin.astype(np.int64)
    levels = sorted({g.level for g in bs.transfer_groups})
    groups = {lv: [] for lv in levels}
    for g in bs.transfer_groups:
        T = np.zeros((n_loc, n_loc))
        T[g.src_slots, g.dst_slots] = 1.0
        groups[g.level].append(dict(fine=g.fine_cells.astype(np.int64),
                                    coarse=g.coarse_cells.astype(np.int64), T=T))
        assert max(g.fine_cells.max(), g.coarse_cells.max()) < n_sub * C
    assert (absent_sub < n_sub * C).all()

    h_cell = (mf.tria.right - mf.tria.left) * (0.5 ** bs.brick_level.astype(np.float64))
    geo_brick = h_cell ** (dim - 2)
    nv_pad = np.zeros((bs.n_bricks, N3p), dtype=bool)
    nv_pad[:, :N3] = bs.node_valid.reshape(bs.n_bricks, N3)

    arrays = dict(
        Kb=Kb, Mb=Mb, K=K, geo=geo_brick,
        geo_cell_sub=np.repeat(geo_brick[:n_sub], C),
        slot_idx=slot_idx, surf_idx=surf_idx,
        absent_sub=absent_sub, hn_sub=hn_sub,
        face_other=bs.face_other, edge_contrib=bs.edge_contrib,
        corner_contrib=bs.corner_contrib, node_valid=nv_pad,
    )
    meta = dict(B=B, p=p, NB=NB, N3=N3, N3p=N3p, n_sub=n_sub,
                hn_bounds=[],
                fill_segs=[], n_fill_tails=0, corr_segs=[], n_corr_tails=0)
    if not len(hn_sub):
        return arrays, meta

    # ---- compact chain schedules (the reference's chain_mode="compact")
    # The whole chain lives in the [n_hn, n_loc] space of the constrained
    # rows: fill destinations, corr sources and tail rows are hn rows, and
    # the level-zeroing row set is hn_sub itself.
    xfer_levels = mf.tria.level[bs.xfer_cells]
    lz_lin = np.concatenate([hn_sub[xfer_levels == lv] for lv in levels])
    lz_keep = np.concatenate(
        [1.0 - bs.hn_closure[xfer_levels == lv] for lv in levels])
    assert np.array_equal(np.sort(lz_lin), np.sort(hn_sub))
    pos_in_hn = np.full(n_sub * C, -1, dtype=np.int64)
    pos_in_hn[hn_sub] = np.arange(len(hn_sub))
    keep_hn = np.zeros((len(hn_sub), n_loc))
    keep_hn[pos_in_hn[lz_lin]] = lz_keep
    in_hn = pos_in_hn >= 0
    arrays["keep_hn"] = keep_hn
    for direction in ("fill", "corr"):
        src, dst, mask, T_stacks, segs, tails = _stage_chain(
            direction, levels, groups, n_loc)
        real = np.nonzero(mask)[0]
        meta[f"{direction}_segs"] = segs
        meta[f"n_{direction}_tails"] = len(tails)
        for seg, T in enumerate(T_stacks):
            arrays[f"{direction}_T{seg}"] = T
        if direction == "fill":
            assert in_hn[dst[real]].all()
            fix = real[in_hn[src[real]]]
            arrays.update(
                fill_src=src, fill_fix_idx=fix,
                fill_fix_local=pos_in_hn[src[fix]],
                fill_real_pos=real, fill_dst_local=pos_in_hn[dst[real]],
            )
            for ti, (ts, td, tT) in enumerate(tails):
                assert in_hn[ts].all() and in_hn[td].all()
                arrays[f"fill_tail{ti}_T"] = tT
                arrays[f"fill_tail{ti}_src"] = pos_in_hn[ts]
                arrays[f"fill_tail{ti}_dst"] = pos_in_hn[td]
        else:
            assert in_hn[src[real]].all()
            hn_pos = real[in_hn[dst[real]]]
            nh_pos = real[~in_hn[dst[real]]]
            arrays.update(
                corr_src=np.maximum(pos_in_hn[src], 0),
                corr_hn_pos=hn_pos, corr_hn_dst=pos_in_hn[dst[hn_pos]],
                corr_nh_pos=nh_pos, corr_nh_dst=dst[nh_pos],
            )
            for ti, (ts, td, tT) in enumerate(tails):
                assert in_hn[ts].all()
                thn = np.nonzero(in_hn[td])[0]
                tnh = np.nonzero(~in_hn[td])[0]
                arrays[f"corr_tail{ti}_T"] = tT
                arrays[f"corr_tail{ti}_src"] = pos_in_hn[ts]
                arrays[f"corr_tail{ti}_hn_pos"] = thn
                arrays[f"corr_tail{ti}_hn_dst"] = pos_in_hn[td[thn]]
                arrays[f"corr_tail{ti}_nh_pos"] = tnh
                arrays[f"corr_tail{ti}_nh_dst"] = td[tnh]

    # mask-sorted contiguous HN groups -> one composite Q per distinct mask
    # (mask 0 = vertex contacts is the identity group)
    hn_bounds, hn_Q = [], []
    uniq, starts = np.unique(bs.hn_masks, return_index=True)
    starts = list(starts) + [len(bs.hn_masks)]
    for i, mv in enumerate(uniq):
        s, e = int(starts[i]), int(starts[i + 1])
        if mv == 0:
            hn_bounds.append((s, e, None))
        else:
            hn_bounds.append((s, e, len(hn_Q)))
            hn_Q.append(hn_composite_matrix(int(mv), si.P, dim))
    meta["hn_bounds"] = hn_bounds
    arrays["hn_Q"] = np.stack(hn_Q) if hn_Q else np.zeros((0, n_loc, n_loc))

    # ---- refill tables (the one-hot EsI / EFX as index maps) -------------
    # The fill writes the closure nodes F of constrained cells; it reads F
    # plus the fold mirror nodes on coarse cells. Positions: the surface
    # nodes first, then the interior nodes X the fill touches.
    hn_brick = hn_sub // C
    hn_slot = hn_sub % C
    F_nodes = np.unique(slot_idx[hn_slot][bs.hn_closure])
    read_nodes = [F_nodes]
    for gl in groups.values():
        for g in gl:
            _, dcol = np.nonzero(g["T"])
            read_nodes.append(np.unique(slot_idx[g["coarse"] % C][:, dcol]))
    fill_nodes = np.unique(np.concatenate(read_nodes))
    X_nodes = np.setdiff1d(fill_nodes, surf_idx)
    n_surfX = n_surf + len(X_nodes)
    pos_of_node = np.full(N3p, -1, dtype=np.int64)
    pos_of_node[surf_idx] = np.arange(n_surf)
    pos_of_node[X_nodes] = n_surf + np.arange(len(X_nodes))
    kpos = pos_of_node[slot_idx.reshape(-1)]  # [C*n_loc] -> pos | -1
    kF = np.zeros(N3p, dtype=bool)
    kF[F_nodes] = True
    efx_src = np.nonzero(kF[slot_idx.reshape(-1)])[0]
    den_X = np.zeros((n_sub, n_surfX + 1))
    wp = pos_of_node[slot_idx[hn_slot]]
    wp = np.where(wp < 0, n_surfX, wp)
    np.add.at(den_X, (hn_brick[:, None], wp), 1.0)
    den_X = den_X[:, :n_surfX]
    arrays.update(
        node_of_pos=np.concatenate([surf_idx, X_nodes]).astype(np.int64),
        efx_src=efx_src.astype(np.int64), efx_pos=kpos[efx_src],
        fill_invden_X=np.where(den_X > 0, 1.0 / np.maximum(den_X, 1.0), 0.0),
    )
    return arrays, meta


# ===========================================================================
def resolve_device(device=None) -> torch.device:
    """The port runs on the card unless the caller asks for another device:
    device=None means CUDA and raises where no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


_INDEX32 = ("face_other", "edge_contrib", "corner_contrib")  # kernel tables


class BrickLaplaceMM(nn.Module):
    """Constrained Cartesian Laplace vmult on [n_bricks, N3p] brick vectors
    (degree >= 4, dim = 3), the port of the reference's ``BrickLaplaceMM``
    at its p >= 4 defaults. Tables are registered buffers on ``device``;
    floating tables are built in float64 on the host and cast to ``dtype``.

    vmult accepts reduced inputs (hanging copies carry no meaning) and
    returns reduced outputs; ``refill`` restores the hanging copies from
    their masters, ``to_dof_vector`` reads a global DoF vector back."""

    def __init__(self, mf: MatrixFree | None, device=None, dtype=None):
        super().__init__()
        self.mf = mf
        self.bs = None
        if mf is None:  # from_tables fills the tables in
            return
        if mf.dim != 3:
            raise NotImplementedError("the port's brick engine supports dim=3")
        if mf.degree < 4:
            raise NotImplementedError(
                "degree <= 3 runs the reference's masked-quadrature / face-plane "
                "schedules, which are not ported yet"
            )
        bs = BrickStructure(mf)
        arrays, meta = operator_tables(mf, bs)
        if dtype is None:
            dtype = {np.dtype(np.float32): torch.float32,
                     np.dtype(np.float64): torch.float64}[mf.dtype]
        self._load(arrays, meta, resolve_device(device), dtype)
        self.bs = bs
        nb = bs.n_bricks
        dm = np.zeros((nb, self.N3p), dtype=bool)
        dm[:, : self.N3] = bs.dot_mask.reshape(nb, self.N3)
        hang = mf.constraints.constrained_dof_marker()
        self.register_buffer("dot_mask_b", torch.from_numpy(dm).to(self.device))
        self.register_buffer("owner", torch.from_numpy(
            bs.owner_node_of_dof.astype(np.int64)).to(self.device))
        self.register_buffer("hanging", torch.from_numpy(hang).to(self.device))

    @classmethod
    def from_tables(cls, arrays: dict, meta: dict, device=None,
                    dtype=torch.float32) -> "BrickLaplaceMM":
        """Operator from host tables alone (``operator_tables`` layout):
        vmult and refill work; the DoF-vector conversions and dot need the
        mesh setup and are absent."""
        op = cls(None)
        op._load(arrays, meta, resolve_device(device), dtype)
        return op

    @property
    def device(self) -> torch.device:
        return self.Kb.device

    @property
    def dtype(self) -> torch.dtype:
        return self.Kb.dtype

    def _load(self, arrays, meta, device, dtype):
        self._meta = meta
        for k in ("B", "p", "NB", "N3", "N3p", "n_sub"):
            setattr(self, k, int(meta[k]))
        self.C = self.B**3
        self.n_loc = (self.p + 1) ** 3
        self.n_bricks = int(arrays["geo"].shape[0])
        for name, a in arrays.items():
            a = np.asarray(a)
            if a.dtype.kind == "f":
                t = torch.from_numpy(a.astype(np.float64)).to(device, dtype)
            elif a.dtype.kind == "b":
                t = torch.from_numpy(a).to(device)
            else:
                t = torch.from_numpy(a.astype(
                    np.int32 if name in _INDEX32 else np.int64)).to(device)
            self.register_buffer(name, t.contiguous())
        self.n_hn = int(arrays["hn_sub"].shape[0])
        if self.n_hn:
            self.register_buffer("geo_hn", self.geo_cell_sub[self.hn_sub])

    # ------------------------------------------------------------ conversions
    def from_dof_vector(self, u) -> torch.Tensor:
        """Global DoF vector (NumPy or tensor) -> [n_bricks, N3p] brick
        vector on the operator's device, hanging entries distributed."""
        if self.bs is None:
            raise RuntimeError("from_dof_vector needs the mesh setup")
        if isinstance(u, torch.Tensor):
            u = u.detach().cpu().numpy()
        bs = self.bs
        u_dist = self.mf.constraints.distribute(np.asarray(u, dtype=np.float64))
        nd = bs.node_dof.reshape(bs.n_bricks, self.N3)
        vals = u_dist[np.maximum(nd, 0)]
        vals[nd < 0] = 0.0
        out = torch.zeros((bs.n_bricks, self.N3p), dtype=self.dtype,
                          device=self.device)
        out[:, : self.N3] = torch.from_numpy(vals).to(self.device, self.dtype)
        return out

    def to_dof_vector(self, bv: torch.Tensor, zero_hanging: bool = False):
        """[n_bricks, N3p] -> global DoF vector (a tensor on the device).
        vmult outputs are reduced, so the hanging copies are refilled first
        unless zero_hanging asks for them to be zero."""
        if self.bs is None:
            raise RuntimeError("to_dof_vector needs the mesh setup")
        if not zero_hanging:
            bv = self.refill(bv)
        u = bv[:, : self.N3].reshape(-1)[self.owner]
        if zero_hanging:
            u = u.masked_fill(self.hanging, 0.0)
        return u

    # ------------------------------------------------ vector space helpers
    def dot_mask(self) -> torch.Tensor:
        """[nb, N3p] weights: 1 at the owner copy of each non-hanging dof."""
        return self.dot_mask_b.to(self.dtype)

    def dot(self, u, v):
        return torch.sum(torch.where(self.dot_mask_b, u * v, 0.0))

    def norm(self, u):
        return torch.sqrt(self.dot(u, u))

    # ------------------------------------------------------------ the chain
    def _cols_rows(self, u_sub, rows):
        """Cell rows [len(rows), n_loc] of the subset bricks (the rows of
        the reference's _extract_cols that the chain reads)."""
        C = self.C
        idx = (rows // C)[:, None] * self.N3p + self.slot_idx[rows % C]
        return u_sub.reshape(-1)[idx]

    def _hn_apply(self, rows, transpose: bool):
        """One composite Q per mask range (identity ranges pass through)."""
        parts = []
        for s, e, qi in self._meta["hn_bounds"]:
            if qi is None:
                parts.append(rows[s:e])
            else:
                Q = self.hn_Q[qi]
                parts.append(rows[s:e] @ (Q.T if transpose else Q))
        return torch.cat(parts, dim=0)

    def _segments(self, sel, direction):
        """Stage-1 transfers: [G, m, n_loc] x [G, n_loc, n_loc] per bucket."""
        outs = []
        for si, off, G, m in self._meta[f"{direction}_segs"]:
            x = sel[off: off + G * m].reshape(G, m, self.n_loc)
            outs.append(torch.bmm(x, getattr(self, f"{direction}_T{si}"))
                        .reshape(G * m, self.n_loc))
        return torch.cat(outs, dim=0)

    @staticmethod
    def _rows_times(x, T):
        return torch.bmm(x[:, None, :], T)[:, 0]

    def _fill_hn_compact(self, u_sub):
        """Compact fill chain (bricks.py:2728-2773): the constrained rows
        with their closure slots zeroed, then the master values folded in
        coarse-first."""
        base = self._cols_rows(u_sub, self.hn_sub) * self.keep_hn
        filled = base
        if self.fill_src.numel():
            sel = self._cols_rows(u_sub, self.fill_src)
            if self.fill_fix_idx.numel():
                sel[self.fill_fix_idx] = base[self.fill_fix_local]
            outs = self._segments(sel, "fill")
            filled = base.index_add(0, self.fill_dst_local,
                                    outs[self.fill_real_pos])
        for ti in range(self._meta["n_fill_tails"]):
            out_t = self._rows_times(filled[getattr(self, f"fill_tail{ti}_src")],
                                     getattr(self, f"fill_tail{ti}_T"))
            filled = filled.index_add(0, getattr(self, f"fill_tail{ti}_dst"), out_t)
        return filled

    def _fill_rows(self, u_sub):
        """Filled constrained rows (bricks.py:2687-2694)."""
        return self._hn_apply(self._fill_hn_compact(u_sub), transpose=False)

    def _corr_compact(self, plain, plain_hn, sub_raw):
        """Compact correction chain + sparse delta (bricks.py:2775-2849):
        dcols = final - plain, nonzero on hole, constrained and fold-target
        rows only."""
        acc = None
        nh_parts = []
        if self.corr_src.numel():
            outs = self._segments(sub_raw[self.corr_src], "corr")
            if self.corr_hn_pos.numel():
                acc = torch.zeros_like(sub_raw).index_add(
                    0, self.corr_hn_dst, outs[self.corr_hn_pos])
            if self.corr_nh_pos.numel():
                nh_parts.append((self.corr_nh_dst, outs[self.corr_nh_pos]))
        for ti in range(self._meta["n_corr_tails"]):
            cur = sub_raw if acc is None else sub_raw + acc
            out_t = self._rows_times(cur[getattr(self, f"corr_tail{ti}_src")],
                                     getattr(self, f"corr_tail{ti}_T"))
            hn_pos = getattr(self, f"corr_tail{ti}_hn_pos")
            if hn_pos.numel():
                acc = (torch.zeros_like(sub_raw) if acc is None else acc).index_add(
                    0, getattr(self, f"corr_tail{ti}_hn_dst"), out_t[hn_pos])
            nh_pos = getattr(self, f"corr_tail{ti}_nh_pos")
            if nh_pos.numel():
                nh_parts.append((getattr(self, f"corr_tail{ti}_nh_dst"),
                                 out_t[nh_pos]))
        final_hn = (sub_raw if acc is None else sub_raw + acc) * self.keep_hn
        dcols = torch.zeros_like(plain)
        if self.absent_sub.numel():
            dcols[self.absent_sub] = -plain[self.absent_sub]
        dcols[self.hn_sub] = final_hn - plain_hn
        for idx, rows in nh_parts:
            dcols.index_add_(0, idx, rows)
        return dcols

    # ---------------------------------------------------------------- vmult
    def _check(self, bv):
        if bv.shape != (self.n_bricks, self.N3p):
            raise ValueError(f"expected a [{self.n_bricks}, {self.N3p}] brick "
                             f"vector, got {tuple(bv.shape)}")
        if bv.dtype != self.dtype or bv.device != self.device:
            raise ValueError(f"expected {self.dtype} on {self.device}, got "
                             f"{bv.dtype} on {bv.device}")

    def vmult(self, bv: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """v = A bv (reference ``_vmult_impl``, non-assembled compact-chain
        input-fill branch, then ``_dss_fill``). plain=True runs every
        kernel's plain PyTorch version on the operator's device instead: the
        reference the card's kernels are held against."""
        self._check(bv)
        if plain:
            ba, ca = brick_apply.brick_apply_plain, cell_apply.cell_apply_plain
            coa = cols_overlap_add.cols_overlap_add_plain
            dss = dss_surface.dss_surface_plain
        else:
            ba, ca = brick_apply.brick_apply, cell_apply.cell_apply
            coa, dss = cols_overlap_add.cols_overlap_add, dss_surface.dss_surface
        v = ba(bv, self.Kb, self.Mb, self.geo, self.p)
        if self.n_sub:
            u_sub = bv[: self.n_sub]
            plain_rows = ca(u_sub, self.K, self.geo_cell_sub, brick_size=self.B)
            if self.n_hn:
                plain_hn = plain_rows[self.hn_sub]
                own = ca(self._fill_rows(u_sub), self.K, self.geo_hn)
                sub_raw = self._hn_apply(own, transpose=True)
                dcols = self._corr_compact(plain_rows, plain_hn, sub_raw)
            else:
                dcols = torch.zeros_like(plain_rows)
                dcols[self.absent_sub] = -plain_rows[self.absent_sub]
            coa(v[: self.n_sub], dcols, brick_size=self.B)
        return dss(v, self.face_other, self.edge_contrib, self.corner_contrib,
                   self.node_valid, self.NB)

    def refill(self, v: torch.Tensor) -> torch.Tensor:
        """Restore the hanging copies of a brick vector whose conforming
        copies agree (reference ``_refill_impl``, input-fill branch): the
        fill chain on the constrained rows, then the coverage-divided
        closure-slot updates written back at their brick nodes."""
        self._check(v)
        if not (self.n_sub and self.n_hn):
            return v
        n_sub, C, n_loc = self.n_sub, self.C, self.n_loc
        v_sub = v[:n_sub]
        diff = self._fill_rows(v_sub) - self._cols_rows(v_sub, self.hn_sub)
        dcols = torch.zeros((n_sub * C, n_loc), dtype=v.dtype, device=v.device)
        dcols[self.hn_sub] = diff
        dflat = dcols.reshape(n_sub, C * n_loc)
        add = torch.zeros_like(self.fill_invden_X).index_add_(
            1, self.efx_pos, dflat[:, self.efx_src]) * self.fill_invden_X
        out = v.clone()
        out[:n_sub].index_add_(1, self.node_of_pos, add)
        return torch.where(self.node_valid, out, 0.0)
