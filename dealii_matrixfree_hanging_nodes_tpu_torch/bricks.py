"""Brick engine of the PyTorch port: the constrained Cartesian Laplace vmult
on per-brick node arrays, held against ``dealii_matrixfree_hanging_nodes_tpu
.bricks.BrickLaplaceMM`` at its defaults (compact fold chains, input-side
hanging-node fill, pooled cross-brick summation; at degree <= 3 the masked
removal, at degree <= 2 face planes).

Layout (as in the reference, so vectors compare one to one): cells are
grouped into Morton-aligned, level-uniform bricks of B^3 cells; a brick
stores the NB^3 (NB = B*p+1) nodes of its cell block, padded to N3p, as one
row of a [n_bricks, N3p] tensor. Bricks holding holes or constrained cells
(the "subset") come first, so every subset access is a leading slice.

vmult = on the subset: cell_apply (cells read from the bricks, times K by
        sum factorization of its 1-D factors K1, M1), hn_cell (the
        constrained rows: fill, Q, K, Q^T in one launch), then corr_compact
        (the fold and the sparse delta of every subset cell row)
      -> brick_apply (separable operator x geo, every brick; its epilogue
        sums the subset's deltas back into their bricks)
      -> dss_surface (in place: sum each shared face/edge/corner over its
        pool, zero the hole nodes): 5 launches (degree >= 4).
vmult at degree <= 3 (the reference's assembled schedule) = plane_fill
        (p <= 2: the face planes' hanging nodes filled into a new vector),
        hn_cell and corr_compact on the chain bricks (no plain rows),
        brick_apply with the folded rows in its epilogue, masked_quad (in
        place: the absent and constrained cells' unconstrained
        contributions removed), plane_fold (p <= 2, in place, 2 launches),
        dss_surface: 5 launches at p = 3, 8 at p <= 2.
vmult_plain (no constraints; the HN overhead's denominator) = brick_apply
        and the absent cells' removal (masked_quad at p <= 3; cell_apply
        and corr_compact's absent rows into brick_apply's epilogue at
        p >= 4), then dss_surface.
refill = [plane_fill,] hn_cell in its fill mode (fill and Q),
        refill_update (the coverage-divided write-back): 2 launches (3
        with face planes).

The reference expresses the data movement with one-hot matmuls because the
TPU gathers slowly; here every one-hot operator is an index map (``slot_idx``
for E, the surface node list for Es, X-node / position maps for EsI, EscX
and EFX; ``kernel_tables`` turns the transfer stacks and composite Q's into
gather lists), and every device step is a hand-written CUDA kernel
(``kernels/``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from .constraints import _active_lookup, decompress_mask
from .dof_handler import local_lattice
from .elements import lagrange_values, shape_info
from .kernels import (
    brick_apply,
    cell_apply,
    corr_compact,
    dss_surface,
    hn_cell,
    masked_quad,
    plane_fill,
    plane_fold,
    refill_update,
)
from .kernels.dss_surface import surface_nodes
from .matrix_free import MatrixFree, resolve_device
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
    (the reference's ``BrickStructure``, with face planes at degree <= 2 as
    the reference operator's defaults build it)."""

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

        # face planes, built before the tier sort so that plane-covered
        # cells leave the chain tier and the per-cell tables; their brick ids
        # are remapped through the reorder below
        self.plane_covered = np.zeros(tria.n_active_cells, dtype=bool)
        self.plane_groups = []
        self.plane_P1 = None
        if p <= 2 and B % 2 == 0:
            self._build_face_planes(masks, brick_of_cell)

        # ---- subset-first brick order -------------------------------------
        # Exceptional bricks (holes, constrained cells, or fold/fill coarse
        # targets) are renumbered to the front, so every subset access is a
        # leading slice. Chain bricks (touched by any constraint/fill/fold
        # index) form the first tier, hole-only bricks the second.
        C = B**dim
        ci = mf.constraints
        chain = np.zeros(self.n_bricks, dtype=bool)
        resid = (masks != 0) & ~self.plane_covered
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
        for g in self.plane_groups:
            g["fine"], g["coarse"] = rank[g["fine"]], rank[g["coarse"]]

        self.brick_of_cell = brick_of_cell
        self.cell_lin = brick_of_cell * (B**dim) + slot  # brick-cell linear id
        self.present = np.zeros(self.n_bricks * C, dtype=bool)
        self.present[self.cell_lin] = True

        # transfer-active subset: constrained cells + vertex-contact cells,
        # stable-sorted by mask so each distinct mask forms one contiguous
        # range (one composite [n_loc, n_loc] matmul per range)
        xfer_sel = resid | self.vertex_contact
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

    # ----------------------------------------------------------- face planes
    def _build_face_planes(self, masks, brick_of_cell):
        """The reference's ``_build_face_planes`` (bricks.py:499-659): the
        aligned cross-level interface pairs (a fine brick's face against a
        quarter of the one-level-coarser neighbor brick's face) and the
        cells they resolve. A constrained cell is plane-covered when its
        mask has face bits only, each constrained face lies on its brick's
        boundary against an aligned brick one level coarser, and each
        face's master cell is unconstrained or itself plane-covered (levels
        ascending, so masters resolve first). Groups are keyed (fine level,
        axis d, side s, coarse plane c_pl, tangential quarter offsets), in
        sorted key order; each holds its (fine, coarse) brick pairs and a
        cover mask [pairs, NB, NB] over the fine face (axes: the higher
        tangential axis, then the lower), made disjoint across groups per
        fine brick node. plane_P1 [NB, Nh] interpolates a fine face line
        from the covering coarse cells' nodes (Nh = (NB-1)/2 + 1)."""
        mf, tria = self.mf, self.mf.tria
        dim, p, B, NB = self.dim, self.p, self.B, self.NB
        ci = mf.constraints
        lvl, coord = tria.level, tria.coord
        sub_a, face_a, edge_a = decompress_mask(masks, dim)
        pure = (masks != 0) & (edge_a == 0)
        props = {}  # (level, d, s, c_pl, *offs) -> {(fine, coarse): [cells]}
        for lv in (np.unique(lvl[pure]) if pure.any() else []):
            cand = np.nonzero(pure & (lvl == lv))[0]
            accepted = []
            for c in cand:
                entry = []
                for d in range(dim):
                    if not (int(face_a[c]) >> d) & 1:
                        continue
                    s = (int(sub_a[c]) >> d) & 1
                    if int(coord[c, d]) & (B - 1) != (0 if s == 0 else B - 1):
                        break
                    m = int(ci.face_neighbor[c, d])
                    if m < 0 or lvl[m] != lv - 1 or (masks[m] != 0 and not self.plane_covered[m]):
                        break
                    F, Cb = int(brick_of_cell[c]), int(brick_of_cell[m])
                    if self.brick_level[Cb] != lv - 1:
                        break
                    # the masters' face toward the fine side, possibly inside Cb
                    c_pl = (int(coord[m, d]) & (B - 1)) * p + (0 if s == 1 else p)
                    offs = [int(self.brick_coord[F][t]) * (B // 2) - int(self.brick_coord[Cb][t]) * B
                            for t in range(dim) if t != d]
                    if any(o not in (0, B // 2) for o in offs):
                        break
                    entry.append((d, s, F, Cb, c_pl, tuple(int(o != 0) for o in offs)))
                else:
                    if entry:
                        accepted.append((c, entry))
            # a level's cells are accepted together, after all of them were tested
            for c, entry in accepted:
                self.plane_covered[c] = True
                for d, s, F, Cb, c_pl, offs in entry:
                    props.setdefault((int(lv), d, s, c_pl) + offs, {}).setdefault(
                        (F, Cb), []).append(c)
        for key in sorted(props):
            lv, d, s, c_pl = key[:4]
            pairs = props[key]
            tang = [t for t in range(dim) if t != d]
            cover = np.zeros((len(pairs), NB, NB))
            for pi, cells in enumerate(pairs.values()):
                for c in cells:
                    hi, lo = (int(coord[c, t]) & (B - 1) for t in reversed(tang))
                    cover[pi, hi * p: hi * p + p + 1, lo * p: lo * p + p + 1] = 1.0
            self.plane_groups.append(dict(
                level=lv, d=d, s=s, c_pl=c_pl, offs=key[4:],
                fine=np.array([f for f, _ in pairs], dtype=np.int64),
                coarse=np.array([cb for _, cb in pairs], dtype=np.int64), cover=cover))
        # each fine brick node is claimed by the first group that covers it
        claimed = {}
        for g in self.plane_groups:
            d, s = g["d"], g["s"]
            t_hi, t_lo = sorted((t for t in range(dim) if t != d), reverse=True)
            hi, lo = np.meshgrid(np.arange(NB), np.arange(NB), indexing="ij")
            plane_idx = ((NB - 1 if s else 0) * NB**d + hi * NB**t_hi + lo * NB**t_lo).ravel()
            for pi, f in enumerate(g["fine"]):
                cl = claimed.setdefault(int(f), np.zeros(NB**dim, dtype=bool))
                eff = (g["cover"][pi].ravel() > 0) & ~cl[plane_idx]
                cl[plane_idx[eff]] = True
                g["cover"][pi] = eff.reshape(NB, NB).astype(np.float64)
        # interpolation from the covering coarse cell's nodal basis
        nodes1 = shape_info(p).nodes
        Nh = (NB - 1) // 2 + 1
        P1 = np.zeros((NB, Nh))
        for i in range(NB):
            xf = (i // p + nodes1[i % p]) / B if i < NB - 1 else 1.0
            k = max(min(int(np.floor(xf * (B // 2) - 1e-12)), B // 2 - 1), 0)
            P1[i, k * p: k * p + p + 1] = lagrange_values(nodes1, np.array([xf * (B // 2) - k]))[0]
        self.plane_P1 = P1

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
        hn_cells = np.nonzero((masks != 0) & ~self.plane_covered)[0]
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
    """Host tables of the constrained Cartesian vmult, as index maps.

    Returns (arrays, meta): ``arrays`` maps buffer names to float64 / int64 /
    int32 / bool NumPy arrays (``BrickLaplaceMM`` buffer names), ``meta``
    holds the static sizes and schedules. The reference builds the same
    tables in ``BrickLaplaceMM.__init__`` (bricks.py:1186-1917) with one-hot
    matrices where these hold indices; ``convert.from_reference`` derives
    this dict from those. The degree <= 3 schedule's tables (Sqb, Dqb, w1,
    the cell selectors qmask_*, the face-plane groups) are the reference's
    as they are; ``kernel_tables`` turns them into lists."""
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
    K = kronecker_sum(K1, M1)

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
                n_chainb=bs.n_chain_bricks, assembled=p <= 3,
                hn_bounds=[],
                fill_segs=[], n_fill_tails=0, corr_segs=[], n_corr_tails=0,
                plane_meta=[], plane_levels=[])

    # the degree <= 3 schedule (the reference's defaults, bricks.py:1149-
    # 1182): the absent and constrained cells' unconstrained contributions
    # come off in one masked quadrature apply (Sqb, Dqb, w1 and the cell
    # selectors, geo-premultiplied; bricks.py:1846-1864, 1897-1917), and at
    # degree <= 2 the face planes fill and fold first and last
    nq1 = si.S.shape[0]
    Sqb = np.zeros((B * nq1, NB))
    Dqb = np.zeros((B * nq1, B * nq1))
    for c in range(B):
        Sqb[c * nq1: (c + 1) * nq1, c * p: c * p + n] = si.S
        Dqb[c * nq1: (c + 1) * nq1, c * nq1: (c + 1) * nq1] = si.Dc
    arrays.update(Sqb=Sqb, Dqb=Dqb, w1=np.asarray(si.quad_w, dtype=np.float64))
    if n_sub:
        absent2 = ~bs.present.reshape(bs.n_bricks, C)[:n_sub]
        hn2 = np.zeros(n_sub * C, dtype=bool)
        hn2[hn_sub] = True
        arrays.update(qmask_absent=absent2 * geo_brick[:n_sub, None],
                      qmask_rem=(absent2 | hn2.reshape(n_sub, C)) * geo_brick[:n_sub, None])
    if bs.plane_groups:
        W = np.unique(np.concatenate([g[k] for g in bs.plane_groups for k in ("fine", "coarse")]))
        w_of = np.full(bs.n_bricks, -1, dtype=np.int64)
        w_of[W] = np.arange(len(W))
        arrays.update(plane_W=W, plane_P1=bs.plane_P1)
        for i, g in enumerate(bs.plane_groups):
            arrays.update({f"plane{i}_fine": w_of[g["fine"]], f"plane{i}_coarse": w_of[g["coarse"]],
                           f"plane{i}_cover": g["cover"]})
        meta["plane_meta"] = [dict(level=g["level"], d=g["d"], s=g["s"], c_pl=g["c_pl"],
                                   offs=g["offs"], n=len(g["fine"])) for g in bs.plane_groups]
        meta["plane_levels"] = sorted({g["level"] for g in bs.plane_groups})
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
# The kernels' index form of the chain tables
def _transfer_pairs(T):
    """(read slot a, written slot b) of every 1 in a transfer matrix T
    (rows @ T copies rows[:, a] to out[:, b]); raises unless T is a 0/1
    partial permutation."""
    T = np.asarray(T)
    a, b = np.nonzero(T)
    if not (np.all(T[a, b] == 1.0) and len(np.unique(a)) == len(a)
            and len(np.unique(b)) == len(b)):
        raise ValueError("a fold/fill transfer matrix is not a 0/1 partial permutation")
    return a, b


def _sparse(rows, cols, shape, vals=None):
    vals = np.ones(len(rows)) if vals is None else vals
    return sp.csr_matrix((vals, (rows, cols)), shape=shape)


def _stage1_entries(arrays, meta, direction):
    """(padded position k, read slot a, written slot b) of every slot copy
    of the stage-1 transfers (the 1s of the [G, n_loc, n_loc] stacks)."""
    ks, As, Bs = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for si, off, G, m in meta[f"{direction}_segs"]:
        for g, T in enumerate(arrays[f"{direction}_T{si}"]):
            a, b = _transfer_pairs(T)
            ks.append(np.repeat(off + g * m + np.arange(m), len(a)))
            As.append(np.tile(a, m))
            Bs.append(np.tile(b, m))
    return np.concatenate(ks), np.concatenate(As), np.concatenate(Bs)


def _tail_entries(arrays, ti, direction, sel=None):
    """(pair index, read slot a, written slot b) of tail stage ti."""
    Ts = arrays[f"{direction}_tail{ti}_T"]
    idx = np.arange(len(Ts)) if sel is None else np.asarray(sel)
    ks, As, Bs = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for i in idx:
        a, b = _transfer_pairs(Ts[i])
        ks.append(np.full(len(a), i))
        As.append(a)
        Bs.append(b)
    return np.concatenate(ks), np.concatenate(As), np.concatenate(Bs)


def _gather_lists(M, n_rows, n_loc, what):
    """By-destination gather lists of a 0/1 map M [n_rows*n_loc, *] whose
    rows are (row, slot) pairs: row_ptr [n_rows+1] into entries sorted by
    (row, slot, source), each entry's slot and source, all int32."""
    M = M.tocsr()
    M.eliminate_zeros()
    M.sort_indices()
    if not np.all(M.data == 1.0):
        raise ValueError(f"{what}: a slot receives one source more than once")
    if M.shape[1] > np.iinfo(np.int32).max:
        raise NotImplementedError(f"{what}: sources exceed int32")
    dst = np.repeat(np.arange(M.shape[0]), np.diff(M.indptr))
    return dict(row_ptr=M.indptr[np.arange(n_rows + 1) * n_loc].astype(np.int32),
                ent_slot=(dst % n_loc).astype(np.int32),
                ent_src=M.indices.astype(np.int32))


def _runs(row_ptr, ent_slot, ent_src, n_loc):
    """corr_compact's form of by-destination gather lists: the entries as
    runs that land on one (row, slot), seg_ptr [n_seg+1] into ent_src and
    seg_dst = row * n_loc + slot ascending, and the block schedule over the
    rows (``corr_compact.schedule``). Raises unless the entries are sorted
    by destination, so that each (row, slot) is one run."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    n_rows = len(row_ptr) - 1
    if n_rows * n_loc > np.iinfo(np.int32).max:
        raise NotImplementedError("corr: dcols slots exceed int32")
    dst = np.repeat(np.arange(n_rows), np.diff(row_ptr)) * n_loc + np.asarray(ent_slot)
    first = np.ones(len(dst), dtype=bool)
    first[1:] = dst[1:] != dst[:-1]
    seg_ptr = np.append(np.nonzero(first)[0], len(dst))
    seg_dst = dst[first]
    if (np.diff(seg_dst) <= 0).any():
        raise ValueError("corr: the fold entries are not sorted into runs by destination")
    blocks = corr_compact.schedule(np.bincount(seg_dst // n_loc, minlength=n_rows), n_loc)
    return dict(seg_ptr=seg_ptr.astype(np.int32), seg_dst=seg_dst.astype(np.int32),
                ent_src=np.asarray(ent_src, dtype=np.int32), blocks=blocks)


def _refill_tables(refill_pos, slot_idx, invden_X, node_valid):
    """refill_update's tables: the nodes the fill writes (refill_pos >= 0),
    ascending; for each, the cells of a brick that hold it as slot << 16 | j
    in ascending slot order, -1 padded to 8; the coverage divisor at each
    written node, [n_sub, n_w]; node_valid at one bit a node. Checked as
    built: every (slot, j) whose node is written is listed once, under that
    node."""
    C, n_loc = slot_idx.shape
    nodes = np.nonzero(refill_pos >= 0)[0]
    w_of_node = np.full(len(refill_pos), -1, dtype=np.int64)
    w_of_node[nodes] = np.arange(len(nodes))
    w_of = w_of_node[slot_idx.reshape(-1)]  # per (slot, j), slot-major
    held = np.nonzero(w_of >= 0)[0]
    w = w_of[held]
    counts = np.bincount(w, minlength=len(nodes))
    if len(nodes) and (counts.min() < 1 or counts.max() > refill_update.MAX_HOLDERS):
        raise ValueError("refill: a written node is held by no cell or by more than 8")
    order = np.argsort(w, kind="stable")  # by node; slots stay ascending within
    rank = np.arange(len(held)) - np.repeat(np.cumsum(counts) - counts, counts)
    holders = np.full((len(nodes), refill_update.MAX_HOLDERS), -1, dtype=np.int64)
    holders[w[order], rank] = (held[order] // n_loc) << 16 | held[order] % n_loc
    real = holders >= 0
    slot, j = holders >> 16, holders & 0xFFFF
    if (not np.array_equal(slot_idx[slot[real], j[real]], nodes[np.nonzero(real)[0]])
            or (np.diff(np.where(real, slot, C), axis=1) <= 0)[real[:, 1:]].any()):
        raise ValueError("refill: the holder lists do not match the cells' nodes")
    return dict(refill_valid_bits=_pack_bits(node_valid),
                refill_nodes=nodes.astype(np.int32), refill_holders=holders.astype(np.int32),
                refill_invden=np.asarray(invden_X)[:, refill_pos[nodes]])


def _corr_lists(arrays, meta, hn_dst, keep, cell_code, nF, nR):
    """Gather lists of the composed fold: dcols rows (subset cell rows) by
    slot over the nF slots of sub_raw. hn_dst: the dcols slot of each
    sub_raw slot. cur = (I + A) sub_raw on the constrained rows, N sub_raw
    on the others; each tail reads cur before this stage's updates."""
    n_loc = keep.shape[1]
    A = _sparse([], [], (nF, nF))
    N = _sparse([], [], (nR, nF))
    if nF and len(arrays["corr_src"]):
        k, a, b = _stage1_entries(arrays, meta, "corr")
        src = np.asarray(arrays["corr_src"])[k] * n_loc + a
        for pos, dsts in (("corr_hn_pos", "corr_hn_dst"), ("corr_nh_pos", "corr_nh_dst")):
            which = np.full(len(arrays["corr_src"]), -1)
            which[arrays[pos]] = np.asarray(arrays[dsts])
            s = which[k] >= 0
            if pos == "corr_hn_pos":
                A = A + _sparse(which[k[s]] * n_loc + b[s], src[s], (nF, nF))
            else:
                N = N + _sparse(which[k[s]] * n_loc + b[s], src[s], (nR, nF))
    for ti in range(meta["n_corr_tails"]):
        cur = sp.identity(nF, format="csr") + A
        tsrc = np.asarray(arrays[f"corr_tail{ti}_src"])
        upd = {}
        for pos, dsts, rows in (("hn_pos", "hn_dst", nF), ("nh_pos", "nh_dst", nR)):
            kk, a, b = _tail_entries(arrays, ti, "corr", arrays[f"corr_tail{ti}_{pos}"])
            dmap = np.full(len(tsrc), -1)
            dmap[arrays[f"corr_tail{ti}_{pos}"]] = arrays[f"corr_tail{ti}_{dsts}"]
            upd[pos] = _sparse(dmap[kk] * n_loc + b, tsrc[kk] * n_loc + a, (rows, nF)) @ cur
        A, N = A + upd["hn_pos"], N + upd["nh_pos"]
    if (cell_code[np.unique(N.tocoo().row // n_loc)] != -1).any():
        raise ValueError("a fold lands on a constrained or absent row outside the hn set")
    kept = _sparse(hn_dst, np.arange(nF), (nR, nF), keep.reshape(-1).astype(np.float64))
    return _gather_lists(kept @ A + N, nR // n_loc, n_loc, "corr")


def kronecker_sum(K1, M1):
    """K1⊗M1⊗M1 + M1⊗K1⊗M1 + M1⊗M1⊗K1 on x-fastest local nodes (the
    axis-d term has K1 on axis d, operator_tables' K)."""
    K = 0.0
    for d in range(3):
        f = [K1 if t == d else M1 for t in range(3)]
        K = K + np.kron(np.kron(f[2], f[1]), f[0])
    return K


def _cell_factors(Kb, Mb, K, p):
    """The cell's 1-D stiffness and mass K1, M1 [p+1, p+1] from the brick
    factors Kb, Mb [NB, NB]: the first cell block, whose [p, p] entry also
    holds the next cell's [0, 0], takes [p, p] from the last cell's corner.
    Raises unless their Kronecker sum is the dense K to 1e-13."""
    n, L = p + 1, Kb.shape[0] - 1
    fac = {}
    for name, A in (("K1", Kb), ("M1", Mb)):
        f = np.array(A[:n, :n], dtype=np.float64)
        f[p, p] = A[L, L]
        fac[name] = f
    err = np.abs(kronecker_sum(fac["K1"], fac["M1"]) - K).max()
    if not err <= 1e-13 * np.abs(K).max():
        raise ValueError(f"the Kronecker sum of K1 and M1 is not K (max error {err:.3e})")
    return fac


def _brick_factors(Kb, Mb, p):
    """brick_apply's factors: the structural nonzeros of Kb and Mb, packed
    row by row (``brick_apply.factor_structure``). Raises unless they
    rebuild Kb and Mb exactly."""
    rows, cols = brick_apply.factor_structure(Kb.shape[0], p)
    out = {}
    for name, A in (("Kb", Kb), ("Mb", Mb)):
        rebuilt = np.zeros_like(A)
        rebuilt[rows, cols] = A[rows, cols]
        if not np.array_equal(rebuilt, A):
            raise ValueError(f"{name} has nonzeros outside the structure of its cell blocks")
        out[f"{name}_packed"] = A[rows, cols]
    return out


def _pack_bits(mask):
    """[rows, n] bool -> [rows, ceil(n/32)] int32 words, bit k of a row in
    word k // 32 at position k % 32."""
    rows, n = mask.shape
    pad = np.zeros((rows, -(-n // 32) * 32), dtype=bool)
    pad[:, :n] = mask
    return np.packbits(pad, axis=1, bitorder="little").view("<u4").view(np.int32)


def _pool_lists(contrib, n_copies, what):
    """One row per pool from a contributor table (row r: the flat copies of
    r's pool in canonical order, sentinel-padded): the row of each pool's
    first copy, -1 padded. Raises unless every row is its pool's list and
    every copy lies in exactly one pool."""
    rows = np.asarray(contrib, dtype=np.int64).copy()
    rows[rows >= n_copies] = -1
    lists = rows[rows[:, 0] == np.arange(n_copies)]
    entry = np.full(n_copies, -1)
    for c in range(lists.shape[1]):
        real = lists[:, c] >= 0
        if (entry[lists[real, c]] >= 0).any():
            raise ValueError(f"dss: a {what} copy lies in two pools")
        entry[lists[real, c]] = np.nonzero(real)[0]
    if (entry < 0).any() or not np.array_equal(rows, lists[entry]):
        raise ValueError(f"dss: the {what} contributor lists do not partition the copies")
    return lists


def _dss_work_lists(face_other, edge_contrib, corner_contrib, node_valid, NB):
    """The dss_surface kernel's tables: face pairs (a lone face has -1 as
    its partner), edge pools and corner pools, each a list of flat copies
    in pool-canonical order; the validity of every surface copy at one bit
    per surface position (``surface_nodes`` order); and the invalid nodes
    off the surface, as the bricks that hold any with one bit per brick node
    (fewer bytes than a list of node indices: holes come a few thousand to
    a hole brick). The padding N3..N3p is zeroed without a table. Checked
    as built: every surface copy of every brick lies in exactly one pool
    entry."""
    nb, N3p = node_valid.shape
    N3 = NB**3
    if nb * N3p > np.iinfo(np.int32).max:
        raise NotImplementedError("brick nodes exceed int32")
    if node_valid[:, N3:].any():
        raise ValueError("dss: a padding node is marked valid")
    r = np.arange(nb * 6)
    fo = np.asarray(face_other, dtype=np.int64)
    other = fo[:, 0].copy() if fo.shape[1] else np.full(nb * 6, nb * 6)
    other[other >= nb * 6] = -1
    paired = other >= 0
    if (other[other[paired]] != r[paired]).any() or (
            (other[paired] % 6) != ((r[paired] % 6) ^ 1)).any():
        raise ValueError("dss: face partners must be mutual, on opposite sides of one axis")
    first = ~paired | (r < other)
    face_pairs = np.stack([r[first], other[first]], axis=1)
    lists = {"face": face_pairs,
             "edge": _pool_lists(edge_contrib, nb * 12, "edge"),
             "corner": _pool_lists(corner_contrib, nb * 8, "corner")}
    if not np.array_equal(np.bincount(face_pairs[face_pairs >= 0], minlength=nb * 6),
                          np.ones(nb * 6, dtype=np.int64)):
        raise ValueError("dss: a face copy lies in no pair or in two")
    surf = surface_nodes(NB)
    hole = ~node_valid[:, :N3]
    hole[:, surf] = False
    hole_bricks = np.nonzero(hole.any(axis=1))[0]
    return dict(dss_face_pairs=lists["face"].astype(np.int32),
                dss_edge_pools=lists["edge"].astype(np.int32),
                dss_corner_pools=lists["corner"].astype(np.int32),
                dss_valid_bits=_pack_bits(node_valid[:, surf]),
                dss_hole_bricks=hole_bricks.astype(np.int32),
                dss_hole_bits=_pack_bits(hole[hole_bricks]))


def _quadrature_check(arrays, K1, M1, p):
    """Raise unless the reference's block quadrature operators (Sqb values,
    Dqb collocation derivatives, w1 weights) integrate the cell's 1-D mass
    and stiffness to M1 and K1 (1e-13): the masked removal's cell stiffness
    is the one the reference's quadrature sweeps apply."""
    nq1 = len(arrays["w1"])
    S = np.asarray(arrays["Sqb"], dtype=np.float64)[:nq1, : p + 1]
    G = np.asarray(arrays["Dqb"], dtype=np.float64)[:nq1, :nq1] @ S
    w = np.asarray(arrays["w1"], dtype=np.float64)
    for name, got, ref in (("M1", S.T @ (w[:, None] * S), M1), ("K1", G.T @ (w[:, None] * G), K1)):
        if not np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max():
            raise ValueError(f"the block quadrature does not integrate {name}")


def _masked_lists(qmask, geo, B):
    """masked_quad's tables from a cell selector qmask [n_sub, B^3] (the
    brick's geo on the selected cells, 0 elsewhere): the bricks that hold a
    selected cell, and for each its selected slots in 8 parity classes
    (class = x%2 + 2 (y%2) + 4 (z%2) of the cell's place in the brick: no
    two cells of a class share a node), class by class, ascending within;
    ptr [n_blk, 9] gives each class's range. Raises unless every selected
    value is its brick's geo."""
    qm = np.asarray(qmask, dtype=np.float64)
    b, s = np.nonzero(qm)
    if not np.array_equal(qm[b, s], np.asarray(geo, dtype=np.float64)[b]):
        raise ValueError("masked removal: a selected cell's weight is not its brick's geo")
    color = s % 2 + 2 * ((s // B) % 2) + 4 * ((s // (B * B)) % 2)
    order = np.lexsort((s, color, b))
    b, s, color = b[order], s[order], color[order]
    bricks = np.unique(b)
    key = np.searchsorted(bricks, b) * 8 + color
    ptr = np.searchsorted(key, np.arange(len(bricks))[:, None] * 8 + np.arange(9))
    return dict(brick=bricks.astype(np.int32), ptr=ptr.astype(np.int32),
                slot=s.astype(np.int32))


def _plane_tables(arrays, meta, n_bricks):
    """plane_fill's and plane_fold's tables: the face-plane fill of every
    level (fine covered node <- P1 (coarse quarter face) P1^T, bricks.py:
    3044-3102) composed on the host into one linear map from the nodes no
    level writes, so that the levels need no order on the card. The fill
    writes the covered nodes ``plane_cov`` (flat brick*N3p + node,
    ascending; ``plane_cov_ptr`` [nb+1] by brick), each the sum over its
    entries (fill_ptr, fill_src flat, fill_w). The fold (bricks.py:3104-
    3167) is its transpose: each target node (fold_tgt, never covered) adds
    its entries over the covered nodes (fold_ptr, fold_src flat, fold_w) in
    ascending order, then the covered nodes are zeroed."""
    NB, N3p = int(meta["NB"]), int(meta["N3p"])
    W = np.asarray(arrays["plane_W"], dtype=np.int64)
    P1 = np.asarray(arrays["plane_P1"], dtype=np.float64)
    Half = (NB - 1) // 2
    rows, cols, vals = [], [], []
    for i, m in enumerate(meta["plane_meta"]):
        d, s, c_pl, offs = m["d"], m["s"], m["c_pl"], m["offs"]
        t_hi, t_lo = sorted((t for t in range(3) if t != d), reverse=True)
        fine = W[np.asarray(arrays[f"plane{i}_fine"], dtype=np.int64)]
        coarse = W[np.asarray(arrays[f"plane{i}_coarse"], dtype=np.int64)]
        pi, ii, jj = np.nonzero(np.asarray(arrays[f"plane{i}_cover"]) > 0)
        wt = P1[ii][:, :, None] * P1[jj][:, None, :]
        k, I, J = np.nonzero(wt)
        rows.append(fine[pi[k]] * N3p + (NB - 1 if s else 0) * NB**d + ii[k] * NB**t_hi
                    + jj[k] * NB**t_lo)
        cols.append(coarse[pi[k]] * N3p + c_pl * NB**d + (offs[1] * Half + I) * NB**t_hi
                    + (offs[0] * Half + J) * NB**t_lo)
        vals.append(wt[k, I, J])
    rows, cols, vals = (np.concatenate(x) for x in (rows, cols, vals))
    if n_bricks * N3p > np.iinfo(np.int32).max:
        raise NotImplementedError("plane tables: brick nodes exceed int32")
    nodes = np.unique(np.concatenate([rows, cols]))
    n = len(nodes)
    A = _sparse(np.searchsorted(nodes, rows), np.searchsorted(nodes, cols), (n, n), vals)
    if A.nnz != len(vals):
        raise ValueError("plane tables: a covered node is written by two groups")
    cov = np.zeros(n, dtype=bool)
    cov[np.searchsorted(nodes, np.unique(rows))] = True
    Du, Dc = sp.diags(1.0 * ~cov), sp.diags(1.0 * cov)
    X = A @ Du
    for _ in range(len(meta["plane_levels"])):  # a chain of k levels composes in k steps
        X = (A @ Du + A @ Dc @ X).tocsr()
    X.eliminate_zeros()
    if (X @ Dc).nnz:
        raise ValueError("plane tables: the level chain does not compose")
    fill = X[cov].tocsr()
    fill.sort_indices()
    fold = fill.T.tocsr()
    fold.sort_indices()
    tgt = np.nonzero(np.diff(fold.indptr))[0]
    cov_flat = nodes[cov]
    i32 = lambda x: np.asarray(x).astype(np.int32)
    return dict(
        plane_cov=i32(cov_flat),
        plane_cov_ptr=i32(np.searchsorted(cov_flat // N3p, np.arange(n_bricks + 1))),
        plane_fill_ptr=i32(fill.indptr), plane_fill_src=i32(nodes[fill.indices]),
        plane_fill_w=fill.data,
        plane_fold_tgt=i32(nodes[tgt]), plane_fold_ptr=i32(np.append(fold.indptr[tgt], fold.nnz)),
        plane_fold_src=i32(cov_flat[fold.indices]), plane_fold_w=fold.data)


def kernel_tables(arrays: dict, meta: dict) -> dict:
    """The tables the six kernels read, derived on the host from the
    reference-layout tables of ``operator_tables`` (or
    ``convert.reference_tables``): the dense one-hot stacks T and the
    composite Q become index lists, checked as they are built.

    - fill: the compact fill chain (stage 1 and its tails, bricks.py:
      2728-2773) is linear in the subset bricks and every transfer is a 0/1
      partial permutation, so the stages compose on the host into one
      gather list per (constrained row, slot): its own node when the keep
      mask holds it, plus the master nodes that the chain copies into it. A
      source that is itself a constrained row reads its masked base
      (``fill_fix_idx``); the tails read the rows after stage 1. hn_cell
      reads these lists (its fill).
    - corr: the compact fold (bricks.py:2775-2849) likewise composes into
      one gather list per (subset cell row, slot) over the slots of
      ``sub_raw``: the tails read ``sub_raw + acc`` before the keep mask,
      and a constrained row keeps only the slots its keep mask holds. The
      list is handed to corr_compact as runs of entries that land on one
      (row, slot), with a block schedule that spreads the heavy fold rows
      (``_runs``). ``cell_code`` tells each subset cell row's kind: its
      constrained row (>= 0), -1 (none), -2 (absent cell).
    - hn: the nonzeros of each composite Q by output slot, for u @ Q
      (fwd) and u @ Q^T (bwd), and each constrained row's Q (-1: identity):
      hn_cell's Q and Q^T.
    - refill: the brick nodes the fill writes, the cells of a brick that
      hold each, ``fill_invden_X`` at those nodes and node_valid as bits
      (``_refill_tables``).
    - cell: the 1-D factors K1 and M1 of the cell stiffness, read off the
      assembled brick factors (``_cell_factors``): cell_apply's and
      hn_cell's sweeps.
    - brick: the structural nonzeros of Kb and Mb, packed row by row for
      brick_apply (``_brick_factors``).
    - dss: the interface pools as work lists with the surface validity and
      the holes as bit tables (``_dss_work_lists``).
    - the degree <= 3 schedule (meta["assembled"]): the fold over the
      chain bricks' cell rows only; masked_quad's cell lists from the
      selectors qmask_rem and qmask_absent (``_masked_lists``), once the
      block quadrature is checked to integrate K1 and M1; the face planes'
      fill and fold composed over their levels (``_plane_tables``).
    - vmult_plain at degree >= 4: the absent rows' codes and an empty fold
      schedule for corr_compact.

    Returns the tables of ``BrickLaplaceMM`` (its buffers, and the packed
    brick factors it keeps on the host): the brick tables as given (node
    validity only as the dss and refill bit tables), these lists, and no
    dense K, T or Q (``kronecker_sum(K1, M1)`` builds K where a check needs
    it)."""
    C = int(meta["B"]) ** 3
    n_loc = (int(meta["p"]) + 1) ** 3
    N3p, n_sub = int(meta["N3p"]), int(meta["n_sub"])
    i32 = lambda x: np.asarray(x).astype(np.int32)
    out = {k: np.asarray(arrays[k]) for k in ("Kb", "Mb", "geo", "geo_cell_sub")}
    node_valid = np.asarray(arrays["node_valid"])  # on the card only as bit tables
    out.update(_cell_factors(out["Kb"], out["Mb"], np.asarray(arrays["K"]), int(meta["p"])))
    out.update(_brick_factors(out["Kb"], out["Mb"], int(meta["p"])))
    out.update(_dss_work_lists(arrays["face_other"], arrays["edge_contrib"],
                               arrays["corner_contrib"], node_valid, int(meta["NB"])))
    hn_sub = np.asarray(arrays["hn_sub"], dtype=np.int64)
    absent = np.asarray(arrays["absent_sub"], dtype=np.int64)
    n_hn, n_rows = len(hn_sub), n_sub * C
    cell_code = np.full(n_rows, -1, dtype=np.int32)
    cell_code[absent] = -2
    cell_code[hn_sub] = np.arange(n_hn)
    keep = (np.asarray(arrays["keep_hn"]) != 0) if n_hn else np.zeros((0, n_loc), bool)
    out.update(cell_code=cell_code, hn_sub=i32(hn_sub), keep_hn=keep)
    if n_sub * N3p > np.iinfo(np.int32).max:
        raise NotImplementedError("subset brick nodes exceed int32")
    assembled = bool(meta.get("assembled", False))
    if assembled:
        # the assembled schedule: the fold covers the chain bricks' cell rows
        # only, the masked removal every absent and constrained cell
        _quadrature_check(arrays, out["K1"], out["M1"], int(meta["p"]))
        n_rows = int(meta["n_chainb"]) * C
        if n_hn and hn_sub.max() >= n_rows:
            raise ValueError("a constrained row lies outside the chain bricks")
        for kind in ("rem", "absent"):
            if f"qmask_{kind}" in arrays:
                out.update({f"mq_{kind}_{k}": v for k, v in _masked_lists(
                    arrays[f"qmask_{kind}"], out["geo"], int(meta["B"])).items()})
        if meta.get("plane_meta"):
            out.update(_plane_tables(arrays, meta, len(out["geo"])))
    elif n_sub:
        # vmult_plain's removal of the absent cells: corr_compact with no runs
        out.update(plain_code=np.where(cell_code == -2, -2, -1).astype(np.int32),
                   plain_blocks=corr_compact.schedule(np.zeros(n_rows, np.int64), n_loc))
    h_all = np.repeat(np.arange(n_hn), n_loc)
    j_all = np.tile(np.arange(n_loc), n_hn)
    nF, nU, nR = n_hn * n_loc, n_sub * N3p, n_rows * n_loc
    out.update({f"corr_{k}": v for k, v in _runs(**_corr_lists(
        arrays, meta, hn_sub[h_all] * n_loc + j_all, keep, cell_code[:n_rows], nF, nR),
        n_loc=n_loc).items()})
    if not n_hn:
        return out

    slot_idx = np.asarray(arrays["slot_idx"], dtype=np.int64)
    node = lambda cell, slot: (cell // C) * N3p + slot_idx[cell % C, slot]

    # ---- fill: filled = M u over the subset brick nodes
    own = _sparse(np.arange(nF), node(hn_sub[h_all], j_all), (nF, nU),
                  keep.reshape(-1).astype(np.float64))
    M = own
    if len(arrays["fill_src"]):
        k, a, b = _stage1_entries(arrays, meta, "fill")
        real = np.full(len(arrays["fill_src"]), -1)
        real[arrays["fill_real_pos"]] = np.arange(len(arrays["fill_real_pos"]))
        fix = np.full(len(arrays["fill_src"]), -1)
        fix[arrays["fill_fix_idx"]] = arrays["fill_fix_local"]
        k, a, b = k[real[k] >= 0], a[real[k] >= 0], b[real[k] >= 0]
        dst = np.asarray(arrays["fill_dst_local"])[real[k]] * n_loc + b
        f = fix[k] >= 0  # the source is a constrained row: its masked base
        M = (M + _sparse(dst[~f], node(np.asarray(arrays["fill_src"])[k[~f]], a[~f]), (nF, nU))
             + _sparse(dst[f], fix[k[f]] * n_loc + a[f], (nF, nF)) @ own)
    for ti in range(meta["n_fill_tails"]):
        kk, a, b = _tail_entries(arrays, ti, "fill")
        src = np.asarray(arrays[f"fill_tail{ti}_src"])[kk] * n_loc + a
        dst = np.asarray(arrays[f"fill_tail{ti}_dst"])[kk] * n_loc + b
        M = M + _sparse(dst, src, (nF, nF)) @ M
    out.update({f"fill_{k}": v for k, v in
                _gather_lists(M - own, n_hn, n_loc, "fill").items()})

    # ---- hn: the nonzeros of each composite Q by output slot
    hn_q = np.full(n_hn, -1, dtype=np.int32)
    for s, e, qi in meta["hn_bounds"]:
        if qi is not None:
            hn_q[s:e] = qi
    out["hn_q"] = hn_q
    Qs = np.asarray(arrays["hn_Q"], dtype=np.float64)
    for name, mats in (("fwd", Qs.transpose(0, 2, 1)), ("bwd", Qs)):
        # row j of mats[q] lists the weights of output slot j
        q, j, i = np.nonzero(mats)
        ptr = np.searchsorted(q * n_loc + j, np.arange(len(Qs) * n_loc + 1))
        out.update({f"hn_{name}_ptr": i32(ptr[np.arange(len(Qs))[:, None] * n_loc
                                              + np.arange(n_loc + 1)]),
                    f"hn_{name}_col": i32(i), f"hn_{name}_w": mats[q, j, i]})

    # ---- refill: the fill's written nodes, their holders and divisors
    node_of_pos = np.asarray(arrays["node_of_pos"], dtype=np.int64)
    efx_src, efx_pos = (np.asarray(arrays[k], dtype=np.int64) for k in ("efx_src", "efx_pos"))
    if not np.array_equal(node_of_pos[efx_pos], slot_idx.reshape(-1)[efx_src]):
        raise ValueError("refill positions do not match their brick nodes")
    refill_pos = np.full(N3p, -1, dtype=np.int64)
    refill_pos[node_of_pos[efx_pos]] = efx_pos
    out.update(_refill_tables(refill_pos, slot_idx, arrays["fill_invden_X"], node_valid))
    return out


# ---------------------------------------------------------------------------
# The chain on the dense one-hot stacks (NumPy, host), stage by stage as
# bricks.py:2728-2849 computes it: the independent form that the composed
# lists of ``kernel_tables`` are checked against.
def _dense_segments(sel, arrays, meta, d):
    n_loc = sel.shape[1]
    return np.concatenate([np.zeros((0, n_loc))] + [
        np.einsum("gmi,gij->gmj", sel[off: off + G * m].reshape(G, m, n_loc),
                  arrays[f"{d}_T{si}"]).reshape(-1, n_loc)
        for si, off, G, m in meta[f"{d}_segs"]])


def dense_fill(arrays, meta, u_sub):
    """The compact fill chain's constrained rows [n_hn, n_loc] from the
    subset bricks u_sub [n_sub, N3p]."""
    t, C, N3p = arrays, meta["B"] ** 3, meta["N3p"]
    r = np.arange(u_sub.shape[0] * C)
    cols = u_sub.reshape(-1)[(r // C)[:, None] * N3p + np.asarray(t["slot_idx"])[r % C]]
    base = cols[t["hn_sub"]] * t["keep_hn"]
    filled = base.copy()
    sel = cols[t["fill_src"]]
    sel[t["fill_fix_idx"]] = base[t["fill_fix_local"]]
    np.add.at(filled, t["fill_dst_local"],
              _dense_segments(sel, t, meta, "fill")[t["fill_real_pos"]])
    for ti in range(meta["n_fill_tails"]):
        out = np.einsum("ki,kij->kj", filled[t[f"fill_tail{ti}_src"]], t[f"fill_tail{ti}_T"])
        np.add.at(filled, t[f"fill_tail{ti}_dst"], out)
    return filled


def dense_corr(arrays, meta, plain, sub_raw):
    """The compact fold chain and its sparse delta: dcols [n_sub*C, n_loc]
    from the plain cell rows and the constrained rows' HN^T output."""
    t = arrays
    outs = _dense_segments(sub_raw[t["corr_src"]], t, meta, "corr")
    acc = np.zeros_like(sub_raw)
    np.add.at(acc, t["corr_hn_dst"], outs[t["corr_hn_pos"]])
    nh = [(t["corr_nh_dst"], outs[t["corr_nh_pos"]])]
    for ti in range(meta["n_corr_tails"]):
        out = np.einsum("ki,kij->kj", (sub_raw + acc)[t[f"corr_tail{ti}_src"]],
                        t[f"corr_tail{ti}_T"])
        np.add.at(acc, t[f"corr_tail{ti}_hn_dst"], out[t[f"corr_tail{ti}_hn_pos"]])
        nh.append((t[f"corr_tail{ti}_nh_dst"], out[t[f"corr_tail{ti}_nh_pos"]]))
    dcols = np.zeros_like(plain)
    dcols[t["absent_sub"]] = -plain[t["absent_sub"]]
    dcols[t["hn_sub"]] = (sub_raw + acc) * t["keep_hn"] - plain[t["hn_sub"]]
    for idx, rows in nh:
        np.add.at(dcols, idx, rows)
    return dcols


# ===========================================================================
class BrickLaplaceMM(nn.Module):
    """Constrained Cartesian Laplace vmult on [n_bricks, N3p] brick vectors
    (dim = 3, every degree), the port of the reference's ``BrickLaplaceMM``
    at its defaults. Tables are registered buffers on ``device``;
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
        if mf.high_order_mapping:
            raise NotImplementedError("the deformed mapping's brick apply is not ported yet")
        if mf.categorize:
            raise NotImplementedError("the brick engine reads the cells in mesh order; build "
                                      "its MatrixFree without categorize")
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
        """Register the kernels' tables (``kernel_tables``) as buffers:
        floating ones cast to dtype, index ones as built (int32); brick_apply's
        packed factors stay on the host."""
        self._meta = meta
        for k in ("B", "p", "NB", "N3", "N3p", "n_sub", "n_chainb"):
            setattr(self, k, int(meta[k]))
        self.C = self.B**3
        self.n_loc = (self.p + 1) ** 3
        self.n_bricks = int(arrays["geo"].shape[0])
        self.assembled = bool(meta["assembled"])
        self.planes = bool(meta["plane_meta"])
        tables = kernel_tables(arrays, meta)
        self.n_absent = int((tables["cell_code"] == -2).sum())
        # the cell rows that corr_compact writes: the chain bricks' under the
        # assembled schedule, every subset brick's otherwise
        self.n_corr_rows = (self.n_chainb if self.assembled else self.n_sub) * self.C
        # cell_apply's and brick_apply's kernels take their factors by value,
        # as launch parameters
        self.brick_factors_host = tuple(torch.from_numpy(tables.pop(f"{n}_packed")).to(dtype)
                                        for n in ("Kb", "Mb"))
        for name, a in tables.items():
            a = np.ascontiguousarray(a)
            t = torch.from_numpy(a.astype(np.float64) if a.dtype.kind == "f" else a)
            self.register_buffer(name, t.to(device, dtype) if a.dtype.kind == "f"
                                 else t.to(device))
        self.n_hn = int(self.hn_sub.shape[0])
        self.register_buffer("geo_hn", self.geo_cell_sub[self.hn_sub.long()])
        self.factors_host = (self.K1.cpu(), self.M1.cpu())

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
    def _kernel(self, mod, plain: bool):
        """A kernel module's wrapper, or its plain version when plain."""
        return getattr(mod, f"{mod.NAME}_plain" if plain else mod.NAME)

    def hn_tables(self):
        """hn_cell's tables after u_sub: the fill lists, each row's Q and the
        Q lists in both directions."""
        return (self.hn_sub, self.keep_hn, self.fill_row_ptr, self.fill_ent_slot,
                self.fill_ent_src, self.hn_q, self.hn_fwd_ptr, self.hn_fwd_col, self.hn_fwd_w,
                self.hn_bwd_ptr, self.hn_bwd_col, self.hn_bwd_w)

    def _hn_cell(self, u_sub, mode: str, plain: bool = False):
        """The constrained rows from the subset bricks: sub_raw (mode "full",
        bricks.py:2465-2474) or the filled rows u_hat (mode "fill")."""
        fac = (self.K1, self.M1) if plain else self.factors_host
        return self._kernel(hn_cell, plain)(u_sub, *self.hn_tables(), *fac, self.geo_hn,
                                            self.B, mode=mode)

    # the steps of hn_cell one by one (plain versions; the tests hold them
    # against the reference's functions)
    def _hn_apply(self, rows, transpose: bool):
        """rows @ Q (the fill) or rows @ Q^T (HN^T), one Q per mask range."""
        d = "bwd" if transpose else "fwd"
        return hn_cell.hn_apply_plain(rows, self.hn_q, getattr(self, f"hn_{d}_ptr"),
                                      getattr(self, f"hn_{d}_col"), getattr(self, f"hn_{d}_w"))

    def _fill_hn_compact(self, u_sub):
        """Compact fill chain (bricks.py:2728-2773) on the constrained rows."""
        return hn_cell.fill_hn_plain(u_sub, *self.hn_tables()[:5], self.B)

    def _fill_rows(self, u_sub):
        """Filled constrained rows (bricks.py:2687-2694)."""
        return self._hn_apply(self._fill_hn_compact(u_sub), False)

    def corr_tables(self):
        """corr_compact's tables after plain_rows and sub_raw: the row codes,
        the keep mask, the fold runs and the block schedule."""
        return (self.cell_code[: self.n_corr_rows], self.keep_hn, self.corr_seg_ptr,
                self.corr_seg_dst, self.corr_ent_src, self.corr_blocks)

    def _corr_compact(self, plain_rows, sub_raw, plain: bool = False):
        """Compact correction chain + sparse delta (bricks.py:2775-2849):
        dcols = final - plain, nonzero on hole, constrained and fold-target
        rows only; plain_rows=None (the assembled schedule, bricks.py:
        2841-2845): the raw folded HN^T rows of the chain bricks."""
        return self._kernel(corr_compact, plain)(plain_rows, sub_raw, *self.corr_tables())

    def masked_tables(self, kind: str):
        """masked_quad's arguments after v and u: the cells of kind "rem"
        (absent and constrained) or "absent", K1 and M1, geo and B; None
        where no cell is selected."""
        brick = getattr(self, f"mq_{kind}_brick", None)
        if brick is None or not brick.numel():
            return None
        return (brick, getattr(self, f"mq_{kind}_ptr"), getattr(self, f"mq_{kind}_slot"))

    def _masked_quad(self, v, u, kind: str, plain: bool = False):
        """v[:n_sub] -= the masked cells' geo_c K_cell u_c (the reference's
        ``-_masked_quad_apply(u_sub, qmask_{kind})``, bricks.py:3169-3244),
        in place; v unchanged where no cell is selected."""
        tables = self.masked_tables(kind)
        if tables is None:
            return v
        fac = (self.K1, self.M1) if plain else self.factors_host
        return self._kernel(masked_quad, plain)(v, u, *tables, *fac, self.geo, self.B)

    def plane_fill_tables(self):
        """plane_fill's arguments after u: the covered nodes by brick and the
        composed fill's entries."""
        return (self.plane_cov, self.plane_cov_ptr, self.plane_fill_ptr, self.plane_fill_src,
                self.plane_fill_w)

    def plane_fold_tables(self):
        """plane_fold's arguments after v: the targets' entries, then the
        covered nodes."""
        return (self.plane_fold_tgt, self.plane_fold_ptr, self.plane_fold_src, self.plane_fold_w,
                self.plane_cov)

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
        input-fill branch, then ``_dss_fill``). The chain reads only bv, so
        it runs first and brick_apply adds its deltas (dcols) into the
        subset bricks as it stores them. plain=True runs every kernel's
        plain PyTorch version on the operator's device instead: the
        reference the card's kernels are held against."""
        self._check(bv)
        if self.assembled:
            return self._vmult_assembled(bv, plain)
        dcols = None
        if self.n_sub:
            u_sub = bv[: self.n_sub]
            if self.n_hn:
                sub_raw = self._hn_cell(u_sub, "full", plain)
            else:
                sub_raw = bv.new_empty((0, self.n_loc))
            dcols = self._corr_compact(self._cell_rows(u_sub, plain), sub_raw, plain)
        return self._dss(self._brick_apply(bv, dcols, plain), plain)

    def _vmult_assembled(self, bv, plain: bool):
        """The reference's degree <= 3 schedule (``_vmult_impl``'s assembled
        branch, bricks.py:2355-2439): the face-plane fill of a new vector u
        (p <= 2), the constrained rows and their fold on the chain bricks
        (hn_cell, corr_compact without plain rows), brick_apply on u with
        the folded rows in its epilogue, the masked removal of the absent
        and constrained cells' unconstrained contributions, the face-plane
        fold, the DSS."""
        u = self._plane_fill(bv, plain) if self.planes else bv
        dcols = None
        if self.n_sub and self.n_hn:
            dcols = self._corr_compact(None, self._hn_cell(u[: self.n_sub], "full", plain), plain)
        v = self._brick_apply(u, dcols, plain)
        if self.n_sub:
            v = self._masked_quad(v, u, "rem" if self.n_hn else "absent", plain)
        if self.planes:
            v = self._kernel(plane_fold, plain)(v, *self.plane_fold_tables())
        return self._dss(v, plain)

    def vmult_plain(self, bv: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """The unconstrained operator (reference ``vmult_plain``,
        ``_vmult_plain_impl`` bricks.py:2909-2956): the brick operator, the
        absent cells' contributions removed, the DSS; no hanging-node
        interpolation, fold or fill. Degree <= 3: the masked removal of the
        absent cells; degree >= 4: their cell rows (cell_apply) negated by
        corr_compact with no fold entries, added in brick_apply's epilogue.
        The HN overhead of the paper is vmult over vmult_plain."""
        self._check(bv)
        if self.assembled:
            v = self._brick_apply(bv, None, plain)
            if self.n_sub:
                v = self._masked_quad(v, bv, "absent", plain)
            return self._dss(v, plain)
        dcols = None
        if self.n_sub and self.n_absent:
            dcols = self._kernel(corr_compact, plain)(
                self._cell_rows(bv[: self.n_sub], plain), bv.new_empty((0, self.n_loc)),
                self.plain_code, self.keep_hn[:0], self.corr_seg_ptr[:1], self.corr_seg_dst[:0],
                self.corr_ent_src[:0], self.plain_blocks)
        return self._dss(self._brick_apply(bv, dcols, plain), plain)

    def _cell_rows(self, u_sub, plain: bool):
        """Every subset cell's geo_c K_cell u_c (cell_apply from the bricks)."""
        fac = (self.K1, self.M1) if plain else self.factors_host
        return self._kernel(cell_apply, plain)(u_sub, *fac, self.geo_cell_sub, brick_size=self.B)

    def _brick_apply(self, u, dcols, plain: bool):
        return self._kernel(brick_apply, plain)(
            u, *((self.Kb, self.Mb) if plain else self.brick_factors_host), self.geo, self.p,
            dcols=dcols, brick_size=self.B)

    def _dss(self, v, plain: bool):
        return self._kernel(dss_surface, plain)(v, *self.dss_tables())

    def _plane_fill(self, u, plain: bool):
        """A new vector: u with the face planes' covered nodes filled."""
        return self._kernel(plane_fill, plain)(u, *self.plane_fill_tables())

    def dss_tables(self):
        """dss_surface's arguments after v: its work lists, bit tables and NB."""
        return (self.dss_face_pairs, self.dss_edge_pools, self.dss_corner_pools,
                self.dss_valid_bits, self.dss_hole_bricks, self.dss_hole_bits, self.NB)

    def refill(self, v: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """Restore the hanging copies of a brick vector whose conforming
        copies agree (reference ``_refill_impl``, input-fill branch): under
        face planes, first their fill into a new vector; then the filled
        constrained rows (hn_cell's fill mode) and the coverage-divided
        closure-slot updates written back at their brick nodes. plain=True
        runs the kernels' plain versions, as for vmult."""
        self._check(v)
        if self.planes:
            v = self._plane_fill(v, plain)
        if not (self.n_sub and self.n_hn):
            return v
        u_hat = self._hn_cell(v[: self.n_sub], "fill", plain)
        return self._kernel(refill_update, plain)(v, u_hat, *self.refill_tables())

    def refill_tables(self):
        """refill_update's arguments after v and u_hat: the validity bits,
        the row codes, the written nodes, their holders and divisors, B."""
        return (self.refill_valid_bits, self.cell_code, self.refill_nodes, self.refill_holders,
                self.refill_invden, self.B)
