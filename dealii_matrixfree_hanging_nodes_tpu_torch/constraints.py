"""Hanging-node constraint machinery (capabilities C3, C5, and the Helper
census of constraint_helper.h). NumPy copy of
``dealii_matrixfree_hanging_nodes_tpu.constraints``.

Produces, from (Triangulation, DoFHandler):

1. ``masks`` — the compressed constraint kind per cell: a small uint16 whose
   bits are [subcell position | face-constrained per axis | edge-constrained
   per axis], 0 = unconstrained sentinel. 3D: 3+3+3 bits (512 kinds, matching
   the reference's compress(quadrant + (face<<3) + (edge<<6)) synthesis at
   benchmark_00_likwid.cc:41-48); 2D: 2+2 bits.
2. The slow/oracle path — an explicit AffineConstraints-style row set
   (u_slave = sum w * u_master), built from coarse Lagrange evaluation at the
   fine nodes; consumed as C^T A C (benchmark_01.h:286-293 analog).
3. The fast path — per-cell DoF indices with hanging slots replaced by the
   coarse neighbor's face/edge DoFs in identity lattice layout, so a plain
   gather followed by the in-register interpolation kernel resolves all
   constraints (the core algorithm of the reference paper).

Detection rules on the 2:1-balanced forest (all cells axis-aligned, one
orientation — no permutation tables needed, unlike the general-mesh code in
deal.II):

- face bit d: the face-d neighbor at side ``s_d = coord_d & 1`` (the only
  face on the parent's boundary) has an active one-level-coarser ancestor.
- edge bit e (3D): the diagonal cell across the edge at tangential corner
  ``(s_a, s_b)`` has an active one-level-coarser ancestor, and neither
  adjacent face is itself constrained (face interpolation covers its edges).

The 2:1 face+edge balance guarantees every master DoF gathered by the fast
path is unconstrained; this is asserted at build time.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .dof_handler import DoFHandler, local_lattice
from .mesh import Triangulation

__all__ = ["ConstraintInfo", "build_constraints", "decompress_mask"]

_WTOL = 1e-13


def decompress_mask(masks: np.ndarray, dim: int):
    """Split compressed masks into (subcell, face, edge) bit-field arrays."""
    masks = np.asarray(masks)
    sub = masks & ((1 << dim) - 1)
    face = (masks >> dim) & ((1 << dim) - 1)
    edge = (masks >> (2 * dim)) & ((1 << dim) - 1) if dim == 3 else np.zeros_like(sub)
    return sub, face, edge


@dataclass
class ConstraintInfo:
    dim: int
    degree: int
    n_dofs: int
    masks: np.ndarray  # uint16 [n_cells]
    cell_dofs_fast: np.ndarray  # int32 [n_cells, n_loc]
    # slow path (CSR over constrained rows)
    slave_dofs: np.ndarray  # int64 [n_slaves]
    row_ptr: np.ndarray  # int64 [n_slaves + 1]
    col: np.ndarray  # int64 [nnz]
    weight: np.ndarray  # float64 [nnz]
    # coarse neighbors used by the fast path (active cell indices, -1 = none)
    face_neighbor: np.ndarray = field(default=None)  # int64 [n_cells, dim]
    edge_neighbor: np.ndarray = field(default=None)  # int64 [n_cells, 3] (3D)

    def constrained_dof_marker(self) -> np.ndarray:
        """Boolean [n_dofs]: True where the DoF is hanging (has a row)."""
        m = np.zeros(self.n_dofs, dtype=bool)
        m[self.slave_dofs] = True
        return m

    # ---------------------------------------------------------- slow apply
    def expansion_matrix(self):
        """scipy CSR C (n x n): identity on unconstrained DoFs, expansion rows
        on hanging DoFs (zero diagonal). vmult_slow = C^T A C."""
        import scipy.sparse as sp

        n = self.n_dofs
        hanging = self.constrained_dof_marker()
        free = np.nonzero(~hanging)[0]
        rows = np.concatenate([free, np.repeat(self.slave_dofs, np.diff(self.row_ptr))])
        cols = np.concatenate([free, self.col])
        vals = np.concatenate([np.ones(len(free)), self.weight])
        return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))

    def distribute(self, u: np.ndarray) -> np.ndarray:
        """Overwrite hanging entries with their constraint expansion."""
        out = np.array(u, copy=True)
        nnz_per = np.diff(self.row_ptr)
        sums = np.zeros(len(self.slave_dofs), dtype=u.dtype)
        np.add.at(
            sums,
            np.repeat(np.arange(len(self.slave_dofs)), nnz_per),
            self.weight.astype(u.dtype) * u[self.col],
        )
        out[self.slave_dofs] = sums
        return out


# ---------------------------------------------------------------------------
def _active_lookup(tria: Triangulation):
    keys = tria.pack(tria.level, tria.coord)
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]

    def find(level: np.ndarray, coord: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Active index of (level, coord) or -1."""
        out = np.full(len(level), -1, dtype=np.int64)
        if not valid.any():
            return out
        k = tria.pack(level[valid], coord[valid])
        pos = np.searchsorted(sorted_keys, k)
        pos_c = np.clip(pos, 0, len(sorted_keys) - 1)
        hit = sorted_keys[pos_c] == k
        res = np.full(len(k), -1, dtype=np.int64)
        res[hit] = order[pos_c[hit]]
        out[valid] = res
        return out

    return find


def _slots_where(lat: np.ndarray, cond: np.ndarray) -> np.ndarray:
    """Flat local-slot indices satisfying a per-node condition (ordered)."""
    return np.nonzero(cond)[0]


def build_constraints(dofh: DoFHandler) -> ConstraintInfo:
    tria = dofh.tria
    dim, p = tria.dim, dofh.degree
    n = p + 1
    n_cells = tria.n_active_cells
    lat = local_lattice(p, dim)  # [n_loc, dim]
    cd = dofh.cell_dofs
    P = dofh.shape.P  # [2, n, n] subface embedding
    level, coord = tria.level, tria.coord
    find = _active_lookup(tria)

    s_bits = (coord & 1).astype(np.int64)  # [n_cells, dim]

    # ---------------------------------------------------- face/edge neighbors
    face_nb = np.full((n_cells, dim), -1, dtype=np.int64)
    for d in range(dim):
        step = 2 * s_bits[:, d] - 1
        nc = coord.copy()
        nc[:, d] += step
        inside = (nc[:, d] >= 0) & (nc[:, d] < (np.int64(1) << level))
        valid = inside & (level >= 1)
        face_nb[:, d] = find(level - 1, nc >> np.int64(1), valid)

    edge_nb = np.full((n_cells, 3), -1, dtype=np.int64)
    if dim == 3:
        for e in range(3):
            a, b = [x for x in range(3) if x != e]
            nc = coord.copy()
            nc[:, a] += 2 * s_bits[:, a] - 1
            nc[:, b] += 2 * s_bits[:, b] - 1
            lim = np.int64(1) << level
            inside = (
                (nc[:, a] >= 0)
                & (nc[:, a] < lim)
                & (nc[:, b] >= 0)
                & (nc[:, b] < lim)
            )
            valid = inside & (level >= 1)
            cand = find(level - 1, nc >> np.int64(1), valid)
            # covered by a constrained adjacent face -> face interp handles it
            covered = (face_nb[:, a] >= 0) | (face_nb[:, b] >= 0)
            edge_nb[:, e] = np.where(covered, -1, cand)

    face_bits = np.zeros(n_cells, dtype=np.int64)
    edge_bits = np.zeros(n_cells, dtype=np.int64)
    for d in range(dim):
        face_bits |= (face_nb[:, d] >= 0).astype(np.int64) << d
        if dim == 3:
            edge_bits |= (edge_nb[:, d] >= 0).astype(np.int64) << d

    sub_val = np.zeros(n_cells, dtype=np.int64)
    for d in range(dim):
        sub_val |= s_bits[:, d] << d
    constrained = (face_bits | edge_bits) != 0
    masks = np.where(
        constrained, sub_val | (face_bits << dim) | (edge_bits << (2 * dim)), 0
    ).astype(np.uint16)

    # --------------------------------------------- fast dofmap + slow rows
    cd_fast = cd.copy()
    slave_list, col_list, w_list = [], [], []

    def tangential_weight(axes_s, axes_idx_fine, axes_idx_coarse):
        """Product of P[s_axis][ia, ja] over tangential axes (kron)."""
        W = np.ones((len(axes_idx_fine[0]), len(axes_idx_coarse[0])))
        for s_ax, ifa, jco in zip(axes_s, axes_idx_fine, axes_idx_coarse):
            W = W * P[s_ax][np.ix_(ifa, jco)]
        return W

    # face constraints, grouped by (axis d, full subcell combo)
    for d in range(dim):
        tang = [x for x in range(dim) if x != d]
        has = face_nb[:, d] >= 0
        if not has.any():
            continue
        for combo in range(1 << dim):
            sv = [(combo >> x) & 1 for x in range(dim)]
            cells = np.nonzero(has & np.all(s_bits == np.array(sv), axis=1))[0]
            if len(cells) == 0:
                continue
            s_d = sv[d]
            fine_slots = _slots_where(lat, lat[:, d] == s_d * p)
            coarse_slots = _slots_where(lat, lat[:, d] == (1 - s_d) * p)
            C = face_nb[cells, d]
            # fast path: replace hanging slots by coarse masters (identity layout)
            cd_fast[np.ix_(cells, fine_slots)] = cd[np.ix_(C, coarse_slots)]
            # slow path rows: coarse basis evaluated at fine node positions
            W = tangential_weight(
                [sv[t] for t in tang],
                [lat[fine_slots, t] for t in tang],
                [lat[coarse_slots, t] for t in tang],
            )
            # skip the one fine node shared with the coarse face (corner vertex)
            shared = np.all(
                np.stack([lat[fine_slots, t] == sv[t] * p for t in tang]), axis=0
            )
            keep = ~shared
            slave_list.append(cd[np.ix_(cells, fine_slots[keep])].ravel())
            m, k = len(cells), int(keep.sum())
            col_list.append(
                np.broadcast_to(cd[C][:, coarse_slots][:, None, :], (m, k, len(coarse_slots))).reshape(m * k, -1)
            )
            w_list.append(np.broadcast_to(W[keep][None, :, :], (m, k, W.shape[1])).reshape(m * k, -1))

    # edge constraints (3D), grouped by (axis e, subcell combo)
    if dim == 3:
        for e in range(3):
            a, b = [x for x in range(3) if x != e]
            has = edge_nb[:, e] >= 0
            if not has.any():
                continue
            for combo in range(8):
                sv = [(combo >> x) & 1 for x in range(3)]
                cells = np.nonzero(has & np.all(s_bits == np.array(sv), axis=1))[0]
                if len(cells) == 0:
                    continue
                fine_slots = _slots_where(
                    lat, (lat[:, a] == sv[a] * p) & (lat[:, b] == sv[b] * p)
                )
                coarse_slots = _slots_where(
                    lat,
                    (lat[:, a] == (1 - sv[a]) * p) & (lat[:, b] == (1 - sv[b]) * p),
                )
                D = edge_nb[cells, e]
                cd_fast[np.ix_(cells, fine_slots)] = cd[np.ix_(D, coarse_slots)]
                W = P[sv[e]][np.ix_(lat[fine_slots, e], lat[coarse_slots, e])]
                keep = lat[fine_slots, e] != sv[e] * p  # endpoint shared with D
                slave_list.append(cd[np.ix_(cells, fine_slots[keep])].ravel())
                m, k = len(cells), int(keep.sum())
                # pad edge rows (n masters) to the face-row width n^(dim-1)
                width = n ** (dim - 1)
                cols_blk = np.zeros((m, k, width), dtype=np.int64)
                cols_blk[:, :, :n] = cd[D][:, coarse_slots][:, None, :]
                w_blk = np.zeros((m, k, width))
                w_blk[:, :, :n] = W[keep][None, :, :]
                col_list.append(cols_blk.reshape(m * k, -1))
                w_list.append(w_blk.reshape(m * k, -1))

    # ------------------------------------------------ assemble + dedupe rows
    if slave_list:
        slaves = np.concatenate(slave_list)
        cols = np.concatenate(col_list, axis=0)
        ws = np.concatenate(w_list, axis=0)
        uniq, first = np.unique(slaves, return_index=True)
        cols, ws = cols[first], ws[first]
        # drop negligible weights, build CSR
        keepw = np.abs(ws) > _WTOL
        counts = keepw.sum(axis=1)
        row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        col = cols[keepw]
        weight = ws[keepw]
        slave_dofs = uniq
    else:
        slave_dofs = np.zeros(0, dtype=np.int64)
        row_ptr = np.zeros(1, dtype=np.int64)
        col = np.zeros(0, dtype=np.int64)
        weight = np.zeros(0, dtype=np.float64)

    # ------------------------------------------------- closure invariant
    # 2:1 face+edge balance => masters are never themselves constrained.
    if len(col):
        hanging = np.zeros(dofh.n_dofs, dtype=bool)
        hanging[slave_dofs] = True
        assert not hanging[col].any(), "constraint chain detected — balance broken"
        assert not hanging[cd_fast.ravel()].any(), (
            "fast dofmap references a hanging DoF — balance broken"
        )

    return ConstraintInfo(
        dim=dim,
        degree=p,
        n_dofs=dofh.n_dofs,
        masks=masks,
        cell_dofs_fast=cd_fast,
        slave_dofs=slave_dofs,
        row_ptr=row_ptr,
        col=col,
        weight=weight,
        face_neighbor=face_nb,
        edge_neighbor=edge_nb,
    )
