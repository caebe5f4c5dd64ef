"""Array-based adaptively refined forest mesh (capability C8 / layer L1).

Host-side NumPy copy of ``dealii_matrixfree_hanging_nodes_tpu.mesh`` for the
PyTorch port (no native setup core). Replaces the deal.II
Triangulation + parallel::distributed::Triangulation (p4est) stack: active cells are flat
NumPy arrays — ``level[n]`` and integer octant coordinates ``coord[n, dim]``
at each cell's own level — kept in Morton (space-filling-curve) order so that
partitioning across chips is a contiguous-range split, exactly the role
p4est's SFC plays in the reference (benchmark_02.cc:65-87).

2:1 balance ("one-irregularity") is enforced over faces (2D/3D) and edges
(3D), matching deal.II's rule; this is the invariant that makes the fast
hanging-node algorithm's masters unconstrained (see ARCHITECTURE.md).

Geometry generators reproduce the semantics of the reference's
GridGenerator::create_{step,quadrant,quadrant_flexible,annulus}
(benchmark.h:5-145) against this representation.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "Triangulation",
    "create_step",
    "create_quadrant",
    "create_quadrant_flexible",
    "create_annulus",
    "create_uniform",
    "create_geometry",
]

# offsets of the 2^dim children within a parent, lexicographic (x fastest)
def _child_offsets(dim: int) -> np.ndarray:
    n = 2**dim
    out = np.zeros((n, dim), dtype=np.int64)
    for c in range(n):
        for d in range(dim):
            out[c, d] = (c >> d) & 1
    return out


def _interleave_bits(coord: np.ndarray, nbits: int) -> np.ndarray:
    """Morton key by bit interleaving; coord [n, dim] -> uint64 [n]."""
    n, dim = coord.shape
    key = np.zeros(n, dtype=np.uint64)
    c = coord.astype(np.uint64)
    for b in range(nbits):
        for d in range(dim):
            key |= ((c[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                b * dim + d
            )
    return key


class Triangulation:
    """Forest-of-octrees AMR mesh over the hyper_cube [left, right]^dim."""

    def __init__(self, dim: int, left: float = -1.0, right: float = 1.0):
        self.dim = dim
        self.left = float(left)
        self.right = float(right)
        self.level = np.zeros(1, dtype=np.int64)
        self.coord = np.zeros((1, dim), dtype=np.int64)
        self._sort()

    # ------------------------------------------------------------------ info
    @property
    def n_active_cells(self) -> int:
        return len(self.level)

    @property
    def n_global_levels(self) -> int:
        return int(self.level.max()) + 1

    def cell_size(self) -> np.ndarray:
        """Physical edge length per active cell."""
        return (self.right - self.left) * (0.5 ** self.level.astype(np.float64))

    def cell_lower(self) -> np.ndarray:
        """Physical lower corner per active cell, [n, dim]."""
        h = self.cell_size()
        return self.left + self.coord.astype(np.float64) * h[:, None]

    def centers(self) -> np.ndarray:
        h = self.cell_size()
        return self.left + (self.coord.astype(np.float64) + 0.5) * h[:, None]

    # ------------------------------------------------------- key bookkeeping
    def pack(self, level: np.ndarray, coord: np.ndarray) -> np.ndarray:
        """Unique int64 key for a (level, coord) cell slot."""
        # 16 bits per coordinate (max level 15 plus headroom) + level bits.
        # np.int64 scalar shifts: NumPy 2.0 python-int promotion is very slow.
        if len(level) and int(level.max()) > 15:
            raise ValueError(
                f"Triangulation supports at most 15 refinement levels, got "
                f"{int(level.max())} — key packing would overflow its 16-bit "
                "coordinate fields"
            )
        key = level.astype(np.int64)
        for d in range(self.dim):
            key = (key << np.int64(16)) | coord[:, d].astype(np.int64)
        return key

    def _sort(self):
        lmax = int(self.level.max())
        anchored = self.coord << (lmax - self.level[:, None])
        keys = _interleave_bits(anchored, lmax + 1)
        order = np.argsort(keys, kind="stable")
        self.level = self.level[order]
        self.coord = self.coord[order]
        self._active_keys = np.sort(self.pack(self.level, self.coord))

    def _is_active(self, level: np.ndarray, coord: np.ndarray) -> np.ndarray:
        keys = self.pack(level, coord)
        idx = np.searchsorted(self._active_keys, keys)
        idx = np.clip(idx, 0, len(self._active_keys) - 1)
        return self._active_keys[idx] == keys

    def active_index_map(self) -> dict:
        """packed key -> active cell index (post-sort order)."""
        return {int(k): i for i, k in enumerate(self.pack(self.level, self.coord))}

    # ----------------------------------------------------------- refinement
    def _split(self, flags: np.ndarray):
        """Replace flagged active cells by their 2^dim children (no balance)."""
        if not flags.any():
            return
        keep_level = self.level[~flags]
        keep_coord = self.coord[~flags]
        parents_l = self.level[flags]
        parents_c = self.coord[flags]
        offs = _child_offsets(self.dim)
        n_child = len(offs)
        child_l = np.repeat(parents_l + 1, n_child)
        child_c = np.repeat(parents_c * 2, n_child, axis=0) + np.tile(
            offs, (len(parents_l), 1)
        )
        self.level = np.concatenate([keep_level, child_l])
        self.coord = np.concatenate([keep_coord, child_c])

    def _balance_offsets(self) -> np.ndarray:
        """Neighbor probe offsets: faces, plus edges in 3D (deal.II rule)."""
        offs = []
        for d in range(self.dim):
            for s in (-1, 1):
                o = np.zeros(self.dim, dtype=np.int64)
                o[d] = s
                offs.append(o)
        if self.dim == 3:
            for e in range(3):
                a, b = [x for x in range(3) if x != e]
                for sa in (-1, 1):
                    for sb in (-1, 1):
                        o = np.zeros(3, dtype=np.int64)
                        o[a], o[b] = sa, sb
                        offs.append(o)
        return np.stack(offs)

    def _balance_once(self) -> bool:
        """Flag+split active cells >=2 levels coarser than a face/edge neighbor.

        For each active cell K at level l and each face/edge-adjacent slot at
        K's own level, if the slot is covered by an active ancestor at level
        <= l-2, that ancestor violates 1-irregularity and is refined.
        (NumPy only: the reference's native setup core is not carried over;
        both give the same mesh.)
        """
        offsets = self._balance_offsets()
        lmax = int(self.level.max())
        to_refine = np.zeros(self.n_active_cells, dtype=bool)
        key_index = self._active_keys  # sorted
        # map sorted key -> active index
        sorted_to_idx = np.argsort(self.pack(self.level, self.coord), kind="stable")

        for off in offsets:
            nb = self.coord + off[None, :]
            lvl = self.level
            valid = np.all(nb >= 0, axis=1) & np.all(
                nb < (np.int64(1) << lvl)[:, None], axis=1
            )
            # check ancestors of the neighbor slot at levels l-2 .. 0
            for up in range(2, lmax + 1):
                anc_lvl = lvl - up
                sel = valid & (anc_lvl >= 0)
                if not sel.any():
                    break
                anc_coord = nb[sel] >> np.int64(up)
                keys = self.pack(anc_lvl[sel], anc_coord)
                pos = np.searchsorted(key_index, keys)
                pos_c = np.clip(pos, 0, len(key_index) - 1)
                hit = key_index[pos_c] == keys
                if hit.any():
                    to_refine[sorted_to_idx[pos_c[hit]]] = True
        if to_refine.any():
            self._split(to_refine)
            return True
        return False

    def execute_refinement(self, flags: np.ndarray):
        """Refine flagged cells, then restore 2:1 balance (deal.II
        execute_coarsening_and_refinement semantics for refine-only flags)."""
        flags = np.asarray(flags, dtype=bool)
        if flags.shape != (self.n_active_cells,):
            raise ValueError("flags must match n_active_cells")
        self._split(flags)
        self._sort()
        while self._balance_once():
            self._sort()

    def refine_global(self, times: int = 1):
        for _ in range(times):
            self.execute_refinement(np.ones(self.n_active_cells, dtype=bool))


# ------------------------------------------------------------------ geometries
def create_uniform(dim: int, n_refinements: int) -> Triangulation:
    tria = Triangulation(dim)
    tria.refine_global(n_refinements)
    return tria


def create_step(dim: int, n_refinements: int) -> Triangulation:
    """Refine the x<0 half-domain once per level (benchmark.h:7-34 semantics)."""
    tria = Triangulation(dim)
    if n_refinements == 0:
        return tria
    tria.refine_global(1)
    for _ in range(1, n_refinements):
        flags = tria.centers()[:, 0] <= 0.0
        tria.execute_refinement(flags)
    assert tria.n_global_levels - 1 == n_refinements
    return tria


def create_quadrant(dim: int, n_refinements: int) -> Triangulation:
    """Refine the all-negative quadrant/octant each level (benchmark.h:38-69)."""
    tria = Triangulation(dim)
    if n_refinements == 0:
        return tria
    tria.refine_global(1)
    for _ in range(1, n_refinements):
        flags = np.all(tria.centers() <= 0.0, axis=1)
        tria.execute_refinement(flags)
    assert tria.n_global_levels - 1 == n_refinements
    return tria


def create_quadrant_flexible(
    dim: int, n_ref_global: int, n_ref_local: int = 1
) -> Triangulation:
    """n_ref_global uniform + n_ref_local octant refinements (benchmark.h:73-96)."""
    tria = Triangulation(dim)
    tria.refine_global(n_ref_global)
    for _ in range(n_ref_local):
        flags = np.all(tria.centers() <= 0.0, axis=1)
        tria.execute_refinement(flags)
    return tria


def create_annulus(dim: int, n_refinements: int) -> Triangulation:
    """Refine three concentric shells in the cube (benchmark.h:100-144)."""
    tria = Triangulation(dim)
    if n_refinements == 0:
        return tria
    for _ in range(max(0, n_refinements - 3)):
        tria.refine_global(1)
    if n_refinements >= 1:
        r = np.linalg.norm(tria.centers(), axis=1)
        tria.execute_refinement(r < 0.55)
    if n_refinements >= 2:
        r = np.linalg.norm(tria.centers(), axis=1)
        tria.execute_refinement((0.3 <= r) & (r <= 0.43))
    if n_refinements >= 3:
        r = np.linalg.norm(tria.centers(), axis=1)
        tria.execute_refinement((0.335 <= r) & (r <= 0.39))
    return tria


def create_geometry(geometry_type: str, dim: int, n_refinements: int) -> Triangulation:
    """Dispatch by the reference's GeometryType parameter (benchmark_01.h:208-217)."""
    if geometry_type == "step":
        return create_step(dim, n_refinements)
    if geometry_type == "quadrant":
        return create_quadrant(dim, n_refinements)
    if geometry_type == "quadrant_flexible":
        return create_quadrant_flexible(dim, n_refinements)
    if geometry_type == "annulus":
        return create_annulus(dim, n_refinements)
    if geometry_type == "uniform":
        return create_uniform(dim, n_refinements)
    raise ValueError(f"unknown geometry type: {geometry_type}")
