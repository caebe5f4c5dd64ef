"""Entity-keyed DoF enumeration for continuous FE_Q(p) on the AMR forest
(capability L2: DoFHandler::distribute_dofs analog, benchmark_01.h:247).
NumPy copy of ``dealii_matrixfree_hanging_nodes_tpu.dof_handler``.

Each of the (p+1)^dim local lattice nodes of a cell belongs to a topological
entity (vertex / edge / face / cell interior), determined per axis by whether
its lattice index is 0, p, or interior. Entities are keyed exactly with
integers at the finest-level resolution:

- point-like axis  -> corner coordinate of the node on that axis, marker 0
- interior axis    -> segment base coordinate, marker = extent * 8 + index

Two lattice nodes share a global DoF iff they share the entity key. This
reproduces deal.II's sharing rule on structured AMR: vertices are shared
across levels by geometric position, edge/face interiors only between cells
owning the *same* (equal-extent) entity — so the hanging (fine) side gets its
own DoFs, which the constraint layer then eliminates. Geometric coincidence
alone (e.g. even-p fine nodes sitting on coarse node positions) correctly
does not merge DoFs.
"""

from __future__ import annotations

import numpy as np

from .elements import shape_info
from .mesh import Triangulation

__all__ = ["DoFHandler", "local_lattice"]


def local_lattice(degree: int, dim: int) -> np.ndarray:
    """Per-axis lattice indices of local DoFs: [n_loc, dim], x fastest."""
    n = degree + 1
    n_loc = n**dim
    l = np.arange(n_loc)
    return np.stack([(l // n**a) % n for a in range(dim)], axis=1)


class DoFHandler:
    """Distributes global DoFs for FE_Q(degree) over the active cells.

    Attributes
    ----------
    cell_dofs : int32 [n_cells, n_loc]
        Global DoF indices per cell, lexicographic local ordering (x fastest).
    n_dofs : int
        Number of global DoFs (hanging DoFs included, as in deal.II).
    """

    def __init__(self, tria: Triangulation, degree: int):
        self.tria = tria
        self.degree = degree
        self.dim = tria.dim
        self.shape = shape_info(degree)
        self._distribute()

    def _distribute(self):
        tria, p, dim = self.tria, self.degree, self.dim
        n = p + 1
        lat = local_lattice(p, dim)  # [n_loc, dim]
        n_cells = tria.n_active_cells
        n_loc = n**dim
        lmax = int(tria.level.max())
        # per-entity-class packed keys (one int64): 16-bit coordinates per
        # axis (lmax <= 15), 4-bit interior lattice indices (p <= 15), 4-bit
        # level field. Enforce instead of silently overflowing.
        if lmax > 15:
            raise ValueError(f"DoFHandler supports at most 15 levels, got {lmax}")
        if p > 15:
            raise ValueError(f"DoFHandler supports degree <= 15, got {p}")

        # The reference's NumPy numbering (equal to its native core's, as
        # its test_mesh.py checks): every lattice node belongs to one of
        # 2^dim classes by which axes are interior; vertices are shared
        # purely by position across levels, interior entities only between
        # equal-extent (same-level) entities.
        sz = (np.int64(1) << (lmax - tria.level)).astype(np.int64)  # [n_cells]
        base = tria.coord * sz[:, None]  # [n_cells, dim] lower corner @ lmax

        interior_ax = (lat > 0) & (lat < p)  # [n_loc, dim]
        cls_of_slot = np.zeros(n_loc, dtype=np.int64)
        for a in range(dim):
            cls_of_slot |= interior_ax[:, a].astype(np.int64) << a

        gids = np.empty((n_cells, n_loc), dtype=np.int32)
        next_gid = 0
        for cls in range(1 << dim):
            slots = np.nonzero(cls_of_slot == cls)[0]
            if not len(slots):
                continue
            key = np.zeros((n_cells, len(slots)), dtype=np.uint64)
            iabits = np.zeros((n_cells, len(slots)), dtype=np.uint64)
            for a in range(dim):
                ia = lat[slots, a][None, :]  # [1, m]
                is_hi = ia == p
                inter = interior_ax[slots, a][None, :]
                ca = base[:, a][:, None] + np.where(is_hi, sz[:, None], 0)
                # NOTE: scalar shift operands must be np.uint64 — NumPy
                # 2.0's python-int promotion path is ~1000x slower here.
                key = (key << np.uint64(16)) | ca.astype(np.uint64)
                iabits = (iabits << np.uint64(4)) | np.where(
                    inter, ia, 0
                ).astype(np.uint64)
            key = (key << np.uint64(4 * dim)) | iabits
            lvl_field = (
                tria.level[:, None].astype(np.uint64)
                if cls
                else np.zeros((n_cells, 1), dtype=np.uint64)
            )
            key = (key << np.uint64(4)) | lvl_field
            flat = key.ravel()
            order = np.argsort(flat, kind="stable")
            s1 = flat[order]
            new_group = np.empty(len(s1), dtype=bool)
            new_group[0] = True
            new_group[1:] = np.diff(s1) != 0
            gid_sorted = np.cumsum(new_group) - 1 + next_gid
            cg = np.empty(len(flat), dtype=np.int32)
            cg[order] = gid_sorted
            gids[:, slots] = cg.reshape(n_cells, len(slots))
            next_gid = int(gid_sorted[-1]) + 1

        self.cell_dofs = gids
        self.n_dofs = next_gid
        self._lat = lat
