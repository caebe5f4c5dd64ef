"""Build the port's operators from the reference engines' host tables.

``from_reference(np_arrays, meta, device, dtype)`` takes
``BrickLaplaceMM._np_arrays`` of the JAX package (plain NumPy arrays) and a
dict of its static metadata (``_hn_bounds``, ``_flat_meta``, ``_n_sub``,
``_n_chainb``, ``_sub_contig``, ``_use_masked_removal``, ``_plane_meta``,
``_plane_levels``, ``N3``, ``N3p``, ``slot_idx``), derives the index maps
that replace the reference's one-hot operators (Es -> surface node list,
EsI -> interior fill nodes, EFX -> (cols position, exchange position)
pairs), carries the degree <= 3 schedule's tables over as they are (the
masked removal's quadrature operators and cell selectors, the face-plane
groups), and returns the port's ``BrickLaplaceMM``. It takes plain dicts,
so it imports nothing of the JAX package.

``matrix_free_from_reference(np_tables, n_dofs, hn_mode, categorize,
cell_permutation)`` takes the reference ``MatrixFree._np`` (NumPy: dofmaps,
masks, hn_idx, hn_masks, geo, S, D, Dc, P, quad_w, slow) with the reference's
``n_dofs``, ``categorize`` and ``cell_permutation``, checks the tables against
them, and returns the port's index engine on those tables, in the
reference's cell order (a categorized reference's permutation included);
``models.laplace.LaplaceOperator`` runs on it.
"""

from __future__ import annotations

import numpy as np
import torch

from .bricks import BrickLaplaceMM
from .matrix_free import MatrixFree

__all__ = ["from_reference", "matrix_free_from_reference", "reference_tables"]


def _one_hot_rows(M: np.ndarray) -> np.ndarray:
    """Column of the single 1 in each row of a 0/1 selection matrix."""
    M = np.asarray(M, dtype=np.float64)
    cols = np.argmax(M, axis=1)
    if not (np.all(M.sum(axis=1) == 1.0) and np.all(M[np.arange(len(M)), cols] == 1.0)):
        raise ValueError("expected a one-hot selection matrix")
    return cols.astype(np.int64)


def reference_tables(np_arrays: dict, meta: dict):
    """(arrays, meta) in the layout of ``bricks.operator_tables`` from the
    reference's host tables."""
    a = np_arrays
    if not meta["_sub_contig"]:
        raise NotImplementedError("the port needs the subset-first brick order")
    slot_idx = np.asarray(meta["slot_idx"], dtype=np.int64)
    C, n_loc = slot_idx.shape
    B = round(C ** (1.0 / 3.0))
    p = round(n_loc ** (1.0 / 3.0)) - 1
    NB = B * p + 1
    if B**3 != C or (p + 1) ** 3 != n_loc or NB**3 != meta["N3"]:
        raise ValueError("slot_idx does not describe a 3-D brick")
    f64 = lambda x: np.asarray(x, dtype=np.float64)
    i64 = lambda x: np.asarray(x, dtype=np.int64)
    surf_idx = _one_hot_rows(a["Es"])
    out = dict(
        Kb=f64(a["Kb"]), Mb=f64(a["Mb"]), K=f64(a["K"]), geo=f64(a["geo"]),
        geo_cell_sub=f64(a["geo_cell_sub"]), slot_idx=slot_idx,
        surf_idx=surf_idx, absent_sub=i64(a["absent_sub"]), hn_sub=i64(a["hn_sub"]),
        face_other=a["face_other"], edge_contrib=a["edge_contrib"],
        corner_contrib=a["corner_contrib"], node_valid=np.asarray(a["node_valid"], bool),
    )
    fm = meta["_flat_meta"]
    m = dict(B=B, p=p, NB=NB, N3=meta["N3"], N3p=meta["N3p"], n_sub=meta["_n_sub"],
             n_chainb=meta["_n_chainb"], assembled=bool(meta["_use_masked_removal"]),
             plane_meta=[dict(mm, offs=tuple(mm["offs"])) for mm in meta["_plane_meta"]],
             plane_levels=list(meta.get("_plane_levels", [])),
             hn_bounds=list(meta["_hn_bounds"]),
             fill_segs=[tuple(s) for s in fm.get("fill", {}).get("segs", [])],
             n_fill_tails=fm.get("fill", {}).get("n_tails", 0),
             corr_segs=[tuple(s) for s in fm.get("corr", {}).get("segs", [])],
             n_corr_tails=fm.get("corr", {}).get("n_tails", 0))
    for k in ("Sqb", "Dqb", "w1", "qmask_absent", "qmask_rem", "plane_P1"):
        if k in a:
            out[k] = f64(a[k])
    if m["plane_meta"]:
        out["plane_W"] = i64(a["plane_W"])
        for i in range(len(m["plane_meta"])):
            out.update({f"plane{i}_{k}": i64(a[f"plane{i}_{k}"]) for k in ("fine", "coarse")})
            out[f"plane{i}_cover"] = f64(a[f"plane{i}_cover"])
    if not len(out["hn_sub"]):
        return out, m

    out["keep_hn"] = f64(a["flat_cp_keep_hn"])
    out["hn_Q"] = (np.stack([f64(q) for q in a["hn_Q"]]) if len(a["hn_Q"])
                   else np.zeros((0, n_loc, n_loc)))
    for si, *_ in m["fill_segs"]:
        out[f"fill_T{si}"] = f64(a[f"flat_fill_T{si}"])
    for si, *_ in m["corr_segs"]:
        out[f"corr_T{si}"] = f64(a[f"flat_corr_T{si}"])
    out.update(
        fill_src=i64(a["flat_fill_src_all"]), fill_fix_idx=i64(a["flat_cp_fill_fix_idx"]),
        fill_fix_local=i64(a["flat_cp_fill_fix_local"]),
        fill_real_pos=i64(a["flat_cp_fill_real_pos"]),
        fill_dst_local=i64(a["flat_cp_fill_dst_local"]),
        corr_src=i64(a["flat_cp_corr_src_local"]), corr_hn_pos=i64(a["flat_cp_corr_hn_pos"]),
        corr_hn_dst=i64(a["flat_cp_corr_hn_dst_local"]),
        corr_nh_pos=i64(a["flat_cp_corr_nh_pos"]), corr_nh_dst=i64(a["flat_cp_corr_nh_dst"]),
    )
    for ti in range(m["n_fill_tails"]):
        out[f"fill_tail{ti}_T"] = f64(a[f"flat_fill_tail{ti}_T"])
        out[f"fill_tail{ti}_src"] = i64(a[f"flat_cp_fill_tail{ti}_src_local"])
        out[f"fill_tail{ti}_dst"] = i64(a[f"flat_cp_fill_tail{ti}_dst_local"])
    for ti in range(m["n_corr_tails"]):
        out[f"corr_tail{ti}_T"] = f64(a[f"flat_corr_tail{ti}_T"])
        out[f"corr_tail{ti}_src"] = i64(a[f"flat_cp_corr_tail{ti}_src_local"])
        for k in ("hn_pos", "nh_pos", "nh_dst"):
            out[f"corr_tail{ti}_{k}"] = i64(a[f"flat_cp_corr_tail{ti}_{k}"])
        out[f"corr_tail{ti}_hn_dst"] = i64(a[f"flat_cp_corr_tail{ti}_hn_dst_local"])

    # refill maps: exchange positions are the surface nodes, then EsI's
    # interior nodes; EFX's nonzeros pair a cols position with its position
    X_nodes = (_one_hot_rows(a["EsI"]) if np.asarray(a["EsI"]).shape[0]
               else np.zeros(0, np.int64))
    efx_src, efx_pos = np.nonzero(np.asarray(a["EFX"]))
    out.update(
        node_of_pos=np.concatenate([surf_idx, X_nodes]),
        efx_src=i64(efx_src), efx_pos=i64(efx_pos),
        fill_invden_X=f64(a["fill_invden_X"]),
    )
    return out, m


def from_reference(np_arrays: dict, meta: dict, device=None,
                   dtype=torch.float32) -> BrickLaplaceMM:
    """The port's operator (vmult, refill) from the reference's tables."""
    arrays, m = reference_tables(np_arrays, meta)
    return BrickLaplaceMM.from_tables(arrays, m, device, dtype)


def matrix_free_from_reference(np_tables: dict, n_dofs: int, hn_mode: str = "compact",
                               categorize: bool = False, cell_permutation=None) -> MatrixFree:
    """The port's index engine (``MatrixFree`` without a mesh) from the
    reference's ``MatrixFree._np``, ``n_dofs``, ``categorize`` and
    ``cell_permutation`` (None: the identity), with the runner hn_mode."""
    tables = {k: np_tables[k] for k in ("dofmap", "dofmap_plain", "masks", "hn_idx", "hn_masks",
                                        "geo", "S", "D", "Dc", "P", "quad_w")}
    tables = {k: np.asarray(v) for k, v in tables.items()}
    tables["slow"] = {k: np.asarray(v) for k, v in np_tables["slow"].items()}
    return MatrixFree.from_tables(tables, n_dofs, hn_mode, categorize, cell_permutation)
