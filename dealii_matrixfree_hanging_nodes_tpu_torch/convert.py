"""Build the port's operators from the reference engines' host tables.

``from_reference(np_arrays, meta, device, dtype)`` takes
``BrickLaplaceMM._np_arrays`` of the JAX package (plain NumPy arrays) and a
dict of its static metadata (``_hn_bounds``, ``_flat_meta``, ``_n_sub``,
``_n_chainb``, ``_sub_contig``, ``_use_masked_removal``, ``_plane_meta``,
``_plane_levels``, ``N3``, ``N3p``, ``slot_idx``, and ``_deformed`` under a
deformed mapping), derives the index maps that replace the reference's
one-hot operators (Es -> surface node list, EsI -> interior fill nodes, EFX
-> (cols position, exchange position) pairs), carries the degree <= 3
schedule's tables over as they are (the masked removal's quadrature
operators and cell selectors, the face-plane groups), reads a deformed
mapping's metric back from the brick-quad lattice ``Gqb`` into brick-cell
rows (checked against ``Gq_sub`` and ``Gq_hn``), and returns the port's
``BrickLaplaceMM``. It takes plain dicts,
so it imports nothing of the JAX package.

``matrix_free_from_reference(np_tables, n_dofs, hn_mode, categorize,
cell_permutation)`` takes the reference ``MatrixFree._np`` (NumPy: dofmaps,
masks, hn_idx, hn_masks, geo, S, D, Dc, P, quad_w, slow) with the reference's
``n_dofs``, ``categorize`` and ``cell_permutation``, checks the tables against
them, and returns the port's index engine on those tables, in the
reference's cell order (a categorized reference's permutation included);
``models.laplace.LaplaceOperator`` runs on it.

``brick_elasticity_from_reference(np_arrays, meta, mu, lam, device, dtype)``
takes the reference ``BrickElasticity.mm._np_arrays`` and the same metadata
as ``from_reference`` (of its scalar engine ``BrickElasticity.mm``) and
returns the port's ``BrickElasticity`` on those tables, with the per-cell
schedule at every degree. ``elasticity_from_reference(np_tables, n_dofs, mu,
lam, constraints, device)`` takes what ``matrix_free_from_reference`` takes
and returns the port's index-engine ``ElasticityOperator`` on it.

``transfer_from_reference(tables, mf_coarse, device, dtype)`` carries a
reference GMG transfer's host tables across (NumPy): a ``BrickTransfer``'s
(``src_lin``, ``E_rows``, ``own_w``, the fine dot mask ``wf`` and the coarse
``DofEmbed`` tables) gives the port's ``BrickTransfer``, a ``Transfer``'s
(``cover``, ``E``, ``own_mask``, ``cdf``) the port's ``Transfer`` on the
coarse level's index engine ``mf_coarse``.
"""

from __future__ import annotations

import numpy as np
import torch

from .bricks import BrickLaplaceMM
from .matrix_free import MatrixFree
from .models.elasticity import ElasticityOperator
from .models.elasticity_bricks import BrickElasticity
from .models.multigrid import Transfer
from .models.multigrid_bricks import BrickTransfer, DofEmbed

__all__ = ["brick_elasticity_from_reference", "elasticity_from_reference", "from_reference",
           "matrix_free_from_reference", "reference_tables", "transfer_from_reference"]


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
    B, p, dim = _brick_shape(slot_idx, int(meta["N3"]))
    NB = B * p + 1
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
    m = dict(B=B, p=p, dim=dim, NB=NB, N3=meta["N3"], N3p=meta["N3p"], n_sub=meta["_n_sub"],
             n_chainb=meta["_n_chainb"], assembled=bool(meta["_use_masked_removal"]),
             plane_meta=[dict(mm, offs=tuple(mm["offs"])) for mm in meta["_plane_meta"]],
             plane_levels=list(meta.get("_plane_levels", [])),
             hn_bounds=list(meta["_hn_bounds"]),
             fill_segs=[tuple(s) for s in fm.get("fill", {}).get("segs", [])],
             n_fill_tails=fm.get("fill", {}).get("n_tails", 0),
             corr_segs=[tuple(s) for s in fm.get("corr", {}).get("segs", [])],
             n_corr_tails=fm.get("corr", {}).get("n_tails", 0))
    m["deformed"] = bool(meta.get("_deformed", False))
    if m["deformed"]:
        out.update(metric=_cell_metric(a, B, p, m["n_sub"], dim), S=f64(a["S"]),
                   Dc=f64(a["Dc"]))
    else:
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


def _brick_shape(slot_idx, N3):
    """(B, p, dim) of the bricks whose per-slot node index is slot_idx
    [B^dim, (p+1)^dim] (cell slots and local nodes x fastest, NB = B p + 1)
    with N3 = NB^dim nodes a brick: the one dim in (2, 3) whose B and p
    rebuild slot_idx exactly; raises where none or both do."""
    C, n_loc = slot_idx.shape
    found = []
    for dim in (2, 3):
        B, n = round(C ** (1.0 / dim)), round(n_loc ** (1.0 / dim))
        p, NB = n - 1, B * (n - 1) + 1
        if B**dim != C or n**dim != n_loc or p < 1 or NB**dim != N3:
            continue
        cell = lambda i, w: [(i // w**a) % w for a in range(dim)]
        node = sum((np.asarray(cell(np.arange(C), B))[a][:, None] * p
                    + np.asarray(cell(np.arange(n_loc), n))[a][None, :]) * NB**a
                   for a in range(dim))
        if np.array_equal(node, slot_idx):
            found.append((B, p, dim))
    if len(found) != 1:
        raise ValueError(f"slot_idx {slot_idx.shape} with N3={N3} describes no 2-D or 3-D brick")
    return found[0]


def _cell_metric(a, B, p, n_sub, dim):
    """The metric in brick-cell rows [n_bricks*B^dim, n_q, n_pairs] (the
    reference's ``Gfull``; n_pairs 6 in 3-D, 3 in 2-D) from its brick-quad
    lattice ``Gqb`` [nb, n_pairs, Q, Q, Q] (2-D: [nb, 3, Q, Q]; Q = B (p+1),
    the axis index along d is c_d (p+1) + q_d, bricks.py:1944-1956),
    checked against the subset's rows ``Gq_sub`` and the constrained rows
    ``Gq_hn`` (at ``hn_sub``)."""
    G = np.asarray(a["Gqb"], dtype=np.float64)
    nb, n, n_pairs = G.shape[0], p + 1, G.shape[1]
    if dim == 3:
        G = G.reshape(nb, n_pairs, B, n, B, n, B, n).transpose(0, 2, 4, 6, 3, 5, 7, 1)
    else:
        G = G.reshape(nb, n_pairs, B, n, B, n).transpose(0, 2, 4, 3, 5, 1)
    metric = np.ascontiguousarray(G.reshape(nb * B**dim, n**dim, n_pairs))
    hn_sub = np.asarray(a["hn_sub"], dtype=np.int64)
    if not (np.array_equal(metric[: n_sub * B**dim], np.asarray(a["Gq_sub"], dtype=np.float64))
            and np.array_equal(metric[hn_sub], np.asarray(a["Gq_hn"], dtype=np.float64))):
        raise ValueError("the brick-quad metric Gqb disagrees with Gq_sub or Gq_hn")
    return metric


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


def brick_elasticity_from_reference(np_arrays: dict, meta: dict, mu: float = 1.0,
                                    lam: float = 1.0, device=None,
                                    dtype=torch.float32) -> BrickElasticity:
    """The port's brick elasticity (vmult, vmult_plain) from the reference's
    ``BrickElasticity.mm`` tables and metadata."""
    arrays, m = reference_tables(np_arrays, meta)
    return BrickElasticity.from_tables(arrays, m, mu, lam, device, dtype)


def elasticity_from_reference(np_tables: dict, n_dofs: int, mu: float = 1.0, lam: float = 1.0,
                              constraints: bool = True, device=None,
                              **kw) -> ElasticityOperator:
    """The port's index-engine elasticity on ``matrix_free_from_reference``
    of the reference's ``MatrixFree._np`` and ``n_dofs`` (kw: its hn_mode,
    categorize, cell_permutation)."""
    mf = matrix_free_from_reference(np_tables, n_dofs, **kw)
    return ElasticityOperator(mf, mu, lam, constraints, device)


def transfer_from_reference(tables: dict, mf_coarse: MatrixFree | None = None, device=None,
                            dtype=torch.float64):
    """The port's GMG transfer from a reference transfer's host tables.

    Brick (a ``BrickTransfer``): src_lin, E_rows, own_w (its ``_dev``), wf
    (``mm_f.dot_mask()``), the coarse DofEmbed's valid_idx, valid_dof, slave,
    row, col, w, owner (its ``_sc``), and n_dofs_c, n_bricks_c, B, N3, N3p.
    Index (a ``Transfer``): cover, E, own_mask, cdf and n_fine_dofs, with the
    port's coarse index engine mf_coarse (e.g. ``matrix_free_from_reference``
    of the reference's coarse ``MatrixFree._np``)."""
    t = {k: (v if np.isscalar(v) else np.asarray(v)) for k, v in tables.items()}
    if "src_lin" not in t:
        if mf_coarse is None:
            raise ValueError("an index transfer needs the coarse MatrixFree")
        return Transfer.from_tables(
            mf_coarse, dict(cover=t["cover"], E=t["E"], own=t["own_mask"], cdf=t["cdf"]),
            int(t["n_fine_dofs"]), device, dtype)
    n_c, N3, N3p = int(t["n_dofs_c"]), int(t["N3"]), int(t["N3p"])
    nb_c = int(t["n_bricks_c"])
    node_dof = np.full(nb_c * N3, -1, dtype=np.int64)
    node_dof[t["valid_idx"].astype(np.int64)] = t["valid_dof"]
    row = t["row"].astype(np.int64)
    row_ptr = np.zeros(len(t["slave"]) + 1, dtype=np.int64)
    np.cumsum(np.bincount(row, minlength=len(t["slave"])), out=row_ptr[1:])
    embed_c = DofEmbed.from_tables(node_dof, t["slave"], row_ptr, t["col"], t["w"], t["owner"],
                                   n_c, N3, N3p, device, dtype)
    wf = np.asarray(t["wf"])
    return BrickTransfer.from_tables(
        dict(src_lin=t["src_lin"], E_rows=t["E_rows"], own_w=t["own_w"],
             wf=wf.reshape(wf.shape[0], -1)[:, :N3]),
        embed_c, int(t["B"]), nb_c, N3, device, dtype)
