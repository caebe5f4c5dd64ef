"""The PyTorch port's host setup (mesh, DoFs, constraints, brick structure,
operator tables) equals the JAX package's, table by table."""

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_port_cases import (  # noqa: E402
    CASES, IDS, port, port_tables, reference, reference_meta,
)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("geo,nref,p", CASES, ids=IDS)
def test_mesh_and_dofs(geo, nref, p):
    rt, rmf, _, _ = reference(geo, nref, p)
    pt, pmf, _ = port(geo, nref, p)
    _eq(pt.level, rt.level)
    _eq(pt.coord, rt.coord)
    _eq(pmf.dof_handler.cell_dofs, rmf.dof_handler.cell_dofs)
    assert pmf.n_dofs == rmf.n_dofs
    _eq(pmf._np["geo"], rmf._np["geo"])


@pytest.mark.parametrize("geo,nref,p", CASES, ids=IDS)
def test_constraints(geo, nref, p):
    rc = reference(geo, nref, p)[1].constraints
    pc = port(geo, nref, p)[1].constraints
    for name in ("masks", "cell_dofs_fast", "slave_dofs", "row_ptr", "col",
                 "face_neighbor", "edge_neighbor"):
        _eq(getattr(pc, name), getattr(rc, name))
    np.testing.assert_allclose(pc.weight, rc.weight, rtol=0, atol=1e-15)
    u = np.random.default_rng(3).standard_normal(rc.n_dofs)
    np.testing.assert_allclose(pc.distribute(u), rc.distribute(u), rtol=0, atol=1e-14)


@pytest.mark.parametrize("geo,nref,p", CASES, ids=IDS)
def test_brick_structure(geo, nref, p):
    rb = reference(geo, nref, p)[2].bs
    pb = port(geo, nref, p)[2].bs
    assert (pb.B, pb.NB, pb.n_bricks) == (rb.B, rb.NB, rb.n_bricks)
    for name in ("brick_level", "brick_coord", "cell_lin", "present", "node_dof",
                 "owner_node_of_dof", "dot_mask", "hn_lin", "hn_masks", "hn_closure",
                 "face_pool_id", "edge_pool_id", "corner_pool_id", "face_other",
                 "edge_contrib", "corner_contrib"):
        _eq(getattr(pb, name), getattr(rb, name))
    assert (pb.n_exc_bricks, pb.n_chain_bricks) == (rb.n_exc_bricks, rb.n_chain_bricks)


@pytest.mark.parametrize("geo,nref,p", CASES, ids=IDS)
def test_operator_tables(geo, nref, p):
    """hn/absent rows, HN mask ranges, fold segments with their T stacks,
    slot_idx and the surface node list: the one-hot operators of the
    reference become the port's index maps."""
    _, _, bl, _ = reference(geo, nref, p)
    a = bl._np_arrays
    t, m = port_tables(geo, nref, p)
    assert m == port(geo, nref, p)[2]._meta
    _eq(t["slot_idx"], bl.slot_idx)
    _eq(t["surf_idx"], np.argmax(a["Es"], axis=1))
    E = np.zeros_like(a["E"])
    E[np.arange(E.shape[0]), t["slot_idx"].reshape(-1)] = 1.0
    _eq(E, a["E"])
    for name in ("Kb", "Mb", "K", "geo", "geo_cell_sub", "absent_sub", "hn_sub",
                 "node_valid"):
        _eq(t[name], a[name])
    _eq(t["keep_hn"], a["flat_cp_keep_hn"])
    _eq(t["hn_Q"], np.stack(a["hn_Q"]))
    assert m["hn_bounds"] == bl._hn_bounds
    assert m["n_sub"] == bl._n_sub
    for d in ("fill", "corr"):
        assert m[f"{d}_segs"] == bl._flat_meta[d]["segs"]
        assert m[f"n_{d}_tails"] == bl._flat_meta[d]["n_tails"]
        for si, *_ in m[f"{d}_segs"]:
            _eq(t[f"{d}_T{si}"], a[f"flat_{d}_T{si}"])
        for ti in range(m[f"n_{d}_tails"]):
            _eq(t[f"{d}_tail{ti}_T"], a[f"flat_{d}_tail{ti}_T"])
    _eq(t["fill_src"], a["flat_fill_src_all"])
    _eq(t["corr_src"], a["flat_cp_corr_src_local"])
    # the refill maps reproduce EFX and EsI
    EFX = np.zeros_like(a["EFX"])
    EFX[t["efx_src"], t["efx_pos"]] = 1.0
    _eq(EFX, a["EFX"])
    _eq(t["node_of_pos"][len(t["surf_idx"]):], np.argmax(a["EsI"], axis=1))
    _eq(t["fill_invden_X"], a["fill_invden_X"])


@pytest.mark.parametrize("geo,nref,p", CASES, ids=IDS)
def test_reference_tables_equal_own_setup(geo, nref, p):
    """convert.reference_tables derives exactly the port's own tables from
    the reference engine's host arrays."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.convert import reference_tables

    bl = reference(geo, nref, p)[2]
    own, own_meta = port_tables(geo, nref, p)
    arrays, meta = reference_tables(bl._np_arrays, reference_meta(bl))
    assert meta == own_meta
    assert sorted(arrays) == sorted(own)
    for k, v in arrays.items():
        _eq(v, own[k])
