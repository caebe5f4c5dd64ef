"""The PyTorch port's brick engine in 2-D against the JAX package's
BrickLaplaceMM, in float64 on the CPU: the brick structure, the operator
tables and ``convert.from_reference``, vmult, vmult_plain, refill and the
DoF-vector round trip at the reference's 2-D cases (tests/test_bricks.py:
test_brick_mm_2d, the face planes at quadrant nref=5 p=3, vmult_plain ==
vmult on uniform nref=3 p=4) and at quadrant nref=4 p=3, 4 (the masked
removal and the per-cell schedule), vmult_multi, each kernel's plain
version against the reference function it replaces at one case a (p, B)
class, and every 2-D mask code alone through hn_cell's plain version. The
same inputs, made with numpy from a seed, go through both, to 1e-12
relative.

2-D bricks are B^2 cells of NB^2 nodes (B = 16 at p <= 3, 8 at p = 4..6):
the operator is Mb⊗Kb + Kb⊗Mb, the surface is 4 side lines and 4 corners
(no edge pools), the masked removal has 4 parity classes."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dealii_matrixfree_hanging_nodes_tpu as ref  # noqa: E402
import dealii_matrixfree_hanging_nodes_tpu_torch as mt  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.ops import hanging_nodes as ref_hn  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import (  # noqa: E402
    auto_brick_size, kernel_tables, kronecker_sum, q_lists,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (  # noqa: E402
    brick_apply, cell_apply, dss_surface, hn_cell, masked_quad, plane_fill, plane_fold,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.ops.hanging_nodes import (  # noqa: E402
    hn_composite_matrix,
)
from torch_port_cases import (  # noqa: E402, F401
    RTOL, one_torch_thread, port, port_tables, reference, reference_meta, rel_err, rng_array,
    release_module_memory,
)

DIM = 2
# (geometry, nref, degree, face_planes): the reference's test_brick_mm_2d cases, its face-plane
# case, and quadrant nref=4 at p=3 (masked removal) and p=4 (per-cell schedule)
CASES = [
    ("quadrant", 3, 2, None), ("step", 3, 1, None), ("uniform", 2, 2, None),
    ("quadrant", 3, 5, None), ("quadrant", 2, 6, None),
    ("quadrant", 5, 3, True), ("quadrant", 4, 3, None), ("quadrant", 4, 4, None),
]
IDS = [f"{g}-{n}-p{p}" + ("-planes" if f else "") for g, n, p, f in CASES]
case = pytest.mark.parametrize("geo,nref,p,fp", CASES, ids=IDS)
# one case a (p, B) class, for the kernels' plain versions: B = 16 at p = 1..3, 8 at p = 4..6;
# quadrant nref=6 p=1 has face planes (by default) with covered cells
CLASS_CASES = [("quadrant", 6, 1, None), ("quadrant", 3, 2, None), ("quadrant", 4, 3, None),
               ("quadrant", 4, 4, None), ("quadrant", 3, 5, None), ("quadrant", 2, 6, None)]
CLASS_IDS = [f"p{c[2]}" for c in CLASS_CASES]
per_class = pytest.mark.parametrize("geo,nref,p,fp", CLASS_CASES, ids=CLASS_IDS)
PLANE_CASES = [("quadrant", 6, 1, None), ("quadrant", 5, 3, True)]
planes = pytest.mark.parametrize("geo,nref,p,fp", PLANE_CASES,
                                 ids=["quadrant-6-p1", "quadrant-5-p3-planes"])
MULTI_CASES = [("quadrant", 3, 2, False), ("quadrant", 4, 3, None), ("quadrant", 4, 4, None),
               ("quadrant", 3, 5, None)]
T = torch.from_numpy


def _pair(geo, nref, p, fp):
    """(reference BrickLaplaceMM, its staged arrays, the port's operator)."""
    _, _, bl, a = reference(geo, nref, p, fp, DIM)
    return bl, a, port(geo, nref, p, fp, DIM)[2]


def _vectors(geo, nref, p, fp, seed):
    """(reference operator, port operator, port brick vector, reference's) of
    one seeded DoF vector."""
    bl, _, op = _pair(geo, nref, p, fp)
    u = rng_array(seed, op.mf.n_dofs)
    return bl, op, op.from_dof_vector(u), bl.from_dof_vector(u)


# ---- setup --------------------------------------------------------------------------
@case
def test_brick_structure_matches_reference(geo, nref, p, fp):
    """The 2-D brick structure (no edge closure, no edge pools, 4 face and
    4 corner pools a brick, the face planes) against the reference's arrays."""
    _, _, bl, _ = reference(geo, nref, p, fp, DIM)
    rb, pb = bl.bs, port(geo, nref, p, fp, DIM)[2].bs
    assert (pb.dim, pb.B, pb.NB, pb.n_bricks) == (DIM, rb.B, rb.NB, rb.n_bricks)
    assert pb.B == auto_brick_size(p, DIM) == (16 if p <= 3 else 8)
    for name in ("brick_level", "brick_coord", "cell_lin", "present", "node_dof",
                 "owner_node_of_dof", "dot_mask", "hn_lin", "hn_masks", "hn_closure",
                 "face_pool_id", "edge_pool_id", "corner_pool_id", "face_other",
                 "edge_contrib", "corner_contrib", "plane_covered"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(rb, name), err_msg=name)
    assert pb.edge_pool_id.shape == (pb.n_bricks, 0) and pb.face_pool_id.shape[1] == 4
    assert (pb.n_exc_bricks, pb.n_chain_bricks) == (rb.n_exc_bricks, rb.n_chain_bricks)
    assert len(pb.plane_groups) == len(rb.plane_groups)
    for g, rg in zip(pb.plane_groups, rb.plane_groups):
        for k in ("level", "d", "s", "c_pl", "offs"):
            assert g[k] == rg[k], k
        for k in ("fine", "coarse", "cover"):
            np.testing.assert_array_equal(g[k], rg[k], err_msg=k)


@case
def test_operator_tables_and_from_reference(geo, nref, p, fp):
    """convert.reference_tables reads B, p and dim off the reference's 2-D
    slot_idx and derives exactly the port's own tables; the operator it
    builds runs vmult, vmult_plain and refill as the port's own does."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.convert import from_reference, reference_tables

    bl, op, bv, _ = _vectors(geo, nref, p, fp, 1)
    own, own_meta = port_tables(geo, nref, p, fp, DIM)
    arrays, meta = reference_tables(bl._np_arrays, reference_meta(bl))
    assert meta == own_meta and meta["dim"] == DIM and meta["B"] == op.B
    assert sorted(arrays) == sorted(own)
    for k, v in arrays.items():
        np.testing.assert_array_equal(v, own[k], err_msg=k)
    conv = from_reference(bl._np_arrays, reference_meta(bl), device="cpu", dtype=torch.float64)
    assert (conv.dim, conv.C, conv.n_loc) == (DIM, op.B**2, (p + 1) ** 2)
    for fn in ("vmult", "vmult_plain", "refill"):
        assert rel_err(getattr(conv, fn)(bv), getattr(op, fn)(bv)) < RTOL, fn


def test_host_lists_check_what_they_derive():
    """The 2-D tables' own checks: a K that is not the 2-D Kronecker sum of
    the brick factors' cell blocks, a corner list that does not partition
    the copies, an edge pool on a 2-D brick, and a 3-D-shaped cell selector
    raise."""
    t, m = port_tables("quadrant", 4, 3, None, DIM)
    assert m["dim"] == DIM
    kernel_tables(t, m)
    with pytest.raises(ValueError, match="Kronecker sum"):
        kernel_tables(dict(t, K=t["K"] * (1.0 + 1e-9)), m)
    cc = np.array(t["corner_contrib"])
    cc[0] = cc[1]
    with pytest.raises(ValueError, match="corner"):
        kernel_tables(dict(t, corner_contrib=cc), m)
    with pytest.raises(ValueError, match="edge"):
        kernel_tables(dict(t, edge_contrib=np.zeros((4, 1), dtype=np.int32)), m)
    with pytest.raises(ValueError, match="qmask"):
        kernel_tables(dict(t, qmask_rem=np.zeros((m["n_sub"], m["B"] ** 3))), m)


# ---- the operator -------------------------------------------------------------------
@case
def test_vmult_matches_reference(geo, nref, p, fp):
    bl, op, bv, rb = _vectors(geo, nref, p, fp, 10)
    np.testing.assert_array_equal(bv.numpy(), np.asarray(rb))
    assert op.assembled == (p <= 3) and op.planes == bool(bl._plane_meta)
    assert bl._face_planes == (p <= 2 if fp is None else fp)
    assert rel_err(op.vmult(bv), np.asarray(bl.vmult(rb))) < RTOL


@case
def test_vmult_plain_matches_reference(geo, nref, p, fp):
    bl, op, bv, rb = _vectors(geo, nref, p, fp, 11)
    assert rel_err(op.vmult_plain(bv), np.asarray(bl.vmult_plain(rb))) < RTOL


@case
def test_refill_and_round_trip(geo, nref, p, fp):
    """refill of a vmult output against the reference's, and the DoF-vector
    round trip it restores (the reference's test_brick_mm_2d)."""
    bl, op, bv, _ = _vectors(geo, nref, p, fp, 12)
    out = op.vmult(bv)
    base = op.refill(out)
    assert rel_err(base, np.asarray(bl.refill(jnp.asarray(out.numpy())))) < RTOL
    out2 = op.from_dof_vector(op.to_dof_vector(out))
    assert float((base - out2).abs().max()) < RTOL * max(1.0, float(base.abs().max()))


@case
def test_vmult_matches_index_engine(geo, nref, p, fp):
    """to_dof_vector(vmult, zero_hanging=True) against the port's own 2-D
    index engine and the reference's index engine (the hanging rows zero)."""
    from dealii_matrixfree_hanging_nodes_tpu.models.laplace import LaplaceOperator as RefLaplace

    _, rmf, _, _ = reference(geo, nref, p, fp, DIM)
    _, mf, op = port(geo, nref, p, fp, DIM)
    u = rng_array(13, mf.n_dofs)
    got = op.to_dof_vector(op.vmult(op.from_dof_vector(u)), zero_hanging=True).numpy()
    idx = mt.LaplaceOperator(mf, device="cpu").vmult(u).numpy()
    assert rel_err(got, idx) < RTOL
    assert rel_err(got, np.asarray(RefLaplace(rmf).vmult(jnp.asarray(u)))) < RTOL


def test_face_planes_match_per_cell_schedule():
    """The face-plane case (quadrant nref=5 p=3, covered cells) equals the
    same operator without planes, as the reference's face-plane test
    holds it."""
    _, op, bv, _ = _vectors("quadrant", 5, 3, True, 14)
    assert op.planes and op.bs.plane_covered.sum() > 0
    plain_op = port("quadrant", 5, 3, False, DIM)[2]
    assert not plain_op.planes
    assert rel_err(op.to_dof_vector(op.vmult(bv), zero_hanging=True),
                   plain_op.to_dof_vector(plain_op.vmult(bv), zero_hanging=True)) < RTOL


def test_vmult_plain_equals_vmult_on_uniform():
    """No hanging nodes (uniform nref=3 p=4): vmult_plain is vmult, as the
    reference's test holds it."""
    _, op, bv, _ = _vectors("uniform", 3, 4, None, 15)
    assert op.n_hn == 0
    a, b = op.vmult(bv), op.vmult_plain(bv)
    assert float((a - b).abs().max()) <= RTOL * float(a.abs().max())


@pytest.mark.parametrize("geo,nref,p,fp", MULTI_CASES, ids=[f"p{c[2]}" for c in MULTI_CASES])
def test_vmult_multi_matches_reference(geo, nref, p, fp):
    """vmult_multi at k=3 against the reference's, each RHS bit-identical to
    vmult of it."""
    bl, op, _, _ = _vectors(geo, nref, p, fp, 16)
    rng = np.random.default_rng(17)
    vs = [op.mf.constraints.distribute(rng.standard_normal(op.mf.n_dofs)) for _ in range(3)]
    bvk = torch.stack([op.from_dof_vector(v) for v in vs])
    got = op.vmult_multi(bvk)
    want = np.asarray(bl.vmult_multi(jnp.stack([bl.from_dof_vector(v) for v in vs])))
    assert rel_err(got, want) < RTOL
    for j in range(3):
        assert torch.equal(got[j], op.vmult(bvk[j].clone())), j


# ---- the kernels' plain versions against the reference functions ----------------------
@per_class
def test_brick_apply_plain(geo, nref, p, fp):
    """The 2-D main apply times geo (_main_apply, bricks.py:2340-2347), and
    with the subset's cell rows overlap-added (_scatter_cols)."""
    bl, a, op = _pair(geo, nref, p, fp)
    bv = rng_array(20, op.n_bricks, op.N3p)
    main = bl._main_apply(jnp.asarray(bv), a) * a["geo"][:, None]
    got = brick_apply.brick_apply(T(bv), *op.brick_factors_host, op.geo, op.p)
    assert rel_err(got, main) < RTOL
    assert rel_err(brick_apply.brick_apply(T(bv), op.Kb, op.Mb, op.geo, op.p), main) < RTOL
    m = op.n_sub
    dcols = rng_array(21, m * op.C, op.n_loc)
    ref_out = main.at[:m].add(bl._scatter_cols(jnp.asarray(dcols), a))
    got = brick_apply.brick_apply(T(bv), *op.brick_factors_host, op.geo, op.p, dcols=T(dcols),
                                  brick_size=op.B)
    assert rel_err(got, ref_out) < RTOL


@pytest.mark.parametrize("p", range(1, 7))
def test_bound_and_overlap_index_read_dim_from_rows(p):
    """brick_apply's bound and overlap-add index read the dimension from
    the row width: a 2-D row of NB^2 nodes (padded to 128) counts NB^2
    nodes and 4 sweeps, and indexes B^2 cells of (p+1)^2 nodes."""
    B = auto_brick_size(p, DIM)
    NB = B * p + 1
    N3p = (NB**2 + 127) // 128 * 128
    nb, m, k = 7, 3, 2
    nbytes, flops = brick_apply.bytes_and_flops(nb, NB, p, N3p, 8, m, k)
    nnz = len(brick_apply.factor_structure(NB, p)[0])
    rows = m * B**2 * (p + 1) ** 2
    assert nbytes == (k * (nb * NB**2 + nb * N3p + rows) + 2 * nnz + nb) * 8
    assert flops == k * ((4 * 2 * nnz * NB + NB**2) * nb + rows)
    idx = brick_apply.overlap_add_index(m, B, p, N3p)
    assert idx.numel() == rows
    assert torch.equal(idx[: B**2 * (p + 1) ** 2],
                       cell_apply.brick_slot_index(B, p, dim=DIM).reshape(-1))


@per_class
def test_dss_surface_plain(geo, nref, p, fp):
    """dss_surface (side lines and corners, no edges) against _dss_fill's
    input-fill branch (_dss_surface, bricks.py:2096-2136), in place."""
    bl, a, op = _pair(geo, nref, p, fp)
    v = rng_array(22, op.n_bricks, op.N3p)
    assert op.dss_edge_pools.shape[0] == 0
    vt = T(v.copy())
    got = dss_surface.dss_surface(vt, *op.dss_tables())
    assert got is vt
    assert rel_err(got, bl._dss_fill(jnp.asarray(v), a, None)) < RTOL


@per_class
def test_dss_work_lists_cover_the_surface(geo, nref, p, fp):
    """Every surface copy of every 2-D brick lies in exactly one pool entry
    and its validity bit is node_valid there; the nodes the bound counts as
    written are exactly those the function changes."""
    op = _pair(geo, nref, p, fp)[2]
    nb, N3p, NB = op.n_bricks, op.N3p, op.NB
    node_valid = T(port_tables(geo, nref, p, fp, DIM)[0]["node_valid"]).reshape(-1)
    hits = torch.zeros(nb * N3p, dtype=torch.int64)
    for pools, kind in zip(op.dss_tables()[:3], dss_surface.POOL_KINDS):
        b, s, node, real = dss_surface.pool_positions(pools, kind, NB, N3p)
        hits.index_add_(0, node[real].reshape(-1), torch.ones_like(node[real]).reshape(-1))
        assert torch.equal(dss_surface.bit_set(op.dss_valid_bits, b[..., None], s)[real],
                           node_valid[node[real]])
    surf = T(dss_surface.surface_nodes(NB, DIM))
    assert len(surf) == 4 * (NB - 2) + 4
    on_surface = torch.zeros(N3p, dtype=torch.int64)
    on_surface[surf] = 1
    assert torch.equal(hits.reshape(nb, N3p), on_surface.expand(nb, N3p))
    v = T(rng_array(23, nb, N3p))
    (read, _), (written, _) = dss_surface.moved_nodes(v, *op.dss_tables())
    changed = torch.nonzero(dss_surface.dss_surface(v.clone(), *op.dss_tables()).reshape(-1)
                            != v.reshape(-1))[:, 0]
    assert torch.equal(torch.sort(written).values, changed)
    assert torch.isin(read, written).all()


@per_class
def test_cell_factors_and_cell_apply(geo, nref, p, fp):
    """K1, M1 give the 2-D K as their Kronecker sum; cell_apply's plain
    version from the bricks (p >= 4) and on rows against _extract_cols @ K^T
    times geo."""
    bl, a, op = _pair(geo, nref, p, fp)
    K = np.asarray(a["K"])
    assert K.shape == ((p + 1) ** 2,) * 2
    assert np.abs(kronecker_sum(op.K1.numpy(), op.M1.numpy(), DIM) - K).max() <= 1e-13 * np.abs(
        K).max()
    rows = rng_array(24, op.n_hn, op.n_loc)
    want = jnp.dot(jnp.asarray(rows), a["K"].T) * jnp.take(a["geo_cell_sub"], a["hn_sub"])[:, None]
    assert rel_err(cell_apply.cell_apply_plain(T(rows), op.K1, op.M1, op.geo_hn), want) < RTOL
    u_sub = rng_array(25, op.n_sub, op.N3p)
    want = jnp.dot(bl._extract_cols(jnp.asarray(u_sub), a), a["K"].T) * a["geo_cell_sub"][:, None]
    got = cell_apply.cell_apply(T(u_sub), op.K1, op.M1, op.geo_cell_sub, brick_size=op.B)
    assert got.shape == want.shape and rel_err(got, want) < RTOL


@per_class
def test_fill_and_corr_chains(geo, nref, p, fp):
    """The fill chain (_fill_hn_compact, then _fill_rows) and the corr chain
    (_corr_compact) on the 2-D constrained rows, and the HN application
    both ways (_hn_apply)."""
    bl, a, op = _pair(geo, nref, p, fp)
    u_sub = rng_array(26, op.n_sub, op.N3p)
    cols = bl._extract_cols(jnp.asarray(u_sub), a)
    assert rel_err(op._fill_hn_compact(T(u_sub)), bl._fill_hn_compact(cols, a)) < RTOL
    assert rel_err(op._fill_rows(T(u_sub)), bl._fill_rows(cols, a)) < RTOL
    rows = rng_array(27, op.n_hn, op.n_loc)
    for transpose in (False, True):
        assert rel_err(op._hn_apply(T(rows), transpose),
                       bl._hn_apply(jnp.asarray(rows), a, transpose=transpose)) < RTOL
    if op.assembled:  # the chain bricks' folded rows alone (plain_rows=None)
        want = bl._corr_compact(None, None, jnp.asarray(rows), a)
        assert rel_err(op._corr_compact(None, T(rows)), want) < RTOL
    else:
        plain = rng_array(28, op.n_sub * op.C, op.n_loc)
        hn = np.asarray(a["hn_sub"])
        want = bl._corr_compact(jnp.asarray(plain), jnp.asarray(plain[hn]), jnp.asarray(rows), a)
        assert rel_err(op._corr_compact(T(plain), T(rows)), want) < RTOL


@pytest.mark.parametrize("geo,nref,p,fp", CLASS_CASES[:3], ids=CLASS_IDS[:3])
def test_masked_quad_plain(geo, nref, p, fp):
    """masked_quad's plain version on its 4-class cell lists against
    -_masked_quad_apply (bricks.py:3169-3244) on the geo-premultiplied
    masks, for the absent and constrained cells and the absent cells."""
    bl, a, op = _pair(geo, nref, p, fp)
    bv = T(rng_array(29, op.n_bricks, op.N3p))
    u_sub = jnp.asarray(bv[: op.n_sub].numpy())
    for kind in ("rem", "absent"):
        brick, ptr, slot = op.masked_tables(kind)
        assert ptr.shape == (brick.shape[0], 5)
        want = -np.asarray(bl._masked_quad_apply(u_sub, a, a[f"qmask_{kind}"]))
        got = masked_quad.masked_quad(torch.zeros_like(bv), bv, brick, ptr, slot, op.K1, op.M1,
                                      op.geo, op.B)
        assert not got[op.n_sub:].any()
        assert rel_err(got[: op.n_sub], want) < RTOL, kind


@planes
def test_plane_fill_and_fold_plain(geo, nref, p, fp):
    """plane_fill's and plane_fold's plain versions on the host-composed 2-D
    tables (1-D P1 on a side line) against _plane_fill and _plane_corr."""
    bl, a, op = _pair(geo, nref, p, fp)
    assert op.planes and op.bs.plane_covered.sum() > 0
    x = T(rng_array(30, op.n_bricks, op.N3p))
    x[:, op.N3:] = 0.0
    x0 = x.clone()
    filled = plane_fill.plane_fill(x, *op.plane_fill_tables())
    assert torch.equal(x, x0)
    assert rel_err(filled, np.asarray(bl._plane_fill(jnp.asarray(x.numpy()), a))) < RTOL
    folded = plane_fold.plane_fold(x.clone(), *op.plane_fold_tables())
    assert rel_err(folded, np.asarray(bl._plane_corr(jnp.asarray(x.numpy()), a))) < RTOL
    assert not folded.view(-1)[op.plane_cov.long()].any()


@pytest.mark.parametrize("code", range(16))
def test_each_mask_code_through_hn_cell(code):
    """One 2-D code (sub bits 0-1, face bits 2-3) alone, p = 1..6: hn_cell's
    plain version on a one-row table (the cell at slot 0 of one brick, no
    fill entries) against the reference's apply_hanging_node_constraints:
    the fill mode gives its forward interpolation, the full mode Q^T (geo K
    Q u)."""
    for p in range(1, 7):
        B, n = auto_brick_size(p, DIM), p + 1
        NB, n_loc = B * p + 1, n * n
        N3p = (NB * NB + 127) // 128 * 128
        P = ref.shape_info(p).P
        Q = hn_composite_matrix(code, np.asarray(P), DIM)
        lists = {k: T(v) for k, v in q_lists(Q[None]).items()}
        u_sub = T(rng_array(100 * code + p, 1, N3p))
        vals = u_sub[0, cell_apply.brick_slot_index(B, p, dim=DIM)[0]].numpy()[None]
        i32 = lambda *x: torch.tensor(x, dtype=torch.int32)
        tables = (i32(0), torch.ones(1, n_loc, dtype=torch.bool), i32(0, 0), i32(), i32(),
                  i32(0), lists["hn_fwd_ptr"], lists["hn_fwd_col"], lists["hn_fwd_w"],
                  lists["hn_bwd_ptr"], lists["hn_bwd_col"], lists["hn_bwd_w"])
        masks = np.array([code], dtype=np.int32)
        fwd = ref_hn.apply_hanging_node_constraints(vals, masks, P, DIM, False)
        got = hn_cell.hn_cell(u_sub, *tables, None, None, None, B, mode="fill")
        assert rel_err(got, fwd) < RTOL, p
        si = ref.shape_info(p)
        K1 = np.einsum("q,qi,qj->ij", si.quad_w, si.D, si.D)
        M1 = np.einsum("q,qi,qj->ij", si.quad_w, si.S, si.S)
        own = np.asarray(fwd) @ (np.kron(M1, K1) + np.kron(K1, M1)).T * 0.5
        want = ref_hn.apply_hanging_node_constraints(own, masks, P, DIM, True)
        got = hn_cell.hn_cell(u_sub, *tables, T(K1), T(M1), torch.tensor([0.5], dtype=torch.float64),
                              B, mode="full")
        assert rel_err(got, want) < RTOL, p
