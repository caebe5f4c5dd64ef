"""Each kernel's plain PyTorch version, and each step of the plain fold/HN
chain, against the JAX package's function on the same inputs (float64,
CPU, relative tolerance 1e-12), and the host tables that brick_apply,
cell_apply and dss_surface read (``bricks.kernel_tables``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (  # noqa: E402
    KERNEL_MODULES,
    brick_apply,
    cell_apply,
    dss_surface,
    hn_cell,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import (  # noqa: E402
    kernel_tables,
    kronecker_sum,
)
from torch_port_cases import (  # noqa: E402
    CASES, IDS, LOW_CASES, RTOL, port, port_tables, reference, rel_err, rng_array,
)

case = pytest.mark.parametrize("geo,nref,p", CASES, ids=IDS)
T = torch.from_numpy


@case
def test_brick_apply(geo, nref, p):
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    bv = rng_array(1, op.n_bricks, op.N3p)
    ref = bl._main_apply(jnp.asarray(bv), a) * a["geo"][:, None]
    got = brick_apply.brick_apply(T(bv), op.Kb, op.Mb, op.geo, op.p)
    assert rel_err(got, ref) < RTOL


@case
def test_cell_apply_from_bricks(geo, nref, p):
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    u_sub = rng_array(2, op.n_sub, op.N3p)
    ref = jnp.dot(bl._extract_cols(jnp.asarray(u_sub), a), a["K"].T) * a["geo_cell_sub"][:, None]
    got = cell_apply.cell_apply(T(u_sub), op.K1, op.M1, op.geo_cell_sub, brick_size=op.B)
    assert got.shape == ref.shape
    assert rel_err(got, ref) < RTOL


@case
def test_cell_apply_from_rows(geo, nref, p):
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    rows = rng_array(3, op.n_hn, op.n_loc)
    ref = jnp.dot(jnp.asarray(rows), a["K"].T) * jnp.take(a["geo_cell_sub"], a["hn_sub"])[:, None]
    got = cell_apply.cell_apply_plain(T(rows), op.K1, op.M1, op.geo_hn)
    assert rel_err(got, ref) < RTOL


@case
def test_brick_apply_with_overlap(geo, nref, p):
    """The fused plain version, on the packed host factors as the vmult
    passes them: the main apply times geo, plus the overlap-add of the
    subset's cell rows into the leading bricks."""
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    bv = rng_array(4, op.n_bricks, op.N3p)
    dcols = rng_array(5, op.n_sub * op.C, op.n_loc)
    ref = (bl._main_apply(jnp.asarray(bv), a) * a["geo"][:, None]).at[: op.n_sub].add(
        bl._scatter_cols(jnp.asarray(dcols), a))
    got = brick_apply.brick_apply(T(bv), *op.brick_factors_host, op.geo, op.p, dcols=T(dcols),
                                  brick_size=op.B)
    assert got.shape == ref.shape
    assert rel_err(got, ref) < RTOL


@case
def test_brick_factor_packing(geo, nref, p):
    """The packed factors rebuild Kb and Mb exactly, with 1 + B p (p+2)
    structural nonzeros each (97 / 71 / 97 at p = 4 / 5 / 6), are kept on
    the host only, and a Kb with a nonzero outside the structure of its cell
    blocks raises."""
    op = port(geo, nref, p)[2]
    nnz = {4: 97, 5: 71, 6: 97}[p]
    for dense, packed in zip((op.Kb, op.Mb), op.brick_factors_host):
        assert packed.shape == (nnz,) and packed.device.type == "cpu"
        assert torch.equal(brick_apply.unpack_factor(packed, p), dense)
    assert not [name for name, _ in op.named_buffers() if name.endswith("_packed")]
    t, m = port_tables(geo, nref, p)
    Kb = np.array(t["Kb"])
    Kb[0, p + 1] = 1e-30  # row 0 couples only with its cell's p+1 nodes
    with pytest.raises(ValueError, match="outside the structure"):
        kernel_tables(dict(t, Kb=Kb), m)


@case
def test_dss_surface(geo, nref, p):
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    v = rng_array(6, op.n_bricks, op.N3p)
    ref = bl._dss_fill(jnp.asarray(v), a, None)
    vt = T(v.copy())
    got = dss_surface.dss_surface(vt, *op.dss_tables())
    assert got is vt  # in place
    assert rel_err(got, ref) < RTOL


@case
def test_cell_factors_make_K(geo, nref, p):
    """K1 and M1, read off the brick factors, give the dense K as their
    Kronecker sum, and are the 1-D stiffness and mass of the element."""
    from dealii_matrixfree_hanging_nodes_tpu.elements import shape_info

    op = port(geo, nref, p)[2]
    K1, M1, K = op.K1.numpy(), op.M1.numpy(), np.asarray(port_tables(geo, nref, p)[0]["K"])
    assert K1.shape == M1.shape == (p + 1, p + 1)
    assert np.abs(kronecker_sum(K1, M1) - K).max() <= 1e-13 * np.abs(K).max()
    si = shape_info(p)
    np.testing.assert_allclose(K1, np.einsum("q,qi,qj->ij", si.quad_w, si.D, si.D),
                               rtol=0, atol=1e-13 * np.abs(K1).max())
    np.testing.assert_allclose(M1, np.einsum("q,qi,qj->ij", si.quad_w, si.S, si.S),
                               rtol=0, atol=1e-13 * np.abs(M1).max())


@case
def test_dss_work_lists_cover_the_surface(geo, nref, p):
    """Every surface copy of every brick lies in exactly one pool entry, the
    validity bits are node_valid on the surface, and the hole bits (with
    the padding) are exactly the invalid nodes off the pools."""
    op = port(geo, nref, p)[2]
    nb, N3p, NB = op.n_bricks, op.N3p, op.NB
    node_valid = T(port_tables(geo, nref, p)[0]["node_valid"])
    valid = node_valid.reshape(-1)
    hits = torch.zeros(nb * N3p, dtype=torch.int64)
    for pools, kind in zip(op.dss_tables()[:3], dss_surface.POOL_KINDS):
        b, s, node, real = dss_surface.pool_positions(pools, kind, NB, N3p)
        hits.index_add_(0, node[real].reshape(-1), torch.ones_like(node[real]).reshape(-1))
        bits = dss_surface.bit_set(op.dss_valid_bits, b[..., None], s)
        assert torch.equal(bits[real], valid[node[real]])
    surf = torch.from_numpy(dss_surface.surface_nodes(NB))
    on_surface = torch.zeros(N3p, dtype=torch.bool)
    on_surface[surf] = True
    assert torch.equal(hits.reshape(nb, N3p), on_surface.expand(nb, N3p).long())
    holes = torch.zeros(nb, N3p, dtype=torch.bool)
    holes[:, NB**3:] = True  # the padding, zeroed without a table
    k = torch.arange(NB**3)
    rows = op.dss_hole_bricks.long()
    holes[rows, : NB**3] = dss_surface.bit_set(op.dss_hole_bits,
                                                torch.arange(len(rows))[:, None], k)
    assert torch.equal(holes, ~node_valid & ~on_surface)


@case
def test_dss_bound_counts_the_nodes_that_change(geo, nref, p):
    """The nodes dss_surface's bound counts as written are exactly those
    the function changes on a random vector (every pooled sum and every
    zeroed node differs from its input), and it reads only those."""
    op = port(geo, nref, p)[2]
    v = T(rng_array(22, op.n_bricks, op.N3p))
    (read, _), (written, _) = dss_surface.moved_nodes(v, *op.dss_tables())
    changed = torch.nonzero(dss_surface.dss_surface(v.clone(), *op.dss_tables()).reshape(-1)
                            != v.reshape(-1))[:, 0]
    assert torch.equal(torch.sort(written).values, changed)
    assert torch.isin(read, written).all()
    nbytes, _ = dss_surface.bytes_and_flops(v, *op.dss_tables())
    together = dss_surface.sector_bytes(v, *op.dss_tables())
    assert nbytes <= together <= dss_surface.sector_bytes(v, *op.dss_tables(), apart=True)


def test_kernel_tables_check_what_they_derive():
    """A K that is not the Kronecker sum of the brick factors' cell blocks,
    or contributor lists that do not partition the copies, raise."""
    t, m = port_tables(*CASES[2])
    bad = dict(t, K=t["K"] * (1.0 + 1e-9))
    with pytest.raises(ValueError, match="Kronecker sum"):
        kernel_tables(bad, m)
    ec = np.array(t["edge_contrib"])
    ec[0] = ec[1]
    with pytest.raises(ValueError, match="edge"):
        kernel_tables(dict(t, edge_contrib=ec), m)


@case
def test_fill_rows(geo, nref, p):
    """_fill_rows = _fill_hn_compact then _hn_apply forward."""
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    u_sub = rng_array(7, op.n_sub, op.N3p)
    ref = bl._fill_rows(bl._extract_cols(jnp.asarray(u_sub), a), a)
    assert rel_err(op._fill_rows(T(u_sub)), ref) < RTOL
    ref_c = bl._fill_hn_compact(bl._extract_cols(jnp.asarray(u_sub), a), a)
    assert rel_err(op._fill_hn_compact(T(u_sub)), ref_c) < RTOL


@case
@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "transposed"])
def test_hn_apply(geo, nref, p, transpose):
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    rows = rng_array(8, op.n_hn, op.n_loc)
    ref = bl._hn_apply(jnp.asarray(rows), a, transpose=transpose)
    assert rel_err(op._hn_apply(T(rows), transpose=transpose), ref) < RTOL


@case
def test_corr_compact(geo, nref, p):
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    plain = rng_array(9, op.n_sub * op.C, op.n_loc)
    sub_raw = rng_array(10, op.n_hn, op.n_loc)
    hn = np.asarray(a["hn_sub"])
    ref = bl._corr_compact(jnp.asarray(plain), jnp.asarray(plain[hn]),
                           jnp.asarray(sub_raw), a)
    got = op._corr_compact(T(plain), T(sub_raw))  # reads plain at hn_sub itself
    assert rel_err(got, ref) < RTOL


CPU_CASES = [pytest.param(mod, False, id=mod.NAME) for mod in KERNEL_MODULES] + [
    pytest.param(brick_apply, True, id="brick_apply-dcols"),
    pytest.param(hn_cell, True, id="hn_cell-fill")]


@pytest.mark.parametrize("mod,variant", CPU_CASES)
def test_cpu_tensors_take_the_plain_version(mod, variant):
    """On CPU tensors a wrapper computes its plain version and launches
    nothing, so its launch count stays put (brick_apply also with the
    subset's cell rows, hn_cell also in its fill mode; the kernels of the
    degree <= 3 schedule on a p=2 operator with face planes; the index
    engine's on the same mesh's MatrixFree)."""
    low = mod.NAME in ("masked_quad", "plane_fill", "plane_fold")
    geo, nref, p = LOW_CASES[1] if low else CASES[0]
    op = port(geo, nref, p)[2]
    wrapper = getattr(mod, mod.NAME)
    plain = getattr(mod, f"{mod.NAME}_plain")
    before = wrapper.launches
    bricks = lambda seed: T(rng_array(seed, op.n_bricks, op.N3p))
    sub = lambda seed: T(rng_array(seed, op.n_sub, op.N3p))
    cells = lambda seed: T(rng_array(seed, op.n_sub * op.C, op.n_loc))
    hn_rows = lambda seed: T(rng_array(seed, op.n_hn, op.n_loc))
    mf, cpu, f64 = port(geo, nref, p)[1], torch.device("cpu"), torch.float64
    dofs = lambda seed: T(rng_array(seed, mf.n_dofs))
    mf_rows = lambda seed: T(rng_array(seed, mf.n_cells, op.n_loc))
    args, kw = {
        "brick_apply": lambda: ((bricks(11), *op.brick_factors_host, op.geo, op.p),
                                {"dcols": cells(13), "brick_size": op.B} if variant else {}),
        "cell_apply": lambda: ((sub(12), op.K1, op.M1, op.geo_cell_sub), {"brick_size": op.B}),
        "dss_surface": lambda: ((bricks(15), *op.dss_tables()), {}),
        "hn_cell": lambda: ((sub(17), *op.hn_tables(), *op.factors_host, op.geo_hn, op.B),
                            {"mode": "fill" if variant else "full"}),
        "corr_compact": lambda: ((cells(18), hn_rows(19), *op.corr_tables()), {}),
        "refill_update": lambda: ((bricks(20), hn_rows(21), *op.refill_tables()), {}),
        "masked_quad": lambda: ((bricks(22), bricks(23), *op.masked_tables("rem"),
                                 *op.factors_host, op.geo, op.B), {}),
        "plane_fill": lambda: ((bricks(24), *op.plane_fill_tables()), {}),
        "plane_fold": lambda: ((bricks(25), *op.plane_fold_tables()), {}),
        "hn_interp": lambda: ((mf_rows(26),), dict(mf.hn_interp_args(cpu, f64), transpose=False)),
        "cell_laplace": lambda: ((dofs(27), *mf.cell_laplace_args(cpu, f64)), {}),
        "dof_scatter": lambda: ((mf_rows(28), *mf.scatter_tables(False, cpu)), {}),
        "constraints_slow": lambda: ((dofs(29), *mf.slow_tables(cpu, f64)["compress"]), {}),
    }[mod.NAME]()
    clone = lambda xs: [x.clone() if isinstance(x, torch.Tensor) else x for x in xs]
    got = wrapper(*clone(args), **kw)
    want = plain(*clone(args), **kw)
    assert torch.equal(got, want)
    assert wrapper.launches == before
