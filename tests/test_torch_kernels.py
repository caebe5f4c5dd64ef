"""Each kernel's plain PyTorch version, and each step of the plain fold/HN
chain, against the JAX package's function on the same inputs (float64,
CPU, relative tolerance 1e-12), and the host tables that brick_apply,
cell_apply and dss_surface read (``bricks.kernel_tables``). The tests
marked ``cuda`` hold the index engine's dim=2 instances against their plain
versions on the card, where no JAX is installed: ``python -m pytest
--noconftest tests/test_torch_kernels.py -m cuda``."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp  # noqa: E402
except ImportError:  # the card's machine has no JAX: only the tests marked cuda run there
    jnp = None

from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (  # noqa: E402
    KERNEL_MODULES,
    brick_apply,
    brick_deformed,
    brick_elasticity,
    brick_transfer,
    cell_apply,
    cell_elasticity,
    cell_transfer,
    corr_compact,
    dof_embed,
    dof_scatter,
    dss_pools,
    dss_surface,
    halo_pack,
    hn_cell,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import (  # noqa: E402
    kernel_tables,
    kronecker_sum,
)
from torch_port_cases import (  # noqa: E402, F401
    CASES, IDS, LOW_CASES, RTOL, port, port_tables, reference, rel_err, rng_array,
    release_module_memory,
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
    pytest.param(hn_cell, True, id="hn_cell-fill"),
    pytest.param(brick_transfer, True, id="brick_transfer-restrict"),
    pytest.param(dof_embed, True, id="dof_embed-embed_t"),
    pytest.param(cell_transfer, True, id="cell_transfer-restrict"),
    pytest.param(hn_cell, "elastic", id="hn_cell-elastic"),
    pytest.param(cell_elasticity, True, id="cell_elasticity-bricks"),
    pytest.param(brick_elasticity, True, id="brick_elasticity-dcols"),
    pytest.param(dof_scatter, "components", id="dof_scatter-components"),
    pytest.param(corr_compact, "components", id="corr_compact-components"),
    pytest.param(dss_surface, "components", id="dss_surface-components"),
    pytest.param(brick_deformed, True, id="brick_deformed-dcols"),
    pytest.param(cell_apply, "deformed", id="cell_apply-deformed"),
    pytest.param(hn_cell, "deformed", id="hn_cell-deformed"),
    pytest.param(halo_pack, "set", id="halo_pack-set"),
    pytest.param(halo_pack, "add", id="halo_pack-add"),
    pytest.param(dss_pools, "read", id="dss_pools-read")]


@functools.lru_cache(maxsize=None)
def rank_tables(geo, nref, p):
    """Rank 1's kernel tables of the 2-rank distributed brick plan (halo
    exchange) on the case's mesh, and the plan."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.parallel import DistributedBrickPlan

    plan = DistributedBrickPlan(port(geo, nref, p)[1], 2)
    return plan.rank_tables(1), plan


@functools.lru_cache(maxsize=None)
def deformed_op(geo, nref, p):
    """The port's BrickLaplaceMM under the deformed mapping on the case's
    mesh, float64 on the CPU."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    mf = mt.MatrixFree(mt.create_geometry(geo, 3, nref), p, dtype=np.float64,
                       high_order_mapping=True)
    return mt.BrickLaplaceMM(mf, device="cpu")


@functools.lru_cache(maxsize=None)
def elastic_op(geo, nref, p):
    """The port's BrickElasticity on the case's mesh, float64 on the CPU."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    return mt.BrickElasticity(port(geo, nref, p)[1], 1.3, 0.7, device="cpu")


@functools.lru_cache(maxsize=None)
def gmg_transfers(geo, nref, p):
    """(BrickTransfer, Transfer) from the mesh with one refinement fewer to
    the case's mesh, float64 on the CPU."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    _, mf, op = port(geo, nref, p)
    mfc = mt.MatrixFree(mt.create_geometry(geo, 3, nref - 1), p, dtype=np.float64)
    return (mt.BrickTransfer(mt.BrickLaplaceMM(mfc, device="cpu"), op),
            mt.Transfer(mfc, mf, device="cpu"))


@pytest.mark.parametrize("mod,variant", CPU_CASES)
def test_cpu_tensors_take_the_plain_version(mod, variant):
    """On CPU tensors a wrapper computes its plain version and launches
    nothing, so its launch count stays put (brick_apply also with the
    subset's cell rows, hn_cell also in its fill mode; the kernels of the
    degree <= 3 schedule on a p=2 operator with face planes; the index
    engine's on the same mesh's MatrixFree; the GMG kernels in both modes
    between the mesh with one refinement fewer and this one; hn_cell's
    elastic mode, cell_elasticity in both modes, brick_elasticity with and
    without cell rows, and dof_scatter, corr_compact and dss_surface on
    their component axis, at the case's elasticity operator; brick_deformed
    with and without cell rows and the deformed modes of cell_apply and
    hn_cell at the case's deformed operator)."""
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
    bt, tr = gmg_transfers(geo, nref, p)
    mf_rows = lambda seed: T(rng_array(seed, mf.n_cells, op.n_loc))
    el = elastic_op(geo, nref, p)
    dop = lambda: deformed_op(geo, nref, p)
    comp = variant == "components"
    lead = (3,) if comp else ()
    args, kw = {
        "brick_apply": lambda: ((bricks(11), *op.brick_factors_host, op.geo, op.p),
                                {"dcols": cells(13), "brick_size": op.B} if variant else {}),
        "cell_apply": lambda: (
            (T(rng_array(12, dop().n_sub, dop().N3p)), None, None, None),
            {"brick_size": dop().B, "deformed": dop().deformed_tables(dop().n_sub * dop().C)})
        if variant == "deformed" else (
            (sub(12), op.K1, op.M1, op.geo_cell_sub), {"brick_size": op.B}),
        "dss_surface": lambda: ((T(rng_array(15, *lead, op.n_bricks, op.N3p)),
                                 *op.dss_tables()), {}),
        "hn_cell": lambda: (
            (T(rng_array(17, 3, op.n_bricks, op.N3p)), *el.mm.hn_tables(), None, None,
             el.mm.geo_hn, op.B), {"mode": "elastic", "elastic": el.elastic_tables()})
        if variant == "elastic" else (
            (T(rng_array(17, dop().n_sub, dop().N3p)), *dop().hn_tables(), None, None, None,
             dop().B), {"mode": "deformed", "deformed": dop().deformed_tables()})
        if variant == "deformed" else (
            (sub(17), *op.hn_tables(), *op.factors_host, op.geo_hn, op.B),
            {"mode": "fill" if variant else "full"}),
        "corr_compact": lambda: ((T(rng_array(18, *lead, op.n_sub * op.C, op.n_loc)),
                                  T(rng_array(19, *lead, op.n_hn, op.n_loc)),
                                  *op.corr_tables()), {}),
        "refill_update": lambda: ((bricks(20), hn_rows(21), *op.refill_tables()), {}),
        "masked_quad": lambda: ((bricks(22), bricks(23), *op.masked_tables("rem"),
                                 *op.factors_host, op.geo, op.B), {}),
        "plane_fill": lambda: ((bricks(24), *op.plane_fill_tables()), {}),
        "plane_fold": lambda: ((bricks(25), *op.plane_fold_tables()), {}),
        "hn_interp": lambda: ((mf_rows(26),), dict(mf.hn_interp_args(cpu, f64), transpose=False)),
        "cell_laplace": lambda: ((dofs(27), *mf.cell_laplace_args(cpu, f64)), {}),
        "dof_scatter": lambda: ((T(rng_array(28, *lead, mf.n_cells, op.n_loc)),
                                 *mf.scatter_tables(False, cpu)), {}),
        "constraints_slow": lambda: ((dofs(29), *mf.slow_tables(cpu, f64)["compress"]), {}),
        "brick_transfer": lambda: (
            (T(rng_array(30, *((op.n_bricks, op.N3p) if variant else
                               (bt.embed_c.shape)))), *bt.tables()),
            {"mode": "restrict" if variant else "prolongate"}),
        "dof_embed": lambda: (
            (T(rng_array(31, *(bt.embed_c.shape if variant else (bt.embed_c.n_dofs,)))),
             *bt.embed_c.tables("embed_t" if variant else "embed"),
             (bt.embed_c.n_dofs,) if variant else bt.embed_c.shape), {}),
        "cell_transfer": lambda: (
            (dofs(32) if variant else T(rng_array(32, tr.child_ptr.numel() - 1, op.n_loc)),
             *tr.tables()), {"mode": "restrict" if variant else "prolongate"}),
        "cell_elasticity": lambda: (
            (T(rng_array(33, 3, op.n_bricks, op.N3p)), None, None, None, el.S, el.Dc,
             el.quad_w, el.mm.geo_cell_sub, 1.3, 0.7), {"brick_size": op.B}) if variant else (
            (T(rng_array(33, mf.n_dofs, 3)), *mf.cell_laplace_args(cpu, f64), 1.3, 0.7), {}),
        "brick_elasticity": lambda: (
            (T(rng_array(34, 3, op.n_bricks, op.N3p)), el.packed_host, op.geo, op.p, 1.3, 0.7),
            {"dcols": T(rng_array(35, 3, op.n_sub * op.C, op.n_loc)), "brick_size": op.B}
            if variant else {}),
        "brick_deformed": lambda: (
            (T(rng_array(36, dop().n_bricks, dop().N3p)), dop().metric, dop().present_bits,
             dop().S, dop().Dc),
            {"brick_size": dop().B, "factors": dop().kernel_factors,
             **({"dcols": T(rng_array(37, dop().n_sub * dop().C, dop().n_loc))} if variant
                else {})}),
        "halo_pack": lambda: halo_pack_args(geo, nref, p, variant),
        "dss_pools": lambda: dss_pools_args(geo, nref, p, variant),
        "chain_halo": lambda: (
            (T(rng_array(42, rank_tables(geo, nref, p)[0]["fold_map"][0].size - 1)),
             *(T(a) for a in rank_tables(geo, nref, p)[0]["fold_map"])), {}),
    }[mod.NAME]()
    clone = lambda xs: [x.clone() if isinstance(x, torch.Tensor) else x for x in xs]
    got = wrapper(*clone(args), **kw)
    want = plain(*clone(args), **kw)
    assert torch.equal(got, want)
    assert wrapper.launches == before


def halo_pack_args(geo, nref, p, mode):
    """halo_pack's arguments in a mode (False: pack) on rank 1's tables of
    the 2-rank plan: the fold exchange's send lists on its chain block, its
    set map, the DSS pools' add runs."""
    t, plan = rank_tables(geo, nref, p)
    n_loc = (p + 1) ** 3
    block = T(rng_array(40, plan.n_chain_max, n_loc))
    if mode == "set":
        return (block, T(rng_array(41, *t["fold"]["send_idx"].shape)),
                T(t["fold"]["set_map"])), {"mode": "set"}
    if mode == "add":
        return (T(rng_array(41, t["dss"]["n_slots"])), T(rng_array(43, *t["dss_send"][0].shape)),
                *(T(a) for a in t["dss_add"])), {"mode": "add"}
    return (block, T(t["fold"]["send_idx"]), T(t["fold"]["send_valid"])), {"mode": "pack"}


def dss_pools_args(geo, nref, p, mode):
    """dss_pools' arguments (accumulate, or read) on rank 1's tables."""
    t, plan = rank_tables(geo, nref, p)
    d = t["dss"]
    v = T(rng_array(44, plan.nb_max, plan.const["N3p"]))
    acc = (v, *(T(d[k]) for k in ("surf_node", "ent_off", "pool_off", "pool_ptr", "pool_src")),
           d["n_slots"])
    if mode == "read":
        pools = dss_pools.dss_pools_plain(*acc, mode="accumulate")
        return (v, pools, T(d["node_ent"]), T(d["read_base"]), T(t["valid_bits"])), {
            "mode": "read"}
    return acc, {"mode": "accumulate"}


# ---- the index engine's dim=2 instances ------------------------------------------------
@functools.lru_cache(maxsize=None)
def index_2d(p, hn_mode="compact", high_order_mapping=False, dtype=np.float64):
    """The port's 2-D MatrixFree at quadrant nref=3 (the reference's 2-D case)."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    return mt.MatrixFree(mt.create_quadrant(2, 3), p, dtype=dtype, hn_mode=hn_mode,
                         high_order_mapping=high_order_mapping)


def index_2d_calls(p, dev, dt, seed):
    """{name: [(part, args, kw)]}: every 2-D instance at quadrant nref=3 on
    dev in dt, as the 2-D paths call it: hn_interp by each runner in both
    directions, cell_laplace fast / slow / constraints=False / deformed,
    cell_transfer in both modes (nref 2 -> 3), cell_elasticity with and
    without the interpolation, dof_scatter on its component axis of 2."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.models import multigrid as pmg

    npdt = np.float32 if dt == torch.float32 else np.float64
    mf = index_2d(p, dtype=npdt)
    md = index_2d(p, high_order_mapping=True, dtype=npdt)
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=dt)
    n_loc = (p + 1) ** 2
    x, rows = rnd(mf.n_dofs), rnd(mf.n_cells, n_loc)
    calls = {"hn_interp": [], "cell_laplace": [], "cell_transfer": [], "cell_elasticity": [],
             "dof_scatter": []}
    for mode in ("compact", "all", "sorted", "matrix"):
        m = index_2d(p, mode, dtype=npdt)
        for tr in (False, True):
            calls["hn_interp"].append((f"{mode} {tr}", (rows.clone(),),
                                       dict(m.hn_interp_args(dev, dt), transpose=tr)))
    for part, m, slow, hn in (("fast", mf, False, True), ("slow", mf, True, False),
                              ("constraints=False", mf, False, False),
                              ("deformed", md, False, True)):
        calls["cell_laplace"].append((part, (x, *m.cell_laplace_args(dev, dt, slow, hn)),
                                      {"factors": m.kernel_factors}))
    mc = mt.MatrixFree(mt.create_quadrant(2, 2), p, dtype=npdt)
    tr = pmg.Transfer(mc, mf, device=dev)
    calls["cell_transfer"] += [("prolongate", (rnd(mc.n_cells, n_loc), *tr.tables()),
                                {"mode": "prolongate"}),
                               ("restrict", (x, *tr.tables()), {"mode": "restrict"})]
    for hn in (True, False):
        calls["cell_elasticity"].append((f"hn={hn}", (rnd(mf.n_dofs, 2),
                                                      *mf.cell_laplace_args(dev, dt, hn=hn),
                                                      1.3, 0.7), {"factors": mf.kernel_factors}))
    calls["dof_scatter"].append(("k=2", (rnd(2, mf.n_cells, n_loc),
                                         *mf.scatter_tables(False, dev)), {}))
    return calls


@pytest.mark.parametrize("name", ["hn_interp", "cell_laplace", "cell_transfer",
                                  "cell_elasticity", "dof_scatter"])
def test_cpu_tensors_take_the_plain_version_2d(name):
    """On CPU tensors each 2-D instance's wrapper computes its plain version
    and launches nothing."""
    from dealii_matrixfree_hanging_nodes_tpu_torch import kernels

    mod = getattr(kernels, name)
    wrapper, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
    before = wrapper.launches
    for part, args, kw in index_2d_calls(4, torch.device("cpu"), torch.float64, 7)[name]:
        clone = lambda xs: [x.clone() if isinstance(x, torch.Tensor) else x for x in xs]
        assert torch.equal(wrapper(*clone(args), **kw), plain(*clone(args), **kw)), part
    assert wrapper.launches == before


@pytest.mark.parametrize("dim", [2, 3])
def test_hn_interp_plain_takes_no_rows(dim):
    """hn_interp's plain version with no items (a runner's empty row list)
    leaves the rows as they are, as the kernel does."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import hn_interp

    p = 3
    P = torch.from_numpy(np.asarray(__import__(
        "dealii_matrixfree_hanging_nodes_tpu_torch").shape_info(p).P))
    rows = T(rng_array(40, 5, (p + 1) ** dim))
    empty = torch.zeros(0, dtype=torch.int32)
    for kw in ({}, {"rows": empty}):
        got = hn_interp.hn_interp_plain(rows.clone(), empty, P, True, **kw)
        assert torch.equal(got, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6])
def test_2d_instances_on_card(p, dtype):
    """Each dim=2 instance of hn_interp (four runners, both directions),
    cell_laplace (fast, slow, constraints=False, deformed), cell_transfer
    (both modes), cell_elasticity (with and without the interpolation) and
    dof_scatter's component axis of 2 against its plain version on the card,
    at 2-D quadrant nref=3: 1e-5 relative in float32 (sums of up to ~50
    rounded terms), 1e-12 in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dealii_matrixfree_hanging_nodes_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for name, parts in index_2d_calls(p, dev, dtype, p).items():
        mod = getattr(kernels, name)
        for part, args, kw in parts:
            clone = lambda xs: [x.clone() if isinstance(x, torch.Tensor) else x for x in xs]
            before = getattr(mod, name).launches
            got = getattr(mod, name)(*clone(args), **kw)
            ref = getattr(mod, f"{name}_plain")(*clone(args), **kw)
            torch.cuda.synchronize()
            assert getattr(mod, name).launches == before + 1, (name, part)
            err = float((got.double() - ref.double()).abs().max() / ref.double().abs().max())
            assert err < tol, (name, part, err)
