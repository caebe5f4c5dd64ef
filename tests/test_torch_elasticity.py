"""The PyTorch port's linear elasticity on both engines (``ElasticityOperator``
on the index engine, ``BrickElasticity`` on the brick engine) against the
JAX package, in float64 on the CPU: the same inputs, made with numpy from a
seed, through the reference function and its port (the plain PyTorch
versions of the kernels), to 1e-12 relative; the port's operators against
its own dense oracle, their symmetry and rigid-body null space; the
component axis of dof_scatter, corr_compact and dss_surface against three
scalar calls, bit-identical."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dealii_matrixfree_hanging_nodes_tpu as ref  # noqa: E402
import dealii_matrixfree_hanging_nodes_tpu_torch as mt  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.matrix_free import MatrixFree as RefMatrixFree  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.models.elasticity import (  # noqa: E402
    ElasticityOperator as RefElasticity,
)
from dealii_matrixfree_hanging_nodes_tpu.models.elasticity_bricks import (  # noqa: E402
    BrickElasticity as RefBrickElasticity,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.convert import (  # noqa: E402
    brick_elasticity_from_reference, elasticity_from_reference,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (  # noqa: E402
    brick_elasticity, cell_elasticity, corr_compact, dof_scatter, dss_surface,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import elasticity_oracle  # noqa: E402
from torch_port_cases import (  # noqa: E402,F401
    RTOL, one_torch_thread, reference_meta, rel_err, rng_array,
    release_module_memory,
)

# the reference's elasticity tests' 3-D cases, and p=4 (the port's main degree)
CASES = [("quadrant", 2, 2), ("quadrant", 3, 3), ("step", 2, 1), ("quadrant", 2, 4)]
IDS = [f"{g}-{n}-p{p}" for g, n, p in CASES]
MU, LAM = 1.3, 0.7  # mu != lam: a swapped G / G^T pair shows
case = pytest.mark.parametrize("geo,nref,p", CASES, ids=IDS)
# the vmults against the reference also at B=2 (p=5, 6), at p=1 on a deeper quadrant and on
# the step mesh at p=3
REF_CASES = CASES + [("quadrant", 2, 5), ("quadrant", 2, 6), ("quadrant", 4, 1), ("step", 3, 3)]
ref_case = pytest.mark.parametrize("geo,nref,p", REF_CASES,
                                   ids=[f"{g}-{n}-p{p}" for g, n, p in REF_CASES])


@functools.lru_cache(maxsize=None)
def meshes(geo, nref, p):
    """(reference MatrixFree, port MatrixFree), float64."""
    return (RefMatrixFree(ref.create_geometry(geo, 3, nref), p, dtype=np.float64),
            mt.MatrixFree(mt.create_geometry(geo, 3, nref), p, dtype=np.float64))


@functools.lru_cache(maxsize=None)
def brick_ops(geo, nref, p):
    """(reference BrickElasticity, port BrickElasticity on the CPU)."""
    rmf, pmf = meshes(geo, nref, p)
    return (RefBrickElasticity(rmf, mu=MU, lam=LAM),
            mt.BrickElasticity(pmf, MU, LAM, device="cpu"))


def conforming(rmf, seed):
    """A displacement [n_dofs, 3] from the seed with its hanging entries
    interpolated (the reference's brick tests' input)."""
    src = rng_array(seed, rmf.n_dofs, 3)
    for c in range(3):
        src[:, c] = rmf.constraints.distribute(src[:, c])
    return src


def t64(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


# ---- the index engine ------------------------------------------------------------
@ref_case
@pytest.mark.parametrize("constraints", [True, False], ids=["constrained", "plain"])
def test_index_vmult_matches_reference(geo, nref, p, constraints):
    rmf, pmf = meshes(geo, nref, p)
    src = rng_array(1, pmf.n_dofs, 3)
    want = np.asarray(RefElasticity(rmf, mu=MU, lam=LAM, constraints=constraints)
                      .vmult(jnp.asarray(src)))
    got = mt.ElasticityOperator(pmf, MU, LAM, constraints, device="cpu").vmult(src).numpy()
    assert got.shape == (pmf.n_dofs, 3)
    assert rel_err(got, want) < RTOL


# ---- the brick engine ------------------------------------------------------------
@ref_case
@pytest.mark.parametrize("call", ["vmult", "vmult_plain"])
def test_brick_vmult_matches_reference(geo, nref, p, call):
    rb, pb = brick_ops(geo, nref, p)
    src = conforming(rb.mf, 2)
    want = rb.to_dof_vector(getattr(rb, call)(rb.from_dof_vector(src)), zero_hanging=True)
    x = pb.from_dof_vector(src)
    assert torch.equal(x, t64(np.asarray(rb.from_dof_vector(src))))  # one brick layout
    got = pb.to_dof_vector(getattr(pb, call)(x), zero_hanging=True).numpy()
    assert rel_err(got, want) < RTOL


@case
def test_both_engines_match_the_oracle(geo, nref, p):
    """The port's index and brick vmults against its own dense C^T A C
    assembly (``oracle.elasticity_oracle``)."""
    _, pmf = meshes(geo, nref, p)
    src = conforming(meshes(geo, nref, p)[0], 3)
    want = elasticity_oracle(pmf.tria, p, MU, LAM, src)
    got = mt.ElasticityOperator(pmf, MU, LAM, device="cpu").vmult(src).numpy()
    assert rel_err(got, want) < RTOL
    pb = brick_ops(geo, nref, p)[1]
    got = pb.to_dof_vector(pb.vmult(pb.from_dof_vector(src)), zero_hanging=True).numpy()
    assert rel_err(got, want) < RTOL


@pytest.mark.parametrize("engine", ["index", "bricks"])
def test_symmetric(engine):
    """(A x, y) == (x, A y) on quadrant nref=2 p=2 (mu = lam = 1)."""
    _, pmf = meshes("quadrant", 2, 2)
    x, y = rng_array(4, pmf.n_dofs, 3), rng_array(5, pmf.n_dofs, 3)
    if engine == "index":
        op = mt.ElasticityOperator(pmf, device="cpu")
        ax, ay = op.vmult(x).numpy(), op.vmult(y).numpy()
    else:
        rmf = meshes("quadrant", 2, 2)[0]
        x, y = conforming(rmf, 4), conforming(rmf, 5)
        op = mt.BrickElasticity(pmf, device="cpu")
        ax, ay = (op.to_dof_vector(op.vmult(op.from_dof_vector(v)), zero_hanging=True).numpy()
                  for v in (x, y))
    assert abs((ax * y).sum() - (x * ay).sum()) < 1e-9 * abs((ax * y).sum())


@pytest.mark.parametrize("engine", ["index", "bricks"])
def test_rigid_body_null_space(engine):
    """A translation (< 1e-11) and a linearized rotation about z (< 1e-10)
    are in the null space, as the reference's tests hold them."""
    _, pmf = meshes("quadrant", 2, 2)
    pts = pmf.dof_handler.support_points()
    translation = np.zeros((pmf.n_dofs, 3))
    translation[:, 0] = 1.0
    rotation = np.stack([-pts[:, 1], pts[:, 0], np.zeros(len(pts))], axis=1)
    if engine == "index":
        op = mt.ElasticityOperator(pmf, device="cpu")
        apply = lambda u: op.vmult(u).numpy()
    else:
        op = mt.BrickElasticity(pmf, device="cpu")
        apply = lambda u: op.to_dof_vector(op.vmult(op.from_dof_vector(u)),
                                           zero_hanging=True).numpy()
    assert np.abs(apply(translation)).max() < 1e-11
    assert np.abs(apply(rotation)).max() < 1e-10


def test_support_points_match_reference():
    for geo, nref, p in (("quadrant", 2, 2), ("step", 2, 3)):
        rmf, pmf = meshes(geo, nref, p)
        assert np.array_equal(pmf.dof_handler.support_points(),
                              rmf.dof_handler.support_points())


# ---- the kernels' plain versions against the reference's steps -------------------
@case
def test_cell_rows_match_el_kel(geo, nref, p):
    """cell_elasticity's bricks mode (the sum-factorized coupled operator)
    against the reference's ``el_Kel`` einsum on the same subset cell rows,
    times geo_cell_sub (the reference's plain3)."""
    rb, pb = brick_ops(geo, nref, p)
    a = rb._stage()
    Kel = np.asarray(rb._extras_np["el_Kel"])
    bv = rng_array(6, 3, pb.mm.n_bricks, pb.mm.N3p)
    mm = rb.mm
    u_sub = mm._take_sub_multi(jnp.asarray(bv.reshape(-1, pb.mm.N3p)), a, 3)
    cols = np.asarray(mm._extract_cols(u_sub, a)).reshape(3, -1, pb.mm.n_loc)
    want = np.einsum("knj,ckij->cni", cols, Kel) * np.asarray(a["geo_cell_sub"])[None, :, None]
    got = pb.cell_rows(t64(bv)).numpy()
    assert rel_err(got, want) < RTOL


@case
def test_hn_rows_match_reference(geo, nref, p):
    """hn_cell's elastic mode (plain) against the reference's
    _fill_rows -> el_Kel -> _hn_apply(transpose) on the same rows."""
    rb, pb = brick_ops(geo, nref, p)
    assert pb.mm.n_hn > 0
    a = rb._stage()
    mm = rb.mm
    bv = rng_array(7, 3, pb.mm.n_bricks, pb.mm.N3p)
    u_sub = mm._take_sub_multi(jnp.asarray(bv.reshape(-1, pb.mm.N3p)), a, 3)
    u3 = jnp.swapaxes(mm._extract_cols(u_sub, a).reshape(3, -1, pb.mm.n_loc), 0, 1)
    u_hat = mm._fill_rows(u3, a)
    own = jnp.einsum("nkj,ckij->nci", u_hat, a["el_Kel"]) * jnp.take(
        a["geo_cell_sub"], a["hn_sub"])[:, None, None]
    want = np.swapaxes(np.asarray(mm._hn_apply(own, a, transpose=True)), 0, 1)
    got = pb.hn_rows(t64(bv)).numpy()
    assert rel_err(got, want) < RTOL


@case
def test_brick_operator_matches_main_apply(geo, nref, p):
    """brick_elasticity's plain version (without cell rows) against the
    reference's ``_main_apply`` times geo, on the brick nodes."""
    rb, pb = brick_ops(geo, nref, p)
    a = rb._stage()
    N3 = pb.mm.N3
    bv = rng_array(8, 3, pb.mm.n_bricks, pb.mm.N3p)
    want = np.asarray(rb._main_apply(jnp.asarray(bv[:, :, :N3]), a)) * np.asarray(
        a["geo"])[None, :, None]
    got = pb.brick_apply(t64(bv), None)
    assert torch.all(got[:, :, N3:] == 0)
    assert rel_err(got[:, :, :N3].numpy(), want) < RTOL
    # the packed factors (the kernel's parameters) rebuild the dense ones exactly
    packed = brick_elasticity.brick_elasticity_plain(t64(bv), pb.packed_host, pb.mm.geo, p,
                                                     MU, LAM)
    assert torch.equal(packed, got)


@pytest.mark.parametrize("p", [2, 4])
def test_least_schedule_computes_the_operator(p):
    """The schedule that brick_elasticity's bound counts (``least_schedule``:
    45 factor applications a brick) computes the operator: x sweeps by
    distinct (input, x factor), y sweeps by distinct (input, x, y factors),
    the terms grouped by (output, z factor) before the z sweeps; against
    the plain version's term-by-term sum, on random cell factors."""
    rng = np.random.default_rng(p)
    K1, M1, G1 = (rng.standard_normal((p + 1, p + 1)) for _ in range(3))
    fac = brick_elasticity.brick_factors(K1, M1, G1, 2)
    NB = 2 * p + 1
    u = rng.standard_normal((3, NB, NB, NB))  # (component, z, y, x)
    xs, ys, zs = {}, {}, {}
    for c in range(3):
        for k in range(3):
            for coef, (fx, fy, fz) in brick_elasticity.terms(c, k, MU, LAM, 3):
                if (k, fx) not in xs:
                    xs[k, fx] = np.einsum("Xx,zyx->zyX", fac[fx], u[k])
                if (k, fx, fy) not in ys:
                    ys[k, fx, fy] = np.einsum("Yy,zyx->zYx", fac[fy], xs[k, fx])
                zs[c, fz] = zs.get((c, fz), 0) + coef * ys[k, fx, fy]
    got = np.zeros_like(u)
    for (c, fz), grouped in zs.items():
        got[c] += np.einsum("Zz,zyx->Zyx", fac[fz], grouped)
    assert len(xs) + len(ys) + len(zs) == brick_elasticity.least_schedule(3)[0] == 45
    bv = torch.from_numpy(u.reshape(3, 1, NB**3))
    want = brick_elasticity.brick_elasticity_plain(
        bv, {n: t64(fac[n]) for n in ("K", "M", "G")}, torch.ones(1, dtype=torch.float64), p,
        MU, LAM)
    assert rel_err(got.reshape(3, 1, -1), want.numpy()) < RTOL


# ---- the component axis -------------------------------------------------------------
def test_dof_scatter_components_match_scalar_calls():
    _, pmf = meshes("quadrant", 3, 3)
    t = pmf.scatter_tables(False, torch.device("cpu"))
    rows = t64(rng_array(9, 3, pmf.n_cells, 64))
    got = dof_scatter.dof_scatter(rows, *t)
    assert got.shape == (pmf.n_dofs, 3)
    for c in range(3):
        assert torch.equal(got[:, c], dof_scatter.dof_scatter(rows[c], *t))


@case
def test_corr_compact_components_match_scalar_calls(geo, nref, p):
    mm = brick_ops(geo, nref, p)[1].mm
    plain = t64(rng_array(10, 3, mm.n_sub * mm.C, mm.n_loc))
    sub_raw = t64(rng_array(11, 3, mm.n_hn, mm.n_loc))
    got = corr_compact.corr_compact(plain, sub_raw, *mm.corr_tables())
    for c in range(3):
        assert torch.equal(got[c], corr_compact.corr_compact(plain[c], sub_raw[c],
                                                             *mm.corr_tables()))


@case
def test_dss_surface_components_match_scalar_calls(geo, nref, p):
    mm = brick_ops(geo, nref, p)[1].mm
    v = t64(rng_array(12, 3, mm.n_bricks, mm.N3p))
    got = dss_surface.dss_surface(v.clone(), *mm.dss_tables())
    for c in range(3):
        assert torch.equal(got[c], dss_surface.dss_surface(v[c].clone(), *mm.dss_tables()))


def test_index_cell_rows_and_scatter_compose():
    """The index vmult is cell_elasticity's rows summed by dof_scatter on its
    component axis: rows [3, n_cells, n_loc], a displacement [n_dofs, 3]."""
    _, pmf = meshes("quadrant", 2, 2)
    cpu = torch.device("cpu")
    src = t64(rng_array(13, pmf.n_dofs, 3))
    rows = cell_elasticity.cell_elasticity(src, *pmf.cell_laplace_args(cpu, torch.float64),
                                           MU, LAM)
    assert rows.shape == (3, pmf.n_cells, 27)
    got = dof_scatter.dof_scatter(rows, *pmf.scatter_tables(False, cpu))
    want = mt.ElasticityOperator(pmf, MU, LAM, device="cpu").vmult(src)
    assert torch.equal(got, want)


# ---- the state carried across ---------------------------------------------------------
def test_brick_elasticity_from_reference():
    rb, _ = brick_ops("quadrant", 3, 3)
    mm = rb.mm
    op = brick_elasticity_from_reference(mm._np_arrays, reference_meta(mm), MU, LAM,
                                         device="cpu", dtype=torch.float64)
    bv = rb.from_dof_vector(conforming(rb.mf, 14))
    want = np.asarray(rb.vmult(bv))
    assert rel_err(op.vmult(t64(np.asarray(bv))).numpy(), want) < RTOL


def test_elasticity_from_reference():
    rmf, pmf = meshes("quadrant", 2, 4)
    op = elasticity_from_reference(rmf._np, rmf.n_dofs, MU, LAM, device="cpu")
    src = rng_array(15, pmf.n_dofs, 3)
    want = np.asarray(RefElasticity(rmf, mu=MU, lam=LAM).vmult(jnp.asarray(src)))
    assert rel_err(op.vmult(src).numpy(), want) < RTOL
