"""The PyTorch port's index engine in 2-D against the JAX package, in float64
on the CPU: the vmult (fast, slow, constraints=False) at the reference's 2-D
cases, the four hanging-node runners and every 2-D mask code alone, the
deformed mapping, the sum factorization, the GMG transfer, the host
diagonal, elasticity, the GMG-CG solve and ``convert.matrix_free_from_
reference``. The same inputs, made with numpy from a seed, go through the
reference function and its port (the plain PyTorch versions of the
kernels), to 1e-12 relative.

A 2-D mask holds sub bits 0-1 and face bits 2-3 and no edge bits, so the 16
codes 0..15 are all there are; a 3-D decoder would read face bit 2 as a
sub bit and give a wrong answer without an error."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dealii_matrixfree_hanging_nodes_tpu as ref  # noqa: E402
import dealii_matrixfree_hanging_nodes_tpu_torch as mt  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.matrix_free import MatrixFree as RefMatrixFree  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.models import multigrid as rmg  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.models.elasticity import (  # noqa: E402
    ElasticityOperator as RefElasticity,
)
from dealii_matrixfree_hanging_nodes_tpu.models.laplace import (  # noqa: E402
    LaplaceOperator as RefLaplace,
)
from dealii_matrixfree_hanging_nodes_tpu.ops import hanging_nodes as ref_hn  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.ops import sum_factorization as ref_sf  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.convert import (  # noqa: E402
    matrix_free_from_reference,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.models import multigrid as pmg  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.ops import sum_factorization as sf  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import (  # noqa: E402
    elasticity_oracle, vmult_oracle,
)
from torch_port_cases import (  # noqa: E402, F401
    RTOL, one_torch_thread, rel_err, rng_array, release_module_memory,
)

DIM = 2
RUNNERS = ("compact", "all", "sorted", "matrix")
# the 2-D rows of the reference's tests/test_matrix_free.py
ORACLE_CASES = [("quadrant", 3, 2), ("step", 3, 3), ("quadrant", 3, 5), ("quadrant", 3, 6)]
ORACLE_IDS = [f"{g}-{n}-p{p}" for g, n, p in ORACLE_CASES]
PATHS = {"fast": {}, "slow": {"slow": True}, "no-constraints": {"constraints": False}}
# the runners' meshes: the reference's quadrant and step cases
RUNNER_MESHES = {"quadrant": ("quadrant", 3, 2), "step": ("step", 3, 3)}
MU, LAM = 1.3, 0.7  # unequal, so a swapped coupling term shows


def t64(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


@functools.lru_cache(maxsize=None)
def meshes(geo, nref, p, hn_mode="compact", high_order_mapping=False):
    """(reference MatrixFree, port MatrixFree) on one 2-D mesh, float64."""
    kw = dict(dtype=np.float64, hn_mode=hn_mode, high_order_mapping=high_order_mapping)
    rmf = RefMatrixFree(ref.create_geometry(geo, DIM, nref), p, **kw)
    pmf = mt.MatrixFree(mt.create_geometry(geo, DIM, nref), p, **kw)
    return rmf, pmf


def vmults(rmf, pmf, seed, **kw):
    src = rng_array(seed, pmf.n_dofs)
    got = mt.LaplaceOperator(pmf, device="cpu", **kw).vmult(src).numpy()
    return got, np.asarray(RefLaplace(rmf, **kw).vmult(src)), src


# ---- the vmult ----------------------------------------------------------------------
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("geo,nref,p", ORACLE_CASES, ids=ORACLE_IDS)
def test_vmult_matches_reference(geo, nref, p, path):
    """The 2-D vmult on each path against the reference; the constrained
    paths also against the scipy oracle (C^T A C)."""
    rmf, pmf = meshes(geo, nref, p)
    assert pmf.dim == DIM and pmf.n_hn_cells > 0
    got, want, src = vmults(rmf, pmf, 0, **PATHS[path])
    assert rel_err(got, want) < RTOL
    if path != "no-constraints":
        assert rel_err(got, vmult_oracle(pmf.tria, p, src)) < RTOL


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6])
def test_sum_factorization_2d(p):
    si = ref.shape_info(p)
    S, Dc = si.S, si.Dc
    u = rng_array(p, 7, (p + 1) ** 2)
    g = sf.evaluate_gradients(t64(u), t64(S), t64(Dc), DIM)
    assert rel_err(g.numpy(), ref_sf.evaluate_gradients(u, S, Dc, DIM)) < RTOL
    qg = rng_array(p + 10, 7, DIM, (p + 1) ** 2)
    got = sf.integrate_gradients(t64(qg), t64(S), t64(Dc), DIM)
    assert rel_err(got.numpy(), ref_sf.integrate_gradients(qg, S, Dc, DIM)) < RTOL


# ---- the hanging-node function ------------------------------------------------------
@functools.lru_cache(maxsize=None)
def mesh_codes():
    """Every mask code the 2-D quadrant and step meshes produce (nref 2..5,
    the port's constraint setup; the masks do not depend on the degree)."""
    codes = set()
    for geo in ("quadrant", "step"):
        for nref in range(2, 6):
            mf = mt.MatrixFree(mt.create_geometry(geo, DIM, nref), 1)
            codes |= set(np.unique(mf._np["masks"]).tolist())
    return codes


def test_mesh_codes_are_2d_codes():
    """The meshes' codes lie in 0..15 (no bit past the face bits) and
    include constrained ones; test_each_code runs every code there is."""
    codes = mesh_codes()
    assert codes <= set(range(16)) and len(codes - {0}) >= 4
    rmf, pmf = meshes("quadrant", 3, 2)
    np.testing.assert_array_equal(pmf._np["masks"], rmf._np["masks"])


@pytest.mark.parametrize("code", range(16))
def test_each_code(code):
    """One 2-D code alone on every row, both directions, p = 1..6, against
    the reference's apply_hanging_node_constraints."""
    for p in range(1, 7):
        P = ref.shape_info(p).P
        vals = rng_array(100 * code + p, 9, (p + 1) ** 2)
        masks = np.full(9, code, dtype=np.int32)
        for transpose in (False, True):
            got = mt.apply_hanging_node_constraints(t64(vals), torch.from_numpy(masks), t64(P),
                                                    DIM, transpose)
            want = ref_hn.apply_hanging_node_constraints(vals, masks, P, DIM, transpose)
            assert rel_err(got.numpy(), want) < RTOL, (p, transpose)
            if code == 0:
                assert torch.equal(got, t64(vals))


@pytest.mark.parametrize("mesh", list(RUNNER_MESHES))
@pytest.mark.parametrize("mode", RUNNERS)
def test_runner_on_rows(mode, mesh):
    """Each runner on cell rows, both directions, and the tables it reads,
    against the reference's; the matrix runner's Q [codes, n^2, n^2] is not
    symmetric, so a transposed Q would show."""
    rmf, pmf = meshes(*RUNNER_MESHES[mesh], mode)
    assert pmf.n_hn_cells == rmf.n_hn_cells > 0 and pmf._first_hn == rmf._first_hn
    np.testing.assert_array_equal(pmf.cell_permutation, rmf.cell_permutation)
    for key in ("dofmap", "dofmap_plain", "masks", "hn_idx", "hn_masks", "geo"):
        np.testing.assert_array_equal(pmf._np[key], rmf._np[key], err_msg=key)
    n_loc = pmf._np["dofmap"].shape[1]
    assert n_loc == (pmf.degree + 1) ** DIM
    rows = rng_array(5, pmf.n_cells, n_loc)
    for transpose in (False, True):
        got = pmf.apply_hanging_node_constraints(t64(rows), transpose)
        want = rmf.apply_hanging_node_constraints(jnp.asarray(rows), transpose)
        assert rel_err(got.numpy(), want) < RTOL, transpose
    if mode == "matrix":
        Q = pmf._matrix_tables()["Q"]
        assert Q.shape[1:] == (n_loc, n_loc)
        assert max(np.abs(q - q.T).max() for q in Q) > 0.1


# ---- the deformed mapping -----------------------------------------------------------
@pytest.mark.parametrize("p", [2, 4])
def test_deformed_mapping(p):
    """The 2-D metric [n_cells, n_q, 3] (xx, xy, yy) and the deformed vmult
    (fast, slow) against the reference at quadrant nref=3; the default sin
    deformation makes the cells non-affine, so a swapped xy/yy would show."""
    rmf, pmf = meshes("quadrant", 3, p, high_order_mapping=True)
    geo = pmf._np["geo"]
    assert geo.shape == (pmf.n_cells, (p + 1) ** 2, 3)
    assert rel_err(geo, rmf._np["geo"]) < RTOL
    assert np.abs(geo[:, :, 1]).max() > 1e-6 * np.abs(geo[:, :, 0]).max()  # non-affine
    for kw in ({}, {"slow": True}):
        got, want, _ = vmults(rmf, pmf, 3, **kw)
        assert rel_err(got, want) < RTOL, kw


# ---- the GMG pieces -----------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def levels(p):
    """(reference, port) coarse and fine MatrixFree at quadrant nref 2 -> 3."""
    return {k: meshes("quadrant", nref, p) for k, nref in (("c", 2), ("f", 3))}


@pytest.mark.parametrize("p", [2, 4])
def test_transfer(p):
    """prolongate and restrict against the reference, and the adjoint
    identity (restrict = prolongate^T) to 1e-12."""
    lv = levels(p)
    (rc, pc), (rf, pf) = lv["c"], lv["f"]
    cov_p, E_p = pmg.covering_embedding(pc, pf)
    cov_r, E_r = rmg.covering_embedding(rc, rf)
    assert np.array_equal(cov_p, cov_r) and E_p.shape[1] == DIM
    assert rel_err(E_p, E_r) <= RTOL
    rt, pt = rmg.Transfer(rc, rf), pmg.Transfer(pc, pf, device="cpu")
    xc, xf = rng_array(1, pc.n_dofs), rng_array(2, pf.n_dofs)
    up = pt.prolongate(t64(xc)).numpy()
    assert rel_err(up, rt.prolongate(jnp.asarray(xc))) <= RTOL
    down = pt.restrict(t64(xf)).numpy()
    assert rel_err(down, rt.restrict(jnp.asarray(xf))) <= RTOL
    lhs, rhs = float(up @ xf), float(xc @ down)
    assert abs(lhs - rhs) <= RTOL * max(abs(lhs), 1.0)


@pytest.mark.parametrize("p", [2, 4])
def test_host_diagonal(p):
    """laplace_diagonal_host in 2-D against the reference and against the
    port's probed diagonal (operator_diagonal)."""
    rmf, pmf = levels(p)["f"]
    diag = pmg.laplace_diagonal_host(pmf)
    assert rel_err(diag, rmg.laplace_diagonal_host(rmf)) <= RTOL
    op = pmg.DirichletLaplace(pmf, device="cpu")
    assert rel_err(pmg.operator_diagonal(op, pmf).numpy(), diag) <= RTOL


@functools.lru_cache(maxsize=None)
def gmg():
    """(reference, port) GMGPreconditioner at 2-D quadrant nref=3 p=2."""
    return (rmg.GMGPreconditioner("quadrant", DIM, 3, 2, n_smooth=3),
            pmg.GMGPreconditioner("quadrant", DIM, 3, 2, n_smooth=3, device="cpu"))


def test_gmg_vcycle():
    rg, pg = gmg()
    mf = pg.fine_mf
    b = rng_array(5, mf.n_dofs)
    b[mf.dof_handler.boundary_dofs()] = 0.0
    b = mf.constraints.distribute(b)
    assert rel_err(pg(t64(b)).numpy(), rg(jnp.asarray(b))) <= RTOL


def test_gmg_cg_iterations():
    """The GMG-preconditioned CG solve at tol 1e-10 takes the reference's
    iteration count, and the two solutions agree on the free DoFs."""
    rg, pg = gmg()
    mf = pg.fine_mf
    xstar = mf.constraints.distribute(rng_array(4, mf.n_dofs))
    xstar[mf.dof_handler.boundary_dofs()] = 0.0
    b_p = pg.fine_op.vmult(t64(xstar))
    b_r = rg.fine_op.vmult(jnp.asarray(xstar))
    assert rel_err(b_p.numpy(), b_r) <= RTOL
    x_p, it_p, _ = pmg.solve_cg(pg.fine_op, b_p, M=pg, tol=1e-10, max_iter=100)
    x_r, it_r, _ = rmg.solve_cg(rg.fine_op, b_r, M=rg, tol=1e-10, max_iter=100)
    assert it_p == it_r < 30
    free = ~mf.constraints.constrained_dof_marker()
    assert np.abs(x_p.numpy() - np.asarray(x_r))[free].max() <= 1e-9
    assert np.abs(x_p.numpy() - xstar)[free].max() <= 1e-6


# ---- elasticity ---------------------------------------------------------------------
@pytest.mark.parametrize("constraints", [True, False], ids=["constrained", "plain"])
def test_elasticity(constraints):
    """The 2-D elasticity vmult at quadrant nref=3 p=2 ([n_dofs, 2]) against
    the reference and, constrained, the dense oracle."""
    rmf, pmf = meshes("quadrant", 3, 2)
    src = rng_array(6, pmf.n_dofs, DIM)
    op = mt.ElasticityOperator(pmf, mu=MU, lam=LAM, constraints=constraints, device="cpu")
    got = op.vmult(src).numpy()
    assert got.shape == (pmf.n_dofs, DIM)
    want = RefElasticity(rmf, mu=MU, lam=LAM, constraints=constraints).vmult(jnp.asarray(src))
    assert rel_err(got, want) < RTOL
    if constraints:
        assert rel_err(got, elasticity_oracle(pmf.tria, 2, MU, LAM, src)) < RTOL


# ---- convert ------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["compact", "sorted"])
def test_convert_from_reference(mode):
    """The port's 2-D index engine from the reference's host tables alone:
    its dimension, the vmult (fast, slow) and the transposed runner."""
    rmf, _ = meshes("step", 3, 3, mode)
    pmf = matrix_free_from_reference(rmf._np, rmf.n_dofs, rmf.hn_mode, rmf.categorize,
                                     rmf.cell_permutation)
    assert (pmf.dim, pmf.degree, pmf.n_cells) == (DIM, 3, rmf.n_cells)
    for kw in ({}, {"slow": True}):
        got, want, _ = vmults(rmf, pmf, 4, **kw)
        assert rel_err(got, want) < RTOL, kw
    rows = rng_array(6, pmf.n_cells, 16)
    got = pmf.apply_hanging_node_constraints(t64(rows), True)
    assert rel_err(got.numpy(), rmf.apply_hanging_node_constraints(jnp.asarray(rows), True)) < RTOL


def test_convert_checks_the_2d_tables():
    """from_tables holds 2-D tables to their dimension: a mask with a bit
    past the 2-D layout (sub 0-1, faces 2-3) and a geo of the 3-D width
    raise."""
    rmf, _ = meshes("quadrant", 3, 2)
    bad_masks = dict(rmf._np, masks=np.asarray(rmf._np["masks"]) | 16)
    with pytest.raises(ValueError, match="masks"):
        matrix_free_from_reference(bad_masks, rmf.n_dofs)
    bad_geo = dict(rmf._np, geo=np.ones((rmf.n_cells, 3)))
    with pytest.raises(ValueError, match="geo"):
        matrix_free_from_reference(bad_geo, rmf.n_dofs)
