"""The PyTorch port's index engine (``MatrixFree``'s cell loop, its four
hanging-node runners, the slow constraint path, the deformed mapping and
``LaplaceOperator``) against the JAX package, in float64 on the CPU: the
same inputs, made with numpy from a seed, through the reference function
and its port (the plain PyTorch versions of the kernels), to 1e-12
relative."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dealii_matrixfree_hanging_nodes_tpu as ref  # noqa: E402
import dealii_matrixfree_hanging_nodes_tpu_torch as mt  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.matrix_free import MatrixFree as RefMatrixFree  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.models.laplace import (  # noqa: E402
    LaplaceOperator as RefLaplace,
)
from dealii_matrixfree_hanging_nodes_tpu.ops import hanging_nodes as ref_hn  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.ops import sum_factorization as ref_sf  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.convert import (  # noqa: E402
    matrix_free_from_reference,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.models.laplace import LaplaceOperator  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.ops import sum_factorization as sf  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import vmult_oracle  # noqa: E402
from torch_port_cases import RTOL, rel_err, rng_array  # noqa: E402

RUNNERS = ("compact", "all", "sorted", "matrix")
# the 3-D cases of the reference's tests/test_matrix_free.py
ORACLE_CASES = [("quadrant", 3, 1), ("quadrant", 3, 2), ("annulus", 5, 2), ("quadrant", 2, 4),
                ("quadrant", 2, 5), ("quadrant", 2, 6)]
BENCH00_MASK = 1 | (0b111 << 3)  # benchmark_00: subcell 1, every face constrained, no edge


def t64(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


@functools.lru_cache(maxsize=None)
def meshes(geo, nref, p, hn_mode="compact", high_order_mapping=False, categorize=False):
    """(reference MatrixFree, port MatrixFree) on one mesh, float64."""
    kw = dict(dtype=np.float64, hn_mode=hn_mode, high_order_mapping=high_order_mapping,
              categorize=categorize)
    rmf = RefMatrixFree(ref.create_geometry(geo, 3, nref), p, **kw)
    pmf = mt.MatrixFree(mt.create_geometry(geo, 3, nref), p, **kw)
    return rmf, pmf


def vmults(rmf, pmf, seed, **kw):
    src = rng_array(seed, pmf.n_dofs)
    got = LaplaceOperator(pmf, device="cpu", **kw).vmult(src).numpy()
    return got, np.asarray(RefLaplace(rmf, **kw).vmult(src)), src


# ---- the hanging-node function --------------------------------------------------
@pytest.mark.parametrize("case", ["bench00", "random", "components"])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6])
def test_apply_hanging_node_constraints(p, case):
    """Both directions against the reference: benchmark_00's mask, random
    9-bit masks, and three components folded into the batch."""
    P = ref.shape_info(p).P
    m, nc = 40, 3 if case == "components" else 1
    rng = np.random.default_rng(p)
    masks = (np.full(m, BENCH00_MASK) if case == "bench00"
             else rng.integers(0, 512, m)).astype(np.int32)
    vals = rng.standard_normal((m, nc * (p + 1) ** 3))
    for transpose in (False, True):
        got = mt.apply_hanging_node_constraints(t64(vals), torch.from_numpy(masks), t64(P), 3,
                                                transpose, n_components=nc)
        want = ref_hn.apply_hanging_node_constraints(vals, masks, P, 3, transpose,
                                                     n_components=nc)
        assert rel_err(got.numpy(), want) < RTOL, transpose


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6])
def test_sum_factorization(p):
    si = ref.shape_info(p)
    u = rng_array(p, 7, (p + 1) ** 3)
    S, Dc = si.S, si.Dc
    g = sf.evaluate_gradients(t64(u), t64(S), t64(Dc), 3)
    assert rel_err(g.numpy(), ref_sf.evaluate_gradients(u, S, Dc, 3)) < RTOL
    qg = rng_array(p + 10, 7, 3, (p + 1) ** 3)
    got = sf.integrate_gradients(t64(qg), t64(S), t64(Dc), 3)
    assert rel_err(got.numpy(), ref_sf.integrate_gradients(qg, S, Dc, 3)) < RTOL
    vals = sf.evaluate_values(t64(u), t64(S), 3)
    assert rel_err(vals.numpy(), ref_sf.evaluate_values(u, S, 3)) < RTOL
    back = sf.integrate_values(t64(qg[:, 0]), t64(S), 3)
    assert rel_err(back.numpy(), ref_sf.integrate_values(qg[:, 0], S, 3)) < RTOL


# ---- the runners and the cell loop -----------------------------------------------
@pytest.mark.parametrize("mode", RUNNERS)
def test_runner_on_rows(mode):
    """Each runner on gathered rows, both directions, and the tables it
    reads; under categorize ("sorted") the same cell permutation and
    permuted tables as the reference. The matrix runner's Q is not
    symmetric, so a transposed Q would show."""
    rmf, pmf = meshes("quadrant", 3, 3, mode)
    assert pmf.n_hn_cells == rmf.n_hn_cells > 0 and pmf._first_hn == rmf._first_hn
    np.testing.assert_array_equal(pmf.cell_permutation, rmf.cell_permutation)
    for key in ("dofmap", "dofmap_plain", "masks", "hn_idx", "hn_masks", "geo"):
        np.testing.assert_array_equal(pmf._np[key], rmf._np[key], err_msg=key)
    assert list(pmf._np) == list(rmf._np)
    rows = rng_array(5, pmf.n_cells, pmf._np["dofmap"].shape[1])
    for transpose in (False, True):
        got = pmf.apply_hanging_node_constraints(t64(rows), transpose)
        want = rmf.apply_hanging_node_constraints(jnp.asarray(rows), transpose)
        assert rel_err(got.numpy(), want) < RTOL, transpose
    if mode == "matrix":
        Q = pmf._matrix_tables()["Q"]
        assert max(np.abs(q - q.T).max() for q in Q) > 0.1


@pytest.mark.parametrize("mode", RUNNERS)
def test_vmult_matches_reference_per_runner(mode):
    """vmult against the reference, fast and slow, with and without
    constraints, at quadrant nref=3 p=3; symmetry (A u, v) = (u, A v) and the
    constant null space."""
    rmf, pmf = meshes("quadrant", 3, 3, mode)
    for kw in ({}, {"slow": True}, {"constraints": False}, {"constraints": False, "slow": True}):
        got, want, _ = vmults(rmf, pmf, 11, **kw)
        assert rel_err(got, want) < RTOL, kw
    op = LaplaceOperator(pmf, device="cpu")
    x, y = rng_array(1, pmf.n_dofs), rng_array(2, pmf.n_dofs)
    Ax, Ay = op.vmult(x).numpy(), op.vmult(y).numpy()
    assert abs((Ax * y).sum() - (x * Ay).sum()) < RTOL * np.abs(Ax * y).sum()
    assert np.abs(op.vmult(np.ones(pmf.n_dofs)).numpy()).max() < RTOL * np.abs(Ax).max()


@pytest.mark.parametrize("geo,nref,p", ORACLE_CASES, ids=[f"{g}-{n}-p{p}" for g, n, p in
                                                          ORACLE_CASES])
def test_vmult_matches_reference_and_oracle(geo, nref, p):
    rmf, pmf = meshes(geo, nref, p)
    got, want, src = vmults(rmf, pmf, 0)
    assert rel_err(got, want) < RTOL
    assert rel_err(got, vmult_oracle(pmf.tria, p, src)) < RTOL


@pytest.mark.parametrize("p", [2, 4])
def test_deformed_mapping(p):
    """The deformed metric and the vmult (fast, slow) against the reference
    at quadrant nref=2; the metric is built at the engine's first use."""
    rmf, pmf = meshes("quadrant", 2, p, high_order_mapping=True)
    assert callable(pmf._np._items["geo"])  # not built by the setup
    assert rel_err(pmf._np["geo"], rmf._np["geo"]) < RTOL
    for kw in ({}, {"slow": True}):
        got, want, _ = vmults(rmf, pmf, 3, **kw)
        assert rel_err(got, want) < RTOL, kw


def test_no_constraints_mesh():
    """A uniform mesh has no constrained cell and no slave: the runners and
    the slow functions return their input, and the vmult matches the
    reference on every path."""
    rmf, pmf = meshes("uniform", 1, 2)
    assert pmf.n_hn_cells == 0 and len(pmf._np["slow"]["slave"]) == 0
    rows, x = t64(rng_array(7, pmf.n_cells, 27)), t64(rng_array(8, pmf.n_dofs))
    assert pmf.apply_hanging_node_constraints(rows, False) is rows
    assert pmf.distribute_slow(x) is x and pmf.compress_slow(x) is x
    for kw in ({}, {"slow": True}, {"constraints": False}):
        got, want, _ = vmults(rmf, pmf, 5, **kw)
        assert rel_err(got, want) < RTOL, kw


def converted(rmf):
    return matrix_free_from_reference(rmf._np, rmf.n_dofs, rmf.hn_mode, rmf.categorize,
                                      rmf.cell_permutation)


@pytest.mark.parametrize("mode,categorize", [("compact", False), ("sorted", True),
                                             ("compact", True)])
def test_convert_from_reference(mode, categorize):
    """The port's index engine from the reference's host tables, n_dofs,
    categorize flag and cell permutation alone computes the reference's
    vmult and runners (categorized under "sorted", and a categorized
    reference with the compact runner)."""
    rmf, _ = meshes("quadrant", 3, 3, mode, categorize=categorize)
    assert rmf.categorize == categorize
    pmf = converted(rmf)
    assert (pmf.n_dofs, pmf.n_cells, pmf.degree) == (rmf.n_dofs, rmf.n_cells, rmf.degree)
    assert pmf.categorize == rmf.categorize
    np.testing.assert_array_equal(pmf.cell_permutation, rmf.cell_permutation)
    for kw in ({}, {"slow": True}):
        got, want, _ = vmults(rmf, pmf, 4, **kw)
        assert rel_err(got, want) < RTOL, kw
    rows = rng_array(6, pmf.n_cells, (pmf.degree + 1) ** 3)
    got = pmf.apply_hanging_node_constraints(t64(rows), True)
    assert rel_err(got.numpy(), rmf.apply_hanging_node_constraints(jnp.asarray(rows), True)) < RTOL


def test_convert_checks_the_tables():
    """from_tables holds the tables to the n_dofs and categorize flag it is
    given: a wrong n_dofs, unsorted masks under categorize and a permutation
    without categorize raise."""
    rmf, _ = meshes("quadrant", 3, 3, "compact")
    with pytest.raises(ValueError, match="dofmap_plain"):
        matrix_free_from_reference(rmf._np, rmf.n_dofs + 1)
    assert np.any(np.diff(np.asarray(rmf._np["masks"])) < 0)
    with pytest.raises(ValueError, match="not sorted"):
        matrix_free_from_reference(rmf._np, rmf.n_dofs, "compact", categorize=True)
    with pytest.raises(ValueError, match="permutation"):
        matrix_free_from_reference(rmf._np, rmf.n_dofs, cell_permutation=np.arange(
            rmf.n_cells)[::-1])


def test_generic_cell_kernel_and_dg_path():
    """cell_loop with another callable (benchmark_01's identity) runs
    read -> callable -> distribute; the DG path (runner, Laplace cell kernel
    on rows, transposed runner) matches the reference's."""
    rmf, pmf = meshes("quadrant", 3, 2, "compact")
    src = rng_array(8, pmf.n_dofs)
    for kw in ({}, {"slow": True}, {"constraints": False}):
        got = pmf.cell_loop(lambda u, a: u, t64(src), **kw).numpy()
        want = np.asarray(rmf.cell_loop(lambda u, a: u, jnp.asarray(src), **kw))
        assert rel_err(got, want) < RTOL, kw
    rows = rng_array(9, pmf.n_cells, 27)
    pk, rk = mt.laplace_cell_kernel(pmf), ref.models.laplace.laplace_cell_kernel(rmf)
    x = t64(rows)
    got = pmf.apply_hanging_node_constraints(
        pk(pmf.apply_hanging_node_constraints(x, False),
           pmf.device_tables(torch.device("cpu"), torch.float64)), True)
    want = rmf.apply_hanging_node_constraints(
        rk(rmf.apply_hanging_node_constraints(jnp.asarray(rows), False), rmf.arrays), True)
    assert rel_err(got.numpy(), want) < RTOL
    assert torch.equal(x, t64(rows))  # the input rows are untouched
    zero = pmf.initialize_dof_vector(device="cpu")
    assert zero.shape == (pmf.n_dofs,) and zero.dtype == torch.float64 and not zero.any()
