"""The port's distributed GMG (DistributedDirichletLaplace,
DistributedTransfer, DistributedGMGPreconditioner) against the JAX package,
float64 on the CPU: spawned gloo ranks (R = 1, 2, 4; one spawn per R) run
the GMG-preconditioned CG of the reference's
test_distributed_gmg_cg_matches_single_chip at quadrant nref=2 p=2 and must
take the reference's distributed iteration count at the same R (the
smoother's start vector is the padded [R, n_own_max] draw, so R changes
it) with its solution; the transfers against the reference's Transfer;
the transfer tables at R=8 against the reference's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dealii_matrixfree_hanging_nodes_tpu as ref
from dealii_matrixfree_hanging_nodes_tpu.matrix_free import MatrixFree as RefMatrixFree
from dealii_matrixfree_hanging_nodes_tpu.models.multigrid import (
    GMGPreconditioner as RefGMG, Transfer as RefTransfer, solve_cg as ref_solve_cg)
from dealii_matrixfree_hanging_nodes_tpu.parallel.multigrid_distributed import (
    DistributedDirichletLaplace as RefDirichlet, DistributedGMGPreconditioner as RefDistGMG,
    DistributedTransfer as RefDistTransfer)

import dealii_matrixfree_hanging_nodes_tpu_torch as mt
from dealii_matrixfree_hanging_nodes_tpu_torch.parallel.distributed import DistributedLaplacePlan
from dealii_matrixfree_hanging_nodes_tpu_torch.parallel.multigrid_distributed import (
    transfer_plan)
from torch_dist_ranks import run_ranks
from torch_port_cases import RTOL, one_torch_thread, release_module_memory  # noqa: F401

RANKS = (1, 2, 4)
NREF, P = 2, 2


@functools.lru_cache(maxsize=None)
def reference_solve():
    """The single-chip reference's rhs and solution (test_solvers.py:141-147)."""
    gmg = RefGMG("quadrant", 3, NREF, P)
    op, mf = gmg.fine_op, gmg.fine_mf
    xstar = mf.constraints.distribute(np.random.default_rng(0).standard_normal(mf.n_dofs))
    xstar = np.asarray(jnp.asarray(xstar).at[op.bdofs].set(0.0))
    b = np.asarray(op.vmult(jnp.asarray(xstar)))
    x, it, _ = ref_solve_cg(op, jnp.asarray(b), M=gmg, tol=1e-10, max_iter=100)
    return b, np.asarray(x), it, ~mf.constraints.constrained_dof_marker()


@functools.lru_cache(maxsize=None)
def reference_distributed(R):
    b = reference_solve()[0]
    dgmg = RefDistGMG("quadrant", 3, NREF, P, devices=jax.devices()[:R])
    dop = dgmg.fine_op
    xd, it, _ = ref_solve_cg(dop, dop.scatter_vector(b), M=dgmg, tol=1e-10, max_iter=100)
    return it, dop.gather_vector(xd)


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    cache = {}

    def get(R):
        if R not in cache:
            cases = dict(gmg=("gmg", dict(nref=NREF, p=P, b=reference_solve()[0])),
                         transfer=("transfer", dict(nref=3, p=2)))
            cache[R] = run_ranks(R, cases, tmp_path_factory.mktemp(f"ranks{R}"))
        return cache[R]

    return get


@pytest.mark.parametrize("R", RANKS)
def test_distributed_gmg_cg_matches_reference(rank_results, R):
    res = rank_results(R)["gmg"]
    it_ref, x_ref = reference_distributed(R)
    assert res["iters"] == it_ref, (R, res["iters"], it_ref)
    _, x_single, _, free = reference_solve()
    assert np.abs(res["x"][free] - x_ref[free]).max() < 1e-8
    assert np.abs(res["x"][free] - x_single[free]).max() < 1e-8


@functools.lru_cache(maxsize=None)
def ref_levels(nref, p):
    return tuple(RefMatrixFree(ref.create_quadrant(3, n), p, dtype=np.float64)
                 for n in (nref - 1, nref))


@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("mode", ["prolongate", "restrict"])
def test_distributed_transfer_matches_reference(rank_results, R, mode):
    mfc, mff = ref_levels(3, 2)
    rng = np.random.default_rng(4)
    xc, xf = rng.standard_normal(mfc.n_dofs), rng.standard_normal(mff.n_dofs)
    tr = RefTransfer(mfc, mff)
    want = np.asarray(tr.prolongate(jnp.asarray(xc)) if mode == "prolongate"
                      else tr.restrict(jnp.asarray(xf)))
    got = rank_results(R)["transfer"][mode]
    assert np.abs(got - want).max() < RTOL * np.abs(want).max()


def test_transfer_tables_match_reference_at_8():
    rc, rf = ref_levels(3, 2)
    dc, df = (RefDirichlet(mf, devices=jax.devices()[:8]) for mf in (rc, rf))
    rt = RefDistTransfer(RefTransfer(rc, rf), dc, df)
    mfc, mff = (mt.MatrixFree(mt.create_quadrant(3, n), 2, dtype=np.float64) for n in (2, 3))
    pc, pf = (DistributedLaplacePlan(mf, 8) for mf in (mfc, mff))
    t = transfer_plan(mfc, mff, pc, pf)
    for key in ("covmap", "cdf", "cov_masks", "E", "own"):
        np.testing.assert_array_equal(t[key], np.asarray(rt._dev[key]), err_msg=key)
