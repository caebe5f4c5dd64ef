"""The PyTorch port's GMG-preconditioned CG on both engines against the JAX
package, in float64 on the CPU, at quadrant nref=2, p=2 (the reference's
solve_01.run configuration cut to two levels): one V-cycle of each
preconditioner to 1e-12 relative, then the solve of a manufactured problem
at tol 1e-10: the reference's iteration count exactly, the solution to
1e-9; the brick engine's device solver takes solve_cg's count. The brick
V-cycle also at quadrant nref=3, p=4 (three levels of B=4 bricks)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dealii_matrixfree_hanging_nodes_tpu.models import multigrid as rmg  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.models import multigrid_bricks as rmb  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.models import multigrid as pmg  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.models import multigrid_bricks as pmb  # noqa: E402
from torch_port_cases import (  # noqa: E402, F401
    RTOL, one_torch_thread, rel_err, rng_array, release_module_memory,
)

NREF, P, TOL = 2, 2, 1e-10
ENGINES = ("index", "brick")


@functools.lru_cache(maxsize=None)
def setup(engine):
    """(reference, port) preconditioners, the fine level's rhs b (the
    operator applied to a random consistent x* with zero Dirichlet rows),
    x*, and the converters from a DoF vector to each side's vector.
    "brick-cg": the brick GMG with the CG coarse solve, on one level (its
    V-cycle is that solve); "brick-p4": the brick GMG at quadrant nref=3,
    p=4."""
    if engine == "index":
        rg = rmg.GMGPreconditioner("quadrant", 3, NREF, P, n_smooth=3)
        pg = pmg.GMGPreconditioner("quadrant", 3, NREF, P, n_smooth=3, device="cpu")
        conv_r, conv_p = jnp.asarray, lambda x: torch.from_numpy(np.array(x, dtype=np.float64))
    else:
        kw = dict(coarse="cg") if engine == "brick-cg" else {}
        nref, p = {"brick-cg": (1, P), "brick-p4": (3, 4)}.get(engine, (NREF, P))
        rg = rmb.BrickGMGPreconditioner("quadrant", 3, nref, p, n_smooth=3, **kw)
        pg = pmb.BrickGMGPreconditioner("quadrant", 3, nref, p, n_smooth=3, device="cpu", **kw)
        conv_r, conv_p = rg.fine_mm.from_dof_vector, pg.fine_mm.from_dof_vector
    mf = pg.fine_mf
    xstar = mf.constraints.distribute(rng_array(4, mf.n_dofs))
    xstar[mf.dof_handler.boundary_dofs()] = 0.0
    return rg, pg, xstar, conv_r, conv_p


@pytest.mark.parametrize("engine", ENGINES + ("brick-cg", "brick-p4"))
def test_vcycle_matches_reference(engine):
    rg, pg, _, conv_r, conv_p = setup(engine)
    b = rng_array(5, pg.fine_mf.n_dofs)
    b[pg.fine_mf.dof_handler.boundary_dofs()] = 0.0
    b = pg.fine_mf.constraints.distribute(b)
    assert rel_err(pg(conv_p(b)), rg(conv_r(b))) <= RTOL


@pytest.mark.parametrize("engine", ENGINES)
def test_gmg_cg_matches_reference(engine):
    rg, pg, xstar, conv_r, conv_p = setup(engine)
    rop, pop = rg.fine_op, pg.fine_op
    b_r, b_p = rop.vmult(conv_r(xstar)), pop.vmult(conv_p(xstar))
    assert rel_err(b_p, b_r) <= RTOL
    kw = {} if engine == "index" else {"dot": pg.fine_mm.dot}
    x_p, it_p, _ = pmg.solve_cg(pop, b_p, M=pg, tol=TOL, max_iter=100, **kw)
    x_r, it_r, _ = rmg.solve_cg(rop, b_r, M=rg, tol=TOL, max_iter=100,
                                **({} if engine == "index" else {"dot": rg.fine_mm.dot}))
    assert it_p == it_r < 30
    mf = pg.fine_mf
    free = ~mf.constraints.constrained_dof_marker()
    to_dof = (lambda x: np.asarray(x)) if engine == "index" else (
        lambda x: pg.fine_mm.to_dof_vector(x).numpy())
    to_dof_r = (lambda x: np.asarray(x)) if engine == "index" else (
        lambda x: np.asarray(rg.fine_mm.to_dof_vector(x)))
    assert np.abs(to_dof(x_p) - to_dof_r(x_r))[free].max() <= 1e-9
    assert np.abs(to_dof(x_p) - xstar)[free].max() <= 1e-6
    if engine == "brick":
        x_d, it_d, res_d = pg.make_device_solver(tol=TOL, max_iter=100)(b_p)
        assert it_d == it_p
        assert np.abs(to_dof(x_d) - to_dof(x_p))[free].max() <= 1e-9
        assert res_d < TOL * float(torch.sqrt(pg.fine_mm.dot(b_p, b_p)))


def test_device_solver_needs_direct_coarse_solve():
    with pytest.raises(NotImplementedError):
        setup("brick-cg")[1].make_device_solver()
