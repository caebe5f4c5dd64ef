"""The PyTorch port's GMG pieces on the index engine and the host setup
(``models.multigrid``: covering_embedding, laplace_diagonal_host,
operator_diagonal, DirichletLaplace, Transfer and its kernel's plain
version, cell_transfer; ChebyshevSmoother; the DoF handler's boundary
DoFs and the manufactured solution) against the JAX package, in float64 on
the CPU: the same inputs, made with numpy from a seed, through the
reference function and its port, to 1e-12 relative; the restriction also
satisfies the adjoint identity with its prolongation to 1e-12. The levels
are quadrant nref 2 -> 3 at p=2 and p=4. The brick engine's GMG pieces are
in ``test_torch_multigrid_bricks.py``, the solves in
``test_torch_multigrid_solve.py``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dealii_matrixfree_hanging_nodes_tpu.models import multigrid as rmg  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.utils.analytic import (  # noqa: E402
    interpolate as ref_interpolate,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.convert import (  # noqa: E402
    matrix_free_from_reference,
    transfer_from_reference,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import cell_transfer  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.models import multigrid as pmg  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.utils.analytic import interpolate  # noqa: E402
from torch_port_cases import (  # noqa: E402, F401 (one_torch_thread: an autouse fixture)
    GMG_DEGREES as DEGREES, RTOL, gmg_levels as levels, one_torch_thread, rel_err, rng_array,
    release_module_memory,
)


def t64(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


@functools.lru_cache(maxsize=None)
def transfers(p):
    """(reference, port) Transfer between the levels."""
    lv = levels(p)
    return rmg.Transfer(lv["rc"], lv["rf"]), pmg.Transfer(lv["pc"], lv["pf"], device="cpu")


def dot(u, v):
    return float(np.sum(np.asarray(u) * np.asarray(v)))


# ---- host setup -------------------------------------------------------------------
@pytest.mark.parametrize("p", DEGREES)
def test_covering_embedding_and_host_diagonal(p):
    lv = levels(p)
    (cov_p, E_p), (cov_r, E_r) = (pmg.covering_embedding(lv["pc"], lv["pf"]),
                                  rmg.covering_embedding(lv["rc"], lv["rf"]))
    assert np.array_equal(cov_p, cov_r)
    assert rel_err(E_p, E_r) <= RTOL
    for k in ("c", "f"):
        assert rel_err(pmg.laplace_diagonal_host(lv["p" + k]),
                       rmg.laplace_diagonal_host(lv["r" + k])) <= RTOL


@pytest.mark.parametrize("p", DEGREES)
def test_dof_handler_boundary_and_interpolation(p):
    """boundary_dofs and the manufactured solution's interpolation
    (utils.analytic) equal the reference's."""
    lv = levels(p)
    pdh, rdh = lv["pf"].dof_handler, lv["rf"].dof_handler
    assert np.array_equal(pdh.boundary_dofs(), rdh.boundary_dofs())
    assert rel_err(interpolate(pdh), ref_interpolate(rdh)) <= RTOL


@pytest.mark.parametrize("p", DEGREES)
def test_operator_diagonal(p):
    """The probed diagonal through the index engine's cell loop (hn_interp,
    the cell kernel, hn_interp transposed, dof_scatter), and the Dirichlet
    operator and its rhs projection, against the reference's."""
    lv = levels(p)
    rop, pop = rmg.DirichletLaplace(lv["rf"]), pmg.DirichletLaplace(lv["pf"], device="cpu")
    assert np.array_equal(pop.bdofs, np.asarray(rop.bdofs))
    assert rel_err(pmg.operator_diagonal(pop, lv["pf"]), rmg.operator_diagonal(rop, lv["rf"])) \
        <= RTOL
    x = rng_array(p, lv["pf"].n_dofs)
    assert rel_err(pop.vmult(t64(x)), rop.vmult(jnp.asarray(x))) <= RTOL
    assert rel_err(pop.project_rhs(t64(x)), rop.project_rhs(jnp.asarray(x))) <= RTOL


# ---- the transfer -----------------------------------------------------------------
@pytest.mark.parametrize("p", DEGREES)
def test_index_transfer(p):
    lv = levels(p)
    rtr, ptr = transfers(p)
    xc, yf = rng_array(10 + p, lv["pc"].n_dofs), rng_array(20 + p, lv["pf"].n_dofs)
    Px = ptr.prolongate(t64(xc))
    Ry = ptr.restrict(t64(yf))
    assert rel_err(Px, rtr.prolongate(jnp.asarray(xc))) <= RTOL
    assert rel_err(Ry, rtr.restrict(jnp.asarray(yf))) <= RTOL
    lhs, rhs = dot(Px, yf), dot(xc, Ry)
    assert abs(lhs - rhs) <= RTOL * abs(lhs)


# ---- cell_transfer's modes on their own -------------------------------------------
@pytest.mark.parametrize("p", DEGREES)
@pytest.mark.parametrize("mode", ["prolongate", "restrict"])
def test_kernel_plain_matches_reference(mode, p):
    """cell_transfer's plain version in each mode, on random inputs, against
    the reference function it replaces: Transfer's gather-embed-own-scatter
    and its cover-sum (before the coarse HN^T and scatter)."""
    lv = levels(p)
    rtr, ptr = transfers(p)
    seed = 70 + 7 * p + len(mode)
    if mode == "prolongate":
        uc = rng_array(seed, lv["pc"].n_cells, (p + 1) ** 3)
        vals = rtr._embed(jnp.asarray(uc)[rtr.cover], rtr.E)
        want = jnp.zeros(lv["rf"].n_dofs).at[rtr._cfg["cdf"].reshape(-1)].add(
            jnp.where(rtr.own_mask, vals, 0).reshape(-1))
        got = cell_transfer.cell_transfer_plain(t64(uc), *ptr.tables(), mode=mode)
    else:
        xf = rng_array(seed, lv["pf"].n_dofs)
        uf = jnp.where(rtr.own_mask, jnp.asarray(xf)[rtr._cfg["cdf"]], 0)
        want = jnp.zeros((lv["rc"].n_cells, (p + 1) ** 3)).at[rtr.cover].add(
            rtr._embed_t(uf, rtr.E))
        got = cell_transfer.cell_transfer_plain(t64(xf), *ptr.tables(), mode=mode)
    assert got.shape == tuple(want.shape)
    assert rel_err(got, want) <= RTOL


@pytest.mark.parametrize("p", DEGREES)
def test_cell_transfer_bound_counts_cdf_at_the_owned_slots(p):
    """Each fine DoF has exactly one owner slot, and cell_transfer's bound
    counts cdf there only: 4 bytes a fine DoF, beside x, out, E, own (one bit
    a slot) and the mode's lists."""
    lv = levels(p)
    ptr = transfers(p)[1]
    E, cdf, own, cover, child_ptr, child, n_fine, _ = ptr.tables()
    assert torch.equal(torch.sort(cdf[own].long()).values, torch.arange(n_fine))
    n_c, n_loc = child_ptr.numel() - 1, (p + 1) ** 3
    bits = (own.numel() + 7) // 8
    for mode, x, lists in (("prolongate", t64(rng_array(5, n_c, n_loc)), cover.numel()),
                           ("restrict", t64(rng_array(6, n_fine)),
                            child_ptr.numel() + child.numel())):
        nbytes, _ = cell_transfer.bytes_and_flops(x, *ptr.tables(), mode=mode)
        assert nbytes == (n_c * n_loc + n_fine + E.numel()) * 8 + 4 * n_fine + bits + 4 * lists


# ---- the smoother ------------------------------------------------------------------
def test_chebyshev_apply():
    """ChebyshevSmoother on the Dirichlet Laplace: the same lmax, and
    apply(b), apply(b, x0) equal to the reference's, at quadrant nref=3 p=2."""
    lv = levels(2)
    mf_r, mf_p = lv["rf"], lv["pf"]
    b = rng_array(80, mf_p.n_dofs)
    b[mf_p.constraints.constrained_dof_marker()] = 0.0
    x0 = mf_p.constraints.distribute(rng_array(81, mf_p.n_dofs))
    rop, pop = rmg.DirichletLaplace(mf_r), pmg.DirichletLaplace(mf_p, device="cpu")
    rsm = rmg.ChebyshevSmoother(rop, rmg.operator_diagonal(rop, mf_r).at[rop.bdofs].set(1.0),
                                degree=4)
    psm = pmg.ChebyshevSmoother(
        pop, pmg.operator_diagonal(pop, mf_p).masked_fill(pop.bmask, 1.0), degree=4)
    b = np.asarray(rop.project_rhs(jnp.asarray(b)))
    assert abs(psm.lmax - rsm.lmax) <= RTOL * rsm.lmax and abs(psm.lmin - rsm.lmin) <= RTOL * rsm.lmin
    assert rel_err(psm.apply(t64(b)), rsm.apply(jnp.asarray(b))) <= RTOL
    assert rel_err(psm.apply(t64(b), x0=t64(x0)),
                   rsm.apply(jnp.asarray(b), x0=jnp.asarray(x0))) <= RTOL


def test_transfer_from_reference():
    """convert.transfer_from_reference: the port's Transfer built from a
    reference Transfer's host tables, on the index engine made from the
    reference's coarse tables, computes the reference's prolongate and
    restrict."""
    lv = levels(2)
    rtr = transfers(2)[0]
    rng = np.random.default_rng(95)
    rc = lv["rc"]
    mfc = matrix_free_from_reference(rc._np, rc.n_dofs)
    tables = dict(cover=rtr.cover, E=rtr.E, own_mask=rtr.own_mask, cdf=rtr._cfg["cdf"],
                  n_fine_dofs=lv["rf"].n_dofs)
    tr = transfer_from_reference(tables, mfc, device="cpu")
    xc, yf = rng.standard_normal(rc.n_dofs), rng.standard_normal(lv["rf"].n_dofs)
    assert rel_err(tr.prolongate(t64(xc)), rtr.prolongate(jnp.asarray(xc))) <= RTOL
    assert rel_err(tr.restrict(t64(yf)), rtr.restrict(jnp.asarray(yf))) <= RTOL
