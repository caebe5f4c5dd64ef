"""The PyTorch port's brick GMG in 2-D (``models.multigrid_bricks`` on 2-D
brick operators: DofEmbed, BrickTransfer, BrickDirichletLaplace,
BrickChebyshev, BrickGMGPreconditioner and its device solver) against the
JAX package, in float64 on the CPU: DofEmbed and BrickTransfer between
quadrant nref 3 and 4 at p=1..6 (B = 16 at p <= 3, 8 at p = 4..6) against
the reference's, the restriction adjoint to the prolongation in the
operators' inner product to 1e-12; brick_transfer's and dof_embed's plain
versions against the reference functions they replace; the V-cycle, and
the GMG-CG solve at quadrant nref=4, p=2 and p=4, tol 1e-10: the
reference's iteration count exactly (7), the solution to 1e-9, the device
solver's count. Inputs are made with numpy from a seed; 1e-12 relative."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dealii_matrixfree_hanging_nodes_tpu as ref  # noqa: E402
import dealii_matrixfree_hanging_nodes_tpu_torch as mt  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.bricks import BrickLaplaceMM as RefBrick  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.matrix_free import MatrixFree as RefMatrixFree  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.models import multigrid as rmg  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.models import multigrid_bricks as rmb  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import brick_transfer, dof_embed  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.models import multigrid as pmg  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.models import multigrid_bricks as pmb  # noqa: E402
from torch_port_cases import (  # noqa: E402, F401 (one_torch_thread: an autouse fixture)
    RTOL, one_torch_thread, rel_err, rng_array, release_module_memory,
)

DIM = 2
DEGREES = (1, 2, 3, 4, 5, 6)
COARSE, FINE = 3, 4  # the transfer tests' levels: quadrant nref 3 -> 4
SOLVE_NREF, SOLVE_DEGREES, TOL = 4, (2, 4), 1e-10


def t64(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


@functools.lru_cache(maxsize=None)
def levels(p):
    """The reference's and the port's coarse and fine 2-D brick operators at
    degree p (face_planes=False, as the GMG builds them): dict rbc, rbf,
    pbc, pbf, and their MatrixFree rc, rf, pc, pf."""
    out = {}
    for key, nref in (("c", COARSE), ("f", FINE)):
        rmf = RefMatrixFree(ref.create_quadrant(DIM, nref), p, dtype=np.float64)
        pmf = mt.MatrixFree(mt.create_quadrant(DIM, nref), p, dtype=np.float64)
        out.update({"r" + key: rmf, "p" + key: pmf,
                    "rb" + key: RefBrick(rmf, face_planes=False),
                    "pb" + key: mt.BrickLaplaceMM(pmf, device="cpu", face_planes=False)})
    return out


@functools.lru_cache(maxsize=None)
def transfers(p):
    """(reference, port) BrickTransfer between the levels."""
    lv = levels(p)
    return rmb.BrickTransfer(lv["rbc"], lv["rbf"]), pmb.BrickTransfer(lv["pbc"], lv["pbf"])


# ---- DofEmbed and BrickTransfer at every degree -------------------------------------
@pytest.mark.parametrize("p", DEGREES)
def test_dof_embed(p):
    """embed, extract, and embed_t against jax.linear_transpose of the
    reference's embed, on the coarse 2-D brick level."""
    lv = levels(p)
    rde, pde = rmb.DofEmbed(lv["rbc"]), pmb.DofEmbed(lv["pbc"])
    assert lv["pbc"].dim == DIM and pde.shape == (lv["pbc"].n_bricks, lv["pbc"].N3p)
    x = rng_array(30 + p, lv["pc"].n_dofs)
    bv = rng_array(40 + p, *pde.shape)
    assert rel_err(pde.embed(t64(x)), rde.embed(jnp.asarray(x), rde.tables)) <= RTOL
    assert rel_err(pde.extract(t64(bv)), rde.extract(jnp.asarray(bv), rde.tables)) <= RTOL
    (ref_t,) = jax.linear_transpose(lambda v: rde.embed(v, rde.tables),
                                    jax.ShapeDtypeStruct((lv["rc"].n_dofs,), jnp.float64))(
        jnp.asarray(bv))
    assert rel_err(pde.embed_t(t64(bv)), ref_t) <= RTOL


@pytest.mark.parametrize("p", DEGREES)
def test_brick_transfer(p):
    """prolongate and restrict against the reference's, and the adjoint
    identity in the reduced-space inner product (the operators' dot); the
    tables are 2-D (E [nlin_f, 2, n, n], 4 parity classes)."""
    lv = levels(p)
    rtr, ptr = transfers(p)
    assert ptr.E_rows.shape[1] == DIM and ptr.r_ptr.shape[1] == 5
    xc = lv["pc"].constraints.distribute(rng_array(50 + p, lv["pc"].n_dofs))
    yf = lv["pf"].constraints.distribute(rng_array(60 + p, lv["pf"].n_dofs))
    xb_r, yb_r = lv["rbc"].from_dof_vector(xc), lv["rbf"].from_dof_vector(yf)
    xb_p, yb_p = lv["pbc"].from_dof_vector(xc), lv["pbf"].from_dof_vector(yf)
    Px, Ry = ptr.prolongate(xb_p), ptr.restrict(yb_p)
    assert rel_err(Px, rtr.prolongate(xb_r)) <= RTOL
    assert rel_err(Ry, rtr.restrict(yb_r)) <= RTOL
    lhs, rhs = float(lv["pbf"].dot(Px, yb_p)), float(lv["pbc"].dot(xb_p, Ry))
    assert abs(lhs - rhs) <= RTOL * abs(lhs)


# ---- each kernel mode's plain version against the reference's function -------------
def _ref_pb_transpose(rtr, yw):
    d, ac, af = rtr._dev, rtr.mm_c._stage(), rtr.mm_f._stage()
    shape = jax.ShapeDtypeStruct((rtr.mm_c.bs.n_bricks, rtr.mm_c.N3p), jnp.float64)
    return jax.linear_transpose(lambda x: rtr._pb(x, d, ac, af), shape)(yw)[0]


@pytest.mark.parametrize("p", (2, 4))
@pytest.mark.parametrize("kernel,mode", [("brick_transfer", "prolongate"),
                                         ("brick_transfer", "restrict"),
                                         ("dof_embed", "embed"), ("dof_embed", "embed_t")])
def test_kernel_plain_matches_reference(kernel, mode, p):
    """Each kernel mode's plain version on its own, on random 2-D inputs,
    against the reference function it replaces: BrickTransfer._pb and its
    jax.linear_transpose of W_f r, DofEmbed.embed and its transpose."""
    lv = levels(p)
    rbt, pbt = transfers(p)
    seed = 70 + 7 * p + len(mode)
    if kernel == "brick_transfer":
        if mode == "prolongate":
            xb = rng_array(seed, lv["pbc"].n_bricks, lv["pbc"].N3p)
            want = rbt._pb(jnp.asarray(xb), rbt._dev, rbt.mm_c._stage(), rbt.mm_f._stage())
        else:
            xb = rng_array(seed, lv["pbf"].n_bricks, lv["pbf"].N3p)
            want = _ref_pb_transpose(rbt, jnp.asarray(xb) * rbt.mm_f.dot_mask())
        got = brick_transfer.brick_transfer_plain(t64(xb), *pbt.tables(), mode=mode)
    else:
        rde, pde = rmb.DofEmbed(lv["rbc"]), pbt.embed_c
        if mode == "embed":
            x = rng_array(seed, lv["pc"].n_dofs)
            want = rde.embed(jnp.asarray(x), rde.tables)
            got = dof_embed.dof_embed_plain(t64(x), *pde.tables(mode), pde.shape)
        else:
            x = rng_array(seed, *pde.shape)
            want = jax.linear_transpose(lambda v: rde.embed(v, rde.tables),
                                        jax.ShapeDtypeStruct((lv["rc"].n_dofs,), jnp.float64))(
                jnp.asarray(x))[0]
            got = dof_embed.dof_embed_plain(t64(x), *pde.tables(mode), (pde.n_dofs,))
    assert got.shape == tuple(want.shape)
    assert rel_err(got, want) <= RTOL


@pytest.mark.parametrize("mode", ["prolongate", "restrict"])
def test_brick_transfer_bound_reads_what_the_output_needs(mode):
    """The nodes that brick_transfer's bound counts as read are enough in
    2-D: the output is unchanged when x is zeroed everywhere else; in
    restrict they are exactly the fine nodes where W_f is 1."""
    lv = levels(4)
    pbt = transfers(4)[1]
    mm = lv["pbc" if mode == "prolongate" else "pbf"]
    x = t64(rng_array(90 + len(mode), mm.n_bricks, mm.N3p))
    read = brick_transfer.read_nodes(x, *pbt.tables(), mode=mode)
    kept = torch.zeros(x.numel(), dtype=x.dtype)
    kept[read] = x.reshape(-1)[read]
    full = brick_transfer.brick_transfer_plain(x, *pbt.tables(), mode=mode)
    assert torch.equal(brick_transfer.brick_transfer_plain(kept.reshape(x.shape), *pbt.tables(),
                                                           mode=mode), full)
    if mode == "restrict":
        assert torch.equal(read, torch.nonzero(mm.dot_mask_b.reshape(-1))[:, 0])


# ---- the smoother and the solve -----------------------------------------------------
def test_brick_chebyshev_apply():
    """BrickDirichletLaplace's vmult and project_rhs, and BrickChebyshev on
    the 2-D fine level at p=2: lmax, apply(b) and apply(b, x0) as the
    reference's."""
    lv = levels(2)
    mf_p = lv["pf"]
    b = rng_array(80, mf_p.n_dofs)
    b[mf_p.constraints.constrained_dof_marker()] = 0.0
    x0 = mf_p.constraints.distribute(rng_array(81, mf_p.n_dofs))
    rbo, pbo = rmb.BrickDirichletLaplace(lv["rbf"]), pmb.BrickDirichletLaplace(lv["pbf"])
    diag = pmg.laplace_diagonal_host(mf_p)
    diag[mf_p.dof_handler.boundary_dofs()] = 1.0
    inv = np.where(diag > 0, 1.0 / np.where(diag > 0, diag, 1.0), 0.0)
    rsm = rmb.BrickChebyshev(rbo, lv["rbf"].from_dof_vector(inv), degree=3)
    psm = pmb.BrickChebyshev(pbo, lv["pbf"].from_dof_vector(inv), degree=3)
    conv_r, conv_p = lv["rbf"].from_dof_vector, lv["pbf"].from_dof_vector
    assert rel_err(pbo.vmult(conv_p(x0)), rbo.vmult(conv_r(x0))) <= RTOL
    assert rel_err(pbo.project_rhs(conv_p(b)), rbo.project_rhs(conv_r(b))) <= RTOL
    assert abs(psm.lmax - rsm.lmax) <= RTOL * rsm.lmax
    assert rel_err(psm.apply(conv_p(b)), rsm.apply(conv_r(b))) <= RTOL
    assert rel_err(psm.apply(conv_p(b), x0=conv_p(x0)),
                   rsm.apply(conv_r(b), x0=conv_r(x0))) <= RTOL


@functools.lru_cache(maxsize=None)
def gmg(p):
    """(reference, port) 2-D brick GMG at quadrant nref=SOLVE_NREF, degree p,
    and the manufactured x* (zero on the boundary)."""
    rg = rmb.BrickGMGPreconditioner("quadrant", DIM, SOLVE_NREF, p)
    pg = pmb.BrickGMGPreconditioner("quadrant", DIM, SOLVE_NREF, p, device="cpu")
    mf = pg.fine_mf
    xstar = mf.constraints.distribute(rng_array(4, mf.n_dofs))
    xstar[mf.dof_handler.boundary_dofs()] = 0.0
    return rg, pg, xstar


@pytest.mark.parametrize("p", SOLVE_DEGREES)
def test_vcycle_matches_reference(p):
    rg, pg, _ = gmg(p)
    assert all(mm.dim == DIM for mm in pg.mms) and len(pg.mms) == SOLVE_NREF
    b = rng_array(5, pg.fine_mf.n_dofs)
    b[pg.fine_mf.dof_handler.boundary_dofs()] = 0.0
    b = pg.fine_mf.constraints.distribute(b)
    assert rel_err(pg(pg.fine_mm.from_dof_vector(b)), rg(rg.fine_mm.from_dof_vector(b))) <= RTOL


@functools.lru_cache(maxsize=None)
def reference_solve(p):
    """The reference's solve_cg with its brick GMG at tol 1e-10 on x*'s
    right-hand side: (rhs, solution as a DoF vector, iterations)."""
    rg, _, xstar = gmg(p)
    b_r = rg.fine_op.vmult(rg.fine_mm.from_dof_vector(xstar))
    x_r, it_r, _ = rmg.solve_cg(rg.fine_op, b_r, M=rg, tol=TOL, max_iter=100, dot=rg.fine_mm.dot)
    return b_r, np.asarray(rg.fine_mm.to_dof_vector(x_r)), it_r


@pytest.mark.parametrize("p", SOLVE_DEGREES)
def test_gmg_cg_matches_reference(p):
    """solve_cg with the brick GMG at tol 1e-10: the reference's iteration
    count (7 at both degrees), the solutions within 1e-9 on the free DoFs
    and near x*."""
    _, pg, xstar = gmg(p)
    b_r, x_r, it_r = reference_solve(p)
    b_p = pg.fine_op.vmult(pg.fine_mm.from_dof_vector(xstar))
    assert rel_err(b_p, b_r) <= RTOL
    x_p, it_p, _ = pmg.solve_cg(pg.fine_op, b_p, M=pg, tol=TOL, max_iter=100, dot=pg.fine_mm.dot)
    assert it_p == it_r == 7
    free = ~pg.fine_mf.constraints.constrained_dof_marker()
    got = pg.fine_mm.to_dof_vector(x_p).numpy()
    assert np.abs(got - x_r)[free].max() <= 1e-9
    assert np.abs(got - xstar)[free].max() <= 1e-6


@pytest.mark.parametrize("p", SOLVE_DEGREES)
def test_device_solver_takes_the_reference_count(p):
    """make_device_solver in 2-D (the recurrence of the reference's
    device-resident loop): the reference's CG count and solution."""
    _, pg, xstar = gmg(p)
    _, x_r, it_r = reference_solve(p)
    b_p = pg.fine_op.vmult(pg.fine_mm.from_dof_vector(xstar))
    x_d, it_d, res_d = pg.make_device_solver(tol=TOL, max_iter=100)(b_p)
    assert it_d == it_r == 7
    assert res_d < TOL * float(torch.sqrt(pg.fine_mm.dot(b_p, b_p)))
    free = ~pg.fine_mf.constraints.constrained_dof_marker()
    assert np.abs(pg.fine_mm.to_dof_vector(x_d).numpy() - x_r)[free].max() <= 1e-9
