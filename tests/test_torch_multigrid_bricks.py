"""The PyTorch port's GMG pieces on the brick engine (``models.
multigrid_bricks``: DofEmbed, BrickDirichletLaplace, BrickTransfer,
BrickChebyshev, and the plain versions of their kernels, brick_transfer and
dof_embed; ``BrickLaplaceMM``'s face_planes argument; ``convert``'s
transfer) against the JAX package, in float64 on the CPU: the same inputs,
made with numpy from a seed, through the reference function and its port,
to 1e-12 relative; the restriction also satisfies the adjoint identity
with its prolongation in the operators' inner product to 1e-12. The levels
are quadrant nref 2 -> 3 at p=2 and p=4, the brick operators built with
face_planes=False as the reference's GMG builds them."""

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
from dealii_matrixfree_hanging_nodes_tpu.models import multigrid_bricks as rmb  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.convert import (  # noqa: E402
    from_reference,
    transfer_from_reference,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import brick_transfer, dof_embed  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.models import multigrid as pmg  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.models import multigrid_bricks as pmb  # noqa: E402
from torch_port_cases import (  # noqa: E402, F401 (one_torch_thread: an autouse fixture)
    GMG_DEGREES as DEGREES, RTOL, gmg_bricks, gmg_levels, one_torch_thread, reference_meta,
    rel_err, rng_array,
)


def t64(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


@functools.lru_cache(maxsize=None)
def levels(p):
    """The MatrixFree levels (rc, rf, pc, pf) and their brick operators
    (rbc, rbf, pbc, pbf) at degree p."""
    return {**gmg_levels(p), **gmg_bricks(p)}


@functools.lru_cache(maxsize=None)
def transfers(p):
    """(reference, port) BrickTransfer between the levels."""
    lv = levels(p)
    return rmb.BrickTransfer(lv["rbc"], lv["rbf"]), pmb.BrickTransfer(lv["pbc"], lv["pbf"])


# ---- DofEmbed and BrickTransfer ---------------------------------------------------
@pytest.mark.parametrize("p", DEGREES)
def test_dof_embed(p):
    """embed, extract, and embed_t against jax.linear_transpose of the
    reference's embed, on the coarse brick level."""
    lv = levels(p)
    rde, pde = rmb.DofEmbed(lv["rbc"]), pmb.DofEmbed(lv["pbc"])
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
    identity in the reduced-space inner product (the operators' dot)."""
    lv = levels(p)
    rtr, ptr = transfers(p)
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


@pytest.mark.parametrize("p", DEGREES)
@pytest.mark.parametrize("kernel,mode", [("brick_transfer", "prolongate"),
                                         ("brick_transfer", "restrict"),
                                         ("dof_embed", "embed"), ("dof_embed", "embed_t")])
def test_kernel_plain_matches_reference(kernel, mode, p):
    """Each kernel mode's plain version on its own, on random inputs, against
    the reference function it replaces: BrickTransfer._pb and its
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


@pytest.mark.parametrize("p", DEGREES)
@pytest.mark.parametrize("mode", ["prolongate", "restrict"])
def test_brick_transfer_bound_reads_what_the_output_needs(mode, p):
    """The nodes that brick_transfer's bound counts as read are enough: the
    output is unchanged when x is zeroed everywhere else. In restrict they
    are exactly the fine nodes where the dot mask W_f is 1."""
    lv = levels(p)
    pbt = transfers(p)[1]
    mm = lv["pbc" if mode == "prolongate" else "pbf"]
    x = t64(rng_array(90 + p + len(mode), mm.n_bricks, mm.N3p))
    read = brick_transfer.read_nodes(x, *pbt.tables(), mode=mode)
    kept = torch.zeros(x.numel(), dtype=x.dtype)
    kept[read] = x.reshape(-1)[read]
    full = brick_transfer.brick_transfer_plain(x, *pbt.tables(), mode=mode)
    assert torch.equal(brick_transfer.brick_transfer_plain(kept.reshape(x.shape), *pbt.tables(),
                                                           mode=mode), full)
    if mode == "restrict":
        assert torch.equal(read, torch.nonzero(mm.dot_mask_b.reshape(-1))[:, 0])


def test_embed_t_fold_matches_a_master_that_is_a_slave():
    """embed_t's composed slave fold equals the transpose of the reference's
    ``x.at[slave].set(upd)`` when a master is itself a slave: a constraint
    chain on a hand-made table (node i holds DoF i), checked against the
    dense transpose of the same two steps."""
    n, N3, N3p = 5, 5, 8
    node_dof = np.arange(n)
    # DoF 1 is a slave of 0 and 2; DoF 3 a slave of 1 (a slave) and 4
    slave, row_ptr = np.array([1, 3]), np.array([0, 2, 4])
    col, w = np.array([0, 2, 1, 4]), np.array([0.5, 0.5, 0.25, 0.75])
    t = dof_embed.tables(node_dof, slave, row_ptr, col, w, n, N3, N3p)
    D = np.eye(n)
    D[1] = [0.5, 0, 0.5, 0, 0]
    D[3] = [0, 0.25, 0, 0, 0.75]  # reads DoF 1 before it is set
    S = np.zeros((N3p, n))
    S[np.arange(n), node_dof] = 1.0
    x = rng_array(1, n)
    y = rng_array(2, N3p)
    y[n:] = 0.0
    assert rel_err(dof_embed.dof_embed_plain(t64(x), *map(torch.from_numpy, t["embed"]), (N3p,)),
                   S @ D @ x) <= RTOL
    assert rel_err(dof_embed.dof_embed_plain(t64(y), *map(torch.from_numpy, t["embed_t"]), (n,)),
                   (S @ D).T @ y) <= RTOL


# ---- the smoother ------------------------------------------------------------------
def test_brick_chebyshev_apply():
    """BrickDirichletLaplace's vmult and project_rhs, and BrickChebyshev:
    the same lmax, and apply(b), apply(b, x0) equal to the reference's, at
    quadrant nref=3 p=2."""
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
    assert abs(psm.lmax - rsm.lmax) <= RTOL * rsm.lmax and abs(psm.lmin - rsm.lmin) <= RTOL * rsm.lmin
    assert rel_err(psm.apply(conv_p(b)), rsm.apply(conv_r(b))) <= RTOL
    assert rel_err(psm.apply(conv_p(b), x0=conv_p(x0)),
                   rsm.apply(conv_r(b), x0=conv_r(x0))) <= RTOL


# ---- the face-plane argument and convert ------------------------------------------
def test_face_planes_argument():
    """BrickLaplaceMM(face_planes=False) at p=2, on a mesh where the default
    (None: on at p <= 2) builds planes, against the reference's: the
    assembled schedule without planes, as the GMG levels run it; vmult and
    refill, also through convert.from_reference. (The default with planes
    is held against the reference in test_torch_lowdeg.py.)"""
    tria_r, tria_p = ref.create_quadrant(3, 4), mt.create_quadrant(3, 4)
    rmf = RefMatrixFree(tria_r, 2, dtype=np.float64)
    pmf = mt.MatrixFree(tria_p, 2, dtype=np.float64)
    assert mt.BrickStructure(pmf).plane_groups and mt.BrickStructure(pmf, None).face_planes
    rop = RefBrick(rmf, face_planes=False)
    pop = mt.BrickLaplaceMM(pmf, device="cpu", face_planes=False)
    assert not pop.planes and not rop._plane_meta and pop.assembled
    conv = from_reference({k: np.asarray(v) for k, v in rop._np_arrays.items()},
                          reference_meta(rop), device="cpu", dtype=torch.float64)
    assert conv.planes == pop.planes
    u = rng_array(90, pmf.n_dofs)
    xr, xp = rop.from_dof_vector(u), pop.from_dof_vector(u)
    for fn in ("vmult", "refill"):
        want = getattr(rop, fn)(xr)
        assert rel_err(getattr(pop, fn)(xp), want) <= RTOL
        assert rel_err(getattr(conv, fn)(xp), want) <= RTOL


def test_transfer_from_reference():
    """convert.transfer_from_reference: the port's BrickTransfer built from a
    reference BrickTransfer's host tables (and its coarse DofEmbed's)
    computes the reference's prolongate and restrict."""
    rbt = transfers(2)[0]
    rng = np.random.default_rng(95)
    mmc = rbt.mm_c
    tables = dict(rbt._dev, **rbt._sc, wf=rbt.mm_f.dot_mask(), n_dofs_c=mmc.mf.n_dofs,
                  n_bricks_c=mmc.bs.n_bricks, B=mmc.bs.B, N3=mmc.N3, N3p=mmc.N3p)
    tr = transfer_from_reference(tables, device="cpu")
    xb = rbt.mm_c.from_dof_vector(mmc.mf.constraints.distribute(
        rng.standard_normal(mmc.mf.n_dofs)))
    yb = rng.standard_normal((rbt.mm_f.bs.n_bricks, rbt.mm_f.N3p))
    assert rel_err(tr.prolongate(t64(xb)), rbt.prolongate(xb)) <= RTOL
    assert rel_err(tr.restrict(t64(yb)), rbt.restrict(jnp.asarray(yb))) <= RTOL
