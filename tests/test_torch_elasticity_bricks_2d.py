"""The PyTorch port's brick elasticity in 2-D (``BrickElasticity`` on 2-D
meshes, two components on bricks of B^2 cells) against the JAX package, in
float64 on the CPU: vmult and vmult_plain at the reference's 2-D case
(tests/test_elasticity_bricks.py: quadrant nref=3 p=2), at p=4 (B=8) and
on the step mesh at p=1, against the reference's BrickElasticity, the
port's 2-D ElasticityOperator and the dense oracle; the rigid-body null
space (two translations, the rotation (-y, x)) and symmetry; the kernels'
plain versions against the reference's steps (brick_elasticity against
_main_apply, cell_elasticity's bricks mode against the el_Kel einsum,
hn_cell's elastic mode against _fill_rows -> el_Kel -> _hn_apply^T); the
component axis of corr_compact and dss_surface at k=2 against two scalar
calls, bit-identical. Inputs are made with numpy from a seed; 1e-12
relative."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dealii_matrixfree_hanging_nodes_tpu as ref  # noqa: E402
import dealii_matrixfree_hanging_nodes_tpu_torch as mt  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.matrix_free import MatrixFree as RefMatrixFree  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.models.elasticity_bricks import (  # noqa: E402
    BrickElasticity as RefBrickElasticity,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.convert import (  # noqa: E402
    brick_elasticity_from_reference,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (  # noqa: E402
    brick_elasticity, corr_compact, dss_surface,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import elasticity_oracle  # noqa: E402
from torch_port_cases import (  # noqa: E402,F401
    RTOL, one_torch_thread, reference_meta, rel_err, rng_array,
    release_module_memory,
)

DIM = 2
# the reference's 2-D case, p=4 (B=8) and the step mesh at p=1
CASES = [("quadrant", 3, 2), ("quadrant", 3, 4), ("step", 3, 1)]
IDS = [f"{g}-{n}-p{p}" for g, n, p in CASES]
MU, LAM = 1.3, 0.7  # mu != lam: a swapped G / G^T pair shows
case = pytest.mark.parametrize("geo,nref,p", CASES, ids=IDS)
# the vmults against the reference also at the other (p, B) classes: p=3 (B=16), p=5, 6 (B=8)
REF_CASES = CASES + [("quadrant", 3, 3), ("quadrant", 3, 5), ("quadrant", 3, 6)]
ref_case = pytest.mark.parametrize("geo,nref,p", REF_CASES,
                                   ids=[f"{g}-{n}-p{p}" for g, n, p in REF_CASES])


@functools.lru_cache(maxsize=None)
def meshes(geo, nref, p):
    """(reference MatrixFree, port MatrixFree), 2-D, float64."""
    return (RefMatrixFree(ref.create_geometry(geo, DIM, nref), p, dtype=np.float64),
            mt.MatrixFree(mt.create_geometry(geo, DIM, nref), p, dtype=np.float64))


@functools.lru_cache(maxsize=None)
def brick_ops(geo, nref, p):
    """(reference BrickElasticity, port BrickElasticity on the CPU)."""
    rmf, pmf = meshes(geo, nref, p)
    return (RefBrickElasticity(rmf, mu=MU, lam=LAM),
            mt.BrickElasticity(pmf, MU, LAM, device="cpu"))


def conforming(mf, seed):
    """A displacement [n_dofs, 2] from the seed with its hanging entries
    interpolated (the reference's brick tests' input)."""
    src = rng_array(seed, mf.n_dofs, DIM)
    for c in range(DIM):
        src[:, c] = mf.constraints.distribute(src[:, c])
    return src


def t64(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def apply(op, u):
    """The brick vmult of a DoF displacement, hanging entries zeroed."""
    return op.to_dof_vector(op.vmult(op.from_dof_vector(u)), zero_hanging=True).numpy()


# ---- the operator --------------------------------------------------------------------
@ref_case
@pytest.mark.parametrize("call", ["vmult", "vmult_plain"])
def test_brick_vmult_matches_reference(geo, nref, p, call):
    rb, pb = brick_ops(geo, nref, p)
    assert pb.dim == DIM and pb.mm.B == (16 if p <= 3 else 8)
    src = conforming(rb.mf, 2)
    want = rb.to_dof_vector(getattr(rb, call)(rb.from_dof_vector(src)), zero_hanging=True)
    x = pb.from_dof_vector(src)
    assert x.shape == (DIM, pb.mm.n_bricks, pb.mm.N3p)
    assert torch.equal(x, t64(np.asarray(rb.from_dof_vector(src))))  # one brick layout
    got = pb.to_dof_vector(getattr(pb, call)(x), zero_hanging=True).numpy()
    assert got.shape == (pb.mm.mf.n_dofs, DIM)
    assert rel_err(got, want) < RTOL


@case
def test_matches_index_engine_and_oracle(geo, nref, p):
    """The port's 2-D brick vmult against its 2-D index vmult (the
    reference's test_brick_elasticity_matches_index, on the port's two
    engines) and against the dense C^T A C oracle."""
    _, pmf = meshes(geo, nref, p)
    src = conforming(pmf, 3)
    got = apply(brick_ops(geo, nref, p)[1], src)
    want = mt.ElasticityOperator(pmf, MU, LAM, device="cpu").vmult(src).numpy()
    assert rel_err(got, want) < RTOL
    assert rel_err(got, elasticity_oracle(pmf.tria, p, MU, LAM, src)) < RTOL


@pytest.mark.parametrize("mode", ["x", "y", "rotation"])
def test_rigid_body_null_space(mode):
    """The two translations (< 1e-11) and the linearized rotation (-y, x)
    (< 1e-10) are in the null space at quadrant nref=3 p=2 (mu = lam = 1)."""
    _, pmf = meshes("quadrant", 3, 2)
    pts = pmf.dof_handler.support_points()
    if mode == "rotation":
        u, tol = np.stack([-pts[:, 1], pts[:, 0]], axis=1), 1e-10
    else:
        u, tol = np.zeros((pmf.n_dofs, DIM)), 1e-11
        u[:, "xy".index(mode)] = 1.0
    op = mt.BrickElasticity(pmf, device="cpu")
    assert np.abs(apply(op, u)).max() < tol


def test_symmetric():
    """(A x, y) == (x, A y) on conforming inputs at quadrant nref=3 p=2."""
    _, pmf = meshes("quadrant", 3, 2)
    x, y = conforming(pmf, 4), conforming(pmf, 5)
    op = mt.BrickElasticity(pmf, device="cpu")
    ax, ay = apply(op, x), apply(op, y)
    assert abs((ax * y).sum() - (x * ay).sum()) < 1e-9 * abs((ax * y).sum())


# ---- the kernels' plain versions against the reference's steps -------------------
@case
def test_cell_rows_match_el_kel(geo, nref, p):
    """cell_elasticity's bricks mode in 2-D against the reference's el_Kel
    einsum ([2, 2, n^2, n^2] blocks) on the same subset cell rows, times
    geo_cell_sub."""
    rb, pb = brick_ops(geo, nref, p)
    a = rb._stage()
    Kel = np.asarray(rb._extras_np["el_Kel"])
    assert Kel.shape == (DIM, DIM, (p + 1) ** 2, (p + 1) ** 2)
    bv = rng_array(6, DIM, pb.mm.n_bricks, pb.mm.N3p)
    mm = rb.mm
    u_sub = mm._take_sub_multi(jnp.asarray(bv.reshape(-1, pb.mm.N3p)), a, DIM)
    cols = np.asarray(mm._extract_cols(u_sub, a)).reshape(DIM, -1, pb.mm.n_loc)
    want = np.einsum("knj,ckij->cni", cols, Kel) * np.asarray(a["geo_cell_sub"])[None, :, None]
    got = pb.cell_rows(t64(bv)).numpy()
    assert rel_err(got, want) < RTOL


@case
def test_hn_rows_match_reference(geo, nref, p):
    """hn_cell's elastic mode in 2-D (plain) against the reference's
    _fill_rows -> el_Kel -> _hn_apply(transpose) on the same rows."""
    rb, pb = brick_ops(geo, nref, p)
    assert pb.mm.n_hn > 0
    a = rb._stage()
    mm = rb.mm
    bv = rng_array(7, DIM, pb.mm.n_bricks, pb.mm.N3p)
    u_sub = mm._take_sub_multi(jnp.asarray(bv.reshape(-1, pb.mm.N3p)), a, DIM)
    u3 = jnp.swapaxes(mm._extract_cols(u_sub, a).reshape(DIM, -1, pb.mm.n_loc), 0, 1)
    u_hat = mm._fill_rows(u3, a)
    own = jnp.einsum("nkj,ckij->nci", u_hat, a["el_Kel"]) * jnp.take(
        a["geo_cell_sub"], a["hn_sub"])[:, None, None]
    want = np.swapaxes(np.asarray(mm._hn_apply(own, a, transpose=True)), 0, 1)
    got = pb.hn_rows(t64(bv)).numpy()
    assert got.shape == (DIM, pb.mm.n_hn, pb.mm.n_loc)
    assert rel_err(got, want) < RTOL


@case
def test_brick_operator_matches_main_apply(geo, nref, p):
    """brick_elasticity's plain version (without cell rows) against the
    reference's 2-D _main_apply (the dense el_A{c}{k}) times geo, on the
    brick nodes; the packed factors rebuild the dense ones exactly."""
    rb, pb = brick_ops(geo, nref, p)
    a = rb._stage()
    N3 = pb.mm.N3
    bv = rng_array(8, DIM, pb.mm.n_bricks, pb.mm.N3p)
    want = np.asarray(rb._main_apply(jnp.asarray(bv[:, :, :N3]), a)) * np.asarray(
        a["geo"])[None, :, None]
    got = pb.brick_apply(t64(bv), None)
    assert torch.all(got[:, :, N3:] == 0)
    assert rel_err(got[:, :, :N3].numpy(), want) < RTOL
    packed = brick_elasticity.brick_elasticity_plain(t64(bv), pb.packed_host, pb.mm.geo, p,
                                                     MU, LAM)
    assert torch.equal(packed, got)


@pytest.mark.parametrize("p", [2, 4])
def test_least_schedule_computes_the_operator(p):
    """The 2-D schedule that brick_elasticity's bound counts
    (``least_schedule(2)``: 16 factor applications a brick, the kernel's
    own): x sweeps by distinct (input, x factor), the terms grouped by
    (output, y factor) before the y sweeps; against the plain version's
    term-by-term sum, on random cell factors."""
    rng = np.random.default_rng(p)
    K1, M1, G1 = (rng.standard_normal((p + 1, p + 1)) for _ in range(3))
    fac = brick_elasticity.brick_factors(K1, M1, G1, 2)
    NB = 2 * p + 1
    u = rng.standard_normal((DIM, NB, NB))  # (component, y, x)
    xs, ys = {}, {}
    for c in range(DIM):
        for k in range(DIM):
            for coef, (fx, fy) in brick_elasticity.terms(c, k, MU, LAM, DIM):
                if (k, fx) not in xs:
                    xs[k, fx] = np.einsum("Xx,yx->yX", fac[fx], u[k])
                ys[c, fy] = ys.get((c, fy), 0) + coef * xs[k, fx]
    got = np.zeros_like(u)
    for (c, fy), grouped in ys.items():
        got[c] += np.einsum("Yy,yx->Yx", fac[fy], grouped)
    assert len(xs) + len(ys) == brick_elasticity.least_schedule(DIM)[0] == 16
    bv = torch.from_numpy(u.reshape(DIM, 1, NB**2))
    want = brick_elasticity.brick_elasticity_plain(
        bv, {n: t64(fac[n]) for n in ("K", "M", "G")}, torch.ones(1, dtype=torch.float64), p,
        MU, LAM)
    assert rel_err(got.reshape(DIM, 1, -1), want.numpy()) < RTOL


# ---- the component axis at k = 2 ----------------------------------------------------
@case
def test_corr_compact_components_match_scalar_calls(geo, nref, p):
    mm = brick_ops(geo, nref, p)[1].mm
    plain = t64(rng_array(10, DIM, mm.n_sub * mm.C, mm.n_loc))
    sub_raw = t64(rng_array(11, DIM, mm.n_hn, mm.n_loc))
    got = corr_compact.corr_compact(plain, sub_raw, *mm.corr_tables())
    assert got.shape == plain.shape
    for c in range(DIM):
        assert torch.equal(got[c], corr_compact.corr_compact(plain[c], sub_raw[c],
                                                             *mm.corr_tables()))


@case
def test_dss_surface_components_match_scalar_calls(geo, nref, p):
    mm = brick_ops(geo, nref, p)[1].mm
    v = t64(rng_array(12, DIM, mm.n_bricks, mm.N3p))
    got = dss_surface.dss_surface(v.clone(), *mm.dss_tables())
    for c in range(DIM):
        assert torch.equal(got[c], dss_surface.dss_surface(v[c].clone(), *mm.dss_tables()))


# ---- the state carried across ---------------------------------------------------------
def test_brick_elasticity_from_reference():
    """The port's 2-D brick elasticity on the reference's scalar tables
    (``convert.brick_elasticity_from_reference``) computes the reference's
    vmult and vmult_plain."""
    rb, _ = brick_ops("quadrant", 3, 2)
    mm = rb.mm
    op = brick_elasticity_from_reference(mm._np_arrays, reference_meta(mm), MU, LAM,
                                         device="cpu", dtype=torch.float64)
    assert op.dim == DIM
    bv = rb.from_dof_vector(conforming(rb.mf, 14))
    for call in ("vmult", "vmult_plain"):
        want = np.asarray(getattr(rb, call)(bv))
        assert rel_err(getattr(op, call)(t64(np.asarray(bv))).numpy(), want) < RTOL
