"""The port's degree <= 3 schedule against the JAX package's BrickLaplaceMM
on the CPU in float64: the masked removal at p <= 3 and the face planes at
p <= 2 (setup tables, the plain versions of the new kernels, vmult,
vmult_plain and refill, the from_reference route), and vmult_plain at
p >= 4 (the cols path)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_port_cases import (  # noqa: E402, F401
    CASES, IDS, LOW_CASES, LOW_IDS, RTOL, port, port_tables, reference, reference_meta, rel_err,
    rng_array,
    release_module_memory,
)

low = pytest.mark.parametrize("geo,nref,p", LOW_CASES, ids=LOW_IDS)
planes = pytest.mark.parametrize(
    "geo,nref,p", [c for c in LOW_CASES if c[2] <= 2], ids=[i for i, c in zip(LOW_IDS, LOW_CASES)
                                                             if c[2] <= 2])


def _vectors(geo, nref, p, seed):
    """(reference operator, port operator, port brick vector, the same for
    the reference) from one seeded DoF vector."""
    _, rmf, bl, _ = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    u = rng_array(seed, rmf.n_dofs)
    return bl, op, op.from_dof_vector(u), bl.from_dof_vector(u)


@low
def test_schedule_is_the_references(geo, nref, p):
    """The port takes the reference's degree gates: the masked removal at
    p <= 3, face planes (with covered cells) at p <= 2."""
    _, _, bl, _ = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    assert op.assembled and bl._use_masked_removal
    assert op.planes == bl._face_planes == (p <= 2)
    assert (op.bs.plane_covered.sum() > 0) == (p <= 2)
    assert op.n_chainb == bl._n_chainb and op.n_sub == bl._n_sub


@low
def test_setup_tables_match_reference(geo, nref, p):
    """The brick structure's plane groups and covered cells, and the
    operator tables of the degree <= 3 schedule, against the reference's."""
    _, _, bl, _ = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    arrays, meta = port_tables(geo, nref, p)
    ra = bl._np_arrays
    np.testing.assert_array_equal(op.bs.plane_covered, bl.bs.plane_covered)
    assert len(op.bs.plane_groups) == len(bl.bs.plane_groups)
    for g, rg in zip(op.bs.plane_groups, bl.bs.plane_groups):
        for k in ("level", "d", "s", "c_pl", "offs"):
            assert g[k] == rg[k], k
        for k in ("fine", "coarse", "cover"):
            np.testing.assert_array_equal(g[k], rg[k])
    if p <= 2:
        np.testing.assert_array_equal(op.bs.plane_P1, bl.bs.plane_P1)
    assert meta["plane_meta"] == bl._plane_meta
    assert meta["n_chainb"] == bl._n_chainb
    np.testing.assert_array_equal(arrays["hn_sub"], ra["hn_sub"])
    np.testing.assert_array_equal(arrays["absent_sub"], ra["absent_sub"])
    names = ["Sqb", "Dqb", "w1", "qmask_absent", "qmask_rem"]
    if p <= 2:
        names += ["plane_W", "plane_P1"] + [f"plane{i}_{k}" for i in range(len(meta["plane_meta"]))
                                          for k in ("fine", "coarse", "cover")]
    for k in names:
        np.testing.assert_allclose(arrays[k], ra[k], rtol=RTOL, atol=0, err_msg=k)


@low
def test_vmult_matches_reference(geo, nref, p):
    bl, op, bv, rb = _vectors(geo, nref, p, 10)
    np.testing.assert_array_equal(bv.numpy(), np.asarray(rb))
    assert rel_err(op.vmult(bv), np.asarray(bl.vmult(rb))) < RTOL


@low
def test_vmult_plain_matches_reference(geo, nref, p):
    bl, op, bv, rb = _vectors(geo, nref, p, 11)
    assert rel_err(op.vmult_plain(bv), np.asarray(bl.vmult_plain(rb))) < RTOL


@low
def test_refill_matches_reference(geo, nref, p):
    """refill of a vmult output (under face planes: the plane fill, then the
    residual chain) and the DoF-vector round trip it restores."""
    bl, op, bv, _ = _vectors(geo, nref, p, 12)
    out = op.vmult(bv)
    base = op.refill(out)
    assert rel_err(base, np.asarray(bl.refill(jnp.asarray(out.numpy())))) < RTOL
    out2 = op.from_dof_vector(op.to_dof_vector(out))
    assert float((base - out2).abs().max()) < RTOL * max(1.0, float(base.abs().max()))


@low
def test_vmult_matches_port_oracle(geo, nref, p):
    from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import vmult_oracle

    tria, mf, op = port(geo, nref, p)
    u = rng_array(13, mf.n_dofs)
    got = op.to_dof_vector(op.vmult(op.from_dof_vector(u)), zero_hanging=True)
    assert rel_err(got, vmult_oracle(tria, p, u)) < RTOL


@low
def test_masked_quad_plain_matches_reference(geo, nref, p):
    """masked_quad's plain version on its cell lists against the
    reference's _masked_quad_apply on its geo-premultiplied masks, for the
    absent and constrained cells (rem) and the absent cells alone."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import masked_quad

    bl, op, bv, _ = _vectors(geo, nref, p, 14)
    a = bl._stage()
    u_sub = bv[: op.n_sub]
    for kind, mask in (("rem", "qmask_rem"), ("absent", "qmask_absent")):
        ref = -np.asarray(bl._masked_quad_apply(jnp.asarray(u_sub.numpy()), a, a[mask]))
        got = masked_quad.masked_quad_plain(torch.zeros_like(bv), bv, *op.masked_tables(kind),
                                            op.K1, op.M1, op.geo, op.B)
        assert not got[op.n_sub:].any()
        assert rel_err(got[: op.n_sub], ref) < RTOL, kind


@planes
def test_plane_fill_and_fold_plain_match_reference(geo, nref, p):
    """plane_fill's and plane_fold's plain versions on the host-composed
    tables against the reference's level-by-level _plane_fill and
    _plane_corr (on a brick vector: its padding N3..N3p is zero, as the
    reference's outputs make it); the fill leaves its input as it was."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import plane_fill, plane_fold

    bl, op, bv, _ = _vectors(geo, nref, p, 15)
    a = bl._stage()
    x = torch.from_numpy(rng_array(16, op.n_bricks, op.N3p))
    x[:, op.N3:] = 0.0
    x0 = x.clone()
    filled = plane_fill.plane_fill_plain(x, *op.plane_fill_tables())
    assert torch.equal(x, x0)
    assert rel_err(filled, np.asarray(bl._plane_fill(jnp.asarray(x.numpy()), a))) < RTOL
    folded = plane_fold.plane_fold_plain(x.clone(), *op.plane_fold_tables())
    assert rel_err(folded, np.asarray(bl._plane_corr(jnp.asarray(x.numpy()), a))) < RTOL
    assert not folded.view(-1)[op.plane_cov.long()].any()


@low
def test_from_reference_matches_own_setup(geo, nref, p):
    from dealii_matrixfree_hanging_nodes_tpu_torch.convert import from_reference

    bl, op, bv, _ = _vectors(geo, nref, p, 17)
    conv = from_reference(bl._np_arrays, reference_meta(bl), device="cpu", dtype=torch.float64)
    assert conv.assembled and conv.planes == op.planes
    for fn in ("vmult", "vmult_plain", "refill"):
        assert rel_err(getattr(conv, fn)(bv), getattr(op, fn)(bv)) < RTOL, fn


@pytest.mark.parametrize("geo,nref,p", CASES, ids=IDS)
def test_vmult_plain_matches_reference_high_degree(geo, nref, p):
    """vmult_plain at p >= 4: cell_apply, corr_compact with the absent rows'
    codes and no runs, brick_apply's epilogue, dss_surface."""
    bl, op, bv, rb = _vectors(geo, nref, p, 18)
    assert not op.assembled
    assert rel_err(op.vmult_plain(bv), np.asarray(bl.vmult_plain(rb))) < RTOL
