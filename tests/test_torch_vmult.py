"""The port's whole constrained vmult against the JAX package's
BrickLaplaceMM.vmult and the scipy oracle, plus refill / to_dof_vector,
dot / norm and the from_reference route (float64, CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_port_cases import (  # noqa: E402
    CASES, IDS, RTOL, port, reference, reference_meta, rel_err, rng_array,
)

case = pytest.mark.parametrize("geo,nref,p", CASES, ids=IDS)


@case
def test_vmult_matches_reference(geo, nref, p):
    _, rmf, bl, _ = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    u = rng_array(0, rmf.n_dofs)
    ref = np.asarray(bl.vmult(bl.from_dof_vector(u)))
    bv = op.from_dof_vector(u)
    np.testing.assert_array_equal(bv.numpy(), np.asarray(bl.from_dof_vector(u)))
    assert rel_err(op.vmult(bv), ref) < RTOL


@case
def test_vmult_matches_oracle(geo, nref, p):
    from dealii_matrixfree_hanging_nodes_tpu.oracle import vmult_oracle

    rtria, rmf, _, _ = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    u = rng_array(1, rmf.n_dofs)
    ref = vmult_oracle(rtria, p, u)
    got = op.to_dof_vector(op.vmult(op.from_dof_vector(u)), zero_hanging=True)
    assert rel_err(got, ref) < RTOL


@case
def test_refill_roundtrip_invariant(geo, nref, p):
    """Analog of the reference's test_brick_vmult_matches_operator invariant:
    vmult outputs are reduced; refill restores the hanging copies, and the
    DoF-vector round trip of the output reproduces the refilled vector."""
    _, rmf, bl, _ = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    u = rng_array(2, rmf.n_dofs)
    out = op.vmult(op.from_dof_vector(u))
    base = op.refill(out)
    assert rel_err(base, np.asarray(bl.refill(jnp.asarray(out.numpy())))) < RTOL
    out2 = op.from_dof_vector(op.to_dof_vector(out))
    inv = float((base - out2).abs().max())
    assert inv < RTOL * max(1.0, float(base.abs().max()))


@case
def test_dot_and_norm(geo, nref, p):
    _, rmf, bl, _ = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    x = rng_array(3, op.n_bricks, op.N3p)
    y = rng_array(4, op.n_bricks, op.N3p)
    ref = float(bl.dot(jnp.asarray(x), jnp.asarray(y)))
    got = float(op.dot(torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(got - ref) < RTOL * abs(ref) + 1e-12
    np.testing.assert_array_equal(op.dot_mask().numpy(), np.asarray(bl.dot_mask()))
    ref_n = float(bl.norm(jnp.asarray(x)))
    assert abs(float(op.norm(torch.from_numpy(x))) - ref_n) < RTOL * ref_n


@case
def test_from_reference_matches_own_setup(geo, nref, p):
    """The operator built from the reference engine's host tables computes
    what the port's own setup computes."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.convert import from_reference

    _, rmf, bl, _ = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    conv = from_reference(bl._np_arrays, reference_meta(bl), device="cpu",
                          dtype=torch.float64)
    bv = op.from_dof_vector(rng_array(5, rmf.n_dofs))
    assert rel_err(conv.vmult(bv), op.vmult(bv)) < RTOL
    assert rel_err(conv.refill(bv), op.refill(bv)) < RTOL


@case
def test_port_oracle_matches_reference_oracle(geo, nref, p):
    from dealii_matrixfree_hanging_nodes_tpu.oracle import vmult_oracle as ref_oracle
    from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import vmult_oracle

    rtria, rmf, _, _ = reference(geo, nref, p)
    ptria = port(geo, nref, p)[0]
    u = rng_array(6, rmf.n_dofs)
    assert rel_err(vmult_oracle(ptria, p, u), ref_oracle(rtria, p, u)) < RTOL


@pytest.mark.parametrize("geo,nref,p", [("uniform", 2, 4), ("annulus", 4, 4)],
                         ids=["no-subset", "holes-only"])
def test_vmult_without_constrained_rows(geo, nref, p):
    """The branches with no subset bricks (a uniform mesh) and with a
    subset of hole cells but no constrained rows."""
    from dealii_matrixfree_hanging_nodes_tpu.oracle import vmult_oracle

    rtria, rmf, bl, _ = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    assert op.n_hn == 0 and (op.n_sub == 0) == (geo == "uniform")
    u = rng_array(9, rmf.n_dofs)
    out = op.vmult(op.from_dof_vector(u))
    assert rel_err(out, np.asarray(bl.vmult(bl.from_dof_vector(u)))) < RTOL
    assert torch.equal(op.refill(out), out)
    ref = vmult_oracle(rtria, p, u)
    assert rel_err(op.to_dof_vector(out, zero_hanging=True), ref) < RTOL


def test_roundtrip_identity():
    """Non-hanging dofs round-trip exactly; hanging ones carry distributed
    values."""
    _, mf, op = port(*CASES[0])
    u = rng_array(7, mf.n_dofs)
    v = op.to_dof_vector(op.from_dof_vector(u)).numpy()
    free = ~mf.constraints.constrained_dof_marker()
    np.testing.assert_array_equal(v[free], u[free])
    np.testing.assert_allclose(v, mf.constraints.distribute(u), rtol=0, atol=1e-13)


def test_float32_operator_follows_float64():
    """The constructor's dtype casts the float64 host tables; the float32
    vmult agrees with the float64 one to float32 accuracy."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    _, mf, op = port(*CASES[1])
    op32 = mt.BrickLaplaceMM(mf, device="cpu", dtype=torch.float32)
    assert op32.Kb.dtype == torch.float32
    bv = op.from_dof_vector(rng_array(8, mf.n_dofs))
    assert rel_err(op32.vmult(bv.float()).double(), op.vmult(bv)) < 1e-5
