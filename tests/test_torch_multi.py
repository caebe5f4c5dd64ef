"""The port's multi-RHS brick vmult (``BrickLaplaceMM.vmult_multi``) against
the JAX package's on the CPU in float64: the reference's own cases and one
a degree class, each RHS against the port's vmult, k=1, the guards, the
right-hand-side axis of each kernel's plain version, and the
from_reference route without face planes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_port_cases import (  # noqa: E402, F401 (one_torch_thread: an autouse fixture)
    RTOL, one_torch_thread, port, reference, reference_meta, rel_err, rng_array,
    release_module_memory,
)

# (geometry, nref, degree, k): the reference's test_vmult_multi_matches_single
# (tests/test_bricks.py:79-95) and one case a degree class (B = 4 at p=4, 2 at
# p=5, the masked removal at p=3 and p=1)
MULTI_CASES = [
    ("quadrant", 3, 2, 3),
    ("annulus", 3, 2, 8),
    ("quadrant", 3, 4, 3),
    ("quadrant", 2, 5, 2),
    ("quadrant", 4, 3, 3),
    ("quadrant", 5, 1, 2),
]
MULTI_IDS = [f"{g}-{n}-p{p}-k{k}" for g, n, p, k in MULTI_CASES]
multi = pytest.mark.parametrize("geo,nref,p,k", MULTI_CASES, ids=MULTI_IDS)


def _vectors(geo, nref, p, k, seed=2):
    """(reference operator, port operator, reference bvk, port bvk): k
    seeded DoF vectors through the reference's constraints.distribute, as
    its test makes them, then each side's from_dof_vector; both operators
    with face_planes=False."""
    _, rmf, bl, _ = reference(geo, nref, p, False)
    op = port(geo, nref, p, False)[2]
    rng = np.random.default_rng(seed)
    vs = [rmf.constraints.distribute(rng.standard_normal(rmf.n_dofs)) for _ in range(k)]
    return (bl, op, jnp.stack([bl.from_dof_vector(v) for v in vs]),
            torch.stack([op.from_dof_vector(v) for v in vs]))


@multi
def test_vmult_multi_matches_reference(geo, nref, p, k):
    """The port's vmult_multi (plain versions on the CPU) against the
    reference's BrickLaplaceMM(mf, face_planes=False).vmult_multi."""
    bl, op, rb, pb = _vectors(geo, nref, p, k)
    assert not op.planes and op.assembled == (p <= 3)
    got = op.vmult_multi(pb)
    assert got.shape == pb.shape
    assert rel_err(got.numpy(), np.asarray(bl.vmult_multi(rb))) < RTOL


@multi
def test_vmult_multi_matches_port_vmult(geo, nref, p, k):
    """Each RHS equals the port's vmult of that RHS, bit for bit, and the
    input is left as it was."""
    _, op, _, pb = _vectors(geo, nref, p, k)
    before = pb.clone()
    got = op.vmult_multi(pb)
    assert torch.equal(pb, before)
    for j in range(k):
        assert torch.equal(got[j], op.vmult(pb[j])), j


@pytest.mark.parametrize("geo,nref,p", [("quadrant", 3, 4), ("quadrant", 4, 3)],
                         ids=["quadrant-3-p4", "quadrant-4-p3"])
def test_vmult_multi_k1_equals_vmult(geo, nref, p):
    _, op, _, pb = _vectors(geo, nref, p, 1)
    got = op.vmult_multi(pb)
    assert got.shape == (1, op.n_bricks, op.N3p)
    assert torch.equal(got[0], op.vmult(pb[0]))


def test_vmult_multi_guards():
    """The reference's guard under face planes (on by default at p=2; the
    quadrant mesh at nref=4 has covered cells), and ValueError on a wrong
    shape, dtype or layout and on k=0."""
    op_planes = port("quadrant", 4, 2)[2]
    assert op_planes.planes
    with pytest.raises(NotImplementedError, match="face_planes"):
        op_planes.vmult_multi(torch.zeros(2, op_planes.n_bricks, op_planes.N3p,
                                          dtype=torch.float64))
    op = port("quadrant", 3, 2, False)[2]
    nb, N3p = op.n_bricks, op.N3p
    bad = [torch.zeros(nb, N3p, dtype=torch.float64),  # no RHS axis
           torch.zeros(0, nb, N3p, dtype=torch.float64),  # k=0
           torch.zeros(2, nb + 1, N3p, dtype=torch.float64),
           torch.zeros(2, nb, N3p - 1, dtype=torch.float64),
           torch.zeros(2, nb, N3p, dtype=torch.float32),
           torch.zeros(nb, 2, N3p, dtype=torch.float64).transpose(0, 1)]  # not contiguous
    for bvk in bad:
        with pytest.raises(ValueError):
            op.vmult_multi(bvk)


def test_rhs_axis_bounds():
    """The kernels' RHS axis: a rank without one is k=1; k=0 and k above
    grid.y's cap raise; a strided subset view keeps its stride."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import _build

    x = torch.zeros(4, 6, 8)
    assert _build.rhs_axis("t", x[0], 2)[:2] == (1, 0)
    k, stride, one = _build.rhs_axis("t", x[:, :3], 2)
    assert (k, stride) == (4, 48) and one.is_contiguous() and one.shape == (3, 8)
    for t in (x[:0], torch.zeros(1, 2, 3).expand(_build.MAX_RHS + 1, 2, 3), x[None]):
        with pytest.raises(ValueError):
            _build.rhs_axis("t", t, 2)


def _plain_rhs_calls(op, k, seed):
    """(name, plain version, RHS-axis arguments, per-RHS arguments for
    RHS j) of the six kernels of vmult_multi at op's shapes: brick_apply
    with k cell-row blocks, cell_apply, hn_cell (both Laplace modes) and
    masked_quad on the strided subset view bvk[:, :n_sub], corr_compact on
    k blocks of rows, dss_surface on k brick vectors (masked_quad and
    dss_surface in place)."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        brick_apply, cell_apply, corr_compact, dss_surface, hn_cell, masked_quad,
    )

    bvk = torch.from_numpy(rng_array(seed, k, op.n_bricks, op.N3p))
    v = torch.from_numpy(rng_array(seed + 1, k, op.n_bricks, op.N3p))
    # strided, as bvk[:, :n_sub] is where the mesh has bricks outside the subset
    sub = torch.from_numpy(rng_array(seed + 5, k, op.n_sub + 1, op.N3p))[:, : op.n_sub]
    assert not sub.is_contiguous()
    rows = torch.from_numpy(rng_array(seed + 2, k, op.n_corr_rows, op.n_loc))
    hn = torch.from_numpy(rng_array(seed + 3, k, op.n_hn, op.n_loc))
    dc = rows if op.assembled else torch.from_numpy(
        rng_array(seed + 4, k, op.n_sub * op.C, op.n_loc))
    hn_tail = (*op.hn_tables(), op.K1, op.M1, op.geo_hn, op.B)
    calls = [
        ("brick_apply", brick_apply.brick_apply_plain,
         lambda j: ((bvk[j], op.Kb, op.Mb, op.geo, op.p),
                    {"dcols": dc[j], "brick_size": op.B}),
         ((bvk, op.Kb, op.Mb, op.geo, op.p), {"dcols": dc, "brick_size": op.B})),
        ("corr_compact", corr_compact.corr_compact_plain,
         lambda j: ((None if op.assembled else rows[j], hn[j], *op.corr_tables()), {}),
         ((None if op.assembled else rows, hn, *op.corr_tables()), {})),
        ("dss_surface", dss_surface.dss_surface_plain,
         lambda j: ((v[j].clone(), *op.dss_tables()), {}),
         ((v.clone(), *op.dss_tables()), {})),
    ]
    calls += [(f"hn_cell-{mode}", hn_cell.hn_cell_plain,
               lambda j, mode=mode: ((sub[j], *hn_tail), {"mode": mode}),
               ((sub, *hn_tail), {"mode": mode})) for mode in hn_cell.MODES]
    if op.assembled:
        kind = "rem" if op.n_hn else "absent"
        mq = (*op.masked_tables(kind), op.K1, op.M1, op.geo, op.B)
        calls.append(("masked_quad", masked_quad.masked_quad_plain,
                      lambda j: ((v[j].clone(), sub[j], *mq), {}),
                      ((v.clone(), sub, *mq), {})))
    else:
        calls.append(("cell_apply", cell_apply.cell_apply_plain,
                      lambda j: ((sub[j], op.K1, op.M1, op.geo_cell_sub), {"brick_size": op.B}),
                      ((sub, op.K1, op.M1, op.geo_cell_sub), {"brick_size": op.B})))
    return calls


@pytest.mark.parametrize("kernel", ["brick_apply", "cell_apply", "hn_cell-full", "hn_cell-fill",
                                    "corr_compact", "dss_surface", "masked_quad"])
def test_plain_kernel_rhs_axis(kernel):
    """Each kernel's plain version with a RHS axis (k=3) equals k calls of
    its single plain version, the subset inputs a strided view of the k
    brick vectors; the wrapper on CPU tensors takes that plain version and
    counts no launch. cell_apply at p=4, masked_quad at p=3 (its schedule),
    the rest at both."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import KERNEL_MODULES

    k = 3
    degrees = {"cell_apply": (4,), "masked_quad": (3,)}.get(kernel, (4, 3))
    for p in degrees:
        op = port("quadrant", 3 if p == 4 else 4, p, False)[2]
        name, plain, one, many = next(c for c in _plain_rhs_calls(op, k, 40 + p)
                                      if c[0] == kernel)
        got = plain(*many[0], **many[1])
        assert got.shape[0] == k
        for j in range(k):
            args, kw = one(j)
            assert torch.equal(got[j], plain(*args, **kw)), (p, j)
        mod = next(m for m in KERNEL_MODULES if m.NAME == name.split("-")[0])
        wrapper = getattr(mod, mod.NAME)
        before = wrapper.launches
        _, _, _, again = next(c for c in _plain_rhs_calls(op, k, 40 + p) if c[0] == kernel)
        assert torch.equal(wrapper(*again[0], **again[1]), got)
        assert wrapper.launches == before


def test_from_reference_without_planes():
    """convert.from_reference takes a reference operator built with
    face_planes=False at p=2 (its meta holds no planes): the operator runs
    without planes, and its vmult_multi equals the port's own setup's."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.convert import from_reference

    bl, op, _, pb = _vectors("quadrant", 3, 2, 3)
    assert not bl._plane_meta
    conv = from_reference(bl._np_arrays, reference_meta(bl), device="cpu", dtype=torch.float64)
    assert not conv.planes and conv.assembled
    assert rel_err(conv.vmult_multi(pb).numpy(), op.vmult_multi(pb).numpy()) < RTOL
