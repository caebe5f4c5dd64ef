"""The PyTorch port's deformed brick engine in 2-D (``BrickLaplaceMM`` on a
2-D ``MatrixFree(..., high_order_mapping=True)``) against the JAX
package's, in float64 on the CPU (the kernels' plain versions): vmult,
vmult_plain and refill at the reference's 2-D deformed case (tests/
test_bricks.py:test_bricks_deformed_mapping, quadrant nref=4 p=3) and one
case a (p, B) class (B = 16 at p <= 3, 8 at p = 4..6); each deformed
kernel's plain version against the reference's function on operators
built from the reference's own tables (``convert.from_reference``);
brick_deformed against the per-cell apply summed over the present cells;
the port's 2-D deformed brick vmult against its 2-D deformed index vmult;
the 2-D metric (3 values a point) in chunks; vmult_multi's refusal. Inputs
are made with numpy from a seed; tolerance 1e-12 relative."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dealii_matrixfree_hanging_nodes_tpu as ref  # noqa: E402
import dealii_matrixfree_hanging_nodes_tpu_torch as mt  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.bricks import BrickLaplaceMM as RefBrickLaplaceMM  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.matrix_free import MatrixFree as RefMatrixFree  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import operator_tables  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.convert import from_reference  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.elements import shape_info  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (  # noqa: E402
    brick_apply, brick_deformed, cell_apply, hn_cell,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.mapping import deformed_laplace_factors  # noqa: E402
from torch_port_cases import (  # noqa: E402,F401 (one_torch_thread: an autouse fixture)
    RTOL, one_torch_thread, reference_meta, rel_err, rng_array,
    release_module_memory,
)

DIM = 2
# (geometry, nref, degree): the reference's 2-D deformed case, then one a (p, B) class
CASES = [
    ("quadrant", 4, 3),
    ("quadrant", 6, 1),
    ("quadrant", 4, 2),
    ("quadrant", 4, 4),
    ("quadrant", 3, 5),
    ("quadrant", 3, 6),
]
IDS = [f"{g}-{n}-p{p}" for g, n, p in CASES]
case = pytest.mark.parametrize("geo,nref,p", CASES, ids=IDS)
T = torch.from_numpy


@functools.lru_cache(maxsize=None)
def engines(geo, nref, p):
    """(reference MatrixFree, its BrickLaplaceMM, its staged arrays, port
    MatrixFree, port BrickLaplaceMM on the CPU), float64, deformed, 2-D."""
    rmf = RefMatrixFree(ref.create_geometry(geo, DIM, nref), p, dtype=np.float64,
                        high_order_mapping=True)
    bl = RefBrickLaplaceMM(rmf)
    pmf = mt.MatrixFree(mt.create_geometry(geo, DIM, nref), p, dtype=np.float64,
                        high_order_mapping=True)
    return rmf, bl, bl._stage(), pmf, mt.BrickLaplaceMM(pmf, device="cpu")


@functools.lru_cache(maxsize=None)
def converted(geo, nref, p):
    """The port's operator on the reference's own tables."""
    bl = engines(geo, nref, p)[1]
    return from_reference(bl._np_arrays, reference_meta(bl), device="cpu", dtype=torch.float64)


def vectors(geo, nref, p, seed):
    """(u, reference brick vector, port brick vector) of a seeded DoF vector."""
    rmf, bl, _, _, op = engines(geo, nref, p)
    u = rng_array(seed, rmf.n_dofs)
    return u, bl.from_dof_vector(u), op.from_dof_vector(u)


# ---- end to end ------------------------------------------------------------------
@case
def test_vmult_matches_reference(geo, nref, p):
    """Reduced outputs, compared as the reference's tests compare them: the
    DoF vectors with the hanging entries zeroed, and the refilled brick
    vectors; the 2-D layout and brick size are the reference's."""
    _, bl, _, _, op = engines(geo, nref, p)
    assert op.dim == DIM and op.deformed and not op.assembled and not op.planes
    assert op.B == bl.bs.B == (16 if p <= 3 else 8) and op.n_hn
    _, rx, px = vectors(geo, nref, p, 0)
    want, got = bl.vmult(rx), op.vmult(px)
    assert got.shape == px.shape
    assert rel_err(op.to_dof_vector(got, zero_hanging=True).numpy(),
                   bl.to_dof_vector(want, zero_hanging=True)) < RTOL
    assert rel_err(op.refill(got).numpy(), np.asarray(bl.refill(want))) < RTOL


@case
def test_vmult_plain_matches_reference(geo, nref, p):
    _, bl, _, _, op = engines(geo, nref, p)
    _, rx, px = vectors(geo, nref, p, 1)
    assert rel_err(op.vmult_plain(px).numpy(), np.asarray(bl.vmult_plain(rx))) < RTOL


@case
def test_refill_matches_reference(geo, nref, p):
    """refill of a vmult output (reduced), as the reference refills it."""
    _, bl, _, _, op = engines(geo, nref, p)
    _, rx, px = vectors(geo, nref, p, 2)
    got = op.refill(op.vmult(px)).numpy()
    assert rel_err(got, np.asarray(bl.refill(bl.vmult(rx)))) < RTOL


@case
def test_vmult_matches_deformed_index_engine(geo, nref, p):
    """The port's 2-D deformed brick vmult against its 2-D deformed index
    vmult (LaplaceOperator), the hanging entries zeroed (the reference's
    test_bricks_deformed_mapping, on the port's two engines)."""
    _, _, _, pmf, op = engines(geo, nref, p)
    u, _, px = vectors(geo, nref, p, 3)
    want = mt.LaplaceOperator(pmf, device="cpu").vmult(u).numpy().copy()
    want[pmf.constraints.constrained_dof_marker()] = 0.0
    assert rel_err(op.to_dof_vector(op.vmult(px), zero_hanging=True).numpy(), want) < RTOL


# ---- each kernel's plain version against the reference's function -----------------
@case
def test_brick_deformed_matches_reference(geo, nref, p):
    """brick_deformed's plain version against _deformed_brick_apply (its 2-D
    branch: whole-brick sweeps on the brick-quad lattice), on the operator
    built from the reference's tables."""
    _, bl, a, _, _ = engines(geo, nref, p)
    op = converted(geo, nref, p)
    assert op.dim == DIM and op.metric.shape[2] == 3
    bv = rng_array(4, op.n_bricks, op.N3p)
    want = bl._deformed_brick_apply(jnp.asarray(bv), a)
    got = brick_deformed.brick_deformed(T(bv), op.metric, op.present_bits, op.S, op.Dc,
                                        brick_size=op.B)
    assert rel_err(got, want) < RTOL


@case
def test_cell_apply_deformed_matches_reference(geo, nref, p):
    """cell_apply's deformed mode against _deformed_cell_apply(cols_u, Gq_sub)."""
    _, bl, a, _, _ = engines(geo, nref, p)
    op = converted(geo, nref, p)
    assert op.n_sub
    u_sub = rng_array(5, op.n_sub, op.N3p)
    want = bl._deformed_cell_apply(bl._extract_cols(jnp.asarray(u_sub), a), a, a["Gq_sub"])
    got = cell_apply.cell_apply(T(u_sub), None, None, None, brick_size=op.B,
                                deformed=op.deformed_tables(op.n_sub * op.C))
    assert got.shape == want.shape == (op.n_sub * op.B**2, (p + 1) ** 2)
    assert rel_err(got, want) < RTOL


@case
def test_hn_cell_deformed_matches_reference(geo, nref, p):
    """hn_cell's deformed mode against _fill_rows -> _deformed_cell_apply(·,
    Gq_hn) -> _hn_apply transposed."""
    _, bl, a, _, _ = engines(geo, nref, p)
    op = converted(geo, nref, p)
    assert op.n_hn
    u_sub = rng_array(6, op.n_sub, op.N3p)
    u_hat = bl._fill_rows(bl._extract_cols(jnp.asarray(u_sub), a), a)
    want = bl._hn_apply(bl._deformed_cell_apply(u_hat, a, a["Gq_hn"]), a, transpose=True)
    got = hn_cell.hn_cell(T(u_sub), *op.hn_tables(), None, None, None, op.B, mode="deformed",
                          deformed=op.deformed_tables())
    assert rel_err(got, want) < RTOL


@case
def test_brick_deformed_is_the_per_cell_sum(geo, nref, p):
    """brick_deformed (the present cells by their bits, B^2 a brick) equals
    cell_apply's deformed rows of every brick cell (absent ones by their
    zero metric) overlap-added into the bricks, with and without cell rows
    in the epilogue."""
    op = engines(geo, nref, p)[4]
    bv = T(rng_array(7, op.n_bricks, op.N3p))
    rows = cell_apply.cell_apply(bv, None, None, None, brick_size=op.B,
                                 deformed=op.deformed_tables())
    want = torch.zeros_like(bv)
    idx = brick_apply.overlap_add_index(op.n_bricks, op.B, op.p, op.N3p)
    want.view(-1).index_add_(0, idx, rows.reshape(-1))
    got = brick_deformed.brick_deformed(bv, op.metric, op.present_bits, op.S, op.Dc,
                                        brick_size=op.B)
    assert rel_err(got, want) < RTOL
    m = max(op.n_sub, 1)
    dcols = T(rng_array(8, m * op.C, op.n_loc))
    want.view(-1).index_add_(0, idx[: dcols.numel()], dcols.reshape(-1))
    got = brick_deformed.brick_deformed(bv, op.metric, op.present_bits, op.S, op.Dc, dcols=dcols,
                                        brick_size=op.B)
    assert rel_err(got, want) < RTOL


# ---- the tables --------------------------------------------------------------------
@case
def test_tables_match_reference(geo, nref, p):
    """The port's 2-D metric in brick-cell rows equals the reference's Gfull
    (its _np_geo_cell), and the operator on the reference's tables has the
    port's present bits (ceil(B^2/32) words a brick) and the vmult of the
    port's own."""
    _, bl, _, pmf, op = engines(geo, nref, p)
    arrays, meta = operator_tables(pmf, op.bs)
    assert meta["deformed"] and not meta["assembled"] and meta["dim"] == DIM
    assert arrays["metric"].shape == (op.n_bricks * op.B**2, (p + 1) ** 2, 3)
    assert rel_err(arrays["metric"], bl._np_geo_cell) < RTOL
    conv = converted(geo, nref, p)
    assert torch.equal(conv.present_bits, op.present_bits)
    assert op.present_bits.shape == (op.n_bricks, -(-op.B**2 // 32))
    _, _, px = vectors(geo, nref, p, 9)
    assert rel_err(conv.vmult(px), op.vmult(px).numpy()) < RTOL


@pytest.mark.parametrize("geo,nref,p", [("quadrant", 4, 4), ("quadrant", 5, 2)],
                         ids=["quadrant-4-p4", "quadrant-5-p2"])
def test_metric_in_chunks_is_bit_identical(geo, nref, p):
    """deformed_laplace_factors in 2-D in chunks of cells gives the one-shot
    values bit for bit, and the reference's."""
    tria, sh = mt.create_geometry(geo, DIM, nref), shape_info(p)
    whole = deformed_laplace_factors(tria, sh, chunk=None)
    assert whole.shape[1:] == ((p + 1) ** 2, 3)
    assert np.array_equal(deformed_laplace_factors(tria, sh, chunk=7), whole)
    rmf = RefMatrixFree(ref.create_geometry(geo, DIM, nref), p, dtype=np.float64,
                        high_order_mapping=True)
    assert rel_err(whole, rmf._np["geo"]) < RTOL


def test_refusals():
    """vmult_multi raises under a deformed mapping in 2-D, as the
    reference's does (bricks.py:3590-3594); face planes and the assembled
    schedule are refused with it."""
    op = engines("quadrant", 4, 3)[4]
    with pytest.raises(NotImplementedError, match="high_order_mapping"):
        op.vmult_multi(torch.zeros(2, op.n_bricks, op.N3p, dtype=op.dtype))
    pmf = engines("quadrant", 4, 2)[3]
    for kw in ({"face_planes": True}, {"assembled": True}):
        with pytest.raises(NotImplementedError):
            mt.BrickLaplaceMM(pmf, device="cpu", **kw)
