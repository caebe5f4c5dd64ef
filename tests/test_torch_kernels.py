"""Each kernel's plain PyTorch version, and each step of the plain fold/HN
chain, against the JAX package's function on the same inputs (float64,
CPU, relative tolerance 1e-12)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (  # noqa: E402
    KERNEL_MODULES,
    brick_apply,
    cell_apply,
    cols_overlap_add,
    dss_surface,
)
from torch_port_cases import CASES, IDS, RTOL, port, reference, rel_err, rng_array  # noqa: E402

case = pytest.mark.parametrize("geo,nref,p", CASES, ids=IDS)
T = torch.from_numpy


@case
def test_brick_apply(geo, nref, p):
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    bv = rng_array(1, op.n_bricks, op.N3p)
    ref = bl._main_apply(jnp.asarray(bv), a) * a["geo"][:, None]
    got = brick_apply.brick_apply(T(bv), op.Kb, op.Mb, op.geo, op.p)
    assert rel_err(got, ref) < RTOL


@case
def test_cell_apply_from_bricks(geo, nref, p):
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    u_sub = rng_array(2, op.n_sub, op.N3p)
    ref = jnp.dot(bl._extract_cols(jnp.asarray(u_sub), a), a["K"].T) * a["geo_cell_sub"][:, None]
    got = cell_apply.cell_apply(T(u_sub), op.K, op.geo_cell_sub, brick_size=op.B)
    assert got.shape == ref.shape
    assert rel_err(got, ref) < RTOL


@case
def test_cell_apply_from_rows(geo, nref, p):
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    rows = rng_array(3, op.n_hn, op.n_loc)
    ref = jnp.dot(jnp.asarray(rows), a["K"].T) * jnp.take(a["geo_cell_sub"], a["hn_sub"])[:, None]
    got = cell_apply.cell_apply(T(rows), op.K, op.geo_hn)
    assert rel_err(got, ref) < RTOL


@case
def test_cols_overlap_add(geo, nref, p):
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    v_sub = rng_array(4, op.n_sub, op.N3p)
    cols = rng_array(5, op.n_sub * op.C, op.n_loc)
    ref = jnp.asarray(v_sub) + bl._scatter_cols(jnp.asarray(cols), a)
    v = T(v_sub.copy())
    out = cols_overlap_add.cols_overlap_add(v, T(cols), brick_size=op.B)
    assert out is v  # in place
    # the padded tail is untouched (the reference's corr is zero there)
    assert rel_err(out, ref) < RTOL


@case
def test_dss_surface(geo, nref, p):
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    v = rng_array(6, op.n_bricks, op.N3p)
    ref = bl._dss_fill(jnp.asarray(v), a, None)
    got = dss_surface.dss_surface(T(v), op.face_other, op.edge_contrib,
                                  op.corner_contrib, op.node_valid, op.NB)
    assert rel_err(got, ref) < RTOL


@case
def test_fill_rows(geo, nref, p):
    """_fill_rows = _fill_hn_compact then _hn_apply forward."""
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    u_sub = rng_array(7, op.n_sub, op.N3p)
    ref = bl._fill_rows(bl._extract_cols(jnp.asarray(u_sub), a), a)
    assert rel_err(op._fill_rows(T(u_sub)), ref) < RTOL
    ref_c = bl._fill_hn_compact(bl._extract_cols(jnp.asarray(u_sub), a), a)
    assert rel_err(op._fill_hn_compact(T(u_sub)), ref_c) < RTOL


@case
@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "transposed"])
def test_hn_apply(geo, nref, p, transpose):
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    rows = rng_array(8, op.n_hn, op.n_loc)
    ref = bl._hn_apply(jnp.asarray(rows), a, transpose=transpose)
    assert rel_err(op._hn_apply(T(rows), transpose=transpose), ref) < RTOL


@case
def test_corr_compact(geo, nref, p):
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    plain = rng_array(9, op.n_sub * op.C, op.n_loc)
    sub_raw = rng_array(10, op.n_hn, op.n_loc)
    hn = np.asarray(a["hn_sub"])
    ref = bl._corr_compact(jnp.asarray(plain), jnp.asarray(plain[hn]),
                           jnp.asarray(sub_raw), a)
    got = op._corr_compact(T(plain), T(sub_raw))  # reads plain at hn_sub itself
    assert rel_err(got, ref) < RTOL


@pytest.mark.parametrize("mod", KERNEL_MODULES, ids=lambda m: m.NAME)
def test_cpu_tensors_take_the_plain_version(mod):
    """On CPU tensors a wrapper computes its plain version and launches
    nothing, so its launch count stays put."""
    geo, nref, p = CASES[0]
    op = port(geo, nref, p)[2]
    wrapper = getattr(mod, mod.NAME)
    plain = getattr(mod, f"{mod.NAME}_plain")
    before = wrapper.launches
    bricks = lambda seed: T(rng_array(seed, op.n_bricks, op.N3p))
    sub = lambda seed: T(rng_array(seed, op.n_sub, op.N3p))
    cells = lambda seed: T(rng_array(seed, op.n_sub * op.C, op.n_loc))
    hn_rows = lambda seed: T(rng_array(seed, op.n_hn, op.n_loc))
    args, kw = {
        "brick_apply": lambda: ((bricks(11), op.Kb, op.Mb, op.geo, op.p), {}),
        "cell_apply": lambda: ((sub(12), op.K, op.geo_cell_sub), {"brick_size": op.B}),
        "cols_overlap_add": lambda: ((sub(13), cells(14)), {"brick_size": op.B}),
        "dss_surface": lambda: ((bricks(15), op.face_other, op.edge_contrib,
                                 op.corner_contrib, op.node_valid, op.NB), {}),
        "hn_apply": lambda: ((hn_rows(16), op.hn_q, op.hn_fwd_ptr, op.hn_fwd_col,
                              op.hn_fwd_w), {}),
        "fill_hn": lambda: ((sub(17), op.hn_sub, op.keep_hn, op.fill_row_ptr,
                             op.fill_ent_slot, op.fill_ent_src, op.B), {}),
        "corr_compact": lambda: ((cells(18), hn_rows(19), op.cell_code, op.keep_hn,
                                  op.corr_row_ptr, op.corr_ent_slot, op.corr_ent_src), {}),
        "refill_update": lambda: ((bricks(20), hn_rows(21), op.node_valid, op.cell_code,
                                   op.refill_pos, op.fill_invden_X, op.B), {}),
    }[mod.NAME]()
    clone = lambda xs: [x.clone() if isinstance(x, torch.Tensor) else x for x in xs]
    got = wrapper(*clone(args), **kw)
    want = plain(*clone(args), **kw)
    assert torch.equal(got, want)
    assert wrapper.launches == before
