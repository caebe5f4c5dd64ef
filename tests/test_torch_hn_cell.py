"""hn_cell, the constrained rows of the vmult in one kernel, on CPU tensors
(its plain version) against the JAX package's functions on the same inputs
(float64, relative tolerance 1e-12): the full mode against the reference's
fill, Q, K and Q^T of the constrained rows (bricks.py:2465-2474), the fill
mode against ``_fill_rows`` (bricks.py:2687-2694)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import hn_cell  # noqa: E402
from torch_port_cases import (  # noqa: E402, F401
    CASES, IDS, RTOL, port, reference, rel_err, rng_array, release_module_memory,
)


@pytest.mark.parametrize("mode", hn_cell.MODES)
@pytest.mark.parametrize("geo,nref,p", CASES, ids=IDS)
def test_hn_cell_matches_reference(geo, nref, p, mode):
    _, _, bl, a = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    u_sub = rng_array(40, op.n_sub, op.N3p)
    u_hat = bl._fill_rows(bl._extract_cols(jnp.asarray(u_sub), a), a)
    if mode == "fill":
        ref = u_hat
    else:
        geo_hn = jnp.take(a["geo_cell_sub"], a["hn_sub"])[:, None]
        ref = bl._hn_apply(jnp.dot(u_hat, a["K"].T) * geo_hn, a, transpose=True)
    before = hn_cell.hn_cell.launches
    got = hn_cell.hn_cell(torch.from_numpy(u_sub), *op.hn_tables(), *op.factors_host,
                          op.geo_hn, op.B, mode=mode)
    assert hn_cell.hn_cell.launches == before  # CPU tensors: the plain version
    assert got.shape == (op.n_hn, op.n_loc)
    assert rel_err(got, ref) < RTOL
