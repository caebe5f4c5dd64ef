"""The kernels' index tables of the hanging-node chain (``bricks.kernel_tables``)
against the dense one-hot tables they are derived from, and ``refill``
against the JAX package (float64, CPU, relative tolerance 1e-12). The
chain's plain versions themselves are held against the JAX functions in
test_torch_kernels.py (test_hn_apply, test_fill_rows, test_corr_compact)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import (  # noqa: E402
    dense_corr,
    dense_fill,
    kernel_tables,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (  # noqa: E402
    corr_compact,
    hn_cell,
)
from torch_port_cases import (  # noqa: E402, F401
    CASES, IDS, RTOL, port, port_tables, reference, rel_err, rng_array,
    release_module_memory,
)

case = pytest.mark.parametrize("geo,nref,p", CASES, ids=IDS)
T = torch.from_numpy


@case
def test_index_tables_reproduce_dense_products(geo, nref, p):
    """On random rows the index lists compute what the dense T stacks and
    composite Q matrices compute: the per-Q slot lists in both
    orientations, and the host-composed fill and fold chains. The two
    quadrant p=4 cases have a 7-pair fill tail and a 3-pair fold tail, as
    the bench mesh (quadrant nref=7) has."""
    t, m = port_tables(geo, nref, p)
    k = {key: T(np.ascontiguousarray(v)) for key, v in kernel_tables(t, m).items()}
    n_hn, n_loc = t["keep_hn"].shape
    rows = rng_array(30, n_hn, n_loc)
    for qi, Q in enumerate(t["hn_Q"]):
        q = torch.full((n_hn,), qi, dtype=torch.int32)
        for d, Qd in (("fwd", Q), ("bwd", Q.T)):
            got = hn_cell.hn_apply_plain(T(rows), q, k[f"hn_{d}_ptr"], k[f"hn_{d}_col"],
                                         k[f"hn_{d}_w"])
            assert rel_err(got, rows @ Qd) < RTOL
    u_sub = rng_array(31, m["n_sub"], m["N3p"])
    got = hn_cell.fill_hn_plain(T(u_sub), k["hn_sub"], k["keep_hn"], k["fill_row_ptr"],
                                k["fill_ent_slot"], k["fill_ent_src"], m["B"])
    assert rel_err(got, dense_fill(t, m, u_sub)) < RTOL
    plain = rng_array(32, m["n_sub"] * m["B"] ** 3, n_loc)
    got = corr_compact.corr_compact_plain(T(plain), T(rows), k["cell_code"], k["keep_hn"],
                                          k["corr_seg_ptr"], k["corr_seg_dst"],
                                          k["corr_ent_src"], k["corr_blocks"])
    assert rel_err(got, dense_corr(t, m, plain, rows)) < RTOL


def test_kernel_tables_reject_a_non_permutation():
    """A transfer matrix with a weight other than 1 is not a slot copy: the
    host build raises instead of handing it to the kernels."""
    t, m = port_tables(*CASES[0])
    si = m["fill_segs"][0][0]
    bad = dict(t)
    bad[f"fill_T{si}"] = t[f"fill_T{si}"] * 2.0
    with pytest.raises(ValueError, match="partial permutation"):
        kernel_tables(bad, m)


@case
def test_refill_matches_reference(geo, nref, p):
    """refill (hn_cell's fill mode, refill_update) on a random brick vector."""
    _, _, bl, _ = reference(geo, nref, p)
    op = port(geo, nref, p)[2]
    v = rng_array(33, op.n_bricks, op.N3p)
    ref = np.asarray(bl.refill(jnp.asarray(v)))
    assert rel_err(op.refill(T(v)), ref) < RTOL
    assert torch.equal(op.refill(T(v), plain=True), op.refill(T(v)))
