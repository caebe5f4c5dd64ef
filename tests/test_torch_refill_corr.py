"""refill_update's and corr_compact's host tables (``bricks.kernel_tables``:
the written nodes, their holders, the compacted divisor and the validity
bits; the fold runs and their block schedule), checked by replaying each
kernel's index logic in NumPy on them against the plain version (float64,
CPU, relative tolerance 1e-12): for refill_update the bit copy in 16-byte
vectors, then the written-node pass; for corr_compact the run sums block by
block, then the row formula in 16-byte vectors; and refill_update's
least traffic (``bytes_and_flops``) against a count of what its output
needs. The plain versions
themselves are held against the JAX package in test_torch_chain.py
(test_refill_matches_reference) and test_torch_kernels.py
(test_corr_compact)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import (  # noqa: E402
    _refill_tables,
    _runs,
    kernel_tables,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (  # noqa: E402
    corr_compact,
    refill_update,
)
from torch_port_cases import (  # noqa: E402, F401
    CASES, IDS, RTOL, port, port_tables, rel_err, rng_array, release_module_memory,
)

case = pytest.mark.parametrize("geo,nref,p", CASES, ids=IDS)
T = torch.from_numpy
W = 2  # float64 values in a 16-byte vector


def replay_refill(v, u_hat, valid_bits, cell_code, nodes, holders, invden, B):
    """refill_update.cu's index logic: pass 1 a brick at a time in W-value
    vectors with their validity word, pass 2 a written node at a time over
    its 8 holders in order."""
    nb, N3p = v.shape
    n_sub, n_w = invden.shape
    C = B**3
    out = np.empty_like(v)
    i = np.arange(N3p // W)
    m = valid_bits.view(np.uint32)[:, (i * W) >> 5] >> ((i * W) & 31)[None, :]  # [nb, nv]
    for k in range(W):
        out[:, k::W] = np.where((m >> k) & 1, v[:, k::W], 0.0)
    for b in range(n_sub):
        codes = cell_code[b * C:(b + 1) * C]
        val = v[b, nodes]
        acc = np.zeros(n_w)
        for k in range(refill_update.MAX_HOLDERS):
            hv = holders[:, k]
            h = np.where(hv >= 0, codes[np.where(hv >= 0, hv >> 16, 0)], -1)
            use = h >= 0
            acc[use] += u_hat[h[use], hv[use] & 0xFFFF] - val[use]
        valid = (valid_bits.view(np.uint32)[b, nodes >> 5] >> (nodes & 31)) & 1
        out[b, nodes[valid == 1]] = (val + acc * invden[b])[valid == 1]
    return out


def replay_corr(plain, sub_raw, cell_code, keep, seg_ptr, seg_dst, ent_src, blocks):
    """corr_compact.cu's index logic, block by block: the block's run sums
    (each in entry order) into a zeroed buffer of its rows, then its rows in
    W-value vectors, each value by the formula of its row's code."""
    n_rows, n_loc = plain.shape
    out = np.full(n_rows * n_loc, np.nan)
    pl, sr, kp = plain.reshape(-1), sub_raw.reshape(-1), keep.reshape(-1)
    for (r0, s0), (r1, s1) in zip(blocks[:-1], blocks[1:]):
        assert r1 - r0 <= corr_compact.block_rows(n_loc)
        base, count = r0 * n_loc, (r1 - r0) * n_loc
        acc = np.zeros(count)
        d = seg_dst[s0:s1] - base
        assert ((d >= 0) & (d < count)).all() and len(np.unique(d)) == len(d)
        e0, n = seg_ptr[s0:s1], seg_ptr[s0 + 1:s1 + 1] - seg_ptr[s0:s1]
        sums = np.zeros(len(d))
        for t in range(n.max(initial=0)):  # each run's entries in order
            more = t < n
            sums[more] += sr[ent_src[e0[more] + t]]
        acc[d] = sums
        i = np.arange(count)
        g0 = (i // W * W) // n_loc  # the vector's first row and, past its end, its second
        g = np.where(i >= (g0 + 1) * n_loc, g0 + 1, g0)
        c = cell_code[r0 + g]
        j = i - g * n_loc
        o = np.where(c >= 0, c, 0) * n_loc + j
        p = pl[base + i]
        out[base + i] = np.where(c >= 0, np.where(kp[o], (sr[o] + acc) - p, -p),
                                 np.where(c == -2, -p, acc))
    return out.reshape(n_rows, n_loc)


@case
def test_refill_update_replay(geo, nref, p):
    op = port(geo, nref, p)[2]
    v = rng_array(50, op.n_bricks, op.N3p)
    u_hat = rng_array(51, op.n_hn, op.n_loc)
    tables = [t.numpy() if isinstance(t, torch.Tensor) else t for t in op.refill_tables()]
    got = replay_refill(v, u_hat, *tables)
    ref = refill_update.refill_update_plain(T(v), T(u_hat), *op.refill_tables())
    assert rel_err(got, ref) < RTOL
    # every written node has a holder, and the divisor a column per written node
    assert (tables[3][:, 0] >= 0).all() and tables[4].shape == (op.n_sub, tables[2].size)


@case
def test_refill_bound_reads_v_only_where_valid(geo, nref, p):
    """refill_update's least traffic: the output does not move when v
    changes at an invalid node (it is 0 there), so the bound reads v at the
    valid nodes only, invden at the valid written nodes and the u_hat
    entries those read, and writes out at every node."""
    op = port(geo, nref, p)[2]
    v = rng_array(55, op.n_bricks, op.N3p)
    u_hat = rng_array(56, op.n_hn, op.n_loc)
    valid = np.asarray(port_tables(geo, nref, p)[0]["node_valid"]).astype(bool)
    ref = refill_update.refill_update_plain(T(v), T(u_hat), *op.refill_tables())
    v2 = np.where(valid, v, rng_array(57, *v.shape))
    assert np.array_equal(refill_update.refill_update_plain(T(v2), T(u_hat),
                                                            *op.refill_tables()), ref)
    bits, code, nodes, holders, invden, B = [
        t.numpy() if isinstance(t, torch.Tensor) else t for t in op.refill_tables()]
    w_valid = valid[: op.n_sub][:, nodes]
    hv = holders.astype(np.int64)
    codes = code.reshape(op.n_sub, B**3)[:, np.maximum(hv >> 16, 0)]  # [n_sub, n_w, 8]
    used = (hv >= 0) & (codes >= 0) & w_valid[..., None]
    n_uhat = np.unique((codes * op.n_loc + (hv & 0xFFFF))[used]).size
    tables = 4 * (bits.size + code.size + nodes.size + holders.size)
    nbytes, flops = refill_update.bytes_and_flops(T(v), T(u_hat), *op.refill_tables())
    assert nbytes == 8 * (v.size + valid.sum() + n_uhat + w_valid.sum()) + tables
    assert flops == 2 * used.sum() + 2 * w_valid.sum()


@case
def test_corr_compact_replay(geo, nref, p):
    op = port(geo, nref, p)[2]
    plain = rng_array(52, op.n_sub * op.C, op.n_loc)
    sub_raw = rng_array(53, op.n_hn, op.n_loc)
    tables = [t.numpy() for t in op.corr_tables()]
    blocks = tables[-1]
    # the schedule covers every row and run once, each block starting on a row group
    assert blocks[0].tolist() == [0, 0]
    assert blocks[-1].tolist() == [op.n_sub * op.C, tables[3].size]
    assert (np.diff(blocks, axis=0) >= 0).all()
    assert (blocks[:-1, 0] % corr_compact.ROW_GROUP == 0).all()
    got = replay_corr(plain, sub_raw, *tables)
    ref = corr_compact.corr_compact_plain(T(plain), T(sub_raw), *op.corr_tables())
    assert rel_err(got, ref) < RTOL


def test_schedule_spreads_heavy_rows():
    """Blocks hold whole row groups, at most block_rows rows and THREADS
    runs each unless one group alone holds more; the runs of a block are
    those of its rows."""
    rng = np.random.default_rng(54)
    n_loc = 125
    runs = np.where(rng.random(1001) < 0.07, rng.integers(1, 120, 1001), 0)
    runs[400:404] = 100  # one group of 400 runs
    blocks = corr_compact.schedule(runs, n_loc)
    r, s = blocks[:, 0], blocks[:, 1]
    assert r[0] == 0 and r[-1] == len(runs) and (r[:-1] % corr_compact.ROW_GROUP == 0).all()
    assert np.array_equal(s, np.concatenate([[0], np.cumsum(runs)])[r])
    rows, taken = np.diff(r), np.diff(s)
    assert (rows >= 1).all() and (rows <= corr_compact.block_rows(n_loc)).all()
    over = taken > corr_compact.THREADS
    assert (rows[over] <= corr_compact.ROW_GROUP).all() and over.sum() == 1
    assert corr_compact.schedule(np.zeros(0, np.int64), n_loc).tolist() == [[0, 0]]


def test_refill_and_corr_tables_check_what_they_derive():
    """A written node that no cell holds (a padding node), and fold lists
    whose entries are not sorted by destination, raise."""
    t, m = port_tables(*CASES[0])
    k = kernel_tables(t, m)
    slot_idx = np.asarray(t["slot_idx"], dtype=np.int64)
    refill_pos = np.full(m["N3p"], -1, dtype=np.int64)
    refill_pos[k["refill_nodes"]] = np.arange(len(k["refill_nodes"]))
    invden = np.asarray(t["fill_invden_X"])[:, : len(k["refill_nodes"])]
    ok = _refill_tables(refill_pos, slot_idx, invden, np.asarray(t["node_valid"]))
    assert np.array_equal(ok["refill_holders"], k["refill_holders"])
    bad = refill_pos.copy()
    bad[m["N3p"] - 1] = 0  # padding: in no cell
    with pytest.raises(ValueError, match="held by no cell"):
        _refill_tables(bad, slot_idx, invden, np.asarray(t["node_valid"]))
    n_loc = slot_idx.shape[1]
    seg = k["corr_seg_dst"]
    lists = dict(row_ptr=np.searchsorted(np.repeat(seg, np.diff(k["corr_seg_ptr"])) // n_loc,
                                         np.arange(m["n_sub"] * m["B"] ** 3 + 1)),
                 ent_slot=np.repeat(seg % n_loc, np.diff(k["corr_seg_ptr"])),
                 ent_src=k["corr_ent_src"])
    rebuilt = _runs(**lists, n_loc=n_loc)
    assert all(np.array_equal(v, k[f"corr_{key}"]) for key, v in rebuilt.items())
    lists["ent_slot"] = lists["ent_slot"][::-1].copy()
    with pytest.raises(ValueError, match="runs"):
        _runs(**lists, n_loc=n_loc)
