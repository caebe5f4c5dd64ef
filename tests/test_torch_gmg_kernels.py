"""The brick GMG's two kernels as they run on the card since their redesign,
on the CPU: ``dof_embed``'s split of each mode's destinations (the rows of
more than LONG_ROW entries listed, a warp each; the others a thread each)
and ``brick_transfer``'s schedules (the prolongation's rounds of distinct
parents, the restriction's rows by parity class with each row's coarse
slot). Their invariants, and a CPU mirror of each kernel's summation in
the kernel's order (pure PyTorch, used only here): each mirror is held bit
for bit against the plain version in float64, and against the JAX
package's ``DofEmbed.embed`` (and its transpose) and ``BrickTransfer._pb``
(and its transpose of W_f r) to 1e-12 relative, at 3-D quadrant nref 4 ->
5 p=4 (embed_t rows of up to 296 entries, 1,285 of them long), 3-D
nref 2 -> 3 p=2 (B=8) and 2-D pairs at p=4 (B=8) and p=2 (B=16); the
mirrors also run with rounds cut to a few rows, so that a cell's rows and a
brick's parents span rounds. The card's checks are in
tests/test_torch_isolation.py (marked ``cuda``)."""

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
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import brick_transfer, dof_embed  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.cell_apply import brick_slot_index  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.cell_transfer import embed_rows  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.models import multigrid_bricks as pmb  # noqa: E402
from torch_port_cases import (  # noqa: E402, F401 (fixtures)
    RTOL, one_torch_thread, rel_err, release_module_memory, rng_array,
)

# (dim, coarse nref, p): the transfer from quadrant nref to nref + 1
PAIRS = [(3, 4, 4), (3, 2, 2), (2, 5, 4), (2, 4, 2)]
PAIR_IDS = [f"{d}d-nref{n}-p{p}" for d, n, p in PAIRS]
pair_case = pytest.mark.parametrize("dim,nref,p", PAIRS, ids=PAIR_IDS)
CUT = "cut"  # the mirrors' cut runs: rounds of 2^dim + 1 rows (and parents)
T = torch.from_numpy


@functools.lru_cache(maxsize=None)
def levels(dim, nref, p):
    """The reference's and the port's brick operators on quadrant nref and
    nref + 1 (face_planes=False, as the GMG builds them), float64: dict
    rc, rf, pc, pf (MatrixFree) and rbc, rbf, pbc, pbf."""
    out = {}
    for key, n in (("c", nref), ("f", nref + 1)):
        rmf = RefMatrixFree(ref.create_quadrant(dim, n), p, dtype=np.float64)
        pmf = mt.MatrixFree(mt.create_quadrant(dim, n), p, dtype=np.float64)
        out.update({"r" + key: rmf, "p" + key: pmf,
                    "rb" + key: RefBrick(rmf, face_planes=False),
                    "pb" + key: mt.BrickLaplaceMM(pmf, device="cpu", face_planes=False)})
    return out


@functools.lru_cache(maxsize=None)
def transfers(dim, nref, p):
    """(reference, port) BrickTransfer between the levels."""
    lv = levels(dim, nref, p)
    return rmb.BrickTransfer(lv["rbc"], lv["rbf"]), pmb.BrickTransfer(lv["pbc"], lv["pbf"])


def tables_with_cap(pbt, cap):
    """pbt's tables with the prolongation's rounds rebuilt at `cap` rows and
    parents a round (the kernel's own cap where cap is None)."""
    tabs = dict(zip(("src_lin", "E", "own") + brick_transfer.LISTS, pbt.tables()[:-1]))
    if cap is not None:
        p_ptr, p_rows, src_lin = tabs["p_ptr"], tabs["p_rows"], tabs["src_lin"]
        B, dim = pbt.B, pbt.E_rows.shape[1]
        sched = brick_transfer.prolongate_schedule(
            p_rows.numpy(), src_lin.numpy()[p_rows.numpy()], B**dim, p_ptr.numel() - 1, cap)
        for k, a in zip(("p_rows", "p_par", "p_slot", "p_sched", "p_bround"), sched):
            tabs[k] = T(a)
    return tuple(tabs.values()) + (pbt.B,)


# ---- dof_embed -------------------------------------------------------------------------
def embed_mirror(x, ptr, idx, w, long, shape):
    """dof_embed as the kernel sums: a row of at most LONG_ROW entries by its
    thread, a listed long row by its warp, 32 entries a step folded in list
    order; either way acc = 0, then acc + w[e] x[idx[e]] in list order
    (rows by position, all at once). Checks that every destination has
    exactly one writer."""
    xf = x.reshape(-1)
    n = ptr.numel() - 1
    length = (ptr[1:] - ptr[:-1]).long()
    out = torch.full((n,), float("nan"), dtype=x.dtype)
    writers = torch.zeros(n, dtype=torch.long)
    short = torch.nonzero(length <= dof_embed.LONG_ROW)[:, 0]
    for rows in (short, long.long()):
        acc = torch.zeros(len(rows), dtype=x.dtype)
        lens = length[rows]
        for step in range(0, int(lens.max()) if len(rows) else 0, 32):
            for k in range(step, step + 32):
                live = k < lens
                e = ptr[rows][live].long() + k
                acc[live] = acc[live] + w[e] * xf[idx[e].long()]
        out[rows] = acc
        writers[rows] += 1
    assert torch.equal(writers, torch.ones(n, dtype=torch.long)), "a destination without one writer"
    return out.reshape(shape)


@pair_case
def test_embed_tables_split_every_destination_once(dim, nref, p):
    """Each mode's long list is exactly its rows of more than LONG_ROW
    entries, ascending, so the thread-a-row blocks (which skip those) and
    the warps cover every destination once; the 3-D nref=4 p=4 level's
    embed_t rows hold up to 296 entries (embed's up to 25)."""
    de = transfers(dim, nref, p)[1].embed_c
    for mode in dof_embed.MODES:
        ptr, idx, w, long = de.tables(mode)
        length = (ptr[1:] - ptr[:-1]).numpy()
        want = np.nonzero(length > dof_embed.LONG_ROW)[0]
        assert long.dtype == torch.int32 and np.array_equal(long.numpy(), want)
        assert np.all(np.diff(long.numpy()) > 0)
        covered = np.zeros(len(length), dtype=int)
        covered[length <= dof_embed.LONG_ROW] += 1
        covered[long.numpy()] += 1
        assert np.all(covered == 1)
        if (dim, nref, p) == (3, 4, 4):
            assert length.max() == {"embed": 25, "embed_t": 296}[mode]


@pair_case
def test_embed_mirror(dim, nref, p):
    """The mirror equals the plain version bit for bit in both modes, and
    the JAX package's DofEmbed.embed and its jax.linear_transpose to 1e-12."""
    lv = levels(dim, nref, p)
    de = transfers(dim, nref, p)[1].embed_c
    rde = rmb.DofEmbed(lv["rbc"])
    x = rng_array(40 + p, de.n_dofs)
    got = embed_mirror(T(x), *de.tables("embed"), de.shape)
    assert torch.equal(got, dof_embed.dof_embed_plain(T(x), *de.tables("embed"), de.shape))
    assert rel_err(got, rde.embed(jnp.asarray(x), rde.tables)) <= RTOL
    bv = rng_array(50 + p, *de.shape)
    got = embed_mirror(T(bv), *de.tables("embed_t"), (de.n_dofs,))
    assert torch.equal(got, dof_embed.dof_embed_plain(T(bv), *de.tables("embed_t"),
                                                      (de.n_dofs,)))
    (want,) = jax.linear_transpose(lambda v: rde.embed(v, rde.tables),
                                   jax.ShapeDtypeStruct((de.n_dofs,), jnp.float64))(
        jnp.asarray(bv))
    assert rel_err(got, want) <= RTOL


def test_embed_long_rows_threshold():
    """long_rows lists the rows longer than the split, and nothing else: on
    hand-made lengths 0, 8, 9, 296, 1 and 33, at the split 8, 0 and
    LONG_ROW (32)."""
    ptr = np.cumsum([0, 0, 8, 9, 296, 1, 33])
    assert dof_embed.long_rows(ptr, split=8).tolist() == [2, 3, 5]
    assert dof_embed.long_rows(ptr, split=0).tolist() == [1, 2, 3, 4, 5]
    assert dof_embed.LONG_ROW == 32 and dof_embed.long_rows(ptr).tolist() == [3, 5]


# ---- brick_transfer --------------------------------------------------------------------
def transfer_mirror(x, src_lin, E, own, p_ptr, p_rows, r_ptr, r_slot, c_ptr, c_rows, p_par,
                    p_slot, p_sched, p_bround, B, mode, cap=None):
    """brick_transfer block by block in the kernel's order. Prolongate: a
    fine brick's rounds (at most `cap` rows and parents; the kernel's own
    cap by default), each round's parents read once, each row swept from its
    parent slot, the owned nodes written (each at most once). Restrict: a
    coarse brick's parity classes, each in rounds of `cap` rows whose
    cells' sums run on in a brick-sized accumulator (each cell's rows of a
    round in ascending order after its earlier rounds', no two cells of a
    class on one node), then every node summed from 0 over the classes in
    order."""
    n, dim = E.shape[-1], E.shape[1]
    p, N3p, C = n - 1, x.shape[1], B**dim
    cap = brick_transfer.round_rows(dim, p, B, mode) if cap is None else cap
    slot_nodes = brick_slot_index(B, p, dim=dim)
    nodes_of = lambda rows: (rows // C)[:, None] * N3p + slot_nodes[rows % C]
    xf = x.reshape(-1)
    if mode == "prolongate":
        nb_f = p_ptr.numel() - 1
        out = torch.zeros(nb_f * N3p, dtype=x.dtype)
        writes = torch.zeros(nb_f * N3p, dtype=torch.long)
        for b in range(nb_f):
            for k in range(int(p_bround[b]), int(p_bround[b + 1])):
                (row0, par0), (row1, par1) = p_sched[k].tolist(), p_sched[k + 1].tolist()
                assert 0 < row1 - row0 <= cap and 0 < par1 - par0 <= cap
                par = p_par[par0:par1].long()
                parents = xf[nodes_of(par)]
                rows = p_rows[row0:row1].long()
                assert bool((rows // C == b).all())
                u = embed_rows(parents[p_slot[row0:row1].long()], E[rows], False)
                sel = (own[rows] & brick_transfer.OWN) != 0
                dst = nodes_of(rows)[sel]
                out[dst] = u[sel]
                writes[dst] += 1
        assert int(writes.max()) <= 1, "a fine node written twice"
        return out.reshape(nb_f, N3p)
    nb_c, ncls = r_ptr.shape[0], 2**dim
    out = torch.zeros(nb_c, N3p, dtype=x.dtype)
    for b in range(nb_c):
        accs = []
        for cls in range(ncls):
            acc = torch.zeros(N3p, dtype=x.dtype)
            e0, e1 = int(r_ptr[b, cls]), int(r_ptr[b, cls + 1])
            cells = slot_nodes[r_slot[e0:e1].long()].reshape(-1)
            assert len(torch.unique(cells)) == len(cells), "two cells of a class meet"
            first, last = int(c_ptr[e0]), int(c_ptr[e1])
            for g0 in range(first, last, cap):
                g1 = min(g0 + cap, last)
                rows = c_rows[g0:g1].long()
                u = torch.where((own[rows] & brick_transfer.OWN_WEIGHTED) != 0,
                                xf[nodes_of(rows)], 0.0)
                u = embed_rows(u, E[rows], True)
                for e in range(e0, e1):
                    dst = slot_nodes[r_slot[e].long()]
                    for r in range(max(int(c_ptr[e]), g0), min(int(c_ptr[e + 1]), g1)):
                        acc[dst] = acc[dst] + u[r - g0]
            accs.append(acc)
        v = torch.zeros(N3p, dtype=x.dtype)
        for acc in accs:
            v = v + acc
        out[b] = v
    return out


@pair_case
def test_transfer_tables(dim, nref, p):
    """The prolongation's rounds: each fine brick's rows (p_ptr's range) are
    its rows that own a node, each once, by parent; every round holds whole
    parent groups within the kernel's cap, its parents distinct and each
    row's slot naming its own parent (src_lin). The restriction: a parity
    class's rows are whole cells in ascending slot order with each cell's
    rows ascending, and the cells of a class share no node."""
    tr = transfers(dim, nref, p)[1]
    t = dict(zip(("src_lin", "E", "own") + brick_transfer.LISTS, tr.tables()[:-1]))
    t = {k: v.numpy() for k, v in t.items()}
    B, C, ncls = tr.B, tr.B**dim, 2**dim
    cap = brick_transfer.round_rows(dim, p, B, "prolongate")
    owning = np.nonzero((t["own"] & brick_transfer.OWN).any(axis=1))[0]
    assert np.array_equal(np.sort(t["p_rows"]), owning)
    sched, bround = t["p_sched"], t["p_bround"]
    assert bround[0] == 0 and bround[-1] == len(sched) - 1
    assert sched[-1].tolist() == [len(t["p_rows"]), len(t["p_par"])]
    for b in range(len(t["p_ptr"]) - 1):
        k0, k1 = bround[b], bround[b + 1]
        assert sched[k0, 0] == t["p_ptr"][b] and sched[k1, 0] == t["p_ptr"][b + 1]
        for k in range(k0, k1):
            rows = t["p_rows"][sched[k, 0]:sched[k + 1, 0]]
            par = t["p_par"][sched[k, 1]:sched[k + 1, 1]]
            assert 0 < len(rows) <= cap and 0 < len(par) <= cap
            assert np.all(rows // C == b) and len(np.unique(par)) == len(par)
            assert np.array_equal(par[t["p_slot"][sched[k, 0]:sched[k + 1, 0]]],
                                  t["src_lin"][rows])
            key = t["src_lin"][rows].astype(np.int64) * 2**32 + rows  # by parent, then ascending
            assert np.all(np.diff(key) > 0)
        # a parent's rows stay in one round
        pars = t["p_par"][sched[k0, 1]:sched[k1, 1]]
        assert len(np.unique(pars)) == len(pars)
    cp = t["c_ptr"]
    slot_nodes = brick_slot_index(B, p, dim=dim).numpy()
    for b in range(t["r_ptr"].shape[0]):
        for cls in range(ncls):
            e0, e1 = t["r_ptr"][b, cls], t["r_ptr"][b, cls + 1]
            slots = t["r_slot"][e0:e1]
            assert np.all(np.diff(slots) > 0)
            assert np.all(sum(((slots // B**a) % 2) << a for a in range(dim)) == cls)
            nodes = slot_nodes[slots].ravel()
            assert len(np.unique(nodes)) == len(nodes)
            for e in range(e0, e1):
                rows = t["c_rows"][cp[e]:cp[e + 1]]
                assert np.all(np.diff(rows) > 0)
                assert np.all(t["src_lin"][rows] == b * C + t["r_slot"][e])


@pair_case
def test_bounds_leave_out_the_schedules(dim, nref, p):
    """Both kernels' least traffic counts the function's inputs alone: it
    is the same whatever schedule the kernel is given (dof_embed's long-row
    list or none; brick_transfer's rounds at the kernel's cap or cut to
    2^dim + 1 rows, which makes more of them)."""
    lv = levels(dim, nref, p)
    pbt = transfers(dim, nref, p)[1]
    de = pbt.embed_c
    none = torch.zeros(0, dtype=torch.int32)
    for mode, x, shape in (("embed", T(rng_array(80, de.n_dofs)), de.shape),
                           ("embed_t", T(rng_array(81, *de.shape)), (de.n_dofs,))):
        ptr, idx, w, long = de.tables(mode)
        every = torch.arange(ptr.numel() - 1, dtype=torch.int32)
        counts = {dof_embed.bytes_and_flops(x, ptr, idx, w, lst, shape)
                  for lst in (long, none, every)}
        assert len(counts) == 1, (mode, counts)
    kernel, cut = tables_with_cap(pbt, None), tables_with_cap(pbt, 2**dim + 1)
    assert cut[brick_transfer.LISTS.index("p_sched") + 3].shape[0] > \
        kernel[brick_transfer.LISTS.index("p_sched") + 3].shape[0]
    for mode, x in (("prolongate", T(rng_array(82, lv["pbc"].n_bricks, lv["pbc"].N3p))),
                    ("restrict", T(rng_array(83, lv["pbf"].n_bricks, lv["pbf"].N3p)))):
        assert (brick_transfer.bytes_and_flops(x, *kernel, mode=mode)
                == brick_transfer.bytes_and_flops(x, *cut, mode=mode)), mode


def _ref_pb_transpose(rtr, yw):
    d, ac, af = rtr._dev, rtr.mm_c._stage(), rtr.mm_f._stage()
    shape = jax.ShapeDtypeStruct((rtr.mm_c.bs.n_bricks, rtr.mm_c.N3p), jnp.float64)
    return jax.linear_transpose(lambda x: rtr._pb(x, d, ac, af), shape)(yw)[0]


@pair_case
@pytest.mark.parametrize("cap", [None, CUT], ids=["kernel-rounds", "cut-rounds"])
def test_transfer_mirror(dim, nref, p, cap):
    """The mirror equals the plain version bit for bit in both modes
    (float64), and the JAX package's BrickTransfer._pb and its
    jax.linear_transpose of W_f r to 1e-12; with the kernel's rounds and
    with rounds of 2^dim + 1 rows (the prolongation's schedule rebuilt so:
    a refined parent's rows and one more a round)."""
    lv = levels(dim, nref, p)
    rbt, pbt = transfers(dim, nref, p)
    cap = 2**dim + 1 if cap == CUT else None
    tabs = tables_with_cap(pbt, cap)
    xb = rng_array(60 + p, lv["pbc"].n_bricks, lv["pbc"].N3p)
    got = transfer_mirror(T(xb), *tabs, "prolongate", cap)
    assert torch.equal(got, brick_transfer.brick_transfer_plain(T(xb), *tabs, mode="prolongate"))
    assert rel_err(got, rbt._pb(jnp.asarray(xb), rbt._dev, rbt.mm_c._stage(),
                                rbt.mm_f._stage())) <= RTOL
    yb = rng_array(70 + p, lv["pbf"].n_bricks, lv["pbf"].N3p)
    got = transfer_mirror(T(yb), *tabs, "restrict", cap)
    assert torch.equal(got, brick_transfer.brick_transfer_plain(T(yb), *tabs, mode="restrict"))
    assert rel_err(got, _ref_pb_transpose(rbt, jnp.asarray(yb) * rbt.mm_f.dot_mask())) <= RTOL


def test_prolongate_schedule_edges():
    """Rounds on hand-made rows: a parent's rows never split, a round closes
    at the row cap and at the parent cap, a brick without rows has no
    round, no rows give one closing entry, and a cap below a parent's rows
    raises."""
    C = 4
    rows = np.array([0, 1, 2, 3, 8, 9, 10])  # bricks 0 and 2 (brick 1 empty)
    parent = np.array([7, 5, 7, 5, 1, 2, 3])
    p_rows, p_par, p_slot, p_sched, p_bround = brick_transfer.prolongate_schedule(
        rows, parent, C, 3, 2)
    assert p_rows.tolist() == [1, 3, 0, 2, 8, 9, 10]
    assert p_par.tolist() == [5, 7, 1, 2, 3]
    assert p_sched.tolist() == [[0, 0], [2, 1], [4, 2], [6, 4], [7, 5]]
    assert p_bround.tolist() == [0, 2, 2, 4]
    assert p_slot.tolist() == [0, 0, 0, 0, 0, 1, 0]
    empty = brick_transfer.prolongate_schedule(np.zeros(0, int), np.zeros(0, int), C, 2, 8)
    assert empty[3].tolist() == [[0, 0]] and empty[4].tolist() == [0, 0, 0]
    with pytest.raises(ValueError, match="rows of one parent"):
        brick_transfer.prolongate_schedule(rows, parent, C, 3, 1)


def test_round_rows_fit_shared_memory():
    """Every instance's rounds fit a block's shared memory in float64
    (csrc/brick_transfer.cu's prolongate_smem / restrict_smem) and hold at
    least one row; 3-D p=4 takes a whole brick (64 rows) a round."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import auto_brick_size
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import _build

    for dim, degrees in _build.BRICK_DEGREES.items():
        for p in degrees:
            B = auto_brick_size(p, dim)
            n = p + 1
            NL, EL = n**dim, dim * n * n
            N3p = -(-((B * p + 1) ** dim) // 128) * 128
            pr = brick_transfer.round_rows(dim, p, B, "prolongate")
            rr = brick_transfer.round_rows(dim, p, B, "restrict")
            assert 1 <= pr <= B**dim and 1 <= rr <= B**dim
            cells = B**dim // 2**dim
            assert 8 * (N3p + pr * (2 * NL + EL)) + 4 * (NL + 4 * pr) <= brick_transfer.SMEM_BYTES
            assert (8 * (N3p + rr * (NL + EL)) + 4 * (NL + 2 * rr + 2 * cells + 1)
                    <= brick_transfer.SMEM_BYTES)
    assert brick_transfer.round_rows(3, 4, 4, "prolongate") == 64
    assert brick_transfer.round_rows(3, 4, 4, "restrict") == 64
