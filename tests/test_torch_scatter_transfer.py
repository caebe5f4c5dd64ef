"""The block schedules of ``dof_scatter`` (chunks of consecutive cells, the
DoFs local to a chunk and the ones that cross chunks) and ``cell_transfer``
(whole families a block in its restrict), their invariants, and a CPU
mirror of each kernel's summation over its schedule (pure PyTorch, used
only here). Each mirror sums what the kernel sums, block by block, in the
kernel's order: it is held bit for bit against the plain version in
float64, and against the
JAX package's ``distribute_local_to_global_plain`` and ``Transfer``'s
prolongate / restrict to 1e-12 relative, at 3-D quadrant nref=2 and 2-D
quadrant nref=3 for p = 1..6 (the transfers from one refinement fewer), k =
1, 2, 3 components, both DoF maps, chunks of one cell, a one-value map with
DoFs that no entry names (the distributed GMG's prolongation) and identity
child lists (its transfer). The tests marked ``cuda`` hold both kernels
against their plain versions on the card, where no JAX is installed:
``python -m pytest --noconftest tests/test_torch_scatter_transfer.py -m
cuda``."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp  # noqa: E402
except ImportError:  # the card's machine has no JAX: only the tests marked cuda run there
    jnp = None

import dealii_matrixfree_hanging_nodes_tpu_torch as mt  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (  # noqa: E402
    cell_transfer,
    dof_scatter,
)
from torch_port_cases import (  # noqa: E402, F401 (fixtures)
    RTOL, one_torch_thread, rel_err, release_module_memory, rng_array,
)

MESHES = [(3, 2, p) for p in range(1, 7)] + [(2, 3, p) for p in range(1, 7)]
MESH_IDS = [f"{d}d-nref{n}-p{p}" for d, n, p in MESHES]
mesh_case = pytest.mark.parametrize("dim,nref,p", MESHES, ids=MESH_IDS)
T = torch.from_numpy


@functools.lru_cache(maxsize=None)
def port_mf(dim, nref, p):
    """The port's MatrixFree on a quadrant mesh, float64."""
    return mt.MatrixFree(mt.create_quadrant(dim, nref), p, dtype=np.float64)


@functools.lru_cache(maxsize=None)
def ref_mf(dim, nref, p):
    """The JAX package's MatrixFree on the same mesh, float64."""
    import dealii_matrixfree_hanging_nodes_tpu as ref
    from dealii_matrixfree_hanging_nodes_tpu.matrix_free import MatrixFree

    return MatrixFree(ref.create_quadrant(dim, nref), p, dtype=np.float64)


@functools.lru_cache(maxsize=None)
def port_transfer(dim, nref, p):
    return mt.Transfer(port_mf(dim, nref - 1, p), port_mf(dim, nref, p), device="cpu")


def permuted_tables(tr, seed):
    """tr's tables with the fine cells renumbered at random: the same
    transfer, its child lists no runs of consecutive fine cells (the
    kernel's listed path)."""
    E, cdf, own, cover, child_ptr, _, n_fine, _ = tr.tables()
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(cdf.shape[0]))
    cover = cover[perm]
    child = torch.from_numpy(np.argsort(cover.numpy(), kind="stable").astype(np.int32))
    n = E.shape[-1]
    blocks = T(cell_transfer.schedule(child_ptr.numpy(), child.numpy(), n, E.shape[1]))
    return (E[perm], cdf[perm], own[perm], cover, child_ptr, child, n_fine, blocks)


def scatter_tables(dim, nref, p, slow, chunk=None):
    mf = port_mf(dim, nref, p)
    dm = np.asarray(mf._np["dofmap_plain" if slow else "dofmap"])
    return tuple(T(a) for a in dof_scatter.transpose_map(dm, mf.n_dofs, chunk))


def one_value_map(seed, n_vals, n_dofs):
    """A [n_vals, 1] map of distinct DoFs among n_dofs (most DoFs named by no
    entry), as the distributed GMG's prolongation gives dof_scatter."""
    ids = np.random.default_rng(seed).permutation(n_dofs)[:n_vals]
    return np.sort(ids)[np.random.default_rng(seed + 1).permutation(n_vals)].reshape(-1, 1)


# ---- the mirrors -------------------------------------------------------------------
def scatter_mirror(rows, ptr, ent, sched):
    """dof_scatter over its schedule, block by block: a chunk block reads
    only its chunk's rows (the staged copy) at its DoFs' offsets from the
    schedule (lptr, loff), each DoF summing its entries from 0 in ascending
    order; a crossing block reads every row by ptr and ent."""
    comp = rows.dim() == 3
    R = (rows if comp else rows[None]).reshape(rows.shape[0] if comp else 1, -1)
    n_dofs, n_loc = ptr.numel() - 1, rows.shape[-1]
    cstart, dptr, ids, lptr, loff = dof_scatter.schedule_parts(sched, n_dofs, ent.numel())
    out = torch.full((n_dofs, R.shape[0]), float("nan"), dtype=rows.dtype)
    for b in range(dptr.numel() - 1):
        pos = torch.arange(int(dptr[b]), int(dptr[b + 1]))
        if not pos.numel():
            continue
        dofs = ids[pos].long()
        if b % 2 == 0:
            v0, v1 = int(cstart[b // 2]) * n_loc, int(cstart[b // 2 + 1]) * n_loc
            src = R[:, v0:v1].clone()  # the chunk, staged
            start, cnt = lptr[pos].long(), (lptr[pos + 1] - lptr[pos]).long()
            at = lambda e: loff[e].long()
        else:
            src = R
            start, cnt = ptr[dofs].long(), (ptr[dofs + 1] - ptr[dofs]).long()
            at = lambda e: ent[e].long()
        acc = torch.zeros(R.shape[0], dofs.numel(), dtype=rows.dtype)
        for r in range(int(cnt.max())):
            live = r < cnt
            s = at(start[live] + r)
            assert bool(((s >= 0) & (s < src.shape[1])).all()), "an entry outside the block"
            acc[:, live] += src[:, s]
        out[dofs] = acc.T
    return out if comp else out[:, 0]


def transfer_mirror(x, E, cdf, own, cover, child_ptr, child, n_fine_dofs, blocks, mode):
    """cell_transfer block by block. Prolongate: blocks of G consecutive
    fine cells (transfer.cuh's Group: G = 256 // lines), each cell sweeping
    its coarse row x[cover[f]], the owned slots written. Restrict: the
    schedule's blocks of whole families, every child gathered and swept,
    then each coarse row summed over its children from 0 in ascending
    order."""
    n, dim = E.shape[-1], E.shape[1]
    lines, maxf = cell_transfer.block_shape(n, dim)
    n_f, NL = cdf.shape
    if mode == "prolongate":
        out = torch.full((n_fine_dofs,), float("nan"), dtype=x.dtype)
        G = max(1, 256 // lines)
        for f0 in range(0, n_f, G):
            f = torch.arange(f0, min(f0 + G, n_f))
            u = cell_transfer.embed_rows(x[cover[f].long()], E[f], False)
            o = own[f]
            out[cdf[f].long()[o]] = u[o]
        return out
    out = torch.full((child_ptr.numel() - 1, NL), float("nan"), dtype=x.dtype)
    for b in range(blocks.shape[0] - 1):
        (c0, p0, first), (c1, p1, _) = blocks[b].tolist(), blocks[b + 1].tolist()
        cp = child_ptr[c0:c1 + 1].long()
        assert cp[0] == p0 and cp[-1] == p1 and c1 - c0 <= maxf and p1 - p0 <= maxf
        kids = torch.arange(first, first + p1 - p0) if first >= 0 else child[p0:p1].long()
        cnt = cp[1:] - cp[:-1]
        u = torch.where(own[kids], x[cdf[kids].long()], 0.0)
        u = cell_transfer.embed_rows(u, E[kids], True)
        acc = torch.zeros(c1 - c0, NL, dtype=x.dtype)
        first_child = cp[:-1] - cp[0]
        for r in range(int(cnt.max()) if cnt.numel() else 0):
            live = r < cnt
            acc[live] += u[first_child[live] + r]
        out[c0:c1] = acc
    return out


# ---- dof_scatter's schedule ----------------------------------------------------------
@mesh_case
@pytest.mark.parametrize("chunk", [None, 1], ids=["chunk", "one-cell"])
def test_scatter_schedule_invariants(dim, nref, p, chunk):
    """Every DoF is in one block: local to exactly one chunk (every entry in
    it, block 2j) or crossing (block 2j+1: its last entry in chunk j, its
    first not, or no entry); the chunks cover the cells in order, each
    within the kernel's most; each block's DoFs ascend; a local DoF's
    offsets in the schedule are its entries less its chunk's first value,
    a crossing DoF has none."""
    mf = port_mf(dim, nref, p)
    n_loc = (p + 1) ** dim
    for slow in (False, True):
        ptr, ent, sched = (a.numpy() for a in scatter_tables(dim, nref, p, slow, chunk))
        ptr, ent = ptr.astype(np.int64), ent.astype(np.int64)
        cstart, dptr, ids, lptr, loff = dof_scatter.schedule_parts(sched, mf.n_dofs, ent.size)
        C = chunk or dof_scatter.chunk_cells(n_loc)
        n_chunks = cstart.size - 1
        assert n_chunks == -(-mf.n_cells // C)
        assert np.array_equal(cstart, np.minimum(np.arange(n_chunks + 1) * C, mf.n_cells))
        assert dptr[0] == 0 and dptr[-1] == mf.n_dofs and np.all(np.diff(dptr) >= 0)
        assert np.array_equal(np.sort(ids), np.arange(mf.n_dofs))
        chunk_of = ent // n_loc // C  # each entry's chunk
        n_local = n_empty = 0
        assert lptr[0] == 0 and np.all(np.diff(lptr) >= 0)
        assert np.all(loff[lptr[-1]:] == 0) and loff.size == 2 * (-(-ent.size // 2))
        for b in range(2 * n_chunks):
            dofs = ids[dptr[b]:dptr[b + 1]]
            assert np.all(np.diff(dofs) > 0)
            for q, i in enumerate(dofs, start=dptr[b]):
                ch = chunk_of[ptr[i]:ptr[i + 1]]
                offs = loff[lptr[q]:lptr[q + 1]]
                if b % 2 == 0:
                    assert ch.size and np.all(ch == b // 2)
                    assert np.array_equal(offs, ent[ptr[i]:ptr[i + 1]] - cstart[b // 2] * n_loc)
                    n_local += 1
                    continue
                assert offs.size == 0
                if ch.size:
                    assert ch[-1] == b // 2 and ch[0] != ch[-1]
                else:
                    n_empty += 1
        assert n_local > 0
        assert n_empty == int(np.sum(np.diff(ptr) == 0))


def test_scatter_schedule_rejects_what_the_kernel_cannot_take():
    """A chunk larger than the kernel's shared memory holds, and a schedule
    whose length fits no number of chunks, raise."""
    dm = np.asarray(port_mf(3, 2, 4)._np["dofmap"])
    n_dofs = port_mf(3, 2, 4).n_dofs
    with pytest.raises(ValueError, match="chunk"):
        dof_scatter.transpose_map(dm, n_dofs, dof_scatter.chunk_cells(dm.shape[1]) + 1)
    _, ent, sched = dof_scatter.transpose_map(dm, n_dofs)
    with pytest.raises(ValueError, match="fits no chunks"):
        dof_scatter.schedule_parts(sched[:-1], n_dofs, ent.size)
    assert dof_scatter.chunk_cells(125) * 125 <= dof_scatter.CHUNK_VALUES
    assert dof_scatter.chunk_cells(1) == dof_scatter.MAX_CHUNK_CELLS
    assert dof_scatter.chunk_cells(10**6) == 1


# ---- dof_scatter's mirror --------------------------------------------------------------
@mesh_case
@pytest.mark.parametrize("k", [1, 2, 3])
def test_scatter_mirror(dim, nref, p, k):
    """The mirror equals the plain version bit for bit (float64; both DoF
    maps, chunks of the default size and of one cell) and each component
    the JAX package's distribute_local_to_global_plain to 1e-12."""
    mf, rmf = port_mf(dim, nref, p), ref_mf(dim, nref, p)
    rows = rng_array(100 + 10 * p + k, k, mf.n_cells, (p + 1) ** dim)
    x = T(rows if k > 1 else rows[0])
    for slow in (False, True):
        for chunk in (None, 1):
            t = scatter_tables(dim, nref, p, slow, chunk)
            got = scatter_mirror(x, *t)
            assert torch.equal(got, dof_scatter.dof_scatter_plain(x, *t))
            assert torch.equal(got, dof_scatter.dof_scatter(x, *t))  # the CPU wrapper
        for c in range(k):
            want = rmf.distribute_local_to_global_plain(jnp.asarray(rows[c]), slow=slow)
            assert rel_err(got.reshape(mf.n_dofs, -1)[:, c], want) <= RTOL


@pytest.mark.parametrize("n_vals,n_dofs", [(700, 2900), (300, 300), (1, 5000)])
def test_scatter_mirror_one_value_map(n_vals, n_dofs):
    """n_loc = 1 (the distributed GMG's prolongation: each owned value to its
    DoF of the padded vector, most DoFs named by no entry and written 0):
    the mirror equals the plain version bit for bit and the JAX scatter-add
    to 1e-12."""
    idx = one_value_map(n_vals, n_vals, n_dofs)
    vals = rng_array(n_dofs, n_vals, 1)
    t = tuple(T(a) for a in dof_scatter.transpose_map(idx, n_dofs))
    got = scatter_mirror(T(vals), *t)
    assert torch.equal(got, dof_scatter.dof_scatter_plain(T(vals), *t))
    assert int((got == 0).sum()) >= n_dofs - n_vals
    want = jnp.zeros(n_dofs).at[idx.reshape(-1)].add(vals.reshape(-1))
    assert rel_err(got, want) <= RTOL


# ---- cell_transfer's schedule ----------------------------------------------------------
def check_blocks(blocks, child_ptr, child, n, dim):
    """Every coarse cell in exactly one block, in order, with its first
    position in the child lists; a block's first fine cell where its
    children are consecutive fine cells, else -1; each block within the
    instance's fine and coarse cells and its line budget; no block could
    have taken the next family (greedy packing)."""
    lines, maxf = cell_transfer.block_shape(n, dim)
    blocks, child_ptr = np.asarray(blocks, np.int64), np.asarray(child_ptr, np.int64)
    child = np.asarray(child, np.int64)
    n_c = child_ptr.size - 1
    assert blocks.shape[1] == 3 and np.array_equal(blocks[:, 1], child_ptr[blocks[:, 0]])
    for (c0, p0, first), (_, p1, _) in zip(blocks[:-1], blocks[1:]):
        kids = child[p0:p1]
        run = kids.size > 0 and np.array_equal(kids, kids[0] + np.arange(kids.size))
        assert first == (kids[0] if run else -1)
    assert blocks[-1, 2] == -1
    blocks = blocks[:, 0]
    assert blocks[0] == 0 and blocks[-1] == n_c and np.all(np.diff(blocks) > 0)
    fine = child_ptr[blocks[1:]] - child_ptr[blocks[:-1]]
    coarse = np.diff(blocks)
    assert np.all(fine <= maxf) and np.all(coarse <= maxf)
    assert np.all(fine * lines <= max(cell_transfer.LINE_BUDGET, 2**dim * lines))
    assert maxf * lines > cell_transfer.LINE_BUDGET - 2**dim * lines  # the most families
    nxt = child_ptr[np.minimum(blocks[1:-1] + 1, n_c)] - child_ptr[blocks[1:-1]]
    assert np.all((fine[:-1] + nxt > maxf) | (coarse[:-1] == maxf))


@mesh_case
def test_transfer_schedule_invariants(dim, nref, p):
    tr = port_transfer(dim, nref, p)
    check_blocks(tr.blocks, tr.child_ptr, tr.child, p + 1, dim)
    counts = np.diff(tr.child_ptr.numpy())
    assert set(counts.tolist()) <= {1, 2**dim}  # a coarse cell stays or splits
    # identity lists (the distributed transfer): blocks of about 256 lines of single cells
    n_f = tr.child.numel()
    ident = np.arange(n_f + 1)
    check_blocks(cell_transfer.schedule(ident, ident[:-1], p + 1, dim), ident, ident[:-1],
                 p + 1, dim)
    # children listed out of order: no block's children are consecutive fine cells
    shuffled = np.random.default_rng(p).permutation(n_f)
    blocks = cell_transfer.schedule(tr.child_ptr, shuffled, p + 1, dim)
    check_blocks(blocks, tr.child_ptr, shuffled, p + 1, dim)


def test_transfer_schedule_edges():
    """No coarse cell: one closing row and no block; childless coarse cells
    count one each; a family beyond a block raises."""
    none = np.zeros(0, np.int64)
    assert cell_transfer.schedule(np.zeros(1, np.int64), none, 3, 3).tolist() == [[0, 0, -1]]
    _, maxf = cell_transfer.block_shape(3, 3)
    empty = np.zeros(2 * maxf + 2, np.int64)  # 2 maxf + 1 childless coarse cells
    b = cell_transfer.schedule(empty, none, 3, 3)
    assert b[:, 0].tolist() == [0, maxf, 2 * maxf, 2 * maxf + 1] and (b[:, 2] == -1).all()
    with pytest.raises(ValueError, match="exceeds"):
        cell_transfer.schedule(np.array([0, maxf + 1]), np.arange(maxf + 1), 3, 3)


# ---- cell_transfer's mirror ------------------------------------------------------------
@mesh_case
def test_transfer_mirror(dim, nref, p):
    """The mirror equals the plain version bit for bit in both modes
    (float64), and composed with the coarse level's read_dof_values /
    distribute_local_to_global it equals the JAX package's
    Transfer.prolongate / restrict to 1e-12."""
    from dealii_matrixfree_hanging_nodes_tpu.models import multigrid as rmg

    tr = port_transfer(dim, nref, p)
    mfc, mff = port_mf(dim, nref - 1, p), port_mf(dim, nref, p)
    rtr = rmg.Transfer(ref_mf(dim, nref - 1, p), ref_mf(dim, nref, p))
    xc, xf = rng_array(200 + p, mfc.n_dofs), rng_array(210 + p, mff.n_dofs)
    uc = mfc.read_dof_values(T(xc))
    up = transfer_mirror(uc, *tr.tables(), "prolongate")
    assert torch.equal(up, cell_transfer.cell_transfer_plain(uc, *tr.tables(), mode="prolongate"))
    assert rel_err(up, rtr.prolongate(jnp.asarray(xc))) <= RTOL
    rows = transfer_mirror(T(xf), *tr.tables(), "restrict")
    assert torch.equal(rows, cell_transfer.cell_transfer_plain(T(xf), *tr.tables(),
                                                               mode="restrict"))
    assert rel_err(mfc.distribute_local_to_global(rows), rtr.restrict(jnp.asarray(xf))) <= RTOL
    # the fine cells renumbered: listed children, the same transfer
    tabs = permuted_tables(tr, p)
    assert int((tabs[-1][:-1, 2] >= 0).sum()) < tabs[-1].shape[0] - 1
    up = transfer_mirror(uc, *tabs, "prolongate")
    assert torch.equal(up, cell_transfer.cell_transfer_plain(uc, *tabs, mode="prolongate"))
    assert rel_err(up, rtr.prolongate(jnp.asarray(xc))) <= RTOL
    rows = transfer_mirror(T(xf), *tabs, "restrict")
    assert torch.equal(rows, cell_transfer.cell_transfer_plain(T(xf), *tabs, mode="restrict"))
    assert rel_err(mfc.distribute_local_to_global(rows), rtr.restrict(jnp.asarray(xf))) <= RTOL


@mesh_case
def test_transfer_mirror_identity_lists(dim, nref, p):
    """Identity child lists (the distributed transfer: x one row a fine
    cell, each fine cell a family of one): the mirror equals the plain
    version bit for bit and the JAX package's embedding of those rows (its
    Transfer._embed, _embed_t) to 1e-12."""
    from dealii_matrixfree_hanging_nodes_tpu.models import multigrid as rmg

    tr = port_transfer(dim, nref, p)
    rtr = rmg.Transfer(ref_mf(dim, nref - 1, p), ref_mf(dim, nref, p))
    E, cdf, own, _, _, _, n_fine, _ = tr.tables()
    n_f, NL = cdf.shape
    ident = torch.arange(n_f, dtype=torch.int32)
    ptr = torch.arange(n_f + 1, dtype=torch.int32)
    blocks = T(cell_transfer.schedule(ptr.numpy(), ident.numpy(), p + 1, dim))
    args = (E, cdf, own, ident, ptr, ident, n_fine, blocks)
    rows = rng_array(220 + p, n_f, NL)
    up = transfer_mirror(T(rows), *args, "prolongate")
    assert torch.equal(up, cell_transfer.cell_transfer_plain(T(rows), *args, mode="prolongate"))
    vals = np.asarray(rtr._embed(jnp.asarray(rows), rtr.E))
    want = np.zeros(n_fine)
    want[cdf.numpy()[own.numpy()]] = vals[own.numpy()]
    assert rel_err(up, want) <= RTOL
    xf = rng_array(230 + p, n_fine)
    down = transfer_mirror(T(xf), *args, "restrict")
    assert torch.equal(down, cell_transfer.cell_transfer_plain(T(xf), *args, mode="restrict"))
    want = rtr._embed_t(jnp.where(rtr.own_mask, jnp.asarray(xf)[rtr._cfg["cdf"]], 0), rtr.E)
    assert rel_err(down, want) <= RTOL


# ---- on the card -----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@mesh_case
def test_kernels_on_card(cuda, dim, nref, p, dtype):
    """dof_scatter (k = 1, 2, 3; both maps; chunks of the default size and
    of one cell; a one-value map) and cell_transfer (both modes; family
    lists, in order and renumbered, and identity lists) against their plain
    versions on the card: 1e-5 relative
    in float32, 1e-12 in float64; two calls bit-identical. dof_scatter sums
    in the CPU plain version's order, so it equals that bit for bit."""
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    mf, mfc = port_mf(dim, nref, p), port_mf(dim, nref - 1, p)
    n_loc = (p + 1) ** dim
    on = lambda a: a.to(cuda, dtype) if a.is_floating_point() else a.to(cuda)
    calls = []
    for slow in (False, True):
        for chunk in (None, 1):
            t = tuple(on(a) for a in scatter_tables(dim, nref, p, slow, chunk))
            for k in (1, 2, 3):
                rows = rng_array(300 + k, k, mf.n_cells, n_loc)
                calls.append((dof_scatter, (on(T(rows if k > 1 else rows[0])), *t), {}))
    idx = one_value_map(5, 700, 2900)
    t = tuple(on(T(a)) for a in dof_scatter.transpose_map(idx, 2900))
    calls.append((dof_scatter, (on(T(rng_array(6, 700, 1))), *t), {}))
    tr = port_transfer(dim, nref, p)
    for tables in (tr.tables(), permuted_tables(tr, p)):
        tabs = [on(a) if isinstance(a, torch.Tensor) else a for a in tables]
        calls += [(cell_transfer, (on(T(rng_array(7, mfc.n_cells, n_loc))), *tabs),
                   {"mode": "prolongate"}),
                  (cell_transfer, (on(T(rng_array(8, mf.n_dofs))), *tabs), {"mode": "restrict"})]
    E, cdf, own, _, _, _, n_fine, _ = tabs
    n_f = cdf.shape[0]
    ident = torch.arange(n_f, dtype=torch.int32, device=cuda)
    ptr = torch.arange(n_f + 1, dtype=torch.int32)
    blocks = T(cell_transfer.schedule(ptr.numpy(), ptr.numpy()[:-1], p + 1, dim)).to(cuda)
    ident_args = (E, cdf, own, ident, ptr.to(cuda), ident, n_fine, blocks)
    calls += [(cell_transfer, (on(T(rng_array(9, n_f, n_loc))), *ident_args),
               {"mode": "prolongate"}),
              (cell_transfer, (on(T(rng_array(10, n_fine))), *ident_args), {"mode": "restrict"})]
    for mod, args, kw in calls:
        before = getattr(mod, mod.NAME).launches
        got = getattr(mod, mod.NAME)(*args, **kw)
        again = getattr(mod, mod.NAME)(*args, **kw)
        want = getattr(mod, f"{mod.NAME}_plain")(*args, **kw)
        torch.cuda.synchronize()
        assert getattr(mod, mod.NAME).launches == before + 2
        assert torch.equal(got, again), mod.NAME
        assert bool(torch.isfinite(got).all())
        assert rel_err(got.cpu(), want.cpu()) <= tol, (mod.NAME, kw)
        if mod is dof_scatter:
            cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
            assert torch.equal(got.cpu(), dof_scatter.dof_scatter_plain(*cpu_args))
