"""``brick_deformed`` as it runs on the card since its redesign (a z-column of
a cell a thread, 2-D a y-column, in the column phases it shares with
``cell_laplace``; S, D = Dc S and their transposes as even-odd launch
parameters; every present cell's result kept in its row and one ordered
pass over the brick's nodes), on the CPU, and its instances on the card.

- a float64 emulation of the kernel's schedule (the column phases with the
  even-odd factors, then each node's present cells summed z cells outer,
  then y, then x, then its cell-row entries in the same order) equals the
  JAX package's ``_deformed_brick_apply`` with ``_scatter_cols``' overlap-add
  of the cell rows on the first bricks, to 1e-12, at every (p, B) of the
  brick size rule in 2-D and 3-D, with and without cell rows, on seeded
  bricks: one with no present cell, one with absent slots, one whole;
- ``BrickLaplaceMM.kernel_factors``, the launch parameters, is
  ``factor_tables`` of the float64 S and Dc and rebuilds S and D = Dc S;
- ``bytes_and_flops`` counts what it counted before the redesign;
- marked ``cuda``: every instance, f32 and f64, against the plain version,
  two calls bit-identical, and the factors required on the card.

The card runs only the tests marked ``cuda`` (``--noconftest``; no JAX
there)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dealii_matrixfree_hanging_nodes_tpu_torch as mt  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import auto_brick_size  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.elements import shape_info  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (  # noqa: E402
    _even_odd, brick_deformed,
)
from torch_port_cases import (  # noqa: E402, F401 (fixtures)
    RTOL, one_torch_thread, rel_err, release_module_memory,
)

DEGREES = list(range(1, 7))
INSTANCES = sorted(brick_deformed.SUPPORTED, key=lambda t: (-t[2], t[0]))
IDS = [f"{dim}d-p{p}-B{B}" for p, B, dim in INSTANCES]
N_BRICKS, N_ROWS = 3, 2  # brick 0 has no present cell, brick 1 absent slots; rows on 0 and 1
T = torch.from_numpy


def seeded_bricks(p, B, dim, seed=0):
    """(bv [nb, N3p], metric [nb B^dim, n^dim, dim (dim+1) / 2] zero at the
    absent slots, present bits int32 [nb, ceil(B^dim / 32)], present [nb,
    B^dim] bool, dcols [N_ROWS B^dim, n^dim]) in float64 from a seed, N3p
    the brick rows' padding to a multiple of 128."""
    rng = np.random.default_rng(1000 * dim + 10 * p + seed)
    n, C = p + 1, B**dim
    NB = B * p + 1
    N3p = -(-NB**dim // 128) * 128
    present = np.ones((N_BRICKS, C), dtype=bool)
    present[0] = False
    present[1] = rng.uniform(size=C) < 0.7
    present[1, :2] = (True, False)
    bv = rng.standard_normal((N_BRICKS, N3p))
    metric = rng.uniform(-1.0, 1.0, (N_BRICKS * C, n**dim, dim * (dim + 1) // 2))
    metric[~present.reshape(-1)] = 0.0
    bits = np.zeros((N_BRICKS, -(-C // 32)), dtype=np.uint32)
    for s in range(C):
        bits[:, s // 32] |= present[:, s].astype(np.uint32) << np.uint32(s % 32)
    dcols = rng.standard_normal((N_ROWS * C, n**dim))
    return bv, metric, bits.view(np.int32), present, dcols


def node_cells(p, B, dim):
    """[NB^dim, 2^dim] cell slots and local indices of each brick node's
    cells in the kernel's order (z cells outer, then y, then x; the cell
    before an interior cell boundary first), -1 past a node's last."""
    n, NB = p + 1, B * p + 1
    axis = []
    for c in range(NB):
        q, r = divmod(c, p)
        if c == B * p:
            axis.append([(B - 1, p)])
        elif r == 0 and q > 0:
            axis.append([(q - 1, p), (q, 0)])
        else:
            axis.append([(q, r)])
    slots = np.full((NB**dim, 2**dim), -1)
    locs = np.full((NB**dim, 2**dim), -1)
    for i in range(NB**dim):
        coords = [(i // NB**k) % NB for k in reversed(range(dim))]  # (z,) y, x
        pairs = [([], [])]
        for c in coords:
            pairs = [(cs + [cell], ls + [loc]) for cs, ls in pairs for cell, loc in axis[c]]
        for r, (cs, ls) in enumerate(pairs):
            slots[i, r] = sum(cell * B**(dim - 1 - k) for k, cell in enumerate(cs))
            locs[i, r] = sum(loc * n**(dim - 1 - k) for k, loc in enumerate(ls))
    return slots, locs


def kernel_schedule(bv, metric, present, S, Dc, dcols, p, B, dim):
    """A float64 emulation of csrc/brick_deformed.cu: the present cells'
    rows from the bricks, the column phases (test_torch_cell_laplace's
    emulation of laplace_cols.cuh with the even-odd factors), then the node
    pass: each node's present cells added one after another to zero in the
    kernel's order, then on the first bricks its cell-row entries in the
    same order; the padding zero."""
    from test_torch_cell_laplace import column_schedule

    n, C, NB = p + 1, B**dim, B * p + 1
    nb, N3p = bv.shape
    slots, locs = node_cells(p, B, dim)
    ok = slots >= 0
    s, loc = np.where(ok, slots, 0), np.where(ok, locs, 0)
    rows = np.zeros((nb, C, n**dim))
    cells = np.nonzero(present.reshape(-1))[0]
    if cells.size:
        nodes = (node_cells_of(p, B, dim)[cells % C])  # [cells, n^dim] brick nodes
        u = bv[cells // C][np.arange(cells.size)[:, None], nodes]
        out = column_schedule(u, metric[cells], S, Dc, None, dim, True).numpy()
        rows.reshape(-1, n**dim)[cells] = out
    v = np.zeros((nb, N3p))
    for b in range(nb):
        for r in range(2**dim):
            add = ok[:, r] & present[b, s[:, r]]
            v[b, :NB**dim][add] += rows[b, s[add, r], loc[add, r]]
    rows_in = dcols.reshape(-1, C, n**dim)
    for b in range(rows_in.shape[0]):
        for r in range(2**dim):
            add = ok[:, r]
            v[b, :NB**dim][add] += rows_in[b, s[add, r], loc[add, r]]
    return v


def node_cells_of(p, B, dim):
    """[B^dim, n^dim]: the brick node of each slot's local nodes (x fastest)."""
    n, NB = p + 1, B * p + 1
    sl = np.arange(B**dim)
    jj = np.arange(n**dim)
    node = np.zeros((B**dim, n**dim), dtype=np.int64)
    for k in range(dim):  # axis k: 0 is x
        cell = (sl // B**k) % B
        loc = (jj // n**k) % n
        node += (cell[:, None] * p + loc[None, :]) * NB**k
    return node


def reference(bv, metric, present, S, Dc, dcols, p, B, dim):
    """The JAX package's _deformed_brick_apply on the brick-quad lattice
    tables (Sqb, Dqb, Gqb laid out as its BrickLaplaceMM builds them), then
    _scatter_cols' overlap-add (_col2im_sep) of dcols merged into the first
    bricks (bricks.py:2553-2559)."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from dealii_matrixfree_hanging_nodes_tpu.bricks import BrickLaplaceMM as RefBrickLaplaceMM

    n, NB, nb = p + 1, B * p + 1, bv.shape[0]
    Q = B * n
    Sqb, Dqb, W = np.zeros((Q, NB)), np.zeros((Q, Q)), np.zeros((Q, NB))
    for c in range(B):
        Sqb[c * n:(c + 1) * n, c * p:c * p + n] = S
        Dqb[c * n:(c + 1) * n, c * n:(c + 1) * n] = Dc
        W[c * n + np.arange(n), c * p + np.arange(n)] = 1.0
    k = metric.shape[-1]
    if dim == 3:
        G = metric.reshape(nb, B, B, B, n, n, n, k).transpose(0, 7, 1, 4, 2, 5, 3, 6)
    else:
        G = metric.reshape(nb, B, B, n, n, k).transpose(0, 5, 1, 3, 2, 4)
    a = {"Sqb": jnp.asarray(Sqb), "Dqb": jnp.asarray(Dqb),
         "Gqb": jnp.asarray(np.ascontiguousarray(G).reshape((nb, k) + (Q,) * dim)),
         "W_col2im": jnp.asarray(W)}
    me = SimpleNamespace(bs=SimpleNamespace(NB=NB, dim=dim, B=B), N3=NB**dim, N3p=bv.shape[1],
                         n=n)
    v = np.asarray(RefBrickLaplaceMM._deformed_brick_apply(me, jnp.asarray(bv), a)).copy()
    if dcols is not None:
        m = dcols.shape[0] // B**dim
        v[:m] += np.asarray(RefBrickLaplaceMM._col2im_sep(me, jnp.asarray(dcols), m, a))
    return v


@pytest.mark.parametrize("rows", [True, False], ids=["cell-rows", "no-rows"])
@pytest.mark.parametrize("p,B,dim", INSTANCES, ids=IDS)
def test_kernel_schedule_equals_the_reference(p, B, dim, rows):
    """The kernel's schedule, emulated in float64, equals the reference's
    whole-brick sweeps (with the cell rows' overlap-add) to 1e-12 at every
    instance, on bricks with no present cell, with absent slots and whole;
    so does the plain version the card holds the kernel against."""
    assert B == auto_brick_size(p, dim)
    bv, metric, bits, present, dcols = seeded_bricks(p, B, dim)
    si = shape_info(p)
    dc = dcols if rows else None
    want = reference(bv, metric, present, si.S, si.Dc, dc, p, B, dim)
    got = kernel_schedule(bv, metric, present, si.S, si.Dc, dcols[:0] if dc is None else dc,
                          p, B, dim)
    assert rel_err(got, want) <= RTOL
    plain = brick_deformed.brick_deformed_plain(T(bv), T(metric), T(bits), T(si.S), T(si.Dc),
                                                None if dc is None else T(dc), brick_size=B)
    assert rel_err(plain, want) <= RTOL
    assert not got[:, (B * p + 1)**dim:].any()  # the padding zero


@pytest.mark.parametrize("p", DEGREES)
def test_kernel_factors_rebuild_s_and_d(p):
    """A deformed BrickLaplaceMM's kernel_factors is factor_tables of the
    float64 S and Dc, built once, and its splits rebuild S, D = Dc S and
    their transposes to 1e-14; a Cartesian operator has none."""
    from test_torch_elastic_kernels import rebuild

    mf = mt.MatrixFree(mt.create_quadrant(2, 1), p, high_order_mapping=True)
    op = mt.BrickLaplaceMM(mf, device="cpu")
    si = shape_info(p)
    tab = op.kernel_factors
    assert np.array_equal(tab, _even_odd.factor_tables(si.S, si.Dc))
    n = p + 1
    h, hh, size = n // 2, (n + 1) // 2, _even_odd.factor_size(n)
    assert tab.shape == (4 * size,) and tab.dtype == np.float64 and tab.flags.c_contiguous
    D = si.Dc @ si.S
    for i, (M, sign) in enumerate(zip((si.S, D, si.S.T, D.T), _even_odd.SIGNS)):
        part = tab[i * size:(i + 1) * size]
        A, Bm, Cv = (part[:hh * h].reshape(hh, h), part[hh * h:2 * hh * h].reshape(hh, h),
                     part[2 * hh * h:])
        assert rel_err(rebuild(A, Bm, Cv, sign, n), M) < 1e-14
    if p == 4:
        assert mt.BrickLaplaceMM(mt.MatrixFree(mt.create_quadrant(2, 1), p),
                                 device="cpu").kernel_factors is None


# bytes and operations of seeded instances, as bytes_and_flops counted them before the redesign
BYTES_AND_FLOPS = {
    (4, 4, 3, True): (1026144, 1886000),
    (4, 4, 3, False): (898144, 1870000),
    (4, 8, 2, True): (149408, 258400),
}


@pytest.mark.parametrize("p,B,dim,rows", list(BYTES_AND_FLOPS),
                         ids=[f"{d}d-p{p}-{'rows' if r else 'no-rows'}"
                              for p, _, d, r in BYTES_AND_FLOPS])
def test_bytes_and_flops_unchanged(p, B, dim, rows):
    """The function's traffic and operations, whatever the schedule: u's
    nodes, v with its padding, the present cells' metric, S and Dc, the
    bits and the cell rows; the collocation form's operations."""
    bv, metric, bits, present, dcols = seeded_bricks(p, B, dim)
    si = shape_info(p)
    got = brick_deformed.bytes_and_flops(T(bv), T(metric), T(bits), T(si.S), T(si.Dc),
                                         T(dcols) if rows else None, brick_size=B)
    assert got == BYTES_AND_FLOPS[(p, B, dim, rows)]


# ---- on the card -----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p,B,dim", INSTANCES, ids=IDS)
def test_brick_deformed_instances_on_card(cuda, p, B, dim, dtype):
    """Every instance against its plain version (1e-5 relative in float32,
    1e-12 in float64), with and without cell rows, on bricks with no
    present cell, with absent slots and whole; two calls bit-identical."""
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    bv, metric, bits, _, dcols = seeded_bricks(p, B, dim, seed=1)
    si = shape_info(p)
    on = lambda a: torch.from_numpy(a).to(cuda, dtype)
    args = (on(bv), on(metric), torch.from_numpy(bits).to(cuda), on(si.S), on(si.Dc))
    fac = _even_odd.factor_tables(si.S, si.Dc)
    for dc in (None, on(dcols)):
        got = brick_deformed.brick_deformed(*args, dcols=dc, brick_size=B, factors=fac)
        again = brick_deformed.brick_deformed(*args, dcols=dc, brick_size=B, factors=fac)
        want = brick_deformed.brick_deformed_plain(*args, dcols=dc, brick_size=B)
        torch.cuda.synchronize()
        assert rel_err(got.cpu(), want.cpu()) < tol, dc is None
        assert torch.equal(got, again)
    threads, smem, blocks = brick_deformed.plan(dtype, p, B, dim, device=cuda)
    assert threads % 32 == 0 and smem > 0 and blocks >= 1


@pytest.mark.cuda
def test_brick_deformed_refuses_a_launch_without_factors(cuda):
    """On the card the kernel takes its launch parameters: no factors, or
    another degree's, raise before any launch; so does a 3-D metric that
    starts off its pairs' alignment."""
    p, B, dim = 4, 4, 3
    bv, metric, bits, _, _ = seeded_bricks(p, B, dim)
    si = shape_info(p)
    args = (T(bv).to(cuda), T(metric).to(cuda), T(bits).to(cuda), T(si.S).to(cuda),
            T(si.Dc).to(cuda))
    with pytest.raises(ValueError, match="factor_tables"):
        brick_deformed.brick_deformed(*args, brick_size=B)
    si3 = shape_info(3)
    with pytest.raises(ValueError, match="factor_tables"):
        brick_deformed.brick_deformed(*args, brick_size=B,
                                      factors=_even_odd.factor_tables(si3.S, si3.Dc))
    # the 3-D kernel reads the metric's points in aligned pairs
    shifted = torch.empty(args[1].numel() + 1, dtype=args[1].dtype, device=cuda)[1:]
    shifted = shifted.view(args[1].shape).copy_(args[1])
    with pytest.raises(ValueError, match="aligned pairs"):
        brick_deformed.brick_deformed(args[0], shifted, *args[2:], brick_size=B,
                                      factors=_even_odd.factor_tables(si.S, si.Dc))
