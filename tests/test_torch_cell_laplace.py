"""``cell_laplace`` as it runs on the card since its redesign (a z-column of
a cell a thread, 2-D a y-column; the factors S, D = Dc S and their
transposes as even-odd launch parameters), on the CPU, and its instances on
the card.

- a float64 emulation of the kernel's schedule (3-D: z1, x1, y with the
  point step, x2, z2, 16 even-odd sweeps a line; 2-D: y1, x, y2, 8) equals
  the JAX package's ``laplace_cell_kernel`` on seeded cells, Cartesian and
  deformed, at every degree, to 1e-12;
- ``MatrixFree.kernel_factors``, the kernel's launch parameters, is
  ``factor_tables`` of the float64 S and Dc and rebuilds S and D = Dc S;
- ``bytes_and_flops`` counts the function's bytes: the distinct source
  values, the DoF map, codes, geo, the weights, the factors S, Dc and P
  and the rows written, whatever the schedule;
- marked ``cuda``: every instance (each flag mode, f32 and f64, p=1..6,
  dim 2 and 3) against the plain version, two calls bit-identical.

The card runs only the tests marked ``cuda`` (``--noconftest``; no JAX
there)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dealii_matrixfree_hanging_nodes_tpu_torch as mt  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.elements import shape_info  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import _even_odd, cell_laplace  # noqa: E402
from torch_port_cases import (  # noqa: E402, F401 (fixtures)
    RTOL, one_torch_thread, rel_err, release_module_memory,
)

DEGREES = list(range(1, 7))
CASES = [(dim, p, deformed) for dim in (3, 2) for p in DEGREES for deformed in (False, True)]
CASE_IDS = [f"{dim}d-p{p}-{'deformed' if d else 'cartesian'}" for dim, p, d in CASES]
T = torch.from_numpy


def seeded_cells(dim, p, deformed, n_cells=6):
    """(u [cells, n^dim], geo, S, Dc, w) in float64 from a seed: geo the
    Cartesian factors [cells, dim] or a packed metric [cells, n^dim,
    dim (dim+1) / 2]."""
    rng = np.random.default_rng(100 * dim + 10 * p + deformed)
    n_loc = (p + 1) ** dim
    si = shape_info(p)
    u = rng.standard_normal((n_cells, n_loc))
    if deformed:
        geo = rng.uniform(-1.0, 1.0, (n_cells, n_loc, dim * (dim + 1) // 2))
    else:
        geo = rng.uniform(0.5, 2.0, (n_cells, dim))
    return u, geo, si.S, si.Dc, si.quad_weights_tensor(dim)


def column_schedule(u, geo, S, Dc, w, dim, deformed):
    """A float64 emulation of the kernel's Laplace on cells u [cells, n^dim]
    as csrc/cell_laplace.cu runs it, every sweep even-odd with the launch's
    factors (_even_odd.factor_tables' splits): 3-D z1 (S_z, D_z), x1 (S_x,
    D_x, S_x), y (S_y, D_y, S_y; the point step: geo_d w or the packed
    metric; D_y^T, S_y^T, S_y^T), x2 (D_x^T + S_x^T, S_x^T), z2 (S_z^T +
    D_z^T); 2-D y1 (S_y, D_y), x (D_x, S_x; the point step; D_x^T, S_x^T),
    y2 (S_y^T + D_y^T)."""
    from test_torch_elastic_kernels import eo_sweep

    n = S.shape[0]
    D = Dc @ S
    split = [(_even_odd.even_odd(M, s), s) for M, s in zip((S, D, S.T, D.T), _even_odd.SIGNS)]
    fS, fD, fST, fDT = split
    sw = lambda f, x, ax: eo_sweep(f[0], f[1], x, ax)
    cells = u.shape[0]
    u = T(u).reshape(cells, *((n,) * dim))  # (cell, [z,] y, x)
    X, Y, Z = -1, -2, -3
    if deformed:
        m = T(geo).reshape(cells, *((n,) * dim), -1)
    else:
        wq = T(w).reshape((n,) * dim)
        gw = [T(geo[:, d]).reshape((cells,) + (1,) * dim) * wq for d in range(dim)]
    if dim == 3:
        a, c = sw(fS, u, Z), sw(fD, u, Z)
        a, b, c = sw(fS, a, X), sw(fD, a, X), sw(fS, c, X)
        g = [sw(fS, b, Y), sw(fD, a, Y), sw(fS, c, Y)]
        if deformed:
            o = [m[..., 0] * g[0] + m[..., 1] * g[1] + m[..., 2] * g[2],
                 m[..., 1] * g[0] + m[..., 3] * g[1] + m[..., 4] * g[2],
                 m[..., 2] * g[0] + m[..., 4] * g[1] + m[..., 5] * g[2]]
        else:
            o = [g[d] * gw[d] for d in range(3)]
        P, Q, R = sw(fDT, o[1], Y), sw(fST, o[0], Y), sw(fST, o[2], Y)
        T1, T2 = sw(fDT, Q, X) + sw(fST, P, X), sw(fST, R, X)
        out = sw(fST, T1, Z) + sw(fDT, T2, Z)
    else:
        a, c = sw(fS, u, Y), sw(fD, u, Y)
        g = [sw(fD, a, X), sw(fS, c, X)]
        if deformed:
            o = [m[..., 0] * g[0] + m[..., 1] * g[1], m[..., 1] * g[0] + m[..., 2] * g[1]]
        else:
            o = [g[d] * gw[d] for d in range(2)]
        out = sw(fST, sw(fDT, o[0], X), Y) + sw(fDT, sw(fST, o[1], X), Y)
    return out.reshape(cells, -1)


@pytest.mark.parametrize("dim,p,deformed", CASES, ids=CASE_IDS)
def test_column_schedule_equals_the_reference_kernel(dim, p, deformed):
    """The kernel's phases, emulated in float64, equal the JAX package's
    ``laplace_cell_kernel`` (the collocation form) on seeded cells to
    1e-12, and so does the plain version the card holds the kernel against."""
    import jax.numpy as jnp
    from types import SimpleNamespace

    from dealii_matrixfree_hanging_nodes_tpu.elements import shape_info as ref_shape_info
    from dealii_matrixfree_hanging_nodes_tpu.models.laplace import laplace_cell_kernel

    u, geo, S, Dc, w = seeded_cells(dim, p, deformed)
    rsi = ref_shape_info(p)
    kernel = laplace_cell_kernel(SimpleNamespace(dim=dim, high_order_mapping=deformed))
    a = {"S": jnp.asarray(rsi.S), "Dc": jnp.asarray(rsi.Dc), "geo": jnp.asarray(geo),
         "quad_w": jnp.asarray(rsi.quad_weights_tensor(dim))}
    want = np.asarray(kernel(jnp.asarray(u), a))
    got = column_schedule(u, geo, S, Dc, w, dim, deformed)
    assert rel_err(got, want) <= RTOL
    plain = cell_laplace.laplace_rows(T(u), T(S), T(Dc), T(w), T(geo), dim)
    assert rel_err(plain, want) <= RTOL


@pytest.mark.parametrize("p", DEGREES)
def test_kernel_factors_rebuild_s_and_d(p):
    """MatrixFree.kernel_factors is factor_tables of the float64 S and Dc
    (the kernel's launch parameters, four even-odd splits of
    ``factor_size`` values), and its splits rebuild S, D = Dc S and their
    transposes to 1e-14."""
    from test_torch_elastic_kernels import rebuild

    mf = mt.MatrixFree(mt.create_quadrant(2, 1), p)
    si = shape_info(p)
    tab = mf.kernel_factors
    assert tab is mf.kernel_factors  # built once
    assert np.array_equal(tab, _even_odd.factor_tables(si.S, si.Dc))
    n = p + 1
    h, hh, size = n // 2, (n + 1) // 2, _even_odd.factor_size(n)
    assert tab.shape == (4 * size,) and tab.dtype == np.float64 and tab.flags.c_contiguous
    D = si.Dc @ si.S
    for i, (M, sign) in enumerate(zip((si.S, D, si.S.T, D.T), _even_odd.SIGNS)):
        part = tab[i * size:(i + 1) * size]
        A, B, C = part[:hh * h].reshape(hh, h), part[hh * h:2 * hh * h].reshape(hh, h), \
            part[2 * hh * h:]
        assert rel_err(rebuild(A, B, C, sign, n), M) < 1e-14


def test_check_factors_refuses_other_tables():
    """The wrapper's check of its launch parameters: factor_tables of n x n
    factors, float64, contiguous, and nothing else."""
    si = shape_info(4)
    tab = _even_odd.factor_tables(si.S, si.Dc)
    _even_odd.check_factors("cell_laplace", tab, 5)
    for bad in (None, tab.astype(np.float32), tab[:-1], tab[::2], torch.from_numpy(tab)):
        with pytest.raises(ValueError, match="factor_tables"):
            _even_odd.check_factors("cell_laplace", bad, 5)
    with pytest.raises(ValueError, match="factor_tables"):
        _even_odd.check_factors("cell_laplace", tab, 4)


BOUND_CASES = [(3, 2, False), (3, 2, True), (2, 3, False), (2, 3, True)]


@pytest.mark.parametrize("dim,nref,deformed", BOUND_CASES,
                         ids=[f"{d}d-{'deformed' if f else 'cartesian'}"
                              for d, _, f in BOUND_CASES])
def test_bytes_count_the_function_not_the_schedule(dim, nref, deformed):
    """bytes_and_flops' bytes: the distinct DoFs the map names (or every
    row), the map, codes, geo, the weights (Cartesian), P, S and Dc, and
    the rows written, each once; the factor tables the kernel takes are
    not counted. Its operations are the collocation form's: 4 dim sweeps of
    2 n^(dim+1) a cell, the point step and the masked lines' interpolation."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.hn_interp import masked_lines

    cpu = torch.device("cpu")
    p = 3
    mf = mt.MatrixFree(mt.create_quadrant(dim, nref), p, high_order_mapping=deformed)
    n, n_loc = p + 1, (p + 1) ** dim
    args = mf.cell_laplace_args(cpu, torch.float64)
    dofmap, codes, geo = args[0], args[1], args[6]
    assert codes is not None and mf.n_cells == dofmap.shape[0]
    src = torch.zeros(mf.n_dofs, dtype=torch.float64)
    for flags in ({}, dict(quad=False, hn_out=False)):
        nbytes, flops = cell_laplace.bytes_and_flops(src, *args, **flags)
        quad = flags.get("quad", True)
        want = 8 * (int(torch.unique(dofmap).numel()) + mf.n_cells * n_loc + 4 * n * n)
        want += 4 * dofmap.numel() + 4 * mf.n_cells
        if quad:
            want += 8 * (geo.numel() + (0 if deformed else n_loc))
        assert nbytes == want
        lines = int(masked_lines(codes.numpy(), p, dim).sum())
        want_flops = 2 * n * n * lines * (2 if quad else 1)
        if quad:
            point = (15 if dim == 3 else 6) if deformed else 2 * dim
            want_flops += mf.n_cells * (4 * dim * 2 * n ** (dim + 1) + point * n_loc)
        assert flops == want_flops
    rows = torch.zeros(mf.n_cells, n_loc, dtype=torch.float64)
    nbytes, _ = cell_laplace.bytes_and_flops(rows, None, None, *args[2:])
    assert nbytes == 8 * (2 * mf.n_cells * n_loc + 4 * n * n + geo.numel()
                          + (0 if deformed else n_loc))


# ---- on the card -----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("dim,p", [(3, p) for p in DEGREES] + [(2, p) for p in DEGREES],
                         ids=[f"3d-p{p}" for p in DEGREES] + [f"2d-p{p}" for p in DEGREES])
def test_cell_laplace_instances_on_card(cuda, dim, p, dtype):
    """Every cell_laplace instance against its plain version (1e-5 relative
    in float32, 1e-12 in float64), two calls bit-identical: the fast map
    with the masks (HN, quadrature, HN^T), the plain map without, the rows
    (dofmap None), each HN direction alone, the read alone, the quadrature
    alone, and the deformed metric, with the cells' masks and without."""
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    tria = mt.create_quadrant(dim, 2 if dim == 3 else 3)
    mf = mt.MatrixFree(tria, p)
    mfd = mt.MatrixFree(tria, p, high_order_mapping=True)
    g = torch.Generator(device=cuda).manual_seed(p)
    x = torch.randn(mf.n_dofs, generator=g, device=cuda, dtype=dtype)
    rows = torch.randn(mf.n_cells, (p + 1) ** dim, generator=g, device=cuda, dtype=dtype)
    fast, slow = (mf.cell_laplace_args(cuda, dtype, slow=s) for s in (False, True))
    deformed = mfd.cell_laplace_args(cuda, dtype)
    assert fast[1] is not None and bool((fast[1] != 0).any())
    fac = mf.kernel_factors
    calls = [((x, *fast), {}), ((x, *slow), {}), ((rows, None, None, *fast[2:]), {}),
             ((rows, None, fast[1], *fast[2:]), {}),
             ((x, *fast), dict(quad=False, hn_out=False)),
             ((rows, None, fast[1], *fast[2:]), dict(hn_in=False, quad=False)),
             ((x, fast[0], None, *fast[2:]), dict(quad=False)),
             ((rows, None, fast[1], *fast[2:]), dict(hn_in=False, hn_out=False)),
             ((x, *deformed), {}), ((x, deformed[0], None, *deformed[2:]), {}),
             ((rows, None, None, *deformed[2:]), {})]
    for k, (args, flags) in enumerate(calls):
        got = cell_laplace.cell_laplace(*args, **flags, factors=fac)
        again = cell_laplace.cell_laplace(*args, **flags, factors=fac)
        want = cell_laplace.cell_laplace_plain(*args, **flags)
        torch.cuda.synchronize()
        assert got.shape == want.shape and rel_err(got.cpu(), want.cpu()) < tol, k
        assert torch.equal(got, again), k


@pytest.mark.cuda
def test_cell_laplace_refuses_a_launch_without_factors(cuda):
    """On the card the quadrature takes its launch parameters: no factors,
    or another degree's, raise before any launch; the read alone needs none."""
    mf = mt.MatrixFree(mt.create_quadrant(3, 2), 4)
    x = torch.zeros(mf.n_dofs, device=cuda)
    args = mf.cell_laplace_args(cuda, torch.float32)
    with pytest.raises(ValueError, match="factor_tables"):
        cell_laplace.cell_laplace(x, *args)
    with pytest.raises(ValueError, match="factor_tables"):
        cell_laplace.cell_laplace(x, *args, factors=mt.MatrixFree(mt.create_quadrant(3, 1),
                                                                  3).kernel_factors)
    cell_laplace.cell_laplace(x, *args, quad=False)
