"""The two elastic kernels as they run on the card since their redesign, on
the CPU, and the deformed metric built in PyTorch.

- ``cell_elasticity``: the even-odd split of its factors (S, D = Dc S and
  their transposes, the kernel's launch parameters) rebuilds them, a sweep
  by the split equals the whole one, and a plain emulation of the kernel's
  phases (a z-column a thread in 3-D, a y-column in 2-D: 16 and 8 even-odd
  sweeps a component, the point operator between them) computes the plain
  version's operator, at every degree;
- ``brick_elasticity``: the operator's cell factors (the kernel's launch
  parameters) assemble its brick factors, and a plain emulation of the 3-D
  kernel's schedule (a block (c, k) at a time, with the sweeps its two
  terms share done once: 53 line applications a brick) and of the 2-D one
  (both outputs from the 8 x-round lines) computes the plain version's
  operator;
- the bounds: cell_elasticity's operations follow the even-odd sweeps,
  both kernels' bytes count the function's inputs and outputs only;
- ``mapping.deformed_laplace_factors(device=...)``: the metric in PyTorch
  against the NumPy form and the JAX package's, to 1e-13 relative, and
  ``MatrixFree.deformed_metric``: built once, by its first user.

Float64 throughout; the card's checks are in tests/test_torch_isolation.py
(marked ``cuda``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dealii_matrixfree_hanging_nodes_tpu as ref  # noqa: E402
import dealii_matrixfree_hanging_nodes_tpu_torch as mt  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.elements import shape_info as ref_shape_info  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu.mapping import (  # noqa: E402
    deformed_laplace_factors as ref_metric,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.elements import shape_info  # noqa: E402
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (  # noqa: E402
    brick_elasticity, cell_elasticity,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.brick_apply import (  # noqa: E402
    factor_structure,
)
from dealii_matrixfree_hanging_nodes_tpu_torch.mapping import (  # noqa: E402
    deformed_laplace_factors,
)
from torch_port_cases import (  # noqa: E402,F401 (fixtures)
    RTOL, one_torch_thread, rel_err, release_module_memory,
)

MU, LAM = 1.3, 0.7  # mu != lam: a swapped G / G^T pair shows
DEGREES_3D = list(range(1, 9))
DEGREES_2D = list(range(1, 7))
T = torch.from_numpy


def factors(p):
    """[(M, sign)] of S, D = Dc S, S^T, D^T at degree p (float64 NumPy)."""
    si = shape_info(p)
    D = si.Dc @ si.S
    return list(zip((si.S, D, si.S.T, D.T), cell_elasticity.SIGNS))


def eo_sweep(split, sign, x, axis):
    """The kernel's even-odd sweep (csrc/cell_elasticity.cu's mat) of every
    line of x along axis: the mirrored sums and differences, their products
    with the even and odd halves, the recombination."""
    A, B, C = (T(t) for t in split)
    n = x.shape[axis]
    h = n // 2
    x = torch.movedim(x, axis, -1)
    e = x[..., :h] + x.flip(-1)[..., :h]
    o = x[..., :h] - x.flip(-1)[..., :h]
    E = e @ A[:h].T + (x[..., h:h + 1] * C[:h] if n % 2 else 0)
    O = o @ B[:h].T
    out = torch.empty_like(x)
    out[..., :h] = E + O
    out[..., n - h:] = (sign * (E - O)).flip(-1)
    if n % 2:
        out[..., h] = (e @ A[h] + C[h] * x[..., h]) if sign > 0 else o @ B[h]
    return torch.movedim(out, -1, axis)


def point(g, geo_w, dim):
    """elasticity.cuh's point operator on the gradients g[c][a] (tensors),
    geo_w[a] = geo_a w at the points: out[c][a]."""
    div = sum(g[c][c] for c in range(dim))
    out = [[MU * (g[c][a] + g[a][c]) * geo_w[a] for a in range(dim)] for c in range(dim)]
    for c in range(dim):
        out[c][c] = out[c][c] + LAM * div * geo_w[c]
    return out


def column_schedule(u, p, geo, dim):
    """A plain emulation of cell_elasticity's operator as the kernel runs it
    on cells u [dim, cells, n^dim] (float64; geo [cells, dim]), every sweep
    even-odd: 3-D z1 (S_z, D_z), x1 (S_x, D_x, S_x), y (D_y, S_y, S_y, the
    point operator, D_y^T, S_y^T, S_y^T), x2 (D_x^T + S_x^T, S_x^T), z2
    (S_z^T + D_z^T); 2-D y1 (S_y, D_y), x (D_x, S_x, the point operator,
    D_x^T, S_x^T), y2 (S_y^T + D_y^T)."""
    n = p + 1
    S, D, ST, DT = ((cell_elasticity.even_odd(M, s), s) for M, s in factors(p))
    sw = lambda f, x, ax: eo_sweep(f[0], f[1], x, ax)
    cells = u.shape[1]
    u = u.reshape(dim, cells, *((n,) * dim))  # (component, cell, [z,] y, x)
    X, Y, Z = -1, -2, -3
    w = T(shape_info(p).quad_weights_tensor(dim)).reshape((n,) * dim)
    geo_w = [geo[:, a].reshape((cells,) + (1,) * dim) * w for a in range(dim)]
    if dim == 3:
        a, c = sw(S, u, Z), sw(D, u, Z)
        a, b, c = sw(S, a, X), sw(D, a, X), sw(S, c, X)
        g = [[sw(S, b[k], Y), sw(D, a[k], Y), sw(S, c[k], Y)] for k in range(3)]
        o = point(g, geo_w, 3)
        Q = torch.stack([sw(ST, o[k][0], Y) for k in range(3)])
        P = torch.stack([sw(DT, o[k][1], Y) for k in range(3)])
        R = torch.stack([sw(ST, o[k][2], Y) for k in range(3)])
        T1, T2 = sw(DT, Q, X) + sw(ST, P, X), sw(ST, R, X)
        out = sw(ST, T1, Z) + sw(DT, T2, Z)
    else:
        a, c = sw(S, u, Y), sw(D, u, Y)
        g = [[sw(D, a[k], X), sw(S, c[k], X)] for k in range(2)]
        o = point(g, geo_w, 2)
        Q = torch.stack([sw(DT, o[k][0], X) for k in range(2)])
        R = torch.stack([sw(ST, o[k][1], X) for k in range(2)])
        out = sw(ST, Q, Y) + sw(DT, R, Y)
    return out.reshape(dim, cells, -1)


def rebuild(A, B, C, sign: int, n: int):
    """The factor [n, n] from its even-odd split (``even_odd``'s inverse)."""
    h, hh = n // 2, (n + 1) // 2
    M = np.zeros((n, n))
    M[:hh, :h] = A + B
    M[:hh, n - h:] = (A - B)[:, ::-1]
    if n % 2:
        M[:hh, h] = C
    M[n - h:] = sign * M[:h][::-1, ::-1]
    return M


def kernel_schedule(c: int, k: int):
    """The 3-D kernel's factors for block (c, k) (csrc/brick_elasticity.cu's
    pair): (x factors a, b; y factors of c1 = Y1a a [+ Y1b b] and of c2 = Y2
    b; z factors of c1 and c2). The diagonal block: x (K, M), y (M, K; M), z
    (M, K); an off-diagonal one: F1 = mu's term (G on k, GT on c, M on the
    third axis), F2 = lam's (G on c, GT on k) along each axis, Y1b None."""
    if c == k:
        return ("K", "M"), ("M", "K", "M"), ("M", "K")
    f1 = brick_elasticity.axis_factors(k, c, 3)
    f2 = brick_elasticity.axis_factors(c, k, 3)
    return (f1[0], f2[0]), (f1[1], None, f2[1]), (f1[2], f2[2])


def grouped_terms(dim: int):
    """{(c, f_last): [(k, fx, fy, (mu multiple, lam multiple))]}: every
    output's Kronecker terms grouped by their factor along the last axis
    (z in 3-D, y in 2-D; fy is None in 2-D), terms with the same factors
    merged, in the kernel's order (csrc/brick_elasticity.cu's terms_of)."""
    out = {}
    for c in range(dim):
        for k in range(dim):
            coefs = ([(1, 0)] * dim if c == k else []) + [(1, 0), (0, 1)]
            for (cm, cl), (_, f) in zip(coefs, brick_elasticity.terms(c, k, 1.0, 1.0, dim)):
                key = (k, f[0], f[1] if dim == 3 else None)
                group = out.setdefault((c, f[-1]), {})
                a, b = group.get(key, (0, 0))
                group[key] = (a + cm, b + cl)
    return {cf: [(*key, coef) for key, coef in group.items()] for cf, group in out.items()}


# ---- cell_elasticity's factors and sweeps ----------------------------------------------
@pytest.mark.parametrize("p", DEGREES_3D)
def test_even_odd_factors_rebuild_s_and_dc(p):
    """The even-odd split of S, D = Dc S and their transposes rebuilds each
    (to rounding), D's rebuilt from S and Dc, and factor_tables packs the
    splits A, B, C of each, in the C struct's order and sizes."""
    si = shape_info(p)
    n = p + 1
    for M, sign in factors(p):
        A, B, C = cell_elasticity.even_odd(M, sign)
        assert A.shape == B.shape == ((n + 1) // 2, n // 2) and C.shape == ((n + 1) // 2,)
        assert rel_err(rebuild(A, B, C, sign, n), M) < 1e-14
    assert rel_err(factors(p)[1][0], si.Dc @ si.S) == 0.0
    tab = cell_elasticity.factor_tables(si.S, si.Dc)
    h, hh = n // 2, (n + 1) // 2
    size = cell_elasticity.factor_size(n)
    assert size == 2 * hh * h + hh and tab.shape == (4 * size,) and tab.dtype == np.float64
    for i, (M, sign) in enumerate(factors(p)):
        A, B, C = cell_elasticity.even_odd(M, sign)
        assert np.array_equal(tab[i * size:(i + 1) * size],
                              np.concatenate([A.ravel(), B.ravel(), C]))


def test_even_odd_refuses_a_factor_without_the_mirror_symmetry():
    M = np.random.default_rng(0).standard_normal((5, 5))
    with pytest.raises(ValueError, match="mirror symmetry"):
        cell_elasticity.even_odd(M, 1)
    with pytest.raises(ValueError, match="mirror symmetry"):
        cell_elasticity.even_odd(shape_info(4).S, -1)


@pytest.mark.parametrize("p", DEGREES_3D)
def test_even_odd_sweep_equals_the_whole_one(p):
    """The kernel's even-odd sweep of random lines equals M @ line along each
    axis, for each factor and sign (to rounding)."""
    rng = np.random.default_rng(p)
    n = p + 1
    x = T(rng.standard_normal((3, n, n, n)))
    for M, sign in factors(p):
        split = cell_elasticity.even_odd(M, sign)
        for axis, spec in ((-1, "qi,czyi->czyq"), (-2, "qi,cziy->czqy"), (-3, "qi,cizy->cqzy")):
            want = torch.einsum(spec, T(M), x)
            assert rel_err(eo_sweep(split, sign, x, axis), want) < 1e-13


@pytest.mark.parametrize("dim,p", [(3, p) for p in DEGREES_3D] + [(2, p) for p in DEGREES_2D],
                         ids=[f"3d-p{p}" for p in DEGREES_3D] + [f"2d-p{p}" for p in DEGREES_2D])
def test_column_schedule_computes_the_operator(dim, p):
    """The kernel's phases (even-odd sweeps, the point operator in the y
    phase, 3-D; in the x phase, 2-D) on random cells with per-axis geo equal
    cell_elasticity's plain operator (``elastic_rows``, the collocation
    form) to 1e-12."""
    rng = np.random.default_rng(10 * dim + p)
    n_loc = (p + 1) ** dim
    u = T(rng.standard_normal((dim, 7, n_loc)))
    geo = T(np.repeat(rng.uniform(0.5, 2.0, (7, 1)), dim, axis=1))
    si = shape_info(p)
    want = cell_elasticity.elastic_rows(u, T(si.S), T(si.Dc), T(si.quad_weights_tensor(dim)),
                                        geo, MU, LAM)
    assert rel_err(column_schedule(u, p, geo, dim), want) < RTOL


def test_cell_elasticity_bound_counts_the_even_odd_sweeps():
    """cell_elasticity.bytes_and_flops: the operations of the kernel's
    even-odd sweeps (16 a line and component in 3-D, 8 in 2-D, ``sweep_flops``)
    and the point operator; the bytes the function's inputs and outputs (not
    the launch's factor tables)."""
    cpu = torch.device("cpu")
    for dim, p in ((3, 4), (2, 4)):
        mf = mt.MatrixFree(mt.create_quadrant(dim, 2), p)
        args = mf.cell_laplace_args(cpu, torch.float64, hn=False)
        src = torch.zeros(mf.n_dofs, dim, dtype=torch.float64)
        nbytes, flops = cell_elasticity.bytes_and_flops(src, *args, MU, LAM)
        n = p + 1
        sweeps = cell_elasticity.SWEEPS[dim]
        per_line = (sum(cell_elasticity.sweep_flops(n, s) * k for s, k in sweeps.items())
                    + cell_elasticity.LINE_ADDS[dim] * n)
        want = mf.n_cells * (dim * n ** (dim - 1) * per_line + (40 if dim == 3 else 16) * n**dim)
        assert flops == want
        whole = mf.n_cells * dim * n ** (dim - 1) * 2 * n * n * sum(sweeps.values())
        assert flops < whole  # fewer than whole sweeps of the same schedule
        n_loc = n**dim
        n_src = dim * int(torch.unique(args[0]).numel())
        assert nbytes == 8 * (n_src + dim * mf.n_cells * n_loc + 4 * n * n + n_loc
                              + args[6].numel()) + 4 * args[0].numel()


# ---- brick_elasticity's schedule -------------------------------------------------------
ELASTIC_OPS = [(3, p) for p in (1, 2, 4, 8)] + [(2, p) for p in (1, 3, 6)]


@pytest.mark.parametrize("dim,p", ELASTIC_OPS, ids=[f"{d}d-p{p}" for d, p in ELASTIC_OPS])
def test_kernel_factors_assemble_the_operators_brick_factors(dim, p):
    """BrickElasticity's launch parameters: brick_elasticity's cell factors
    (K1, M1, G1, G1^T, float64 on the host) assembled over the brick's cells
    give the operator's brick factors Kb, Mb, Gb bit for bit (the kernel
    sweeps a brick factor's rows as its cells' blocks), and
    cell_elasticity's tables are factor_tables of the operator's S and
    Dc."""
    mf = mt.MatrixFree(mt.create_quadrant(dim, 2), p)
    op = mt.BrickElasticity(mf, MU, LAM, device="cpu")
    F = op.brick_kernel_factors
    assert F.dtype == torch.float64 and F.device.type == "cpu" and F.shape == (4, p + 1, p + 1)
    assert torch.equal(F[3], F[2].T)
    fb = brick_elasticity.brick_factors(*(F[i].numpy() for i in range(3)), op.mm.B)
    for name in ("K", "M", "G"):
        assert np.array_equal(fb[name], getattr(op, f"{name}b").numpy())
    si = shape_info(p)
    assert np.array_equal(op.cell_kernel_factors, cell_elasticity.factor_tables(si.S, si.Dc))


def cell_sweep(F1, x, axis):
    """The kernels' sweep of every line of x along axis by a brick factor
    assembled from the cell factor F1 (csrc/brick_elasticity.cu's cell_dot):
    each cell's block applied to its p+1 nodes, a boundary node taking the
    left cell's last row, then the right cell's first."""
    p = F1.shape[0] - 1
    x = np.moveaxis(x, axis, -1)
    out = np.zeros_like(x)
    for q in range((x.shape[-1] - 1) // p):
        out[..., q * p:q * p + p + 1] += x[..., q * p:q * p + p + 1] @ F1.T
    return np.moveaxis(out, -1, axis)


@pytest.mark.parametrize("p,B", [(1, 3), (2, 2), (4, 2), (5, 2), (8, 2)])
def test_kernel_schedule_computes_the_operator(p, B):
    """The 3-D kernel's schedule (``kernel_schedule``: each block (c, k) swept
    on its own, x, y, z, with the x sweep shared where both terms have M
    along x and the z sweep where both have M along z: 53 applications a
    brick), each sweep by the cell factors (``cell_sweep``), on random bricks
    and cell factors equals the plain version's term-by-term sum, to 1e-12."""
    rng = np.random.default_rng(p)
    K1, M1, G1 = (rng.standard_normal((p + 1, p + 1)) for _ in range(3))
    fac = brick_elasticity.brick_factors(K1, M1, G1, B)
    NB = B * p + 1
    u = rng.standard_normal((3, 2, NB, NB, NB))  # (component, brick, z, y, x)
    cf = dict(K=K1, M=M1, G=G1, GT=G1.T)
    sweep = lambda name, x, a: cell_sweep(cf[name], x, {0: -1, 1: -2, 2: -3}[a])
    got, apps = np.zeros_like(u), 0
    for c in range(3):
        al = [2 * MU + LAM if a == c else MU for a in range(3)]
        for k in range(3):
            (xa, xb), (y1a, y1b, y2), (z1, z2) = kernel_schedule(c, k)
            a = sweep(xa, u[k], 0)
            b = a if xa == xb else sweep(xb, u[k], 0)
            apps += 1 if xa == xb else 2
            s1a, t1, t2 = (al[0], 1.0, al[2]) if c == k else (1.0, MU, LAM)
            c1 = s1a * sweep(y1a, a, 1) + (al[1] * sweep(y1b, b, 1) if y1b else 0)
            c2 = sweep(y2, b, 1)
            apps += 3 if y1b else 2
            if z1 == z2:
                got[c] += sweep(z1, t1 * c1 + t2 * c2, 2)
                apps += 1
            else:
                got[c] += t1 * sweep(z1, c1, 2) + t2 * sweep(z2, c2, 2)
                apps += 2
    assert apps == 53
    want = brick_elasticity.brick_elasticity_plain(
        T(u.reshape(3, 2, -1)), {n: T(fac[n]) for n in ("K", "M", "G")},
        torch.ones(2, dtype=torch.float64), p, MU, LAM)
    assert rel_err(got.reshape(3, 2, -1), want.numpy()) < RTOL


@pytest.mark.parametrize("p", [1, 2, 4, 6])
def test_2d_schedule_computes_both_outputs(p):
    """The 2-D kernel's schedule: each input's line through its four x
    factors once (8 lines a brick row), then each output's four terms
    (``grouped_terms(2)``, coefficient times the y factor on one of the 8),
    every sweep by the cell factors, equal the plain version, to 1e-12, on
    random cell factors."""
    rng = np.random.default_rng(p)
    K1, M1, G1 = (rng.standard_normal((p + 1, p + 1)) for _ in range(3))
    B = 3
    fac = brick_elasticity.brick_factors(K1, M1, G1, B)
    NB = B * p + 1
    u = rng.standard_normal((2, 3, NB, NB))  # (component, brick, y, x)
    cf = dict(K=K1, M=M1, G=G1, GT=G1.T)
    X = {(k, f): cell_sweep(cf[f], u[k], -1) for k in range(2) for f in brick_elasticity.FACTORS}
    groups = grouped_terms(2)
    assert sum(len(g) for g in groups.values()) == 8
    got = np.zeros_like(u)
    for (c, fy), group in groups.items():
        for k, fx, _, (cm, cl) in group:
            got[c] += (cm * MU + cl * LAM) * cell_sweep(cf[fy], X[k, fx], -2)
    want = brick_elasticity.brick_elasticity_plain(
        T(u.reshape(2, 3, -1)), {n: T(fac[n]) for n in ("K", "M", "G")},
        torch.ones(3, dtype=torch.float64), p, MU, LAM)
    assert rel_err(got.reshape(2, 3, -1), want.numpy()) < RTOL


@pytest.mark.parametrize("dim", [3, 2])
def test_brick_elasticity_bound_counts_inputs_and_outputs(dim):
    """brick_elasticity.bytes_and_flops: the bytes of u, v with its padding,
    the four cell factors, geo and the cell rows (the function's inputs and
    output); the operations the least schedule's (45 line applications in
    3-D, below the kernel's 53; 16 in 2-D, the kernel's)."""
    NB, p, N3p = (17, 4, 4992) if dim == 3 else (33, 4, 1152)
    nnz = len(factor_structure(NB, p)[0])
    nb, m = 10, 3
    nbytes, flops = brick_elasticity.bytes_and_flops(nb, NB, p, N3p, 4, m)
    n_rows = dim * m * ((NB - 1) // p) ** dim * (p + 1) ** dim
    assert nbytes == 4 * (dim * nb * NB**dim + dim * nb * N3p + 4 * (p + 1) ** 2 + nb + n_rows)
    sweeps, n_terms = brick_elasticity.least_schedule(dim)
    assert flops == (sweeps * 2 * nnz * NB ** (dim - 1) + (2 * n_terms + dim) * NB**dim) * nb \
        + n_rows


# ---- the deformed metric in PyTorch ------------------------------------------------------
METRIC_CASES = [(3, 2, 2), (3, 3, 4), (3, 2, 5), (2, 4, 4), (2, 5, 2), (2, 3, 6)]


@pytest.mark.parametrize("dim,nref,p", METRIC_CASES,
                         ids=[f"{d}d-nref{n}-p{p}" for d, n, p in METRIC_CASES])
def test_metric_in_torch_matches_numpy_and_the_reference(dim, nref, p):
    """deformed_laplace_factors on a torch device (the CPU here; chunks of 7
    cells, so chunks end inside the mesh) against its NumPy form and the JAX
    package's (NumPy) function: within 1e-13 of the largest entry."""
    tria = mt.create_quadrant(dim, nref)
    sh = shape_info(p)
    host = deformed_laplace_factors(tria, sh)
    dev = deformed_laplace_factors(tria, sh, chunk=7, device="cpu")
    want = ref_metric(ref.create_quadrant(dim, nref), ref_shape_info(p))
    assert dev.shape == host.shape == want.shape and dev.dtype == np.float64
    scale = np.abs(want).max()
    assert np.abs(dev - host).max() <= 1e-13 * scale
    assert np.abs(dev - want).max() <= 1e-13 * scale


@pytest.mark.parametrize("first_user", ["index", "bricks", "host"])
def test_matrix_free_builds_the_metric_once_by_its_first_user(first_user):
    """MatrixFree.deformed_metric: the index engine's staging of geo, the
    brick operator's setup or the host tables build the metric at their
    first use, on the CPU in NumPy (bit for bit deformed_laplace_factors on
    the host, in the categorized cell order), and every later user reads
    the same array."""
    tria = mt.create_quadrant(3, 2)
    cpu = torch.device("cpu")
    mf = mt.MatrixFree(tria, 3, high_order_mapping=True, categorize=first_user != "bricks")
    assert mf._metric is None
    if first_user == "index":
        mf.cell_laplace_args(cpu, torch.float64)
    elif first_user == "bricks":
        mt.BrickLaplaceMM(mf, device=cpu)
    else:
        np.asarray(mf._np["geo"])
    metric = mf._metric
    want = deformed_laplace_factors(tria, shape_info(3))[mf.cell_permutation]
    assert metric is not None and np.array_equal(metric, want)
    assert mf.deformed_metric(cpu) is metric and mf._sources["geo"] is metric
    with pytest.raises(ValueError, match="no deformed mapping"):
        mt.MatrixFree(tria, 3).deformed_metric()


@pytest.mark.cuda
def test_matrix_free_builds_a_card_operators_metric_on_the_card():
    """A deformed index operator on the card builds its metric there (in
    PyTorch, float64), within 1e-13 of the NumPy form on the host, and its
    vmult agrees with the plain path on the host metric."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tria = mt.create_quadrant(3, 3)
    mf = mt.MatrixFree(tria, 4, high_order_mapping=True)
    op = mt.LaplaceOperator(mf, device="cuda")
    x = np.random.default_rng(0).standard_normal(mf.n_dofs)
    got = op.vmult(torch.from_numpy(x).cuda()).cpu().numpy()
    want = deformed_laplace_factors(tria, shape_info(4))
    assert np.abs(mf._metric - want).max() <= 1e-13 * np.abs(want).max()
    host = mt.MatrixFree(tria, 4, high_order_mapping=True)
    ref_y = mt.LaplaceOperator(host, device="cpu").vmult(torch.from_numpy(x)).numpy()
    assert rel_err(got, ref_y) < 1e-12
