"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, runs on the card unless asked for the CPU, keeps a CUDA source and
a launch count beside each kernel, and its smoke script refuses to run
without a card. The kernels themselves run only on a CUDA card (the tests
marked ``cuda``)."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import KERNEL_MODULES  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "dealii_matrixfree_hanging_nodes_tpu_torch"


def _run(code, cwd=REPO):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=120)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import dealii_matrixfree_hanging_nodes_tpu_torch as mt\n"
        "import dealii_matrixfree_hanging_nodes_tpu_torch.convert\n"
        "import dealii_matrixfree_hanging_nodes_tpu_torch.oracle\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'dealii_matrixfree_hanging_nodes_tpu']\n"
        "print(bad)\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_port_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import dealii_matrixfree_hanging_nodes_tpu\b"
                         r"|from dealii_matrixfree_hanging_nodes_tpu[ .])", re.M)
    for path in list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def test_default_device_is_cuda():
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    mf = mt.MatrixFree(mt.create_quadrant(3, 2), 4)
    for op in (mt.BrickLaplaceMM, mt.LaplaceOperator):
        if torch.cuda.is_available():
            assert op(mf).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                op(mf)
        assert op(mf, device="cpu").device.type == "cpu"


def test_unported_branches_raise():
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    with pytest.raises(NotImplementedError):
        mt.BrickLaplaceMM(mt.MatrixFree(mt.create_quadrant(3, 2), 3, high_order_mapping=True),
                          device="cpu")
    with pytest.raises(NotImplementedError):
        mt.BrickLaplaceMM(mt.MatrixFree(mt.create_quadrant(2, 2), 4), device="cpu")
    with pytest.raises(NotImplementedError):  # the brick engine reads cells in mesh order
        mt.BrickLaplaceMM(mt.MatrixFree(mt.create_quadrant(3, 2), 4, categorize=True),
                          device="cpu")


def test_index_engine_raises_for_2d():
    """The index engine is 3-D only, on every device."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    mf = mt.MatrixFree(mt.create_quadrant(2, 2), 4)
    with pytest.raises(NotImplementedError):
        mt.LaplaceOperator(mf, device="cpu")
    with pytest.raises(NotImplementedError):
        mf.apply_hanging_node_constraints(torch.zeros(mf.n_cells, 25, dtype=torch.float64), False)
    with pytest.raises(NotImplementedError):
        mf.cell_loop(lambda u, a: u, torch.zeros(mf.n_dofs, dtype=torch.float64))
    with pytest.raises(NotImplementedError):
        mt.apply_hanging_node_constraints(torch.zeros(3, 25, dtype=torch.float64),
                                          torch.zeros(3, dtype=torch.int32),
                                          mf.shape.P, 2)


@pytest.mark.parametrize("mod", KERNEL_MODULES, ids=lambda m: m.NAME)
def test_kernel_module_has_source_and_counter(mod):
    src = PKG / "csrc" / f"{mod.NAME}.cu"
    text = src.read_text()
    assert "Replaces:" in text and "Bound on an H100" in text and "Design:" in text
    assert 'extern "C"' in text
    wrapper = getattr(mod, mod.NAME)
    assert isinstance(wrapper.launches, int)
    assert callable(getattr(mod, f"{mod.NAME}_plain"))
    path, line = mod.REPLACES.rsplit(":", 1)
    assert (REPO / path).exists() and int(line) > 0


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """A kernel library is named by its source and the csrc headers it
    includes, so an edited header rebuilds every kernel that includes it
    and no other."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import _build

    for name in ("cell_apply.cu", "hn_cell.cu", "brick_apply.cu", "sum_factorization.cuh"):
        shutil.copy(PKG / "csrc" / name, tmp_path)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = ("cell_apply", "hn_cell", "brick_apply")
    before = {n: _build.library_path(n) for n in names}
    assert [p.name for p in _build._sources(tmp_path / "hn_cell.cu", [])] == [
        "hn_cell.cu", "sum_factorization.cuh"]
    header = tmp_path / "sum_factorization.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["cell_apply"] != before["cell_apply"]
    assert after["hn_cell"] != before["hn_cell"]
    assert after["brick_apply"] == before["brick_apply"]


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the smoke script exits non-zero and prints no result;
    copied alone into an empty directory it cannot run either."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for cwd in (REPO, tmp_path):
        if cwd is tmp_path:
            shutil.copy(REPO / "chip_smoke.py", tmp_path)
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


# ---- on the card -------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernels_match_plain_on_card(cuda, dtype):
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        brick_apply, cell_apply, corr_compact, dss_surface, hn_cell, refill_update,
    )

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    mf = mt.MatrixFree(mt.create_quadrant(3, 4), 4)
    op = mt.BrickLaplaceMM(mf, device=cuda, dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    bv = torch.randn(op.n_bricks, op.N3p, generator=g, device=cuda, dtype=dtype)
    cols = torch.randn(op.n_sub * op.C, op.n_loc, generator=g, device=cuda, dtype=dtype)
    rows = torch.randn(op.n_hn, op.n_loc, generator=g, device=cuda, dtype=dtype)
    hn_args = (bv[: op.n_sub], *op.hn_tables(), *op.factors_host, op.geo_hn, op.B)
    chain = [
        (corr_compact, (cols, rows, *op.corr_tables())),
        (refill_update, (bv, rows, *op.refill_tables())),
    ]
    pairs = [(getattr(mod, mod.NAME)(*args), getattr(mod, f"{mod.NAME}_plain")(*args))
             for mod, args in chain]
    pairs += [(hn_cell.hn_cell(*hn_args, mode=mode),
               hn_cell.hn_cell_plain(*hn_args[:-4], op.K1, op.M1, *hn_args[-2:], mode=mode))
              for mode in hn_cell.MODES]
    pairs += [
        (op.vmult(bv), op.vmult(bv, plain=True)),
        (op.refill(bv), op.refill(bv, plain=True)),
        (brick_apply.brick_apply(bv, *op.brick_factors_host, op.geo, op.p),
         brick_apply.brick_apply_plain(bv, op.Kb, op.Mb, op.geo, op.p)),
        (brick_apply.brick_apply(bv, *op.brick_factors_host, op.geo, op.p, dcols=cols,
                                 brick_size=op.B),
         brick_apply.brick_apply_plain(bv, op.Kb, op.Mb, op.geo, op.p, dcols=cols,
                                       brick_size=op.B)),
        (cell_apply.cell_apply(bv[: op.n_sub], *op.factors_host, op.geo_cell_sub, brick_size=op.B),
         cell_apply.cell_apply_plain(bv[: op.n_sub], op.K1, op.M1, op.geo_cell_sub, op.B)),
        (dss_surface.dss_surface(bv.clone(), *op.dss_tables()),
         dss_surface.dss_surface_plain(bv.clone(), *op.dss_tables())),
    ]
    torch.cuda.synchronize()
    for got, ref in pairs:
        assert float((got - ref).abs().max() / ref.abs().max()) < tol
    with pytest.raises(ValueError, match="host tensors"):  # no hidden copy to the host
        cell_apply.cell_apply(bv[: op.n_sub], op.K1, op.M1, op.geo_cell_sub, brick_size=op.B)
    with pytest.raises(ValueError, match="host tensors"):
        hn_cell.hn_cell(*hn_args[:-4], op.K1, op.M1, *hn_args[-2:])
    with pytest.raises(ValueError, match="host tensors"):
        brick_apply.brick_apply(bv, *(f.to(cuda) for f in op.brick_factors_host), op.geo, op.p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p", [5, 6, 7, 8])
def test_brick_apply_degrees_on_card(cuda, p, dtype):
    """brick_apply at the degrees of two cells a brick side, without and
    with cell rows (on the leading half of the bricks), against its plain
    version."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import brick_apply

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    op = mt.BrickLaplaceMM(mt.MatrixFree(mt.create_quadrant(3, 3), p), device=cuda, dtype=dtype)
    assert (op.NB, op.p) in brick_apply.SUPPORTED and op.B == 2
    g = torch.Generator(device=cuda).manual_seed(p)
    bv = torch.randn(op.n_bricks, op.N3p, generator=g, device=cuda, dtype=dtype)
    m = (op.n_bricks + 1) // 2
    cols = torch.randn(m * op.C, op.n_loc, generator=g, device=cuda, dtype=dtype)
    for extra in ({}, {"dcols": cols, "brick_size": op.B}):
        got = brick_apply.brick_apply(bv, *op.brick_factors_host, op.geo, op.p, **extra)
        ref = brick_apply.brick_apply_plain(bv, op.Kb, op.Mb, op.geo, op.p, **extra)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max() / ref.abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p", [5, 6, 7, 8])
def test_hn_cell_degrees_on_card(cuda, p, dtype):
    """hn_cell at the degrees of two cells a brick side (8 rows a block), in
    both modes, against its plain version."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import hn_cell

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    op = mt.BrickLaplaceMM(mt.MatrixFree(mt.create_quadrant(3, 3), p), device=cuda, dtype=dtype)
    assert op.B == 2 and op.n_hn > 8
    g = torch.Generator(device=cuda).manual_seed(p)
    u_sub = torch.randn(op.n_sub, op.N3p, generator=g, device=cuda, dtype=dtype)
    for mode in hn_cell.MODES:
        got = hn_cell.hn_cell(u_sub, *op.hn_tables(), *op.factors_host, op.geo_hn, op.B,
                              mode=mode)
        ref = hn_cell.hn_cell_plain(u_sub, *op.hn_tables(), op.K1, op.M1, op.geo_hn, op.B,
                                    mode=mode)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max() / ref.abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p", [5, 6, 7, 8])
def test_refill_corr_degrees_on_card(cuda, p, dtype):
    """refill_update and corr_compact at the degrees of two cells a brick
    side (their block schedule and holders at each n_loc) against their
    plain versions."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import corr_compact, refill_update

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    op = mt.BrickLaplaceMM(mt.MatrixFree(mt.create_quadrant(3, 3), p), device=cuda, dtype=dtype)
    assert op.B == 2 and op.n_hn > 0
    g = torch.Generator(device=cuda).manual_seed(p)
    bv = torch.randn(op.n_bricks, op.N3p, generator=g, device=cuda, dtype=dtype)
    cols = torch.randn(op.n_sub * op.C, op.n_loc, generator=g, device=cuda, dtype=dtype)
    rows = torch.randn(op.n_hn, op.n_loc, generator=g, device=cuda, dtype=dtype)
    for mod, args in ((corr_compact, (cols, rows, *op.corr_tables())),
                      (refill_update, (bv, rows, *op.refill_tables()))):
        got = getattr(mod, mod.NAME)(*args)
        ref = getattr(mod, f"{mod.NAME}_plain")(*args)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max() / ref.abs().max()) < tol


def _rel(got, ref):
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("geo,nref,p", [("quadrant", 4, 3), ("quadrant", 4, 2), ("step", 4, 2),
                                        ("quadrant", 6, 1)],
                         ids=["quadrant-4-p3", "quadrant-4-p2", "step-4-p2", "quadrant-6-p1"])
def test_low_degree_kernels_on_card(cuda, geo, nref, p, dtype):
    """The degree <= 3 schedule on the card: masked_quad, plane_fill and
    plane_fold, and brick_apply, hn_cell, corr_compact (without plain rows)
    and refill_update at their instances for B = 4, 8, 16, each against its
    plain version; vmult, vmult_plain and refill against the plain path."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        brick_apply, corr_compact, hn_cell, masked_quad, plane_fill, plane_fold, refill_update,
    )

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    op = mt.BrickLaplaceMM(mt.MatrixFree(mt.create_geometry(geo, 3, nref), p), device=cuda,
                           dtype=dtype)
    assert op.assembled and op.planes == (p <= 2) and op.n_hn > 0
    g = torch.Generator(device=cuda).manual_seed(p)
    bv = torch.randn(op.n_bricks, op.N3p, generator=g, device=cuda, dtype=dtype)
    v = torch.randn(op.n_bricks, op.N3p, generator=g, device=cuda, dtype=dtype)
    rows = torch.randn(op.n_hn, op.n_loc, generator=g, device=cuda, dtype=dtype)
    cols = torch.randn(op.n_corr_rows, op.n_loc, generator=g, device=cuda, dtype=dtype)
    pairs = []
    for kind in ("rem", "absent"):
        args = (bv, *op.masked_tables(kind))
        pairs.append((masked_quad.masked_quad(v.clone(), *args, *op.factors_host, op.geo, op.B),
                      masked_quad.masked_quad_plain(v.clone(), *args, op.K1, op.M1, op.geo, op.B)))
    if op.planes:
        pairs += [(plane_fill.plane_fill(bv, *op.plane_fill_tables()),
                   plane_fill.plane_fill_plain(bv, *op.plane_fill_tables())),
                  (plane_fold.plane_fold(v.clone(), *op.plane_fold_tables()),
                   plane_fold.plane_fold_plain(v.clone(), *op.plane_fold_tables()))]
    hn_args = (bv[: op.n_sub], *op.hn_tables(), *op.factors_host, op.geo_hn, op.B)
    pairs += [(hn_cell.hn_cell(*hn_args, mode=mode),
               hn_cell.hn_cell_plain(*hn_args[:-4], op.K1, op.M1, *hn_args[-2:], mode=mode))
              for mode in hn_cell.MODES]
    for mod, args in ((corr_compact, (None, rows, *op.corr_tables())),
                      (refill_update, (bv, rows, *op.refill_tables()))):
        pairs.append((getattr(mod, mod.NAME)(*args), getattr(mod, f"{mod.NAME}_plain")(*args)))
    for extra in ({}, {"dcols": cols, "brick_size": op.B}):
        pairs.append((brick_apply.brick_apply(bv, *op.brick_factors_host, op.geo, op.p, **extra),
                      brick_apply.brick_apply_plain(bv, op.Kb, op.Mb, op.geo, op.p, **extra)))
    pairs += [(op.vmult(bv), op.vmult(bv, plain=True)),
              (op.vmult_plain(bv), op.vmult_plain(bv, plain=True)),
              (op.refill(bv), op.refill(bv, plain=True))]
    torch.cuda.synchronize()
    for i, (got, ref) in enumerate(pairs):
        assert _rel(got, ref) < tol, i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p", [4, 5])
def test_vmult_plain_on_card(cuda, p, dtype):
    """vmult_plain at p >= 4 (cell_apply, corr_compact with the absent rows'
    codes and no runs, brick_apply's epilogue, dss_surface) against its
    plain path."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    op = mt.BrickLaplaceMM(mt.MatrixFree(mt.create_quadrant(3, 3), p), device=cuda, dtype=dtype)
    assert not op.assembled and op.n_absent > 0
    g = torch.Generator(device=cuda).manual_seed(p)
    bv = torch.randn(op.n_bricks, op.N3p, generator=g, device=cuda, dtype=dtype)
    got, ref = op.vmult_plain(bv), op.vmult_plain(bv, plain=True)
    torch.cuda.synchronize()
    assert _rel(got, ref) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("geo,p", [("quadrant", 2), ("quadrant", 3), ("step", 2)])
def test_low_degree_vmult_on_card_matches_oracle(cuda, geo, p):
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import vmult_oracle

    tria = mt.create_geometry(geo, 3, 4)
    mf = mt.MatrixFree(tria, p)
    op = mt.BrickLaplaceMM(mf, device=cuda)
    u = np.random.default_rng(0).standard_normal(mf.n_dofs)
    got = op.to_dof_vector(op.vmult(op.from_dof_vector(u)), zero_hanging=True).cpu().numpy()
    ref = vmult_oracle(tria, p, u)
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()


@pytest.mark.cuda
def test_vmult_on_card_matches_oracle(cuda):
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import vmult_oracle

    tria = mt.create_quadrant(3, 3)
    mf = mt.MatrixFree(tria, 4)
    op = mt.BrickLaplaceMM(mf, device=cuda)
    u = np.random.default_rng(0).standard_normal(mf.n_dofs)
    got = op.to_dof_vector(op.vmult(op.from_dof_vector(u)), zero_hanging=True).cpu().numpy()
    ref = vmult_oracle(tria, 4, u)
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()


# ---- the index engine on the card ---------------------------------------------
def _index_pairs(mf, dev, dtype, seed):
    """(kernel output, plain output) pairs of the four index-engine kernels on
    mf's tables: hn_interp by the runner of mf.hn_mode in both directions,
    cell_laplace in each of its input, HN and quadrature modes, dof_scatter
    on both maps, constraints_slow in both modes, and the operator's fast,
    slow and unconstrained vmult."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        cell_laplace, constraints_slow, dof_scatter,
    )
    from dealii_matrixfree_hanging_nodes_tpu_torch.models.laplace import LaplaceOperator

    g = torch.Generator(device=dev).manual_seed(seed)
    n_loc = (mf.degree + 1) ** 3
    x = torch.randn(mf.n_dofs, generator=g, device=dev, dtype=dtype)
    rows = torch.randn(mf.n_cells, n_loc, generator=g, device=dev, dtype=dtype)
    pairs = [(mf.apply_hanging_node_constraints(rows, tr),
              mf.apply_hanging_node_constraints(rows, tr, plain=True)) for tr in (False, True)]
    fast, slow = (mf.cell_laplace_args(dev, dtype, slow=s) for s in (False, True))
    for src, dmap in ((x, fast[0]), (x, slow[0]), (rows, None)):
        for hn, flags in ((True, {}), (False, {}), (True, dict(quad=False, hn_out=False)),
                          (True, dict(hn_in=False, quad=False))):
            args = (src, dmap, fast[1] if hn else None, *fast[2:])
            pairs.append((cell_laplace.cell_laplace(*args, **flags),
                          cell_laplace.cell_laplace_plain(*args, **flags)))
    for t in (mf.scatter_tables(False, dev), mf.scatter_tables(True, dev)):
        pairs.append((dof_scatter.dof_scatter(rows, *t), dof_scatter.dof_scatter_plain(rows, *t)))
    for t in mf.slow_tables(dev, dtype).values():
        pairs.append((constraints_slow.constraints_slow(x, *t),
                      constraints_slow.constraints_slow_plain(x, *t)))
    for kw in ({}, {"slow": True}, {"constraints": False}):
        op = LaplaceOperator(mf, device=dev, **kw)
        pairs.append((op.vmult(x), op.vmult(x, plain=True)))
    return pairs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6])
def test_index_kernels_on_card(cuda, p, dtype):
    """hn_interp, cell_laplace, dof_scatter and constraints_slow against their
    plain versions at every degree, under every runner and the deformed
    mapping; two calls of the vmult bit-identical."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.models.laplace import LaplaceOperator

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    tria = mt.create_quadrant(3, 3 if p <= 3 else 2)
    mfs = [mt.MatrixFree(tria, p, hn_mode=mode) for mode in ("compact", "all", "sorted", "matrix")]
    mfs.append(mt.MatrixFree(tria, p, high_order_mapping=True))
    for i, mf in enumerate(mfs):
        assert mf.n_hn_cells > 0
        pairs = _index_pairs(mf, cuda, dtype, seed=p + i)
        torch.cuda.synchronize()
        for k, (got, ref) in enumerate(pairs):
            assert got.shape == ref.shape and _rel(got, ref) < tol, (mf.hn_mode, k)
    op = LaplaceOperator(mfs[0], device=cuda)
    x = torch.randn(mfs[0].n_dofs, device=cuda, dtype=dtype)
    assert torch.equal(op.vmult(x), op.vmult(x))


@pytest.mark.cuda
@pytest.mark.parametrize("p,nref", [(4, 3), (6, 2)])
def test_index_vmult_on_card_matches_oracle(cuda, p, nref):
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.models.laplace import LaplaceOperator
    from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import vmult_oracle

    tria = mt.create_quadrant(3, nref)
    mf = mt.MatrixFree(tria, p)
    u = np.random.default_rng(0).standard_normal(mf.n_dofs)
    ref = vmult_oracle(tria, p, u)
    for slow in (False, True):
        got = LaplaceOperator(mf, slow=slow, device=cuda).vmult(u).cpu().numpy()
        assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()
