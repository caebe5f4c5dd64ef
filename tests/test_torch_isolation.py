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
        "import dealii_matrixfree_hanging_nodes_tpu_torch.models.multigrid_bricks\n"
        "import dealii_matrixfree_hanging_nodes_tpu_torch.models.elasticity\n"
        "import dealii_matrixfree_hanging_nodes_tpu_torch.models.elasticity_bricks\n"
        "import dealii_matrixfree_hanging_nodes_tpu_torch.kernels.cell_elasticity\n"
        "import dealii_matrixfree_hanging_nodes_tpu_torch.kernels.brick_elasticity\n"
        "import dealii_matrixfree_hanging_nodes_tpu_torch.utils.analytic\n"
        "import dealii_matrixfree_hanging_nodes_tpu_torch.parallel.partition\n"
        "import dealii_matrixfree_hanging_nodes_tpu_torch.parallel.comm\n"
        "import dealii_matrixfree_hanging_nodes_tpu_torch.parallel.distributed\n"
        "import dealii_matrixfree_hanging_nodes_tpu_torch.parallel.bricks_distributed\n"
        "import dealii_matrixfree_hanging_nodes_tpu_torch.parallel.multigrid_distributed\n"
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
    for op in (mt.BrickLaplaceMM, mt.LaplaceOperator, mt.DirichletLaplace,
               mt.ElasticityOperator, mt.BrickElasticity):
        if torch.cuda.is_available():
            assert op(mf).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                op(mf)
        assert op(mf, device="cpu").device.type == "cpu"


def test_solver_entry_points_default_to_cuda():
    """The GMG entry points (the index engine's Transfer and
    GMGPreconditioner, the brick engine's BrickGMGPreconditioner) run on the
    card unless the caller passes device="cpu"."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    mfc, mff = (mt.MatrixFree(mt.create_quadrant(3, n), 2) for n in (1, 2))
    entries = (lambda **kw: mt.Transfer(mfc, mff, **kw).E,
               lambda **kw: mt.GMGPreconditioner("quadrant", 3, 2, 2, **kw).fine_op.bmask,
               lambda **kw: mt.BrickGMGPreconditioner("quadrant", 3, 2, 2, **kw).fine_mm.Kb)
    for entry in entries:
        if torch.cuda.is_available():
            assert entry().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                entry()
        assert entry(device="cpu").device.type == "cpu"


def one_rank_group(tmp_path):
    """A one-rank process group in this process (NCCL for CUDA tensors and
    gloo for CPU ones with a card, gloo without), initialised from a file in
    tmp_path."""
    import torch.distributed as dist

    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    return dist


def test_distributed_entry_points_default_to_cuda(tmp_path):
    """The distributed engines run on the card (cuda:<LOCAL_RANK>) unless
    the caller passes device="cpu"; without a card and without a device they
    raise before they need a process group."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch import parallel

    mf = mt.MatrixFree(mt.create_quadrant(3, 2), 4)
    entries = (lambda **kw: parallel.DistributedLaplace(mf, **kw).device,
               lambda **kw: parallel.DistributedLaplace(mf, exchange="halo", **kw).device,
               lambda **kw: parallel.DistributedBrickLaplace(mf, **kw).device,
               lambda **kw: parallel.DistributedDirichletLaplace(mf, **kw).device,
               lambda **kw: parallel.DistributedGMGPreconditioner(
                   "quadrant", 3, 2, 2, **kw).fine_op.device)
    if not torch.cuda.is_available():
        for entry in entries:
            with pytest.raises(RuntimeError, match="CUDA"):
                entry()
    dist = one_rank_group(tmp_path)
    try:
        for entry in entries:
            if torch.cuda.is_available():
                assert entry().type == "cuda"
            assert entry(device="cpu").type == "cpu"
    finally:
        dist.destroy_process_group()


def test_unported_branches_raise():
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.models.multigrid import laplace_diagonal_host

    # vmult_multi under a deformed mapping, as the reference raises (bricks.py:3590-3594);
    # the GMG's host diagonal refuses the deformed mesh, as the reference's does
    mf_d = mt.MatrixFree(mt.create_quadrant(3, 2), 3, high_order_mapping=True)
    deformed = mt.BrickLaplaceMM(mf_d, device="cpu")
    with pytest.raises(NotImplementedError, match="high_order_mapping"):
        deformed.vmult_multi(torch.zeros(2, deformed.n_bricks, deformed.N3p,
                                         dtype=deformed.dtype))
    with pytest.raises(NotImplementedError):
        laplace_diagonal_host(mf_d)
    with pytest.raises(NotImplementedError):  # elasticity on the deformed scalar tables
        mt.BrickElasticity.on_operator(deformed)
    # the deformed 2-D brick engine builds; vmult_multi raises there too, as the reference's
    deformed2 = mt.BrickLaplaceMM(mt.MatrixFree(mt.create_quadrant(2, 2), 4,
                                                high_order_mapping=True), device="cpu")
    assert deformed2.dim == 2 and deformed2.deformed
    with pytest.raises(NotImplementedError, match="high_order_mapping"):
        deformed2.vmult_multi(torch.zeros(2, deformed2.n_bricks, deformed2.N3p,
                                          dtype=deformed2.dtype))
    with pytest.raises(NotImplementedError):  # the brick engine reads cells in mesh order
        mt.BrickLaplaceMM(mt.MatrixFree(mt.create_quadrant(3, 2), 4, categorize=True),
                          device="cpu")
    # vmult_multi under face planes (on by default at p <= 2), as the reference raises
    planes = mt.BrickLaplaceMM(mt.MatrixFree(mt.create_quadrant(3, 4), 2), device="cpu")
    assert planes.planes
    with pytest.raises(NotImplementedError, match="face_planes"):
        planes.vmult_multi(torch.zeros(2, planes.n_bricks, planes.N3p, dtype=planes.dtype))
    # the brick engine's solver takes 2-D, as the brick engine does
    assert mt.BrickGMGPreconditioner("quadrant", 2, 2, 2, device="cpu").fine_mm.dim == 2
    mf2 = mt.MatrixFree(mt.create_quadrant(2, 2), 2)
    # elasticity on both engines: the deformed mapping and non-cube cells raise; dim=2 runs on
    # both
    for elastic in (mt.ElasticityOperator, mt.BrickElasticity):
        with pytest.raises(NotImplementedError):
            elastic(mt.MatrixFree(mt.create_quadrant(3, 2), 2, high_order_mapping=True),
                    device="cpu")
        stretched = mt.MatrixFree(mt.create_quadrant(3, 1), 2)
        stretched._np["geo"][:, 0] *= 2.0  # cells twice as long along one axis
        with pytest.raises(NotImplementedError):
            elastic(stretched, device="cpu")
        with pytest.raises(NotImplementedError):  # the deformed mapping in 2-D too
            elastic(mt.MatrixFree(mt.create_quadrant(2, 2), 2, high_order_mapping=True),
                    device="cpu")
    assert mt.BrickElasticity(mf2, device="cpu").dim == 2


def test_brick_engine_raises_for_2d():
    """The brick engine raises for dim=2 only where the reference does: the
    brick Laplace, the deformed brick engine, the brick GMG (DofEmbed,
    BrickDirichletLaplace, BrickTransfer, BrickGMGPreconditioner and its
    device solver) and BrickElasticity build and run on a 2-D mesh on the
    CPU (tests/test_torch_bricks_2d*.py, test_torch_multigrid_bricks_2d.py
    and test_torch_elasticity_bricks_2d.py hold them against the
    reference); vmult_multi under a deformed mapping and elasticity on the
    deformed tables still raise, as the reference's do."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.models.multigrid_bricks import (
        BrickDirichletLaplace, BrickTransfer, DofEmbed,
    )

    mf = mt.MatrixFree(mt.create_quadrant(2, 2), 4)
    op = mt.BrickLaplaceMM(mf, device="cpu")
    assert op.dim == 2 and op.N3 == op.NB**2 and op.C == op.B**2
    zero = torch.zeros(op.n_bricks, op.N3p, dtype=op.dtype)
    assert op.vmult(zero).shape == (op.n_bricks, op.N3p)
    de = DofEmbed(op)
    assert de.embed(torch.zeros(mf.n_dofs, dtype=op.dtype)).shape == zero.shape
    assert BrickDirichletLaplace(op).vmult(zero).shape == zero.shape
    mfc = mt.MatrixFree(mt.create_quadrant(2, 1), 4)
    tr = BrickTransfer(mt.BrickLaplaceMM(mfc, device="cpu", face_planes=False), op)
    assert tr.restrict(zero).shape[1] == op.N3p
    gmg = mt.BrickGMGPreconditioner("quadrant", 2, 2, 4, device="cpu")
    b = gmg.fine_op.vmult(gmg.fine_mm.from_dof_vector(np.ones(gmg.fine_mf.n_dofs)))
    assert gmg.make_device_solver(tol=1e-8)(b)[1] > 0
    el = mt.BrickElasticity(mf, device="cpu")
    assert el.vmult(torch.zeros(2, op.n_bricks, op.N3p, dtype=op.dtype)).shape == (
        2, op.n_bricks, op.N3p)
    assert mt.BrickElasticity.on_operator(mt.BrickLaplaceMM(mf, device="cpu",
                                                             assembled=False)).dim == 2
    deformed = mt.BrickLaplaceMM(mt.MatrixFree(mt.create_quadrant(2, 2), 4,
                                               high_order_mapping=True), device="cpu")
    assert deformed.vmult(zero).shape == zero.shape
    with pytest.raises(NotImplementedError, match="high_order_mapping"):
        deformed.vmult_multi(zero[None])
    with pytest.raises(NotImplementedError):  # elasticity on the deformed scalar tables
        mt.BrickElasticity.on_operator(deformed)
    # the index engine takes the same mesh
    assert mt.LaplaceOperator(mf, device="cpu").vmult(
        torch.zeros(mf.n_dofs, dtype=torch.float64)).shape == (mf.n_dofs,)


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

    for name in ("cell_apply.cu", "hn_cell.cu", "brick_apply.cu", "sum_factorization.cuh",
                 "cell_transfer.cu", "brick_transfer.cu", "transfer.cuh", "hanging_nodes.cuh",
                 "elasticity.cuh", "cell_elasticity.cu", "brick_elasticity.cu",
                 "laplace_quad.cuh", "cell_laplace.cu", "brick_deformed.cu", "brick_band.cuh",
                 "even_odd.cuh", "laplace_cols.cuh"):
        shutil.copy(PKG / "csrc" / name, tmp_path)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = ("cell_apply", "hn_cell", "brick_apply", "cell_transfer", "brick_transfer",
             "cell_elasticity", "brick_elasticity", "cell_laplace", "brick_deformed")
    before = {n: _build.library_path(n) for n in names}
    assert [p.name for p in _build._sources(tmp_path / "hn_cell.cu", [])] == [
        "hn_cell.cu", "elasticity.cuh", "hanging_nodes.cuh", "laplace_quad.cuh",
        "sum_factorization.cuh"]
    assert [p.name for p in _build._sources(tmp_path / "cell_elasticity.cu", [])] == [
        "cell_elasticity.cu", "elasticity.cuh", "hanging_nodes.cuh", "even_odd.cuh",
        "sum_factorization.cuh"]
    assert [p.name for p in _build._sources(tmp_path / "cell_transfer.cu", [])] == [
        "cell_transfer.cu", "transfer.cuh", "hanging_nodes.cuh"]
    header = tmp_path / "sum_factorization.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["cell_apply"] != before["cell_apply"]
    assert after["hn_cell"] != before["hn_cell"]
    assert after["brick_apply"] == before["brick_apply"]
    assert after["cell_transfer"] == before["cell_transfer"]
    # the transfers' shared sweeps: an edit rebuilds both transfer kernels and nothing else
    header = tmp_path / "transfer.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    final = {n: _build.library_path(n) for n in names}
    assert final["cell_transfer"] != after["cell_transfer"]
    assert final["brick_transfer"] != after["brick_transfer"]
    assert all(final[n] == after[n] for n in ("cell_apply", "hn_cell", "brick_apply"))
    # elasticity's cell operator: an edit rebuilds the two kernels that include it, and
    # neither the brick operator nor the Laplace kernels
    header = tmp_path / "elasticity.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    last = {n: _build.library_path(n) for n in names}
    assert last["cell_elasticity"] != final["cell_elasticity"]
    assert last["hn_cell"] != final["hn_cell"]
    assert all(last[n] == final[n] for n in ("cell_apply", "brick_apply", "cell_transfer",
                                             "brick_transfer", "brick_elasticity"))
    # the Laplace quadrature at the Gauss points: an edit rebuilds the two kernels that run
    # it (cell_apply's and hn_cell's deformed modes); cell_laplace and brick_deformed run the
    # column phases on the even-odd sweeps since their redesigns
    header = tmp_path / "laplace_quad.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    quad = {n: _build.library_path(n) for n in names}
    assert all(quad[n] != last[n] for n in ("cell_apply", "hn_cell"))
    assert all(quad[n] == last[n] for n in ("brick_apply", "cell_transfer", "brick_transfer",
                                            "cell_elasticity", "brick_elasticity",
                                            "cell_laplace", "brick_deformed"))
    # the brick factors' band structure: an edit rebuilds the two brick operators only
    header = tmp_path / "brick_band.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    band = {n: _build.library_path(n) for n in names}
    assert band["brick_apply"] != quad["brick_apply"]
    assert band["brick_elasticity"] != quad["brick_elasticity"]
    assert all(band[n] == quad[n] for n in names if n not in ("brick_apply", "brick_elasticity"))
    # the even-odd sweeps: an edit rebuilds the three kernels that sweep by them only
    assert [p.name for p in _build._sources(tmp_path / "cell_laplace.cu", [])] == [
        "cell_laplace.cu", "even_odd.cuh", "hanging_nodes.cuh", "laplace_cols.cuh",
        "sum_factorization.cuh"]
    assert [p.name for p in _build._sources(tmp_path / "brick_deformed.cu", [])] == [
        "brick_deformed.cu", "laplace_cols.cuh", "even_odd.cuh", "sum_factorization.cuh"]
    header = tmp_path / "even_odd.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    eo = {n: _build.library_path(n) for n in names}
    sweepers = ("cell_laplace", "cell_elasticity", "brick_deformed")
    assert all(eo[n] != band[n] for n in sweepers)
    assert all(eo[n] == band[n] for n in names if n not in sweepers)
    # the Laplace's column phases: an edit rebuilds the two kernels that run them only
    header = tmp_path / "laplace_cols.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    cols = {n: _build.library_path(n) for n in names}
    assert all(cols[n] != eo[n] for n in ("cell_laplace", "brick_deformed"))
    assert all(cols[n] == eo[n] for n in names if n not in ("cell_laplace", "brick_deformed"))


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


# ---- the multi-RHS vmult on the card ------------------------------------------
def _multi_pairs(op, k, dev, dtype, seed):
    """(kernel output, plain output) pairs of the six kernels of vmult_multi
    on the card with a RHS axis of k: brick_apply with k cell-row blocks,
    cell_apply (p >= 4), hn_cell in both Laplace modes and masked_quad (p <=
    3) on a strided subset view (the first n_sub of n_sub + 1 bricks a RHS,
    as bvk[:, :n_sub] is where the mesh has bricks outside the subset),
    corr_compact on k blocks of rows, dss_surface in place on k brick
    vectors."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        brick_apply, cell_apply, corr_compact, dss_surface, hn_cell, masked_quad,
    )

    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=dtype)
    bvk, v = rnd(k, op.n_bricks, op.N3p), rnd(k, op.n_bricks, op.N3p)
    sub = rnd(k, op.n_sub + 1, op.N3p)[:, : op.n_sub]
    assert not sub.is_contiguous() or k == 1
    rows, hn = rnd(k, op.n_corr_rows, op.n_loc), rnd(k, op.n_hn, op.n_loc)
    plain_rows = None if op.assembled else rows
    fused = dict(dcols=rows, brick_size=op.B)
    hn_tail = (*op.hn_tables(), *op.factors_host, op.geo_hn, op.B)
    hn_plain_tail = (*op.hn_tables(), op.K1, op.M1, op.geo_hn, op.B)
    pairs = [
        (brick_apply.brick_apply(bvk, *op.brick_factors_host, op.geo, op.p, **fused),
         brick_apply.brick_apply_plain(bvk, op.Kb, op.Mb, op.geo, op.p, **fused)),
        (corr_compact.corr_compact(plain_rows, hn, *op.corr_tables()),
         corr_compact.corr_compact_plain(plain_rows, hn, *op.corr_tables())),
        (dss_surface.dss_surface(v.clone(), *op.dss_tables()),
         dss_surface.dss_surface_plain(v.clone(), *op.dss_tables())),
    ]
    pairs += [(hn_cell.hn_cell(sub, *hn_tail, mode=mode),
               hn_cell.hn_cell_plain(sub, *hn_plain_tail, mode=mode)) for mode in hn_cell.MODES]
    if op.assembled:
        kind = "rem" if op.n_hn else "absent"
        mq = op.masked_tables(kind)
        pairs.append((masked_quad.masked_quad(v.clone(), sub, *mq, *op.factors_host, op.geo, op.B),
                      masked_quad.masked_quad_plain(v.clone(), sub, *mq, op.K1, op.M1, op.geo,
                                                    op.B)))
    else:
        pairs.append((cell_apply.cell_apply(sub, *op.factors_host, op.geo_cell_sub, op.B),
                      cell_apply.cell_apply_plain(sub, op.K1, op.M1, op.geo_cell_sub, op.B)))
    return pairs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p,nref", [(4, 3), (5, 2), (3, 4), (2, 4), (1, 5)],
                         ids=["p4", "p5", "p3", "p2", "p1"])
def test_multi_rhs_on_card(cuda, p, nref, dtype):
    """The RHS axis of the six kernels at k = 1, 2, 8 against their plain
    versions on the card (f32 1e-5, f64 1e-12), the subset inputs strided;
    vmult_multi (5 launches) with each RHS bit-identical to vmult of it,
    and against its plain path."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import KERNEL_MODULES

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    op = mt.BrickLaplaceMM(mt.MatrixFree(mt.create_quadrant(3, nref), p), device=cuda,
                           dtype=dtype, face_planes=False)
    assert not op.planes and op.n_hn > 0 and op.n_sub > 0
    wrappers = [getattr(m, m.NAME) for m in KERNEL_MODULES]
    for k in (1, 2, 8):
        for i, (got, ref) in enumerate(_multi_pairs(op, k, cuda, dtype, seed=10 * p + k)):
            torch.cuda.synchronize()
            assert got.shape == ref.shape and got.shape[0] == k, (k, i)
            assert _rel(got, ref) < tol, (k, i)
        g = torch.Generator(device=cuda).manual_seed(k)
        bvk = torch.randn(k, op.n_bricks, op.N3p, generator=g, device=cuda, dtype=dtype)
        for w in wrappers:
            w.launches = 0
        got = op.vmult_multi(bvk)
        torch.cuda.synchronize()
        assert sum(w.launches for w in wrappers) == 5, k
        for j in range(k):
            assert torch.equal(got[j], op.vmult(bvk[j].clone())), (k, j)
        assert _rel(got, op.vmult_multi(bvk, plain=True)) < tol, k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_component_axis_calls_unchanged_on_card(cuda, dtype):
    """Elasticity's k = 3 calls of corr_compact and dss_surface: each
    component bit-identical to a scalar call on it and to the same slices
    of a call on more right-hand sides (k = 5, the same instance)."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import corr_compact, dss_surface

    mm = mt.BrickElasticity(mt.MatrixFree(mt.create_quadrant(3, 3), 4), 1.3, 0.7, device=cuda,
                            dtype=dtype).mm
    g = torch.Generator(device=cuda).manual_seed(3)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=cuda, dtype=dtype)
    rows, hn, bv = rnd(5, mm.n_corr_rows, mm.n_loc), rnd(5, mm.n_hn, mm.n_loc), \
        rnd(5, mm.n_bricks, mm.N3p)
    three = corr_compact.corr_compact(rows[:3], hn[:3], *mm.corr_tables())
    five = corr_compact.corr_compact(rows, hn, *mm.corr_tables())
    v3 = dss_surface.dss_surface(bv[:3].clone(), *mm.dss_tables())
    v5 = dss_surface.dss_surface(bv.clone(), *mm.dss_tables())
    assert torch.equal(three, five[:3]) and torch.equal(v3, v5[:3])
    for c in range(3):
        assert torch.equal(three[c], corr_compact.corr_compact(rows[c], hn[c],
                                                               *mm.corr_tables()))
        assert torch.equal(v3[c], dss_surface.dss_surface(bv[c].clone(), *mm.dss_tables()))


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
            pairs.append((cell_laplace.cell_laplace(*args, **flags, factors=mf.kernel_factors),
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


# ---- elasticity on the card ----------------------------------------------------
ELASTIC_NREF = {1: 4, 2: 3, 3: 3, 4: 2, 5: 2, 6: 2}  # quadrant meshes with constrained rows


def _elastic_pairs(mf, dev, dtype, seed):
    """(kernel output, plain output) pairs of elasticity on both engines:
    cell_elasticity in both modes, hn_cell's elastic mode, corr_compact and
    dss_surface on their component axis, brick_elasticity with and without
    cell rows, dof_scatter on its component axis, and each operator's
    vmult (and vmult_plain, vmult without constraints)."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        brick_elasticity, cell_elasticity, corr_compact, dof_scatter, dss_surface,
    )

    g = torch.Generator(device=dev).manual_seed(seed)
    op = mt.BrickElasticity(mf, 1.3, 0.7, device=dev, dtype=dtype)
    mm = op.mm
    bv = torch.randn(3, mm.n_bricks, mm.N3p, generator=g, device=dev, dtype=dtype)
    rows = torch.randn(3, mm.n_sub * mm.C, mm.n_loc, generator=g, device=dev, dtype=dtype)
    hn = torch.randn(3, mm.n_hn, mm.n_loc, generator=g, device=dev, dtype=dtype)
    pairs = [(op.cell_rows(bv), op.cell_rows(bv, plain=True)),
             (op.hn_rows(bv), op.hn_rows(bv, plain=True)),
             (corr_compact.corr_compact(rows, hn, *mm.corr_tables()),
              corr_compact.corr_compact_plain(rows, hn, *mm.corr_tables())),
             (dss_surface.dss_surface(bv.clone(), *mm.dss_tables()),
              dss_surface.dss_surface_plain(bv.clone(), *mm.dss_tables())),
             (op.vmult(bv), op.vmult(bv, plain=True)),
             (op.vmult_plain(bv), op.vmult_plain(bv, plain=True))]
    dense = dict(K=op.Kb, M=op.Mb, G=op.Gb)
    m = (mm.n_bricks + 1) // 2
    cols = torch.randn(3, m * mm.C, mm.n_loc, generator=g, device=dev, dtype=dtype)
    for extra in ({}, {"dcols": cols, "brick_size": mm.B}):
        pairs.append((brick_elasticity.brick_elasticity(bv, op.brick_kernel_factors, mm.geo,
                                                        mm.p, 1.3, 0.7, **extra),
                      brick_elasticity.brick_elasticity_plain(bv, dense, mm.geo, mm.p, 1.3,
                                                              0.7, **extra)))
    x = torch.randn(mf.n_dofs, 3, generator=g, device=dev, dtype=dtype)
    for cons in (True, False):
        opi = mt.ElasticityOperator(mf, 1.3, 0.7, constraints=cons, device=dev)
        pairs.append((opi.vmult(x.to(opi.dtype)), opi.vmult(x.to(opi.dtype), plain=True)))
    args = mf.cell_laplace_args(dev, dtype)
    pairs.append((cell_elasticity.cell_elasticity(x, *args, 1.3, 0.7,
                                                  factors=op.cell_kernel_factors),
                  cell_elasticity.cell_elasticity_plain(x, *args, 1.3, 0.7)))
    cells = torch.randn(3, mf.n_cells, mm.n_loc, generator=g, device=dev, dtype=dtype)
    t = mf.scatter_tables(False, dev)
    pairs.append((dof_scatter.dof_scatter(cells, *t), dof_scatter.dof_scatter_plain(cells, *t)))
    return op, bv, cells, rows, hn, pairs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6])
def test_elasticity_kernels_on_card(cuda, p, dtype):
    """Elasticity's kernels and the component axis against their plain
    versions at degrees 1..6 (f32 1e-5, f64 1e-12); each component of a
    component-axis call bit-identical to a scalar call on it; two vmults
    of each engine bit-identical."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        corr_compact, dof_scatter, dss_surface,
    )

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    mf = mt.MatrixFree(mt.create_quadrant(3, ELASTIC_NREF[p]), p,
                       dtype=np.float32 if dtype == torch.float32 else np.float64)
    op, bv, cells, rows, hn, pairs = _elastic_pairs(mf, cuda, dtype, seed=p)
    mm = op.mm
    assert mm.n_hn > 0 and mm.n_sub > 0
    torch.cuda.synchronize()
    for k, (got, ref) in enumerate(pairs):
        assert got.shape == ref.shape and _rel(got, ref) < tol, k
    t = mf.scatter_tables(False, cuda)
    three = dof_scatter.dof_scatter(cells, *t)
    dcols = corr_compact.corr_compact(rows, hn, *mm.corr_tables())
    v = dss_surface.dss_surface(bv.clone(), *mm.dss_tables())
    for c in range(3):
        assert torch.equal(three[:, c], dof_scatter.dof_scatter(cells[c].contiguous(), *t))
        assert torch.equal(dcols[c], corr_compact.corr_compact(
            rows[c].contiguous(), hn[c].contiguous(), *mm.corr_tables()))
        assert torch.equal(v[c], dss_surface.dss_surface(bv[c].clone(), *mm.dss_tables()))
    assert torch.equal(op.vmult(bv), op.vmult(bv))
    opi = mt.ElasticityOperator(mf, 1.3, 0.7, device=cuda)
    x = torch.randn(mf.n_dofs, 3, device=cuda, dtype=dtype)
    assert torch.equal(opi.vmult(x), opi.vmult(x))


@pytest.mark.cuda
@pytest.mark.parametrize("geo,nref,p", [("quadrant", 2, 2), ("quadrant", 3, 3), ("step", 2, 1),
                                        ("quadrant", 2, 4)])
def test_elasticity_on_card_matches_oracle(cuda, geo, nref, p):
    """float64 through the kernels on both engines against the dense
    assembled oracle (1e-12), mu=1.3, lam=0.7."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import elasticity_oracle

    tria = mt.create_geometry(geo, 3, nref)
    mf = mt.MatrixFree(tria, p)
    u = np.random.default_rng(0).standard_normal((mf.n_dofs, 3))
    for c in range(3):
        u[:, c] = mf.constraints.distribute(u[:, c])
    ref = elasticity_oracle(tria, p, 1.3, 0.7, u)
    got = mt.ElasticityOperator(mf, 1.3, 0.7, device=cuda).vmult(u).cpu().numpy()
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()
    op = mt.BrickElasticity(mf, 1.3, 0.7, device=cuda)
    got = op.to_dof_vector(op.vmult(op.from_dof_vector(u)), zero_hanging=True).cpu().numpy()
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()


ELASTIC_INSTANCES = [(3, p) for p in range(1, 9)] + [(2, p) for p in range(1, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("dim,p", ELASTIC_INSTANCES,
                         ids=[f"{d}d-p{p}" for d, p in ELASTIC_INSTANCES])
def test_elastic_kernel_instances_on_card(cuda, dim, p, dtype):
    """Every instance of the two elastic kernels (3-D p=1..8, 2-D p=1..6):
    cell_elasticity in its index mode (the cells' codes) and its bricks
    mode, brick_elasticity with and without cell rows, and hn_cell's
    elastic mode, against their plain versions (f32 1e-5, f64 1e-12) at
    quadrant nref=2 (3-D) or 3 (2-D); two calls of each bit-identical."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import cell_elasticity

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    mf = mt.MatrixFree(mt.create_quadrant(dim, 2 if dim == 3 else 3), p)
    op = mt.BrickElasticity(mf, 1.3, 0.7, device=cuda, dtype=dtype)
    mm = op.mm
    g = torch.Generator(device=cuda).manual_seed(p)
    bv = torch.randn(dim, mm.n_bricks, mm.N3p, generator=g, device=cuda, dtype=dtype)
    x = torch.randn(mf.n_dofs, dim, generator=g, device=cuda, dtype=dtype)
    args = mf.cell_laplace_args(cuda, dtype)
    assert mm.n_sub > 0 and mm.n_hn > 0 and bool((args[1] != 0).any())
    cols = op.cell_rows(bv)
    calls = [(lambda: cell_elasticity.cell_elasticity(x, *args, 1.3, 0.7,
                                                      factors=op.cell_kernel_factors),
              lambda: cell_elasticity.cell_elasticity_plain(x, *args, 1.3, 0.7)),
             (lambda: op.cell_rows(bv), lambda: op.cell_rows(bv, plain=True)),
             (lambda: op.hn_rows(bv), lambda: op.hn_rows(bv, plain=True)),
             (lambda: op.brick_apply(bv, None), lambda: op.brick_apply(bv, None, True)),
             (lambda: op.brick_apply(bv, cols), lambda: op.brick_apply(bv, cols, True))]
    for k, (fn, plain) in enumerate(calls):
        got, again, ref = fn(), fn(), plain()
        torch.cuda.synchronize()
        assert got.shape == ref.shape and _rel(got, ref) < tol, k
        assert torch.equal(got, again), k


# ---- the GMG transfers and solves on the card ------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6, 7, 8])
def test_transfer_kernels_on_card(cuda, p, dtype):
    """brick_transfer and dof_embed (each mode, the brick engine's degrees)
    and cell_transfer (each mode, the index engine's p <= 6) against their
    plain versions between quadrant nref 2 and 3; two calls bit-identical."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        brick_transfer, cell_transfer, dof_embed,
    )

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    npdt = np.float32 if dtype == torch.float32 else np.float64
    mfc, mff = (mt.MatrixFree(mt.create_quadrant(3, n), p, dtype=npdt) for n in (2, 3))
    mmc, mmf = (mt.BrickLaplaceMM(mf, device=cuda, face_planes=False) for mf in (mfc, mff))
    g = torch.Generator(device=cuda).manual_seed(p)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=cuda, dtype=dtype)
    bt = mt.BrickTransfer(mmc, mmf)
    de = bt.embed_c
    calls = [(brick_transfer, (rnd(mmc.n_bricks, mmc.N3p), *bt.tables()), dict(mode="prolongate")),
             (brick_transfer, (rnd(mmf.n_bricks, mmf.N3p), *bt.tables()), dict(mode="restrict")),
             (dof_embed, (rnd(mfc.n_dofs), *de.tables("embed"), de.shape), {}),
             (dof_embed, (rnd(*de.shape), *de.tables("embed_t"), (de.n_dofs,)), {})]
    if p <= 6:
        tr = mt.Transfer(mfc, mff, device=cuda)
        calls += [(cell_transfer, (rnd(mfc.n_cells, (p + 1) ** 3), *tr.tables()),
                   dict(mode="prolongate")),
                  (cell_transfer, (rnd(mff.n_dofs), *tr.tables()), dict(mode="restrict"))]
    for mod, args, kw in calls:
        before = getattr(mod, mod.NAME).launches
        got = getattr(mod, mod.NAME)(*args, **kw)
        again = getattr(mod, mod.NAME)(*args, **kw)
        ref = getattr(mod, f"{mod.NAME}_plain")(*args, **kw)
        torch.cuda.synchronize()
        assert getattr(mod, mod.NAME).launches == before + 2
        assert got.shape == ref.shape and _rel(got, ref) < tol, (mod.NAME, kw)
        assert torch.equal(got, again), (mod.NAME, kw)


def _embed_rows_csr(ptr, idx, w, rows):
    """dof_embed's lists of the given rows alone, in their order."""
    start = ptr[:-1].long()[rows]
    length = ptr[1:].long()[rows] - start
    sub = torch.zeros(len(rows) + 1, dtype=torch.int64, device=ptr.device)
    sub[1:] = torch.cumsum(length, 0)
    ent = (torch.arange(int(sub[-1]), device=ptr.device)
           + torch.repeat_interleave(start - sub[:-1], length))
    return sub.to(torch.int32), idx[ent], w[ent]


def _hold_brick_gmg_kernels(bt, mmc, mmf, dtype, seed):
    """brick_transfer (both modes) and dof_embed (both modes) on bt's tables
    against their plain versions (f32 1e-5, f64 1e-12), one launch a call,
    two calls bit-identical; dof_embed on the lists of its long rows alone
    (every row listed long) and of its short rows alone (none listed) gives
    the whole call's bits at those rows."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import brick_transfer, dof_embed

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    dev = mmf.device
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=dtype)
    de = bt.embed_c
    calls = [(brick_transfer, (rnd(mmc.n_bricks, mmc.N3p), *bt.tables()), dict(mode="prolongate")),
             (brick_transfer, (rnd(mmf.n_bricks, mmf.N3p), *bt.tables()), dict(mode="restrict")),
             (dof_embed, (rnd(de.n_dofs), *de.tables("embed"), de.shape), {}),
             (dof_embed, (rnd(*de.shape), *de.tables("embed_t"), (de.n_dofs,)), {})]
    for mod, args, kw in calls:
        got = _counted(lambda: getattr(mod, mod.NAME)(*args, **kw), 1, mod.NAME)
        again = getattr(mod, mod.NAME)(*args, **kw)
        ref = getattr(mod, f"{mod.NAME}_plain")(*args, **kw)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and _rel(got, ref) < tol, (mod.NAME, kw)
        assert torch.equal(got, again), (mod.NAME, kw)
        if mod is dof_embed:
            x, ptr, idx, w, long = args[:5]
            short = torch.ones(ptr.numel() - 1, dtype=torch.bool, device=dev)
            short[long.long()] = False
            for rows, listed in ((long.long(), True), (torch.nonzero(short).reshape(-1), False)):
                sub = _embed_rows_csr(ptr, idx, w, rows)
                sub_long = (torch.arange(len(rows), dtype=torch.int32, device=dev) if listed
                            else torch.zeros(0, dtype=torch.int32, device=dev))
                part = dof_embed.dof_embed(x, *sub, sub_long, (len(rows),))
                assert torch.equal(part, got.reshape(-1)[rows]), (kw, listed)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["prolongate", "restrict"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_brick_transfer_round_rows_match_the_kernel(cuda, dtype, mode):
    """The rows a round that the host's schedules assume (round_rows) are
    the compiled kernel's (plan's last entry), at every dim and degree."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import auto_brick_size
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import _build, brick_transfer

    for dim, degrees in _build.BRICK_DEGREES.items():
        for p in degrees:
            host = brick_transfer.round_rows(dim, p, auto_brick_size(p, dim), mode)
            assert brick_transfer.plan(dtype, p, dim, mode, cuda)[4] == host, (dim, p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_transfer_kernels_on_card_nref5(cuda, dtype):
    """brick_transfer and dof_embed between quadrant nref 4 and 5 at p=4 (the
    coarse level's embed_t rows hold up to 296 entries, 1,285 of them more
    than LONG_ROW, so both kinds of dof_embed blocks run; a fine brick's
    rows take one prolongation round): against their plain versions, two
    calls bit-identical (``_hold_brick_gmg_kernels``)."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    npdt = np.float32 if dtype == torch.float32 else np.float64
    mfc, mff = (mt.MatrixFree(mt.create_quadrant(3, n), 4, dtype=npdt) for n in (4, 5))
    mmc, mmf = (mt.BrickLaplaceMM(mf, device=cuda, face_planes=False) for mf in (mfc, mff))
    bt = mt.BrickTransfer(mmc, mmf)
    assert int(bt.embed_c.embed_t_long.numel()) > 0
    _hold_brick_gmg_kernels(bt, mmc, mmf, dtype, 4)


def _manufactured(mf, seed):
    x = mf.constraints.distribute(np.random.default_rng(seed).standard_normal(mf.n_dofs))
    x[mf.dof_handler.boundary_dofs()] = 0.0
    return x


@pytest.mark.cuda
def test_brick_gmg_solve_on_card(cuda):
    """The brick GMG-CG at quadrant nref=3, p=4, float64 on the card (the
    device solver) takes the iteration count of the plain path on the CPU,
    and reaches the same solution."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    iters, sols = {}, {}
    for dev in ("cpu", cuda):
        gmg = mt.BrickGMGPreconditioner("quadrant", 3, 3, 4, device=dev)
        mm = gmg.fine_mm
        xs = _manufactured(gmg.fine_mf, 0)
        b = gmg.fine_op.vmult(mm.from_dof_vector(xs))
        x, iters[str(dev)], _ = gmg.make_device_solver(tol=1e-10, max_iter=100)(b)
        sols[str(dev)] = mm.to_dof_vector(x).cpu().numpy()
    assert iters["cpu"] == iters[str(cuda)] < 30
    free = ~gmg.fine_mf.constraints.constrained_dof_marker()
    assert np.abs(sols["cpu"] - sols[str(cuda)])[free].max() < 1e-9


@pytest.mark.cuda
def test_index_gmg_solve_on_card(cuda):
    """The index-engine GMG-CG of solve_01.run (quadrant nref=3, p=2,
    float64, tol 1e-10) on the card takes the CPU plain path's count."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    iters = {}
    for dev in ("cpu", cuda):
        gmg = mt.GMGPreconditioner("quadrant", 3, 3, 2, device=dev)
        op = gmg.fine_op
        b = op.vmult(torch.from_numpy(_manufactured(gmg.fine_mf, 0)).to(op.device))
        _, iters[str(dev)], _ = mt.solve_cg(op, b, M=gmg, tol=1e-10, max_iter=100)
    assert iters["cpu"] == iters[str(cuda)] < 30


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p,nref", [(1, 4), (2, 3), (3, 3), (4, 3), (5, 2), (6, 2)],
                         ids=["p1", "p2", "p3", "p4", "p5", "p6"])
def test_deformed_kernels_on_card(cuda, p, nref, dtype):
    """The deformed brick engine at every (p, B): brick_deformed (with and
    without cell rows), cell_apply's and hn_cell's deformed modes against
    their plain versions; vmult (5 launches), vmult_plain (2) and refill
    against the plain path; two vmults bit-identical; the f64 vmult
    against the deformed index engine's."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        KERNEL_MODULES, brick_deformed, cell_apply, hn_cell,
    )

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    mf = mt.MatrixFree(mt.create_quadrant(3, nref), p, high_order_mapping=True)
    op = mt.BrickLaplaceMM(mf, device=cuda, dtype=dtype)
    assert op.deformed and op.n_hn
    g = torch.Generator(device=cuda).manual_seed(p)
    bv = torch.randn(op.n_bricks, op.N3p, generator=g, device=cuda, dtype=dtype)
    cols = torch.randn(op.n_sub * op.C, op.n_loc, generator=g, device=cuda, dtype=dtype)
    bd = (bv, op.metric, op.present_bits, op.S, op.Dc)
    hn_args = (bv[: op.n_sub], *op.hn_tables(), None, None, None, op.B)
    ca_args = (bv[: op.n_sub], None, None, None, op.B)
    tab = op.deformed_tables(op.n_sub * op.C)
    fac = op.kernel_factors
    pairs = [
        (brick_deformed.brick_deformed(*bd, brick_size=op.B, factors=fac),
         brick_deformed.brick_deformed_plain(*bd, brick_size=op.B)),
        (brick_deformed.brick_deformed(*bd, dcols=cols, brick_size=op.B, factors=fac),
         brick_deformed.brick_deformed_plain(*bd, dcols=cols, brick_size=op.B)),
        (cell_apply.cell_apply(*ca_args, deformed=tab),
         cell_apply.cell_apply_plain(*ca_args, deformed=tab)),
        (hn_cell.hn_cell(*hn_args, mode="deformed", deformed=op.deformed_tables()),
         hn_cell.hn_cell_plain(*hn_args, mode="deformed", deformed=op.deformed_tables())),
        (op.vmult_plain(bv), op.vmult_plain(bv, plain=True)),
        (op.refill(bv), op.refill(bv, plain=True)),
    ]
    wrappers = [getattr(m, m.NAME) for m in KERNEL_MODULES]
    before = sum(w.launches for w in wrappers)
    y = op.vmult(bv)
    assert sum(w.launches for w in wrappers) - before == 5
    pairs.append((y, op.vmult(bv, plain=True)))
    torch.cuda.synchronize()
    for got, ref in pairs:
        assert float((got - ref).abs().max() / ref.abs().max()) < tol
    assert torch.equal(y, op.vmult(bv))
    if dtype == torch.float64:
        u = np.random.default_rng(p).standard_normal(mf.n_dofs)
        got = op.to_dof_vector(op.vmult(op.from_dof_vector(u)), zero_hanging=True).cpu().numpy()
        want = mt.LaplaceOperator(mf, device=cuda).vmult(u).cpu().numpy()
        want[mf.constraints.constrained_dof_marker()] = 0.0
        assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


# the 2-D brick engine's cases on the card: (p, quadrant nref), each with hanging nodes, holes
# and (p <= 2) face planes
BRICK_2D = [(1, 6), (2, 6), (3, 5), (4, 5), (5, 4), (6, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p,nref", BRICK_2D, ids=[f"p{p}" for p, _ in BRICK_2D])
def test_brick_kernels_2d_on_card(cuda, p, nref, dtype):
    """The dim=2 instances of the brick engine's kernels against their plain
    versions (f32 1e-5, f64 1e-12): brick_apply with and without cell rows,
    cell_apply (p >= 4), hn_cell in both modes, corr_compact, refill_update,
    dss_surface, masked_quad (p <= 3) and the face planes' plane_fill and
    plane_fold (p <= 2); vmult, vmult_plain and refill against the plain
    path with their launches (p >= 4: 5, 4, 2; p = 3: 5, 3, 2; p <= 2: 8, 3,
    3) and two vmults bit-identical; vmult_multi at k = 3 (5 launches) with
    each RHS bit-identical to vmult of it; the f64 vmult against the oracle."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        KERNEL_MODULES, brick_apply, cell_apply, corr_compact, dss_surface, hn_cell,
        masked_quad, plane_fill, plane_fold, refill_update,
    )
    from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import vmult_oracle

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    tria = mt.create_quadrant(2, nref)
    mf = mt.MatrixFree(tria, p)
    op = mt.BrickLaplaceMM(mf, device=cuda, dtype=dtype)
    assert op.dim == 2 and op.n_hn and op.n_absent and op.planes == (p <= 2)
    g = torch.Generator(device=cuda).manual_seed(p)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=cuda, dtype=dtype)
    bv, v = rnd(op.n_bricks, op.N3p), rnd(op.n_bricks, op.N3p)
    cols, rows = rnd(op.n_corr_rows, op.n_loc), rnd(op.n_hn, op.n_loc)
    hn_args = (bv[: op.n_sub], *op.hn_tables(), *op.factors_host, op.geo_hn, op.B)
    pairs = [(hn_cell.hn_cell(*hn_args, mode=mode),
              hn_cell.hn_cell_plain(*hn_args[:-4], op.K1, op.M1, *hn_args[-2:], mode=mode))
             for mode in hn_cell.MODES]
    for mod, args in ((corr_compact, (None if op.assembled else cols, rows, *op.corr_tables())),
                      (refill_update, (bv, rows, *op.refill_tables()))):
        pairs.append((getattr(mod, mod.NAME)(*args), getattr(mod, f"{mod.NAME}_plain")(*args)))
    for extra in ({}, {"dcols": cols, "brick_size": op.B}):
        pairs.append((brick_apply.brick_apply(bv, *op.brick_factors_host, op.geo, op.p, **extra),
                      brick_apply.brick_apply_plain(bv, op.Kb, op.Mb, op.geo, op.p, **extra)))
    pairs.append((dss_surface.dss_surface(v.clone(), *op.dss_tables()),
                  dss_surface.dss_surface_plain(v.clone(), *op.dss_tables())))
    if op.assembled:
        for kind in ("rem", "absent"):
            args = (bv, *op.masked_tables(kind))
            pairs.append((masked_quad.masked_quad(v.clone(), *args, *op.factors_host, op.geo,
                                                  op.B),
                          masked_quad.masked_quad_plain(v.clone(), *args, op.K1, op.M1, op.geo,
                                                        op.B)))
    else:
        pairs.append((cell_apply.cell_apply(bv[: op.n_sub], *op.factors_host, op.geo_cell_sub,
                                            op.B),
                      cell_apply.cell_apply_plain(bv[: op.n_sub], op.K1, op.M1, op.geo_cell_sub,
                                                  op.B)))
    if op.planes:
        pairs += [(plane_fill.plane_fill(bv, *op.plane_fill_tables()),
                   plane_fill.plane_fill_plain(bv, *op.plane_fill_tables())),
                  (plane_fold.plane_fold(v.clone(), *op.plane_fold_tables()),
                   plane_fold.plane_fold_plain(v.clone(), *op.plane_fold_tables()))]
    wrappers = [getattr(m, m.NAME) for m in KERNEL_MODULES]
    launches = (8, 3, 3) if p <= 2 else (5, 3, 2) if p == 3 else (5, 4, 2)
    for fn, want in zip(("vmult", "vmult_plain", "refill"), launches):
        before = sum(w.launches for w in wrappers)
        got = getattr(op, fn)(bv)
        assert sum(w.launches for w in wrappers) - before == want, fn
        pairs.append((got, getattr(op, fn)(bv, plain=True)))
    torch.cuda.synchronize()
    for i, (got, ref) in enumerate(pairs):
        assert _rel(got, ref) < tol, i
    assert torch.equal(op.vmult(bv), op.vmult(bv))
    mm = op if not op.planes else mt.BrickLaplaceMM(mf, device=cuda, dtype=dtype,
                                                     face_planes=False)
    bvk = rnd(3, mm.n_bricks, mm.N3p)
    before = sum(w.launches for w in wrappers)
    got = mm.vmult_multi(bvk)
    assert sum(w.launches for w in wrappers) - before == 5
    for j in range(3):
        assert torch.equal(got[j], mm.vmult(bvk[j].clone())), j
    assert _rel(got, mm.vmult_multi(bvk, plain=True)) < tol
    if dtype == torch.float64:
        u = np.random.default_rng(p).standard_normal(mf.n_dofs)
        out = op.to_dof_vector(op.vmult(op.from_dof_vector(u)), zero_hanging=True).cpu().numpy()
        assert np.abs(out - vmult_oracle(tria, p, u)).max() < 1e-12 * np.abs(out).max()


def _counted(fn, want, what):
    """fn() with the port's kernel launches during it checked to be `want`."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import KERNEL_MODULES

    wrappers = [getattr(m, m.NAME) for m in KERNEL_MODULES]
    before = sum(w.launches for w in wrappers)
    out = fn()
    assert sum(w.launches for w in wrappers) - before == want, what
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p,nref", BRICK_2D, ids=[f"p{p}" for p, _ in BRICK_2D])
def test_brick_deformed_2d_on_card(cuda, p, nref, dtype):
    """The deformed 2-D brick engine's dim=2 instances against their plain
    versions (f32 1e-5, f64 1e-12): brick_deformed with and without cell
    rows, cell_apply's and hn_cell's deformed modes; vmult (5 launches),
    vmult_plain (2) and refill (2) against the plain path, two vmults
    bit-identical; the f64 vmult against the 2-D deformed index engine's."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        brick_deformed, cell_apply, hn_cell,
    )

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    mf = mt.MatrixFree(mt.create_quadrant(2, nref), p, high_order_mapping=True)
    op = mt.BrickLaplaceMM(mf, device=cuda, dtype=dtype)
    assert op.dim == 2 and op.deformed and op.n_hn
    g = torch.Generator(device=cuda).manual_seed(p)
    bv = torch.randn(op.n_bricks, op.N3p, generator=g, device=cuda, dtype=dtype)
    cols = torch.randn(op.n_sub * op.C, op.n_loc, generator=g, device=cuda, dtype=dtype)
    bd = (bv, op.metric, op.present_bits, op.S, op.Dc)
    hn_args = (bv[: op.n_sub], *op.hn_tables(), None, None, None, op.B)
    ca_args = (bv[: op.n_sub], None, None, None, op.B)
    tab = op.deformed_tables(op.n_sub * op.C)
    fac = op.kernel_factors
    pairs = [
        (brick_deformed.brick_deformed(*bd, brick_size=op.B, factors=fac),
         brick_deformed.brick_deformed_plain(*bd, brick_size=op.B)),
        (brick_deformed.brick_deformed(*bd, dcols=cols, brick_size=op.B, factors=fac),
         brick_deformed.brick_deformed_plain(*bd, dcols=cols, brick_size=op.B)),
        (cell_apply.cell_apply(*ca_args, deformed=tab),
         cell_apply.cell_apply_plain(*ca_args, deformed=tab)),
        (hn_cell.hn_cell(*hn_args, mode="deformed", deformed=op.deformed_tables()),
         hn_cell.hn_cell_plain(*hn_args, mode="deformed", deformed=op.deformed_tables())),
    ]
    for fn, want in (("vmult", 5), ("vmult_plain", 2), ("refill", 2)):
        got = _counted(lambda: getattr(op, fn)(bv), want, fn)
        pairs.append((got, getattr(op, fn)(bv, plain=True)))
    torch.cuda.synchronize()
    for i, (got, ref) in enumerate(pairs):
        assert got.shape == ref.shape and _rel(got, ref) < tol, i
    assert torch.equal(op.vmult(bv), op.vmult(bv))
    if dtype == torch.float64:
        u = np.random.default_rng(p).standard_normal(mf.n_dofs)
        got = op.to_dof_vector(op.vmult(op.from_dof_vector(u)), zero_hanging=True).cpu().numpy()
        want = mt.LaplaceOperator(mf, device=cuda).vmult(u).cpu().numpy()
        want[mf.constraints.constrained_dof_marker()] = 0.0
        assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p,nref", BRICK_2D, ids=[f"p{p}" for p, _ in BRICK_2D])
def test_brick_elasticity_2d_on_card(cuda, p, nref, dtype):
    """The 2-D brick elasticity's dim=2 instances against their plain
    versions (f32 1e-5, f64 1e-12): cell_elasticity's bricks mode, hn_cell's
    elastic mode, brick_elasticity with and without cell rows, corr_compact
    and dss_surface on their component axis at k = 2 (each component
    bit-identical to a scalar call); vmult (5 launches) and vmult_plain (4)
    against the plain path, two vmults bit-identical; the f64 vmult against
    the dense oracle (mu=1.3, lam=0.7)."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        brick_elasticity, corr_compact, dss_surface,
    )
    from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import elasticity_oracle

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    tria = mt.create_quadrant(2, nref)
    mf = mt.MatrixFree(tria, p)
    op = mt.BrickElasticity(mf, 1.3, 0.7, device=cuda, dtype=dtype)
    mm = op.mm
    assert op.dim == 2 and mm.n_hn and mm.n_sub
    g = torch.Generator(device=cuda).manual_seed(p)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=cuda, dtype=dtype)
    bv = rnd(2, mm.n_bricks, mm.N3p)
    rows, hn = rnd(2, mm.n_sub * mm.C, mm.n_loc), rnd(2, mm.n_hn, mm.n_loc)
    pairs = [(op.cell_rows(bv), op.cell_rows(bv, plain=True)),
             (op.hn_rows(bv), op.hn_rows(bv, plain=True)),
             (corr_compact.corr_compact(rows, hn, *mm.corr_tables()),
              corr_compact.corr_compact_plain(rows, hn, *mm.corr_tables())),
             (dss_surface.dss_surface(bv.clone(), *mm.dss_tables()),
              dss_surface.dss_surface_plain(bv.clone(), *mm.dss_tables()))]
    dense = dict(K=op.Kb, M=op.Mb, G=op.Gb)
    m = (mm.n_bricks + 1) // 2
    cols = rnd(2, m * mm.C, mm.n_loc)
    for extra in ({}, {"dcols": cols, "brick_size": mm.B}):
        pairs.append((brick_elasticity.brick_elasticity(bv, op.brick_kernel_factors, mm.geo,
                                                        mm.p, 1.3, 0.7, **extra),
                      brick_elasticity.brick_elasticity_plain(bv, dense, mm.geo, mm.p, 1.3,
                                                              0.7, **extra)))
    for fn, want in (("vmult", 5), ("vmult_plain", 4)):
        got = _counted(lambda: getattr(op, fn)(bv), want, fn)
        pairs.append((got, getattr(op, fn)(bv, plain=True)))
    torch.cuda.synchronize()
    for i, (got, ref) in enumerate(pairs):
        assert got.shape == ref.shape and _rel(got, ref) < tol, i
    dcols = corr_compact.corr_compact(rows, hn, *mm.corr_tables())
    v = dss_surface.dss_surface(bv.clone(), *mm.dss_tables())
    for c in range(2):
        assert torch.equal(dcols[c], corr_compact.corr_compact(
            rows[c].contiguous(), hn[c].contiguous(), *mm.corr_tables()))
        assert torch.equal(v[c], dss_surface.dss_surface(bv[c].clone(), *mm.dss_tables()))
    assert torch.equal(op.vmult(bv), op.vmult(bv))
    if dtype == torch.float64:
        u = np.random.default_rng(p).standard_normal((mf.n_dofs, 2))
        for c in range(2):
            u[:, c] = mf.constraints.distribute(u[:, c])
        ref = elasticity_oracle(tria, p, 1.3, 0.7, u)
        got = op.to_dof_vector(op.vmult(op.from_dof_vector(u)), zero_hanging=True).cpu().numpy()
        assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p,nref", BRICK_2D, ids=[f"p{p}" for p, _ in BRICK_2D])
def test_brick_transfer_2d_on_card(cuda, p, nref, dtype):
    """The 2-D brick GMG's kernels between quadrant nref-1 and nref against
    their plain versions (f32 1e-5, f64 1e-12): brick_transfer's dim=2
    instances in both modes and dof_embed in both modes on a 2-D level; two
    calls bit-identical. In f64 the 2-D brick GMG-CG at quadrant nref=4
    (tol 1e-10) takes the CPU plain path's iteration count."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import brick_transfer, dof_embed

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    npdt = np.float32 if dtype == torch.float32 else np.float64
    mfc, mff = (mt.MatrixFree(mt.create_quadrant(2, n), p, dtype=npdt) for n in (nref - 1, nref))
    mmc, mmf = (mt.BrickLaplaceMM(mf, device=cuda, face_planes=False) for mf in (mfc, mff))
    g = torch.Generator(device=cuda).manual_seed(p)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=cuda, dtype=dtype)
    bt = mt.BrickTransfer(mmc, mmf)
    assert mmf.dim == 2 and bt.E_rows.shape[1] == 2
    de = bt.embed_c
    calls = [(brick_transfer, (rnd(mmc.n_bricks, mmc.N3p), *bt.tables()), dict(mode="prolongate")),
             (brick_transfer, (rnd(mmf.n_bricks, mmf.N3p), *bt.tables()), dict(mode="restrict")),
             (dof_embed, (rnd(mfc.n_dofs), *de.tables("embed"), de.shape), {}),
             (dof_embed, (rnd(*de.shape), *de.tables("embed_t"), (de.n_dofs,)), {})]
    for mod, args, kw in calls:
        got = _counted(lambda: getattr(mod, mod.NAME)(*args, **kw), 1, mod.NAME)
        again = getattr(mod, mod.NAME)(*args, **kw)
        ref = getattr(mod, f"{mod.NAME}_plain")(*args, **kw)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and _rel(got, ref) < tol, (mod.NAME, kw)
        assert torch.equal(got, again), (mod.NAME, kw)
    if dtype == torch.float64 and p in (2, 4):
        iters = {}
        for dev in ("cpu", cuda):
            gmg = mt.BrickGMGPreconditioner("quadrant", 2, 4, p, device=dev)
            mm = gmg.fine_mm
            b = gmg.fine_op.vmult(mm.from_dof_vector(_manufactured(gmg.fine_mf, 0)))
            _, iters[str(dev)], _ = gmg.make_device_solver(tol=1e-10, max_iter=100)(b)
        assert iters["cpu"] == iters[str(cuda)] == 7


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6])
def test_brick_transfer_2d_on_card_nref6(cuda, p, dtype):
    """The 2-D brick GMG's kernels between quadrant nref 5 and 6 at every 2-D
    degree (the coarse level's embed_t rows hold up to 28 entries at p=4 and
    44 at p=6, one of them more than LONG_ROW at p = 5, 6): against their
    plain versions, two calls bit-identical (``_hold_brick_gmg_kernels``)."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    npdt = np.float32 if dtype == torch.float32 else np.float64
    mfc, mff = (mt.MatrixFree(mt.create_quadrant(2, n), p, dtype=npdt) for n in (5, 6))
    mmc, mmf = (mt.BrickLaplaceMM(mf, device=cuda, face_planes=False) for mf in (mfc, mff))
    _hold_brick_gmg_kernels(mt.BrickTransfer(mmc, mmf), mmc, mmf, dtype, p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_distributed_kernels_on_card(cuda, dtype):
    """halo_pack (pack, set, add), dss_pools (accumulate, read) and
    chain_halo (fold, fill) against their plain versions on every rank's
    tables of the R=4 plans (brick engine: both exchanges; index engine:
    the halo)."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import chain_halo, dss_pools, halo_pack
    from dealii_matrixfree_hanging_nodes_tpu_torch.parallel import (DistributedBrickPlan,
                                                                    DistributedLaplacePlan)

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    mf = mt.MatrixFree(mt.create_quadrant(3, 4), 4)
    g = torch.Generator(device=cuda).manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, generator=g, device=cuda, dtype=dtype)
    on = lambda a: torch.from_numpy(np.asarray(a)).to(cuda, dtype if np.asarray(a).dtype.kind
                                                       == "f" else torch.int32)
    pairs = []
    for exchange in ("halo", "replicated"):
        plan = DistributedBrickPlan(mf, 4, exchange=exchange)
        n_loc = (plan.bs.p + 1) ** 3
        for r in range(4):
            t = plan.rank_tables(r)
            v = rand(plan.nb_max, plan.const["N3p"])
            d = t["dss"]
            acc = (*(on(d[k]) for k in ("surf_node", "ent_off", "pool_off", "pool_ptr",
                                        "pool_src")), d["n_slots"])
            pools = dss_pools.dss_pools(v, *acc, mode="accumulate")
            pairs.append((pools, dss_pools.dss_pools_plain(v, *acc, mode="accumulate")))
            read = (pools, on(d["node_ent"]), on(d["read_base"]), on(t["valid_bits"]))
            pairs.append((dss_pools.dss_pools(v.clone(), *read, mode="read"),
                          dss_pools.dss_pools_plain(v.clone(), *read, mode="read")))
            if not plan.has_chain:
                continue
            for key in ("fold_map", "fill_map"):
                m = tuple(on(a) for a in t[key])
                x = rand(m[0].numel() - 1)
                pairs.append((chain_halo.chain_halo(x, *m), chain_halo.chain_halo_plain(x, *m)))
            blk = (on(t["fill_idx"]), on(t["block_valid"]))
            pairs.append((halo_pack.halo_pack(v, *blk, mode="pack"),
                          halo_pack.halo_pack_plain(v, *blk, mode="pack")))
            if exchange == "halo":
                block = rand(plan.n_chain_max, n_loc)
                x = t["fold"]
                send = (on(x["send_idx"]), on(x["send_valid"]))
                pairs.append((halo_pack.halo_pack(block, *send, mode="pack"),
                              halo_pack.halo_pack_plain(block, *send, mode="pack")))
                recv = rand(*x["send_idx"].shape)
                pairs.append((halo_pack.halo_pack(block, recv, on(x["set_map"]), mode="set"),
                              halo_pack.halo_pack_plain(block, recv, on(x["set_map"]),
                                                        mode="set")))
                add = tuple(on(a) for a in t["dss_add"])
                recv = rand(*t["dss_send"][0].shape)
                pairs.append((halo_pack.halo_pack(pools.clone(), recv, *add, mode="add"),
                              halo_pack.halo_pack_plain(pools.clone(), recv, *add, mode="add")))
    plan = DistributedLaplacePlan(mf, 4, exchange="halo")
    for r in range(4):
        t = plan.rank_tables(r)
        src = rand(plan.n_own_max)
        recv = rand(4, plan.halo_max_pair)
        add = tuple(on(a) for a in t["add"])
        pairs.append((halo_pack.halo_pack(src.clone(), recv, *add, mode="add"),
                      halo_pack.halo_pack_plain(src.clone(), recv, *add, mode="add")))
    torch.cuda.synchronize()
    for got, ref in pairs:
        scale = max(float(ref.abs().max()), 1e-30)
        assert float((got - ref).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_distributed_engines_on_card_match_single_device(cuda, tmp_path):
    """One NCCL rank on the card: both distributed engines, both exchanges,
    float64, against the single-device engines on the card (1e-12)."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch import parallel

    mf = mt.MatrixFree(mt.create_quadrant(3, 3), 4)
    u = np.random.default_rng(0).standard_normal(mf.n_dofs)
    ref_i = mt.LaplaceOperator(mf, device=cuda).vmult(u).cpu().numpy()
    mm = mt.BrickLaplaceMM(mf, device=cuda, face_planes=False)
    ref_b = mm.to_dof_vector(mm.vmult(mm.from_dof_vector(u)), zero_hanging=True).cpu().numpy()
    dist = one_rank_group(tmp_path)
    try:
        for ex in ("allgather", "halo"):
            op = parallel.DistributedLaplace(mf, exchange=ex, device=cuda)
            got = op.gather_vector(op.vmult(op.scatter_vector(u)))
            assert np.abs(got - ref_i).max() <= 1e-12 * np.abs(ref_i).max()
        for ex in ("halo", "replicated"):
            op = parallel.DistributedBrickLaplace(mf, exchange=ex, device=cuda)
            got = op.to_dof_vector(op.vmult(op.from_dof_vector(u)), zero_hanging=True)
            assert np.abs(got - ref_b).max() <= 1e-12 * np.abs(ref_b).max()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("dim,p,nref", [(3, 1, 4), (3, 2, 3), (3, 3, 3), (2, 1, 5), (2, 2, 4),
                                        (2, 3, 4)])
def test_distributed_brick_low_degree_on_card(cuda, tmp_path, dim, p, nref):
    """cell_apply's instances at p <= 3 (the distributed brick step's
    subset rows) against their plain version in f32 and f64, and one NCCL
    rank's DistributedBrickLaplace (both exchanges, float64) against the
    single-device engine on the card (1e-12)."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch import parallel
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import cell_apply

    mf = mt.MatrixFree(mt.create_quadrant(dim, nref), p)
    for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        op = mt.BrickLaplaceMM(mf, device=cuda, dtype=dt, face_planes=False, assembled=False)
        g = torch.Generator(device=cuda).manual_seed(p)
        u = torch.randn(op.n_sub, op.N3p, generator=g, device=cuda, dtype=dt)
        got = cell_apply.cell_apply(u, *op.factors_host, op.geo_cell_sub, brick_size=op.B)
        ref = cell_apply.cell_apply_plain(u, op.K1, op.M1, op.geo_cell_sub, op.B)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max() / ref.abs().max()) < tol
    u = np.random.default_rng(p).standard_normal(mf.n_dofs)
    mm = mt.BrickLaplaceMM(mf, device=cuda, face_planes=False)
    ref = mm.to_dof_vector(mm.vmult(mm.from_dof_vector(u)), zero_hanging=True).cpu().numpy()
    dist = one_rank_group(tmp_path)
    try:
        for ex in ("halo", "replicated"):
            op = parallel.DistributedBrickLaplace(mf, exchange=ex, device=cuda)
            got = op.to_dof_vector(op.vmult(op.from_dof_vector(u)), zero_hanging=True)
            assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    finally:
        dist.destroy_process_group()
