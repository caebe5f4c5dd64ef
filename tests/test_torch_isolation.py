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
    if torch.cuda.is_available():
        assert mt.BrickLaplaceMM(mf).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            mt.BrickLaplaceMM(mf)
    assert mt.BrickLaplaceMM(mf, device="cpu").device.type == "cpu"


def test_unported_branches_raise():
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    with pytest.raises(NotImplementedError):
        mt.BrickLaplaceMM(mt.MatrixFree(mt.create_quadrant(3, 2), 3), device="cpu")
    with pytest.raises(NotImplementedError):
        mt.BrickLaplaceMM(mt.MatrixFree(mt.create_quadrant(2, 2), 4), device="cpu")


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
        brick_apply, cell_apply, cols_overlap_add, dss_surface,
    )

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    mf = mt.MatrixFree(mt.create_quadrant(3, 4), 4)
    op = mt.BrickLaplaceMM(mf, device=cuda, dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    bv = torch.randn(op.n_bricks, op.N3p, generator=g, device=cuda, dtype=dtype)
    cols = torch.randn(op.n_sub * op.C, op.n_loc, generator=g, device=cuda, dtype=dtype)
    rows = torch.randn(op.n_hn, op.n_loc, generator=g, device=cuda, dtype=dtype)
    dss = (op.face_other, op.edge_contrib, op.corner_contrib, op.node_valid, op.NB)
    pairs = [
        (brick_apply.brick_apply(bv, op.Kb, op.Mb, op.geo, op.p),
         brick_apply.brick_apply_plain(bv, op.Kb, op.Mb, op.geo)),
        (cell_apply.cell_apply(bv[: op.n_sub], op.K, op.geo_cell_sub, brick_size=op.B),
         cell_apply.cell_apply_plain(bv[: op.n_sub], op.K, op.geo_cell_sub, op.B)),
        (cell_apply.cell_apply(rows, op.K, op.geo_hn),
         cell_apply.cell_apply_plain(rows, op.K, op.geo_hn)),
        (cols_overlap_add.cols_overlap_add(bv[: op.n_sub].clone(), cols, op.B),
         cols_overlap_add.cols_overlap_add_plain(bv[: op.n_sub].clone(), cols, op.B)),
        (dss_surface.dss_surface(bv, *dss), dss_surface.dss_surface_plain(bv, *dss)),
    ]
    torch.cuda.synchronize()
    for got, ref in pairs:
        assert float((got - ref).abs().max() / ref.abs().max()) < tol


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
