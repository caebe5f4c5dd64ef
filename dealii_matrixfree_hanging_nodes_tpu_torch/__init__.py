"""PyTorch / CUDA port of ``dealii_matrixfree_hanging_nodes_tpu``: the
matrix-free Laplace operator with in-operator hanging-node constraints, for
NVIDIA Hopper (H100), in two engines:

- the brick engine (``BrickLaplaceMM``): the constrained Cartesian 3-D vmult,
  vmult_plain and refill on the brick layout at every degree, on nine
  hand-written CUDA kernels;
- the index engine (``MatrixFree``'s cell loop with ``LaplaceOperator``): a
  DoF map per cell, the hanging-node runners (compact, all, sorted,
  matrix), the slow constraint path and the deformed mapping, on four
  (``hn_interp``, ``cell_laplace``, ``dof_scatter``, ``constraints_slow``).

The host setup (mesh, DoFs, constraints, tables) is NumPy; the operators
are ``torch.nn.Module``s whose device work runs in the kernels
(``kernels/``, sources in ``csrc/``). Entry points run on the card unless
the caller passes ``device="cpu"``, where every kernel takes its plain
PyTorch version.

Quick start::

    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    tria = mt.create_quadrant(3, 7)
    mf = mt.MatrixFree(tria, 4, dtype="float32")
    op = mt.BrickLaplaceMM(mf)              # on the card
    v = op.vmult(op.from_dof_vector(u))
    lap = mt.LaplaceOperator(mf)            # the index engine, on the card
    w = lap.vmult(u)                        # a global DoF vector
"""

import torch

# the port computes in exact float32 / float64: no TF32 products
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .bricks import BrickLaplaceMM, BrickStructure  # noqa: E402
from .elements import ShapeInfo, shape_info  # noqa: E402
from .matrix_free import MatrixFree  # noqa: E402
from .models.laplace import LaplaceOperator, laplace_cell_kernel  # noqa: E402
from .ops.hanging_nodes import apply_hanging_node_constraints  # noqa: E402
from .mesh import (  # noqa: E402
    Triangulation,
    create_annulus,
    create_geometry,
    create_quadrant,
    create_quadrant_flexible,
    create_step,
    create_uniform,
)

__all__ = [
    "BrickLaplaceMM",
    "BrickStructure",
    "LaplaceOperator",
    "MatrixFree",
    "apply_hanging_node_constraints",
    "laplace_cell_kernel",
    "ShapeInfo",
    "shape_info",
    "Triangulation",
    "create_annulus",
    "create_geometry",
    "create_quadrant",
    "create_quadrant_flexible",
    "create_step",
    "create_uniform",
]
