"""PyTorch / CUDA port of ``dealii_matrixfree_hanging_nodes_tpu``: the
matrix-free degree >= 4 Laplace vmult with in-operator hanging-node
constraints on the brick layout, for NVIDIA Hopper (H100).

The host setup (mesh, DoFs, constraints, brick tables) is NumPy; the
operator is a ``torch.nn.Module`` whose device work runs in four
hand-written CUDA kernels (``kernels/``, sources in ``csrc/``). Entry points
run on the card unless the caller passes ``device="cpu"``, where every
kernel takes its plain PyTorch version.

Quick start::

    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    tria = mt.create_quadrant(3, 7)
    mf = mt.MatrixFree(tria, 4, dtype="float32")
    op = mt.BrickLaplaceMM(mf)              # on the card
    v = op.vmult(op.from_dof_vector(u))
"""

import torch

# the port computes in exact float32 / float64: no TF32 products
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .bricks import BrickLaplaceMM, BrickStructure  # noqa: E402
from .elements import ShapeInfo, shape_info  # noqa: E402
from .matrix_free import MatrixFree  # noqa: E402
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
    "MatrixFree",
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
