"""PyTorch / CUDA port of ``dealii_matrixfree_hanging_nodes_tpu``: the
matrix-free Laplace operator with in-operator hanging-node constraints, for
NVIDIA Hopper (H100), in two engines:

- the brick engine (``BrickLaplaceMM``): the constrained Cartesian 3-D vmult,
  vmult_plain and refill on the brick layout at every degree, on nine
  hand-written CUDA kernels;
- the index engine (``MatrixFree``'s cell loop with ``LaplaceOperator``), in
  3-D and 2-D: a DoF map per cell, the hanging-node runners (compact, all,
  sorted, matrix), the slow constraint path and the deformed mapping, on
  four (``hn_interp``, ``cell_laplace``, ``dof_scatter``,
  ``constraints_slow``; 2-D instances of the first three);
- the solvers on both engines (``models.multigrid``: CG, Chebyshev, the
  global-coarsening GMG V-cycle on the index engine, 3-D and 2-D; ``models.
  multigrid_bricks``: the same on brick vectors, with a GMG-preconditioned
  CG whose vectors stay on the device), on three more for the transfers and
  the DoF embedding (``cell_transfer``, ``brick_transfer``, ``dof_embed``);
- linear elasticity on both engines (``ElasticityOperator`` on the index
  engine, 3-D and 2-D, ``BrickElasticity`` on brick vectors [3, n_bricks,
  N3p]), on two
  more (``cell_elasticity``, ``brick_elasticity``), hn_cell's elastic mode
  and a component axis on dof_scatter (2 or 3 components), corr_compact and
  dss_surface; the brick engine, its GMG and its elasticity in 3-D and 2-D.
- the distributed engines (``parallel``: ``DistributedLaplace``,
  ``DistributedBrickLaplace``, the distributed GMG) on ``torch.distributed``,
  one process a rank, on three more (``halo_pack``, ``dss_pools``,
  ``chain_halo``) around the backend's collectives.

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
    gmg = mt.BrickGMGPreconditioner("quadrant", 3, 6, 4, dtype="float32")
    x, iters, res = gmg.make_device_solver(tol=1e-5)(b)   # b a brick vector
"""

import torch

# the port computes in exact float32 / float64: no TF32 products
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .bricks import BrickLaplaceMM, BrickStructure  # noqa: E402
from .elements import ShapeInfo, shape_info  # noqa: E402
from .matrix_free import MatrixFree  # noqa: E402
from .models.elasticity import ElasticityOperator  # noqa: E402
from .models.elasticity_bricks import BrickElasticity  # noqa: E402
from .models.laplace import LaplaceOperator, laplace_cell_kernel  # noqa: E402
from .models.multigrid import (  # noqa: E402
    ChebyshevSmoother,
    DirichletLaplace,
    GMGPreconditioner,
    Transfer,
    solve_cg,
)
from .models.multigrid_bricks import (  # noqa: E402
    BrickChebyshev,
    BrickDirichletLaplace,
    BrickGMGPreconditioner,
    BrickTransfer,
    DofEmbed,
)
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
    "BrickChebyshev",
    "BrickDirichletLaplace",
    "BrickElasticity",
    "BrickGMGPreconditioner",
    "BrickLaplaceMM",
    "BrickStructure",
    "BrickTransfer",
    "ChebyshevSmoother",
    "DirichletLaplace",
    "DofEmbed",
    "ElasticityOperator",
    "GMGPreconditioner",
    "LaplaceOperator",
    "Transfer",
    "solve_cg",
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
