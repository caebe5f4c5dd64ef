"""The distributed engines of the port on ``torch.distributed`` (one
process a rank; NCCL on the card, gloo on the CPU): the host partition
(``partition``), the collectives (``comm``), the index engine's
``DistributedLaplace``, the brick engine's ``DistributedBrickLaplace`` and
the distributed GMG (``multigrid_distributed``)."""

from .bricks_distributed import DistributedBrickLaplace, DistributedBrickPlan  # noqa: F401
from .distributed import DistributedLaplace, DistributedLaplacePlan  # noqa: F401
from .multigrid_distributed import (  # noqa: F401
    DistributedDirichletLaplace,
    DistributedGMGPreconditioner,
    DistributedTransfer,
)
