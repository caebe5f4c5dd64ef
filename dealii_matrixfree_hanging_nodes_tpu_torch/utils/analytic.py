"""Analytic functions and their nodal interpolation (NumPy), a copy of
``dealii_matrixfree_hanging_nodes_tpu.utils.analytic``.

The reference initializes benchmark_03's source vector by interpolating
f(x) = sum_d sin(x_d) at the DoF support points (AnalyticalFunction,
benchmark_03.h:362-378); the GMG solve's manufactured solution is the same
function, zeroed on the boundary."""

from __future__ import annotations

import numpy as np

__all__ = ["sum_of_sines", "interpolate"]


def sum_of_sines(points: np.ndarray) -> np.ndarray:
    """f(x) = sum_d sin(x_d)  (benchmark_03.h:366-371)."""
    return np.sin(points).sum(axis=-1)


# the separable form that DoFHandler.interpolate_values evaluates per axis
sum_of_sines.axis_fn = np.sin


def interpolate(dof_handler, fn=sum_of_sines) -> np.ndarray:
    """Nodal interpolation into a DoF vector (VectorTools::interpolate)."""
    return dof_handler.interpolate_values(fn)
