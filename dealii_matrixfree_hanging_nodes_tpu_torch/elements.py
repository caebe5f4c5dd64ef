"""1D element data for FE_Q(p) tensor-product elements (capability C11).
Copy of ``dealii_matrixfree_hanging_nodes_tpu.elements``.

Everything sum factorization and the hanging-node kernels need from the
element is a handful of 1D tables (the reference consumes these via deal.II's
ShapeInfo; cf. benchmark_00_likwid.cc:24-48 which builds kernels from
(FE, quadrature) alone):

- ``nodes``      : Gauss-Lobatto support points of FE_Q(p) on [0, 1]
- ``quad_x/w``   : (p+1)-point Gauss quadrature on [0, 1]
- ``S``  [q, i]  : shape value  N_i(x_q)
- ``D``  [q, i]  : shape grad   N_i'(x_q)
- ``Dc`` [q, q'] : collocation derivative on the quadrature-point Lagrange
                   basis (for the collocation-gradient evaluation path)
- ``P0/P1`` [i,j]: subface embedding matrices N_j((x_i + s)/2), s in {0, 1} —
                   the only matrices the hanging-node interpolation needs.

All tables are computed in float64 NumPy at setup time and cast to the
compute dtype when staged to device.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "gauss_points",
    "gauss_lobatto_points",
    "lagrange_values",
    "lagrange_derivatives",
    "ShapeInfo",
    "shape_info",
]


def gauss_points(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule mapped to [0, 1]; returns (points, weights)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_lobatto_points(n: int) -> np.ndarray:
    """n Gauss-Lobatto points on [0, 1] (includes both endpoints), n >= 2."""
    if n < 2:
        raise ValueError("Gauss-Lobatto needs at least 2 points")
    if n == 2:
        return np.array([0.0, 1.0])
    # Interior points are roots of P'_{n-1}.
    legendre_coeffs = np.zeros(n)
    legendre_coeffs[n - 1] = 1.0
    deriv = np.polynomial.legendre.Legendre(legendre_coeffs).deriv()
    interior = deriv.roots()
    x = np.concatenate([[-1.0], np.sort(interior.real), [1.0]])
    return 0.5 * (x + 1.0)


def lagrange_values(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Values of the Lagrange basis on ``nodes`` at points ``x``: [len(x), len(nodes)]."""
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = len(nodes)
    out = np.ones((len(x), n))
    for j in range(n):
        for k in range(n):
            if k != j:
                out[:, j] *= (x - nodes[k]) / (nodes[j] - nodes[k])
    return out


def lagrange_derivatives(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """First derivatives of the Lagrange basis at points ``x``: [len(x), len(nodes)]."""
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = len(nodes)
    out = np.zeros((len(x), n))
    for j in range(n):
        denom = 1.0
        for k in range(n):
            if k != j:
                denom *= nodes[j] - nodes[k]
        for m in range(n):
            if m == j:
                continue
            term = np.ones(len(x))
            for k in range(n):
                if k != j and k != m:
                    term *= x - nodes[k]
            out[:, j] += term
        out[:, j] /= denom
    return out


class ShapeInfo:
    """1D shape tables for FE_Q(degree) with (degree+1)-point Gauss quadrature.

    Analog of the shape data consumed by the reference's
    FEEvaluation / FEEvaluationHangingNodesFactory (benchmark_00_likwid.cc:56-59).
    """

    def __init__(self, degree: int):
        if degree < 1:
            raise ValueError("degree must be >= 1")
        self.degree = degree
        self.n_1d = degree + 1
        self.nodes = gauss_lobatto_points(degree + 1)
        self.quad_x, self.quad_w = gauss_points(degree + 1)
        # value/gradient tables at quadrature points
        self.S = lagrange_values(self.nodes, self.quad_x)
        self.D = lagrange_derivatives(self.nodes, self.quad_x)
        # collocation derivative: Lagrange basis on the quadrature points
        self.Dc = lagrange_derivatives(self.quad_x, self.quad_x)
        # subface embedding matrices: coarse basis evaluated at the two
        # half-interval images of the nodes; P[s][i, j] = N_j((x_i + s) / 2)
        self.P = np.stack(
            [
                lagrange_values(self.nodes, (self.nodes + s) / 2.0)
                for s in (0, 1)
            ]
        )

    def n_dofs_per_cell(self, dim: int) -> int:
        return self.n_1d**dim

    def n_q_points(self, dim: int) -> int:
        return self.n_1d**dim

    def quad_weights_tensor(self, dim: int) -> np.ndarray:
        """Tensor-product quadrature weights, flattened lexicographically (x fastest)."""
        w = self.quad_w
        out = w
        for _ in range(dim - 1):
            out = np.multiply.outer(w, out)  # new axis is slower-varying
        return out.reshape(-1)


@functools.lru_cache(maxsize=None)
def shape_info(degree: int) -> ShapeInfo:
    return ShapeInfo(degree)
