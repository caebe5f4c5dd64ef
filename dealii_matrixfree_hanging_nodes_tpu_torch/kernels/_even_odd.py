"""The even-odd tables of the 1-D factors that ``cell_elasticity``,
``cell_laplace`` and ``brick_deformed`` take as their launch parameters
(``csrc/even_odd.cuh`` holds the sweeps that read them).

On the symmetric Gauss points and nodes, S (the values of the nodal basis
at the Gauss points) and D = Dc S (their derivatives there) satisfy
S[n-1-i, n-1-j] = S[i, j] and D[n-1-i, n-1-j] = -D[i, j], and their
transposes alike; a sweep then takes the sums and differences of the
mirrored inputs and about half the products."""

from __future__ import annotations

import numpy as np

SIGNS = (1, -1, 1, -1)  # S, D = Dc S, S^T, D^T: M[n-1-i, n-1-j] = sign M[i, j]


def even_odd(M, sign: int):
    """(A, B, C) of a 1-D factor M [n, n] (float64 NumPy) with M[n-1-i,
    n-1-j] = sign M[i, j], the kernels' even-odd split: for rows i <
    (n+1)//2 and columns j < n//2, A = (M[i, j] + M[i, n-1-j]) / 2, B =
    (M[i, j] - M[i, n-1-j]) / 2, and C[i] = M[i, n//2] (odd n; zero for
    even n). Raises where M lacks the mirror symmetry (beyond 1e-12 of its
    largest entry)."""
    M = np.asarray(M, dtype=np.float64)
    n = M.shape[0]
    h, hh = n // 2, (n + 1) // 2
    if np.abs(M - sign * M[::-1, ::-1]).max() > 1e-12 * max(np.abs(M).max(), 1e-300):
        raise ValueError(f"even_odd: a factor lacks the mirror symmetry of sign {sign}")
    mirror = M[:hh, ::-1][:, :h]  # M[i, n-1-j]
    C = M[:hh, h].copy() if n % 2 else np.zeros(hh)
    return (M[:hh, :h] + mirror) / 2, (M[:hh, :h] - mirror) / 2, C


def factor_tables(S, Dc):
    """A kernel's factors as its launch parameters (the wrappers'
    ``factors``): float64 [4 F] of S, D = Dc S (the derivatives of the
    nodal basis at the Gauss points) and their transposes, each its
    even-odd split A, B, C (``even_odd``), F = 2 ((n+1)//2) (n//2) +
    (n+1)//2 values. S and Dc: float64 arrays [n, n] (the shape info's)."""
    S, Dc = np.asarray(S, dtype=np.float64), np.asarray(Dc, dtype=np.float64)
    D = Dc @ S
    out = [x.ravel() for M, sign in zip((S, D, S.T, D.T), SIGNS) for x in even_odd(M, sign)]
    return np.ascontiguousarray(np.concatenate(out))


def factor_size(n: int) -> int:
    """F, the values of one factor's even-odd split (``factor_tables``)."""
    return 2 * ((n + 1) // 2) * (n // 2) + (n + 1) // 2


def check_factors(name: str, factors, n: int) -> None:
    """Raise unless factors is ``factor_tables`` of n x n factors: a
    C-contiguous float64 NumPy array of 4 F values."""
    if (not isinstance(factors, np.ndarray) or factors.dtype != np.float64
            or factors.shape != (4 * factor_size(n),) or not factors.flags.c_contiguous):
        raise ValueError(f"{name}: the kernel takes factors=factor_tables(S, Dc), float64 "
                         f"[{4 * factor_size(n)}]")
