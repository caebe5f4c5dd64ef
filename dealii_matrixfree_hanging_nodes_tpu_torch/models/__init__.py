"""Operators and solvers of the port: the index engine's Laplace
(``laplace``) and elasticity (``elasticity``), the brick engine's elasticity
(``elasticity_bricks``), CG, Chebyshev and GMG on the index engine
(``multigrid``) and on the brick engine (``multigrid_bricks``)."""
