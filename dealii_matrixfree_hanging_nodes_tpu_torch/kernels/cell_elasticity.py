"""Kernel 17, ``cell_elasticity``: linear elasticity's cell operator,
a(u, v) = int 2 mu eps(u):eps(v) + lam div u div v on cube cells, one launch
to component-major cell rows [dim, n_cells, n_loc], in one of two modes:

- index (``dofmap`` given, ``brick_size=None``), 3-D or 2-D: each cell's dim
  components read through the DoF map from a global vector [n_dofs, dim]
  (DoF-major, the reference's layout; its component count is the dimension,
  checked against n_loc = (p+1)^dim), the hanging-node interpolation of
  each by the cell's mask (codes None: none), the coupled operator with the
  cell's geo [n_cells, dim], the transposed interpolation. The scatter-add
  is ``dof_scatter``'s (its component axis writes [n_dofs, dim] back);
- bricks (``dofmap=None``, ``brick_size=B``), 3-D or 2-D: cell r of the
  first m bricks of component brick vectors src [dim, nb, N3p] (slot r %
  B^dim of brick r // B^dim), scaled by geo [m*B^dim] on every axis: every
  subset cell's geo_c Kel u_c (the reference's ``plain3``); the dimension
  is read from the row width (``_build.brick_dim``) and must equal the
  component count.

The plain version runs the collocation form of the Laplace kernel (values
by S, gradients by Dc, the coupled operator at each Gauss point, the
transposes): on cube cells with p+1 Gauss points it equals the reference's
cell matrix ``el_Kel`` times geo up to rounding. The kernel computes the
same operator with the basis derivatives D = Dc S, a z-column (2-D: a
y-column) of a cell a thread, each sweep even-odd; the even-odd splits of
S, D and their transposes (``factor_tables``, ``even_odd``) travel as the
launch's parameters: the operators build them once and pass them to the
wrapper (``factors=``).

Replaces the reference's elasticity ``kernel`` and ``_vmult``'s reads and
HN^T (models/elasticity.py:44-98) and BrickElasticity's subset gather with
the ``el_Kel`` einsum (models/elasticity_bricks.py:229-240, in 2-D on its
[2, 2, n^2, n^2] blocks). CUDA source: ``csrc/cell_elasticity.cu`` (the
point operator in ``csrc/elasticity.cuh``)."""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._even_odd import SIGNS, check_factors, even_odd, factor_size, factor_tables  # noqa: F401
from ..ops.sum_factorization import evaluate_gradients, integrate_gradients
from .cell_apply import cell_nodes
from .cell_laplace import hn_rows
from .hn_interp import masked_lines

NAME = "cell_elasticity"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/models/elasticity.py:44"
DEGREES = (1, 2, 3, 4, 5, 6, 7, 8)
DEGREES_2D = (1, 2, 3, 4, 5, 6)  # the dim=2 instances (both modes)


def elastic_rows(u, S, Dc, quad_w, geo, mu, lam):
    """The coupled operator on component-major rows u [dim, cells, n_loc]
    (the reference's ``kernel``; dim components in dim dimensions): geo
    [cells, dim] per axis. A new [dim, cells, n_loc] tensor."""
    dim = u.shape[0]
    g = [evaluate_gradients(u[c], S, Dc, dim) for c in range(dim)]  # [cells, dim, nq] each
    w = quad_w[None, :]
    out = [[mu * (g[c][:, a] + g[a][:, c]) * geo[:, a, None] * w for a in range(dim)]
           for c in range(dim)]
    div = sum(g[c][:, c] for c in range(dim))
    for c in range(dim):
        out[c][c] = out[c][c] + lam * div * geo[:, c, None] * w
    return torch.stack([integrate_gradients(torch.stack(out[c], dim=1), S, Dc, dim)
                        for c in range(dim)])


def brick_rows(src, brick_size, m, p):
    """[k, m*B^dim, n_loc]: the cell rows of the first m bricks of each of
    the k components of src [k, nb, N3p] (dim read from the row width)."""
    dim = _build.brick_dim(NAME, brick_size * p + 1, src.shape[2])
    idx = cell_nodes(torch.arange(m * brick_size**dim, device=src.device), brick_size, p,
                     src.shape[2], src.device)
    return src[:, :m].reshape(src.shape[0], -1)[:, idx]


def cell_elasticity_plain(src, dofmap, codes, P, S, Dc, quad_w, geo, mu, lam, *,
                          brick_size=None, factors=None):
    """Plain PyTorch version: the steps one after another (a new tensor);
    it reads S and Dc, and takes the kernel's factors only to share the
    wrapper's signature."""
    S, Dc = (t.to(src.device, src.dtype) for t in (S, Dc))
    n = S.shape[-1]
    if dofmap is None:
        dim = src.shape[0]
        m = geo.shape[0] // brick_size**dim
        u = brick_rows(src, brick_size, m, n - 1)
        geo = geo[:, None].expand(-1, dim)
    else:
        u = src.T[:, dofmap.long()]
    dim = u.shape[0]
    if codes is not None:
        u = torch.stack([hn_rows(u[c], codes, P, False, dim) for c in range(dim)])
    u = elastic_rows(u, S, Dc, quad_w, geo, mu, lam)
    if codes is not None:
        u = torch.stack([hn_rows(u[c], codes, P, True, dim) for c in range(dim)])
    return u


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_longlong] \
    + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2


def cell_elasticity(src, dofmap, codes, P, S, Dc, quad_w, geo, mu, lam, *, brick_size=None,
                    factors=None):
    """Index mode: src [n_dofs, dim] (dim 2 or 3), dofmap int32 [n_cells,
    n^dim], codes int32 [n_cells] or None, P [2, n, n], geo [n_cells, dim].
    Bricks mode: src [dim, nb, N3p] (dim 3 or 2, the rows' dimension),
    dofmap and codes None (P may be None), geo [m*B^dim] with m <= nb.
    quad_w [n^dim] of src's dtype on its device; S, Dc [n, n] (the plain
    version's; the kernel reads only their shape). factors: the kernel's
    launch parameters, ``factor_tables(S, Dc)`` (float64 NumPy), required
    on the kernel path -> new [dim, n_cells, n^dim]."""
    args = (src, dofmap, codes, P, S, Dc, quad_w, geo, mu, lam)
    if src.device.type == "cpu":
        return cell_elasticity_plain(*args, brick_size=brick_size)
    names = ("src", "dofmap", "codes", "P", "quad_w", "geo")
    dev = _build.check_cuda(NAME, src.dtype, **{k: t for k, t in zip(
        names, (src, dofmap, codes, P, quad_w, geo)) if t is not None})
    if any(t is not None and t.dtype != torch.int32 for t in (dofmap, codes)):
        raise TypeError(f"{NAME}: dofmap and codes must be int32")
    n = S.shape[-1]
    dim = src.shape[0] if dofmap is None else src.shape[-1]  # a component an axis
    n_loc = n**dim
    if dim not in _build.DIMS:
        raise ValueError(f"{NAME}: src {tuple(src.shape)} has {dim} components, not 2 or 3")
    if dofmap is None:
        B = int(brick_size)
        n_cells = geo.shape[0]
        bad = (codes is not None or src.dim() != 3 or geo.dim() != 1
               or _build.brick_dim(NAME, B * (n - 1) + 1, src.shape[2]) != dim
               or n_cells % B**dim or n_cells // B**dim > src.shape[1])
    else:
        n_cells = dofmap.shape[0]
        bad = (brick_size is not None or src.dim() != 2
               or dofmap.shape != (n_cells, n_loc) or geo.shape != (n_cells, dim)
               or (codes is not None and (codes.shape != (n_cells,) or P is None
                                          or P.shape != (2, n, n))))
    check_factors(NAME, factors, n)
    if (bad or n - 1 not in (DEGREES if dim == 3 else DEGREES_2D) or S.shape != (n, n)
            or Dc.shape != (n, n) or quad_w.shape != (n_loc,)
            or dim * n_cells * n_loc >= 2**31):
        raise ValueError(f"{NAME}: shapes src {tuple(src.shape)}, dofmap "
                         f"{None if dofmap is None else tuple(dofmap.shape)}, geo "
                         f"{tuple(geo.shape)}, S {tuple(S.shape)}, brick_size {brick_size}")
    out = torch.empty((dim, n_cells, n_loc), dtype=src.dtype, device=src.device)
    if n_cells == 0:
        return out
    # bricks mode: the component bricks' row length and the values between components
    N3p, cstride = (src.shape[2], src.shape[1] * src.shape[2]) if dofmap is None else (0, 0)
    ptrs = (ctypes.c_void_p * 7)(*(None if t is None else t.data_ptr()
                                   for t in (src, dofmap, codes, P, quad_w, geo, out)))
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(src.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, ptrs, factors.ctypes.data_as(ctypes.c_void_p), float(mu),
                  float(lam), cstride, int(brick_size or 0), N3p, n_cells, n - 1, dim, None)
    cell_elasticity.launches += 1
    return out


cell_elasticity.launches = 0


def plan(dtype, p, device=None, dim=3):
    """(threads, shared-memory bytes, blocks per SM) of a launch at degree
    p in dim dimensions; launches nothing."""
    info = (ctypes.c_int * 3)()
    dev = torch.device("cuda") if device is None else device
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, (ctypes.c_void_p * 7)(), None, 1.0, 1.0, 0, 0, 0, 1, p, dim,
                  info)
    return tuple(info)


# the kernel's sweeps of a line and component by the factor's mirror sign (+1: S, S^T; -1: D,
# D^T), 16 in 3-D and 8 in 2-D, and the pairs of lines it adds (T1, the result)
SWEEPS = {3: {1: 10, -1: 6}, 2: {1: 4, -1: 4}}
LINE_ADDS = {3: 2, 2: 1}


def sweep_flops(n: int, sign: int) -> int:
    """Operations of one even-odd sweep of a line of n values as the kernel
    runs it: the n//2 mirrored sums and differences (2 h), for each of the
    h outer row pairs the even and odd products and their sum and difference
    (4 h, 2 more with a middle column), and the middle row of odd n (2 h + 1
    even, 2 h - 1 odd)."""
    h, odd = n // 2, n % 2
    return 2 * h + h * (4 * h + 2 * odd) + odd * (2 * h + (1 if sign > 0 else -1))


def bytes_and_flops(src, dofmap, codes, P, S, Dc, quad_w, geo, mu, lam, *, brick_size=None):
    """Least traffic: the distinct source values read once (the DoFs that
    dofmap names, dim components each, or the subset cell's brick nodes),
    dofmap, codes and geo read once, the rows written once, the factors S,
    Dc and P read once (the function's inputs; not the kernel's even-odd
    tables). Operations, the least of the kernels that compute the
    operator (this one's, since hn_cell's elastic mode runs 12 whole sweeps
    where this one runs 16 even-odd ones): per cell and component the
    kernel's sweeps of its n^(dim-1) lines (``SWEEPS``, ``sweep_flops``) and
    their line additions, the coupled operator's ~40 a point in 3-D (~16 in
    2-D), and the interpolation's 2 n^2 a masked line, component and
    direction."""
    n = S.shape[-1]
    dim = src.shape[0] if dofmap is None else src.shape[-1]
    n_loc, isz = n**dim, src.element_size()
    if dofmap is None:
        n_cells = geo.shape[0]
        nodes = cell_nodes(torch.arange(n_cells, device=src.device), brick_size, n - 1,
                           src.shape[2], src.device)
        n_src = dim * int(torch.unique(nodes).numel())
    else:
        n_cells = dofmap.shape[0]
        n_src = dim * int(torch.unique(dofmap).numel())
    nbytes = (n_src + dim * n_cells * n_loc + 4 * n * n + n_loc + geo.numel()) * isz
    nbytes += 4 * (0 if dofmap is None else dofmap.numel())
    per_line = (sum(sweep_flops(n, sign) * k for sign, k in SWEEPS[dim].items())
                + LINE_ADDS[dim] * n)
    flops = n_cells * (dim * n ** (dim - 1) * per_line + (40 if dim == 3 else 16) * n_loc)
    if codes is not None:
        nbytes += 4 * n_cells
        per_dir = dim * 2 * n * n * int(masked_lines(codes.cpu().numpy(), n - 1, dim).sum())
        flops += 2 * per_dir
    return nbytes, flops
