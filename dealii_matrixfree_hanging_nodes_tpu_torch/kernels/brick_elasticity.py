"""Kernel 18, ``brick_elasticity``: linear elasticity's coupled brick
operator times the brick's geometry factor on component brick vectors
[dim, nb, N3p] (component-major, x fastest, padded tail zero; dim = 3, or
2 on 2-D bricks of NB^2 nodes),

    v_c = geo sum_k A_ck u_k,
    A_ck = mu [c == k] sum_a D_a^T W D_a + mu D_k^T W D_c + lam D_c^T W D_k,

each block a short sum of Kronecker products of the brick-assembled 1-D
factors Kb, Mb, Gb = D^T W S and Gb^T (the reference's ``terms``,
models/elasticity_bricks.py:124-130), with, on the first m bricks, the
overlap-add of each component's cell rows ``dcols`` [dim, m*B^dim,
(p+1)^dim] as an epilogue (as ``brick_apply``'s). The dimension is the
component count, checked against the row width (``_build.brick_dim``).

Replaces ``BrickElasticity._main_apply`` (models/elasticity_bricks.py:
184-213, the dense plane operators on the MXU; in 2-D one dense [NB^2,
NB^2] el_A{c}{k} a block, 205-213) times ``geo`` and the subset's
``_scatter_cols`` / ``_subset_scatter_add_multi`` (250-254).
CUDA source: ``csrc/brick_elasticity.cu``. On the kernel path the wrapper
takes the 1-D cell factors K1, M1, G1, G1^T that the brick factors are
assembled from (``cell_factor_tables``, a host tensor the operator builds
once) as the launch's parameters, and the kernels sweep a brick factor's
rows as its cells' blocks; the plain version takes the brick factors."""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .brick_apply import (
    SUPPORTED, SUPPORTED_2D, factor_structure, overlap_add_index, unpack_factor,
)

NAME = "brick_elasticity"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/models/elasticity_bricks.py:184"
FACTORS = ("K", "M", "G", "GT")  # the packed order


def axis_factors(a_test: int, b_trial: int, dim: int):
    """Per-axis factor names (x, y[, z]) of D_a^T W D_b (the reference's
    ``_axis_factors``)."""
    return ["K" if ax == a_test == b_trial else "G" if ax == a_test else
            "GT" if ax == b_trial else "M" for ax in range(dim)]


def terms(c: int, k: int, mu: float, lam: float, dim: int):
    """The Kronecker terms (coefficient, per-axis factor names) of block
    (c, k) in dim dimensions (the reference's ``terms``)."""
    out = [(mu, axis_factors(ax, ax, dim)) for ax in range(dim)] if c == k else []
    return out + [(mu, axis_factors(k, c, dim)), (lam, axis_factors(c, k, dim))]


def least_schedule(dim: int):
    """(factor applications to every line of a brick, distinct Kronecker
    terms) of the least sum-factorized schedule of the dim^2 blocks. 3-D:
    along x one a distinct (input, x factor), along y one a distinct
    (input, x, y factors), along z one a distinct (output, z factor), the
    terms of an output grouped across its inputs; 12 + 21 + 12 = 45
    applications and 21 terms. The 3-D kernel sweeps each block (c, k) on
    its own (x: 2, y: 2-3, z: 2 applications), 57 a brick, 53 with the x
    sweep of the blocks (1, 2), (2, 1) and the z sweep of (0, 1), (1, 0)
    shared by their two terms. 2-D: along x one a
    distinct (input, x factor), along y one a distinct (output, y factor);
    8 + 8 = 16 applications and 8 terms, the 2-D kernel's."""
    xs, ys, zs, ts = set(), set(), set(), set()
    for c in range(dim):
        for k in range(dim):
            for _, f in terms(c, k, 1.0, 1.0, dim):
                xs.add((k, f[0]))
                if dim == 3:
                    ys.add((k, f[0], f[1]))
                    zs.add((c, f[2]))
                else:
                    ys.add((c, f[1]))
                ts.add((c, k, *f))
    return len(xs) + len(ys) + len(zs), len(ts)


def brick_factors(K1, M1, G1, B: int):
    """{name: [NB, NB]} brick-assembled 1-D factors from the cell ones
    (float64 NumPy): K, M, G and GT = G^T."""
    p = K1.shape[0] - 1
    NB = B * p + 1
    out = {}
    for name, F1 in (("K", K1), ("M", M1), ("G", G1)):
        Fb = np.zeros((NB, NB))
        for c in range(B):
            Fb[c * p: c * p + p + 1, c * p: c * p + p + 1] += F1
        out[name] = Fb
    out["GT"] = out["G"].T.copy()
    return out


def cell_factor_tables(K1, M1, G1) -> torch.Tensor:
    """The kernel's launch parameters: float64 [4, p+1, p+1] host tensor of
    the cell factors K1, M1, G1 and G1^T (``FACTORS`` order) from which
    ``brick_factors`` assembles the brick's."""
    F = [np.asarray(a, dtype=np.float64) for a in (K1, M1, G1)]
    return torch.from_numpy(np.ascontiguousarray(np.stack([*F, F[2].T])))


def pack(factors: dict, p: int) -> np.ndarray:
    """[4, nnz]: the structural nonzeros of K, M, G, GT packed row by row
    (``brick_apply.factor_structure``); checked to hold every nonzero."""
    NB = factors["K"].shape[0]
    rows, cols = factor_structure(NB, p)
    packed = np.stack([factors[n][rows, cols] for n in FACTORS])
    for n, row in zip(FACTORS, packed):
        dense = np.zeros((NB, NB))
        dense[rows, cols] = row
        if not np.array_equal(dense, factors[n]):
            raise ValueError(f"{NAME}: factor {n} has nonzeros outside the brick structure")
    return packed


def brick_elasticity_plain(bv, factors, geo, p, mu, lam, dcols=None, brick_size=None):
    """Plain PyTorch version, term by term: every Kronecker term of each
    block (c, k) as one einsum over the brick's (z, y, x) axes ((y, x) in
    2-D), summed, times geo; then one ``index_add_`` a component of its
    cell rows. factors: {name: dense [NB, NB]} (K, M, G; GT is G's
    transpose), or the packed [4, nnz] (``pack``)."""
    if isinstance(factors, torch.Tensor):
        factors = {n: unpack_factor(factors[i].to(bv.device, bv.dtype), p)
                   for i, n in enumerate(FACTORS[:3])}
    dim, nb, N3p = bv.shape
    NB = factors["K"].shape[0]
    N3 = NB**dim
    fac = dict(factors, GT=factors["G"].T)
    u = bv[:, :, :N3].reshape(dim, nb, *([NB] * dim))
    spec = "Zz,Yy,Xx,bzyx->bZYX" if dim == 3 else "Yy,Xx,byx->bYX"
    outs = []
    for c in range(dim):
        acc = torch.zeros_like(u[0])
        for k in range(dim):
            for coef, f in terms(c, k, mu, lam, dim):
                acc = acc + coef * torch.einsum(spec, *(fac[n] for n in reversed(f)), u[k])
        outs.append(F.pad(acc.reshape(nb, N3) * geo[:, None], (0, N3p - N3)))
    v = torch.stack(outs)
    if dcols is not None:
        B = int(brick_size)
        m = dcols.shape[1] // B**dim
        idx = overlap_add_index(m, B, p, N3p, v.device)
        for c in range(dim):
            v[c].view(-1).index_add_(0, idx, dcols[c].reshape(-1))
    return v


_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_double] * 2 + [ctypes.c_int] * 5
         + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def brick_elasticity(bv, factors, geo, p, mu, lam, dcols=None, brick_size=None):
    """bv [dim, nb, N3p] (dim 3, or 2 on 2-D bricks), geo [nb], dcols [dim,
    m*B^dim, n_loc] or None -> v [dim, nb, N3p]. On the kernel path
    ``factors`` is the host float64 tensor [4, p+1, p+1] of the cell
    factors (``cell_factor_tables``); on CPU tensors the plain version
    takes the brick factors, packed [4, nnz] or dense {K, M, G}."""
    if bv.device.type == "cpu":
        return brick_elasticity_plain(bv, factors, geo, p, mu, lam, dcols, brick_size)
    extra = {} if dcols is None else {"dcols": dcols}
    dev = _build.check_cuda(NAME, bv.dtype, bv=bv, geo=geo, **extra)
    if (not isinstance(factors, torch.Tensor) or factors.device.type != "cpu"
            or factors.dtype != torch.float64 or factors.shape != (4, p + 1, p + 1)
            or not factors.is_contiguous()):
        raise ValueError(f"{NAME}: the kernel takes the cell factors as a float64 host tensor "
                         f"[4, {p + 1}, {p + 1}] (cell_factor_tables)")
    if bv.dim() != 3:
        raise ValueError(f"{NAME}: bv must be [dim, nb, N3p], got {tuple(bv.shape)}")
    dim, nb, N3p = bv.shape
    NB = next((w for w, q in (SUPPORTED if dim == 3 else SUPPORTED_2D) if q == p), None)
    if NB is None:
        raise ValueError(f"{NAME}: no {dim}-D instance at p={p}")
    B = (NB - 1) // p
    if _build.brick_dim(NAME, NB, N3p) != dim or geo.shape != (nb,):
        raise ValueError(f"{NAME}: shapes bv {tuple(bv.shape)}, geo {tuple(geo.shape)}")
    m = 0
    if dcols is not None:
        m, rest = divmod(dcols.shape[1], B**dim)
        if (brick_size is None or int(brick_size) != B or dcols.dim() != 3
                or dcols.shape[0] != dim or dcols.shape[2] != (p + 1) ** dim or rest or m > nb):
            raise ValueError(f"{NAME}: dcols {tuple(dcols.shape)} are no cell rows of B={B} "
                             f"bricks of {tuple(bv.shape)}")
    out = torch.empty_like(bv)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(bv.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(bv), _build.ptr(factors), _build.ptr(geo),
                  None if dcols is None else _build.ptr(dcols), _build.ptr(out), float(mu),
                  float(lam), nb, m, NB, p, N3p, None, dim)
    brick_elasticity.launches += 1
    return out


brick_elasticity.launches = 0


def plan(dtype, p, dim, device=None):
    """(threads, shared-memory bytes, blocks per SM) of a launch at degree
    p in dim dimensions; launches nothing."""
    NB = next(w for w, q in (SUPPORTED if dim == 3 else SUPPORTED_2D) if q == p)
    info = (ctypes.c_int * 3)()
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(dtype)}", _ARGS)
    _build.launch(NAME, fn, torch.device("cuda") if device is None else device, None, None,
                  None, None, None, 1.0, 1.0, 1, 0, NB, p, (NB**dim + 127) // 128 * 128, info,
                  dim)
    return tuple(info)


def bytes_and_flops(nb, NB, p, N3p, itemsize, m=0):
    """Least traffic (read u's dim NB^dim nodes once, write v with its
    padding once, the four cell factors, geo, and the m bricks' cell rows)
    and the operation count of the least sum-factorized schedule
    (``least_schedule``, not the kernel's): each factor application a
    multiply and an add per structural nonzero of every line, a multiply
    and an add per node for each distinct term's coefficient, geo's
    multiply per node and output, one add per cell-row entry. The
    dimension is read from N3p."""
    dim = _build.brick_dim(NAME, NB, N3p)
    nnz = len(factor_structure(NB, p)[0])
    n_rows = dim * m * ((NB - 1) // p) ** dim * (p + 1) ** dim
    nbytes = (dim * nb * NB**dim + dim * nb * N3p + 4 * (p + 1) ** 2 + nb + n_rows) * itemsize
    sweeps, n_terms = least_schedule(dim)
    flops = (sweeps * 2 * nnz * NB ** (dim - 1) + (2 * n_terms + dim) * NB**dim) * nb + n_rows
    return nbytes, flops
