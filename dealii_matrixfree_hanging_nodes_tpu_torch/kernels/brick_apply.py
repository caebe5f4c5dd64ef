"""Kernel 1, ``brick_apply``: the separable brick Laplace times the brick's
geometry factor, v_b = geo_b (Mz⊗(My⊗Kx + Ky⊗Mx) + Kz⊗My⊗Mx) u_b, on every
brick of a [n_bricks, N3p] vector (x fastest, padded tail zero), with, on
the first m bricks, the overlap-add of their cell rows ``dcols`` [m*B^3,
(p+1)^3] as an epilogue: each brick node gains the 1-8 cell entries that
sit on it.

Replaces ``experiments/queue/_mb_main.py:63`` ``pallas_fused``, the Pallas
form of ``BrickLaplaceMM._main_apply`` (bricks.py:2321-2348) times ``geo``
(bricks.py:2367), and in the epilogue ``_scatter_cols`` (bricks.py:
2196-2241) with the merge ``v.at[:n_sub].add(corr)`` (bricks.py:2553-2559).
CUDA source: ``csrc/brick_apply.cu``.

With a right-hand-side axis (``BrickLaplaceMM.vmult_multi``: bv [k, nb,
N3p] with any stride between its RHS, dcols [k, m*B^3, n_loc]) each RHS
goes through the same factors in one launch (grid.y), bit-identical to a
call on it alone (the reference's k-major ``_main_apply`` and
``_subset_scatter_add_multi``, bricks.py:3459-3461, 3513-3515).

2-D bricks (rows of NB^2 nodes, ``BrickLaplaceMM`` on a 2-D mesh): v_b =
geo_b (My⊗Kx + Ky⊗Mx) u_b, the cell rows [m*B^2, (p+1)^2] (the
reference's 2-D branch, bricks.py:2340-2347); the dimension is read from
the row width (``_build.brick_dim``).

The kernel takes the structural nonzeros of Kb and Mb, packed row by row
(``factor_structure``), as launch parameters: on the kernel path they are
host tensors (``BrickLaplaceMM.brick_factors_host``)."""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .cell_apply import brick_slot_index

NAME = "brick_apply"
REPLACES = "experiments/queue/_mb_main.py:63"
# (NB, p) pairs the CUDA kernel is instantiated for, 3-D: B=16, 8, 4 at p=1, 2, 3 and 4,
# B=2 at p=5..8; 2-D: B=16 at p=1..3, B=8 at p=4..6
SUPPORTED = {(17, 1), (17, 2), (13, 3), (17, 4), (11, 5), (13, 6), (15, 7), (17, 8)}
SUPPORTED_2D = {(17, 1), (33, 2), (49, 3), (33, 4), (41, 5), (49, 6)}


def factor_structure(NB: int, p: int):
    """(rows, cols) of the structural nonzeros of a brick factor [NB, NB]
    assembled from cell blocks of degree p, row by row (the packed order):
    a node inside a cell couples with its cell's p+1 nodes, a node on an
    interior cell boundary with both cells', 2p+1."""
    i = np.arange(NB)
    lo = np.where(i == 0, 0, (i - 1) // p * p)
    hi = np.minimum(NB - 1, (i // p + 1) * p)
    rows = np.repeat(i, hi - lo + 1)
    return rows, np.concatenate([np.arange(a, b + 1) for a, b in zip(lo, hi)])


def factor_width(n_packed: int, p: int) -> int:
    """NB of a packed factor: it holds 1 + B p (p+2) values, NB = B p + 1."""
    B, rest = divmod(n_packed - 1, p * (p + 2))
    if rest or B < 1:
        raise ValueError(f"{NAME}: {n_packed} values are no packed factor of degree {p}")
    return B * p + 1


def unpack_factor(packed, p):
    """The dense factor [NB, NB] of a packed one."""
    NB = factor_width(packed.shape[0], p)
    rows, cols = (torch.from_numpy(a) for a in factor_structure(NB, p))
    dense = packed.new_zeros(NB, NB)
    dense[rows.to(packed.device), cols.to(packed.device)] = packed
    return dense


def overlap_add_index(m, B, p, N3p, device=None):
    """Flat index into v [m, N3p] of every entry of cell rows [m*B^dim, n_loc]
    (the dimension read from the row width N3p)."""
    dim = _build.brick_dim(NAME, B * p + 1, N3p)
    idx = brick_slot_index(B, p, device, dim).reshape(-1)
    return (torch.arange(m, device=device)[:, None] * N3p + idx[None, :]).reshape(-1)


def _rows_of(dcols, brick_size, nb, N3p, dim):
    """(m, p) of the cell rows dcols [m*B^dim, (p+1)^dim] of the first m
    bricks of [nb, N3p] brick vectors of dimension dim."""
    if brick_size is None:
        raise ValueError(f"{NAME}: dcols needs brick_size")
    B = int(brick_size)
    p, dc = _build.cell_shape(NAME, dcols.shape[1]) if dcols.dim() == 2 else (0, 0)
    m, rest = divmod(dcols.shape[0], B**dim)
    if dcols.dim() != 2 or dc != dim or rest or m > nb or N3p < (B * p + 1) ** dim:
        raise ValueError(f"{NAME}: dcols {tuple(dcols.shape)} are no cell rows of "
                         f"B={B} bricks of [{nb}, {N3p}] in {dim}-D")
    return m, p


def brick_apply_plain(bv, Kb, Mb, geo, p=None, dcols=None, brick_size=None):
    """Plain PyTorch version, the reference's algebra: the 289x289 xy
    factors Fxy = Mb⊗Kb + Kb⊗Mb and Mxy = Mb⊗Mb, then the z contractions
    (2-D, bricks of NB^2 nodes: the x contractions with Kb and Mb, then the
    y ones, bricks.py:2340-2347); then one ``index_add_`` of dcols into the
    first m bricks. Kb, Mb dense [NB, NB] or packed (then p is needed). A
    RHS axis: each RHS so."""
    if bv.dim() == 3:
        return torch.stack([brick_apply_plain(bv[j], Kb, Mb, geo, p,
                                              None if dcols is None else dcols[j], brick_size)
                            for j in range(bv.shape[0])])
    if Kb.dim() == 1:
        Kb, Mb = unpack_factor(Kb, p), unpack_factor(Mb, p)
    nb, N3p = bv.shape
    NB = Kb.shape[0]
    dim = _build.brick_dim(NAME, NB, N3p)
    N3 = NB**dim
    if dim == 2:
        u2 = bv[:, :N3].reshape(nb, NB, NB)
        t = torch.einsum("wy,byx->bwx", Mb, u2 @ Kb.T)
        s = torch.einsum("wy,byx->bwx", Kb, u2)
        v = F.pad((t + s @ Mb.T).reshape(nb, N3), (0, N3p - N3)) * geo[:, None]
    else:
        u3 = bv[:, :N3].reshape(nb, NB, NB * NB)
        Fxy = torch.kron(Mb, Kb) + torch.kron(Kb, Mb)
        Mxy = torch.kron(Mb, Mb)
        t = torch.einsum("wz,bzr->bwr", Mb, u3 @ Fxy.T)
        s = torch.einsum("wz,bzr->bwr", Kb, u3)
        v = F.pad((t + s @ Mxy.T).reshape(nb, N3), (0, N3p - N3)) * geo[:, None]
    if dcols is not None:
        m, pc = _rows_of(dcols, brick_size, nb, N3p, dim)
        idx = overlap_add_index(m, int(brick_size), pc, N3p, v.device)
        v.view(-1).index_add_(0, idx, dcols.reshape(-1))
    return v


_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong]
         + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def _packed_host(Fp, p, dtype):
    if Fp.device.type != "cpu":
        raise ValueError(f"{NAME}: the kernel takes the packed Kb and Mb as host tensors "
                         f"(op.brick_factors_host), got them on {Fp.device}")
    if Fp.dim() != 1:
        raise ValueError(f"{NAME}: the kernel takes packed factors "
                         f"(op.brick_factors_host), got shape {tuple(Fp.shape)}")
    factor_width(Fp.shape[0], p)
    return Fp.detach().to(dtype).contiguous()


def brick_apply(bv, Kb, Mb, geo, p, dcols=None, brick_size=None):
    """bv [nb, N3p], geo [nb], dcols [m*B^3, n_loc] or None -> new v [nb,
    N3p]; a RHS axis: bv [k, nb, N3p] (any stride between RHS), dcols [k,
    m*B^3, n_loc] -> v [k, nb, N3p]. On the kernel path Kb and Mb are the
    packed host factors (``op.brick_factors_host``); on CPU tensors the
    plain version takes them dense or packed."""
    if bv.device.type == "cpu":
        return brick_apply_plain(bv, Kb, Mb, geo, p, dcols, brick_size)
    k, stride, bv1 = _build.rhs_axis(NAME, bv, 2)
    lead = bv.shape[:-2]
    extra = {}
    if dcols is not None:
        if dcols.shape[:-2] != lead:
            raise ValueError(f"{NAME}: dcols {tuple(dcols.shape)} for bv {tuple(bv.shape)}")
        extra["dcols"] = dcols
    dev = _build.check_cuda(NAME, bv.dtype, bv=bv1, geo=geo, **extra)
    Kp, Mp = (_packed_host(Fp, p, bv.dtype) for Fp in (Kb, Mb))
    nb, N3p = bv1.shape
    NB = factor_width(Kp.shape[0], p)
    dim = _build.brick_dim(NAME, NB, N3p)
    if (NB, p) not in (SUPPORTED if dim == 3 else SUPPORTED_2D) or Mp.shape != Kp.shape:
        raise ValueError(f"{NAME}: unsupported {dim}-D brick width NB={NB} at p={p}")
    if geo.shape != (nb,) or (dim == 2 and N3p % 4):
        raise ValueError(f"{NAME}: shapes bv {tuple(bv.shape)}, geo {tuple(geo.shape)}")
    m = 0
    if dcols is not None:
        m, pc = _rows_of(dcols[0] if lead else dcols, brick_size, nb, N3p, dim)
        if pc != p or int(brick_size) * p + 1 != NB:
            raise ValueError(f"{NAME}: dcols of p={pc}, B={brick_size} for NB={NB}, p={p}")
    out = torch.empty(bv.shape, dtype=bv.dtype, device=bv.device)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(bv.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(bv), _build.ptr(Kp), _build.ptr(Mp),
                  _build.ptr(geo), None if dcols is None else _build.ptr(dcols),
                  _build.ptr(out), nb, m, NB, p, N3p, k, stride, None, dim)
    brick_apply.launches += 1
    return out


brick_apply.launches = 0


def plan(dtype, p, m=0, device=None, dim=3):
    """(shared-memory bytes, blocks per SM) of a launch at degree p with
    m > 0 or m == 0 bricks of cell rows; launches nothing."""
    NB = next(w for w, q in (SUPPORTED if dim == 3 else SUPPORTED_2D) if q == p)
    info = (ctypes.c_int * 2)()
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(dtype)}", _ARGS)
    _build.launch(NAME, fn, torch.device("cuda") if device is None else device, None, None,
                  None, None, None, None, 1, m, NB, p, (NB**dim + 127) // 128 * 128, 1, 0, info,
                  dim)
    return tuple(info)


def bytes_and_flops(nb, NB, p, N3p, itemsize, m=0, k=1):
    """Least traffic (read u's NB^dim nodes once, write v with its padding
    once, the packed factors, geo, and the m bricks' cell rows) and the
    operation count: seven sweeps (four in 2-D), each summing the
    structural nonzeros of one factor per node, the geo scale and one add
    per cell-row entry. k right-hand sides: the vectors and cell rows k
    times, the factors and geo once. The dimension is read from N3p."""
    dim = _build.brick_dim(NAME, NB, N3p)
    nnz = len(factor_structure(NB, p)[0])
    n_rows = m * ((NB - 1) // p) ** dim * (p + 1) ** dim
    sweeps = 7 if dim == 3 else 4
    nbytes = (k * (nb * NB**dim + nb * N3p + n_rows) + 2 * nnz + nb) * itemsize
    flops = k * ((sweeps * 2 * nnz * NB ** (dim - 1) + NB**dim) * nb + n_rows)
    return nbytes, flops
