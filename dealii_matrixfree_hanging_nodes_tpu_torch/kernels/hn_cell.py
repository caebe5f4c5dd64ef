"""Kernel 5, ``hn_cell``: the constrained rows of the vmult in one launch,
from the subset bricks u_sub [n_sub, N3p] to HN^T. Row h is cell hn_sub[h]:

1. fill: the masked own nodes of the cell plus the master nodes that the
   fill chain copies into each slot (``fill_hn_plain``);
2. Q: u_hat = filled @ Q_h, Q_h the composite hanging-node matrix of the
   row's mask range (identity ranges pass through; ``hn_apply_plain``);
3. K: own = scale[h] * (K u_hat), by sum factorization of K1, M1
   (``cell_apply_plain``'s row mode);
4. Q^T: out = own @ Q_h^T.

``mode="fill"`` stops after step 2 and returns u_hat (refill's input).
``mode="elastic"`` takes component brick vectors u_sub [3, m, N3p] and
runs each component through steps 1 and 2, then linear elasticity's coupled
operator times scale[h] (``cell_elasticity``'s, on every axis; ``elastic``
= (S, Dc, quad_w, mu, lam)) in place of step 3, then step 4: out [3, n_hn,
n_loc], component-major (the reference's ``_fill_rows`` -> ``el_Kel`` ->
``_hn_apply(transpose=True)``, models/elasticity_bricks.py:241-248).
``mode="deformed"`` (a deformed mapping) replaces step 3 by each row's own
stiffness at its Gauss points, ``deformed`` = (S, Dc, geo): the sweeps of S
and Dc with the packed metric geo[hn_sub[h]] (geo [n_rows, n_q, 6], the
operator's brick-cell rows, whose subset rows lead; ``cell_laplace``'s
``laplace_rows``), no scale (the reference's ``_fill_rows`` ->
``_deformed_cell_apply(u_hat, Gq_hn)`` -> ``_hn_apply(transpose=True)``,
bricks.py:2466-2474, 2959-2976). Neither mode is in ``MODES``: the card
tests loop over ``MODES`` with the Laplace rows' arguments.

With a right-hand-side axis (the "full" and "fill" modes;
``BrickLaplaceMM.vmult_multi``: u_sub [k, n_sub, N3p] with any stride
between its RHS, the subset view ``bvk[:, :n_sub]``) each RHS goes through
the same lists and Q's in one launch (grid.y): out [k, n_hn, n_loc], each
RHS bit-identical to a call on it alone (the reference's rows [n_hn, k,
n_loc] with ``_hn_ids2``, bricks.py:3386, 3478-3482).

Replaces the reference's ``_fill_rows`` (bricks.py:2687-2694: the compact
fill chain ``_fill_hn_compact``, 2728-2773, fed by ``_extract_cols``, then
``_hn_apply`` forward, 2244-2258), the constrained rows' ``u_hat @ K.T *
geo`` (2469-2471) and the transposed ``_hn_apply`` (2474). The tables are
``bricks.kernel_tables``' (``BrickLaplaceMM.hn_tables()``): the fill chain
composed on the host into gather lists (row_ptr [n_hn+1] into entries
sorted by (row, slot); ent_slot, ent_src int32, ent_src a flat index into
u_sub), and each Q's nonzeros by output slot for u @ Q (fwd) and u @ Q^T
(bwd): q [n_hn] the row's Q (-1: identity), ptr [nQ, n_loc+1] int32 into
col int32 and w. 2-D rows ((p+1)^2 values, cells in NB^2-node bricks; the
Q's those of the 2-D masks, ``hn_composite_matrix(mask, P, 2)``) run every
mode: the elastic mode on two components (u_sub [2, m, N3p], out [2, n_hn,
n_loc]), the deformed mode with the 2-D metric (3 values a point); the
dimension comes from n_loc (``_build.cell_shape``). CUDA source:
``csrc/hn_cell.cu``."""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .cell_apply import cell_apply_plain, cell_degree, cell_nodes
from .cell_elasticity import elastic_rows
from .cell_laplace import laplace_rows

NAME = "hn_cell"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:2687"
MODES = ("full", "fill")  # the Laplace rows' modes; "elastic" and "deformed" take more
OTHER_MODES = ("elastic", "deformed")


def gather_sums(src_flat, row_ptr, ent_slot, ent_src, n_loc):
    """[n_rows, n_loc] sums of src_flat[ent_src] by (row, slot): the
    entries' part of the fill, summed in entry order."""
    n_rows = row_ptr.numel() - 1
    rows = torch.repeat_interleave(torch.arange(n_rows, device=src_flat.device),
                                   (row_ptr[1:] - row_ptr[:-1]).long())
    acc = torch.zeros(n_rows * n_loc, dtype=src_flat.dtype, device=src_flat.device)
    acc.index_add_(0, rows * n_loc + ent_slot.long(), src_flat[ent_src.long()])
    return acc.view(n_rows, n_loc)


def fill_hn_plain(u_sub, hn_sub, keep, row_ptr, ent_slot, ent_src, brick_size):
    """Step 1, the compact fill chain on the constrained rows: masked
    gather of each row's own nodes, then the entries' sums added."""
    n_loc = keep.shape[1]
    p = _build.cell_shape(NAME, n_loc)[0]
    flat = u_sub.reshape(-1)
    base = torch.where(keep, flat[cell_nodes(hn_sub, brick_size, p, u_sub.shape[1],
                                             u_sub.device)], 0.0)
    return base + gather_sums(flat, row_ptr, ent_slot, ent_src, n_loc)


def hn_apply_plain(rows, q, ptr, col, w):
    """rows @ Q (fwd lists) or rows @ Q^T (bwd lists), one Q per row's mask
    range: for each Q, gather the weighted inputs of every entry and sum
    them by output slot; rows with q < 0 pass through."""
    out = rows.clone()
    n_loc = rows.shape[1]
    for qi in range(ptr.shape[0]):
        sel = torch.nonzero(q == qi)[:, 0]
        if not sel.numel():
            continue
        e0, e1 = int(ptr[qi, 0]), int(ptr[qi, -1])
        slot = torch.repeat_interleave(torch.arange(n_loc, device=rows.device),
                                       (ptr[qi, 1:] - ptr[qi, :-1]).long())
        vals = rows[sel][:, col[e0:e1].long()] * w[e0:e1]
        out[sel] = torch.zeros((len(sel), n_loc), dtype=rows.dtype,
                               device=rows.device).index_add_(1, slot, vals)
    return out


def hn_cell_plain(u_sub, hn_sub, keep, row_ptr, ent_slot, ent_src, q, fwd_ptr, fwd_col, fwd_w,
                  bwd_ptr, bwd_col, bwd_w, K1, M1, scale, brick_size, mode="full", *,
                  elastic=None, deformed=None):
    """Plain PyTorch version: the four steps one after another, each
    through device memory (K1, M1 and scale are read in the full mode
    only, but scale in the elastic mode too). A RHS axis: each RHS so."""
    if _mode(mode) in MODES and u_sub.dim() == 3:
        return torch.stack([hn_cell_plain(u, hn_sub, keep, row_ptr, ent_slot, ent_src, q,
                                          fwd_ptr, fwd_col, fwd_w, bwd_ptr, bwd_col, bwd_w, K1,
                                          M1, scale, brick_size, mode) for u in u_sub])
    if _mode(mode) == "elastic":
        S, Dc, quad_w, mu, lam = elastic
        u_hat = torch.stack([hn_apply_plain(fill_hn_plain(
            u, hn_sub, keep, row_ptr, ent_slot, ent_src, brick_size), q, fwd_ptr, fwd_col, fwd_w)
            for u in u_sub])
        own = elastic_rows(u_hat, S, Dc, quad_w, scale[:, None].expand(-1, u_sub.shape[0]), mu,
                           lam)
        return torch.stack([hn_apply_plain(r, q, bwd_ptr, bwd_col, bwd_w) for r in own])
    filled = fill_hn_plain(u_sub, hn_sub, keep, row_ptr, ent_slot, ent_src, brick_size)
    u_hat = hn_apply_plain(filled, q, fwd_ptr, fwd_col, fwd_w)
    if _mode(mode) == "fill":
        return u_hat
    if mode == "deformed":
        S, Dc, geo = deformed
        own = laplace_rows(u_hat, S, Dc, None, geo[hn_sub.long()],
                           _build.cell_shape(NAME, keep.shape[1])[1])
    else:
        own = cell_apply_plain(u_hat, K1, M1, scale)
    return hn_apply_plain(own, q, bwd_ptr, bwd_col, bwd_w)


def _mode(mode):
    if mode not in MODES + OTHER_MODES:
        raise ValueError(f"{NAME}: mode must be one of {MODES + OTHER_MODES}, got {mode!r}")
    return mode


_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_int]
         + [ctypes.c_void_p])
# (p, B, dim) of the full and fill modes' instances: the brick size rule's, 3-D at p = 1..8 and
# 2-D at p = 1..6
SUPPORTED = ({(1, 16, 3), (2, 8, 3), (3, 4, 3), (4, 4, 3), (5, 2, 3), (6, 2, 3), (7, 2, 3),
              (8, 2, 3)} | {(1, 16, 2), (2, 16, 2), (3, 16, 2), (4, 8, 2), (5, 8, 2),
                            (6, 8, 2)})
_ELASTIC_ARGS = ([ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_longlong,
                  ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int,
                                                           ctypes.c_void_p])


def hn_cell(u_sub, hn_sub, keep, row_ptr, ent_slot, ent_src, q, fwd_ptr, fwd_col, fwd_w,
            bwd_ptr, bwd_col, bwd_w, K1, M1, scale, brick_size, mode="full", *, elastic=None,
            deformed=None):
    """u_sub [n_sub, N3p] ([dim, m, N3p] in the elastic mode, m >= n_sub; a
    RHS axis in the full and fill modes: [k, n_sub, N3p], any stride
    between RHS);
    hn_sub, q [n_hn], row_ptr [n_hn+1], ent_slot, ent_src, the Q lists' ptr
    [nQ, n_loc+1] and col int32; keep [n_hn, n_loc] bool; w and scale [n_hn]
    of u_sub's dtype -> new [n_hn, n_loc] tensor ([dim, n_hn, n_loc] in the
    elastic mode, [k, n_hn, n_loc] with a RHS axis). The kernel takes K1 and M1 by value, as launch
    parameters: on the kernel path they must be CPU tensors
    (``op.factors_host``). In the fill and deformed modes K1, M1 and scale
    may be None, in the elastic mode K1 and M1; elastic = (S, Dc, quad_w,
    mu, lam), S, Dc and quad_w on u_sub's device; deformed = (S, Dc, geo),
    geo [n_rows, n_loc, 6] (2-D: 3) over at least the subset bricks' cell
    rows, on u_sub's device (the deformed mode takes no RHS axis)."""
    args = (u_sub, hn_sub, keep, row_ptr, ent_slot, ent_src, q, fwd_ptr, fwd_col, fwd_w,
            bwd_ptr, bwd_col, bwd_w)
    _mode(mode)
    if u_sub.device.type == "cpu":
        return hn_cell_plain(*args, K1, M1, scale, brick_size, mode, elastic=elastic,
                             deformed=deformed)
    names = ("u_sub", "hn_sub", "keep", "row_ptr", "ent_slot", "ent_src", "q", "fwd_ptr",
             "fwd_col", "fwd_w", "bwd_ptr", "bwd_col", "bwd_w")
    k, stride = 1, 0
    tensors = dict(zip(names, args))
    if mode in MODES:
        k, stride, tensors["u_sub"] = _build.rhs_axis(NAME, u_sub, 2)
    if mode in ("full", "elastic"):
        tensors["scale"] = scale
    if mode == "elastic":
        tensors.update(zip(("S", "Dc", "quad_w"), elastic[:3]))
    if mode == "deformed":
        tensors.update(zip(("S", "Dc", "geo"), deformed))
    dev = _build.check_cuda(NAME, u_sub.dtype, **tensors)
    n_hn, n_loc = keep.shape
    B = int(brick_size)
    p, dim = _build.cell_shape(NAME, n_loc)
    _check_tables(args, n_hn, n_loc)
    if (p, B, dim) not in SUPPORTED:
        raise ValueError(f"{NAME}: no {dim}-D instance at p={p}, B={B}")
    if mode == "elastic":
        return _elastic(args, scale, elastic, n_hn, p, B, dim, dev)
    if _build.brick_dim(NAME, B * p + 1, u_sub.shape[-1]) != dim:
        raise ValueError(f"{NAME}: u_sub {tuple(u_sub.shape)} holds no {dim}-D bricks of "
                         f"{B * p + 1} nodes a side")
    extra = (None, None, None)  # geo, S, Dc
    if mode == "deformed":
        S, Dc, geo = deformed
        n = p + 1
        if (u_sub.dim() != 2 or S.shape != (n, n) or Dc.shape != (n, n) or geo.dim() != 3
                or geo.shape[1:] != (n_loc, dim * (dim + 1) // 2)
                or u_sub.shape[0] * B**dim > geo.shape[0]):
            raise ValueError(f"{NAME}: deformed mode shapes u_sub {tuple(u_sub.shape)}, S "
                             f"{tuple(S.shape)}, geo {tuple(geo.shape)}")
        extra = (geo, S, Dc)
    if mode != "full":
        factors = (None, None)
    else:
        if cell_degree(K1) != p or M1.shape != K1.shape or scale.shape != (n_hn,):
            raise ValueError(f"{NAME}: K1, M1 must be [{p + 1}, {p + 1}] and scale [{n_hn}]")
        if K1.device.type != "cpu" or M1.device.type != "cpu":
            raise ValueError(f"{NAME}: the kernel takes K1 and M1 as host tensors "
                             f"(op.factors_host), got them on {K1.device} and {M1.device}")
        factors = tuple(f.detach().to(u_sub.dtype).contiguous() for f in (K1, M1))
    out = torch.empty((*u_sub.shape[:-2], n_hn, n_loc), dtype=u_sub.dtype, device=u_sub.device)
    ptrs = (ctypes.c_void_p * 17)(*(t.data_ptr() for t in args),
                                  scale.data_ptr() if mode == "full" else None,
                                  *(None if t is None else t.data_ptr() for t in extra))
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(u_sub.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, ptrs, *(None if f is None else _build.ptr(f) for f in factors),
                  _build.ptr(out), n_hn, p, B, u_sub.shape[-1],
                  {"full": 0, "fill": 1, "deformed": 2}[mode], k, stride, dim)
    hn_cell.launches += 1
    return out


hn_cell.launches = 0


def _check_tables(args, n_hn, n_loc):
    """The types and shapes of the tables after u_sub."""
    (_, hn_sub, keep, row_ptr, ent_slot, ent_src, q, fwd_ptr, fwd_col, fwd_w, bwd_ptr,
     bwd_col, bwd_w) = args
    if any(t.dtype != torch.int32 for t in (hn_sub, row_ptr, ent_slot, ent_src, q, fwd_ptr,
                                            fwd_col, bwd_ptr, bwd_col)):
        raise TypeError(f"{NAME}: the index tables must be int32")
    if (keep.dtype != torch.bool or hn_sub.shape != (n_hn,)
            or q.shape != (n_hn,) or row_ptr.shape != (n_hn + 1,)
            or ent_slot.shape != ent_src.shape
            or any(ptr.dim() != 2 or ptr.shape[1] != n_loc + 1 or col.shape != w.shape
                   for ptr, col, w in ((fwd_ptr, fwd_col, fwd_w), (bwd_ptr, bwd_col, bwd_w)))):
        raise ValueError(f"{NAME}: shapes keep {tuple(keep.shape)}, row_ptr "
                         f"{tuple(row_ptr.shape)}, Q lists {tuple(fwd_ptr.shape)} / "
                         f"{tuple(bwd_ptr.shape)}")


def _elastic(args, scale, elastic, n_hn, p, B, dim, dev):
    """The elastic mode's launch: dim components of rows of (p+1)^dim values."""
    u_sub = args[0]
    S, Dc, quad_w, mu, lam = elastic
    n, n_loc = p + 1, (p + 1) ** dim
    if (u_sub.dim() != 3 or u_sub.shape[0] != dim
            or _build.brick_dim(NAME, B * p + 1, u_sub.shape[2]) != dim
            or scale.shape != (n_hn,) or S.shape != (n, n) or Dc.shape != (n, n)
            or quad_w.shape != (n_loc,)):
        raise ValueError(f"{NAME}: elastic mode shapes u_sub {tuple(u_sub.shape)}, scale "
                         f"{tuple(scale.shape)}, S {tuple(S.shape)} in {dim}-D")
    out = torch.empty((dim, n_hn, n_loc), dtype=u_sub.dtype, device=u_sub.device)
    if n_hn == 0:
        return out
    ptrs = (ctypes.c_void_p * 17)(*(t.data_ptr() for t in (*args, scale, S, Dc, quad_w)))
    fn = _build.function(NAME, f"{NAME}_elastic_{_build.suffix(u_sub.dtype)}", _ELASTIC_ARGS)
    _build.launch(NAME, fn, dev, ptrs, float(mu), float(lam), u_sub.shape[1] * u_sub.shape[2],
                  _build.ptr(out), n_hn, p, B, u_sub.shape[2], None, dim)
    hn_cell.launches += 1
    return out


def elastic_plan(dtype, p, B, dim, device=None):
    """(threads, shared-memory bytes, blocks per SM) of an elastic-mode
    launch at degree p, brick size B, in dim dimensions; launches nothing."""
    info = (ctypes.c_int * 3)()
    dev = torch.device("cuda") if device is None else device
    fn = _build.function(NAME, f"{NAME}_elastic_{_build.suffix(dtype)}", _ELASTIC_ARGS)
    _build.launch(NAME, fn, dev, (ctypes.c_void_p * 17)(), 1.0, 1.0, 0, None, 1, p, B, 0, info,
                  dim)
    return tuple(info)


def bytes_and_flops(u_sub, hn_sub, keep, row_ptr, ent_slot, ent_src, q, fwd_ptr, fwd_col,
                    fwd_w, bwd_ptr, bwd_col, bwd_w, brick_size, mode="full"):
    """Least traffic: each distinct brick node the rows read (kept own nodes
    and entry sources) read once, out written once, the keep mask at one
    bit a slot, hn_sub, q, the fill lists and the Q lists read once, and in
    the full mode scale, K1 and M1 (the elastic mode: three components of
    the nodes and of out, scale, S, Dc and the weights). Operations: an add
    per fill entry, a multiply and an add per nonzero of each row's Q (and
    of Q^T), and in the full mode the 7 sweeps of 2 n^4 and the scale a row
    (the elastic mode: each of these a component, and the coupled
    operator's 36 sweeps of 2 n^4 and ~40 operations a point a row; the
    deformed mode: the rows' metric read, 12 sweeps of 2 n^4 and 15
    operations a point a row; 2-D: two components, 16 sweeps of 2 n^3 and
    ~16 operations a point, and the deformed mode's 3 metric values, 8
    sweeps of 2 n^3 and 7 operations a point). A RHS axis: the nodes, the
    rows and the operations k times, the tables once."""
    n_hn, n_loc = keep.shape
    p, dim = _build.cell_shape(NAME, n_loc)
    n = p + 1
    k = dim if _mode(mode) == "elastic" else (u_sub.shape[0] if u_sub.dim() == 3 else 1)
    isz = u_sub.element_size()
    own = cell_nodes(hn_sub, brick_size, p, u_sub.shape[-1], u_sub.device)[keep]
    n_read = torch.unique(torch.cat([own, ent_src.long()])).numel()
    n_ent = ent_src.numel()
    lists = [(fwd_ptr, fwd_col)] + ([(bwd_ptr, bwd_col)] if mode != "fill" else [])
    nbytes = (k * (n_read + n_hn * n_loc) * isz + (keep.numel() + 7) // 8
              + 4 * (2 * n_hn + row_ptr.numel() + ent_slot.numel() + n_ent)
              + sum(4 * ptr.numel() + (4 + isz) * col.numel() for ptr, col in lists))
    flops = k * n_ent
    for ptr, _ in lists if fwd_ptr.shape[0] else []:
        nnz = ptr[:, -1] - ptr[:, 0]
        flops += 2 * k * int(torch.where(q >= 0, nnz[q.long().clamp(min=0)], 0).sum())
    if mode == "full":
        nbytes += (n_hn + 2 * n * n) * isz
        flops += k * n_hn * ((7 * 2 * n**4 + n**3) if dim == 3 else (4 * 2 * n**3 + n**2))
    elif mode == "elastic":
        nbytes += (n_hn + 2 * n * n + n_loc) * isz
        flops += n_hn * ((3 * 12 * 2 * n**4 + 40 * n_loc) if dim == 3
                         else (2 * 8 * 2 * n**3 + 16 * n_loc))
    elif mode == "deformed":
        nbytes += (n_hn * n_loc * dim * (dim + 1) // 2 + 2 * n * n) * isz
        flops += n_hn * ((12 * 2 * n**4 + 15 * n_loc) if dim == 3 else (8 * 2 * n**3 + 7 * n_loc))
    return nbytes, flops
