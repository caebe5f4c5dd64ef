"""Kernel 7, ``corr_compact``: the compact fold chain and the sparse delta of
the subset cell rows. With acc[r, j] the sum of sub_raw_flat[src] over the
entries of the run that lands on (r, j), every row r of dcols
[n_sub*B^3, n_loc] is

    cell_code[r] = h >= 0 (constrained row h):
        keep[h, j] ? (sub_raw[h, j] + acc[r, j]) - plain[r, j] : -plain[r, j]
    cell_code[r] = -2 (absent cell):      -plain[r, j]
    otherwise (fold targets, the rest):   acc[r, j]

with plain=None read as zeros (the assembled schedule of degree <= 3, whose
masked removal takes the cells' plain contributions off instead).

Replaces the reference's ``_corr_compact`` (bricks.py:2775-2849) with the
``plain_rows[hn_sub]`` gather before it (bricks.py:2465): stage-1 one-hot
transfer matmuls, the scatter-adds into the hn and non-hn rows, the tails
on ``sub_raw + acc``, the keep mask and ``final - plain``. As for the fill,
``bricks.kernel_tables`` composes the stages on the host into runs: the
entries ent_src (flat indices into sub_raw) sorted by destination, run s
holding entries seg_ptr[s] .. seg_ptr[s+1] that all land on the flat dcols
slot seg_dst[s] = row * n_loc + slot (ascending), and a block schedule
(``schedule``). 2-D cells ((p+1)^2 values) run the same kernel at their
sizes. CUDA source: ``csrc/corr_compact.cu``.

With a leading axis of k components or right-hand sides (elasticity's 3:
plain, dcols [3, n_rows, n_loc], sub_raw [3, n_hn, n_loc], component-major;
``BrickLaplaceMM.vmult_multi``'s k right-hand sides, k-major) each goes
through the same tables in one launch (grid.y), bit-identical to a scalar
call on its slices (the reference's trailing component axis of the rows,
models/elasticity_bricks.py:241-249, and its ``_corr_compact`` on
``plain3 [nsC, k, n_loc]``, bricks.py:3484-3485)."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

NAME = "corr_compact"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:2775"
THREADS = 256  # the kernel's block size, and the most runs the schedule gives a block
ROW_GROUP = 4  # a block's first row is a multiple of this: 16-byte aligned rows in f32 and f64


def block_rows(n_loc: int) -> int:
    """The most rows a block takes: about 4096 values (its run sums in
    shared memory: 16 KB in f32, 32 KB in f64), a multiple of ROW_GROUP."""
    return max(ROW_GROUP, 4096 // n_loc // ROW_GROUP * ROW_GROUP)


def schedule(runs_per_row, n_loc: int) -> np.ndarray:
    """The kernel's blocks as [n_blocks + 1, 2] int32 (first row, first run)
    from the runs that land on each row (their dst rows ascending): rows
    cut into groups of ROW_GROUP, a block takes whole groups while it holds
    at most ``block_rows(n_loc)`` rows and THREADS runs (a group with more
    runs is a block alone), so the heavy fold rows spread over many blocks
    and no block sums more than one run a thread."""
    runs = np.asarray(runs_per_row, dtype=np.int64)
    n_rows = len(runs)
    n_groups = -(-n_rows // ROW_GROUP)
    g_runs = np.add.reduceat(runs, np.arange(n_groups) * ROW_GROUP) if n_rows else runs
    cap = block_rows(n_loc) // ROW_GROUP
    starts, rows, taken = [0], 0, 0
    for g, k in enumerate(g_runs):
        if rows and (rows == cap or taken + k > THREADS):
            starts.append(g)
            rows, taken = 0, 0
        rows += 1
        taken += int(k)
    if n_rows == 0:
        starts = []
    first_row = np.minimum(np.asarray(starts + [n_groups], dtype=np.int64) * ROW_GROUP, n_rows)
    first_run = np.concatenate([[0], np.cumsum(runs)])[first_row]
    return np.stack([first_row, first_run], axis=1).astype(np.int32)


def run_sums(sub_raw, seg_ptr, seg_dst, ent_src, n_slots):
    """[n_slots] sums of sub_raw_flat[ent_src] by run, each added at its
    dst slot, in entry order (zero where no run lands)."""
    dst = torch.repeat_interleave(seg_dst.long(), (seg_ptr[1:] - seg_ptr[:-1]).long())
    acc = torch.zeros(n_slots, dtype=sub_raw.dtype, device=sub_raw.device)
    return acc.index_add_(0, dst, sub_raw.reshape(-1)[ent_src.long()])


def corr_compact_plain(plain, sub_raw, cell_code, keep, seg_ptr, seg_dst, ent_src, blocks):
    """Plain PyTorch version on the same runs (``blocks``, the kernel's
    schedule, is not read): the run sums, then the constrained and absent
    rows written over them (a component axis: each component so)."""
    if sub_raw.dim() == 3:
        return torch.stack([corr_compact_plain(None if plain is None else plain[c], sub_raw[c],
                                               cell_code, keep, seg_ptr, seg_dst, ent_src, blocks)
                            for c in range(sub_raw.shape[0])])
    n_rows, n_loc = cell_code.shape[0], sub_raw.shape[1]
    dcols = run_sums(sub_raw, seg_ptr, seg_dst, ent_src, n_rows * n_loc).view(n_rows, n_loc)
    if plain is None:
        plain = torch.zeros((), dtype=sub_raw.dtype, device=sub_raw.device).expand(n_rows, n_loc)
    absent = torch.nonzero(cell_code == -2)[:, 0]
    dcols[absent] = -plain[absent]
    hn = torch.nonzero(cell_code >= 0)[:, 0]
    h = cell_code[hn].long()
    dcols[hn] = torch.where(keep[h], (sub_raw[h] + dcols[hn]) - plain[hn], -plain[hn])
    return dcols


_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
         + [ctypes.c_void_p])


def corr_compact(plain, sub_raw, cell_code, keep, seg_ptr, seg_dst, ent_src, blocks):
    """plain [n_rows, n_loc] or None (zeros), sub_raw [n_hn, n_loc];
    cell_code [n_rows], seg_ptr [n_seg+1], seg_dst [n_seg], ent_src, blocks
    [n_blocks+1, 2] int32 (``schedule``); keep [n_hn, n_loc] bool -> new
    dcols [n_rows, n_loc]. A leading axis of k components or right-hand
    sides: plain [k, n_rows, n_loc], sub_raw [k, n_hn, n_loc] -> dcols [k,
    n_rows, n_loc]."""
    args = (plain, sub_raw, cell_code, keep, seg_ptr, seg_dst, ent_src, blocks)
    if sub_raw.device.type == "cpu":
        return corr_compact_plain(*args)
    dev = _build.check_cuda(NAME, sub_raw.dtype, **{k: t for k, t in zip(
        ("plain", "sub_raw", "cell_code", "keep", "seg_ptr", "seg_dst", "ent_src", "blocks"),
        args) if t is not None})
    k = _build.rhs_axis(NAME, sub_raw, 2)[0]
    lead = sub_raw.shape[:-2]
    n_rows, n_loc = cell_code.shape[0], sub_raw.shape[-1]
    p, _ = _build.cell_shape(NAME, n_loc)
    if any(t.dtype != torch.int32 for t in (cell_code, seg_ptr, seg_dst, ent_src, blocks)):
        raise TypeError(f"{NAME}: cell_code, seg_ptr, seg_dst, ent_src and blocks must be int32")
    if (keep.dtype != torch.bool or lead + tuple(keep.shape) != sub_raw.shape
            or (plain is not None and plain.shape != lead + (n_rows, n_loc))
            or cell_code.dim() != 1
            or seg_ptr.shape != (seg_dst.numel() + 1,) or ent_src.dim() != 1
            or blocks.dim() != 2 or blocks.shape[1] != 2 or n_rows * n_loc > 2**31 - 1):
        raise ValueError(f"{NAME}: shapes plain "
                         f"{None if plain is None else tuple(plain.shape)}, sub_raw "
                         f"{tuple(sub_raw.shape)}, seg_ptr {tuple(seg_ptr.shape)}, blocks "
                         f"{tuple(blocks.shape)}")
    out = torch.empty(lead + (n_rows, n_loc), dtype=sub_raw.dtype, device=sub_raw.device)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(sub_raw.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, *(None if t is None else _build.ptr(t) for t in args),
                  _build.ptr(out),
                  blocks.shape[0] - 1, block_rows(n_loc), n_loc, p, k, n_rows * n_loc,
                  keep.numel())
    corr_compact.launches += 1
    return out


corr_compact.launches = 0


def bytes_and_flops(plain, sub_raw, cell_code, keep, seg_ptr, seg_dst, ent_src, blocks):
    """Least traffic (the kernel's arguments, each component of a component
    axis for the rows): sub_raw read once, plain read
    at the constrained and absent rows only (not at all where it is None),
    dcols written once, cell_code, the keep mask (one bit a slot), the runs
    and the schedule read once; an add per entry and two operations per
    constrained slot."""
    k = sub_raw.shape[0] if sub_raw.dim() == 3 else 1
    n_rows, n_loc = cell_code.shape[0], sub_raw.shape[-1]
    n_read_plain = 0 if plain is None else k * int((cell_code != -1).sum()) * n_loc
    n_ent = ent_src.numel()
    nbytes = ((sub_raw.numel() + n_read_plain + k * n_rows * n_loc) * sub_raw.element_size()
              + (keep.numel() + 7) // 8
              + 4 * (n_rows + seg_ptr.numel() + seg_dst.numel() + n_ent + blocks.numel()))
    return nbytes, k * n_ent + 2 * sub_raw.numel()
