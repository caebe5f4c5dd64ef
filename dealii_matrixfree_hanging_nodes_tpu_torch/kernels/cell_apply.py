"""Kernel 2, ``cell_apply``: the dense local stiffness on cell rows,
out[r] = scale[r] * (K x_r), in one of two input modes:

- from bricks (``brick_size=B``): x_r are the (p+1)^3 nodes of cell r read
  from its brick, src [m, N3p] -> out [m*B^3, n_loc] — the reference's
  ``_extract_cols`` (bricks.py:2178-2194) fused with ``cols @ K.T *
  geo_cell_sub`` (bricks.py:2449-2453);
- from rows (``brick_size=None``): src [m, n_loc] -> out [m, n_loc] — the
  reference's ``u_hat @ K.T * geo_cell_sub[hn_sub]`` (bricks.py:2469-2471).

CUDA source: ``csrc/cell_apply.cu``."""

from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "cell_apply"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:2178"


def cell_degree(K) -> int:
    n = round(K.shape[0] ** (1.0 / 3.0))
    if n**3 != K.shape[0] or K.shape != (n**3, n**3):
        raise ValueError(f"K must be [(p+1)^3, (p+1)^3], got {tuple(K.shape)}")
    return n - 1


def brick_slot_index(B: int, p: int, device=None) -> torch.Tensor:
    """[B^3, (p+1)^3] brick node of (cell slot, local node), both x
    fastest (the reference's ``slot_idx``, the one-hot E as an index map)."""
    n, NB = p + 1, B * p + 1
    loc = torch.arange(n**3, device=device)
    slot = torch.arange(B**3, device=device)
    axis = lambda i, w, a: (i // w**a) % w
    return sum(
        ((axis(slot, B, a) * p)[:, None] + axis(loc, n, a)[None, :]) * NB**a
        for a in range(3)
    )


def cell_apply_plain(src, K, scale, brick_size=None):
    """Plain PyTorch version: gather the cell rows, one matmul, scale."""
    if brick_size is not None:
        idx = brick_slot_index(brick_size, cell_degree(K), src.device)
        src = src[:, idx.reshape(-1)].reshape(-1, K.shape[0])
    return (src @ K.T) * scale[:, None]


_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def cell_apply(src, K, scale, brick_size=None):
    """Launch the kernel on CUDA tensors; the plain version on CPU ones."""
    if src.device.type == "cpu":
        return cell_apply_plain(src, K, scale, brick_size)
    dev = _build.check_cuda(NAME, src.dtype, src=src, K=K, scale=scale)
    p = cell_degree(K)
    n_loc = K.shape[0]
    m = src.shape[0]
    if brick_size is None:
        rows, B, N3p = m, 0, 0
        if src.shape != (m, n_loc):
            raise ValueError(f"{NAME}: rows must be [m, {n_loc}], got {tuple(src.shape)}")
    else:
        B = int(brick_size)
        if src.dim() != 2 or src.shape[1] < (B * p + 1) ** 3:
            raise ValueError(f"{NAME}: bricks must be [m, >= NB^3], got {tuple(src.shape)}")
        rows, N3p = m * B**3, src.shape[1]
    if scale.shape != (rows,):
        raise ValueError(f"{NAME}: scale must be [{rows}], got {tuple(scale.shape)}")
    out = torch.empty((rows, n_loc), dtype=src.dtype, device=src.device)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(src.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(src), _build.ptr(K), _build.ptr(scale),
                  _build.ptr(out), rows, p, B, N3p)
    cell_apply.launches += 1
    return out


cell_apply.launches = 0


def bytes_and_flops(src_elems, rows, n_loc, itemsize):
    """Least traffic (src read once, out written once, K and scale) and the
    dense product's operation count."""
    nbytes = (src_elems + rows * n_loc + n_loc * n_loc + rows) * itemsize
    return nbytes, 2 * rows * n_loc * n_loc
