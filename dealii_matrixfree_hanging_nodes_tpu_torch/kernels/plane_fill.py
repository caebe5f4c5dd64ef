"""Kernel 10, ``plane_fill``: the face-plane fill of the degree <= 2 schedule
into a new vector. out = u, except at the covered nodes cov [n_cov] (flat
indices brick * N3p + node, ascending; cov_ptr [nb+1] each brick's range):

    out[cov[k]] = sum of w[e] * u_flat[src[e]] over e = fill_ptr[k] .. fill_ptr[k+1]

The entries are the fill of every level (a fine brick's covered face node
from P1 (coarse quarter face) P1^T, coarse level first) composed on the
host into one map from the nodes no level writes (``bricks._plane_tables``),
so one launch reads u alone and writes out alone.

Replaces the reference's ``_plane_fill`` (bricks.py:3044-3102): per level,
gathers of the plane-touched bricks, the [NB, Nh] interpolations and a
scatter-add of the covered updates, then the scatter back into a new
vector. CUDA source: ``csrc/plane_fill.cu``."""

from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "plane_fill"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:3044"


def segment_sums(x_flat, ptr, src, w):
    """[len(ptr)-1] sums of w[e] * x_flat[src[e]] by segment, in entry order."""
    seg = torch.repeat_interleave(torch.arange(ptr.numel() - 1, device=x_flat.device),
                                  (ptr[1:] - ptr[:-1]).long())
    acc = torch.zeros(ptr.numel() - 1, dtype=x_flat.dtype, device=x_flat.device)
    return acc.index_add_(0, seg, x_flat[src.long()] * w)


def plane_fill_plain(u, cov, cov_ptr, fill_ptr, fill_src, fill_w):
    """Plain PyTorch version: a copy of u, then the covered nodes' sums
    written over it."""
    out = u.clone()
    out.view(-1)[cov.long()] = segment_sums(u.reshape(-1), fill_ptr, fill_src, fill_w)
    return out


_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def plane_fill(u, cov, cov_ptr, fill_ptr, fill_src, fill_w):
    """u [nb, N3p] -> new [nb, N3p] tensor; cov [n_cov], cov_ptr [nb+1],
    fill_ptr [n_cov+1], fill_src int32, fill_w of u's dtype."""
    if u.device.type == "cpu":
        return plane_fill_plain(u, cov, cov_ptr, fill_ptr, fill_src, fill_w)
    dev = _build.check_cuda(NAME, u.dtype, u=u, cov=cov, cov_ptr=cov_ptr, fill_ptr=fill_ptr,
                            fill_src=fill_src, fill_w=fill_w)
    nb, N3p = u.shape
    if any(t.dtype != torch.int32 for t in (cov, cov_ptr, fill_ptr, fill_src)):
        raise TypeError(f"{NAME}: cov, cov_ptr, fill_ptr and fill_src must be int32")
    if (cov_ptr.shape != (nb + 1,) or fill_ptr.shape != (cov.numel() + 1,)
            or fill_src.shape != fill_w.shape or nb * N3p > 2**31 - 1):
        raise ValueError(f"{NAME}: shapes u {tuple(u.shape)}, cov_ptr {tuple(cov_ptr.shape)}, "
                         f"fill_ptr {tuple(fill_ptr.shape)}")
    if u.data_ptr() % 16 or N3p * u.element_size() % 16:
        raise ValueError(f"{NAME}: u's rows must be 16-byte aligned (16-byte copies)")
    out = torch.empty_like(u)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(u.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(u), _build.ptr(out), _build.ptr(cov),
                  _build.ptr(cov_ptr), _build.ptr(fill_ptr), _build.ptr(fill_src),
                  _build.ptr(fill_w), nb, N3p)
    plane_fill.launches += 1
    return out


plane_fill.launches = 0


def bytes_and_flops(u, cov, cov_ptr, fill_ptr, fill_src, fill_w):
    """Least traffic: u read once (its covered nodes need not be), out
    written once, the tables read once; a multiply and an add per entry."""
    isz = u.element_size()
    nbytes = ((2 * u.numel() - cov.numel() + fill_w.numel()) * isz
              + 4 * (cov.numel() + cov_ptr.numel() + fill_ptr.numel() + fill_src.numel()))
    return nbytes, 2 * fill_src.numel()
