"""Kernel 1, ``brick_apply``: the separable brick Laplace times the brick's
geometry factor, v_b = geo_b (Mz⊗(My⊗Kx + Ky⊗Mx) + Kz⊗My⊗Mx) u_b, on every
brick of a [n_bricks, N3p] vector (x fastest, padded tail zero).

Replaces ``experiments/queue/_mb_main.py:63`` ``pallas_fused``, the Pallas
form of ``BrickLaplaceMM._main_apply`` (bricks.py:2321-2348) times ``geo``
(bricks.py:2367). CUDA source: ``csrc/brick_apply.cu``."""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

NAME = "brick_apply"
REPLACES = "experiments/queue/_mb_main.py:63"
# (NB, p) pairs the CUDA kernel is instantiated for: B=4 at p=4, B=2 at p=5..8
SUPPORTED = {(17, 4), (11, 5), (13, 6), (15, 7), (17, 8)}


def brick_apply_plain(bv, Kb, Mb, geo, p=None):
    """Plain PyTorch version, the reference's algebra: the 289x289 xy
    factors Fxy = Mb⊗Kb + Kb⊗Mb and Mxy = Mb⊗Mb, then the z contractions."""
    nb, N3p = bv.shape
    NB = Kb.shape[0]
    N3 = NB**3
    u3 = bv[:, :N3].reshape(nb, NB, NB * NB)
    Fxy = torch.kron(Mb, Kb) + torch.kron(Kb, Mb)
    Mxy = torch.kron(Mb, Mb)
    t = torch.einsum("wz,bzr->bwr", Mb, u3 @ Fxy.T)
    s = torch.einsum("wz,bzr->bwr", Kb, u3)
    v = (t + s @ Mxy.T).reshape(nb, N3)
    return F.pad(v, (0, N3p - N3)) * geo[:, None]


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def brick_apply(bv, Kb, Mb, geo, p):
    """bv [nb, N3p], Kb/Mb [NB, NB] (degree p: banded, |i-j| <= p), geo [nb]
    -> v [nb, N3p]."""
    if bv.device.type == "cpu":
        return brick_apply_plain(bv, Kb, Mb, geo)
    dev = _build.check_cuda(NAME, bv.dtype, bv=bv, Kb=Kb, Mb=Mb, geo=geo)
    nb, N3p = bv.shape
    NB = Kb.shape[0]
    if (NB, p) not in SUPPORTED or Mb.shape != (NB, NB) or Kb.shape != (NB, NB):
        raise ValueError(f"{NAME}: unsupported brick width NB={NB}")
    if geo.shape != (nb,) or N3p < NB**3:
        raise ValueError(f"{NAME}: shapes bv {tuple(bv.shape)}, geo {tuple(geo.shape)}")
    out = torch.empty_like(bv)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(bv.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(bv), _build.ptr(Kb), _build.ptr(Mb),
                  _build.ptr(geo), _build.ptr(out), nb, NB, p, N3p)
    brick_apply.launches += 1
    return out


brick_apply.launches = 0


def bytes_and_flops(nb, NB, p, N3p, itemsize):
    """Least traffic (read u and write v once, the factors and geo) and the
    kernel's operation count: seven sweeps, each summing the band
    |i-j| <= p of one factor per node."""
    band = sum(min(NB - 1, i + p) - max(0, i - p) + 1 for i in range(NB))
    nbytes = (2 * nb * N3p + 2 * NB * NB + nb) * itemsize
    flops = 7 * 2 * band * NB * NB * nb
    return nbytes, flops
