"""Kernel 4, ``dss_surface``: the cross-brick direct-stiffness summation.
Every shared face / edge / corner node of a brick gets the sum of all its
copies over the interface pool, and the nodes outside the mesh (holes,
padding) are zeroed: out = where(node_valid, dss(v), 0).

Replaces the input-fill branch of the reference's ``_dss_fill``
(bricks.py:2562-2568 and 2608-2612) with ``_dss_surface``
(bricks.py:2096-2136). CUDA source: ``csrc/dss_surface.cu``.

The surface of a brick is ordered as in the reference: the 6 face
interiors ((NB-2)^2 nodes each, faces 2d+side), the 12 edge interiors
(NB-2 nodes each, edge e*4 + 2*sa + sb along axis e), the 8 corners (bit d
set where the corner sits at NB-1 on axis d). The pair tables hold flat
indices into those blocks (face b*6+f, edge b*12+e, corner b*8+c), with
the block size times n_bricks as the sentinel."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

NAME = "dss_surface"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:2534"


def surface_nodes(NB: int) -> np.ndarray:
    """Brick node of each surface position (the one-hot Es as an index map,
    the reference's ordering, bricks.py:1252-1311)."""
    inner = np.arange(1, NB - 1)
    grid3 = lambda z, y, x: (z * NB + y) * NB + x
    surf = []
    for d in range(3):
        for side in (0, 1):
            c = 0 if side == 0 else NB - 1
            if d == 0:  # x-face: vary (z, y)
                ids = grid3(inner[:, None], inner[None, :], c)
            elif d == 1:
                ids = grid3(inner[:, None], c, inner[None, :])
            else:
                ids = grid3(c, inner[:, None], inner[None, :])
            surf.append(ids.reshape(-1))
    for e in range(3):
        axes = [x for x in range(3) if x != e]
        for sa in (0, 1):
            for sb in (0, 1):
                cc = np.zeros((len(inner), 3), dtype=np.int64)
                cc[:, e] = inner
                cc[:, axes[0]] = 0 if sa == 0 else NB - 1
                cc[:, axes[1]] = 0 if sb == 0 else NB - 1
                surf.append(grid3(cc[:, 2], cc[:, 1], cc[:, 0]))
    for combo in range(8):
        cc = [(0 if ((combo >> d) & 1) == 0 else NB - 1) for d in range(3)]
        surf.append(np.array([grid3(cc[2], cc[1], cc[0])]))
    return np.concatenate(surf).astype(np.int64)


def dss_surface_plain(v, face_other, edge_contrib, corner_contrib, node_valid, NB):
    """Plain PyTorch version, the reference's gather-only ("pair") form:
    extract the surface, sum each copy's contributors, write the delta
    back, mask. Returns a new tensor."""
    nb = v.shape[0]
    surf_idx = torch.from_numpy(surface_nodes(NB)).to(v.device)
    surf = v[:, surf_idx]
    fsize, esize = (NB - 2) ** 2, NB - 2
    zero = lambda w: torch.zeros((1, w), dtype=v.dtype, device=v.device)
    fflat = surf[:, : 6 * fsize].reshape(nb * 6, fsize)
    fnew = fflat
    if face_other.shape[1]:
        fpad = torch.cat([fflat, zero(fsize)])
        fnew = fflat + fpad[face_other[:, 0].long()]
    off = 6 * fsize
    eflat = surf[:, off: off + 12 * esize].reshape(nb * 12, esize)
    epad = torch.cat([eflat, zero(esize)])
    enew = epad[edge_contrib.reshape(-1).long()].reshape(nb * 12, -1, esize).sum(1)
    off += 12 * esize
    cflat = surf[:, off: off + 8].reshape(-1, 1)
    cpad = torch.cat([cflat, zero(1)])[:, 0]
    cnew = cpad[corner_contrib.reshape(-1).long()].reshape(nb * 8, -1).sum(1)
    surf_new = torch.cat(
        [fnew.reshape(nb, -1), enew.reshape(nb, -1), cnew.reshape(nb, 8)], dim=1)
    out = v.clone()
    out[:, surf_idx] += surf_new - surf
    return torch.where(node_valid, out, 0.0)


_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
          ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
         + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def dss_surface(v, face_other, edge_contrib, corner_contrib, node_valid, NB):
    """v [nb, N3p]; face_other [nb*6, 0|1], edge_contrib [nb*12, *],
    corner_contrib [nb*8, *] int32; node_valid [nb, N3p] bool -> new tensor."""
    if v.device.type == "cpu":
        return dss_surface_plain(v, face_other, edge_contrib, corner_contrib,
                                 node_valid, NB)
    dev = _build.check_cuda(NAME, v.dtype, v=v, face_other=face_other,
                            edge_contrib=edge_contrib, corner_contrib=corner_contrib,
                            node_valid=node_valid)
    nb, N3p = v.shape
    for key, t, rows in (("face_other", face_other, 6), ("edge_contrib", edge_contrib, 12),
                         ("corner_contrib", corner_contrib, 8)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != nb * rows:
            raise ValueError(f"{NAME}: {key} must be int32 [{nb * rows}, k]")
    if face_other.shape[1] > 1:
        raise ValueError(f"{NAME}: a face pairs at most two bricks")
    if node_valid.dtype != torch.bool or node_valid.shape != v.shape or N3p < NB**3:
        raise ValueError(f"{NAME}: node_valid must be bool {tuple(v.shape)}")
    out = torch.empty_like(v)
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(v.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(v), _build.ptr(face_other), face_other.shape[1],
                  _build.ptr(edge_contrib), edge_contrib.shape[1], _build.ptr(corner_contrib),
                  corner_contrib.shape[1], _build.ptr(node_valid), _build.ptr(out),
                  nb, NB, N3p)
    dss_surface.launches += 1
    return out


dss_surface.launches = 0


def bytes_and_flops(node_valid, face_other, edge_contrib, corner_contrib, NB, itemsize):
    """Least traffic of the function done in place on v (v is a temporary
    of the vmult): every surface copy read once and written once, a zero
    written at every hole or padding node off the surface (valid interior
    nodes do not move), the hole pattern read at one bit per node, and the
    pair tables read once. One add per extra contributor of each surface
    copy, counted from these tables."""
    nb, N3p = node_valid.shape
    surf = torch.from_numpy(surface_nodes(NB)).to(node_valid.device)
    off_surface = torch.ones(N3p, dtype=torch.bool, device=node_valid.device)
    off_surface[surf] = False
    holes = int((~node_valid[:, off_surface]).sum())
    nbytes = ((2 * nb * surf.numel() + holes) * itemsize + nb * N3p // 8
              + 4 * (face_other.numel() + edge_contrib.numel() + corner_contrib.numel()))
    valid = lambda t, rows: (t < nb * rows).sum(dim=1)
    flops = (int(valid(face_other, 6).sum()) * (NB - 2) ** 2
             + int((valid(edge_contrib, 12) - 1).clamp(min=0).sum()) * (NB - 2)
             + int((valid(corner_contrib, 8) - 1).clamp(min=0).sum()))
    return nbytes, flops
