"""Kernel 4, ``dss_surface``: the cross-brick direct-stiffness summation,
in place. Every shared face / edge / corner node of a brick gets the sum of
all its copies over the interface pool, and the nodes outside the mesh
(holes, padding) are zeroed: v <- where(node_valid, dss(v), 0).

Replaces the input-fill branch of the reference's ``_dss_fill``
(bricks.py:2562-2568 and 2608-2612) with ``_dss_surface``
(bricks.py:2096-2136). CUDA source: ``csrc/dss_surface.cu``.

The surface of a brick is ordered as in the reference: the 6 face
interiors ((NB-2)^2 nodes each, faces 2d+side), the 12 edge interiors
(NB-2 nodes each, edge e*4 + 2*sa + sb along axis e), the 8 corners (bit d
set where the corner sits at NB-1 on axis d). The work lists
(``bricks.kernel_tables``) hold, per pool, its copies as flat indices into
those blocks (face b*6+f, edge b*12+e, corner b*8+c) in pool-canonical
order, padded with -1; the validity of each surface copy is one bit per
surface position, the invalid nodes off the surface one bit per brick node
of each hole brick (padding is zeroed without a table).

A 2-D brick's surface (rows of NB^2 nodes) is its 4 side-line interiors
(NB-2 nodes each, sides 2d+side) and its 4 corners: face_pairs pair the
sides (b*4+f), corner pools hold up to 4 copies (b*4+c), and there are no
edge pools (the reference's 2-D ordering, bricks.py:1294-1310).

With a leading axis of k components or right-hand sides (elasticity's
v [3, nb, N3p]; ``BrickLaplaceMM.vmult_multi``'s [k, nb, N3p]) each goes
through the same tables in one launch (grid.y), bit-identical to a scalar
call on v[c] (the reference's ``_dss_surface_multi``, bricks.py:3303)."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

NAME = "dss_surface"
REPLACES = "dealii_matrixfree_hanging_nodes_tpu/bricks.py:2534"


def surface_nodes(NB: int, dim: int = 3) -> np.ndarray:
    """Brick node of each surface position (the one-hot Es as an index map,
    the reference's ordering, bricks.py:1252-1311): in 3-D the 6 face
    interiors, 12 edge interiors and 8 corners; in 2-D the 4 side-line
    interiors (x-sides varying y, then y-sides varying x, side 0 first),
    then the 4 corners (bit d set at NB-1 on axis d)."""
    inner = np.arange(1, NB - 1)
    if dim == 2:
        surf = [inner * NB, inner * NB + NB - 1, inner, (NB - 1) * NB + inner]
        surf += [np.array([(combo >> 1) * (NB - 1) * NB + (combo & 1) * (NB - 1)])
                 for combo in range(4)]
        return np.concatenate(surf).astype(np.int64)
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


POOL_KINDS = ("face", "edge", "corner")


def surface_blocks(NB: int, dim: int):
    """{kind: (copies a brick, nodes a copy, first surface position)} of the
    surface's blocks in ``surface_nodes`` order (no edges in 2-D)."""
    M = NB - 2
    if dim == 2:
        return {"face": (4, M, 0), "edge": (0, M, 4 * M), "corner": (4, 1, 4 * M)}
    return {"face": (6, M * M, 0), "edge": (12, M, 6 * M * M),
            "corner": (8, 1, 6 * M * M + 12 * M)}


def pool_positions(pools, kind, NB, N3p):
    """(brick [e, c], surface position [e, c, m], flat node [e, c, m], real
    [e, c]) of every copy of every pool in a work list, m nodes per copy,
    in bricks of N3p values (which give the dimension); padding copies
    (-1) are not real and point at brick 0."""
    dim = _build.brick_dim(NAME, NB, N3p)
    K, width, off = surface_blocks(NB, dim)[kind]
    K = max(K, 1)  # 2-D edge lists are empty
    surf = torch.from_numpy(surface_nodes(NB, dim)).to(pools.device)
    real = pools >= 0
    r = pools.long().clamp(min=0)
    b = r // K
    s = off + (r % K)[..., None] * width + torch.arange(width, device=pools.device)
    return b, s, b[..., None] * N3p + surf[s], real


def bit_set(words, row, k):
    """Bit k of row `row` of a packed [rows, words] int32 bit table."""
    return ((words[row, k >> 5] >> (k & 31)) & 1).bool()


def dss_surface_plain(v, face_pairs, edge_pools, corner_pools, valid_bits, hole_bricks,
                      hole_bits, NB):
    """Plain PyTorch version on the same work lists: gather each pool's
    copies, sum them in canonical order, write the sum to the valid copies
    and 0 to the invalid ones, then zero the padding and the holes off the
    surface. Updates v in place and returns it (a component axis: each
    component so)."""
    if v.dim() == 3:
        for vc in v:
            dss_surface_plain(vc, face_pairs, edge_pools, corner_pools, valid_bits, hole_bricks,
                              hole_bits, NB)
        return v
    flat = v.view(-1)
    dim = _build.brick_dim(NAME, NB, v.shape[1])
    writes = []
    for pools, kind in zip((face_pairs, edge_pools, corner_pools), POOL_KINDS):
        b, s, node, real = pool_positions(pools, kind, NB, v.shape[1])
        vals = flat[node]
        tot = vals[:, 0]
        for c in range(1, vals.shape[1]):
            tot = torch.where(real[:, c, None], tot + vals[:, c], tot)
        new = torch.where(bit_set(valid_bits, b[..., None], s), tot[:, None], 0.0)
        writes.append((node[real], new[real]))
    for node, new in writes:  # the pools are disjoint: every read came first
        flat[node] = new
    N3 = NB**dim
    v[:, N3:] = 0.0
    if hole_bricks.numel():
        rows = hole_bricks.long()
        k = torch.arange(N3, device=v.device)
        hole = bit_set(hole_bits, torch.arange(len(rows), device=v.device)[:, None], k)
        v[rows, :N3] = torch.where(hole, 0.0, v[rows, :N3])
    return v


_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
          ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7
         + [ctypes.c_void_p])
SUPPORTED_NB = (11, 13, 15, 17)  # NB = B p + 1 of the brick size rule, 3-D
SUPPORTED_NB_2D = (17, 33, 41, 49)  # and 2-D


def dss_surface(v, face_pairs, edge_pools, corner_pools, valid_bits, hole_bricks, hole_bits,
                NB):
    """v [nb, N3p] or [k, nb, N3p], updated in place and returned;
    face_pairs [*, 2], edge_pools [*, <= 8], corner_pools [*, <= 8],
    valid_bits [nb, *], hole_bricks [h], hole_bits [h, *], all int32."""
    if v.device.type == "cpu":
        return dss_surface_plain(v, face_pairs, edge_pools, corner_pools, valid_bits,
                                 hole_bricks, hole_bits, NB)
    tables = dict(face_pairs=face_pairs, edge_pools=edge_pools, corner_pools=corner_pools,
                  valid_bits=valid_bits, hole_bricks=hole_bricks, hole_bits=hole_bits)
    dev = _build.check_cuda(NAME, v.dtype, v=v, **tables)
    k = _build.rhs_axis(NAME, v, 2)[0]
    nb, N3p = v.shape[-2:]
    dim = _build.brick_dim(NAME, NB, N3p)
    M, N3 = NB - 2, NB**dim
    n_surf = sum(K * width for K, width, _ in surface_blocks(NB, dim).values())
    if NB not in (SUPPORTED_NB if dim == 3 else SUPPORTED_NB_2D):
        raise ValueError(f"{NAME}: no {dim}-D instance at NB={NB}")
    for key, t in tables.items():
        dims = 1 if key == "hole_bricks" else 2
        if t.dtype != torch.int32 or t.dim() != dims:
            raise ValueError(f"{NAME}: {key} must be int32 with {dims} dims, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if face_pairs.shape[1] != 2 or edge_pools.shape[1] > 8 or corner_pools.shape[1] > 2**dim:
        raise ValueError(f"{NAME}: pools hold 2 face, <= 8 edge and <= {2**dim} corner copies")
    if dim == 2 and edge_pools.shape[0]:
        raise ValueError(f"{NAME}: a 2-D brick has no edge pools")
    if valid_bits.shape[0] != nb or 32 * valid_bits.shape[1] < n_surf:
        raise ValueError(f"{NAME}: valid_bits must hold a bit per surface node of each brick")
    if hole_bits.shape[0] != hole_bricks.shape[0] or 32 * hole_bits.shape[1] < N3:
        raise ValueError(f"{NAME}: hole_bits must hold a bit per node of each hole brick")
    if N3p < N3 or nb * N3p > np.iinfo(np.int32).max:
        raise ValueError(f"{NAME}: v must be [nb, >= {N3}] with int32 node indices")
    fn = _build.function(NAME, f"{NAME}_{_build.suffix(v.dtype)}", _ARGS)
    _build.launch(NAME, fn, dev, _build.ptr(v), _build.ptr(face_pairs), face_pairs.shape[0],
                  _build.ptr(edge_pools), edge_pools.shape[0], edge_pools.shape[1],
                  _build.ptr(corner_pools), corner_pools.shape[0], corner_pools.shape[1],
                  _build.ptr(valid_bits), valid_bits.shape[1], _build.ptr(hole_bricks),
                  _build.ptr(hole_bits), hole_bits.shape[0], hole_bits.shape[1], nb, NB, N3p, k,
                  dim)
    dss_surface.launches += 1
    return v


dss_surface.launches = 0


def moved_nodes(v, face_pairs, edge_pools, corner_pools, valid_bits, hole_bricks, hole_bits,
                NB):
    """The nodes of v that the function must move in place: ((read, group),
    (written, group)), flat indices into v and the surface block each lies
    in (face f, 6 + edge, 18 + corner; 26 for a hole, 27 for padding). Every
    copy of a pool of two or more copies is read and written; a pool of one
    copy is written (0) only where it is invalid, as is every hole or
    padding node off the surface; interior nodes and valid unshared copies
    do not move."""
    nb, N3p = v.shape
    dim = _build.brick_dim(NAME, NB, N3p)
    N3, dev = NB**dim, v.device
    blocks = surface_blocks(NB, dim)
    block = torch.cat([g0 + torch.arange(blocks[kind][0]).repeat_interleave(blocks[kind][1])
                       for kind, g0 in zip(POOL_KINDS, (0, 6, 18))]).to(dev)
    read, written = [], []
    for pools, kind in zip((face_pairs, edge_pools, corner_pools), POOL_KINDS):
        b, s, node, real = pool_positions(pools, kind, NB, N3p)
        shared = real & (real.sum(dim=1, keepdim=True) > 1)
        lone = (real & ~shared)[..., None] & ~bit_set(valid_bits, b[..., None], s)
        read.append((node[shared].reshape(-1), block[s[shared]].reshape(-1)))
        written += [read[-1], (node[lone], block[s[lone]])]
    k = torch.arange(N3, device=dev)
    rows = hole_bricks.long()
    hole = bit_set(hole_bits, torch.arange(len(rows), device=dev)[:, None], k)
    holes = (rows[:, None] * N3p + k)[hole]
    pad = (torch.arange(nb, device=dev)[:, None] * N3p + torch.arange(N3, N3p, device=dev))
    written += [(holes, torch.full_like(holes, 26)), (pad.reshape(-1), torch.full_like(
        pad.reshape(-1), 27))]
    cat = lambda parts: tuple(torch.cat(t) for t in zip(*parts))
    return cat(read), cat(written)


def _table_bytes(tables):
    return sum(4 * t.numel() for t in tables if isinstance(t, torch.Tensor))


def bytes_and_flops(v, *tables):
    """Least traffic of the function in place on v (v is a temporary of the
    vmult), in words: the nodes of ``moved_nodes`` read and written once,
    and the work lists and bit tables at the encoding the kernel reads
    (validity one bit per surface copy, holes one bit per node of a hole
    brick). One add per extra copy of each pool node, counted from the
    lists. ``tables``: dss_surface's arguments after v. A component axis
    moves each component's nodes and reads the tables once."""
    k = v.shape[0] if v.dim() == 3 else 1
    (read, _), (written, _) = moved_nodes(v[0] if v.dim() == 3 else v, *tables)
    face_pairs, edge_pools, corner_pools, NB = tables[0], tables[1], tables[2], tables[-1]
    nbytes = k * (read.numel() + written.numel()) * v.element_size() + _table_bytes(tables)
    extra = lambda t: int(((t >= 0).sum(dim=1) - 1).sum())
    dim = _build.brick_dim(NAME, NB, v.shape[-1])
    flops = (extra(face_pairs) * (NB - 2) ** (dim - 1) + extra(edge_pools) * (NB - 2)
             + extra(corner_pools))
    return nbytes, k * flops


def sector_bytes(v, *tables, apart=False):
    """The same traffic with v's nodes counted in 32-byte sectors, each
    sector read once and written once: what the function moves in this
    layout, where x is the fastest axis, so a node of an x-face shares its
    sector only with the node across the next row, which lies on the brick's
    other x-face (brick rows start on a sector boundary). apart: a sector
    is paid once for each surface block that touches it, as when the
    blocks of a brick (its two x-faces above all) are not touched
    together."""
    total = _table_bytes(tables)
    for nodes, group in moved_nodes(v, *tables):
        key = nodes * v.element_size() // 32
        total += 32 * torch.unique(key * 32 + group if apart else key).numel()
    return total
