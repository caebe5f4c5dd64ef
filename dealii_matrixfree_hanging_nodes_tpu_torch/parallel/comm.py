"""The collectives of the distributed engines on ``torch.distributed``: the
port's counterpart of the ``jax.lax`` collectives that the reference calls
inside ``shard_map`` (all_gather, psum_scatter, all_to_all, psum,
axis_index). Each function takes the process group its ranks share; ranks
are numbered in the group, and a collective's blocks are rank-major in that
order, as the reference's tiled collectives over a mesh axis are.

comm=False gives the reference's no-communication ablation
(benchmark_02.cc:204-209) in the reference's own identity forms: the local
block tiled in place of a gather (distributed.py:234,
bricks_distributed.py:1067-1068), the leading block of a sum in place of its
scatter, ``recv = send`` for an all_to_all (bricks_distributed.py:893-894,
948-949) and no sum at all for a psum. Those forms run as plain PyTorch on
the rank's device; the collectives are the backend's (NCCL on the card,
gloo on the CPU).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["rank", "size", "all_gather", "psum_scatter", "all_to_all", "psum", "sm_groups",
           "rank_device", "default_group"]

# the tensor forms of all_gather / reduce_scatter (PyTorch 2.13 renamed them *_single)
_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def rank(group=None) -> int:
    """This process's rank in the group (the reference's ``axis_index``)."""
    return dist.get_rank(group)


def size(group=None) -> int:
    return dist.get_world_size(group)



def all_gather(x: torch.Tensor, group=None, comm: bool = True) -> torch.Tensor:
    """``jax.lax.all_gather(x, tiled=True)``: every rank's x, rank-major along
    axis 0, a new tensor [R * x.shape[0], ...]; comm=False tiles the local x
    R times (``jnp.tile``)."""
    R = size(group)
    if not comm:
        return x.repeat(R, *([1] * (x.dim() - 1)))
    out = torch.empty((R * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _gather(out, x.contiguous(), group=group)
    return out


def psum_scatter(x: torch.Tensor, group=None, comm: bool = True) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, scatter_dimension=0, tiled=True)``: block r
    of the ranks' summed x (x.shape[0] a multiple of R), a new tensor;
    comm=False: the leading block of the local x (``contrib[:n]``)."""
    R = size(group)
    n = x.shape[0] // R
    if x.shape[0] != n * R:
        raise ValueError(f"psum_scatter: {x.shape[0]} rows do not split over {R} ranks")
    if not comm:
        return x[:n]
    out = torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _reduce_scatter(out, x.contiguous(), group=group)
    return out


def all_to_all(send: torch.Tensor, group=None, comm: bool = True) -> torch.Tensor:
    """``jax.lax.all_to_all(send, split_axis=0, concat_axis=0, tiled=False)``
    on send [R, m]: row s goes to rank s, and row s of the result came from
    rank s (equal splits), a new tensor; comm=False returns send (``recv =
    send``)."""
    if send.shape[0] != size(group):
        raise ValueError(f"all_to_all: {send.shape[0]} rows for {size(group)} ranks")
    if not comm:
        return send
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send.contiguous(), group=group)
    return recv


def psum(x: torch.Tensor, group=None, comm: bool = True) -> torch.Tensor:
    """``jax.lax.psum``: the ranks' x summed, in place on x (contiguous);
    comm=False leaves x as it is."""
    if comm:
        if not x.is_contiguous():
            raise ValueError("psum: x must be contiguous (the sum is in place)")
        dist.all_reduce(x, group=group)
    return x


def sm_groups(sm: int, group=None):
    """The two-stage exchange's groups over the R ranks of `group` (the
    reference's (nodes x sm) mesh ``devices.reshape(-1, sm)``: rank = node *
    sm + j): (intra, inter) of this process, intra the sm ranks of its node,
    inter the ranks of its j across the nodes. Every process creates every
    group, in the same order, as ``new_group`` requires."""
    R = size(group)
    if sm <= 0 or R % sm:
        raise ValueError(f"sm_group_size {sm} does not divide {R} ranks")
    ranks = dist.get_process_group_ranks(group) if group is not None else list(range(R))
    me = rank(group)
    intra = inter = None
    for node in range(R // sm):
        g = dist.new_group([ranks[node * sm + j] for j in range(sm)])
        if me // sm == node:
            intra = g
    for j in range(sm):
        g = dist.new_group([ranks[node * sm + j] for node in range(R // sm)])
        if me % sm == j:
            inter = g
    return intra, inter


def rank_device(device=None) -> torch.device:
    """A rank's device: the card of its ``LOCAL_RANK`` (0 where unset) unless
    the caller names another; without a card and without a device, raises
    (the port runs on the card unless asked for the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the plain "
                           "PyTorch versions on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def default_group(group=None):
    """group, or the WORLD group of an initialised process group."""
    if group is not None:
        return group
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call init_process_group "
                           "(nccl on the card, gloo on the CPU) or pass group=")
    return dist.group.WORLD
