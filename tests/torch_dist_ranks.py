"""Rank workers of the distributed engines' CPU tests: ``run_ranks(R, cases,
tmp_path)`` starts R processes (``torch.multiprocessing.spawn``) on a gloo
group (``init_method="file://..."``: no TCP ports, since the test workers
share the host), each with one PyTorch thread, runs every case on the
port's distributed engines at float64 on the CPU, and returns rank 0's
results (every output is gathered to every rank by the engines' own
collectives). This module imports no JAX: the reference runs in the test
process and the ranks get their inputs from seeds."""

from __future__ import annotations

import pickle

import numpy as np

TIMEOUT_S = 300


def _mf(geometry, dim, nref, p, deformed=False):
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    return mt.MatrixFree(mt.create_geometry(geometry, dim, nref), p, dtype=np.float64,
                         high_order_mapping=deformed)


def _weights(mf, w):
    from dealii_matrixfree_hanging_nodes_tpu_torch.parallel.partition import (
        hanging_nodes_weighting)

    return None if w is None else hanging_nodes_weighting(mf.constraints.masks != 0, w)


def index_case(geometry, dim, nref, p, deformed=False, exchange="allgather", weight=None,
               sm=None, comm=True, seed=0):
    """DistributedLaplace's vmult of default_rng(seed)'s normals, gathered;
    two calls' bits compared; the plan's statistics."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.parallel import DistributedLaplace

    mf = _mf(geometry, dim, nref, p, deformed)
    u = np.random.default_rng(seed).standard_normal(mf.n_dofs)
    op = DistributedLaplace(mf, device="cpu", weights=_weights(mf, weight), exchange=exchange,
                            sm_group_size=sm, perform_communication=comm)
    x = op.scatter_vector(u)
    y1, y2 = op.vmult(x), op.vmult(x)
    return dict(out=op.gather_vector(y1), same=bool((y1 == y2).all()), n_ghost=op.n_ghost,
                n_import=op.n_import, n_own_max=op.n_own_max,
                halo_max_pair=getattr(op.plan, "halo_max_pair", None))


def brick_case(geometry, dim, nref, p, deformed=False, exchange="halo", weight=None, comm=True,
               seed=0):
    """DistributedBrickLaplace's vmult of default_rng(seed)'s normals, read
    back as a DoF vector with the hanging DoFs zeroed; two calls' bits
    compared; the partition and the ghost statistics."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.parallel import DistributedBrickLaplace

    mf = _mf(geometry, dim, nref, p, deformed)
    u = np.random.default_rng(seed).standard_normal(mf.n_dofs)
    op = DistributedBrickLaplace(mf, device="cpu", weights=_weights(mf, weight),
                                 exchange=exchange, perform_communication=comm)
    x = op.from_dof_vector(u)
    y1, y2 = op.vmult(x), op.vmult(x)
    return dict(out=op.to_dof_vector(y1, zero_hanging=True), same=bool((y1 == y2).all()),
                n_ghost=op.n_ghost, n_import=op.n_import, rank_of_brick=op.plan.rank_of_brick)


def brick_cg_case(geometry, dim, nref, p, seed=2, max_iter=300):
    """CG on the distributed brick operator with the reduced-space group dot
    and the constants deflated (the reference's test_distributed_bricks_dot_
    and_cg): the solution as a DoF vector, the manufactured rhs and the final
    deflated residual's norm over the rhs's."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.parallel import DistributedBrickLaplace

    mf = _mf(geometry, dim, nref, p)
    x_true = np.random.default_rng(seed).standard_normal(mf.n_dofs)
    op = DistributedBrickLaplace(mf, device="cpu")
    ones = op.from_dof_vector(np.ones(mf.n_dofs))
    nn = op.dot(ones, ones)
    deflate = lambda v: v - (op.dot(ones, v) / nn) * ones
    b = deflate(op.vmult(op.from_dof_vector(x_true)))
    x = b * 0.0
    r = b
    d = r
    rs = op.dot(r, r)
    for _ in range(max_iter):
        Ad = op.vmult(d)
        alpha = rs / op.dot(d, Ad)
        x = x + alpha * d
        r = deflate(r - alpha * Ad)
        rs_new = op.dot(r, r)
        if float(rs_new) < 1e-26:
            break
        d = r + (rs_new / rs) * d
        rs = rs_new
    x_dof = op.to_dof_vector(x)
    r2 = deflate(b - op.vmult(op.from_dof_vector(x_dof)))
    return dict(x=x_dof, b=op.to_dof_vector(b, zero_hanging=True),
                rel_res=float(op.norm(r2) / op.norm(b)))


def gmg_case(nref, p, b):
    """The distributed GMG-preconditioned CG (the reference's
    test_distributed_gmg_cg_matches_single_chip) on the right-hand side b
    (the single-device reference's A x*): iterations and the solution."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.parallel import DistributedGMGPreconditioner

    dgmg = DistributedGMGPreconditioner("quadrant", 3, nref, p, device="cpu")
    dop = dgmg.fine_op
    xd, it, res = mt.solve_cg(dop, dop.scatter_vector(b), M=dgmg, tol=1e-10, max_iter=100,
                              dot=dop.dot)
    return dict(iters=it, x=dop.gather_vector(xd), res=res)


def transfer_case(nref, p, seed=4):
    """DistributedTransfer between quadrant levels nref-1 and nref:
    prolongate of a coarse vector and restrict of a fine one (both
    default_rng(seed)'s normals), gathered."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.parallel import (
        DistributedDirichletLaplace, DistributedTransfer)

    mfc, mff = (_mf("quadrant", 3, n, p) for n in (nref - 1, nref))
    opc, opf = (DistributedDirichletLaplace(mf, device="cpu") for mf in (mfc, mff))
    tr = DistributedTransfer(mfc, mff, opc, opf)
    rng = np.random.default_rng(seed)
    xc, xf = rng.standard_normal(mfc.n_dofs), rng.standard_normal(mff.n_dofs)
    return dict(prolongate=opf.gather_vector(tr.prolongate(opc.scatter_vector(xc))),
                restrict=opc.gather_vector(tr.restrict(opf.scatter_vector(xf))))


CASE_FNS = dict(index=index_case, brick=brick_case, brick_cg=brick_cg_case, gmg=gmg_case,
                transfer=transfer_case)


def _worker(rank, n_ranks, init_file, cases, out_file):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=n_ranks)
    try:
        results = {key: CASE_FNS[kind](**kw) for key, (kind, kw) in cases.items()}
        if rank == 0:
            with open(out_file, "wb") as fh:
                pickle.dump(results, fh)
    finally:
        dist.destroy_process_group()


def run_ranks(n_ranks: int, cases: dict, tmp_path) -> dict:
    """{key: (kind, kwargs)} -> {key: result} from n_ranks spawned gloo ranks
    (one spawn runs every case)."""
    import torch.multiprocessing as mp

    init_file, out_file = tmp_path / f"init-{n_ranks}", tmp_path / f"results-{n_ranks}.pkl"
    ctx = mp.start_processes(_worker, args=(n_ranks, str(init_file), cases, str(out_file)),
                             nprocs=n_ranks, join=False, start_method="spawn")
    for _ in range(TIMEOUT_S):
        if ctx.join(timeout=1):
            break
    else:
        for p in ctx.processes:
            p.kill()
        raise TimeoutError(f"{n_ranks} ranks did not finish in {TIMEOUT_S} s")
    with open(out_file, "rb") as fh:
        return pickle.load(fh)
