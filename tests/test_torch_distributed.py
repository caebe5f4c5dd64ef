"""The port's DistributedLaplace (the index engine over ranks on
torch.distributed) against the JAX package, float64 on the CPU: spawned
gloo ranks (R = 1, 2, 4; one spawn per R runs every case) against the
reference's single-chip LaplaceOperator and, for the no-communication
ablation, the reference's DistributedLaplace at the same R (relative 1e-12:
sums across ranks run in the backend's order); the host plan at R=8
against the reference's tables, and halo_pack's plain version against the
reference's halo expressions on them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dealii_matrixfree_hanging_nodes_tpu as ref
from dealii_matrixfree_hanging_nodes_tpu.matrix_free import MatrixFree as RefMatrixFree
from dealii_matrixfree_hanging_nodes_tpu.models.laplace import LaplaceOperator as RefLaplace
from dealii_matrixfree_hanging_nodes_tpu.parallel.distributed import (
    DistributedLaplace as RefDistributed)
from dealii_matrixfree_hanging_nodes_tpu.parallel.partition import hanging_nodes_weighting

import dealii_matrixfree_hanging_nodes_tpu_torch as mt
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import halo_pack
from dealii_matrixfree_hanging_nodes_tpu_torch.parallel.distributed import DistributedLaplacePlan
from torch_dist_ranks import run_ranks
from torch_port_cases import RTOL, one_torch_thread, release_module_memory  # noqa: F401

RANKS = (1, 2, 4)
# (geometry, dim, nref, p, deformed) of the reference's test_parallel cases and a 2-D one
MESHES = {"q3": ("quadrant", 3, 3, 2, False), "q3d": ("quadrant", 3, 3, 2, True),
          "q2": ("quadrant", 2, 4, 3, False)}
# case -> (mesh, keyword arguments of DistributedLaplace)
CASES = {
    "allgather": ("q3", {}),
    "halo": ("q3", dict(exchange="halo")),
    "deformed-allgather": ("q3d", {}),
    "deformed-halo": ("q3d", dict(exchange="halo")),
    "weighted": ("q3", dict(weight=7.5)),
    "2d-allgather": ("q2", {}),
    "2d-halo": ("q2", dict(exchange="halo")),
    "sm2": ("q3", dict(sm=2)),
    "no-comm": ("q3", dict(comm=False)),
}
PARAMS = [(R, c) for R in RANKS for c in CASES if not (c == "sm2" and R == 1)]


def case_seed(case):
    return 1 if case == "weighted" else 0


@functools.lru_cache(maxsize=None)
def ref_mf(mesh):
    g, dim, nref, p, deformed = MESHES[mesh]
    return RefMatrixFree(ref.create_geometry(g, dim, nref), p, dtype=np.float64,
                         high_order_mapping=deformed)


@functools.lru_cache(maxsize=None)
def ref_vmult(mesh, seed):
    mf = ref_mf(mesh)
    src = np.random.default_rng(seed).standard_normal(mf.n_dofs)
    return np.asarray(RefLaplace(mf).vmult(src))


@functools.lru_cache(maxsize=None)
def ref_no_comm(mesh, R):
    """The reference's ablation output at R devices (its collectives elided)."""
    mf = ref_mf(mesh)
    src = np.random.default_rng(0).standard_normal(mf.n_dofs)
    dop = RefDistributed(mf, devices=jax.devices()[:R], perform_communication=False)
    return dop.gather_vector(dop.vmult(dop.scatter_vector(src)))


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    cache = {}

    def get(R):
        if R not in cache:
            cases = {}
            for case, (mesh, kw) in CASES.items():
                if case == "sm2" and R == 1:
                    continue
                g, dim, nref, p, deformed = MESHES[mesh]
                cases[case] = ("index", dict(geometry=g, dim=dim, nref=nref, p=p,
                                             deformed=deformed, seed=case_seed(case), **kw))
            cache[R] = run_ranks(R, cases, tmp_path_factory.mktemp(f"ranks{R}"))
        return cache[R]

    return get


@pytest.mark.parametrize("R,case", PARAMS, ids=[f"R{R}-{c}" for R, c in PARAMS])
def test_distributed_laplace_matches_reference(rank_results, R, case):
    res = rank_results(R)[case]
    mesh = CASES[case][0]
    want = ref_no_comm(mesh, R) if case == "no-comm" else ref_vmult(mesh, case_seed(case))
    err = np.abs(res["out"] - want).max() / np.abs(want).max()
    assert err < RTOL, (R, case, err)
    assert res["same"]  # two calls at fixed R and backend: bit-identical
    if case == "halo":
        assert res["halo_max_pair"] < res["n_own_max"]
    if case == "weighted" and R > 1:
        assert res["n_ghost"].sum() > 0 and res["n_import"].sum() > 0


# ---- the host plan at R=8 against the reference's tables (no ranks) ----------
@functools.lru_cache(maxsize=None)
def plans(mesh, exchange, weighted=False):
    r_mf = ref_mf(mesh)
    g, dim, nref, p, deformed = MESHES[mesh]
    mf = mt.MatrixFree(mt.create_geometry(g, dim, nref), p, dtype=np.float64,
                       high_order_mapping=deformed)
    w = hanging_nodes_weighting(mf.constraints.masks != 0, 7.5) if weighted else None
    return (RefDistributed(r_mf, devices=jax.devices()[:8], weights=w, exchange=exchange),
            DistributedLaplacePlan(mf, 8, w, exchange))


PLAN_CASES = [("q3", "allgather", False), ("q3", "halo", False), ("q3d", "halo", False),
              ("q3", "allgather", True), ("q2", "halo", False)]


@pytest.mark.parametrize("mesh,exchange,weighted", PLAN_CASES,
                         ids=[f"{m}-{e}{'-weighted' if w else ''}" for m, e, w in PLAN_CASES])
def test_plan_tables_match_reference_at_8(mesh, exchange, weighted):
    rd, plan = plans(mesh, exchange, weighted)
    for key in ("rank_of_cell", "n_own", "padded_id", "n_ghost", "n_import",
                "local_index_of_cell"):
        np.testing.assert_array_equal(getattr(plan, key), getattr(rd, key), err_msg=key)
    assert (plan.n_own_max, plan.n_padded, plan.n_cell_max) == (
        rd.n_own_max, rd.n_padded, rd.n_cell_max)
    for key in ("dofmap_r", "masks_r", "geo_r"):
        np.testing.assert_array_equal(getattr(plan, key), np.asarray(getattr(rd, key)),
                                      err_msg=key)
    if exchange == "halo":
        assert plan.halo_max_pair == rd.halo_max_pair
        assert plan.halo["local_size"] == rd.halo["local_size"]
        for key in ("send_idx", "send_valid", "dm_local"):
            np.testing.assert_array_equal(plan.halo[key], np.asarray(rd.halo[key]), err_msg=key)


@pytest.mark.parametrize("mesh", ["q3", "q2"])
def test_halo_pack_plain_matches_reference_expressions(mesh):
    """halo_pack's pack, set and add (plain versions, on each rank's R=8
    tables) against local_vmult_halo's expressions (distributed.py:
    265-284): src_own[send_idx] * send_valid, [src_own; recv] and
    own.at[send_idx].add(back * send_valid)."""
    rd, plan = plans(mesh, "halo")
    R, n = plan.n_ranks, plan.n_own_max
    rng = np.random.default_rng(3)
    h = rd.halo
    for r in range(R):
        t = plan.rank_tables(r)
        src = rng.standard_normal(n)
        recv = rng.standard_normal((R, plan.halo_max_pair))
        send_idx, send_valid = np.asarray(h["send_idx"][r]), np.asarray(h["send_valid"][r])
        want = np.asarray(jnp.asarray(src)[send_idx] * send_valid)
        got = halo_pack.halo_pack(torch.from_numpy(src), torch.from_numpy(t["send_idx"]),
                                  torch.from_numpy(t["send_valid"]), mode="pack")
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.concatenate([src, recv.reshape(-1)])
        got = halo_pack.halo_pack(torch.from_numpy(src), torch.from_numpy(recv),
                                  torch.from_numpy(t["set_map"]), mode="set")
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(jnp.asarray(src).at[send_idx.reshape(-1)].add(
            (recv * send_valid).reshape(-1)))
        got = halo_pack.halo_pack(torch.from_numpy(src.copy()), torch.from_numpy(recv),
                                  *(torch.from_numpy(a) for a in t["add"]), mode="add")
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * np.abs(want).max())
