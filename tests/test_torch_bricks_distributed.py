"""The port's DistributedBrickLaplace (the brick engine over ranks on
torch.distributed) against the JAX package, float64 on the CPU: spawned
gloo ranks (R = 1, 2, 4; one spawn per R runs every case) against the
reference's single-chip BrickLaplaceMM (its distributed engine equals it to
1e-12, tests/test_parallel.py) and, for the no-communication ablation,
against the reference's DistributedBrickLaplace at the same R (relative
1e-12: sums across ranks run in the backend's order); the host plan at R=8
against the reference's tables; dss_pools', halo_pack's and chain_halo's
plain versions against the reference's DSS, chain exchange and chain
functions (run under the reference's own shard_map on 8 CPU devices) on
those tables."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import dealii_matrixfree_hanging_nodes_tpu as ref
from dealii_matrixfree_hanging_nodes_tpu.bricks import BrickLaplaceMM as RefBrick
from dealii_matrixfree_hanging_nodes_tpu.matrix_free import MatrixFree as RefMatrixFree
from dealii_matrixfree_hanging_nodes_tpu.parallel.bricks_distributed import (
    DistributedBrickLaplace as RefDistributedBrick)
from dealii_matrixfree_hanging_nodes_tpu.parallel.partition import hanging_nodes_weighting

import dealii_matrixfree_hanging_nodes_tpu_torch as mt
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import chain_halo, dss_pools, halo_pack
from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.dss_surface import surface_nodes
from dealii_matrixfree_hanging_nodes_tpu_torch.parallel.bricks_distributed import (
    DistributedBrickPlan)
from torch_dist_ranks import run_ranks
from torch_port_cases import RTOL, one_torch_thread, release_module_memory  # noqa: F401

RANKS = (1, 2, 4)
# (geometry, dim, nref, p, deformed): the reference's test_parallel meshes
MESHES = {"q3p2": ("quadrant", 3, 3, 2, False), "q3p4": ("quadrant", 3, 3, 4, False),
          "q2p3": ("quadrant", 2, 4, 3, False), "a4p1": ("annulus", 3, 4, 1, False),
          "s2p2": ("step", 2, 3, 2, False), "q3p2d": ("quadrant", 3, 3, 2, True),
          "q4p3": ("quadrant", 3, 4, 3, False), "a5p2": ("annulus", 3, 5, 2, False)}
CASES = {
    **{m: (m, {}) for m in ("q3p2", "q3p4", "q2p3", "a4p1", "s2p2")},
    "deformed-halo": ("q3p2d", {}),
    "deformed-replicated": ("q3p2d", dict(exchange="replicated")),
    "weighted": ("q3p2", dict(weight=5.0, seed=1)),
    "unweighted": ("q3p2", dict(seed=1)),
    "q4p3-halo": ("q4p3", dict(seed=3)),
    "q4p3-replicated": ("q4p3", dict(exchange="replicated", seed=3)),
    "a5p2-halo": ("a5p2", dict(seed=3)),
    "a5p2-replicated": ("a5p2", dict(exchange="replicated", seed=3)),
    "no-comm-halo": ("q3p2", dict(comm=False)),
    "no-comm-replicated": ("q3p2", dict(exchange="replicated", comm=False)),
}
# the reference's replicated ablation is compared at R = 1, 2 (its halo one at every R)
PARAMS = [(R, c) for R in RANKS for c in CASES if (R, c) != (4, "no-comm-replicated")]


@functools.lru_cache(maxsize=None)
def ref_mf(mesh):
    g, dim, nref, p, deformed = MESHES[mesh]
    return RefMatrixFree(ref.create_geometry(g, dim, nref), degree=p, dtype=np.float64,
                         high_order_mapping=deformed)


@functools.lru_cache(maxsize=None)
def ref_single(mesh, seed):
    mf = ref_mf(mesh)
    u = np.random.default_rng(seed).standard_normal(mf.n_dofs)
    mm = RefBrick(mf)
    return mm.to_dof_vector(mm.vmult(mm.from_dof_vector(u)), zero_hanging=True)


@functools.lru_cache(maxsize=None)
def ref_no_comm(mesh, R, exchange):
    mf = ref_mf(mesh)
    u = np.random.default_rng(0).standard_normal(mf.n_dofs)
    dop = RefDistributedBrick(mf, devices=jax.devices()[:R], exchange=exchange,
                              perform_communication=False)
    return dop.to_dof_vector(dop.vmult(dop.from_dof_vector(u)), zero_hanging=True)


def case_args(case):
    mesh, kw = CASES[case]
    g, dim, nref, p, deformed = MESHES[mesh]
    return dict(geometry=g, dim=dim, nref=nref, p=p, deformed=deformed, **kw)


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    cache = {}

    def get(R):
        if R not in cache:
            cases = {c: ("brick", case_args(c)) for c in CASES}
            if R > 1:
                cases["cg"] = ("brick_cg", dict(geometry="quadrant", dim=3, nref=3, p=2))
            cache[R] = run_ranks(R, cases, tmp_path_factory.mktemp(f"ranks{R}"))
        return cache[R]

    return get


@pytest.mark.parametrize("R,case", PARAMS, ids=[f"R{R}-{c}" for R, c in PARAMS])
def test_distributed_brick_matches_reference(rank_results, R, case):
    res = rank_results(R)[case]
    mesh, kw = CASES[case]
    if not kw.get("comm", True):
        want = ref_no_comm(mesh, R, kw.get("exchange", "halo"))
    else:
        want = ref_single(mesh, kw.get("seed", 0))
    err = np.abs(res["out"] - want).max() / np.abs(want).max()
    assert err < RTOL, (R, case, err)
    assert res["same"]  # two calls at fixed R and backend: bit-identical


@pytest.mark.parametrize("R", [2, 4])
def test_ghost_statistics_present(rank_results, R):
    res = rank_results(R)["unweighted"]
    assert res["n_ghost"].sum() > 0 and res["n_import"].sum() > 0


@pytest.mark.parametrize("mesh", ["q4p3", "a5p2"])
def test_halo_ghost_volume_below_replicated(rank_results, mesh):
    """At R=4 the neighbour-wise exchange moves well under a third of the
    replicated exchange's ghost values, as the reference's test asserts."""
    res = rank_results(4)
    halo, rep = res[f"{mesh}-halo"], res[f"{mesh}-replicated"]
    assert rep["n_ghost"].sum() > 0
    assert halo["n_ghost"].sum() < rep["n_ghost"].sum() / 3


@pytest.mark.parametrize("R", [2, 4])
def test_distributed_brick_dot_and_cg(rank_results, R):
    """CG with the group's reduced-space dot converges (the reference's
    test_distributed_bricks_dot_and_cg), and its solution solves the system
    through the reference's single-chip operator."""
    res = rank_results(R)["cg"]
    assert res["rel_res"] < 1e-10
    mf = ref_mf("q3p2")
    mm = RefBrick(mf)
    ax = mm.to_dof_vector(mm.vmult(mm.from_dof_vector(res["x"])), zero_hanging=True)
    assert np.abs(ax - res["b"]).max() < 1e-9 * np.abs(res["b"]).max()


# ---- the host plan at R=8 against the reference's tables (no ranks) ----------
@functools.lru_cache(maxsize=None)
def plans(mesh, exchange, weighted=False):
    g, dim, nref, p, deformed = MESHES[mesh]
    mf = mt.MatrixFree(mt.create_geometry(g, dim, nref), p, dtype=np.float64,
                       high_order_mapping=deformed)
    w = hanging_nodes_weighting(mf.constraints.masks != 0, 5.0) if weighted else None
    return (RefDistributedBrick(ref_mf(mesh), devices=jax.devices()[:8], weights=w,
                                exchange=exchange),
            DistributedBrickPlan(mf, 8, w, exchange))


def assert_tree_equal(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_tree_equal(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


PLAN_CASES = [("q3p2", "halo", False), ("q3p2", "replicated", False), ("a5p2", "halo", False),
              ("q3p2d", "halo", False), ("q2p3", "halo", False), ("q3p2", "halo", True)]


def test_weighted_repartition_moves_bricks():
    """At R=8 (the reference's test) the weights change the partition; the
    ranks' results with weights match the reference above."""
    assert not np.array_equal(plans("q3p2", "halo", True)[1].rank_of_brick,
                              plans("q3p2", "halo")[1].rank_of_brick)


@pytest.mark.parametrize("mesh,exchange,weighted", PLAN_CASES,
                         ids=[f"{m}-{e}{'-weighted' if w else ''}" for m, e, w in PLAN_CASES])
def test_plan_tables_match_reference_at_8(mesh, exchange, weighted):
    rd, plan = plans(mesh, exchange, weighted)
    for key in ("rank_of_brick", "rank_of_cell", "nb_r", "slab_brick", "slab_valid",
                "slabpos_of_brick", "sub_ids_r", "chain_src_r", "hn_sub_g", "n_ghost",
                "n_import"):
        np.testing.assert_array_equal(getattr(plan, key), getattr(rd, key), err_msg=key)
    assert (plan.nb_max, plan.n_sub_max, plan.n_chain_max, plan.has_chain) == (
        rd.nb_max, rd.n_sub_max, rd.n_chain_max, rd.has_chain)
    for name in ("pools_f", "pools_c", "pools_e"):
        if getattr(rd, name) is not None:
            assert_tree_equal(getattr(plan, name), getattr(rd, name), name)
    d = rd._dev
    for key, got in (("geo", plan.geo_r), ("node_valid", plan.node_valid_r),
                     ("geo_cell_sub", plan.geo_cell_sub_r), ("absent_keep", plan.absent_keep_r),
                     ("chain_valid", plan.chain_valid_r),
                     ("fill_invden", plan.fill_invden_r.astype(rd.mf.dtype))):
        np.testing.assert_array_equal(got, d[key], err_msg=key)
    assert_tree_equal({k: plan.rep[k] for k in rd._rep}, rd._rep, "rep")
    if exchange == "halo":
        assert plan.halo_ntouch == rd._halo_ntouch and plan.halo_nflat == rd._halo_nflat
        for key in [k for k in d if k.endswith("_loc")] + ["dsend_idx", "dsend_valid"]:
            np.testing.assert_array_equal(plan.halo[key], d[key], err_msg=key)
        if rd.has_chain:
            for tag in ("fold", "fill"):
                assert plan.halo[tag]["n_need"] == getattr(rd, f"_halo_n_need_{tag}")
                got = {k: v for k, v in plan.halo[tag].items() if k != "n_need"}
                assert_tree_equal(got, d[tag], tag)
    if rd._deformed:
        for r in range(8):
            t = plan.rank_tables(r)
            C = plan.bs.B ** plan.bs.dim
            rows = (t["perm"][:, None] * C + np.arange(C)).reshape(-1)
            np.testing.assert_array_equal(t["metric"], d["Gq"][r][rows], err_msg=f"Gq {r}")


# ---- the new kernels' plain versions against the reference's expressions -----
def shard_call(rd, fn, *args):
    """fn(per-rank args) under the reference's shard_map over its 8 devices."""
    spec = P(rd.axis_name)
    body = lambda *a: fn(*[jax.tree.map(lambda x: x[0], x) for x in a])[None]
    return np.asarray(jax.jit(jax.shard_map(body, mesh=rd.mesh, in_specs=(spec,) * len(args),
                                            out_specs=spec))(*args))


def slabs_with_surface(plan, surf, rng):
    """Each rank's slab in its device order, random, its bricks' surface
    nodes holding surf[r] (the reference's slab order)."""
    NB, dim = plan.bs.NB, plan.bs.dim
    sn = surface_nodes(NB, dim)
    out = []
    for r in range(plan.n_ranks):
        perm = plan.rank_order(r)
        v = rng.standard_normal((plan.nb_max, plan.const["N3p"]))
        v[:, sn] = surf[r][perm]
        out.append((torch.from_numpy(v), perm))
    return out, sn


@pytest.mark.parametrize("mesh,exchange", [("q3p2", "halo"), ("q3p2", "replicated"),
                                           ("q2p3", "halo"), ("q2p3", "replicated")])
def test_dss_pools_and_halo_pack_match_reference_dss(mesh, exchange):
    """dss_pools (accumulate, the exchange by halo_pack or a sum, read) on
    every rank's R=8 tables against the reference's _dss_local_halo /
    _dss_local run under its shard_map: the valid surface nodes equal, the
    invalid nodes zero."""
    rd, plan = plans(mesh, exchange)
    R = plan.n_ranks
    rng = np.random.default_rng(5)
    n_surf = len(surface_nodes(plan.bs.NB, plan.bs.dim))
    surf = rng.standard_normal((R, plan.nb_max, n_surf)) * plan.slab_valid[..., None]
    d, _, _ = rd._stage()
    fn = rd._dss_local_halo if exchange == "halo" else rd._dss_local
    want = shard_call(rd, fn, jnp.asarray(surf), d)
    slabs, sn = slabs_with_surface(plan, surf, rng)
    tabs = [plan.rank_tables(r) for r in range(R)]
    i32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32))
    pools = []
    for (v, _), t in zip(slabs, tabs):
        s = t["dss"]
        pools.append(dss_pools.dss_pools(v, i32(s["surf_node"]), i32(s["ent_off"]),
                                         i32(s["pool_off"]), i32(s["pool_ptr"]),
                                         i32(s["pool_src"]), s["n_slots"], mode="accumulate"))
    n_prefix = tabs[0]["dss"]["n_prefix"]
    if exchange == "replicated":
        total = sum(p[:n_prefix] for p in pools)
        for p in pools:
            p[:n_prefix] = total
    else:
        sends = [halo_pack.halo_pack(p, i32(t["dss_send"][0]), torch.from_numpy(t["dss_send"][1]),
                                     mode="pack") for p, t in zip(pools, tabs)]
        for r, (p, t) in enumerate(zip(pools, tabs)):
            recv = torch.stack([sends[s][r] for s in range(R)])
            dst, ptr, src, w = t["dss_add"]
            halo_pack.halo_pack(p, recv, i32(dst), i32(ptr), i32(src), torch.from_numpy(w),
                                mode="add")
    for r, ((v, perm), p, t) in enumerate(zip(slabs, pools, tabs)):
        s = t["dss"]
        dss_pools.dss_pools(v, p, i32(s["node_ent"]), i32(s["read_base"]), i32(t["valid_bits"]),
                            mode="read")
        valid = plan.node_valid_r[r][perm]
        got = v.numpy()
        vs = valid[:, sn]
        np.testing.assert_allclose(got[:, sn][vs], want[r][perm][vs], rtol=0,
                                   atol=RTOL * np.abs(want).max())
        assert not got[~valid].any()


# the annulus: multi-level chains across ranks, the need sets' stress case
@pytest.mark.parametrize("mesh,exchange", [("q3p2", "halo"), ("a5p2", "halo")])
def test_chain_exchange_and_chain_halo_match_reference(mesh, exchange):
    """halo_pack's pack and set against _chain_exchange (under the
    reference's shard_map), and chain_halo (the composed fold and fill)
    against _chain_fold_halo / _chain_fill_halo on each rank's need buffer."""
    rd, plan = plans(mesh, exchange)
    if not plan.has_chain:
        pytest.skip("no chain")
    R, ncm = plan.n_ranks, plan.n_chain_max
    n_loc = (plan.bs.p + 1) ** plan.bs.dim
    rng = np.random.default_rng(7)
    d, rep, _ = rd._stage()
    tabs = [plan.rank_tables(r) for r in range(R)]
    i32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32))
    for tag in ("fold", "fill"):
        n_need = getattr(rd, f"_halo_n_need_{tag}")
        block = rng.standard_normal((R, ncm, n_loc)) * plan.chain_valid_r
        want = shard_call(rd, lambda b, t: rd._chain_exchange(b, t, n_need), jnp.asarray(block),
                          d[tag])
        chain_fn = jax.jit(lambda b, t, rp, f=(rd._chain_fold_halo if tag == "fold"
                                               else rd._chain_fill_halo): f(b, t, rp, None))
        sends = [halo_pack.halo_pack(torch.from_numpy(block[r]), i32(t[tag]["send_idx"]),
                                     torch.from_numpy(t[tag]["send_valid"]), mode="pack")
                 for r, t in enumerate(tabs)]
        for r, t in enumerate(tabs):
            recv = torch.stack([sends[s][r] for s in range(R)])
            buf = halo_pack.halo_pack(torch.from_numpy(block[r]), recv, i32(t[tag]["set_map"]),
                                      mode="set").view(n_need + 1, n_loc)
            np.testing.assert_array_equal(buf.numpy(), want[r])
            t_r = jax.tree.map(lambda x: x[r], d[tag])
            ref_out = np.asarray(chain_fn(jnp.asarray(want[r]), t_r, rep))
            ptr, src, w = t[f"{tag}_map"]
            got = chain_halo.chain_halo(buf, i32(ptr), i32(src), torch.from_numpy(w))
            np.testing.assert_allclose(got.numpy(), ref_out, rtol=0,
                                       atol=RTOL * max(np.abs(ref_out).max(), 1.0))


@pytest.mark.parametrize("mesh", ["q3p2", "a5p2"])
def test_chain_halo_replicated_matches_reference_loops(mesh):
    """chain_halo on the gathered buffer with the replicated tables against
    the replicated step's level loops (bricks_distributed.py:1069-1081,
    1145-1156), written here as the reference writes them."""
    rd, plan = plans(mesh, "replicated")
    R, ncm = plan.n_ranks, plan.n_chain_max
    n_loc = (plan.bs.p + 1) ** plan.bs.dim
    rep = jax.tree.map(jnp.asarray, rd._rep)
    buf = np.random.default_rng(9).standard_normal((R * ncm, n_loc))
    buf *= plan.chain_valid_r.reshape(R * ncm, 1)
    b = jnp.asarray(buf)
    for lv in sorted(rd._levels, reverse=True):
        rows = [jnp.dot(jnp.take(b, g["fine"], axis=0), g["T"]) for g in rep["transfers"][lv]]
        coarse = [g["coarse"] for g in rep["transfers"][lv]]
        lz = rep["level_zero"][lv]
        zeroed = jnp.take(b, lz["lin"], axis=0) * lz["keep"]
        b = b.at[jnp.concatenate(coarse)].add(jnp.concatenate(rows, axis=0))
        b = b.at[lz["lin"]].set(zeroed)
    fold_want = np.asarray(b)
    c = jnp.asarray(buf)
    for lv in sorted(rd._levels):
        lz = rep["level_zero"][lv]
        c = c.at[lz["lin"]].set(jnp.take(c, lz["lin"], axis=0) * lz["keep"])
        rows = [jnp.dot(jnp.take(c, g["coarse"], axis=0), g["T"].T)
                for g in rep["transfers"][lv]]
        fine = [g["fine"] for g in rep["transfers"][lv]]
        c = c.at[jnp.concatenate(fine)].add(jnp.concatenate(rows, axis=0))
    fill_want = np.asarray(c)
    t = plan.rank_tables(0)
    for key, want in (("fold_map", fold_want), ("fill_map", fill_want)):
        ptr, src, w = t[key]
        got = chain_halo.chain_halo(torch.from_numpy(buf), torch.from_numpy(ptr),
                                    torch.from_numpy(src), torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * np.abs(want).max())
