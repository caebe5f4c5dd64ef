"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
2. build the 13 CUDA kernels from ``dealii_matrixfree_hanging_nodes_tpu_torch/csrc``
   (one nvcc per source, all at once), with each kernel's registers and spills,
   refill_update's and corr_compact's stack frames (refill_update must have none), and
   brick_apply's shared memory and blocks per SM at each degree;
3. set up the bench workload: quadrant mesh, nref=7, degree 4, float32, on the card,
   print the sizes of dss_surface's work lists and the subset cell rows by kind,
   and on the host hold the kernels'
   composed chain lists at this mesh against the dense one-hot chain, stage by
   stage (float64, relative tolerance 1e-12);
4. hold each kernel against its plain PyTorch version on the card at the
   shapes the vmult and refill give it (relative tolerance 1e-5 in float32;
   the kernels that work in place on their own copies; brick_apply as the
   vmult launches it, with the overlap-add of the vmult's own cell-row
   deltas in its epilogue), and time kernel,
   plain version and, where one PyTorch call computes the same function, that
   call (brick_apply's: one ``torch.mm`` by the dense brick operator, TF32
   off), with CUDA events on a busy card (device time; median over
   repetitions after warm-up; dss_surface's timed calls work on a scratch
   copy refreshed before each, outside the timed window); dss_surface's
   traffic counted in 32-byte sectors (surface blocks touched together and
   apart) printed beside its bound; printed beside brick_apply: its time
   without the cell rows (the function earlier versions timed) and
   ``index_add_`` of the cell rows alone; beside refill_update its masked copy
   alone and a device ``copy_`` of the brick vector, beside corr_compact its
   rows without their runs; the library calls of corr_compact,
   refill_update, dss_surface, cell_apply and hn_cell (each mode) are one
   CSR product each, the kernel's whole map composed into one matrix (their
   nonzeros printed, with those of brick_apply, whose matrix is too large
   to build), and beside hn_cell stands the sum of the library calls
   for its steps; every library call is held against the plain version
   (1e-4);
5. the end-to-end constrained vmult at nref=7 in float32 through the kernels,
   held against the plain float64 path on the card (after zeroing the
   hanging entries, relative tolerance 1e-5), with every kernel's launch
   count read from that run (5 launches per vmult); its time and DoF/s; the
   host's time to issue one vmult and one fused brick_apply (``host_ms``); a
   profile of where its device time goes (5 launches of the port's
   kernels, no device launch outside them); then vmult_plain the same way
   (4 launches) and the HN overhead, vmult over vmult_plain;
6. ``refill`` of the vmult's output at nref=7 in float32 through the
   kernels against the plain float64 refill on the card (1e-5), with its
   launch counts (2 per refill), time, the host's time to issue one refill and
   its profile (no launch outside the kernels);
7. the index engine (``MatrixFree``'s cell loop with ``LaplaceOperator``) on
   phase 3's nref=7 p=4 float32 mesh: its sizes (constrained cells, masks,
   slaves and constraint entries, the transposed DoF map's entries); each
   of its four kernels (hn_interp by every runner, cell_laplace as each
   vmult launches it, dof_scatter on both maps, constraints_slow in both
   modes) against its plain version (1e-5), timed with its bound and its
   library call (hn_interp's and constraints_slow's maps as one CSR product,
   dof_scatter's one ``index_add``; none fits cell_laplace); the vmult
   (fast, slow, constraints=False) and apply_hanging_node_constraints
   against the plain float64 path (1e-5), their launches checked (2, 4, 2,
   1), two calls bit-identical, timed and profiled (no device launch
   outside the kernels but the one copy that keeps the HN input unwritten);
   each runner's vmult (the four share one cell_laplace kernel) and
   apply_hanging_node_constraints (hn_interp by that runner); the HN overhead
   (vmult over constraints=False, fast and slow); the deformed vmult at
   quadrant nref=6 against the plain float64 path (1e-5);
8. the degree <= 3 schedule, one phase a degree (``LOW_DEGREES``: p=3 on
   the nref=7 mesh, p=2 and p=1 at quadrant nref=8), float32 through the
   kernels: its sizes (masked cells against the subset's, plane-covered
   cells, levels), every kernel against its plain version (1e-5) and timed
   with its bound and library call, vmult, vmult_plain and refill against
   the plain float64 path (1e-5) with their launches counted and checked
   (8, 3, 3 at p <= 2; 5, 3, 2 at p=3), timed, profiled, and the HN
   overhead per degree;
9. float64 through the kernels: at quadrant nref=4 p=4 every kernel against
   its plain version, the vmult against the scipy oracle and refill against
   the plain path; the index engine's kernels against their plain versions
   there, its fast and slow vmult against the oracle and each other, at
   quadrant nref=2 p=6 against the oracle, the deformed vmult at quadrant
   nref=3 p=4 against its plain path; at quadrant nref=2 p=6 the brick
   vmult against the oracle; at quadrant nref=4 p=3 and p=2 every kernel
   against its plain version, the vmult against the oracle, vmult_plain and
   refill against the plain path (relative tolerance 1e-12 each);
10. a JSON line with the vmult's, vmult_plain's and refill's numbers and
   each degree's, one with the index engine's, one with the kernels'
   numbers (all 13; the new instances as parts named by degree;
   masked_quad's, plane_fill's and plane_fold's totals from p=2), then the
   device line.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}  # outside the tensor cores
SEED = 0
VMULT_LAUNCHES, REFILL_LAUNCHES = 5, 2
PLAIN_LAUNCHES = {"cell_apply": 1, "corr_compact": 1, "brick_apply": 1, "dss_surface": 1}
# the degree <= 3 phases: (degree, quadrant nref), each in float32 through the kernels
LOW_DEGREES = ((3, 7), (2, 8), (1, 8))
MASKED_CSR_CAP = 300_000_000  # masked_quad's library matrix: entries before summation
# the kernel of the degree <= 3 schedule whose parts give a new kernel's totals
LOW_MAIN_DEGREE = 2
LIBRARY_TOL = 1e-4  # a library yardstick against the plain version, float32, relative
# parts timed in phase 4 that refill launches and the vmult does not: in the
# kernels line they stand in "parts" only, and a kernel's totals are those
# of its vmult launches
REFILL_PARTS = {("hn_cell", "fill")}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def time_ms(fn, reps: int = 20, warmup: int = 3, device_only: bool = False,
            reset=None) -> float:
    """Median time of fn() in ms, from CUDA events around each call.
    device_only: before each call the card spins for ~0.5 ms, so the host
    enqueues the events and the call's launches while the card is busy and
    the events time the device work alone, not the host's launch time (a
    call whose launches take the host longer than the spin still shows
    part of it). reset: run before each call, outside the timed window
    (refreshes the input of a call that works in place)."""
    for _ in range(warmup):
        if reset:
            reset()
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        if device_only:
            torch.cuda._sleep(1_000_000)
        if reset:
            reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def host_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median host time in ms to issue fn(), its launches enqueued and not
    waited for; the card spins before each call, so no launch waits on it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def errors(got: torch.Tensor, ref: torch.Tensor):
    diff = float((got.double() - ref.double()).abs().max())
    return diff, diff / max(float(ref.double().abs().max()), 1e-300)


def bound(nbytes: int, flops: int | None, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops or 0) / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def profile_path(what, fn, kernel_names, expect: int, reps: int = 10, copies: int = 0):
    """Where one call's time goes: device time by kernel from torch.profiler
    over `reps` calls of fn, the port's kernels against everything else, and
    the device's idle share of the wall time. CUPTI has left out whole calls
    of a session (1-3 of 10 at degree <= 3), so the numbers are per call
    recorded: the port's kernel records over `expect` launches a call (the
    launches themselves are counted exactly by ``counted``). Each session
    first runs fn in `warm` profiler warm-up steps, whose records are
    dropped, so the `reps` recorded calls start with the tracer running.
    The first session of five that records every call is kept, else the one
    that recorded the most. Fails where no session saw device time, or where the
    kept one saw any device launch outside the port's kernels other than
    `copies` device-to-device copies a call (the copy that keeps an input
    unwritten)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    warm = 2  # profiler steps whose records are dropped: the tracer starts in them
    # a later profiler session in one process has been seen to record no device
    # activity at all while the calls ran (once in a dozen runs on an H100): such
    # a session is run again, at most four times, as is one that left out calls
    ours = lambda key: any(k in key for k in kernel_names)
    best = None
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True, schedule=schedule(wait=0, warmup=warm, active=reps)) as prof:
            for _ in range(warm):
                fn()
                torch.cuda.synchronize()  # recording starts at the last step: nothing running
                prof.step()
            t0 = time.perf_counter()
            for i in range(reps):
                fn()
                if i < reps - 1:  # the last active step ends with the session
                    prof.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        rows = []  # device kernels only: the aten ops that launch them would count twice
        for ev in prof.key_averages():
            # the schedule's step annotation spans the step on the device's timeline; it
            # is no launch
            if ev.device_type != DeviceType.CUDA or ev.key.startswith("ProfilerStep"):
                continue
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            if dev_us > 0:
                rows.append((dev_us / 1e3, ev.count, ev.key))
        calls = sum(r[1] for r in rows if ours(r[2])) / expect
        if best is None or calls > best[0]:
            best = (calls, rows, wall_ms)
        if rows and calls == reps:
            break
        print(f"profile of the {what}: the profiler recorded the port's kernels of {calls:g} "
              f"of {reps} calls (session {attempt + 1} of 5)", flush=True)
    calls, rows, wall_ms = best
    check(bool(rows) and calls > 0, f"the profiler saw no device time in the {what}")
    rows = [(ms / calls, count / calls, key) for ms, count, key in rows]
    busy = sum(r[0] for r in rows)
    own_ms = sum(r[0] for r in rows if ours(r[2]))
    res = dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1 - busy / wall_ms,
               port_kernels_ms=own_ms, other_ms=busy - own_ms, calls_recorded=calls,
               port_launches=sum(r[1] for r in rows if ours(r[2])),
               other_launches=sum(r[1] for r in rows if not ours(r[2])))
    print(f"profile (per {what}, {calls:g} of {reps} calls recorded): wall {wall_ms:.4f} ms, "
          f"device busy {busy:.4f} ms (idle {100 * res['idle_share']:.1f} %), port kernels "
          f"{own_ms:.4f} ms in {res['port_launches']:g} launches, other device work "
          f"{res['other_ms']:.4f} ms in {res['other_launches']:g} launches")
    for ms, count, key in sorted(rows, reverse=True)[:15]:
        print(f"  {ms:9.4f} ms  x{count:<4.3g} {key[:90]}")
    n_copies = sum(r[1] for r in rows if not ours(r[2]) and "Memcpy DtoD" in r[2])
    check(res["other_launches"] == n_copies == copies,
          f"{res['other_launches']} device launches per {what} outside the port's kernels "
          f"({n_copies} of them device copies, {copies} expected)")
    return res


def sparse_csr(rows, cols, vals, shape):
    """A CSR matrix on the card from COO entries (the library yardsticks)."""
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape).coalesce() \
        .to_sparse_csr()


def yardsticks(op, inter, K, cell=True):
    """Library calls on the same data (``kernel_calls``' intermediates
    `inter`), each map written as one CSR matrix (built here, outside the
    timing): corr_compact as one cuSPARSE product over sub_raw and plain
    stacked; refill_update over v and u_hat stacked; dss_surface over v (its
    pool sums); cell_apply over the subset brick nodes (``cell_composed``);
    hn_cell as one product per mode over the subset brick nodes,
    its whole map composed into one matrix (``hn_composed``); and hn_cell's
    steps one call each, as the kernels that it replaced were timed: the
    fill over the subset brick nodes, Q and Q^T as block-diagonal products
    over the constrained rows, ``torch.mm(u_hat, K.T)`` for K (no scale).
    Under the degree <= 3 schedule plain_rows is None (corr_compact reads
    no plain rows there) and cell=False (no cell_apply on that path).
    Returns ({name: [fn per part]}, {hn_cell mode: [fn per step]},
    {matrix: nonzeros})."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import dss_surface, refill_update
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.cell_apply import cell_nodes

    filled, u_hat, own, u_sub, u_sub_r, sub_raw, plain_rows, v1, y, u_hat_r = (inter[k] for k in (
        "filled", "u_hat", "own", "u_sub", "u_sub_r", "sub_raw", "plain_rows", "v1", "y",
        "u_hat_r"))
    n_loc, dev, dt = op.n_loc, u_sub.device, u_sub.dtype
    ar = lambda n: torch.arange(n, device=dev)
    rep = torch.repeat_interleave
    nS = op.n_hn * n_loc

    def slots_of(ptr):  # each list entry's output slot, entries in order
        return rep(ar(n_loc).repeat(ptr.shape[0]), (ptr[:, 1:] - ptr[:, :-1]).reshape(-1))

    def hn_matrix(d):
        ptr, col = getattr(op, f"hn_{d}_ptr").long(), getattr(op, f"hn_{d}_col").long()
        w = getattr(op, f"hn_{d}_w")
        slot_of = slots_of(ptr)
        q = op.hn_q.long()
        qr = torch.nonzero(q >= 0)[:, 0]
        cnt = (ptr[:, -1] - ptr[:, 0])[q[qr]]
        r = rep(qr, cnt)
        e = rep(ptr[q[qr], 0], cnt) + ar(int(cnt.sum())) - rep(torch.cumsum(cnt, 0) - cnt, cnt)
        ident = (torch.nonzero(q < 0)[:, 0][:, None] * n_loc + ar(n_loc)).reshape(-1)
        rows = torch.cat([r * n_loc + slot_of[e], ident])
        cols = torch.cat([r * n_loc + col[e], ident])
        vals = torch.cat([w[e], torch.ones(len(ident), dtype=dt, device=dev)])
        return sparse_csr(rows, cols, vals, (nS, nS))

    def hn_dense(d):  # [nQ + 1, n_loc, n_loc]: out_row = Q @ in_row, the last one I
        ptr, col = getattr(op, f"hn_{d}_ptr").long(), getattr(op, f"hn_{d}_col").long()
        nq, n_ent = ptr.shape[0], int(ptr[-1, -1]) if ptr.numel() else 0
        Q = torch.eye(n_loc, dtype=dt, device=dev).repeat(nq + 1, 1, 1)
        Q[:nq] = 0
        Q.index_put_((rep(ar(nq), ptr[:, -1] - ptr[:, 0]), slots_of(ptr), col[:n_ent]),
                     getattr(op, f"hn_{d}_w")[:n_ent], accumulate=True)
        return Q

    def hn_composed(mode):
        """hn_cell[mode] as one matrix from u_sub to the rows: fill entry
        (row r, slot j, source s) contributes column j of row r's dense map
        to column s (the map is Q_f, or scale_r Q_b K Q_f in the full mode)."""
        Qf = hn_dense("fwd")
        maps = Qf if mode == "fill" else hn_dense("bwd") @ K @ Qf
        q = op.hn_q.long()
        qq = torch.where(q >= 0, q, maps.shape[0] - 1)
        r, j = fill_rows // n_loc, fill_rows % n_loc
        vals = maps[qq[r], :, j]
        if mode == "full":
            vals = vals * op.geo_hn[r][:, None]
        rows = r[:, None] * n_loc + ar(n_loc)
        nz = vals != 0
        return sparse_csr(rows[nz], fill_cols[:, None].expand(-1, n_loc)[nz], vals[nz],
                          (nS, u_sub.numel()))

    def refill_composed():
        """refill_update as one matrix over [v; u_hat]: a valid node keeps
        v, times 1 - invden * (its holders that are constrained rows) where
        the update runs, and takes invden times each such holder's u_hat
        entry; an invalid node is zero."""
        n_nodes = y.numel()
        valid = refill_update.valid_mask(op.refill_valid_bits, op.N3p).reshape(-1)
        hv = op.refill_holders.long()
        codes = op.cell_code.view(op.n_sub, op.C).long()[:, torch.where(hv >= 0, hv >> 16, 0)]
        used = (hv >= 0) & (codes >= 0)  # [n_sub, n_w, 8]
        w_rows = ar(op.n_sub)[:, None] * op.N3p + op.refill_nodes.long()  # [n_sub, n_w]
        diag = torch.ones(n_nodes, dtype=dt, device=dev)
        diag[w_rows.reshape(-1)] = (1 - op.refill_invden * used.sum(dim=-1)).reshape(-1)
        diag = torch.where(valid, diag, 0.0)
        nz = torch.nonzero(diag)[:, 0]
        take = used & valid[w_rows][..., None]
        ent_rows = w_rows[..., None].expand_as(take)[take]
        ent_cols = n_nodes + (codes * n_loc + (hv & 0xFFFF))[take]
        ent_vals = op.refill_invden[..., None].expand(take.shape)[take]
        return sparse_csr(torch.cat([nz, ent_rows]), torch.cat([nz, ent_cols]),
                          torch.cat([diag[nz], ent_vals]), (n_nodes, n_nodes + u_hat_r.numel()))

    def dss_composed():
        """dss_surface as one matrix on v, from dss_surface's own tables: a
        valid copy of a pool takes the sum of the pool's copies, a node off
        the surface keeps its value unless it is padding or a hole, every
        other node is zero."""
        tables = op.dss_tables()
        valid_bits, hole_bricks, hole_bits, NB = tables[3], tables[4].long(), tables[5], tables[-1]
        rows, cols = [], []
        for pools, kind in zip(tables[:3], dss_surface.POOL_KINDS):
            b, s, node, real = dss_surface.pool_positions(pools, kind, NB, op.N3p)
            ok = real[..., None] & dss_surface.bit_set(valid_bits, b[..., None], s)
            for c in range(pools.shape[1]):
                sel = ok & real[:, c, None, None]
                rows.append(node[sel])
                cols.append(node[:, c: c + 1].expand_as(node)[sel])
        N3 = NB**3
        keeps = torch.zeros(v1.shape, dtype=torch.bool, device=dev)
        keeps[:, :N3] = True
        keeps[:, torch.from_numpy(dss_surface.surface_nodes(NB)).to(dev)] = False
        hole = dss_surface.bit_set(hole_bits, ar(len(hole_bricks))[:, None], ar(N3))
        keeps[hole_bricks, :N3] = keeps[hole_bricks, :N3] & ~hole
        own_node = torch.nonzero(keeps.reshape(-1))[:, 0]
        rows, cols = torch.cat(rows + [own_node]), torch.cat(cols + [own_node])
        return sparse_csr(rows, cols, torch.ones(len(rows), dtype=dt, device=dev),
                          (v1.numel(), v1.numel()))

    def cell_composed():
        """cell_apply as one matrix over the subset brick nodes: row (cell
        r, slot i) takes scale_r K[i, j] at cell r's node j, for each
        nonzero of K. Built directly as CSR with int32 indices (1.0 G
        nonzeros at nref=7: 8.2 GB, where int64 columns would take 12.3)."""
        kr, kc = torch.nonzero(K, as_tuple=True)  # row-major: sorted by kr
        nodes = cell_nodes(ar(op.n_sub * op.C), op.B, op.p, op.N3p, dev).to(torch.int32)
        R, nnz_k = nodes.shape[0], kr.numel()
        k_ptr = torch.cumsum(torch.bincount(kr, minlength=n_loc), 0) - torch.bincount(
            kr, minlength=n_loc)
        crow = torch.cat([(ar(R)[:, None] * nnz_k + k_ptr).reshape(-1),
                          torch.tensor([R * nnz_k], device=dev)]).to(torch.int32)
        return torch.sparse_csr_tensor(crow, nodes[:, kc].reshape(-1),
                                       (op.geo_cell_sub[:, None] * K[kr, kc]).reshape(-1),
                                       (R * n_loc, u_sub.numel()))

    ent_row = lambda ptr: rep(ar(ptr.numel() - 1), (ptr[1:] - ptr[:-1]).long())
    kept = torch.nonzero(op.keep_hn.reshape(-1))[:, 0]
    nodes = cell_nodes(op.hn_sub, op.B, op.p, op.N3p, dev).reshape(-1)
    fill_rows = torch.cat([kept, ent_row(op.fill_row_ptr) * n_loc + op.fill_ent_slot.long()])
    fill_cols = torch.cat([nodes[kept], op.fill_ent_src.long()])
    fill = sparse_csr(fill_rows, fill_cols, torch.ones(len(fill_rows), dtype=dt, device=dev),
                      (nS, u_sub.numel()))
    code = op.corr_tables()[0].long()
    n_rows = code.numel()
    hn_cells = op.hn_sub.long()
    minus = (torch.nonzero(code != -1)[:, 0][:, None] * n_loc + ar(n_loc)).reshape(-1)
    if plain_rows is None:
        minus = minus[:0]
    corr = sparse_csr(
        torch.cat([rep(op.corr_seg_dst.long(), (op.corr_seg_ptr[1:] - op.corr_seg_ptr[:-1]).long()),
                   (hn_cells[:, None] * n_loc + ar(n_loc)).reshape(-1)[kept], minus]),
        torch.cat([op.corr_ent_src.long(), kept, nS + minus]),
        torch.cat([torch.ones(op.corr_ent_src.numel() + len(kept), dtype=dt, device=dev),
                   -torch.ones(len(minus), dtype=dt, device=dev)]),
        (n_rows * n_loc, nS + (0 if plain_rows is None else n_rows * n_loc)))
    fwd, bwd = hn_matrix("fwd"), hn_matrix("bwd")
    x_fwd, x_bwd, x_u = filled.reshape(-1), own.reshape(-1), u_sub.reshape(-1)
    x_corr = sub_raw.reshape(-1) if plain_rows is None else torch.cat(
        [sub_raw.reshape(-1), plain_rows.reshape(-1)])
    fill_steps = [lambda: fill @ x_u, lambda: fwd @ x_fwd]
    one = {f"hn_cell[{mode}]": hn_composed(mode) for mode in ("full", "fill")}
    one.update(refill_update=refill_composed(), dss_surface=dss_composed())
    if cell:
        one["cell_apply"] = cell_composed()
    x_u_r = u_sub_r.reshape(-1)
    x_refill = torch.cat([y.reshape(-1), u_hat_r.reshape(-1)])
    x_v1 = v1.reshape(-1)
    return ({"corr_compact": [lambda: corr @ x_corr],
             **({"cell_apply": [lambda: one["cell_apply"] @ x_u]} if cell else {}),
             # in the order of kernel_calls' hn_cell parts: full on u_sub, fill on u_sub_r
             "hn_cell": [lambda: one["hn_cell[full]"] @ x_u, lambda: one["hn_cell[fill]"] @ x_u_r],
             "refill_update": [lambda: one["refill_update"] @ x_refill],
             "dss_surface": [lambda: one["dss_surface"] @ x_v1]},
            {"fill": fill_steps,
             "full": fill_steps + [lambda: torch.mm(u_hat, K.T), lambda: bwd @ x_bwd]},
            {name: m._nnz() for name, m in one.items()})


def kernel_calls(op, x, y):
    """Every kernel's call on the card at the shapes the vmult (input x) and
    refill (input y, a vmult output) give it: {name: [(mode, kernel, plain,
    (bytes, flops), fresh, reset)]}, fresh computing (kernel, plain) outputs
    anew on their own copies for the kernels that work in place, reset
    refreshing the scratch copy that the timed calls of such a kernel work
    on where repeated calls would grow it without bound."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        brick_apply, cell_apply, corr_compact, dss_surface, hn_cell, refill_update,
    )

    isz = x.element_size()
    u_sub, u_sub_r = x[: op.n_sub], y[: op.n_sub]
    plain_rows = cell_apply.cell_apply(u_sub, *op.factors_host, op.geo_cell_sub, brick_size=op.B)
    # hn_cell's steps one by one (plain versions on the card): the yardsticks' inputs
    filled = op._fill_hn_compact(u_sub)
    u_hat = op._hn_apply(filled, False)
    own = cell_apply.cell_apply_plain(u_hat, op.K1, op.M1, op.geo_hn)
    sub_raw = op._hn_cell(u_sub, "full")
    dcols = op._corr_compact(plain_rows, sub_raw)
    fused = dict(dcols=dcols, brick_size=op.B)
    v1 = brick_apply.brick_apply(x, *op.brick_factors_host, op.geo, op.p, **fused)
    u_hat_r = op._hn_cell(u_sub_r, "fill")
    dss_args = op.dss_tables()
    hn_args = (*op.hn_tables(), *op.factors_host, op.geo_hn, op.B)
    hn_plain_args = (*op.hn_tables(), op.K1, op.M1, op.geo_hn, op.B)
    corr_args = op.corr_tables()
    refill_args = op.refill_tables()
    v_dss = v1.clone()  # the timed dss_surface calls' scratch, refreshed from v1 before each
    torch.cuda.synchronize()
    return {
        "brick_apply": [(
            "fused",
            lambda: brick_apply.brick_apply(x, *op.brick_factors_host, op.geo, op.p, **fused),
            lambda: brick_apply.brick_apply_plain(x, op.Kb, op.Mb, op.geo, op.p, **fused),
            brick_apply.bytes_and_flops(op.n_bricks, op.NB, op.p, op.N3p, isz, op.n_sub), None,
            None,
        )],
        "cell_apply": [(
            "from_bricks",
            lambda: cell_apply.cell_apply(u_sub, *op.factors_host, op.geo_cell_sub, op.B),
            lambda: cell_apply.cell_apply_plain(u_sub, op.K1, op.M1, op.geo_cell_sub, op.B),
            cell_apply.bytes_and_flops(u_sub.numel(), plain_rows.shape[0], op.n_loc, isz), None,
            None,
        )],
        "dss_surface": [(
            "bricks",
            lambda: dss_surface.dss_surface(v_dss, *dss_args),
            lambda: dss_surface.dss_surface_plain(v_dss, *dss_args),
            dss_surface.bytes_and_flops(v1, *dss_args),
            lambda: (dss_surface.dss_surface(v1.clone(), *dss_args),
                     dss_surface.dss_surface_plain(v1.clone(), *dss_args)),
            lambda: v_dss.copy_(v1),
        )],
        "hn_cell": [(
            mode,
            lambda src=src, mode=mode: hn_cell.hn_cell(src, *hn_args, mode=mode),
            lambda src=src, mode=mode: hn_cell.hn_cell_plain(src, *hn_plain_args, mode=mode),
            hn_cell.bytes_and_flops(src, *op.hn_tables(), op.B, mode=mode), None, None,
        ) for mode, src in (("full", u_sub), ("fill", u_sub_r))],
        "corr_compact": [(
            "dcols",
            lambda: corr_compact.corr_compact(plain_rows, sub_raw, *corr_args),
            lambda: corr_compact.corr_compact_plain(plain_rows, sub_raw, *corr_args),
            corr_compact.bytes_and_flops(plain_rows, sub_raw, *corr_args), None, None,
        )],
        "refill_update": [(
            "bricks",
            lambda: refill_update.refill_update(y, u_hat_r, *refill_args),
            lambda: refill_update.refill_update_plain(y, u_hat_r, *refill_args),
            refill_update.bytes_and_flops(y, u_hat_r, *refill_args), None, None,
        )],
    }, dict(filled=filled, u_hat=u_hat, own=own, u_sub=u_sub, u_sub_r=u_sub_r, sub_raw=sub_raw,
            plain_rows=plain_rows, dcols=dcols, v1=v1, y=y, u_hat_r=u_hat_r)


def low_launches(op):
    """Kernel launches per call on the degree <= 3 schedule (a mesh with
    constrained rows and holes): {call: {kernel: launches}}."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import plane_fold

    planes = ({"plane_fill": 1, "plane_fold": plane_fold.LAUNCHES} if op.planes else {})
    return {"vmult": {"hn_cell": 1, "corr_compact": 1, "brick_apply": 1, "masked_quad": 1,
                      "dss_surface": 1, **planes},
            "vmult_plain": {"brick_apply": 1, "masked_quad": 1, "dss_surface": 1},
            "refill": {"hn_cell": 1, "refill_update": 1,
                       **({"plane_fill": 1} if op.planes else {})}}


def in_place(mode, mod, src, args, plain_args=None):
    """The part of a kernel that works in place on src (updated and
    returned), as kernel_calls gives it: the timed calls work on a scratch
    copy that reset refreshes before each, fresh runs kernel and plain
    version on their own copies."""
    fn, plain_fn = getattr(mod, mod.NAME), getattr(mod, f"{mod.NAME}_plain")
    plain_args = args if plain_args is None else plain_args
    scratch = src.clone()
    return (mode, lambda: fn(scratch, *args), lambda: plain_fn(scratch, *plain_args),
            mod.bytes_and_flops(src, *args),
            lambda: (fn(src.clone(), *args), plain_fn(src.clone(), *plain_args)),
            lambda: scratch.copy_(src))


def low_kernel_calls(op, x, y):
    """kernel_calls for the degree <= 3 schedule: every kernel of the vmult
    (input x), the vmult_plain's masked removal and the refill (input y) at
    the shapes those calls give it, its parts named by the degree. Returns
    (calls, intermediates for ``yardsticks``)."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        brick_apply, cell_apply, corr_compact, dss_surface, hn_cell, masked_quad, plane_fill,
        plane_fold, refill_update,
    )

    tag, isz = f"p={op.p}", x.element_size()
    u = op._plane_fill(x, False) if op.planes else x
    yf = op._plane_fill(y, False) if op.planes else y
    u_sub, yf_sub = u[: op.n_sub], yf[: op.n_sub]
    sub_raw = op._hn_cell(u_sub, "full")
    dcols = op._corr_compact(None, sub_raw)
    fused = dict(dcols=dcols, brick_size=op.B)
    v0 = brick_apply.brick_apply(u, *op.brick_factors_host, op.geo, op.p, **fused)
    v_abs = brick_apply.brick_apply(x, *op.brick_factors_host, op.geo, op.p)
    v1 = op._masked_quad(v0.clone(), u, "rem")
    v2 = plane_fold.plane_fold(v1.clone(), *op.plane_fold_tables()) if op.planes else v1
    u_hat_r = op._hn_cell(yf_sub, "fill")
    filled = op._fill_hn_compact(u_sub)
    u_hat = op._hn_apply(filled, False)
    own = cell_apply.cell_apply_plain(u_hat, op.K1, op.M1, op.geo_hn)
    hn_args = (*op.hn_tables(), *op.factors_host, op.geo_hn, op.B)
    hn_plain_args = (*op.hn_tables(), op.K1, op.M1, op.geo_hn, op.B)
    calls = {
        "brick_apply": [(
            f"{tag} fused",
            lambda: brick_apply.brick_apply(u, *op.brick_factors_host, op.geo, op.p, **fused),
            lambda: brick_apply.brick_apply_plain(u, op.Kb, op.Mb, op.geo, op.p, **fused),
            brick_apply.bytes_and_flops(op.n_bricks, op.NB, op.p, op.N3p, isz, op.n_chainb),
            None, None)],
        "hn_cell": [(
            f"{tag} {mode}",
            lambda src=src, mode=mode: hn_cell.hn_cell(src, *hn_args, mode=mode),
            lambda src=src, mode=mode: hn_cell.hn_cell_plain(src, *hn_plain_args, mode=mode),
            hn_cell.bytes_and_flops(src, *op.hn_tables(), op.B, mode=mode), None, None,
        ) for mode, src in (("full", u_sub), ("fill", yf_sub))],
        "corr_compact": [(
            f"{tag} dcols",
            lambda: corr_compact.corr_compact(None, sub_raw, *op.corr_tables()),
            lambda: corr_compact.corr_compact_plain(None, sub_raw, *op.corr_tables()),
            corr_compact.bytes_and_flops(None, sub_raw, *op.corr_tables()), None, None)],
        "masked_quad": [in_place(
            f"{tag} {kind}", masked_quad, v,
            (src, *op.masked_tables(kind), *op.factors_host, op.geo, op.B),
            (src, *op.masked_tables(kind), op.K1, op.M1, op.geo, op.B))
            for kind, v, src in (("rem", v0, u), ("absent", v_abs, x))],
        "dss_surface": [in_place(tag, dss_surface, v2, op.dss_tables())],
        "refill_update": [(
            f"{tag}",
            lambda: refill_update.refill_update(yf, u_hat_r, *op.refill_tables()),
            lambda: refill_update.refill_update_plain(yf, u_hat_r, *op.refill_tables()),
            refill_update.bytes_and_flops(yf, u_hat_r, *op.refill_tables()), None, None)],
    }
    if op.planes:
        calls["plane_fill"] = [(
            f"{tag}", lambda: plane_fill.plane_fill(x, *op.plane_fill_tables()),
            lambda: plane_fill.plane_fill_plain(x, *op.plane_fill_tables()),
            plane_fill.bytes_and_flops(x, *op.plane_fill_tables()), None, None)]
        calls["plane_fold"] = [in_place(tag, plane_fold, v1, op.plane_fold_tables())]
    torch.cuda.synchronize()
    return calls, dict(filled=filled, u_hat=u_hat, own=own, u_sub=u_sub, u_sub_r=yf_sub,
                       sub_raw=sub_raw, plain_rows=None, v1=v2, y=yf, u_hat_r=u_hat_r,
                       u=u, x=x, v0=v0, v_abs=v_abs, v_fold=v1)


def low_yardsticks(op, inter, K):
    """The library calls of the degree <= 3 schedule's kernels, by name and
    part (``low_kernel_calls``' order), with their matrices' nonzeros:
    ``yardsticks`` for hn_cell, corr_compact, refill_update and dss_surface;
    ``brick_library`` for brick_apply; one CSR product each for the new
    kernels, their maps composed: masked_quad over [v; u] (its cells'
    stiffness entries, built only below MASKED_CSR_CAP entries before
    summation), plane_fill over u, plane_fold over v."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import masked_quad
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.cell_apply import cell_nodes

    lib, hn_steps, nnz = yardsticks(op, inter, K, cell=False)
    hn_steps = {f"p={op.p} {mode}": fns for mode, fns in hn_steps.items()}
    lib["brick_apply"] = [brick_library(op, inter["u"])]
    dev, dt = K.device, K.dtype
    ar = lambda n: torch.arange(n, device=dev)

    def masked_csr(kind, v, u):
        cells = masked_quad.selected_cells(*op.masked_tables(kind), op.B)
        n_ent = cells.numel() * op.n_loc**2
        if n_ent > MASKED_CSR_CAP:
            nnz[f"masked_quad[{kind}] (not built, entries)"] = n_ent
            return None
        nodes = cell_nodes(cells, op.B, op.p, op.N3p, dev)
        N = v.numel()
        vals = -(op.geo[cells // op.C][:, None, None] * K[None])
        M = sparse_csr(
            torch.cat([ar(N), nodes[:, :, None].expand(-1, op.n_loc, op.n_loc).reshape(-1)]),
            torch.cat([ar(N), N + nodes[:, None, :].expand(-1, op.n_loc, op.n_loc).reshape(-1)]),
            torch.cat([torch.ones(N, dtype=dt, device=dev), vals.reshape(-1)]), (N, 2 * N))
        nnz[f"masked_quad[{kind}]"] = M._nnz()
        xin = torch.cat([v.reshape(-1), u.reshape(-1)])
        return lambda: M @ xin

    lib["masked_quad"] = [masked_csr("rem", inter["v0"], inter["u"]),
                          masked_csr("absent", inter["v_abs"], inter["x"])]
    if op.planes:
        N = inter["x"].numel()
        cov = op.plane_cov.long()
        keep = torch.ones(N, dtype=torch.bool, device=dev)
        keep[cov] = False
        kept = torch.nonzero(keep)[:, 0]
        seg = lambda ptr: torch.repeat_interleave(ar(ptr.numel() - 1), (ptr[1:] - ptr[:-1]).long())
        ones = torch.ones(len(kept), dtype=dt, device=dev)
        fill = sparse_csr(torch.cat([kept, cov[seg(op.plane_fill_ptr)]]),
                          torch.cat([kept, op.plane_fill_src.long()]),
                          torch.cat([ones, op.plane_fill_w]), (N, N))
        fold = sparse_csr(torch.cat([kept, op.plane_fold_tgt.long()[seg(op.plane_fold_ptr)]]),
                          torch.cat([kept, op.plane_fold_src.long()]),
                          torch.cat([ones, op.plane_fold_w]), (N, N))
        nnz.update(plane_fill=fill._nnz(), plane_fold=fold._nnz())
        x_u, x_v = inter["x"].reshape(-1), inter["v_fold"].reshape(-1)
        lib["plane_fill"] = [lambda: fill @ x_u]
        lib["plane_fold"] = [lambda: fold @ x_v]
    return lib, hn_steps, nnz


def degree_phase(mt, tria, nref, p, dev, wrappers, smi):
    """One degree of the degree <= 3 schedule at quadrant nref, float32
    through the kernels: the setup and its sizes; every kernel against its
    plain version, timed with its bound and library call; vmult,
    vmult_plain and refill against the plain float64 path (1e-5), with
    their launches counted and checked, their times, the HN overhead
    (vmult over vmult_plain) and their profiles. Returns (numbers, {kernel:
    [part]})."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import kronecker_sum

    tol = 1e-5
    t0 = time.perf_counter()
    mf = mt.MatrixFree(tria, p, dtype=np.float32)
    op = mt.BrickLaplaceMM(mf, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_sel = {k: (0 if op.masked_tables(k) is None else op.masked_tables(k)[2].numel())
             for k in ("rem", "absent")}
    sizes = dict(n_dofs=mf.n_dofs, cells=tria.n_active_cells, bricks=op.n_bricks,
                 subset_bricks=op.n_sub, chain_bricks=op.n_chainb, constrained_rows=op.n_hn,
                 subset_cells=op.n_sub * op.C, masked_cells=n_sel,
                 masked_bricks={k: (0 if op.masked_tables(k) is None
                                    else op.masked_tables(k)[0].numel()) for k in n_sel},
                 plane_covered_cells=int(op.bs.plane_covered.sum()),
                 plane_groups=len(op._meta["plane_meta"]),
                 plane_levels=len(op._meta["plane_levels"]))
    if op.planes:
        sizes.update(covered_nodes=op.plane_cov.numel(), fill_entries=op.plane_fill_src.numel(),
                     fold_targets=op.plane_fold_tgt.numel())
    print(f"setup p={p}: {setup_s:.1f} s (quadrant nref={nref} f32, B={op.B}, NB={op.NB}): "
          f"{json.dumps(sizes)}", flush=True)
    check(op.assembled and op.planes == (p <= 2), f"p={p} does not run the degree <= 3 schedule")
    if p <= 2:
        check(sizes["plane_covered_cells"] > 0, f"p={p}: no plane-covered cell")
    u = np.random.default_rng(SEED).standard_normal(mf.n_dofs).astype(np.float32)
    x = op.from_dof_vector(u)
    y = op.vmult(x)
    calls, inter = low_kernel_calls(op, x, y)
    K = torch.from_numpy(kronecker_sum(op.K1.cpu().numpy(), op.M1.cpu().numpy())).to(dev, x.dtype)
    lib, hn_steps, nnz = low_yardsticks(op, inter, K)
    print(f"p={p}: maps composed into one CSR matrix each (the library calls), nonzeros: {nnz}",
          flush=True)
    parts = {name: measure_parts(name, cparts, lib.get(name, [None] * len(cparts)), hn_steps,
                                 x.dtype, tol)
             for name, cparts in calls.items()}
    del calls, inter, lib
    torch.cuda.empty_cache()

    op64 = mt.BrickLaplaceMM(mf, device=dev, dtype=torch.float64)
    x64 = x.double()
    expect = low_launches(op)
    res, counts = {}, {}
    refs = {"vmult": lambda: op64.vmult(x64, plain=True),
            "vmult_plain": lambda: op64.vmult_plain(x64, plain=True)}
    outs = {}
    for call in ("vmult", "vmult_plain", "refill"):
        fn = {"vmult": lambda: op.vmult(x), "vmult_plain": lambda: op.vmult_plain(x),
              "refill": lambda: op.refill(outs["vmult"])}[call]
        ref = refs[call]() if call != "refill" else op64.refill(outs["vmult"].double(), plain=True)
        out, n = counted(wrappers, fn)
        outs[call] = out
        if call == "vmult":  # reduced outputs: compared at the non-hanging DoFs
            got, ref = op.to_dof_vector(out, zero_hanging=True), op64.to_dof_vector(
                ref, zero_hanging=True)
        else:
            got = out
        _, err = errors(got, ref)
        n = {k: c for k, c in n.items() if c}
        counts[call] = n
        print(f"{call} p={p} f32 vs plain f64 path: max rel err {err:.3e} (tol {tol:g}), "
              f"launches {n}", flush=True)
        check(bool(torch.isfinite(out).all()) and out.shape == x.shape, f"{call} p={p} malformed")
        check(err <= tol, f"{call} p={p} disagrees with the float64 path: {err:.3e}")
        check(n == expect[call], f"{call} p={p} launched {n}, not {expect[call]}")
        ms = time_ms(fn, reps=20, warmup=3)
        plain_ms = time_ms(lambda: {"vmult": op.vmult, "vmult_plain": op.vmult_plain,
                                    "refill": op.refill}[call](
            x if call != "refill" else outs["vmult"], plain=True), reps=5, warmup=1)
        res[call] = dict(ms=ms, plain_ms=plain_ms, max_rel_err=err, launches=n,
                         host_ms=host_ms(fn, reps=20),
                         profile=profile_path(f"{call} p={p}", fn, set(wrappers),
                                              sum(expect[call].values())))
    overhead = res["vmult"]["ms"] / res["vmult_plain"]["ms"]
    print(f"p={p} nref={nref} f32 on {smi}: vmult {res['vmult']['ms']:.4f} ms "
          f"({mf.n_dofs / res['vmult']['ms'] / 1e6:.4f} GDoF/s), vmult_plain "
          f"{res['vmult_plain']['ms']:.4f} ms, refill {res['refill']['ms']:.4f} ms; "
          f"HN overhead (vmult / vmult_plain) {overhead:.4f}", flush=True)
    for name, plist in parts.items():  # each part's launches in the call that runs it
        for part in plist:
            call = ("refill" if name == "refill_update" or part["mode"].endswith("fill")
                    and name == "hn_cell" else
                    "vmult_plain" if part["mode"].endswith("absent") else "vmult")
            part["launches"] = counts[call].get(name, 0)
            part["call"] = call
    numbers = dict(p=p, nref=nref, B=op.B, setup_s=setup_s, sizes=sizes, hn_overhead=overhead,
                   **res, card=smi)
    del op, op64, x, x64, y, outs
    torch.cuda.empty_cache()
    return numbers, parts


def check_chain_tables(mf, op, seed):
    """Host only, float64: the composed gather lists that ``kernel_tables``
    hands the chain kernels, run through the plain versions on CPU tensors,
    against the dense one-hot chain computed stage by stage (``dense_fill``,
    ``dense_corr``) and against rows @ Q per mask range, on random rows.
    Returns {part: relative error}; fails above 1e-12."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import (
        dense_corr, dense_fill, kernel_tables, operator_tables,
    )
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import corr_compact, hn_cell

    t, m = operator_tables(mf, op.bs)
    k = {key: torch.from_numpy(np.ascontiguousarray(v)) for key, v in kernel_tables(t, m).items()}
    rng = np.random.default_rng(seed)
    n_hn, n_loc = t["keep_hn"].shape
    rows = rng.standard_normal((n_hn, n_loc))
    u_sub = rng.standard_normal((m["n_sub"], m["N3p"]))
    plain = rng.standard_normal((m["n_sub"] * m["B"] ** 3, n_loc))
    got, ref = {}, {}
    for d in ("fwd", "bwd"):
        got[f"Q[{d}]"] = hn_cell.hn_apply_plain(
            torch.from_numpy(rows), k["hn_q"], k[f"hn_{d}_ptr"], k[f"hn_{d}_col"], k[f"hn_{d}_w"])
        ref[f"Q[{d}]"] = rows.copy()
        for s, e, qi in m["hn_bounds"]:
            if qi is not None:
                Q = np.asarray(t["hn_Q"][qi])
                ref[f"Q[{d}]"][s:e] = rows[s:e] @ (Q if d == "fwd" else Q.T)
    got["fill"] = hn_cell.fill_hn_plain(
        torch.from_numpy(u_sub), k["hn_sub"], k["keep_hn"], k["fill_row_ptr"],
        k["fill_ent_slot"], k["fill_ent_src"], m["B"])
    ref["fill"] = dense_fill(t, m, u_sub)
    got["corr_compact"] = corr_compact.corr_compact_plain(
        torch.from_numpy(plain), torch.from_numpy(rows), k["cell_code"], k["keep_hn"],
        k["corr_seg_ptr"], k["corr_seg_dst"], k["corr_ent_src"], k["corr_blocks"])
    ref["corr_compact"] = dense_corr(t, m, plain, rows)
    errs = {name: errors(got[name], torch.from_numpy(ref[name]))[1] for name in got}
    print(f"chain tables vs the dense one-hot chain ({m['n_fill_tails']} fill and "
          f"{m['n_corr_tails']} fold tail stages), max rel err per part (tol 1e-12): {errs}",
          flush=True)
    for name, err in errs.items():
        check(err <= 1e-12, f"{name}'s lists disagree with the dense chain: {err:.3e}")
    return errs


def check_kernels(calls, tol, what):
    """Each kernel's output against its plain version; returns {name: [(abs, rel)]}."""
    out = {}
    for name, parts in calls.items():
        for mode, kern, plain, _, fresh, _ in parts:
            got, ref = fresh() if fresh else (kern(), plain())
            torch.cuda.synchronize()
            abs_err, rel_err = errors(got, ref)
            check(bool(torch.isfinite(got).all()), f"{name}[{mode}] gave non-finite values")
            check(rel_err <= tol, f"{name}[{mode}] disagrees with its plain version ({what}): "
                                  f"{rel_err:.3e}")
            out.setdefault(name, []).append((abs_err, rel_err))
    print(f"{what}: every kernel matches its plain version (max rel err "
          f"{max(r for v in out.values() for _, r in v):.3e}, tol {tol:g})", flush=True)
    return out


def counted(wrappers, fn):
    """Run fn once with every launch count set to 0 just before; return
    its result and the counts read just after."""
    for wrapper in wrappers.values():
        wrapper.launches = 0
    res = fn()
    torch.cuda.synchronize()
    return res, {name: wrapper.launches for name, wrapper in wrappers.items()}


def brick_library(op, x):
    """brick_apply's library call: its map is one dense brick operator A
    [N3, N3] (Mz (x) (My (x) Kx + Ky (x) Mx) + Kz (x) My (x) Mx), the same for
    every brick, so one torch.mm over the bricks computes it, with geo
    applied to the input outside the timed call, TF32 off. Returns (call,
    the plain version without cell rows, which the call is held against):
    the cell rows' overlap-add keeps its own index_add_ yardstick."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import brick_apply

    torch.backends.cuda.matmul.allow_tf32 = False
    Kb, Mb = op.Kb.double(), op.Mb.double()
    A = (torch.kron(Mb, torch.kron(Mb, Kb) + torch.kron(Kb, Mb))
         + torch.kron(Kb, torch.kron(Mb, Mb))).to(x.dtype)
    xs = (x * op.geo[:, None])[:, : op.N3].contiguous()
    return (lambda: torch.mm(xs, A.T),
            lambda: brick_apply.brick_apply_plain(x, op.Kb, op.Mb, op.geo, op.p)[:, : op.N3])


def kernel_record(mod):
    return dict(name=mod.NAME, route="cuda",
                source=f"dealii_matrixfree_hanging_nodes_tpu_torch/csrc/{mod.NAME}.cu",
                replaces=mod.REPLACES, launches=None, max_abs_err=0.0, max_rel_err=0.0,
                ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by=None, library_ms=None, parts=[])


def measure_parts(name, parts, libs, hn_steps, dtype, tol):
    """Each part of a kernel: its error against the plain version, the
    kernel's, the plain version's and the library call's times (device
    only), its bound; the library call held against the plain version.
    Returns [part dict], printing a line each."""
    out = []
    for (mode, kern, plain, (nbytes, flops), fresh, reset), lib in zip(parts, libs):
        lib_ref = None
        if isinstance(lib, tuple):  # a library call held against its own plain reference
            lib, lib_ref = lib
        got, ref = fresh() if fresh else (kern(), plain())
        torch.cuda.synchronize()
        abs_err, rel_err = errors(got, ref)
        check(rel_err <= tol, f"{name}[{mode}] disagrees with its plain version: {rel_err:.3e}")
        k_ms = time_ms(kern, device_only=True, reset=reset)
        p_ms = time_ms(plain, device_only=True, reset=reset)
        b_ms, b_by = bound(nbytes, flops, dtype)
        l_ms = None if lib is None else time_ms(lib, device_only=True)
        part = dict(mode=mode, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=l_ms, max_abs_err=abs_err, max_rel_err=rel_err)
        if lib is not None:  # the library call computes the same function
            part["library_rel_err"] = errors(
                lib().reshape(-1), (ref if lib_ref is None else lib_ref()).reshape(-1))[1]
            check(part["library_rel_err"] <= LIBRARY_TOL,
                  f"{name}[{mode}]'s library call disagrees with its plain version: "
                  f"{part['library_rel_err']:.3e}")
        if name == "hn_cell" and mode in hn_steps:  # beside it: its steps' library calls
            steps_ms = [time_ms(fn, device_only=True) for fn in hn_steps[mode]]
            part["library_steps_ms"] = steps_ms
            print(f"hn_cell[{mode}]'s steps as library calls (fill, Q"
                  + (", torch.mm for K, Q^T" if "full" in mode else "") + "): "
                  + " + ".join(f"{t:.4f}" for t in steps_ms)
                  + f" = {sum(steps_ms):.4f} ms (beside the kernel, not its library_ms)",
                  flush=True)
        out.append(part)
        print(f"{name}[{mode}]: max rel err {rel_err:.3e} (tol {tol:g}), max abs err "
              f"{abs_err:.3e}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
              f"{(flops or 0) / 1e9:.3f} GFLOP)"
              + (f", library {l_ms:.4f} ms (rel err {part['library_rel_err']:.3e})"
                 if l_ms is not None else ""), flush=True)
    return out


INDEX_RUNNERS = ("compact", "all", "sorted", "matrix")
# launches per call of the index engine on a mesh with constrained cells and slaves
INDEX_LAUNCHES = {
    "vmult": {"cell_laplace": 1, "dof_scatter": 1},
    "vmult constraints=False": {"cell_laplace": 1, "dof_scatter": 1},
    "vmult slow": {"constraints_slow": 2, "cell_laplace": 1, "dof_scatter": 1},
    "apply_hanging_node_constraints": {"hn_interp": 1},
}
# the parts whose numbers are a new kernel's totals in the kernels line, and the call whose
# launches it reports: its launches on the path that runs it
INDEX_MAIN = {"hn_interp": ({"compact"}, "apply_hanging_node_constraints"),
              "cell_laplace": ({"vmult"}, "vmult"), "dof_scatter": ({"fast map"}, "vmult"),
              "constraints_slow": ({"distribute", "compress"}, "vmult slow")}
DEFORMED_NREF = 6  # the deformed mapping's mesh: the metric's host setup (PERF.md section 4)


def index_kernel_calls(mfs, x, rows, deformed=None):
    """Every index-engine kernel's calls on the card at the shapes the index
    engine's paths give it (x a global vector, rows cell rows; mfs one
    MatrixFree a runner on one mesh): hn_interp by each runner (compact in
    both directions), in place on a scratch copy of rows that reset refreshes;
    cell_laplace as the fast vmult launches it (every runner's: they share
    it), the slow vmult (plain map, no HN), constraints=False and, with
    deformed = (mf, x), the deformed vmult; dof_scatter on both maps; constraints_slow
    in both modes of the slow vmult. Returns (calls, intermediates)."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        cell_laplace, constraints_slow, dof_scatter, hn_interp,
    )

    mf = mfs["compact"]
    dev, dt = x.device, x.dtype
    calls = {"hn_interp": [], "cell_laplace": [], "dof_scatter": [], "constraints_slow": []}
    for mode, m in mfs.items():
        for tr in ((False, True) if mode == "compact" else (False,)):
            kw = dict(m.hn_interp_args(dev, dt), transpose=tr)
            scratch = rows.clone()
            calls["hn_interp"].append((
                mode + (" transposed" if tr else ""),
                lambda kw=kw, s=scratch: hn_interp.hn_interp(s, **kw),
                lambda kw=kw, s=scratch: hn_interp.hn_interp_plain(s, **kw),
                hn_interp.bytes_and_flops(rows, **kw),
                lambda kw=kw: (hn_interp.hn_interp(rows.clone(), **kw),
                               hn_interp.hn_interp_plain(rows.clone(), **kw)),
                lambda s=scratch: s.copy_(rows)))
    x_dist = mf.distribute_slow(x)
    launches = [("vmult", mf, x, False, True), ("vmult slow", mf, x_dist, True, False),
                ("vmult constraints=False", mf, x, False, False)]
    if deformed is not None:
        launches.append((f"vmult deformed nref={DEFORMED_NREF}", *deformed, False, True))
    for part, m, src, slow, hn in launches:
        args = (src, *m.cell_laplace_args(dev, dt, slow=slow, hn=hn))
        calls["cell_laplace"].append((
            part, lambda a=args: cell_laplace.cell_laplace(*a),
            lambda a=args: cell_laplace.cell_laplace_plain(*a),
            cell_laplace.bytes_and_flops(*args), None, None))
    rows_fast = cell_laplace.cell_laplace(x, *mf.cell_laplace_args(dev, dt))
    rows_slow = cell_laplace.cell_laplace(x_dist, *mf.cell_laplace_args(dev, dt, slow=True))
    for part, r, slow in (("fast map", rows_fast, False), ("plain map", rows_slow, True)):
        t = mf.scatter_tables(slow, dev)
        calls["dof_scatter"].append((
            part, lambda r=r, t=t: dof_scatter.dof_scatter(r, *t),
            lambda r=r, t=t: dof_scatter.dof_scatter_plain(r, *t),
            dof_scatter.bytes_and_flops(r, *t), None, None))
    y_slow = dof_scatter.dof_scatter(rows_slow, *mf.scatter_tables(True, dev))
    tables = mf.slow_tables(dev, dt)
    for part, v in (("distribute", x), ("compress", y_slow)):
        t = tables[part]
        calls["constraints_slow"].append((
            part, lambda v=v, t=t: constraints_slow.constraints_slow(v, *t),
            lambda v=v, t=t: constraints_slow.constraints_slow_plain(v, *t),
            constraints_slow.bytes_and_flops(v, *t), None, None))
    torch.cuda.synchronize()
    return calls, dict(x=x, rows=rows, x_dist=x_dist, rows_fast=rows_fast, rows_slow=rows_slow,
                       y_slow=y_slow)


def index_yardsticks(mfs, inter, n_parts):
    """The library calls of the index engine's kernels, by name and part
    (``index_kernel_calls``' order), with their matrices' nonzeros:
    hn_interp's map composed into one CSR matrix over the rows (the
    runner's composite Q's, transposed for the transposed part; identity on
    the other rows), dof_scatter as one ``index_add`` into a zero vector
    (out of place), constraints_slow as one CSR product per mode; none for
    cell_laplace, whose composed map (a dense cell matrix a cell) is printed
    and not built."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.constraints_slow import bit_set

    mf = mfs["compact"]
    x, rows = inter["x"], inter["rows"]
    dev, dt = x.device, x.dtype
    n_loc = rows.shape[1]
    ar = lambda n: torch.arange(n, device=dev)
    nnz = {}

    def hn_csr(m, transpose):
        tab = m._on("matrix", dev, dt)
        Q, hn_group, hn_idx = tab["Q"], tab["hn_group"], m._on("hn_idx", dev).long()
        cg = torch.full((m.n_cells,), -1, dtype=torch.long, device=dev)
        cg[hn_idx] = hn_group.long()  # each cell's group, -1: none
        Qm = Q if transpose else Q.transpose(1, 2)  # Qm[g][i, j]: out_i takes in_j
        rr, cc, vv = [], [], []
        for g in range(Q.shape[0]):
            cells = torch.nonzero(cg == g)[:, 0]
            i, j = torch.nonzero(Qm[g], as_tuple=True)
            rr.append((cells[:, None] * n_loc + i[None]).reshape(-1))
            cc.append((cells[:, None] * n_loc + j[None]).reshape(-1))
            vv.append(Qm[g][i, j].repeat(len(cells)))
        ident = (torch.nonzero(cg < 0)[:, 0][:, None] * n_loc + ar(n_loc)).reshape(-1)
        M = sparse_csr(torch.cat(rr + [ident]), torch.cat(cc + [ident]),
                       torch.cat(vv + [torch.ones(len(ident), dtype=dt, device=dev)]),
                       (rows.numel(), rows.numel()))
        return M

    lib = {"hn_interp": [], "cell_laplace": [None] * n_parts["cell_laplace"]}
    xr = rows.reshape(-1)
    for mode, m in mfs.items():
        for tr in ((False, True) if mode == "compact" else (False,)):
            M = hn_csr(m, tr)
            nnz[f"hn_interp[{mode}{' transposed' if tr else ''}]"] = M._nnz()
            lib["hn_interp"].append(lambda M=M: M @ xr)
    nnz["cell_laplace (not built)"] = mf.n_cells * n_loc * n_loc
    lib["dof_scatter"] = []
    zeros = torch.zeros(mf.n_dofs, dtype=dt, device=dev)
    for key, slow in (("rows_fast", False), ("rows_slow", True)):
        idx = mf._np["dofmap_plain" if slow else "dofmap"]
        idx = torch.from_numpy(np.ascontiguousarray(idx).reshape(-1)).to(dev).long()
        vals = inter[key].reshape(-1)
        lib["dof_scatter"].append(lambda idx=idx, vals=vals: zeros.index_add(0, idx, vals))
    lib["constraints_slow"] = []
    n = mf.n_dofs
    for part, v in (("distribute", x), ("compress", inter["y_slow"])):
        targets, ptr, idx, w, tbits, zbits, acc = mf.slow_tables(dev, dt)[part]
        k = torch.repeat_interleave(ar(targets.numel()), (ptr[1:] - ptr[:-1]).long())
        keep = ~bit_set(zbits, n) if zbits is not None else torch.ones(n, dtype=torch.bool,
                                                                        device=dev)
        if not acc:
            keep &= ~bit_set(tbits, n)
        diag = torch.nonzero(keep)[:, 0]
        M = sparse_csr(torch.cat([diag, targets.long()[k]]), torch.cat([diag, idx.long()]),
                       torch.cat([torch.ones(len(diag), dtype=dt, device=dev), w]), (n, n))
        nnz[f"constraints_slow[{part}]"] = M._nnz()
        lib["constraints_slow"].append(lambda M=M, v=v: M @ v)
    return lib, nnz


def index_phase(mt, tria, mf, dev, wrappers, smi):
    """The index engine at quadrant nref=7 p=4 float32 (mf: phase 3's
    MatrixFree, the compact runner): its sizes; every index kernel against
    its plain version (1e-5), timed with its bound and library call; the
    vmult (fast, slow, constraints=False) and apply_hanging_node_constraints
    against the plain float64 path (1e-5) with their launches counted and
    checked, two calls bit-identical, timed and profiled; each runner's vmult
    and apply_hanging_node_constraints; the HN overhead; the deformed vmult
    at quadrant nref=DEFORMED_NREF. Returns (numbers, {kernel: record})."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import KERNEL_MODULES

    tol, f32 = 1e-5, torch.float32
    t0 = time.perf_counter()
    mfs = {"compact": mf, **{mode: mt.MatrixFree(tria, 4, dtype=np.float32, hn_mode=mode)
                             for mode in INDEX_RUNNERS[1:]}}
    runners_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ptr, ent = mf.scatter_tables(False, dev)
    ent_plain = mf.scatter_tables(True, dev)[1]
    tables = mf.slow_tables(dev, f32)
    tables_s = time.perf_counter() - t0
    slow = mf._np["slow"]
    sizes = dict(cells=mf.n_cells, n_dofs=mf.n_dofs, constrained_cells=mf.n_hn_cells,
                 constrained_share=mf.n_hn_cells / mf.n_cells,
                 distinct_masks=int(np.unique(mf._np["hn_masks"]).size),
                 slaves=int(len(slow["slave"])), constraint_entries=int(len(slow["col"])),
                 masters=int(tables["compress"][0].numel()),
                 dofmap_bytes=int(mf._np["dofmap"].nbytes),
                 transposed_map_entries=int(ent.numel()),
                 transposed_plain_map_entries=int(ent_plain.numel()))
    print(f"index engine setup: runners all/sorted/matrix {runners_s:.1f} s, the transposed maps "
          f"and the constraint tables {tables_s:.1f} s (quadrant nref=7 p=4 f32): "
          f"{json.dumps(sizes)}", flush=True)
    check(mf.n_hn_cells > 0 and sizes["slaves"] > 0, "the index mesh has no constrained cells")
    x = op_input(mf, dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = torch.randn(mf.n_cells, (mf.degree + 1) ** 3, generator=g, device=dev, dtype=f32)

    t0 = time.perf_counter()
    tria_d = mt.create_quadrant(3, DEFORMED_NREF)
    mf_d = mt.MatrixFree(tria_d, 4, dtype=np.float32, high_order_mapping=True)
    op_d = mt.LaplaceOperator(mf_d, device=dev)
    x_d = op_input(mf_d, dev)
    y_d, nd = counted(wrappers, lambda: op_d.vmult(x_d))  # builds the metric at first use
    deformed_s = time.perf_counter() - t0
    print(f"deformed mesh quadrant nref={DEFORMED_NREF} p=4 f32: {mf_d.n_cells} cells, "
          f"{mf_d.n_dofs} DoFs, metric {tuple(mf_d._np['geo'].shape)}; setup with the metric "
          f"and the first vmult {deformed_s:.1f} s", flush=True)

    calls, inter = index_kernel_calls(mfs, x, rows, deformed=(mf_d, x_d))
    lib, nnz = index_yardsticks(mfs, inter, {k: len(v) for k, v in calls.items()})
    print(f"index engine: maps composed into one CSR matrix each (the library calls), nonzeros: "
          f"{nnz}; cell_laplace has no library call: its map composed is a dense "
          f"{(mf.degree + 1) ** 3}^2 cell matrix a cell ({nnz['cell_laplace (not built)']} "
          f"nonzeros), and no single PyTorch call gathers, interpolates and integrates",
          flush=True)
    parts = {name: measure_parts(name, cparts, lib[name], {}, f32, tol)
             for name, cparts in calls.items()}
    del calls, inter, lib
    torch.cuda.empty_cache()

    LaplaceOperator = mt.LaplaceOperator
    ops = {"vmult": LaplaceOperator(mf, device=dev),
           "vmult slow": LaplaceOperator(mf, slow=True, device=dev),
           "vmult constraints=False": LaplaceOperator(mf, constraints=False, device=dev)}
    x64, rows64 = x.double(), rows.double()
    fns = {call: (lambda o=o: o.vmult(x)) for call, o in ops.items()}
    plains = {call: (lambda o=o: o.vmult(x64, plain=True)) for call, o in ops.items()}
    fns["apply_hanging_node_constraints"] = lambda: mf.apply_hanging_node_constraints(rows, False)
    plains["apply_hanging_node_constraints"] = lambda: mf.apply_hanging_node_constraints(
        rows64, False, plain=True)
    res, counts = {}, {}
    for call, fn in fns.items():
        ref = plains[call]()
        out, n = counted(wrappers, fn)
        n = {k: c for k, c in n.items() if c}
        counts[call] = n
        err = errors(out, ref)[1]
        same = bool(torch.equal(fn(), fn()))
        print(f"index {call} nref=7 f32 vs plain f64 path: max rel err {err:.3e} (tol {tol:g}), "
              f"launches {n}, two calls bit-identical: {same}", flush=True)
        check(bool(torch.isfinite(out).all()) and out.shape == ref.shape, f"index {call} malformed")
        check(err <= tol, f"index {call} disagrees with the float64 path: {err:.3e}")
        check(n == INDEX_LAUNCHES[call], f"index {call} launched {n}, not {INDEX_LAUNCHES[call]}")
        check(same, f"two calls of index {call} differ")
        copies = 1 if call == "apply_hanging_node_constraints" else 0
        res[call] = dict(ms=time_ms(fn, reps=20, warmup=3),
                         plain_ms=time_ms(plains[call], reps=5, warmup=1), max_rel_err=err,
                         launches=n, host_ms=host_ms(fn, reps=20),
                         profile=profile_path(f"index {call}", fn, set(wrappers),
                                              sum(INDEX_LAUNCHES[call].values()), copies=copies))
    runners = {}
    ref = plains["vmult"]()
    for mode, m in mfs.items():
        op = LaplaceOperator(m, device=dev)
        out, n = counted(wrappers, lambda: op.vmult(x))
        n = {k: c for k, c in n.items() if c}
        v_err = errors(out, ref)[1]
        hn_out, nh = counted(wrappers, lambda: m.apply_hanging_node_constraints(rows, False))
        nh = {k: c for k, c in nh.items() if c}
        h_err = errors(hn_out, m.apply_hanging_node_constraints(rows64, False, plain=True))[1]
        check(v_err <= tol and h_err <= tol, f"runner {mode} disagrees: vmult {v_err:.3e}, "
                                             f"HN {h_err:.3e}")
        check(n == INDEX_LAUNCHES["vmult"] and nh == INDEX_LAUNCHES[
            "apply_hanging_node_constraints"], f"runner {mode} launched {n}, {nh}")
        runners[mode] = dict(
            vmult_ms=time_ms(lambda: op.vmult(x), reps=20, warmup=3), vmult_err=v_err,
            hn_ms=time_ms(lambda: m.apply_hanging_node_constraints(rows, False), reps=20,
                          warmup=3), hn_err=h_err)
        print(f"runner {mode}: vmult {runners[mode]['vmult_ms']:.4f} ms (rel err {v_err:.3e}), "
              f"apply_hanging_node_constraints {runners[mode]['hn_ms']:.4f} ms (rel err "
              f"{h_err:.3e}), launches {n}, {nh}", flush=True)
        del op
    base = res["vmult constraints=False"]["ms"]
    overhead = {"fast": res["vmult"]["ms"] / base, "slow": res["vmult slow"]["ms"] / base}

    ref_d = op_d.vmult(x_d.double(), plain=True)
    nd = {k: c for k, c in nd.items() if c}
    d_err = errors(y_d, ref_d)[1]
    check(bool(torch.isfinite(y_d).all()) and d_err <= tol,
          f"deformed vmult disagrees with the float64 path: {d_err:.3e}")
    check(nd == INDEX_LAUNCHES["vmult"], f"deformed vmult launched {nd}")
    deformed = dict(nref=DEFORMED_NREF, n_dofs=mf_d.n_dofs, cells=mf_d.n_cells,
                    ms=time_ms(lambda: op_d.vmult(x_d), reps=20, warmup=3),
                    plain_ms=time_ms(lambda: op_d.vmult(x_d.double(), plain=True), reps=5,
                                     warmup=1),
                    max_rel_err=d_err, launches=nd, setup_s=deformed_s)
    print(f"index engine nref=7 p=4 f32 on {smi}: vmult {res['vmult']['ms']:.4f} ms "
          f"({mf.n_dofs / res['vmult']['ms'] / 1e6:.4f} GDoF/s), slow "
          f"{res['vmult slow']['ms']:.4f} ms, constraints=False {base:.4f} ms; HN overhead "
          f"fast {overhead['fast']:.4f}, slow {overhead['slow']:.4f}; deformed nref="
          f"{DEFORMED_NREF} vmult {deformed['ms']:.4f} ms (rel err {d_err:.3e}, launches {nd})",
          flush=True)

    records = {}
    for mod in [m for m in KERNEL_MODULES if m.NAME in parts]:
        main_parts, call = INDEX_MAIN[mod.NAME]
        rec = kernel_record(mod)
        rec["parts"] = parts[mod.NAME]
        main = [p for p in rec["parts"] if p["mode"] in main_parts]
        for k in ("ms", "plain_ms", "bound_ms"):
            rec[k] = sum(p[k] for p in main)
        rec["bound_by"] = max((p["bound_ms"], p["bound_by"]) for p in main)[1]
        libs = [p["library_ms"] for p in main]
        rec["library_ms"] = None if None in libs else sum(libs)
        rec["max_abs_err"] = max(p["max_abs_err"] for p in rec["parts"])
        rec["max_rel_err"] = max(p["max_rel_err"] for p in rec["parts"])
        rec["launches"] = counts[call].get(mod.NAME, 0)
        records[mod.NAME] = rec
    numbers = dict(sizes=sizes, setup_s=dict(runners=runners_s, tables=tables_s), **res,
                   runners=runners, hn_overhead=overhead, deformed=deformed, card=smi)
    del mfs, ops, op_d, mf_d
    torch.cuda.empty_cache()
    return numbers, records


def op_input(mf, dev):
    """A float32 global vector on the card from the seed (the index engine's input)."""
    u = np.random.default_rng(SEED).standard_normal(mf.n_dofs).astype(np.float32)
    return torch.from_numpy(u).to(dev)


def index_f64_checks(mt, tria4, mf4, dev):
    """float64 through the kernels: at quadrant nref=4 p=4 every index kernel
    against its plain version and the fast and slow vmult against the scipy
    oracle; at quadrant nref=2 p=6 the vmult against the oracle; the
    deformed vmult at quadrant nref=3 p=4 against its plain path (1e-12)."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import vmult_oracle

    tol, f64 = 1e-12, torch.float64
    mfs = {"compact": mf4, **{m: mt.MatrixFree(tria4, 4, hn_mode=m) for m in INDEX_RUNNERS[1:]}}
    u4 = np.random.default_rng(SEED).standard_normal(mf4.n_dofs)
    x4 = torch.from_numpy(u4).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = torch.randn(mf4.n_cells, 125, generator=g, device=dev, dtype=f64)
    check_kernels(index_kernel_calls(mfs, x4, rows)[0], tol, "index nref=4 f64")
    out = {}
    ref4 = vmult_oracle(tria4, 4, u4)
    for slow in (False, True):
        got = mt.LaplaceOperator(mf4, slow=slow, device=dev).vmult(x4)
        out[slow] = got
        err = float(np.abs(got.cpu().numpy() - ref4).max() / np.abs(ref4).max())
        print(f"index vmult{' slow' if slow else ''} nref=4 p=4 f64 vs scipy oracle: max rel err "
              f"{err:.3e} (tol {tol:g})", flush=True)
        check(err <= tol, f"float64 index vmult (slow={slow}) disagrees with the oracle: {err:.3e}")
    e = errors(out[True], out[False])[1]
    print(f"index vmult slow vs fast nref=4 p=4 f64: max rel err {e:.3e} (tol {tol:g})", flush=True)
    check(e <= tol, f"float64 slow and fast index vmult disagree: {e:.3e}")
    tria6 = mt.create_quadrant(3, 2)
    mf6 = mt.MatrixFree(tria6, 6)
    u6 = np.random.default_rng(SEED).standard_normal(mf6.n_dofs)
    ref6 = vmult_oracle(tria6, 6, u6)
    got6 = mt.LaplaceOperator(mf6, device=dev).vmult(u6).cpu().numpy()
    err6 = float(np.abs(got6 - ref6).max() / np.abs(ref6).max())
    print(f"index vmult nref=2 p=6 f64 vs scipy oracle: max rel err {err6:.3e} (tol {tol:g})",
          flush=True)
    check(err6 <= tol, f"float64 p=6 index vmult disagrees with the oracle: {err6:.3e}")
    mfd = mt.MatrixFree(mt.create_quadrant(3, 3), 4, high_order_mapping=True)
    opd = mt.LaplaceOperator(mfd, device=dev)
    xd = torch.from_numpy(np.random.default_rng(SEED).standard_normal(mfd.n_dofs)).to(dev)
    ed = errors(opd.vmult(xd), opd.vmult(xd, plain=True))[1]
    print(f"index deformed vmult nref=3 p=4 f64 vs its plain path: max rel err {ed:.3e} "
          f"(tol {tol:g})", flush=True)
    check(ed <= tol, f"float64 deformed index vmult disagrees with its plain path: {ed:.3e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2

    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import kronecker_sum
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        KERNEL_MODULES, _build, brick_apply, corr_compact, dss_surface, refill_update,
    )
    from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import vmult_oracle

    # ---- 1. the card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}", flush=True)
    dev = torch.device("cuda", 0)

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(logs)} kernel libraries")
    for name, log in logs.items():
        for kernel, usage in _build.ptxas_usage(log):
            print(f"  {kernel}: {usage}")
    # the stack frames of the two kernels redesigned last (refill_update must have none)
    frames = {name: [(k, u.split("; ", 1)[1]) for k, u in _build.ptxas_usage(
        _build.library_path(name).with_suffix(".log").read_text())]
        for name in ("refill_update", "corr_compact")}
    for name, usage in frames.items():
        print(f"  {name} stack frames: " + "; ".join(f"{k}: {u}" for k, u in usage), flush=True)
    check(bool(frames["refill_update"]) and all(
        u == "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
        for _, u in frames["refill_update"]), "refill_update has a stack frame or spills")
    for dt in (torch.float32, torch.float64):
        for p in sorted(q for _, q in brick_apply.SUPPORTED):
            plans = [brick_apply.plan(dt, p, m, device=dev) for m in (0, 1)]
            print(f"  brick_apply_kernel {dt} p={p}: shared memory bytes, blocks per SM "
                  f"{plans[0]} without cell rows, {plans[1]} with")

    # ---- 3. setup: quadrant nref=7, p=4, float32 ----------------------------
    t0 = time.perf_counter()
    tria = mt.create_quadrant(3, 7)
    mf = mt.MatrixFree(tria, 4, dtype=np.float32)
    op = mt.BrickLaplaceMM(mf, device=dev)
    torch.cuda.synchronize()
    print(f"setup: {time.perf_counter() - t0:.1f} s  (quadrant nref=7 p=4 f32: "
          f"{mf.n_dofs} DoFs, {tria.n_active_cells} cells, {op.n_bricks} bricks, "
          f"{op.n_sub} subset bricks, {op.n_hn} constrained rows, "
          f"{op.fill_ent_src.numel()} fill and {op.corr_ent_src.numel()} fold entries; the fold "
          f"in {op.corr_seg_dst.numel()} runs over {op.corr_blocks.shape[0] - 1} blocks; "
          f"{op.refill_nodes.numel()} written nodes a subset brick)", flush=True)
    hole_bits = op.dss_hole_bits.cpu().numpy()
    n_holes = int(np.unpackbits(hole_bits.view(np.uint8)).sum())
    lone = lambda pools: int(((pools >= 0).sum(dim=1) == 1).sum())
    print(f"dss work lists: {op.dss_face_pairs.shape[0]} face entries, "
          f"{op.dss_edge_pools.shape[0]} edge pools and {op.dss_corner_pools.shape[0]} corner "
          f"pools (of one copy: {lone(op.dss_face_pairs)}, {lone(op.dss_edge_pools)}, "
          f"{lone(op.dss_corner_pools)}); "
          f"{n_holes} invalid nodes off the surface in {hole_bits.shape[0]} hole bricks, "
          f"as bits {hole_bits.nbytes + 4 * hole_bits.shape[0]} B (a node list: {4 * n_holes} B)",
          flush=True)

    code = op.cell_code
    fold_rows = torch.bincount(op.corr_seg_dst.long() // op.n_loc, minlength=code.numel()) > 0
    print(f"subset cell rows: {code.numel()}: {int((code >= 0).sum())} constrained, "
          f"{int((code == -2).sum())} absent, {int(((code == -1) & fold_rows).sum())} fold "
          f"targets, {int(((code == -1) & ~fold_rows).sum())} zero in dcols; "
          f"{int(fold_rows.sum())} rows hold every fold entry", flush=True)

    t0 = time.perf_counter()
    check_chain_tables(mf, op, SEED)
    print(f"chain table check: {time.perf_counter() - t0:.1f} s", flush=True)
    u = np.random.default_rng(SEED).standard_normal(mf.n_dofs).astype(np.float32)
    x = op.from_dof_vector(u)
    y = op.vmult(x)  # refill's input: a vmult output (reduced)

    # ---- 4. each kernel against its plain version ---------------------------
    tol32 = 1e-5
    calls, inter = kernel_calls(op, x, y)
    check_kernels(calls, tol32, "nref=7 f32")
    # library yardsticks: one PyTorch call computing the same function (timed
    # here only; the port never calls them)
    library = {name: [None] * len(parts) for name, parts in calls.items()}
    K = torch.from_numpy(kronecker_sum(op.K1.cpu().numpy(), op.M1.cpu().numpy())).to(dev, x.dtype)
    lib_calls, hn_steps, lib_nnz = yardsticks(op, inter, K)
    library.update(lib_calls)
    print(f"maps composed into one CSR matrix each (the library calls), nonzeros: {lib_nnz}; "
          f"brick_apply's library call is one torch.mm by the dense brick operator "
          f"[{op.N3}, {op.N3}]", flush=True)
    library["brick_apply"] = [brick_library(op, x)]
    wrappers = {mod.NAME: getattr(mod, mod.NAME) for mod in KERNEL_MODULES}
    results = {}
    for mod in [m for m in KERNEL_MODULES if m.NAME in calls]:
        name = mod.NAME
        rec = kernel_record(mod)
        bound_parts = []
        for part in measure_parts(name, calls[name], library[name], hn_steps, x.dtype, tol32):
            rec["parts"].append(part)
            rec["max_abs_err"] = max(rec["max_abs_err"], part["max_abs_err"])
            rec["max_rel_err"] = max(rec["max_rel_err"], part["max_rel_err"])
            if (name, part["mode"]) not in REFILL_PARTS:
                rec["ms"] += part["ms"]
                rec["plain_ms"] += part["plain_ms"]
                rec["bound_ms"] += part["bound_ms"]
                if part["library_ms"] is not None:
                    rec["library_ms"] = (rec["library_ms"] or 0.0) + part["library_ms"]
                bound_parts.append((part["bound_ms"], part["bound_by"]))
        rec["bound_by"] = max(bound_parts)[1]
        if name in frames:
            rec["ptxas"] = [f"{k}: {u}" for k, u in frames[name]]
        results[name] = rec
    # beside the fused brick_apply (printed, not in the kernels line): the launch
    # without cell rows, as earlier versions timed it, and the overlap-add alone as
    # one index_add_
    nbytes, flops = brick_apply.bytes_and_flops(op.n_bricks, op.NB, op.p, op.N3p,
                                                x.element_size())
    bare_ms = time_ms(lambda: brick_apply.brick_apply(x, *op.brick_factors_host, op.geo, op.p),
                      device_only=True)
    print(f"brick_apply without cell rows: {bare_ms:.4f} ms, bound "
          f"{bound(nbytes, flops, x.dtype)[0]:.4f} ms ({nbytes / 1e6:.1f} MB)", flush=True)
    dcols = inter["dcols"]
    idx = brick_apply.overlap_add_index(op.n_sub, op.B, op.p, op.N3p, dev)
    v_sub = inter["v1"][: op.n_sub].clone()
    ia_ms = time_ms(lambda: v_sub.view(-1).index_add_(0, idx, dcols.view(-1)), device_only=True)
    print(f"index_add_ of the cell rows alone (the overlap-add's library yardstick): "
          f"{ia_ms:.4f} ms", flush=True)
    # beside refill_update and corr_compact (printed, not in the kernels line): the masked copy
    # alone (no subset bricks), a device copy_ of the same brick vector, and corr_compact's
    # rows without their runs
    y, u_hat_r = inter["y"], inter["u_hat_r"]
    bits, code, nodes, holders, invden, B = op.refill_tables()
    out = torch.empty_like(y)
    copy_ms = time_ms(lambda: refill_update.refill_update(y, u_hat_r, bits, code[:0], nodes,
                                                          holders, invden[:0], B), device_only=True)
    devcopy_ms = time_ms(lambda: out.copy_(y), device_only=True)
    ct = op.corr_tables()
    no_runs = (*ct[:2], ct[2][:1], ct[3][:0], ct[4][:0], torch.from_numpy(corr_compact.schedule(
        np.zeros(ct[0].numel(), np.int64), op.n_loc)).to(dev))
    rows_ms = time_ms(lambda: corr_compact.corr_compact(inter["plain_rows"], inter["sub_raw"],
                                                        *no_runs), device_only=True)
    print(f"refill_update's masked copy alone (no subset bricks): {copy_ms:.4f} ms; copy_ of the "
          f"brick vector: {devcopy_ms:.4f} ms; corr_compact's rows without their runs: "
          f"{rows_ms:.4f} ms", flush=True)
    # dss_surface's traffic in 32-byte sectors: an estimate printed beside its
    # bound, not a bound (the kernels line carries only the bound)
    dss = results["dss_surface"]
    for apart in (False, True):
        sectors = dss_surface.sector_bytes(inter["v1"], *op.dss_tables(), apart=apart)
        s_ms = sectors / PEAK_BYTES_PER_S * 1e3
        print(f"dss_surface in 32-byte sectors, surface blocks touched "
              f"{'apart' if apart else 'together'}: {sectors / 1e6:.1f} MB, {s_ms:.4f} ms "
              f"(kernel {dss['ms']:.4f} ms, bound {dss['bound_ms']:.4f} ms in words)", flush=True)
    del calls, inter, library, lib_calls, hn_steps, out

    # ---- 5. end-to-end vmult, nref=7, float32, through the kernels ---------
    op64 = mt.BrickLaplaceMM(mf, device=dev, dtype=torch.float64)
    x64 = x.double()
    ref = op64.to_dof_vector(op64.vmult(x64, plain=True), zero_hanging=True)
    y, counts = counted(wrappers, lambda: op.vmult(x))
    got = op.to_dof_vector(y, zero_hanging=True)
    abs_err, rel_err = errors(got, ref)
    print(f"vmult nref=7 f32 vs plain f64 path: max rel err {rel_err:.3e} (tol 1e-5), "
          f"launches per vmult {counts}", flush=True)
    check(bool(torch.isfinite(y).all()) and got.shape == (mf.n_dofs,), "vmult output malformed")
    check(rel_err <= 1e-5, f"vmult disagrees with the float64 path: {rel_err:.3e}")
    for name in results:
        if name != "refill_update":
            check(counts[name] > 0, f"the vmult never launched {name}")
            results[name]["launches"] = counts[name]
    check(sum(counts.values()) == VMULT_LAUNCHES,
          f"{sum(counts.values())} kernel launches per vmult, not {VMULT_LAUNCHES}")
    vm_ms = time_ms(lambda: op.vmult(x), reps=30, warmup=5)
    vm_plain_ms = time_ms(lambda: op.vmult(x, plain=True), reps=10, warmup=2)
    print(f"vmult nref=7 p=4 f32 on {smi}: {vm_ms:.4f} ms ({mf.n_dofs / vm_ms / 1e6:.4f} "
          f"GDoF/s); plain path {vm_plain_ms:.4f} ms", flush=True)
    vm_host_ms = host_ms(lambda: op.vmult(x))
    ba_host_ms = host_ms(lambda: brick_apply.brick_apply(
        x, *op.brick_factors_host, op.geo, op.p, dcols=dcols, brick_size=op.B))
    print(f"host time to issue a vmult ({VMULT_LAUNCHES} launches): {vm_host_ms:.4f} ms; one fused "
          f"brick_apply: {ba_host_ms:.4f} ms", flush=True)
    vm_prof = profile_path("vmult", lambda: op.vmult(x), set(wrappers), VMULT_LAUNCHES)
    # the unconstrained operator at p=4 (cell_apply, corr_compact on the absent rows' codes,
    # brick_apply's epilogue, dss_surface) and the HN overhead vmult / vmult_plain
    ref = op64.vmult_plain(x64, plain=True)
    yp, pcounts = counted(wrappers, lambda: op.vmult_plain(x))
    pl_err = errors(yp, ref)[1]
    pcounts = {k: n for k, n in pcounts.items() if n}
    print(f"vmult_plain nref=7 p=4 f32 vs plain f64 path: max rel err {pl_err:.3e} (tol 1e-5), "
          f"launches {pcounts}", flush=True)
    check(bool(torch.isfinite(yp).all()) and yp.shape == x.shape, "vmult_plain output malformed")
    check(pl_err <= 1e-5, f"vmult_plain disagrees with the float64 path: {pl_err:.3e}")
    check(pcounts == PLAIN_LAUNCHES, f"vmult_plain launched {pcounts}, not {PLAIN_LAUNCHES}")
    vp_ms = time_ms(lambda: op.vmult_plain(x), reps=30, warmup=5)
    vp_prof = profile_path("vmult_plain", lambda: op.vmult_plain(x), set(wrappers),
                           sum(PLAIN_LAUNCHES.values()))
    print(f"vmult_plain nref=7 p=4 f32 on {smi}: {vp_ms:.4f} ms; HN overhead (vmult / "
          f"vmult_plain) {vm_ms / vp_ms:.4f}", flush=True)

    # ---- 6. refill, nref=7, float32, through the kernels --------------------
    ref = op64.refill(y.double(), plain=True)
    got, rcounts = counted(wrappers, lambda: op.refill(y))
    abs_err, rf_err = errors(got, ref)
    print(f"refill nref=7 f32 vs plain f64 refill: max rel err {rf_err:.3e} (tol 1e-5), "
          f"launches per refill {rcounts}", flush=True)
    check(bool(torch.isfinite(got).all()) and got.shape == y.shape, "refill output malformed")
    check(rf_err <= 1e-5, f"refill disagrees with the float64 path: {rf_err:.3e}")
    for name in ("hn_cell", "refill_update"):
        check(rcounts[name] > 0, f"refill never launched {name}")
    check(sum(rcounts.values()) == REFILL_LAUNCHES,
          f"{sum(rcounts.values())} kernel launches per refill, not {REFILL_LAUNCHES}")
    results["refill_update"]["launches"] = rcounts["refill_update"]
    rf_ms = time_ms(lambda: op.refill(y), reps=30, warmup=5)
    rf_plain_ms = time_ms(lambda: op.refill(y, plain=True), reps=10, warmup=2)
    rf_host_ms = host_ms(lambda: op.refill(y))
    print(f"refill nref=7 p=4 f32 on {smi}: {rf_ms:.4f} ms; plain path {rf_plain_ms:.4f} ms; "
          f"host time to issue a refill ({REFILL_LAUNCHES} launches) {rf_host_ms:.4f} ms",
          flush=True)
    rf_prof = profile_path("refill", lambda: op.refill(y), set(wrappers), REFILL_LAUNCHES)
    n_dofs4 = mf.n_dofs
    del op64, x64, ref, got, op, x, y, yp
    torch.cuda.empty_cache()

    # ---- 7. the index engine, nref=7, float32, through the kernels ----------
    t0 = time.perf_counter()
    index, index_records = index_phase(mt, tria, mf, dev, wrappers, smi)
    index["phase_s"] = time.perf_counter() - t0
    print(f"index engine phase: {index['phase_s']:.1f} s", flush=True)
    results.update(index_records)

    # ---- 8. the degree <= 3 schedule, float32 through the kernels -----------
    low, low_parts = {}, {}
    trias = {7: tria}
    for p, nref in LOW_DEGREES:
        if nref not in trias:
            trias[nref] = mt.create_quadrant(3, nref)
        numbers, parts = degree_phase(mt, trias[nref], nref, p, dev, wrappers, smi)
        low[f"p={p}"] = numbers
        for name, plist in parts.items():
            low_parts.setdefault(name, []).extend(plist)
    del trias
    for name, plist in low_parts.items():
        if name in results:  # an existing kernel at its new instances: parts beside p=4's
            results[name]["parts"].extend(plist)
            for part in plist:
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                                   part["max_abs_err"])
                results[name]["max_rel_err"] = max(results[name]["max_rel_err"],
                                                   part["max_rel_err"])
            continue
        mod = next(m for m in KERNEL_MODULES if m.NAME == name)
        rec = kernel_record(mod)
        rec["parts"] = plist
        main_part = next(part for part in plist
                         if part["mode"].startswith(f"p={LOW_MAIN_DEGREE}")
                         and part["call"] == "vmult")
        for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "launches"):
            rec[k] = main_part[k]
        rec["max_abs_err"] = max(part["max_abs_err"] for part in plist)
        rec["max_rel_err"] = max(part["max_rel_err"] for part in plist)
        results[name] = rec
    print("HN overhead (vmult / vmult_plain, f32) on " + smi + ": "
          + ", ".join([f"p=4 {vm_ms / vp_ms:.4f}"]
                      + [f"{k} {v['hn_overhead']:.4f}" for k, v in low.items()]), flush=True)

    # ---- 9. float64 through the kernels --------------------------------------
    tria4 = mt.create_quadrant(3, 4)
    mf4 = mt.MatrixFree(tria4, 4, dtype=np.float64)
    op4 = mt.BrickLaplaceMM(mf4, device=dev)
    u4 = np.random.default_rng(SEED).standard_normal(mf4.n_dofs)
    x4 = op4.from_dof_vector(u4)
    y4 = op4.vmult(x4)
    check_kernels(kernel_calls(op4, x4, y4)[0], 1e-12, "nref=4 f64")
    got4 = op4.to_dof_vector(y4, zero_hanging=True)
    ref4 = vmult_oracle(tria4, 4, u4)
    err4 = float(np.abs(got4.cpu().numpy() - ref4).max() / np.abs(ref4).max())
    print(f"vmult nref=4 f64 vs scipy oracle: max rel err {err4:.3e} (tol 1e-12)", flush=True)
    check(err4 <= 1e-12, f"float64 vmult disagrees with the oracle: {err4:.3e}")
    rf4 = errors(op4.refill(y4), op4.refill(y4, plain=True))[1]
    print(f"refill nref=4 f64 vs plain f64 refill: max rel err {rf4:.3e} (tol 1e-12)", flush=True)
    check(rf4 <= 1e-12, f"float64 refill disagrees with its plain path: {rf4:.3e}")
    tria6 = mt.create_quadrant(3, 2)
    mf6 = mt.MatrixFree(tria6, 6, dtype=np.float64)
    op6 = mt.BrickLaplaceMM(mf6, device=dev)
    u6 = np.random.default_rng(SEED).standard_normal(mf6.n_dofs)
    got6 = op6.to_dof_vector(op6.vmult(op6.from_dof_vector(u6)), zero_hanging=True)
    ref6 = vmult_oracle(tria6, 6, u6)
    err6 = float(np.abs(got6.cpu().numpy() - ref6).max() / np.abs(ref6).max())
    print(f"vmult nref=2 p=6 f64 vs scipy oracle: max rel err {err6:.3e} (tol 1e-12)",
          flush=True)
    check(err6 <= 1e-12, f"float64 p=6 vmult disagrees with the oracle: {err6:.3e}")
    t0 = time.perf_counter()
    index_f64_checks(mt, tria4, mf4, dev)
    print(f"index engine float64 checks: {time.perf_counter() - t0:.1f} s", flush=True)
    for p in (3, 2):  # the degree <= 3 schedule in float64 at quadrant nref=4
        mfp = mt.MatrixFree(tria4, p, dtype=np.float64)
        opp = mt.BrickLaplaceMM(mfp, device=dev)
        up = np.random.default_rng(SEED).standard_normal(mfp.n_dofs)
        xp = opp.from_dof_vector(up)
        yp = opp.vmult(xp)
        check_kernels(low_kernel_calls(opp, xp, yp)[0], 1e-12, f"nref=4 p={p} f64")
        errp = errors(opp.to_dof_vector(yp, zero_hanging=True).cpu(),
                      torch.from_numpy(vmult_oracle(tria4, p, up)))[1]
        print(f"vmult nref=4 p={p} f64 vs scipy oracle: max rel err {errp:.3e} (tol 1e-12)",
              flush=True)
        check(errp <= 1e-12, f"float64 p={p} vmult disagrees with the oracle: {errp:.3e}")
        for call in ("vmult_plain", "refill"):
            fn = getattr(opp, call)
            e = errors(fn(yp if call == "refill" else xp),
                       fn(yp if call == "refill" else xp, plain=True))[1]
            print(f"{call} nref=4 p={p} f64 vs its plain path: max rel err {e:.3e} (tol 1e-12)",
                  flush=True)
            check(e <= 1e-12, f"float64 p={p} {call} disagrees with its plain path: {e:.3e}")

    # ---- 10. the numbers -----------------------------------------------------
    print(json.dumps({"vmult": {"ms": vm_ms, "plain_ms": vm_plain_ms, "n_dofs": n_dofs4,
                                "gdofs_per_s": n_dofs4 / vm_ms / 1e6, "launches": counts,
                                "host_ms": vm_host_ms, "brick_apply_host_ms": ba_host_ms,
                                "profile": vm_prof, "card": smi},
                      "refill": {"ms": rf_ms, "plain_ms": rf_plain_ms, "launches": rcounts,
                                 "host_ms": rf_host_ms, "profile": rf_prof, "card": smi},
                      "vmult_plain": {"ms": vp_ms, "launches": pcounts, "profile": vp_prof,
                                      "hn_overhead": vm_ms / vp_ms, "card": smi},
                      "degrees": low}))
    print(json.dumps({"index": index}))
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
