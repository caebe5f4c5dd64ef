"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
2. build the 22 CUDA kernels from ``dealii_matrixfree_hanging_nodes_tpu_torch/csrc``
   (one nvcc per source, all at once), with each kernel's registers and spills,
   refill_update's and corr_compact's stack frames (refill_update must have none),
   brick_apply's shared memory and blocks per SM at each degree (3-D and 2-D),
   brick_deformed's threads, shared memory and blocks per SM at each (p, B, dim),
   the 2-D brick_elasticity's and hn_cell elastic mode's at p = 1..6, and
   brick_transfer's in both modes at each (dim, p), with the restriction's
   thread block clusters resident at once; a whole run makes phase 3's mesh
   and MatrixFree on the host while the nvcc processes run;
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
   quadrant nref=6 against the plain float64 path (1e-5); dof_scatter's
   schedule (its chunks, the shares of DoFs and entries local to a chunk,
   from the host tables) and beside it (a) a coalesced read of the rows and
   (b) the gather rows[ent] alone, timed with their bounds;
8. the degree <= 3 schedule, one phase a degree (``LOW_DEGREES``: p=3, 2
   and 1 on the nref=7 mesh, so that the whole run fits its time limit),
   float32 through the
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
10. the GMG-CG solve (solve_01.run_bricks at its defaults): the brick
   engine's BrickGMGPreconditioner at quadrant nref=6, p=4, float32 (levels
   nref 1..6, a dense coarse inverse), its setup seconds and each level's
   sizes; the device solver at tol 1e-5, max 100 iterations, after one
   warm-up solve: iterations, the relative residual (checked <= 1e-5),
   err_max against the manufactured solution (sum of sines, zero on the
   boundary) on the free DoFs, seconds a solve and an iteration, the two
   solves bit-identical (checked), the launches of the port's kernels in
   the solve (brick_transfer and dof_embed checked launched); one
   V-cycle's launches by kernel, the host's time to issue it and its
   profile (device busy, idle share; every launch outside the port's
   kernels a PyTorch elementwise op, reduction or the coarse dense product,
   each kind counted, anything else fails); the index GMG of solve_01.run
   (quadrant nref=3, p=2, float64, tol 1e-10) on the card against the plain
   path on the CPU (the same iteration count, solutions within 1e-9,
   cell_transfer checked launched); brick_transfer and dof_embed at every
   transfer of the V-cycle, and cell_transfer (beside it between the same
   nref 5 and 6 levels' index engines), in both modes against their plain
   versions (1e-5; the brick kernels' two calls bit-identical), timed with
   their bounds and library calls (each map composed into one CSR matrix),
   a V-cycle's device time in each brick kernel from those times and from
   the profile, and their side timings at the finest transfer (dof_embed on
   the CSR of its long rows alone and of its short rows alone,
   brick_transfer's rounds a block before and now);
11. linear elasticity (elasticity_01.py's operator, mu = lam = 1) on both
   engines, float32 through the kernels: at quadrant nref=7 p=4 (phase 3's
   mesh, 3 x 17.55 M component DoFs; the brick operators wrap phase 3's and
   phase 5's scalar tables) and at elasticity_01's default quadrant nref=5
   p=2: the brick vmult (5 launches) and vmult_plain (4) and the index vmult
   with and without constraints (2 and 2) against their plain float64 paths
   on the card (1e-5), launches checked exactly, two calls bit-identical,
   timed, GDoF/s as 3 n_dofs / time, the host's issue time, profiled (no
   device launch outside the port's kernels), the HN overhead of each
   engine; at nref=7 every elasticity kernel and component-axis call
   (cell_elasticity in both modes, hn_cell's elastic mode, corr_compact,
   brick_elasticity, dss_surface, dof_scatter) against its plain version
   (1e-5), timed with its bound and library call (component-axis kernels:
   their map as one CSR product or index_add_ over three columns;
   brick_elasticity: one torch.mm by the dense [3 N3, 3 N3] brick operator;
   none for cell_elasticity, whose bricks mode composes to a dense coupled
   Kel a cell, 9.2 G nonzeros, and hn_cell's elastic mode); at nref=5 p=2 the
   same kernels against their plain versions; float64 on both engines
   against the dense oracle (1e-12, mu=1.3, lam=0.7) at quadrant nref=2
   p=2, nref=3 p=3, step nref=2 p=1 and quadrant nref=2 p=4; every instance
   of cell_elasticity (index mode with codes, bricks mode) and
   brick_elasticity (with and without cell rows) at 3-D p=1..8 and 2-D
   p=1..6 in float32 and float64 against its plain version (1e-5, 1e-12),
   two calls bit-identical (``elastic_instance_checks``).
   ``python3 chip_smoke.py --elasticity`` runs phases 1, 2, this one and
   the 2-D elasticity of phases 14 and 16 alone (a partial run: it prints
   their JSON and a "partial" line, not the device line);
12. the multi-RHS vmult (``BrickLaplaceMM.vmult_multi``) at quadrant nref=7
   p=4 f32 (phase 3's mesh, phase 5's operators) for k = 1, 3, 8 against k
   back-to-back vmults: launches checked (5 a call at every k), every RHS
   bit-identical to vmult of it, CUDA-event medians of both, ms per vector
   and their ratio, the host's time to issue one call, the profile (device
   busy and idle share, no launch outside the port's kernels); at k=8 the
   f32 result against the plain f64 path (1e-5) and each kernel's RHS-axis
   instance against its plain version, timed with its bound and library
   call (the kernel's single-RHS matrix applied to k columns at once, one
   CSR product with a dense [n, k] block; brick_apply's dense operator by
   torch.mm over k x n_bricks rows); float64 bit-identical to stacked
   vmults at nref=7, and against the scipy oracle at quadrant nref=4 p=4
   k=3 (1e-12); the degree <= 3 schedule without face planes at k=8 (p=3
   on phase 8's nref=7 operator, p=2 and p=1 at nref=6): launches,
   bit-identity, time per vector; masked_quad's RHS-axis instance at p=3;
13. the deformed brick engine (``BrickLaplaceMM`` under high_order_mapping)
   at quadrant nref=7 p=4 f32 on phase 3's mesh: the setup by step (the
   metric's seconds, built on the card in float64 and kept on the host, and
   the traced peak bytes of the host's allocations meanwhile; the
   operator's structure, tables and transfer) and the metric's device bytes; brick_deformed (with
   and without cell rows) and the deformed modes of cell_apply and hn_cell
   against their plain versions (1e-5), timed with their bounds and library
   calls (cell_apply's and hn_cell's maps as one CSR product each, none for
   brick_deformed, its composed nonzeros printed); vmult (5 launches),
   vmult_plain (2) and refill (2) against the plain float64 path (1e-5),
   launches checked, two calls bit-identical, timed, the host's issue time,
   profiled (no device launch outside the port's kernels); the HN overhead;
   the deformed over the Cartesian vmult of phase 3's operator; the f32
   vmult against the deformed index vmult (1e-5); float64 at the reference's
   two cases and one case a (p, B) class (every kernel instance against its
   plain version, the vmult against the plain path and the deformed index
   engine, vmult_plain and refill against the plain path; 1e-12); p=2 at
   nref=6 (``DEFORMED_LOW``; vmult, vmult_plain and refill, launches
   checked, timed); brick_deformed's plan (threads, shared-memory bytes,
   blocks per SM) printed beside its times and bounds, as in phase 16.
   ``python3 chip_smoke.py --metric-host`` instead times the deformed metric
   on the host at once and in chunks (seconds, traced peak bytes, checked
   bit-identical) and prints one JSON line;
14. 2-D on the index engine (``index2d_phase``) at quadrant nref=11 p=4 f32
   (16,841,157 DoFs, uncut): the setup by step (the mesh, MatrixFree, the
   sorted runner's own setup, the all and matrix runners on the compact
   engine's tables, the device tables, the deformed engine and its host
   metric) and the sizes (cells, DoFs, constrained cells, codes, dofmap and
   row bytes); every 2-D instance against its plain version (1e-5), timed
   with its bound and library call: hn_interp by the four runners,
   cell_laplace fast / slow / constraints=False / deformed (each one's map
   composed into one CSR matrix, 657 M nonzeros: the Cartesian ones' blocks
   one a mask, the deformed one's a cell), dof_scatter on both maps and its
   component axis of 2 (``index_add_``), constraints_slow, cell_elasticity
   (no library call: its coupled map's 2.63 G nonzeros need int64 indices,
   on which cuSPARSE's SpMV failed; the count printed), cell_transfer at
   the 2-D GMG's finest transfer; dof_scatter's schedule shares (host);
   the vmult (fast, slow, constraints=False), the deformed vmult, the
   elasticity vmult and apply_hanging_node_constraints against the plain
   float64 path (1e-5), launches checked exactly (2, 4, 2, 2, 2, 1 and the
   copy), two calls bit-identical, timed (GDoF/s, host_ms, busy and idle
   share); each runner's vmult; the HN overhead fast and slow; float64
   against the scipy oracle at the reference's 2-D cases and elasticity
   against the dense oracle (1e-12); the GMG-CG solve at quadrant nref=10
   p=4 f32 (tol 1e-5: iterations, residual, seconds, a V-cycle's launches,
   host time and idle share) and at nref=4 p=2 f64 (tol 1e-10, the CPU
   plain path's iteration count, checked exactly);
15. 2-D on the brick engine (``brick2d_phase``) on phase 14's mesh
   (quadrant nref=11, not rebuilt; p=4 on phase 14's own MatrixFree, 16.8 M
   DoFs, then p=3, 2, 1 on a new MatrixFree each), float32: at each degree
   ``degree_phase`` as phase 8 runs it (the setup by step and the sizes:
   bricks, subset bricks, constrained rows, the dss work lists; every 2-D
   kernel instance against its plain version, 1e-5, timed with its bound
   and library call, made as in phases 4 and 8; vmult, vmult_plain and
   refill against the plain float64 path, 1e-5, launches checked exactly:
   5/4/2 at p=4, 5/3/2 at p=3, 8/3/3 at p <= 2, two calls bit-identical,
   timed with GDoF/s, host_ms and the busy and idle share); the HN
   overhead; the brick vmult over phase 14's index vmult on the same mesh;
   vmult_multi at k=8 and p=4 (5 launches, each RHS bit-identical to vmult
   of it); float64 against the scipy oracle at the reference's 2-D cases
   (1e-12);
16. the rest of 2-D on the brick engine (``brick2d_paths_phase``), f32:
   the deformed mapping at quadrant nref=11 p=4 on phase 14's deformed
   MatrixFree (brick_deformed with and without cell rows, the deformed
   modes of cell_apply and hn_cell against their plain versions, 1e-5,
   timed with bounds and library calls, brick_deformed's its map composed
   over the brick nodes as one CSR matrix; vmult, vmult_plain and refill
   against the plain float64 path with 5 / 2 / 2 launches, bit-identical,
   timed, profiled; GDoF/s; over phase 14's deformed index vmult; against
   the deformed index vmult, 1e-5), p=2 at nref=11, and float64 at the
   reference's 2-D deformed case and one a (p, B) class (1e-12); the 2-D
   brick GMG-CG at quadrant nref=9 p=4 (tol 1e-5: iterations, residual,
   seconds, a V-cycle's launches and profile; brick_transfer and dof_embed
   at every transfer against their plain versions, timed with bounds
   and library calls, and their side timings, as in phase 10) and at nref=4
   p=2 in float64 (tol 1e-10, the CPU
   plain path's count); the 2-D brick elasticity on phase 15's p=4
   operator (mu = lam = 1: vmult 5 launches, vmult_plain 4, the index
   vmults beside them, against the plain float64 path, timed, GDoF/s over
   2 n_dofs, profiled, the HN overhead, over phase 14's index elasticity;
   cell_elasticity's bricks mode, hn_cell's elastic mode, corr_compact and
   dss_surface at k = 2 and brick_elasticity against their plain
   versions, timed with bounds and library calls: the composed maps as
   CSR, the dense el_A by torch.mm) and float64 against the dense oracle
   at quadrant nref=3 p=2, 4 (1e-12, mu=1.3, lam=0.7);
17. the distributed engines (``distributed_phase``) on one NCCL rank (a
   default group of NCCL for CUDA tensors and gloo for CPU ones): at phase
   3's mesh, DistributedLaplace (allgather, halo) and DistributedBrickLaplace
   (halo, replicated) against the single-device engines (1e-5), their
   launches by kernel (``DIST_LAUNCHES``), two calls bit-identical, timed
   (ms, GDoF/s, over the single-device vmult) and profiled (the port's
   kernels, NCCL's launches counted by name apart, nothing else); the
   deformed brick engine at quadrant nref=6; float64 at nref=4 against the
   scipy oracle and the single-device engines (1e-12); halo_pack, dss_pools
   and chain_halo at the main path's shapes with bounds and library calls
   (CSR products), and on every rank's tables of the 4-rank plans at nref=5
   in f32 and f64; the distributed GMG-CG (float64 at nref=3 p=2: the CPU
   plain path's iterations; float32 at nref=5 p=4); 2 gloo ranks on the one
   card where gloo takes CUDA tensors in every collective the engines use
   (else the refusals are recorded). ``python3 chip_smoke.py --distributed``
   runs phases 1, 2 and this one alone; ``python3 chip_smoke.py --gmg``
   phases 1, 2, 10 and phase 16's 2-D brick GMG alone (a partial run: it
   prints their JSON and a "partial" line, not the device line);
18. a JSON line with the vmult's, vmult_plain's and refill's numbers and
   each degree's, one with the index engine's, one with the GMG solve's,
   one with elasticity's, one with the multi-RHS vmult's, one with the
   deformed brick engine's, one with the 2-D index engine's, one with the
   2-D brick engine's, one with phase 16's, one with phase 17's, one with the
   kernels' numbers (all 22; the new instances as parts named by degree;
   masked_quad's, plane_fill's and plane_fold's totals from p=2; the GMG
   kernels' launches from the solve that runs them; elasticity's calls of
   the existing kernels, the RHS-axis instances, "multi k=8 <kernel>", and
   the deformed modes, "deformed p=4", as parts; brick_deformed's totals
   from its vmult launch; the 2-D instances as parts named "2-D ...", the
   brick engine's "2-D brick p=<d> ...", phase 16's "2-D ..."), then the
   device line.

Each phase prints its wall seconds on a line of its own, ``phase N (name):
S s``. ``python3 chip_smoke.py --index`` runs phases 1, 2, 7, phase 9's
index-engine float64 checks and phase 14's Laplace paths (no elasticity, no
GMG-CG) alone; ``python3 chip_smoke.py --deformed`` phases 1, 2, 13 and
phase 16's deformed mapping alone (its own 2-D deformed MatrixFree, the
deformed index vmult timed for the ratio); both are partial runs: they print
their JSON and a "partial" line, not the device line.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}  # outside the tensor cores
SEED = 0
VMULT_LAUNCHES, REFILL_LAUNCHES = 5, 2
PLAIN_LAUNCHES = {"cell_apply": 1, "corr_compact": 1, "brick_apply": 1, "dss_surface": 1}
# the degree <= 3 phases: (degree, quadrant nref), each in float32 through the kernels, at
# nref=7 so that the whole run fits its time limit
LOW_DEGREES = ((3, 7), (2, 7), (1, 7))
MASKED_CSR_CAP = 300_000_000  # masked_quad's library matrix: entries before summation
# the kernel of the degree <= 3 schedule whose parts give a new kernel's totals
LOW_MAIN_DEGREE = 2
LIBRARY_TOL = 1e-4  # a library yardstick against the plain version, float32, relative
# profile_path's sessions at most, to record every call of a profile (see profile_path)
PROFILE_SESSIONS = 10


def session_reps(reps: int, attempt: int, recorded: bool) -> int:
    """Calls in profile session `attempt` (from 0): `reps`, and where no session so far
    recorded a call, 2, 4, then 8 times as many (``profile_path``)."""
    return reps if recorded or attempt == 0 else reps * 2 ** min(attempt, 3)


# parts timed in phase 4 that refill launches and the vmult does not: in the
# kernels line they stand in "parts" only, and a kernel's totals are those
# of its vmult launches
REFILL_PARTS = {("hn_cell", "fill")}


def phase_seconds(n, what, t0) -> float:
    """Print phase n's wall seconds since t0 on a line of its own; return them."""
    seconds = time.perf_counter() - t0
    print(f"phase {n} ({what}): {seconds:.1f} s", flush=True)
    return seconds


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


ELEMENTWISE_KERNELS = ("at::native::vectorized_elementwise_kernel",
                       "at::native::unrolled_elementwise_kernel", "at::native::elementwise_kernel")


def kernel_name(key: str) -> str:
    """A device launch's kernel name without its return type, template
    arguments and parameters (cuBLAS's gemv returns a SFINAE
    ``std::enable_if<...>::type``)."""
    if key.startswith("std::enable_if<"):
        depth = 0
        for i, c in enumerate(key):
            depth += (c == "<") - (c == ">")
            if c == ">" and depth == 0:
                break
        key = key[i + 1:].removeprefix("::type ")
    key = key.removeprefix("void ").replace("(anonymous namespace)", "anonymous")
    return key.split("<", 1)[0].split("(", 1)[0]


def launch_class(key: str):
    """The kind of a device launch outside the port's kernels that the GMG
    solve may make, from the kernel's name (its template arguments left
    out): a PyTorch elementwise op (the vector updates, masks and fills), an
    index (the owner-copy gather of ``DofEmbed.extract``), a reduction (the
    dots and norms: PyTorch's, or cuBLAS's dot and its final block sum), a
    copy to the host (a CG residual test's read), or a dense product (the
    coarse level's ``torch.matmul``); None for anything else
    (``index_add_``, a scatter or a batched product of a plain version among
    them)."""
    if key.startswith("Memcpy DtoH"):
        return "copy"
    head = kernel_name(key)
    if head in ELEMENTWISE_KERNELS:
        return "elementwise"
    if head == "at::native::index_elementwise_kernel" or "gather" in head:
        return "index"
    if head in ("at::native::reduce_kernel", "dot_kernel", "reduce_1Block_kernel"):
        return "reduction"
    if "gemv" in head.lower() or "gemm" in head.lower():
        return "dense product"
    return None


def profile_path(what, fn, kernel_names, expect: int, reps: int = 10, copies: int = 0,
                 classes: dict | None = None, collectives: bool = False):
    """Where one call's time goes: device time by kernel from torch.profiler
    over `reps` calls of fn, the port's kernels against everything else, and
    the device's idle share of the wall time. CUPTI has left out whole calls
    of a session (1-3 of 10 at degree <= 3), and single records too (one
    device copy of ten, with every kernel of the ten calls kept), so the
    numbers are per call recorded: the port's kernel records over `expect`
    launches a call (the launches themselves are counted exactly by
    ``counted``). Each session first runs fn in `warm` profiler warm-up
    steps, whose records are dropped, so the `reps` recorded calls start
    with the tracer running. Sessions that recorded none of the calls have
    come in streaks, up to five in a row on an H100, and so have sessions that
    lost the same first calls; neither an idle lead nor a spin kernel across
    the window's start stopped that (``profiler_probe.py`` counts such
    sessions by variant), so a profile runs up to ``PROFILE_SESSIONS``
    sessions. Late in the process sessions have kept only a call's last
    records, the same number in every session of a profile (2.25 of 10
    calls of 4 launches, 3 of 10 of 2), and a short call none at all in ten
    sessions in a row: after a session that recorded no call, the next ones
    run 2, 4, then 8 times `reps` calls (``session_reps``), so that the
    window outlasts what is lost. A session is whole where it recorded the
    port's kernels of every call and, of the launches outside them that are
    pinned (`copies`, and the kinds that `classes` names), `reps` times the
    pinned number. collectives: the backend's collective launches (NCCL's kernels
    and device-to-device copies, which the distributed engines' own kernels never make) are
    counted by name apart (``collective_launches``, per call) and left out of the other
    launches and their checks; their time counts in the device's busy time.
    The first whole session of ``PROFILE_SESSIONS`` is kept, else the one
    that recorded the most; from such a partial session the device's busy,
    other and idle time are not measured (None: its records, averaged over
    the calls they hold, have read busy above the wall clock, as the 2-D
    vmult_multi's kept 22 of 50 launches in all five sessions of a run). Fails where
    no session saw device time, or where
    the kept one saw any device launch outside the port's kernels other than
    `copies` device-to-device copies a call (the copy that keeps an input
    unwritten). Only where all sessions recorded every kernel but lost
    a device copy's record (seen once on an H100, in one whole run) do the
    copies count from the host's runtime calls (``cudaMemcpyAsync``, `reps`
    times `copies`); the device's busy and idle time, short of the lost
    copy, are then not measured (None). With classes ({kind: launches a call}), the launches outside
    the port's kernels may be PyTorch elementwise ops, in any number, and
    the kinds of ``launch_class`` that `classes` names, each exactly as
    often as it says (None: in any number); any other launch fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    warm = 2  # profiler steps whose records are dropped: the tracer starts in them
    # a later profiler session in one process has been seen to record no device
    # activity at all while the calls ran (once in a dozen runs on an H100): such
    # a session is run again, up to PROFILE_SESSIONS in all, as is one that left out calls
    ours = lambda key: any(k in key for k in kernel_names)

    def pinned(rows, n):
        """The pinned launches outside the port's kernels that a session recorded,
        against the number that n whole calls make."""
        if classes is None:
            got = sum(c for _, c, key in rows if not ours(key) and "Memcpy DtoD" in key)
            return got == copies * n
        kinds = {}
        for _, c, key in rows:
            if not ours(key):
                kinds[launch_class(key)] = kinds.get(launch_class(key), 0) + c
        return all(kinds.get(k, 0) == m * n
                   for k, m in classes.items() if k != "elementwise" and m is not None)

    best = None
    for attempt in range(PROFILE_SESSIONS):
        n = session_reps(reps, attempt, best is not None and best[0][1] > 0)
        # hand the allocator's cached device memory back first: CUPTI allocates its own device
        # buffers for the kernel records, and the sessions that lost records came late in the
        # process, after the phases that hold tens of GB
        torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True, schedule=schedule(wait=0, warmup=warm, active=n)) as prof:
            for _ in range(warm):
                fn()
                torch.cuda.synchronize()  # recording starts at the last step: nothing running
                prof.step()
            t0 = time.perf_counter()
            for i in range(n):
                fn()
                if i < n - 1:  # the last active step ends with the session
                    prof.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        rows, crows = [], []  # device kernels only: the aten ops would count twice
        for ev in prof.key_averages():
            # the schedule's step annotation spans the step on the device's timeline; it
            # is no launch
            if ev.device_type != DeviceType.CUDA or ev.key.startswith("ProfilerStep"):
                continue
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            if dev_us > 0:
                backend = collectives and ("nccl" in ev.key.lower()
                                           or ev.key.startswith("Memcpy DtoD"))
                (crows if backend else rows).append((dev_us / 1e3, ev.count, ev.key))
        host_copies = sum(ev.count for ev in prof.key_averages()
                          if ev.device_type == DeviceType.CPU and ev.key == "cudaMemcpyAsync")
        calls = sum(r[1] for r in rows if ours(r[2])) / expect
        whole = bool(rows) and calls == n and pinned(rows, n)
        if best is None or (whole, calls) > best[0]:
            best = ((whole, calls), rows, wall_ms, host_copies, crows, n)
        if whole:
            break
        print(f"profile of the {what}: the profiler recorded the port's kernels of {calls:g} "
              f"of {n} calls{'' if calls != n else ', not every pinned launch'} "
              f"(session {attempt + 1} of {PROFILE_SESSIONS})", flush=True)
    (whole, calls), rows, wall_ms, host_copies, crows, reps = best
    check(bool(rows) and calls > 0, f"the profiler saw no device time in the {what}")
    rows = [(ms / calls, count / calls, key) for ms, count, key in rows]
    crows = [(ms / calls, count / calls, key) for ms, count, key in crows]
    coll_ms = sum(r[0] for r in crows)
    busy = sum(r[0] for r in rows) + coll_ms
    own_ms = sum(r[0] for r in rows if ours(r[2]))
    n_copies = sum(r[1] for r in rows if not ours(r[2]) and "Memcpy DtoD" in r[2])
    # every session kept each call's kernels and lost a device copy's record, while the host
    # issued every copy: the copies count from the host, and busy and idle are not measured
    lost_copy = (classes is None and not whole and calls == reps
                 and n_copies < copies == host_copies / reps)
    by_kernel = {name: sum(r[0] for r in rows if name in r[2]) for name in sorted(kernel_names)}
    res = dict(wall_ms=wall_ms, busy_ms=busy if whole else None,
               idle_share=1 - busy / wall_ms if whole else None,
               port_kernels_ms=own_ms,
               port_kernels_by_name={k: v for k, v in by_kernel.items() if v > 0},
               other_ms=busy - own_ms - coll_ms if whole else None,
               calls_recorded=calls, port_launches=sum(r[1] for r in rows if ours(r[2])),
               other_launches=sum(r[1] for r in rows if not ours(r[2])))
    print(f"profile (per {what}, {calls:g} of {reps} calls recorded): wall {wall_ms:.4f} ms, "
          + (f"device busy and idle not measured (CUPTI kept {n_copies:g} of the {copies} "
             f"device copies a call that the host issued, in all {PROFILE_SESSIONS} sessions)"
             if lost_copy else f"device busy {busy:.4f} ms (idle "
             f"{100 * res['idle_share']:.1f} %)" if whole else
             f"device busy and idle not measured (no whole session of {PROFILE_SESSIONS})")
          + f", port kernels {own_ms:.4f} ms in {res['port_launches']:g} launches, other "
          f"device work {'' if whole else 'not measured, '}"
          f"{f'{busy - own_ms - coll_ms:.4f} ms ' if whole else ''}in "
          f"{res['other_launches']:g} launches")
    if collectives:
        res["collective_ms"] = coll_ms
        res["collective_launches"] = {kernel_name(key): count for _, count, key in crows}
        print(f"  the backend's collectives: {coll_ms:.4f} ms, launches by name "
              f"{res['collective_launches']}", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:15]:
        print(f"  {ms:9.4f} ms  x{count:<4.3g} {key[:90]}")
    if classes is not None:
        kinds, heads = {}, {}
        for ms, count, key in rows:
            if not ours(key):
                kind = launch_class(key)
                check(kind is not None, f"the {what} launched {key!r}: neither a port kernel nor "
                                        f"a PyTorch elementwise op, index, reduction, copy to "
                                        f"the host or dense product")
                kinds[kind] = kinds.get(kind, 0) + count
                head = kernel_name(key)
                heads[head] = heads.get(head, 0) + count
        res["other_by_kind"] = kinds
        print(f"  launches outside the port's kernels by kind: {kinds}; by kernel: {heads}",
              flush=True)
        for kind in ("index", "reduction", "dense product", "copy"):
            got, want = kinds.get(kind, 0), classes.get(kind, 0)
            check(want is None or abs(got - want) < 1e-9,
                  f"the {what} made {got:g} {kind} launches a call, {want} expected")
        return res
    res["host_copies"] = host_copies / reps
    check(res["other_launches"] == n_copies and (n_copies == copies or lost_copy),
          f"{res['other_launches']} device launches per {what} outside the port's kernels "
          f"({n_copies} of them device copies, the host issued {res['host_copies']:g}; "
          f"{copies} expected)")
    return res


def prime_profiler(what, fn, sessions=2 * PROFILE_SESSIONS):
    """Throwaway torch.profiler sessions over fn (the schedule of
    ``profile_path``, nothing kept) until one records device time, at most
    `sessions`, each after the first running 2, 4, then 8 times the calls
    (``session_reps``, as ``profile_path`` does after an empty session);
    fails, as ``profile_path`` does, where none did. Returns how many ran.
    After the process group's NCCL setup the first profile has lost up to
    ten sessions in a row on an H100 (and all ten priming sessions of three
    calls once), so phase 17 primes the tracer before its first
    profile: a larger session budget for that profile, whose count is
    printed and kept in phase 17's JSON."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for n in range(1, sessions + 1):
        active = session_reps(3, n - 1, False)
        torch.cuda.empty_cache()  # as profile_path: room for CUPTI's device buffers
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True,
                     schedule=schedule(wait=0, warmup=2, active=active)) as prof:
            for _ in range(2 + active):
                fn()
                torch.cuda.synchronize()
                prof.step()
        if any(ev.device_type == DeviceType.CUDA and not ev.key.startswith("ProfilerStep")
               for ev in prof.key_averages()):
            break
    else:
        check(False, f"the profiler saw no device time in {sessions} sessions priming the {what}")
    print(f"profiler primed for the {what}: {n} throwaway session(s)", flush=True)
    return n


def sparse_csr(rows, cols, vals, shape):
    """A CSR matrix on the card from COO entries (the library yardsticks)."""
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape).coalesce() \
        .to_sparse_csr()


def yardsticks(op, inter, K, cell=True, keep=None):
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
    keep: a dict that receives the composed matrices by kernel (phase 12
    applies them to k columns). Returns ({name: [fn per part]}, {hn_cell
    mode: [fn per step]}, {matrix: nonzeros})."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import refill_update
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

    def hn_composed(mode):
        """hn_cell[mode] as one matrix from u_sub to the rows (``hn_map``)."""
        Qf = hn_dense(op, "fwd", dt)
        maps = Qf if mode == "fill" else hn_dense(op, "bwd", dt) @ K @ Qf
        q = op.hn_q.long()
        qq = torch.where(q >= 0, q, maps.shape[0] - 1)
        return hn_map(op, maps, qq, fill_rows, fill_cols, u_sub.numel(),
                      op.geo_hn if mode == "full" else None)

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

    fill_rows, fill_cols = fill_entries(op)
    fill = sparse_csr(fill_rows, fill_cols, torch.ones(len(fill_rows), dtype=dt, device=dev),
                      (nS, u_sub.numel()))
    corr = corr_matrix(op, plain_rows is not None, dt)
    fwd, bwd = hn_matrix("fwd"), hn_matrix("bwd")
    x_fwd, x_bwd, x_u = filled.reshape(-1), own.reshape(-1), u_sub.reshape(-1)
    x_corr = sub_raw.reshape(-1) if plain_rows is None else torch.cat(
        [sub_raw.reshape(-1), plain_rows.reshape(-1)])
    fill_steps = [lambda: fill @ x_u, lambda: fwd @ x_fwd]
    one = {f"hn_cell[{mode}]": hn_composed(mode) for mode in ("full", "fill")}
    one.update(refill_update=refill_composed(), dss_surface=dss_matrix(op, dt))
    if cell:
        one["cell_apply"] = cell_composed()
    if keep is not None:
        keep.update(corr_compact=corr, hn_cell=one["hn_cell[full]"],
                    dss_surface=one["dss_surface"], cell_apply=one.get("cell_apply"))
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


def fill_entries(op):
    """hn_cell's fill as (row, source) pairs over the constrained rows' slots
    (row h slot j at h n_loc + j) and the flat subset brick nodes: the kept
    own nodes, then the fill lists' entries."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.cell_apply import cell_nodes

    dev, n_loc = op.hn_sub.device, op.n_loc
    ptr = op.fill_row_ptr
    ent_row = torch.repeat_interleave(torch.arange(ptr.numel() - 1, device=dev),
                                      (ptr[1:] - ptr[:-1]).long())
    kept = torch.nonzero(op.keep_hn.reshape(-1))[:, 0]
    nodes = cell_nodes(op.hn_sub, op.B, op.p, op.N3p, dev).reshape(-1)
    return (torch.cat([kept, ent_row * n_loc + op.fill_ent_slot.long()]),
            torch.cat([nodes[kept], op.fill_ent_src.long()]))


def hn_dense(op, d, dt):
    """[nQ + 1, n_loc, n_loc]: hn_cell's Q lists in direction d ("fwd",
    "bwd") as dense maps, out_row = Q @ in_row, the last one the identity."""
    dev, n_loc = op.hn_q.device, op.n_loc
    ptr, col = getattr(op, f"hn_{d}_ptr").long(), getattr(op, f"hn_{d}_col").long()
    nq, n_ent = ptr.shape[0], int(ptr[-1, -1]) if ptr.numel() else 0
    slots = torch.repeat_interleave(torch.arange(n_loc, device=dev).repeat(nq),
                                    (ptr[:, 1:] - ptr[:, :-1]).reshape(-1))
    Q = torch.eye(n_loc, dtype=dt, device=dev).repeat(nq + 1, 1, 1)
    Q[:nq] = 0
    Q.index_put_((torch.repeat_interleave(torch.arange(nq, device=dev), ptr[:, -1] - ptr[:, 0]),
                  slots, col[:n_ent]), getattr(op, f"hn_{d}_w")[:n_ent], accumulate=True)
    return Q


def hn_map(op, maps, which, fill_rows, fill_cols, n_cols, scale=None):
    """hn_cell as one CSR matrix from the subset brick nodes to the rows:
    fill entry (row r, slot j, source s) contributes column j of row r's
    dense map maps[which[r]] (times scale[r]) to column s."""
    n_loc = op.n_loc
    r, j = fill_rows // n_loc, fill_rows % n_loc
    vals = maps[which[r], :, j]
    if scale is not None:
        vals = vals * scale[r][:, None]
    rows = r[:, None] * n_loc + torch.arange(n_loc, device=vals.device)
    nz = vals != 0
    return sparse_csr(rows[nz], fill_cols[:, None].expand(-1, n_loc)[nz], vals[nz],
                      (op.n_hn * n_loc, n_cols))


def corr_matrix(op, with_plain: bool, dt):
    """corr_compact's map on a brick operator's tables as one CSR matrix
    over sub_raw and plain stacked (plain only where with_plain): each run's
    entries add into their dcols slot, a constrained row keeps sub_raw at
    its kept slots, and the plain value comes off every constrained and
    absent row."""
    n_loc, dev = op.n_loc, op.cell_code.device
    ar = lambda n: torch.arange(n, device=dev)
    nS = op.n_hn * n_loc
    kept = torch.nonzero(op.keep_hn.reshape(-1))[:, 0]
    code = op.corr_tables()[0].long()
    n_rows = code.numel()
    hn_cells = op.hn_sub.long()
    minus = (torch.nonzero(code != -1)[:, 0][:, None] * n_loc + ar(n_loc)).reshape(-1)
    if not with_plain:
        minus = minus[:0]
    return sparse_csr(
        torch.cat([torch.repeat_interleave(op.corr_seg_dst.long(),
                                           (op.corr_seg_ptr[1:] - op.corr_seg_ptr[:-1]).long()),
                   (hn_cells[:, None] * n_loc + ar(n_loc)).reshape(-1)[kept], minus]),
        torch.cat([op.corr_ent_src.long(), kept, nS + minus]),
        torch.cat([torch.ones(op.corr_ent_src.numel() + len(kept), dtype=dt, device=dev),
                   -torch.ones(len(minus), dtype=dt, device=dev)]),
        (n_rows * n_loc, nS + (n_rows * n_loc if with_plain else 0)))


def dss_matrix(op, dt):
    """dss_surface as one matrix on a brick vector [n_bricks, N3p], from
    dss_surface's own tables: a valid copy of a pool takes the sum of the
    pool's copies, a node off the surface keeps its value unless it is
    padding or a hole, every other node is zero."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import dss_surface

    dev = op.cell_code.device
    ar = lambda n: torch.arange(n, device=dev)
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
    N3 = op.N3
    n = op.n_bricks * op.N3p
    keeps = torch.zeros((op.n_bricks, op.N3p), dtype=torch.bool, device=dev)
    keeps[:, :N3] = True
    keeps[:, torch.from_numpy(dss_surface.surface_nodes(NB, op.dim)).to(dev)] = False
    hole = dss_surface.bit_set(hole_bits, ar(len(hole_bricks))[:, None], ar(N3))
    keeps[hole_bricks, :N3] = keeps[hole_bricks, :N3] & ~hole
    own_node = torch.nonzero(keeps.reshape(-1))[:, 0]
    rows, cols = torch.cat(rows + [own_node]), torch.cat(cols + [own_node])
    return sparse_csr(rows, cols, torch.ones(len(rows), dtype=dt, device=dev), (n, n))


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
            brick_apply.bytes_and_flops(op.n_bricks, op.NB, op.p, op.N3p, isz, op.n_sub),
            None, None,
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
    lib, hn_steps, nnz = yardsticks(op, inter, K, cell=False)
    hn_steps = {f"p={op.p} {mode}": fns for mode, fns in hn_steps.items()}
    lib["brick_apply"] = [brick_library(op, inter["u"])]
    dev, dt = K.device, K.dtype
    ar = lambda n: torch.arange(n, device=dev)

    def masked_csr(kind, v, u):
        M = masked_matrix(op, kind, K, nnz)
        if M is None:
            return None
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


def masked_matrix(op, kind, K, nnz):
    """masked_quad[kind]'s map as one CSR matrix over [v; u] (v [nb, N3p]
    and u of its shape): v kept, each selected cell's geo K_cell taken off
    at its nodes; None where its entries before summation pass
    MASKED_CSR_CAP. Its nonzeros (or the entries not built) go into nnz."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import masked_quad
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.cell_apply import cell_nodes

    dev, dt = K.device, K.dtype
    ar = lambda n: torch.arange(n, device=dev)
    cells = masked_quad.selected_cells(*op.masked_tables(kind), op.B)
    n_ent = cells.numel() * op.n_loc**2
    if n_ent > MASKED_CSR_CAP:
        nnz[f"masked_quad[{kind}] (not built, entries)"] = n_ent
        return None
    nodes = cell_nodes(cells, op.B, op.p, op.N3p, dev)
    N = op.n_bricks * op.N3p
    vals = -(op.geo[cells // op.C][:, None, None] * K[None])
    M = sparse_csr(
        torch.cat([ar(N), nodes[:, :, None].expand(-1, op.n_loc, op.n_loc).reshape(-1)]),
        torch.cat([ar(N), N + nodes[:, None, :].expand(-1, op.n_loc, op.n_loc).reshape(-1)]),
        torch.cat([torch.ones(N, dtype=dt, device=dev), vals.reshape(-1)]), (N, 2 * N))
    nnz[f"masked_quad[{kind}]"] = M._nnz()
    return M


# kernel launches per call of the per-cell schedule (p >= 4): phases 5, 6 and 15
HIGH_LAUNCHES = {"vmult": {"cell_apply": 1, "hn_cell": 1, "corr_compact": 1, "brick_apply": 1,
                           "dss_surface": 1},
                 "vmult_plain": PLAIN_LAUNCHES, "refill": {"hn_cell": 1, "refill_update": 1}}


def degree_phase(mt, tria, nref, p, dev, wrappers, smi, keep=None, mf=None, tag=""):
    """One degree of the degree <= 3 schedule at quadrant nref, float32
    through the kernels: the setup and its sizes; every kernel against its
    plain version, timed with its bound and library call; vmult,
    vmult_plain and refill against the plain float64 path (1e-5), with
    their launches counted and checked, their times, the HN overhead
    (vmult over vmult_plain) and their profiles. keep: a dict that receives
    the float32 operator under its degree (phase 12 reuses it). Every call
    is also checked bit-identical over two calls and reported in GDoF/s.
    Phase 15 runs it on 2-D meshes at every degree (tag "2-D brick ", a
    prefix of the parts' modes and of the printed lines; p >= 4 runs the
    per-cell schedule's kernels, as phases 4-6 do), on a MatrixFree mf it
    was given or builds. Returns (numbers, {kernel: [part]})."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import auto_brick_size, kronecker_sum

    tol = 1e-5
    t0 = time.perf_counter()
    if mf is None:
        mf = mt.MatrixFree(tria, p, dtype=np.float32)
    t1 = time.perf_counter()
    op = mt.BrickLaplaceMM(mf, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_steps = dict(matrix_free=t1 - t0, **op.setup_s,
                       device=time.perf_counter() - t1 - sum(op.setup_s.values()))
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
    hole_bits = op.dss_hole_bits.cpu().numpy()
    sizes.update(dim=op.dim, fill_entries_chain=op.fill_ent_src.numel(),
                 fold_entries=op.corr_ent_src.numel(), fold_runs=op.corr_seg_dst.numel(),
                 dss_face_entries=op.dss_face_pairs.shape[0],
                 dss_edge_pools=op.dss_edge_pools.shape[0],
                 dss_corner_pools=op.dss_corner_pools.shape[0],
                 dss_hole_bricks=hole_bits.shape[0],
                 dss_hole_nodes=int(np.unpackbits(hole_bits.view(np.uint8)).sum()))
    print(f"{tag}setup p={p}: {setup_s:.1f} s (quadrant nref={nref} f32, B={op.B}, NB={op.NB}), "
          f"seconds by step {json.dumps(setup_steps)}: {json.dumps(sizes)}", flush=True)
    check(op.assembled == (p <= 3) and op.planes == (p <= 2),
          f"{tag}p={p} does not run the reference's schedule at its degree")
    if p <= 2:
        check(sizes["plane_covered_cells"] > 0, f"{tag}p={p}: no plane-covered cell")
    u = np.random.default_rng(SEED).standard_normal(mf.n_dofs).astype(np.float32)
    x = op.from_dof_vector(u)
    y = op.vmult(x)
    K = torch.from_numpy(kronecker_sum(op.K1.cpu().numpy(), op.M1.cpu().numpy(),
                                       op.dim)).to(dev, x.dtype)
    if op.assembled:
        calls, inter = low_kernel_calls(op, x, y)
        lib, hn_steps, nnz = low_yardsticks(op, inter, K)
    else:  # the per-cell schedule, as phases 4-6 run it
        calls, inter = kernel_calls(op, x, y)
        lib, hn_steps, nnz = yardsticks(op, inter, K)
        lib["brick_apply"] = [brick_library(op, x)]
    print(f"{tag}p={p}: maps composed into one CSR matrix each (the library calls), nonzeros: "
          f"{nnz}", flush=True)
    parts = {name: measure_parts(name, cparts, lib.get(name, [None] * len(cparts)), hn_steps,
                                 x.dtype, tol)
             for name, cparts in calls.items()}
    del calls, inter, lib
    torch.cuda.empty_cache()

    op64 = mt.BrickLaplaceMM(mf, device=dev, dtype=torch.float64)
    x64 = x.double()
    expect = low_launches(op) if op.assembled else HIGH_LAUNCHES
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
        same = bool(torch.equal(fn(), fn()))
        print(f"{tag}{call} p={p} f32 vs plain f64 path: max rel err {err:.3e} (tol {tol:g}), "
              f"launches {n}, two calls bit-identical: {same}", flush=True)
        check(bool(torch.isfinite(out).all()) and out.shape == x.shape,
              f"{tag}{call} p={p} malformed")
        check(err <= tol, f"{tag}{call} p={p} disagrees with the float64 path: {err:.3e}")
        check(n == expect[call], f"{tag}{call} p={p} launched {n}, not {expect[call]}")
        check(same, f"two {tag}{call} p={p} calls differ")
        ms = time_ms(fn, reps=20, warmup=3)
        plain_ms = time_ms(lambda: {"vmult": op.vmult, "vmult_plain": op.vmult_plain,
                                    "refill": op.refill}[call](
            x if call != "refill" else outs["vmult"], plain=True), reps=5, warmup=1)
        res[call] = dict(ms=ms, plain_ms=plain_ms, max_rel_err=err, launches=n,
                         host_ms=host_ms(fn, reps=20), gdofs_per_s=mf.n_dofs / ms / 1e6,
                         profile=profile_path(f"{tag}{call} p={p}", fn, set(wrappers),
                                              sum(expect[call].values())))
    overhead = res["vmult"]["ms"] / res["vmult_plain"]["ms"]
    print(f"{tag}p={p} nref={nref} f32 on {smi}: vmult {res['vmult']['ms']:.4f} ms "
          f"({mf.n_dofs / res['vmult']['ms'] / 1e6:.4f} GDoF/s), vmult_plain "
          f"{res['vmult_plain']['ms']:.4f} ms, refill {res['refill']['ms']:.4f} ms; "
          f"HN overhead (vmult / vmult_plain) {overhead:.4f}", flush=True)
    for name, plist in parts.items():  # each part's launches in the call that runs it
        for part in plist:
            call = ("refill" if name == "refill_update" or part["mode"].endswith("fill")
                    and name == "hn_cell" else
                    "vmult_plain" if part["mode"].endswith("absent") else "vmult")
            part["launches"] = counts[call].get(name, 0)
            part["call"] = f"{tag}{call}"
            mode = part["mode"]
            part["mode"] = f"{tag}{mode if mode.startswith('p=') else f'p={p} {mode}'}"
    numbers = dict(p=p, nref=nref, B=op.B, setup_s=setup_s, setup_steps_s=setup_steps,
                   sizes=sizes, hn_overhead=overhead, **res, card=smi)
    if keep is not None:
        keep[p] = op
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
    [N3, N3] (Mz (x) (My (x) Kx + Ky (x) Mx) + Kz (x) My (x) Mx; in 2-D My (x)
    Kx + Ky (x) Mx), the same for every brick, so one torch.mm over the
    bricks computes it, with geo
    applied to the input outside the timed call, TF32 off; k right-hand
    sides x [k, n_bricks, N3p] go in as k x n_bricks rows. Returns (call,
    the plain version without cell rows, which the call is held against):
    the cell rows' overlap-add keeps its own index_add_ yardstick."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import brick_apply

    torch.backends.cuda.matmul.allow_tf32 = False
    Kb, Mb = op.Kb.double(), op.Mb.double()
    A = torch.kron(Mb, Kb) + torch.kron(Kb, Mb)
    if op.dim == 3:
        A = torch.kron(Mb, A) + torch.kron(Kb, torch.kron(Mb, Mb))
    A = A.to(x.dtype)
    xs = (x * op.geo[:, None])[..., : op.N3].reshape(-1, op.N3).contiguous()
    return (lambda: torch.mm(xs, A.T), lambda: brick_apply.brick_apply_plain(
        x, op.Kb, op.Mb, op.geo, op.p)[..., : op.N3].reshape(-1, op.N3))


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
DEFORMED_NREF = 6  # the deformed index vmult's mesh (PERF.md section 4)


def index_kernel_calls(mfs, x, rows, deformed=None, deformed_nref=DEFORMED_NREF):
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
        launches.append((f"vmult deformed nref={deformed_nref}", *deformed, False, True))
    for part, m, src, slow, hn in launches:
        args = (src, *m.cell_laplace_args(dev, dt, slow=slow, hn=hn))
        calls["cell_laplace"].append((
            part, lambda a=args, f=m.kernel_factors: cell_laplace.cell_laplace(*a, factors=f),
            lambda a=args: cell_laplace.cell_laplace_plain(*a),
            cell_laplace.bytes_and_flops(*args), None, None))
    fac = mf.kernel_factors
    rows_fast = cell_laplace.cell_laplace(x, *mf.cell_laplace_args(dev, dt), factors=fac)
    rows_slow = cell_laplace.cell_laplace(x_dist, *mf.cell_laplace_args(dev, dt, slow=True),
                                          factors=fac)
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


def scatter_shares(mf):
    """dof_scatter's schedule on mf's fast DoF map, from its host tables:
    the chunk's cells, the chunks, the shares of the DoFs and entries local
    to one chunk (summed from shared memory), of the crossing DoFs and of
    the DoFs with no entry."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import dof_scatter

    ptr, ent, sched = mf._sources["scatter"]
    n = mf.n_dofs
    cstart, dptr, ids, _, _ = dof_scatter.schedule_parts(sched, n, ent.size)
    n_chunks = cstart.size - 1
    counts = np.diff(ptr.astype(np.int64))
    block = np.repeat(np.arange(2 * n_chunks), np.diff(dptr.astype(np.int64)))
    local = ids[block % 2 == 0]
    empty = int((counts == 0).sum())
    return dict(chunk_cells=int(cstart[1] - cstart[0]), chunks=n_chunks,
                local_dofs=local.size / n, local_entries=float(counts[local].sum() / ent.size),
                crossing_dofs=(n - local.size - empty) / n, empty_dofs=empty / n)


def scatter_side_timings(rows, ent):
    """dof_scatter's costs apart, on the card: (a) a coalesced read of the
    rows (``rows.sum()``: the floor of reading them), (b) the gather
    rows[ent] alone into an entry-ordered buffer (``torch.index_select``
    with the transposed map's ent: the row sectors each entry touches and
    the index chain ent -> rows, without the sums by destination). Each with
    its bound (bytes: the rows; the rows, ent and the buffer)."""
    flat = rows.reshape(-1)
    buf = torch.empty_like(flat)
    read_ms = time_ms(lambda: flat.sum(), device_only=True)
    gather_ms = time_ms(lambda: torch.index_select(flat, 0, ent, out=buf), device_only=True)
    check(torch.equal(buf, flat[ent.long()]), "the side gather rows[ent] is wrong")
    nbytes = flat.numel() * flat.element_size()
    return dict(read_ms=read_ms, read_bound_ms=bound(nbytes, None, flat.dtype)[0],
                gather_ms=gather_ms,
                gather_bound_ms=bound(2 * nbytes + 4 * ent.numel(), None, flat.dtype)[0])


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
    ptr, ent, _ = mf.scatter_tables(False, dev)
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
    scatter = dict(shares=scatter_shares(mf),
                   side=scatter_side_timings(inter["rows_fast"], ent))
    print(f"dof_scatter at quadrant nref=7 p=4 f32 on {smi}: its schedule's chunks and local "
          f"shares (host) {json.dumps(scatter['shares'])}; beside the kernel, (a) a coalesced "
          f"read of the rows and (b) the gather rows[ent] alone (ms, bound ms): "
          f"{json.dumps(scatter['side'])}", flush=True)
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
                   runners=runners, hn_overhead=overhead, deformed=deformed,
                   dof_scatter=scatter, card=smi)
    del mfs, ops, op_d, mf_d
    torch.cuda.empty_cache()
    return numbers, records


GMG_NREF, GMG_DEGREE, GMG_TOL, GMG_MAX_ITER = 6, 4, 1e-5, 100  # solve_01.run_bricks' defaults
INDEX_GMG_NREF, INDEX_GMG_DEGREE, INDEX_GMG_TOL = 3, 2, 1e-10  # solve_01.run, float64
GMG_KERNELS = ("brick_transfer", "dof_embed", "cell_transfer")


def sorted_csr(rows, cols, vals, n_rows, n_cols):
    """A CSR matrix on the card, int32 indices, from entries whose (row,
    col) pairs are distinct (the GMG kernels' library yardsticks). Unlike
    ``sparse_csr`` it sums no duplicates, so it skips coalesce's int64
    [2, nnz] index copy and sort, several GB at the transfers' ~300 M
    nonzeros."""
    order = torch.argsort(rows.long() * n_cols + cols.long())
    crow = torch.zeros(n_rows + 1, dtype=torch.long, device=rows.device)
    torch.cumsum(torch.bincount(rows.long(), minlength=n_rows), 0, out=crow[1:])
    return torch.sparse_csr_tensor(crow.int(), cols[order].int(), vals[order], (n_rows, n_cols))


def kron_rows(E):
    """[m, n^dim, n^dim]: each row's embedding E[:, 2] (x) E[:, 1] (x) E[:, 0]
    (2-D: E[:, 1] (x) E[:, 0]) as one matrix, out node (z, y, x) by in node,
    x fastest."""
    m, dim, n, _ = E.shape
    if dim == 2:
        return torch.einsum("myb,mxa->myxba", E[:, 1], E[:, 0]).reshape(m, n**2, n**2)
    return torch.einsum("mzc,myb,mxa->mzyxcba", E[:, 2], E[:, 1], E[:, 0]).reshape(
        m, n**3, n**3)


def transfer_library(out_idx, in_idx, K, weight, n_out, n_in):
    """(prolongate, restrict) of a transfer as two CSR matrices: out entry
    out_idx[i] = K[i] . x[in_idx[i]] (one writer an entry), and the
    transpose with the restriction's 0/1 weight of each out entry."""
    NL = K.shape[1]
    rows = out_idx.repeat_interleave(NL)
    P = sorted_csr(rows, in_idx.reshape(-1), K.reshape(-1), n_out, n_in)
    keep = weight.repeat_interleave(NL)
    R = sorted_csr(in_idx.reshape(-1)[keep], rows[keep], K.reshape(-1)[keep], n_in, n_out)
    return P, R


def gmg_kernel_calls(gmg, dev, i=-1):
    """The brick GMG kernels' calls at the shapes the solve gives them, in
    the levels' dtype: transfer i of the V-cycle (levels i -> i+1; -1 the
    finest) in both modes and its coarse level's dof_embed in both modes.
    Each with its library call (the map composed into one CSR matrix) and
    the matrices' nonzeros."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import brick_transfer, dof_embed
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.cell_apply import cell_nodes

    i = i % len(gmg.transfers)
    mmc, mmf = gmg.mms[i], gmg.mms[i + 1]
    tr = gmg.transfers[i]
    de = tr.embed_c
    g = torch.Generator(device=dev).manual_seed(SEED + i)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=mmf.dtype)
    calls = {name: [] for name in GMG_KERNELS[:2]}
    lib = {name: [] for name in GMG_KERNELS[:2]}
    nnz = {}

    def part(name, mode, mod, args, kw):
        calls[name].append((mode, lambda: getattr(mod, mod.NAME)(*args, **kw),
                            lambda: getattr(mod, f"{mod.NAME}_plain")(*args, **kw),
                            mod.bytes_and_flops(*args, **kw), None, None))

    xc, rf = rnd(mmc.n_bricks, mmc.N3p), rnd(mmf.n_bricks, mmf.N3p)
    for mode, x in (("prolongate", xc), ("restrict", rf)):
        part("brick_transfer", mode, brick_transfer, (x, *tr.tables()), dict(mode=mode))
    (src_lin, E, own, p_ptr, p_rows, *_, B) = tr.tables()
    rows = p_rows.long()
    sel = (own[rows] & brick_transfer.OWN) != 0
    r_i, j = torch.nonzero(sel, as_tuple=True)
    K = kron_rows(E[rows])[r_i, j]
    P, R = transfer_library(
        cell_nodes(rows, B, mmf.p, mmf.N3p, dev)[r_i, j],
        cell_nodes(src_lin[rows], B, mmf.p, mmf.N3p, dev)[r_i], K,
        (own[rows][r_i, j] & brick_transfer.OWN_WEIGHTED) != 0, rf.numel(), xc.numel())
    del K
    nnz["brick_transfer"] = (P._nnz(), R._nnz())
    lib["brick_transfer"] = [lambda: P @ xc.reshape(-1), lambda: R @ rf.reshape(-1)]
    xd, bv = rnd(de.n_dofs), rnd(*de.shape)
    for mode, x, shape in (("embed", xd, de.shape), ("embed_t", bv, (de.n_dofs,))):
        part("dof_embed", mode, dof_embed, (x, *de.tables(mode), shape), {})
        ptr, idx, w, _ = de.tables(mode)
        M = torch.sparse_csr_tensor(ptr, idx, w, (ptr.numel() - 1, x.numel()))
        nnz[f"dof_embed[{mode}]"] = M._nnz()
        lib["dof_embed"].append(lambda M=M, x=x: M @ x.reshape(-1))
    torch.cuda.synchronize()
    return calls, lib, nnz


def gmg_rounds(tr, dim, p):
    """brick_transfer's rounds a block, host counts from the tables, under
    the one-block-a-brick schedule ("before") and the kernel's ("now"):
    restrict, before one block a coarse brick taking G = 256 / lines cells
    of a parity class at a time, a round for each row position (the most
    rows of the group's cells), now one block a (coarse brick, class)
    taking up to ``round_rows`` of the class's rows a round; prolongate,
    before G rows a round a fine brick, now the host schedule's rounds.
    Returns {mode: {"before": (blocks, mean, max), "now": (...)}}."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import brick_transfer

    n = p + 1
    G = max(1, 256 // (n * n if dim == 3 else n))
    ncls = 2**dim
    r_ptr = tr.r_ptr.cpu().numpy()
    cnt = np.diff(tr.c_ptr.cpu().numpy())
    before, now = [], []
    cap = brick_transfer.round_rows(dim, p, tr.B, "restrict")
    for b in range(r_ptr.shape[0]):
        rounds = 0
        for c in range(ncls):
            cells = cnt[r_ptr[b, c]:r_ptr[b, c + 1]]
            rounds += sum(int(cells[g0:g0 + G].max()) for g0 in range(0, len(cells), G))
            now.append(-(-int(cells.sum()) // cap))
        before.append(rounds)
    rows_b = np.diff(tr.p_ptr.cpu().numpy())
    summary = lambda a: (len(a), float(np.mean(a)) if len(a) else 0.0, int(max(a, default=0)))
    return {"restrict": {"before": summary(before), "now": summary(now)},
            "prolongate": {"before": summary(-(-rows_b // G)),
                           "now": summary(np.diff(tr.p_bround.cpu().numpy()))}}


def embed_rows_csr(ptr, idx, w, rows):
    """dof_embed's lists of the given rows alone (ascending), in their
    order: (ptr, idx, w) of a table with len(rows) rows."""
    start = ptr[:-1].long()[rows]
    length = ptr[1:].long()[rows] - start
    sub = torch.zeros(len(rows) + 1, dtype=torch.int64, device=ptr.device)
    sub[1:] = torch.cumsum(length, 0)
    ent = (torch.arange(int(sub[-1]), device=ptr.device)
           + torch.repeat_interleave(start - sub[:-1], length))
    return sub.to(torch.int32), idx[ent], w[ent]


def gmg_side_timings(gmg, dev, tag):
    """Beside the GMG kernels (printed, not in the kernels line), at the
    finest transfer: dof_embed's whole call in each mode, and the wrapper on
    the CSR of the long rows alone (every row listed long: the warps'
    blocks, and thread blocks that skip every row) and of the short rows
    alone (no row listed: the thread-a-row instance), with the rows' and
    entries' counts; brick_transfer's rounds a block before and now
    (``gmg_rounds``)."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import dof_embed

    tr = gmg.transfers[-1]
    de, mm = tr.embed_c, gmg.mms[-1]
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for mode, shape, n_in in (("embed", de.shape, de.n_dofs),
                              ("embed_t", (de.n_dofs,), int(np.prod(de.shape)))):
        x = torch.randn(n_in, generator=g, device=dev, dtype=mm.dtype)
        tabs = de.tables(mode)
        length = (tabs[0][1:] - tabs[0][:-1]).long()
        is_long = length > dof_embed.LONG_ROW
        long_rows, short_rows = (torch.nonzero(m).reshape(-1) for m in (is_long, ~is_long))
        sub = {"long": (*embed_rows_csr(*tabs[:3], long_rows),
                        torch.arange(len(long_rows), dtype=torch.int32, device=dev)),
               "short": (*embed_rows_csr(*tabs[:3], short_rows),
                         torch.zeros(0, dtype=torch.int32, device=dev))}
        calls = {"all": lambda: dof_embed.dof_embed(x, *tabs, shape)}
        for part, t in sub.items():
            calls[part] = lambda t=t: dof_embed.dof_embed(x, *t, (t[0].numel() - 1,))
        whole = calls["all"]().reshape(-1)
        for part, rows in (("long", long_rows), ("short", short_rows)):
            check(torch.equal(calls[part](), whole[rows]),
                  f"dof_embed[{mode}] on its {part} rows alone differs from the whole call")
        n_rows = {"all": len(length), "long": len(long_rows), "short": len(short_rows)}
        ms = {part: time_ms(fn, device_only=True) if n_rows[part] else None  # none: no launch
              for part, fn in calls.items()}
        show = lambda part: f"{ms[part]:.4f} ms" if ms[part] is not None else "no rows"
        out[mode] = dict(ms=ms, long_rows=int(is_long.sum()),
                         long_entries=int(length[is_long].sum()),
                         short_rows=int((~is_long).sum()),
                         short_entries=int(length[~is_long].sum()),
                         longest=int(length.max()))
        print(f"{tag}dof_embed[{mode}] at the finest transfer's coarse level: all "
              f"{show('all')}, long rows alone {show('long')} ({out[mode]['long_rows']} rows of "
              f"more than {dof_embed.LONG_ROW} entries, {out[mode]['long_entries']} entries, the "
              f"longest {out[mode]['longest']}), short rows alone {show('short')} "
              f"({out[mode]['short_rows']} rows, {out[mode]['short_entries']} entries)",
              flush=True)
    out["rounds"] = gmg_rounds(tr, mm.dim, mm.p)
    for mode, r in out["rounds"].items():
        print(f"{tag}brick_transfer[{mode}] rounds a block (blocks, mean, max): before "
              f"{r['before']}, now {r['now']}", flush=True)
    return out


def gmg_transfer_sweep(gmg, dev, tag, tol):
    """brick_transfer and dof_embed at every transfer of the V-cycle (levels
    i -> i+1, the finest last), both modes each, against their plain
    versions (tol), two calls bit-identical, timed with bounds and library
    calls; the V-cycle's device time in each kernel from these times (a
    V-cycle runs each transfer's restrict, embed_t, embed and prolongate
    once, and the coarse solve's embed on level 0's DofEmbed). Returns
    ({kernel: finest transfer's parts}, {kernel: the other transfers'
    parts}, numbers)."""
    finest, others = {}, {}
    per = []
    n_tr = len(gmg.transfers)
    for i in range(n_tr):
        calls, lib, nnz = gmg_kernel_calls(gmg, dev, i)
        label = f"{tag}transfer {i} -> {i + 1}"
        row = {"transfer": label, "nnz": nnz}
        for name in ("brick_transfer", "dof_embed"):
            for mode, kern, *_ in calls[name]:
                a, b2 = kern(), kern()
                torch.cuda.synchronize()
                check(torch.equal(a, b2), f"two {name}[{mode}] calls at {label} differ")
            parts = measure_parts(name, calls[name], lib[name], {}, gmg.mms[-1].dtype, tol)
            for part in parts:
                row[f"{name}[{part['mode']}]"] = {k: part[k] for k in (
                    "ms", "bound_ms", "library_ms", "plain_ms")}
                if i < n_tr - 1:
                    part["mode"] = f"{label} {part['mode']}"
            (finest if i == n_tr - 1 else others).setdefault(name, []).extend(parts)
        per.append(row)
        del calls, lib
        torch.cuda.empty_cache()
    ms = lambda row, key, k="ms": row[key][k]
    busy = {"brick_transfer": sum(ms(r, "brick_transfer[prolongate]")
                                  + ms(r, "brick_transfer[restrict]") for r in per),
            "dof_embed": sum(ms(r, "dof_embed[embed]") + ms(r, "dof_embed[embed_t]") for r in per)
            + ms(per[0], "dof_embed[embed]")}
    bound_busy = {"brick_transfer": sum(ms(r, "brick_transfer[prolongate]", "bound_ms")
                                        + ms(r, "brick_transfer[restrict]", "bound_ms")
                                        for r in per),
                  "dof_embed": sum(ms(r, "dof_embed[embed]", "bound_ms")
                                   + ms(r, "dof_embed[embed_t]", "bound_ms") for r in per)
                  + ms(per[0], "dof_embed[embed]", "bound_ms")}
    print(f"{tag}a V-cycle's device time in the GMG kernels, from each transfer's times: "
          + ", ".join(f"{k} {v:.4f} ms (bound {bound_busy[k]:.4f} ms)" for k, v in busy.items()),
          flush=True)
    return finest, others, dict(transfers=per, vcycle_kernel_ms=busy, vcycle_bound_ms=bound_busy)


def cell_transfer_calls(tr_i, dev):
    """cell_transfer's calls in both modes at an index Transfer's shapes and
    dtype, on inputs from SEED, with the library call of each (the map as
    one CSR matrix) and the matrices' nonzeros: (parts, libs, nnz)."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import cell_transfer

    E, cdf, own, cover, child_ptr, child, n_fine, _ = tr_i.tables()
    g = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=E.dtype)
    NL = cdf.shape[1]
    uc, xf = rnd(child_ptr.numel() - 1, NL), rnd(n_fine)
    parts = []
    for mode, x in (("prolongate", uc), ("restrict", xf)):
        args = (x, *tr_i.tables())
        parts.append((mode, lambda args=args, mode=mode: cell_transfer.cell_transfer(
            *args, mode=mode), lambda args=args, mode=mode: cell_transfer.cell_transfer_plain(
            *args, mode=mode), cell_transfer.bytes_and_flops(*args, mode=mode), None, None))
    Pi, Ri = cell_transfer_maps(E, cdf, own, cover, n_fine, uc.shape[0])
    torch.cuda.synchronize()
    return parts, [lambda: Pi @ uc.reshape(-1), lambda: Ri @ xf], (Pi._nnz(), Ri._nnz())


def cell_transfer_maps(E, cdf, own, cover, n_fine, n_rows):
    """cell_transfer's maps as two CSR matrices (its library calls): the
    prolongation [n_fine, n_rows NL] (a fine DoF gets its owned slot's
    embedding of its coarse row, cover) and the restriction, its
    transpose."""
    NL = cdf.shape[1]
    f_i, j = torch.nonzero(own, as_tuple=True)
    K = kron_rows(E)[f_i, j]
    in_idx = cover.long()[f_i, None] * NL + torch.arange(NL, device=E.device)[None, :]
    return transfer_library(cdf.long()[f_i, j], in_idx, K,
                            torch.ones(len(f_i), dtype=torch.bool, device=E.device), n_fine,
                            n_rows * NL)


def scatter_library(rows, ptr, ent):
    """dof_scatter's library call: one index_add_ of the rows' values at
    their DoFs (each entry's DoF from the transposed map) into a zero
    vector."""
    n = ptr.numel() - 1
    dof = torch.empty(ent.numel(), dtype=torch.long, device=ent.device)
    dof[ent.long()] = torch.repeat_interleave(torch.arange(n, device=ent.device),
                                              (ptr[1:] - ptr[:-1]).long())
    out, vals = torch.zeros(n, dtype=rows.dtype, device=rows.device), rows.reshape(-1)
    return lambda: out.zero_().index_add_(0, dof, vals)


def index_gmg_solves(mt, dim, nref, p, tol, dev, wrappers):
    """The index GMG-CG of solve_01.run at quadrant nref, degree p, float64,
    tol, on a manufactured x* (zero on the boundary): on the CPU's plain
    path and on the card. Checks the same iteration count (< 30), the
    solutions within 1e-9 on the free DoFs and cell_transfer launched.
    Returns ({device: iterations}, the solutions' difference, the card's
    error against x*, the card's solve's launches, the card's
    preconditioner)."""
    t0 = time.perf_counter()
    its, sols = {}, {}
    for where in ("cpu", dev):  # gi is the card's at the end
        gi = mt.GMGPreconditioner("quadrant", dim, nref, p, device=where)
        opi, mfi = gi.fine_op, gi.fine_mf
        xsi = mfi.constraints.distribute(np.random.default_rng(SEED).standard_normal(mfi.n_dofs))
        xsi[opi.bdofs] = 0.0
        bi = opi.vmult(torch.from_numpy(xsi).to(opi.device))
        (xi, its[str(where)], _), icounts = counted(
            wrappers, lambda: mt.solve_cg(opi, bi, M=gi, tol=tol, max_iter=100))
        sols[str(where)] = xi.cpu().numpy()
    icounts = {k: n for k, n in icounts.items() if n}
    free_i = ~mfi.constraints.constrained_dof_marker()
    dx = float(np.abs(sols[str(dev)] - sols["cpu"])[free_i].max())
    erri = float(np.abs(sols[str(dev)] - xsi)[free_i].max())
    what = f"{dim}-D index GMG-CG quadrant nref={nref} p={p} f64 tol {tol:g}"
    print(f"{what}: {its[str(dev)]} iterations on the card, {its['cpu']} on the CPU's plain "
          f"path; solutions differ by {dx:.3e}, err {erri:.3e}; {time.perf_counter() - t0:.1f} "
          f"s; launches in the card's solve {icounts}", flush=True)
    check(its[str(dev)] == its["cpu"] < 30, f"the {what}'s iteration count differs from the "
                                            f"CPU's plain path")
    check(dx <= 1e-9, f"the {what}'s solution differs from the CPU's: {dx:.3e}")
    check(icounts.get("cell_transfer", 0) > 0, f"the {what} never launched cell_transfer")
    return its, dx, erri, icounts, gi


def gmg_phase(mt, dev, wrappers, smi):
    """The GMG-CG solve (solve_01.run_bricks at its defaults): the brick
    GMG at quadrant nref=GMG_NREF, p=GMG_DEGREE, float32, the device solver
    at tol GMG_TOL: setup and level sizes, one warm-up solve, then the
    counted solve (iterations, relative residual, err_max against the
    manufactured solution on the free DoFs, seconds, two solves
    bit-identical); one V-cycle's launches and profile; each GMG kernel
    against its plain version at the shapes of the path that launches it
    (cell_transfer: the index GMG's finest transfer, float64, and beside it
    the brick GMG's two finest levels, float32), timed with its bound and
    library call; the
    index GMG of solve_01.run on the card against the plain path on the CPU
    (the same iteration count). Returns (numbers, {kernel: record})."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import KERNEL_MODULES
    from dealii_matrixfree_hanging_nodes_tpu_torch.utils.analytic import interpolate

    tol32 = 1e-5
    t0 = time.perf_counter()
    gmg = mt.BrickGMGPreconditioner("quadrant", 3, GMG_NREF, GMG_DEGREE, dtype=np.float32,
                                    device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    levels = [dict(nref=GMG_NREF - len(gmg.levels) + 1 + i, cells=mf.n_cells, n_dofs=mf.n_dofs,
                   constrained_dofs=int(len(mf.constraints.slave_dofs)), bricks=mm.n_bricks,
                   subset_bricks=mm.n_sub, constrained_rows=mm.n_hn)
              for i, (mf, mm) in enumerate(zip(gmg.levels, gmg.mms))]
    print(f"GMG setup: {setup_s:.1f} s (quadrant nref={GMG_NREF} p={GMG_DEGREE} f32, "
          f"{len(levels)} levels, coarse direct [{gmg.levels[0].n_dofs}]^2)", flush=True)
    for lv in levels:
        print(f"  level {json.dumps(lv)}", flush=True)
    op, mm, mf = gmg.fine_op, gmg.fine_mm, gmg.fine_mf
    xs = interpolate(mf.dof_handler).astype(np.float32)
    xs[op._bdofs] = 0.0
    b = op.vmult(mm.from_dof_vector(xs))
    solve = gmg.make_device_solver(tol=GMG_TOL, max_iter=GMG_MAX_ITER)
    t0 = time.perf_counter()
    x0, it0, _ = solve(b)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (x, iters, res), counts = counted(wrappers, lambda: solve(b))
    solve_s = time.perf_counter() - t0
    counts = {k: n for k, n in counts.items() if n}
    b_norm = float(torch.sqrt(mm.dot(b, b)))
    r = b - op.vmult(x)
    true_res = float(torch.sqrt(mm.dot(r, r))) / b_norm
    free = ~mf.constraints.constrained_dof_marker()
    err = float(np.abs((mm.to_dof_vector(x).cpu().numpy() - xs)[free]).max())
    print(f"GMG-CG quadrant nref={GMG_NREF} p={GMG_DEGREE} f32 on {smi}: {iters} iterations, "
          f"relative residual {res / b_norm:.3e} (recomputed b - A x: {true_res:.3e}), err_max "
          f"{err:.3e}; solve {solve_s:.4f} s, {solve_s / max(iters, 1):.4f} s an iteration "
          f"(warm-up solve {warm_s:.2f} s); launches in the solve {counts}", flush=True)
    check(bool(torch.isfinite(x).all()) and x.shape == b.shape, "the GMG solution is malformed")
    check(iters < GMG_MAX_ITER and res / b_norm <= GMG_TOL,
          f"GMG-CG did not converge: {iters} iterations, relative residual {res / b_norm:.3e}")
    check(it0 == iters and torch.equal(x0, x), "two GMG solves are not bit-identical")
    for name in ("brick_transfer", "dof_embed"):
        check(counts.get(name, 0) > 0, f"the GMG solve never launched {name}")
    vcycle, vcounts = counted(wrappers, lambda: gmg(b))
    vcounts = {k: n for k, n in vcounts.items() if n}
    print(f"one V-cycle's port launches {vcounts} ({sum(vcounts.values())})", flush=True)
    check(bool(torch.isfinite(vcycle).all()), "the V-cycle gave non-finite values")
    # a V-cycle reads no dot; its one index and one dense product are the coarse solve's
    # extract and matmul
    v_prof = profile_path("V-cycle", lambda: gmg(b), set(wrappers), sum(vcounts.values()), reps=5,
                          classes={"index": 1, "dense product": 1, "reduction": 0})
    v_host_ms = host_ms(lambda: gmg(b), reps=5, warmup=1)
    print(f"host time to issue one V-cycle: {v_host_ms:.4f} ms; its device time by port kernel "
          f"(profile): {v_prof['port_kernels_by_name']}", flush=True)

    # the index GMG of solve_01.run, float64, on the card and on the CPU
    its, dx, erri, icounts, gi = index_gmg_solves(mt, 3, INDEX_GMG_NREF, INDEX_GMG_DEGREE,
                                                  INDEX_GMG_TOL, dev, wrappers)

    # the GMG kernels at the shapes their paths give them: brick_transfer and dof_embed at
    # the brick GMG's finest transfer (f32); cell_transfer at the index GMG's finest
    # (nref INDEX_GMG_NREF-1 -> INDEX_GMG_NREF, f64), and beside it, outside the kernels
    # line, between the brick GMG's two finest levels' index engines (f32)
    # brick_transfer and dof_embed at every transfer of the V-cycle (the kernels line's totals
    # are the finest transfer's), and their side timings
    finest, others, sweep = gmg_transfer_sweep(gmg, dev, "", tol32)
    side = gmg_side_timings(gmg, dev, "")
    t0 = time.perf_counter()
    calls, lib, nnz = {}, {}, {}
    calls["cell_transfer"], lib["cell_transfer"], nnz["cell_transfer"] = cell_transfer_calls(
        gi.transfers[-1], dev)
    tr_i = mt.Transfer(gmg.levels[-2], gmg.levels[-1], device=dev)
    big_calls, big_lib, nnz["cell_transfer (nref 6, p 4)"] = cell_transfer_calls(tr_i, dev)
    print(f"cell_transfer's library matrices ({time.perf_counter() - t0:.1f} s), nonzeros: "
          f"{nnz}", flush=True)
    results = {}
    for mod in [m for m in KERNEL_MODULES if m.NAME in GMG_KERNELS]:
        name = mod.NAME
        rec = kernel_record(mod)
        dt, tol = ((torch.float64, 1e-12) if name == "cell_transfer"
                   else (torch.float32, tol32))
        rec["parts"] = (measure_parts(name, calls[name], lib[name], {}, dt, tol)
                        if name == "cell_transfer" else finest[name])
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            rec[key] = sum(part[key] for part in rec["parts"])
        rec["bound_by"] = max((part["bound_ms"], part["bound_by"]) for part in rec["parts"])[1]
        rec["max_abs_err"] = max(part["max_abs_err"] for part in rec["parts"])
        rec["max_rel_err"] = max(part["max_rel_err"] for part in rec["parts"])
        rec["launches"] = (icounts if name == "cell_transfer" else counts).get(name, 0)
        rec["launches_per_vcycle"] = vcounts.get(name, 0)
        rec["launches_path"] = ("index GMG-CG solve" if name == "cell_transfer"
                                else "brick GMG-CG solve")
        rec["shapes"] = (f"quadrant nref {INDEX_GMG_NREF - 1} -> {INDEX_GMG_NREF}, "
                         f"p={INDEX_GMG_DEGREE}, float64" if name == "cell_transfer" else
                         f"quadrant nref {GMG_NREF - 1} -> {GMG_NREF}, p={GMG_DEGREE}, float32")
        print(f"{name} at {rec['shapes']}: {rec['ms']:.4f} ms against a bound of "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), library {rec['library_ms']:.4f} "
              f"ms; launches {rec['launches']} in the {rec['launches_path']}, "
              f"{rec['launches_per_vcycle']} a brick V-cycle", flush=True)
        rec["parts"] = rec["parts"] + others.get(name, [])
        for part in rec["parts"]:
            for key in ("max_abs_err", "max_rel_err"):
                rec[key] = max(rec[key], part[key])
        results[name] = rec
    big = measure_parts("cell_transfer", big_calls, big_lib, {}, torch.float32, tol32)
    big = {key: sum(part[key] for part in big) for key in ("ms", "plain_ms", "bound_ms",
                                                           "library_ms")}
    print(f"cell_transfer at quadrant nref {GMG_NREF - 1} -> {GMG_NREF}, p={GMG_DEGREE}, "
          f"float32 (no solve of this run takes these shapes): {big['ms']:.4f} ms against a "
          f"bound of {big['bound_ms']:.4f} ms, plain {big['plain_ms']:.4f} ms, library "
          f"{big['library_ms']:.4f} ms", flush=True)
    del big_calls, big_lib
    del calls, lib
    torch.cuda.empty_cache()
    numbers = dict(nref=GMG_NREF, degree=GMG_DEGREE, dtype="float32", tol=GMG_TOL,
                   setup_s=setup_s, levels=levels, iterations=iters, rel_res=res / b_norm,
                   rel_res_recomputed=true_res, err_max=err, solve_s=solve_s,
                   s_per_iter=solve_s / max(iters, 1), warmup_s=warm_s, launches=counts,
                   vcycle=dict(launches=vcounts, host_ms=v_host_ms, profile=v_prof),
                   transfers=sweep, side=side,
                   index=dict(nref=INDEX_GMG_NREF, degree=INDEX_GMG_DEGREE, dtype="float64",
                              iterations=its[str(dev)], iterations_cpu=its["cpu"],
                              solution_diff=dx, err=erri, launches=icounts),
                   cell_transfer_nref6_p4_f32=big, card=smi)
    del gmg, gi, tr_i, b, x, x0, r
    torch.cuda.empty_cache()
    return numbers, results


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


# ---- linear elasticity on both engines ------------------------------------------------------
ELASTIC_MU = ELASTIC_LAM = 1.0  # benchmarks/elasticity_01.py's operator
# (name, quadrant nref, degree), float32: VERDICT's size (phase 3's mesh) and elasticity_01's
# own default
ELASTIC_CONFIGS = (("scale", 7, 4), ("elasticity_01", 5, 2))
ELASTIC_LAUNCHES = {
    "vmult": {"cell_elasticity": 1, "hn_cell": 1, "corr_compact": 1, "brick_elasticity": 1,
              "dss_surface": 1},
    "vmult_plain": {"cell_elasticity": 1, "corr_compact": 1, "brick_elasticity": 1,
                    "dss_surface": 1},
    "index": {"cell_elasticity": 1, "dof_scatter": 1},
    "index_plain": {"cell_elasticity": 1, "dof_scatter": 1},
}
# float64 against the dense oracle, mu=1.3, lam=0.7: the reference's elasticity tests' cases and p=4
ELASTIC_ORACLE = (("quadrant", 2, 2), ("quadrant", 3, 3), ("step", 2, 1), ("quadrant", 2, 4))
ELASTIC_NEW = ("cell_elasticity", "brick_elasticity")


def brick_elastic_library(opb, x):
    """brick_elasticity's library call: its map is one dense brick operator
    [dim N3, dim N3] (block (c, k) the sum of its Kronecker terms; in 2-D
    the reference's el_A{c}{k}), the same for every brick, so one torch.mm
    over the bricks (their components side by side, geo applied outside the
    timed call, TF32 off) computes it. Returns (call, the plain version
    without cell rows in the call's layout, which the call is held
    against)."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import brick_elasticity

    torch.backends.cuda.matmul.allow_tf32 = False
    mm, d = opb.mm, opb.dim
    N3 = mm.N3
    fac = {"K": opb.Kb.double(), "M": opb.Mb.double(), "G": opb.Gb.double()}
    fac["GT"] = fac["G"].T.contiguous()
    A = torch.zeros((d * N3, d * N3), dtype=torch.float64, device=x.device)
    for c in range(d):
        for k in range(d):
            for coef, f in brick_elasticity.terms(c, k, opb.mu, opb.lam, d):
                term = fac[f[0]]
                for name in f[1:]:
                    term = torch.kron(fac[name], term)
                A[c * N3:(c + 1) * N3, k * N3:(k + 1) * N3] += coef * term
    A = A.to(x.dtype)
    side = lambda v: v[:, :, :N3].permute(1, 0, 2).reshape(mm.n_bricks, d * N3)
    xs = side(x * mm.geo[None, :, None]).contiguous()
    return (lambda: torch.mm(xs, A.T), lambda: side(opb.brick_apply(x, None, plain=True)))


def elastic_kernel_calls(opb, mf, x, xi, with_libs=True):
    """Elasticity's kernels at the shapes the two vmults give them (x the
    brick vector, xi the index engine's displacement): {name: [part]} as
    kernel_calls gives them, and (with_libs) {name: [library call per
    part]} (None where no PyTorch call computes the function) with the
    library matrices' nonzeros."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        brick_elasticity, cell_elasticity, corr_compact, dof_scatter, dss_surface, hn_cell,
    )

    mm, dev, dt = opb.mm, x.device, x.dtype
    isz = x.element_size()
    plain3 = opb.cell_rows(x)
    sub_raw = opb.hn_rows(x)
    dcols = corr_compact.corr_compact(plain3, sub_raw, *mm.corr_tables())
    v1 = opb.brick_apply(x, dcols)
    ci_args = (xi, *mf.cell_laplace_args(dev, dt), opb.mu, opb.lam)
    fac = opb.cell_kernel_factors  # the index mode's too: the same degree
    rows3 = cell_elasticity.cell_elasticity(*ci_args, factors=fac)
    scatter = mf.scatter_tables(False, dev)
    cb_args = (x, None, None, None, opb.S, opb.Dc, opb.quad_w, mm.geo_cell_sub, opb.mu, opb.lam)
    calls = {
        "cell_elasticity": [
            ("index", lambda: cell_elasticity.cell_elasticity(*ci_args, factors=fac),
             lambda: cell_elasticity.cell_elasticity_plain(*ci_args),
             cell_elasticity.bytes_and_flops(*ci_args), None, None),
            ("bricks", lambda: opb.cell_rows(x), lambda: opb.cell_rows(x, plain=True),
             cell_elasticity.bytes_and_flops(*cb_args, brick_size=mm.B), None, None)],
        "hn_cell": [("elastic", lambda: opb.hn_rows(x), lambda: opb.hn_rows(x, plain=True),
                     hn_cell.bytes_and_flops(x, *mm.hn_tables(), mm.B, mode="elastic"), None,
                     None)],
        "corr_compact": [(
            "components", lambda: corr_compact.corr_compact(plain3, sub_raw, *mm.corr_tables()),
            lambda: corr_compact.corr_compact_plain(plain3, sub_raw, *mm.corr_tables()),
            corr_compact.bytes_and_flops(plain3, sub_raw, *mm.corr_tables()), None, None)],
        "brick_elasticity": [(
            "fused", lambda: opb.brick_apply(x, dcols), lambda: opb.brick_apply(x, dcols, True),
            brick_elasticity.bytes_and_flops(mm.n_bricks, mm.NB, mm.p, mm.N3p, isz, mm.n_sub),
            None, None)],
        "dss_surface": [in_place("components", dss_surface, v1, mm.dss_tables())],
        "dof_scatter": [("components", lambda: dof_scatter.dof_scatter(rows3, *scatter),
                         lambda: dof_scatter.dof_scatter_plain(rows3, *scatter),
                         dof_scatter.bytes_and_flops(rows3, *scatter), None, None)],
    }
    if not with_libs:
        torch.cuda.synchronize()
        return calls, None, None
    # library calls: the component-axis kernels' maps over the dim components at once (a
    # CSR product with dim columns, an index_add_ of dim columns), the brick operator's
    # dense product; none computes cell_elasticity or hn_cell's elastic mode in one call
    d = opb.dim
    cols3 = lambda t: t.reshape(d, -1).T.contiguous()
    corr = corr_matrix(mm, True, dt)
    x_corr = torch.cat([cols3(sub_raw), cols3(plain3)])
    dss = dss_matrix(mm, dt)
    v3 = cols3(v1)
    dof = mf._on("dofmap", dev).reshape(-1).long()
    src3 = cols3(rows3)
    out3 = torch.zeros((mf.n_dofs, d), dtype=dt, device=dev)
    libs = {
        "cell_elasticity": [None, None],
        "hn_cell": [None],
        "corr_compact": [(lambda: corr @ x_corr, lambda: cols3(
            corr_compact.corr_compact_plain(plain3, sub_raw, *mm.corr_tables())))],
        "brick_elasticity": [brick_elastic_library(opb, x)],
        "dss_surface": [(lambda: dss @ v3, lambda: cols3(
            dss_surface.dss_surface_plain(v1.clone(), *mm.dss_tables())))],
        "dof_scatter": [lambda: out3.zero_().index_add_(0, dof, src3)],
    }
    nnz = {f"corr_compact (x{d} columns)": corr._nnz(), f"dss_surface (x{d} columns)": dss._nnz()}
    torch.cuda.synchronize()
    return calls, libs, nnz


def elastic_config(mt, name, mf, opb, opb64, dev, wrappers, smi, index=True):
    """One configuration, float32 through the kernels: the brick vmult and
    vmult_plain and (with index) the index vmult with and without
    constraints, each against its plain float64 path on the card (1e-5),
    its launches checked exactly, two calls bit-identical, timed (median
    of CUDA-event-timed back-to-back calls after warm-up), GDoF/s as
    dim n_dofs / time, the host's issue time, a profile (no device launch
    outside the port's kernels; busy and idle share); the HN overhead of
    each engine run. Returns (the numbers, the brick input, the index
    input)."""
    n3 = opb.dim * mf.n_dofs
    u = np.random.default_rng(SEED).standard_normal((mf.n_dofs, opb.dim)).astype(np.float32)
    x = opb.from_dof_vector(u)
    x64 = x.double()
    xi = torch.from_numpy(u).to(dev)
    xi64 = xi.double()
    runs = [
        ("vmult", lambda: opb.vmult(x),
         lambda: opb64.to_dof_vector(opb64.vmult(x64, plain=True), zero_hanging=True),
         lambda y: opb.to_dof_vector(y, zero_hanging=True)),
        ("vmult_plain", lambda: opb.vmult_plain(x), lambda: opb64.vmult_plain(x64, plain=True),
         lambda y: y),
    ]
    if index:
        opi = {True: mt.ElasticityOperator(mf, opb.mu, opb.lam, device=dev),
               False: mt.ElasticityOperator(mf, opb.mu, opb.lam, constraints=False, device=dev)}
        runs += [("index", lambda: opi[True].vmult(xi), lambda: opi[True].vmult(xi64, plain=True),
                  lambda y: y),
                 ("index_plain", lambda: opi[False].vmult(xi),
                  lambda: opi[False].vmult(xi64, plain=True), lambda y: y)]
    out = {}
    for call, fn, ref_fn, read in runs:
        ref = ref_fn()
        y, counts = counted(wrappers, fn)
        counts = {k: n for k, n in counts.items() if n}
        got = read(y)
        err = errors(got, ref)[1]
        del ref
        what = f"elastic {call} ({name})"
        print(f"{what} f32 vs plain f64 path: max rel err {err:.3e} (tol 1e-5), launches "
              f"{counts}", flush=True)
        check(bool(torch.isfinite(y).all()) and got.shape == (
            (mf.n_dofs, opb.dim) if call != "vmult_plain" else x.shape),
              f"{what} output malformed")
        check(err <= 1e-5, f"{what} disagrees with the float64 path: {err:.3e}")
        check(counts == ELASTIC_LAUNCHES[call], f"{what} launched {counts}, not "
                                                f"{ELASTIC_LAUNCHES[call]}")
        check(torch.equal(y, fn()), f"two calls of the {what} are not bit-identical")
        ms = time_ms(fn, reps=30, warmup=5)
        hms = host_ms(fn)
        prof = profile_path(what, fn, set(wrappers), sum(ELASTIC_LAUNCHES[call].values()))
        out[call] = dict(ms=ms, gdofs_per_s=n3 / ms / 1e6, launches=counts, host_ms=hms,
                         max_rel_err=err, profile=prof)
        print(f"{what} on {smi}: {ms:.4f} ms ({n3 / ms / 1e6:.4f} GDoF/s over {n3} component "
              f"DoFs); host time to issue {hms:.4f} ms", flush=True)
    out["hn_overhead_bricks"] = out["vmult"]["ms"] / out["vmult_plain"]["ms"]
    line = f"bricks {out['hn_overhead_bricks']:.4f} (vmult / vmult_plain)"
    if index:
        out["hn_overhead_index"] = out["index"]["ms"] / out["index_plain"]["ms"]
        line += f", index {out['hn_overhead_index']:.4f} (vmult / constraints=False)"
    print(f"elastic HN overhead ({name}) on {smi}: {line}", flush=True)
    return out, x, xi


def elastic_oracle_checks(mt, dev, dim=3, cases=ELASTIC_ORACLE):
    """float64 through the kernels on both engines against the dense
    oracle (1e-12), mu=1.3, lam=0.7, at cases (dim-D meshes)."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import elasticity_oracle

    worst = 0.0
    for geo, nref, p in cases:
        tria = mt.create_geometry(geo, dim, nref)
        mf = mt.MatrixFree(tria, p)
        u = np.random.default_rng(SEED).standard_normal((mf.n_dofs, dim))
        for c in range(dim):
            u[:, c] = mf.constraints.distribute(u[:, c])
        ref = elasticity_oracle(tria, p, 1.3, 0.7, u)
        scale = np.abs(ref).max()
        opb = mt.BrickElasticity(mf, 1.3, 0.7, device=dev)
        got = {"index": mt.ElasticityOperator(mf, 1.3, 0.7, device=dev).vmult(u),
               "bricks": opb.to_dof_vector(opb.vmult(opb.from_dof_vector(u)),
                                           zero_hanging=True)}
        for engine, g in got.items():
            err = float(np.abs(g.cpu().numpy() - ref).max() / scale)
            worst = max(worst, err)
            print(f"elastic {engine} vmult {dim}-D {geo} nref={nref} p={p} f64 vs dense oracle: "
                  f"max rel err {err:.3e} (tol 1e-12)", flush=True)
            check(err <= 1e-12, f"float64 elastic {engine} vmult at {geo} nref={nref} p={p} "
                                f"disagrees with the oracle: {err:.3e}")
    return worst


# every instance of the two elastic kernels: (dim, degree, quadrant nref), small meshes with
# constrained and subset cells
ELASTIC_INSTANCES = tuple((3, p, 2) for p in range(1, 9)) + tuple((2, p, 3) for p in range(1, 7))


def elastic_instance_checks(mt, dev):
    """Every instance of cell_elasticity (index mode with the cells' codes,
    bricks mode) and brick_elasticity (with and without cell rows) at
    ELASTIC_INSTANCES, float32 and float64 (mu=1.3, lam=0.7, seeded inputs):
    against its plain version on the same inputs (1e-5, 1e-12) and two calls
    bit-identical. Returns {"<dim>-D p=<p> <dtype>": worst relative error}."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import brick_elasticity, cell_elasticity

    out = {}
    for dim, p, nref in ELASTIC_INSTANCES:
        mf = mt.MatrixFree(mt.create_quadrant(dim, nref), p)
        for dt in (torch.float32, torch.float64):
            tol = 1e-5 if dt == torch.float32 else 1e-12
            op = mt.BrickElasticity(mf, 1.3, 0.7, device=dev, dtype=dt)
            mm = op.mm
            g = torch.Generator(device=dev).manual_seed(SEED + p)
            bv = torch.randn(dim, mm.n_bricks, mm.N3p, generator=g, device=dev, dtype=dt)
            x = torch.randn(mf.n_dofs, dim, generator=g, device=dev, dtype=dt)
            args = mf.cell_laplace_args(dev, dt)
            check(mm.n_sub > 0 and args[1] is not None and bool((args[1] != 0).any()),
                  f"elastic instance {dim}-D p={p}: no subset or constrained cells")
            cols = op.cell_rows(bv)
            calls = {
                "cell_elasticity index": (
                    lambda: cell_elasticity.cell_elasticity(x, *args, 1.3, 0.7,
                                                            factors=op.cell_kernel_factors),
                    lambda: cell_elasticity.cell_elasticity_plain(x, *args, 1.3, 0.7)),
                "cell_elasticity bricks": (lambda: op.cell_rows(bv),
                                           lambda: op.cell_rows(bv, plain=True)),
                "brick_elasticity": (lambda: op.brick_apply(bv, None),
                                     lambda: op.brick_apply(bv, None, True)),
                "brick_elasticity with cell rows": (lambda: op.brick_apply(bv, cols),
                                                    lambda: op.brick_apply(bv, cols, True))}
            worst = 0.0
            for what, (fn, plain) in calls.items():
                got, again, ref = fn(), fn(), plain()
                err = errors(got, ref)[1]
                same = bool(torch.equal(got, again))
                worst = max(worst, err)
                check(got.shape == ref.shape and err <= tol and same,
                      f"{what} {dim}-D p={p} {dt}: rel err {err:.3e} (tol {tol:g}), two calls "
                      f"bit-identical {same}")
            key = f"{dim}-D p={p} {str(dt).split('.')[-1]}"
            out[key] = worst
            del op, bv, x, cols
        print(f"elastic kernel instances {dim}-D p={p} (quadrant nref={nref}): every mode within "
              f"tolerance of its plain version, two calls bit-identical; worst rel err f32 "
              f"{out[f'{dim}-D p={p} float32']:.3e}, f64 {out[f'{dim}-D p={p} float64']:.3e}",
              flush=True)
    torch.cuda.empty_cache()
    return out


def elasticity_phase(mt, mf7, op7, op7_64, dev, wrappers, smi):
    """Linear elasticity (elasticity_01.py's operator, mu = lam = 1) on both
    engines: at quadrant nref=7 p=4 f32 (phase 3's mesh; the brick
    operators wrap phase 3's and phase 5's scalar tables) and at
    elasticity_01's default, quadrant nref=5 p=2 f32 (``elastic_config``
    each); every elasticity kernel and component-axis call at nref=7
    against its plain version (1e-5), timed with its bound and library
    call; at nref=5 p=2 the same kernels against their plain versions; the
    float64 oracle cases. Returns (numbers, {kernel: record} for the new
    kernels, {kernel: [part]} for the existing ones)."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        KERNEL_MODULES, brick_elasticity, cell_elasticity, hn_cell,
    )

    for dt in (torch.float32, torch.float64):
        print(f"elasticity kernels at p=4 {dt} (threads, shared memory bytes, blocks per SM): "
              f"cell_elasticity {cell_elasticity.plan(dt, 4, dev)}, hn_cell elastic "
              f"{hn_cell.elastic_plan(dt, 4, 4, 3, dev)}, brick_elasticity "
              f"{brick_elasticity.plan(dt, 4, 3, dev)}", flush=True)
    numbers = {}
    records, parts = {}, {}
    for i, (name, nref, p) in enumerate(ELASTIC_CONFIGS):
        scale = i == 0  # the first runs on phase 3's mesh and operators
        t0 = time.perf_counter()
        if scale:
            mf = mf7
            opb = mt.BrickElasticity.on_operator(op7, ELASTIC_MU, ELASTIC_LAM)
            opb64 = mt.BrickElasticity.on_operator(op7_64, ELASTIC_MU, ELASTIC_LAM)
        else:
            mf = mt.MatrixFree(mt.create_quadrant(3, nref), p, dtype=np.float32)
            opb = mt.BrickElasticity(mf, ELASTIC_MU, ELASTIC_LAM, device=dev)
            opb64 = mt.BrickElasticity(mf, ELASTIC_MU, ELASTIC_LAM, device=dev,
                                       dtype=torch.float64)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        mm = opb.mm
        print(f"elasticity {name}: quadrant nref={nref} p={p} f32, {mf.n_dofs} DoFs "
              f"({3 * mf.n_dofs} component DoFs), {mm.n_bricks} bricks, {mm.n_sub} subset "
              f"bricks, {mm.n_hn} constrained rows; setup {setup_s:.1f} s", flush=True)
        res, x, xi = elastic_config(mt, name, mf, opb, opb64, dev, wrappers, smi)
        res.update(nref=nref, degree=p, dtype="float32", n_dofs=mf.n_dofs,
                   component_dofs=3 * mf.n_dofs, setup_s=setup_s, card=smi)
        numbers[name] = res
        calls, libs, nnz = elastic_kernel_calls(opb, mf, x, xi, with_libs=scale)
        if not scale:
            check_kernels(calls, 1e-5, f"elastic nref={nref} p={p} f32")
            del calls, opb, opb64, mf
            continue
        # cell_elasticity's bricks mode as one map from the bricks to the rows: a dense
        # [3 n_loc, 3 n_loc] block a subset cell
        kel_nnz = mm.n_sub * mm.B**3 * (3 * (mm.p + 1) ** 3) ** 2
        print(f"elastic library matrices, nonzeros: {nnz}; brick_elasticity's library call is "
              f"one torch.mm by the dense brick operator [{3 * mm.N3}, {3 * mm.N3}]; no "
              f"PyTorch call computes cell_elasticity's index mode (gather, per-mask "
              f"interpolation, quadrature), its bricks mode (its map composed is a dense "
              f"coupled Kel a subset cell: {kel_nnz} nonzeros, {kel_nnz * 8 / 1e9:.1f} GB as "
              f"CSR with f32 values and int32 indices, beside the card's 80 GB) or hn_cell's "
              f"elastic mode (its composed map couples the three components: 9x the full "
              f"mode's nonzeros)", flush=True)
        for mod_name in calls:
            measured = measure_parts(mod_name, calls[mod_name], libs[mod_name], {},
                                     torch.float32, 1e-5)
            for part in measured:
                part["call"] = "elastic vmult" if mod_name != "dof_scatter" else "elastic index"
            if mod_name not in ELASTIC_NEW:
                parts[mod_name] = measured
                continue
            rec = kernel_record(next(m for m in KERNEL_MODULES if m.NAME == mod_name))
            rec["parts"] = measured
            for key in ("ms", "plain_ms", "bound_ms"):
                rec[key] = sum(part[key] for part in measured)
            libs_ms = [part["library_ms"] for part in measured if part["library_ms"] is not None]
            rec["library_ms"] = sum(libs_ms) if libs_ms else None
            rec["bound_by"] = max((part["bound_ms"], part["bound_by"]) for part in measured)[1]
            rec["max_abs_err"] = max(part["max_abs_err"] for part in measured)
            rec["max_rel_err"] = max(part["max_rel_err"] for part in measured)
            launched = {call: res[call]["launches"].get(mod_name, 0)
                        for call in ("vmult", "index")}
            rec["launches"] = sum(launched.values())
            rec["launches_path"] = (f"the elastic brick vmult and index vmult at quadrant "
                                    f"nref=7 p=4 f32: {launched}")
            rec["shapes"] = "quadrant nref=7, p=4, float32, 3 components"
            records[mod_name] = rec
        del calls, libs
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers["oracle_max_rel_err"] = elastic_oracle_checks(mt, dev)
    numbers["oracle_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    numbers["instances"] = elastic_instance_checks(mt, dev)
    numbers["instances_s"] = time.perf_counter() - t0
    return numbers, records, parts


# ---- the multi-RHS vmult ---------------------------------------------------------------------
MULTI_KS = (1, 3, 8)  # right-hand sides a call, timed at quadrant nref=7 p=4 f32
MULTI_K = 8  # the kernels line's instances and the degree <= 3 runs
MULTI_LAUNCHES = 5  # a vmult_multi at every k, both schedules
# the degree <= 3 schedule without face planes, beside phase 8's p=3 operator: (degree, nref)
MULTI_LOW = ((2, 6), (1, 6))  # at nref=6 so that the whole run fits its time limit
MULTI_ORACLE = (4, 4, 3)  # float64 against the oracle: quadrant nref, degree, k


def multi_inputs(op, k, seed):
    """[k, n_bricks, N3p]: k seeded DoF vectors through from_dof_vector."""
    rng = np.random.default_rng(seed)
    return torch.stack([op.from_dof_vector(rng.standard_normal(op.mf.n_dofs)) for _ in range(k)])


def multi_run(op, bvk, wrappers, smi, what):
    """vmult_multi on bvk against k back-to-back vmults: its launches
    (checked: MULTI_LAUNCHES, one of each kernel of the schedule), each RHS
    bit-identical to vmult of it, the medians of CUDA-event-timed calls, ms
    per vector and their ratio, the host's time to issue one call and its
    profile (no device launch outside the port's kernels). Returns (numbers,
    output)."""
    k = bvk.shape[0]
    out, counts = counted(wrappers, lambda: op.vmult_multi(bvk))
    counts = {name: n for name, n in counts.items() if n}
    expect = {name: 1 for name in ("hn_cell", "corr_compact", "brick_apply", "dss_surface",
                                   "masked_quad" if op.assembled else "cell_apply")}
    check(counts == expect, f"vmult_multi {what} launched {counts}, not {expect}")
    check(bool(torch.isfinite(out).all()) and out.shape == bvk.shape,
          f"vmult_multi {what} output malformed")
    for j in range(k):
        check(torch.equal(out[j], op.vmult(bvk[j])),
              f"vmult_multi {what}: RHS {j} differs from vmult of it")
    ms = time_ms(lambda: op.vmult_multi(bvk), reps=20, warmup=3)
    stacked = time_ms(lambda: [op.vmult(bvk[j]) for j in range(k)], reps=20, warmup=3)
    res = dict(k=k, ms=ms, ms_per_vector=ms / k, stacked_ms=stacked,
               stacked_ms_per_vector=stacked / k, stacked_over_multi=stacked / ms,
               launches=counts, host_ms=host_ms(lambda: op.vmult_multi(bvk), reps=20),
               profile=profile_path(f"vmult_multi {what}", lambda: op.vmult_multi(bvk),
                                    set(wrappers), MULTI_LAUNCHES), card=smi)
    busy = res["profile"]["busy_ms"]
    res["busy_ms_per_vector"] = None if busy is None else busy / k
    print(f"vmult_multi {what} on {smi}: {ms:.4f} ms a call, {ms / k:.4f} ms a vector "
          f"(busy {'not measured' if busy is None else f'{busy / k:.4f}'}); {k} vmults back "
          f"to back {stacked:.4f} ms, "
          f"{stacked / k:.4f} a vector; stacked / multi {stacked / ms:.4f}; host issues a call "
          f"in {res['host_ms']:.4f} ms; every RHS bit-identical to its vmult; launches {counts}",
          flush=True)
    return res, out


def multi_kernel_calls(op, bvk, mats, K):
    """Each kernel of vmult_multi at bvk's shapes (k right-hand sides,
    the subset a strided view), in kernel_calls' form, parts named "multi
    k=<k> <kernel>", with their library calls: the kernel's single-RHS
    matrix (``yardsticks``' matrices `mats`; masked_quad's built here)
    applied to the k columns at once (a CSR product with a dense [n, k]
    block, the columns laid out outside the timed call), brick_apply's
    dense brick operator by torch.mm over k x n_bricks rows; each held
    against the plain version in its layout. Returns ({name: [part]},
    {name: [(library, reference)]})."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        brick_apply, cell_apply, corr_compact, dss_surface, hn_cell, masked_quad,
    )

    k, isz = bvk.shape[0], bvk.element_size()
    tag = f"multi k={k}"
    sub = bvk[:, : op.n_sub]
    cols = lambda x: x.reshape(k, -1).T.contiguous()  # [n, k]: one RHS a column
    hn_args = (*op.hn_tables(), *op.factors_host, op.geo_hn, op.B)
    hn_plain_args = (*op.hn_tables(), op.K1, op.M1, op.geo_hn, op.B)
    plain_rows = None if op.assembled else cell_apply.cell_apply(
        sub, *op.factors_host, op.geo_cell_sub, op.B)
    sub_raw = hn_cell.hn_cell(sub, *hn_args, mode="full")
    dcols = corr_compact.corr_compact(plain_rows, sub_raw, *op.corr_tables())
    fused = dict(dcols=dcols, brick_size=op.B)
    v0 = brick_apply.brick_apply(bvk, *op.brick_factors_host, op.geo, op.p, **fused)
    calls = {
        "brick_apply": [(
            f"{tag} brick_apply",
            lambda: brick_apply.brick_apply(bvk, *op.brick_factors_host, op.geo, op.p, **fused),
            lambda: brick_apply.brick_apply_plain(bvk, op.Kb, op.Mb, op.geo, op.p, **fused),
            brick_apply.bytes_and_flops(op.n_bricks, op.NB, op.p, op.N3p, isz,
                                        op.n_corr_rows // op.C, k), None, None)],
        "hn_cell": [(
            f"{tag} hn_cell", lambda: hn_cell.hn_cell(sub, *hn_args, mode="full"),
            lambda: hn_cell.hn_cell_plain(sub, *hn_plain_args, mode="full"),
            hn_cell.bytes_and_flops(sub, *op.hn_tables(), op.B, mode="full"), None, None)],
        "corr_compact": [(
            f"{tag} corr_compact",
            lambda: corr_compact.corr_compact(plain_rows, sub_raw, *op.corr_tables()),
            lambda: corr_compact.corr_compact_plain(plain_rows, sub_raw, *op.corr_tables()),
            corr_compact.bytes_and_flops(plain_rows, sub_raw, *op.corr_tables()), None, None)],
    }
    x_sub = cols(sub)
    x_corr = cols(sub_raw) if plain_rows is None else torch.cat([cols(sub_raw),
                                                                 cols(plain_rows)])
    libs = {
        "brick_apply": [brick_library(op, bvk)],
        "hn_cell": [(lambda: mats["hn_cell"] @ x_sub, lambda: cols(calls["hn_cell"][0][2]()))],
        "corr_compact": [(lambda: mats["corr_compact"] @ x_corr,
                          lambda: cols(calls["corr_compact"][0][2]()))],
    }
    if op.assembled:
        v_in = v0
        mq = op.masked_tables("rem" if op.n_hn else "absent")
        calls["masked_quad"] = [in_place(f"{tag} masked_quad", masked_quad, v0,
                                         (bvk, *mq, *op.factors_host, op.geo, op.B),
                                         (bvk, *mq, op.K1, op.M1, op.geo, op.B))]
        v_dss = masked_quad.masked_quad(v0.clone(), bvk, *mq, *op.factors_host, op.geo, op.B)
        M = masked_matrix(op, "rem" if op.n_hn else "absent", K, {})
        x_mq = torch.cat([cols(v_in), cols(bvk)])
        libs["masked_quad"] = [None if M is None else (
            lambda: M @ x_mq, lambda: cols(masked_quad.masked_quad_plain(
                v_in.clone(), bvk, *mq, op.K1, op.M1, op.geo, op.B)))]
    else:
        calls["cell_apply"] = [(
            f"{tag} cell_apply",
            lambda: cell_apply.cell_apply(sub, *op.factors_host, op.geo_cell_sub, op.B),
            lambda: cell_apply.cell_apply_plain(sub, op.K1, op.M1, op.geo_cell_sub, op.B),
            cell_apply.bytes_and_flops(sub[0].numel(), op.n_sub * op.C, op.n_loc, isz, k),
            None, None)]
        libs["cell_apply"] = [(lambda: mats["cell_apply"] @ x_sub,
                               lambda: cols(calls["cell_apply"][0][2]()))]
        v_dss = v0
    calls["dss_surface"] = [in_place(f"{tag} dss_surface", dss_surface, v_dss, op.dss_tables())]
    x_dss = cols(v_dss)
    libs["dss_surface"] = [(lambda: mats["dss_surface"] @ x_dss, lambda: cols(
        dss_surface.dss_surface_plain(v_dss.clone(), *op.dss_tables())))]
    torch.cuda.synchronize()
    return calls, libs


def multi_phase(mt, op, op64, op3, mats, dev, wrappers, smi):
    """vmult_multi: at quadrant nref=7 p=4 f32 (phase 3's mesh, phase 5's
    operators) for each k of MULTI_KS against k back-to-back vmults
    (``multi_run``); at k=MULTI_K the f32 result against the plain float64
    path (1e-5), every kernel's RHS-axis instance against its plain
    version, timed with its bound and library call; float64 on the card
    bit-identical to stacked vmults, and against the scipy oracle at
    MULTI_ORACLE (1e-12); the degree <= 3 schedule without face planes at
    k=MULTI_K (phase 8's p=3 operator, MULTI_LOW), masked_quad's instance
    from p=3. Returns (numbers, {kernel: [part]})."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import auto_brick_size, kronecker_sum
    from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import vmult_oracle

    numbers, parts = {}, {}
    bvk = multi_inputs(op, MULTI_K, SEED + 12)
    for k in MULTI_KS:
        numbers[f"p=4 k={k}"], out = multi_run(op, bvk[:k], wrappers, smi, f"p=4 nref=7 k={k}")
    ref = op64.vmult_multi(bvk.double(), plain=True)
    err = max(errors(op.to_dof_vector(out[j], zero_hanging=True),
                     op64.to_dof_vector(ref[j], zero_hanging=True))[1] for j in range(MULTI_K))
    print(f"vmult_multi p=4 nref=7 k={MULTI_K} f32 vs the plain f64 path: max rel err "
          f"{err:.3e} (tol 1e-5)", flush=True)
    check(err <= 1e-5, f"vmult_multi disagrees with the float64 path: {err:.3e}")
    numbers["f32_vs_plain_f64_max_rel_err"] = err
    del ref, out
    bvk64 = bvk[:3].double()
    out64 = op64.vmult_multi(bvk64)
    check(all(torch.equal(out64[j], op64.vmult(bvk64[j])) for j in range(3)),
          "float64 vmult_multi differs from its stacked vmults")
    print("vmult_multi p=4 nref=7 k=3 f64: every RHS bit-identical to its vmult", flush=True)
    del bvk64, out64
    K = torch.from_numpy(kronecker_sum(op.K1.cpu().numpy(), op.M1.cpu().numpy())).to(dev,
                                                                                     op.dtype)
    calls, libs = multi_kernel_calls(op, bvk, mats, K)
    for name in calls:
        parts[name] = measure_parts(name, calls[name], libs[name], {}, op.dtype, 1e-5)
    del calls, libs, bvk
    torch.cuda.empty_cache()

    nref, p, k = MULTI_ORACLE
    tria = mt.create_quadrant(3, nref)
    op_o = mt.BrickLaplaceMM(mt.MatrixFree(tria, p, dtype=np.float64), device=dev)
    rng = np.random.default_rng(SEED + 13)
    us = [rng.standard_normal(op_o.mf.n_dofs) for _ in range(k)]
    out = op_o.vmult_multi(torch.stack([op_o.from_dof_vector(u) for u in us]))
    err = max(errors(op_o.to_dof_vector(out[j], zero_hanging=True).cpu(),
                     torch.from_numpy(vmult_oracle(tria, p, u)))[1] for j, u in enumerate(us))
    print(f"vmult_multi quadrant nref={nref} p={p} k={k} f64 vs scipy oracle: max rel err "
          f"{err:.3e} (tol 1e-12)", flush=True)
    check(err <= 1e-12, f"float64 vmult_multi disagrees with the oracle: {err:.3e}")
    numbers["oracle_max_rel_err"] = err

    lows = [(3, 7, op3)] + [(q, n, None) for q, n in MULTI_LOW]
    for q, n, opq in lows:
        t0 = time.perf_counter()
        if opq is None:
            opq = mt.BrickLaplaceMM(mt.MatrixFree(mt.create_quadrant(3, n), q,
                                                  dtype=np.float32), device=dev,
                                    face_planes=False)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        check(opq.assembled and not opq.planes, f"p={q} runs no degree <= 3 schedule without "
                                                f"face planes")
        bvk = multi_inputs(opq, MULTI_K, SEED + 14)
        res, _ = multi_run(opq, bvk, wrappers, smi, f"p={q} nref={n} k={MULTI_K}")
        res.update(nref=n, setup_s=setup_s, n_dofs=opq.mf.n_dofs)
        numbers[f"p={q} k={MULTI_K}"] = res
        if q == 3:
            Kq = torch.from_numpy(kronecker_sum(opq.K1.cpu().numpy(), opq.M1.cpu().numpy())).to(
                dev, opq.dtype)
            calls, libs = multi_kernel_calls(opq, bvk, {}, Kq)
            parts["masked_quad"] = measure_parts("masked_quad", calls["masked_quad"],
                                                 libs["masked_quad"], {}, opq.dtype, 1e-5)
            del calls, libs
        del opq, bvk
        torch.cuda.empty_cache()
    for name, plist in parts.items():
        for part in plist:
            key = f"p={3 if name == 'masked_quad' else 4} k={MULTI_K}"
            part["launches"] = numbers[key]["launches"][name]
            part["call"] = f"vmult_multi {key}"
    return numbers, parts


# ---- the deformed brick engine ------------------------------------------------------------
DEFORMED_NREF_BRICK, DEFORMED_DEGREE = 7, 4  # the bench mesh, float32 (PERF.md section 4)
DEFORMED_LAUNCHES = {
    "vmult": {"cell_apply": 1, "hn_cell": 1, "corr_compact": 1, "brick_deformed": 1,
              "dss_surface": 1},
    "vmult_plain": {"brick_deformed": 1, "dss_surface": 1},
    "refill": {"hn_cell": 1, "refill_update": 1},
}
# float64 (1e-12): the reference's deformed brick cases, then one a (p, B) class
DEFORMED_F64 = (("quadrant", 3, 2), ("annulus", 4, 2), ("quadrant", 4, 1), ("quadrant", 3, 3),
                ("quadrant", 3, 4), ("quadrant", 2, 6))
# degree, quadrant nref: the per-cell schedule at B=8, float32 (at nref=6 so that the whole
# run fits its time limit)
DEFORMED_LOW = (2, 6)


def metric_build(mf, dev):
    """Build mf's deformed metric on dev, as a card operator's first use does
    (``MatrixFree.deformed_metric``: float64, ``mapping.deformed_laplace_factors``
    in chunks of cells on the card, copied to the host): (seconds, peak bytes
    of the host allocations made meanwhile, traced by tracemalloc, which sees
    NumPy's, and the metric's bytes)."""
    import tracemalloc

    tracemalloc.start()
    t0 = time.perf_counter()
    geo = mf.deformed_metric(dev)
    seconds = time.perf_counter() - t0
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    return seconds, peak, geo.nbytes


def metric_host_comparison(mt):
    """``python3 chip_smoke.py --metric-host``: the deformed metric of the
    deformed phase's mesh built on the host at once and in chunks of cells
    (``mapping.METRIC_CHUNK``): seconds and traced peak bytes of each, and
    the two bit-identical (checked). Host work only; prints one JSON line."""
    import tracemalloc

    from dealii_matrixfree_hanging_nodes_tpu_torch.elements import shape_info
    from dealii_matrixfree_hanging_nodes_tpu_torch.mapping import (
        METRIC_CHUNK, deformed_laplace_factors,
    )

    tria = mt.create_quadrant(3, DEFORMED_NREF_BRICK)
    sh = shape_info(DEFORMED_DEGREE)
    res, geo = {"cells": tria.n_active_cells, "chunk": METRIC_CHUNK}, {}
    for name, chunk in (("chunks", METRIC_CHUNK), ("at_once", None)):
        tracemalloc.start()
        t0 = time.perf_counter()
        geo[name] = deformed_laplace_factors(tria, sh, chunk=chunk)
        res[name] = dict(seconds=time.perf_counter() - t0,
                         peak_bytes=tracemalloc.get_traced_memory()[1])
        tracemalloc.stop()
        print(f"metric at quadrant nref={DEFORMED_NREF_BRICK} p={DEFORMED_DEGREE}, {name}: "
              f"{res[name]['seconds']:.2f} s, peak {res[name]['peak_bytes'] / 1e9:.3f} GB",
              flush=True)
    res["bit_identical"] = bool(np.array_equal(geo["chunks"], geo["at_once"]))
    res["metric_bytes"] = geo["chunks"].nbytes
    check(res["bit_identical"], "the metric in chunks differs from the metric at once")
    print(json.dumps({"metric_host": res}))


def deformed_cell_matrices(op, cells, chunk=2048):
    """[len(cells), n_loc, n_loc]: each brick cell's deformed stiffness K_c
    (row i, column j), by the plain quadrature (``laplace_rows``) of the
    unit vectors with the cell's metric, in chunks of cells."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.cell_laplace import laplace_rows

    n = op.n_loc
    eye = torch.eye(n, dtype=op.dtype, device=op.device)
    out = torch.empty((len(cells), n, n), dtype=op.dtype, device=op.device)
    for s in range(0, len(cells), chunk):
        c = cells[s:s + chunk]
        cols = laplace_rows(eye.repeat(len(c), 1), op.S, op.Dc, None,
                            op.metric[c].repeat_interleave(n, dim=0), op.dim)  # K_c e_j
        out[s:s + len(c)] = cols.view(len(c), n, n).transpose(1, 2)
    return out


def deformed_brick_csr(op, chunk=1024):
    """brick_deformed's map composed, for 2-D bricks: one CSR matrix over
    the brick nodes [nb*N3p, nb*N3p], block diagonal by brick, each block
    its present cells' K_c (``deformed_cell_matrices``) scattered to their
    nodes and summed where cells share a node, int32 indices; built in
    chunks of bricks. The padded tail rows are empty."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import brick_deformed
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.cell_apply import cell_nodes

    nb, N, dev = op.n_bricks, op.N3p, op.device
    cells = brick_deformed.present_cells(op.present_bits, op.C)
    starts = list(range(0, nb, chunk))
    cuts = torch.searchsorted(cells, torch.tensor(starts + [nb], device=dev) * op.C).tolist()
    counts, cols, vals = [], [], []
    for i, b0 in enumerate(starts):
        c = cells[cuts[i]:cuts[i + 1]]
        nodes = cell_nodes(c, op.B, op.p, N, dev)  # [m, n_loc] flat brick-node ids
        key = (nodes[:, :, None] * N + nodes[:, None, :] % N).reshape(-1)  # row, column in brick
        key, inv = torch.unique(key, return_inverse=True)  # sorted by row, then column
        vals.append(torch.zeros(len(key), dtype=op.dtype, device=dev).index_add_(
            0, inv, deformed_cell_matrices(op, c).reshape(-1)))
        row = key // N
        counts.append(torch.bincount(row - b0 * N, minlength=(min(b0 + chunk, nb) - b0) * N))
        cols.append((row // N * N + key % N).to(torch.int32))
        del nodes, key, inv, row
    crow = torch.zeros(nb * N + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.cat(counts), 0)
    check(int(crow[-1]) < 2**31, "brick_deformed's composed map needs int64 indices")
    return torch.sparse_csr_tensor(crow.to(torch.int32), torch.cat(cols), torch.cat(vals),
                                   (nb * N, nb * N))


def deformed_kernel_calls(op, x, with_libs=True):
    """The deformed path's kernels at the shapes its vmult gives them (input
    x), in kernel_calls' form: brick_deformed with the subset's cell rows
    in its epilogue (the vmult's launch) and without (vmult_plain's),
    cell_apply's and hn_cell's deformed modes; with with_libs their library
    calls: cell_apply's map as one CSR product (each subset cell's dense
    K_c at its nodes, int32 indices), hn_cell's (the fill composed with
    each row's Q_b K_c Q_f) likewise; brick_deformed's in 2-D as one CSR
    product over the brick nodes (``deformed_brick_csr``), held against the
    plain version without cell rows (their overlap-add has brick_apply's
    index_add_ yardstick); none in 3-D (its composed map, a dense K_c a
    present cell, is counted and not built). Returns (calls, libraries or
    None, {matrix: nonzeros})."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        brick_deformed, cell_apply, corr_compact, hn_cell,
    )
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.cell_apply import cell_nodes

    isz, dev = x.element_size(), x.device
    u_sub = x[: op.n_sub]
    tab = op.deformed_tables(op.n_sub * op.C)
    plain_rows = cell_apply.cell_apply(u_sub, None, None, None, op.B, deformed=tab)
    sub_raw = x.new_empty((0, op.n_loc))
    if op.n_hn:
        hn_args = (u_sub, *op.hn_tables(), None, None, None, op.B)
        sub_raw = hn_cell.hn_cell(*hn_args, mode="deformed", deformed=op.deformed_tables())
    dcols = corr_compact.corr_compact(plain_rows, sub_raw, *op.corr_tables())
    bd = (x, op.metric, op.present_bits, op.S, op.Dc)
    calls = {
        "brick_deformed": [(
            f"{tag} p={op.p}", lambda d=d: brick_deformed.brick_deformed(
                *bd, dcols=d, brick_size=op.B, factors=op.kernel_factors),
            lambda d=d: brick_deformed.brick_deformed_plain(*bd, dcols=d, brick_size=op.B),
            brick_deformed.bytes_and_flops(*bd, dcols=d, brick_size=op.B), None, None)
            for tag, d in (("vmult (cell rows)", dcols), ("vmult_plain", None))],
        "cell_apply": [(
            f"deformed p={op.p}",
            lambda: cell_apply.cell_apply(u_sub, None, None, None, op.B, deformed=tab),
            lambda: cell_apply.cell_apply_plain(u_sub, None, None, None, op.B, deformed=tab),
            cell_apply.bytes_and_flops(u_sub.numel(), plain_rows.shape[0], op.n_loc, isz,
                                       deformed=True), None, None)],
    }
    if op.n_hn:
        calls["hn_cell"] = [(
            f"deformed p={op.p}",
            lambda: hn_cell.hn_cell(*hn_args, mode="deformed", deformed=op.deformed_tables()),
            lambda: hn_cell.hn_cell_plain(*hn_args, mode="deformed",
                                          deformed=op.deformed_tables()),
            hn_cell.bytes_and_flops(u_sub, *op.hn_tables(), op.B, mode="deformed"), None, None)]
    n_present = int(brick_deformed.present_cells(op.present_bits, op.C).numel())
    nnz = {"brick_deformed (not built)" if op.dim == 3 else "brick_deformed (cell blocks)":
           n_present * op.n_loc**2}
    if not with_libs:
        torch.cuda.synchronize()
        return calls, None, nnz
    ar = lambda n: torch.arange(n, device=dev)
    R, n = op.n_sub * op.C, op.n_loc
    Kc = deformed_cell_matrices(op, ar(R))  # [R, n, n]
    nodes = cell_nodes(ar(R), op.B, op.p, op.N3p, dev).to(torch.int32)
    ca_lib = torch.sparse_csr_tensor((ar(R * n + 1) * n).to(torch.int32),
                                     nodes[:, None, :].expand(R, n, n).reshape(-1),
                                     Kc.reshape(-1), (R * n, u_sub.numel()))
    del Kc, nodes
    fill_rows, fill_cols = fill_entries(op)
    Qf, Qb = hn_dense(op, "fwd", x.dtype), hn_dense(op, "bwd", x.dtype)
    q = op.hn_q.long()
    qq = torch.where(q >= 0, q, Qf.shape[0] - 1)
    maps = Qb[qq] @ deformed_cell_matrices(op, op.hn_sub.long()) @ Qf[qq]  # [n_hn, n, n]
    hn_lib = hn_map(op, maps, ar(op.n_hn), fill_rows, fill_cols, u_sub.numel())
    del maps, Qf, Qb
    nnz.update({"cell_apply[deformed]": ca_lib._nnz(), "hn_cell[deformed]": hn_lib._nnz()})
    x_u = u_sub.reshape(-1)
    libs = {"brick_deformed": [None, None], "cell_apply": [lambda: ca_lib @ x_u],
            "hn_cell": [lambda: hn_lib @ x_u]}
    if op.dim == 2:
        bd_lib, x_b = deformed_brick_csr(op), x.reshape(-1)
        nnz["brick_deformed"] = bd_lib._nnz()
        bare = lambda: brick_deformed.brick_deformed_plain(*bd, brick_size=op.B)
        libs["brick_deformed"] = [(lambda: bd_lib @ x_b, bare)] * 2
    torch.cuda.synchronize()
    return calls, libs, nnz


def deformed_plan(op, parts, dev, smi):
    """Print brick_deformed's plan (threads, shared-memory bytes, blocks per
    SM) at op's instance beside its measured parts' times and bounds, and
    keep it in each part."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import brick_deformed

    plan = list(brick_deformed.plan(op.dtype, op.p, op.B, op.dim, device=dev))
    for part in parts:
        part["plan"] = plan
    print(f"brick_deformed {op.dim}-D p={op.p} B={op.B} on {smi}: threads, shared memory bytes, "
          f"blocks per SM {plan}; " + "; ".join(
              f"{q['mode']} {q['ms']:.4f} ms (bound {q['bound_ms']:.4f} ms, plain "
              f"{q['plain_ms']:.4f})" for q in parts), flush=True)


def deformed_f64_checks(mt, dev, wrappers, dim=3, cases=DEFORMED_F64):
    """float64 through the kernels at cases (dim-D meshes; 1e-12 each):
    every deformed kernel instance against its plain version, the vmult
    against the plain path and the deformed index engine's, vmult_plain
    and refill against the plain path; the vmult's launches checked."""
    tol, out = 1e-12, {}
    for geo, nref, p in cases:
        mf = mt.MatrixFree(mt.create_geometry(geo, dim, nref), p, dtype=np.float64,
                           high_order_mapping=True)
        op = mt.BrickLaplaceMM(mf, device=dev)
        u = np.random.default_rng(SEED).standard_normal(mf.n_dofs)
        x = op.from_dof_vector(u)
        calls, _, _ = deformed_kernel_calls(op, x, with_libs=False)
        what = f"deformed {dim}-D {geo} nref={nref} p={p} f64"
        kernel_err = max(r for v in check_kernels(calls, tol, what).values() for _, r in v)
        y, n = counted(wrappers, lambda: op.vmult(x))
        n = {k: c for k, c in n.items() if c}
        want = {k: c for k, c in DEFORMED_LAUNCHES["vmult"].items() if op.n_hn or k != "hn_cell"}
        check(n == want, f"{what}: vmult launched {n}, not {want}")
        ref = mt.LaplaceOperator(mf, device=dev).vmult(torch.from_numpy(u).to(dev))
        ref[torch.from_numpy(mf.constraints.constrained_dof_marker()).to(dev)] = 0.0
        errs = dict(kernels=kernel_err,
                    vmult_vs_index=errors(op.to_dof_vector(y, zero_hanging=True), ref)[1],
                    vmult=errors(y, op.vmult(x, plain=True))[1],
                    vmult_plain=errors(op.vmult_plain(x), op.vmult_plain(x, plain=True))[1],
                    refill=errors(op.refill(y), op.refill(y, plain=True))[1])
        print(f"{what}: max rel errs {json.dumps(errs)} (tol {tol:g}), vmult launches {n}",
              flush=True)
        check(max(errs.values()) <= tol, f"{what} disagrees: {errs}")
        out[f"{geo} nref={nref} p={p}"] = errs
    return out


def deformed_run(op, op64, x, wrappers, smi, what, profile=True):
    """vmult, vmult_plain and refill of the deformed operator op (float32,
    input x) against the float64 operator op64's plain path (after zeroing
    the hanging entries; 1e-5), their launches counted and checked
    (DEFORMED_LAUNCHES), two calls bit-identical, timed as phase 5 times the
    vmult, the host's issue time and, with profile, the profiles (no device
    launch outside the port's kernels). Returns (numbers, vmult launches)."""
    res = {}
    x64 = x.double()
    y = None
    for call in ("vmult", "vmult_plain", "refill"):
        arg = y if call == "refill" else x
        fn = (lambda f=getattr(op, call), a=arg: f(a))
        got, n = counted(wrappers, fn)
        n = {k: c for k, c in n.items() if c}
        ref = getattr(op64, call)(arg.double() if call == "refill" else x64, plain=True)
        if call == "vmult":
            y = got
            err = errors(op.to_dof_vector(got, zero_hanging=True),
                         op64.to_dof_vector(ref, zero_hanging=True))[1]
        else:
            err = errors(got, ref)[1]
        same = bool(torch.equal(fn(), fn()))
        check(bool(torch.isfinite(got).all()) and got.shape == x.shape, f"{what} {call} malformed")
        check(err <= 1e-5, f"{what} {call} disagrees with the float64 path: {err:.3e}")
        check(n == DEFORMED_LAUNCHES[call], f"{what} {call} launched {n}, not "
                                            f"{DEFORMED_LAUNCHES[call]}")
        check(same, f"two calls of {what} {call} differ")
        r = dict(ms=time_ms(fn, reps=30, warmup=5), max_rel_err=err, launches=n,
                 host_ms=host_ms(fn), card=smi)
        if call == "vmult":
            r["plain_ms"] = time_ms(lambda: op.vmult(x, plain=True), reps=5, warmup=1)
        if profile:
            r["profile"] = profile_path(f"{what} {call}", fn, set(wrappers),
                                        sum(DEFORMED_LAUNCHES[call].values()))
        res[call] = r
        print(f"{what} {call} on {smi}: {r['ms']:.4f} ms, host issues it in {r['host_ms']:.4f} "
              f"ms; vs the plain f64 path max rel err {err:.3e} (tol 1e-5); launches {n}; two "
              f"calls bit-identical", flush=True)
    res["hn_overhead"] = res["vmult"]["ms"] / res["vmult_plain"]["ms"]
    return res, res["vmult"]["launches"]


def deformed_phase(mt, tria, op_c, dev, wrappers, smi):
    """The deformed brick engine (BrickLaplaceMM under high_order_mapping)
    at quadrant nref=DEFORMED_NREF_BRICK p=DEFORMED_DEGREE f32 on phase 3's
    mesh: the setup's seconds by step (the metric's seconds on the card and peak
    bytes; the operator's structure, tables and transfer) and the metric's
    device bytes; each deformed kernel instance against its plain version
    (1e-5), timed with its bound and library call; vmult, vmult_plain and
    refill against the plain float64 path (``deformed_run``); the HN
    overhead; the vmult over the Cartesian vmult of phase 3's operator op_c
    on the same mesh; the f32 vmult against the deformed index engine's
    (1e-5); float64 at DEFORMED_F64 (``deformed_f64_checks``); the per-cell
    schedule at p=2 (DEFORMED_LOW), vmult and vmult_plain timed and
    counted. Returns (numbers, brick_deformed's record, {kernel: [part]})."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import KERNEL_MODULES

    t0 = time.perf_counter()
    mf = mt.MatrixFree(tria, DEFORMED_DEGREE, dtype=np.float32, high_order_mapping=True)
    mf_s = time.perf_counter() - t0
    metric_s, metric_peak, metric_bytes = metric_build(mf, dev)
    op = mt.BrickLaplaceMM(mf, device=dev)
    torch.cuda.synchronize()
    op64 = mt.BrickLaplaceMM(mf, device=dev, dtype=torch.float64)
    torch.cuda.synchronize()
    setup = dict(matrix_free=mf_s, metric=metric_s, metric_device=str(dev),
                 metric_host_peak_bytes=metric_peak, metric_host_bytes=metric_bytes,
                 operator=op.setup_s,
                 metric_device_bytes=op.metric.numel() * op.metric.element_size(),
                 total=time.perf_counter() - t0)
    print(f"deformed setup (quadrant nref={DEFORMED_NREF_BRICK} p={DEFORMED_DEGREE} f32, "
          f"{mf.n_dofs} DoFs, {op.n_bricks} bricks, {op.n_sub} subset bricks, {op.n_hn} "
          f"constrained rows): {json.dumps(setup)}", flush=True)
    u = np.random.default_rng(SEED).standard_normal(mf.n_dofs).astype(np.float32)
    x = op.from_dof_vector(u)

    calls, libs, nnz = deformed_kernel_calls(op, x)
    print(f"deformed maps composed into one CSR matrix each (the library calls), nonzeros: "
          f"{nnz}; brick_deformed has no library call: its map composed is a dense "
          f"{op.n_loc}^2 matrix a present cell, and no one call applies them and sums them "
          f"into the bricks", flush=True)
    parts = {name: measure_parts(name, cparts, libs[name], {}, x.dtype, 1e-5)
             for name, cparts in calls.items()}
    deformed_plan(op, parts["brick_deformed"], dev, smi)
    del calls, libs
    torch.cuda.empty_cache()

    numbers, launches = deformed_run(op, op64, x, wrappers, smi,
                                     f"deformed p={DEFORMED_DEGREE} nref={DEFORMED_NREF_BRICK}")
    xc = op_c.from_dof_vector(u)
    cart_ms = time_ms(lambda: op_c.vmult(xc), reps=30, warmup=5)
    numbers["cartesian_vmult_ms"] = cart_ms
    numbers["deformed_over_cartesian"] = numbers["vmult"]["ms"] / cart_ms
    idx = mt.LaplaceOperator(mf, device=dev)
    ref = idx.vmult(torch.from_numpy(u).to(dev))
    ref[torch.from_numpy(mf.constraints.constrained_dof_marker()).to(dev)] = 0.0
    cross = errors(op.to_dof_vector(op.vmult(x), zero_hanging=True), ref)[1]
    check(cross <= 1e-5, f"the deformed brick vmult disagrees with the index engine's: "
                         f"{cross:.3e}")
    numbers["vs_index_max_rel_err"] = cross
    print(f"deformed nref={DEFORMED_NREF_BRICK} p={DEFORMED_DEGREE} f32 on {smi}: vmult "
          f"{numbers['vmult']['ms']:.4f} ms ({mf.n_dofs / numbers['vmult']['ms'] / 1e6:.4f} "
          f"GDoF/s), vmult_plain {numbers['vmult_plain']['ms']:.4f}, refill "
          f"{numbers['refill']['ms']:.4f}; HN overhead {numbers['hn_overhead']:.4f}; the "
          f"Cartesian vmult on the same mesh {cart_ms:.4f} ms, deformed / Cartesian "
          f"{numbers['deformed_over_cartesian']:.4f}; against the deformed index vmult (f32, "
          f"through its kernels) max rel err {cross:.3e} (tol 1e-5)", flush=True)
    numbers.update(setup=setup, n_dofs=mf.n_dofs, nref=DEFORMED_NREF_BRICK,
                   degree=DEFORMED_DEGREE, library_nnz=nnz, card=smi)
    del op, op64, idx, ref, x, mf
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    numbers["f64"] = deformed_f64_checks(mt, dev, wrappers)
    numbers["f64_s"] = time.perf_counter() - t0

    p, nref = DEFORMED_LOW
    t0 = time.perf_counter()
    mf_l = mt.MatrixFree(mt.create_quadrant(3, nref), p, dtype=np.float32,
                         high_order_mapping=True)
    op_l = mt.BrickLaplaceMM(mf_l, device=dev)
    op_l64 = mt.BrickLaplaceMM(mf_l, device=dev, dtype=torch.float64)
    torch.cuda.synchronize()
    low_setup = time.perf_counter() - t0
    x_l = op_l.from_dof_vector(np.random.default_rng(SEED).standard_normal(mf_l.n_dofs))
    low, _ = deformed_run(op_l, op_l64, x_l, wrappers, smi, f"deformed p={p} nref={nref}",
                          profile=False)
    low.update(setup_s=low_setup, n_dofs=mf_l.n_dofs)
    numbers[f"p={p} nref={nref}"] = low
    del op_l, op_l64, mf_l, x_l
    torch.cuda.empty_cache()

    mod = next(m for m in KERNEL_MODULES if m.NAME == "brick_deformed")
    rec = kernel_record(mod)
    rec["parts"] = parts.pop("brick_deformed")
    main = rec["parts"][0]  # the vmult's launch
    for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
        rec[k] = main[k]
    rec["library_nnz_not_built"] = nnz["brick_deformed (not built)"]
    rec["max_abs_err"] = max(q["max_abs_err"] for q in rec["parts"])
    rec["max_rel_err"] = max(q["max_rel_err"] for q in rec["parts"])
    rec["launches"] = launches["brick_deformed"]
    rec["parts"][1]["launches"] = numbers["vmult_plain"]["launches"]["brick_deformed"]
    main["launches"] = rec["launches"]
    for name, plist in parts.items():
        for part in plist:
            part["launches"] = launches[name]
            part["call"] = "deformed vmult"
    return numbers, rec, parts


# ---- 2-D on the index engine -------------------------------------------------------------
INDEX2D_NREF, INDEX2D_DEGREE = 11, 4  # quadrant nref=11 p=4 f32: 16,841,157 DoFs, uncut
INDEX2D_DEFORMED_NREF = 11  # the deformed vmult's mesh (PERF.md section 4)
INDEX2D_GMG_NREF = 10  # the GMG-CG solve at quadrant nref=10 p=4 f32 (PERF.md section 4)
INDEX2D_GMG_CHECK = (4, 2)  # quadrant nref, degree of the float64 solve held to the CPU's count
INDEX2D_ORACLE = (("quadrant", 3, 2), ("step", 3, 3), ("quadrant", 3, 5), ("quadrant", 3, 6))
INDEX2D_ELASTIC_ORACLE = ("quadrant", 3, 2)
INDEX2D_LAUNCHES = {
    **INDEX_LAUNCHES,
    "vmult deformed": {"cell_laplace": 1, "dof_scatter": 1},
    "elasticity": {"cell_elasticity": 1, "dof_scatter": 1},
}


def probe_maps(fn, n_in, codes, dt, dev):
    """[len(codes), n_out, n_in]: the dense map of a linear cell function for
    each code, from unit inputs: fn(unit inputs [n_in, n_in], code) gives the
    outputs [n_in, n_out], one a unit input; the map is their transpose."""
    eye = torch.eye(n_in, dtype=torch.float64, device=dev)
    return torch.stack([fn(eye, int(c)).T for c in codes]).to(dt)


def cell_csr(block, cols, n_cols, chunk=16384):
    """One CSR matrix of a cell-wise map, rows cell by cell: cell c's n_loc
    rows take its dense block [n_loc, n_loc] (out by in) at its input
    columns cols [n_cells, n_loc] (unsorted, as cuSPARSE's product takes
    them); block(s, e) gives cells s .. e-1's blocks. int32 indices (the
    entries must fit). Filled cell chunk by cell chunk into the
    preallocated entries."""
    n_cells, n_loc = cols.shape
    nnz = n_cells * n_loc * n_loc
    check(nnz < 2**31 and n_cols < 2**31, f"a cell CSR of {nnz} nonzeros needs int64 indices")
    dev = cols.device
    crow = torch.arange(n_cells * n_loc + 1, device=dev, dtype=torch.int32).mul_(n_loc)
    col = torch.empty(nnz, dtype=torch.int32, device=dev)
    val = None
    for s in range(0, n_cells, chunk):
        e = min(s + chunk, n_cells)
        v = block(s, e)
        if val is None:
            val = torch.empty(nnz, dtype=v.dtype, device=dev)
        col[s * n_loc * n_loc:e * n_loc * n_loc] = cols[s:e, None, :].expand(
            e - s, n_loc, n_loc).reshape(-1)
        val[s * n_loc * n_loc:e * n_loc * n_loc] = v.reshape(-1)
    return torch.sparse_csr_tensor(crow, col, val, (n_cells * n_loc, n_cols))


def mask_groups(mf, dev):
    """(the distinct masks, each cell's index among them)."""
    masks = mf._on("masks", dev).long()
    codes = torch.unique(masks)
    return codes.tolist(), torch.searchsorted(codes, masks)


def laplace_library(mf, dev, dt, slow, hn):
    """cell_laplace's map as one CSR matrix from the global vector to the
    cell rows: each cell's dense n_loc^2 block (its interpolation, the
    Laplace and the transposed interpolation composed; none on the slow
    path and without constraints) at the DoFs its map names (a 2-D cell's
    25^2 entries fit: 657 M at quadrant nref=11 p=4, 5.3 GB in f32 with
    int32 indices). Cartesian: the blocks come from unit inputs through the
    plain version at geo 1, one a mask, scaled by each cell's factor (equal
    on both axes, checked: cube cells). Deformed (high_order_mapping): each
    cell's block from unit inputs through the plain version with the cell's
    own metric and mask, in chunks of cells. Returns (matrix, nonzeros)."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import cell_laplace

    n_loc = (mf.degree + 1) ** mf.dim
    on = lambda k: mf._on(k, dev, torch.float64)
    factors = (on("P"), on("S"), on("Dc"), on("quad_w"))
    geo = mf._on("geo", dev, torch.float64)
    if mf.high_order_mapping:
        masks = mf._on("masks", dev)
        eye = torch.eye(n_loc, dtype=torch.float64, device=dev)

        def block(s, e):  # row (c, j) of the probe: cell c's map of unit input j
            out = cell_laplace.cell_laplace_plain(
                eye.repeat(e - s, 1), None, masks[s:e].repeat_interleave(n_loc), *factors,
                geo[s:e].repeat_interleave(n_loc, dim=0))
            return out.view(e - s, n_loc, n_loc).transpose(1, 2).to(dt)
    else:
        if hn and not slow:
            codes, group = mask_groups(mf, dev)
        else:
            codes, group = [0], torch.zeros(mf.n_cells, dtype=torch.long, device=dev)
        check(bool((geo == geo[:, :1]).all()), "the 2-D library call needs cube cells")
        ones = torch.ones((n_loc, mf.dim), dtype=torch.float64, device=dev)
        maps = probe_maps(lambda e, c: cell_laplace.cell_laplace_plain(
            e, None, torch.full((n_loc,), c, dtype=torch.int32, device=dev), *factors, ones),
            n_loc, codes, dt, dev)
        scale = geo[:, 0].to(dt)
        block = lambda s, e: maps[group[s:e]] * scale[s:e, None, None]
    M = cell_csr(block, mf._on("dofmap_plain" if slow else "dofmap", dev), mf.n_dofs)
    return M, M._nnz()


def index2d_run(what, fn, plain, wrappers, expect, tol=1e-5, copies=0, n_dofs=None):
    """One 2-D index-engine call, float32 through the kernels: against the
    plain float64 path on the card, its launches checked exactly, two calls
    bit-identical, timed (median of CUDA-event-timed back-to-back calls),
    GDoF/s where n_dofs is given, the host's issue time and a profile (no
    device launch outside the port's kernels but `copies` device copies).
    Returns its numbers."""
    ref = plain()
    out, n = counted(wrappers, fn)
    n = {k: c for k, c in n.items() if c}
    err = errors(out, ref)[1]
    del ref
    same = bool(torch.equal(fn(), fn()))
    print(f"2-D {what} f32 vs plain f64 path: max rel err {err:.3e} (tol {tol:g}), launches {n}, "
          f"two calls bit-identical: {same}", flush=True)
    check(bool(torch.isfinite(out).all()), f"2-D {what} gave non-finite values")
    check(err <= tol, f"2-D {what} disagrees with the float64 path: {err:.3e}")
    check(n == expect, f"2-D {what} launched {n}, not {expect}")
    check(same, f"two calls of the 2-D {what} differ")
    res = dict(ms=time_ms(fn, reps=20, warmup=3), plain_ms=time_ms(plain, reps=3, warmup=1),
               max_rel_err=err, launches=n, host_ms=host_ms(fn, reps=20),
               profile=profile_path(f"2-D {what}", fn, set(wrappers), sum(expect.values()),
                                    copies=copies))
    if n_dofs is not None:
        res["gdofs_per_s"] = n_dofs / res["ms"] / 1e6
    return res


def index2d_gmg(mt, dev, wrappers, smi):
    """The index GMG-CG in 2-D: at quadrant nref=INDEX2D_GMG_NREF p=4 f32,
    tol 1e-5 (setup by step and levels, a warm-up solve, then the counted
    solve: iterations, relative residual, seconds; one V-cycle's launches,
    the host's time to issue it and its profile: busy and idle share); at
    INDEX2D_GMG_CHECK in float64, tol 1e-10, the iteration count on the card
    against the CPU's plain path (as phase 10 holds the 3-D one). Returns
    (numbers, the finest Transfer of the f32 solve)."""
    t0 = time.perf_counter()
    gmg = mt.GMGPreconditioner("quadrant", 2, INDEX2D_GMG_NREF, INDEX2D_DEGREE,
                               dtype=np.float32, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    levels = [dict(cells=mf.n_cells, n_dofs=mf.n_dofs) for mf in gmg.levels]
    op, mf = gmg.fine_op, gmg.fine_mf
    print(f"2-D GMG setup: {setup_s:.1f} s (quadrant nref={INDEX2D_GMG_NREF} p={INDEX2D_DEGREE} "
          f"f32, {len(levels)} levels: {levels})", flush=True)
    xs = mf.constraints.distribute(np.random.default_rng(SEED).standard_normal(mf.n_dofs))
    xs[op.bdofs] = 0.0
    b = op.vmult(torch.from_numpy(xs.astype(np.float32)).to(dev))
    solve = lambda: mt.solve_cg(op, b, M=gmg, tol=1e-5, max_iter=100)
    t0 = time.perf_counter()
    x0, it0, _ = solve()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (x, iters, res), counts = counted(wrappers, solve)
    solve_s = time.perf_counter() - t0
    counts = {k: c for k, c in counts.items() if c}
    rel = res / float(torch.linalg.vector_norm(b))
    print(f"2-D GMG-CG quadrant nref={INDEX2D_GMG_NREF} p={INDEX2D_DEGREE} f32 on {smi}: {iters} "
          f"iterations, relative residual {rel:.3e}; solve {solve_s:.4f} s, "
          f"{solve_s / max(iters, 1):.4f} s an iteration (warm-up {warm_s:.2f} s); launches "
          f"{counts}", flush=True)
    check(bool(torch.isfinite(x).all()) and iters < 100 and rel <= 1e-5,
          f"the 2-D GMG-CG did not converge: {iters} iterations, {rel:.3e}")
    check(it0 == iters and torch.equal(x0, x), "two 2-D GMG solves are not bit-identical")
    check(counts.get("cell_transfer", 0) > 0, "the 2-D GMG solve never launched cell_transfer")
    vc, vcounts = counted(wrappers, lambda: gmg(b))
    vcounts = {k: c for k, c in vcounts.items() if c}
    check(bool(torch.isfinite(vc).all()), "the 2-D V-cycle gave non-finite values")
    # the coarse level's CG reads a residual to the host an iteration and takes dots
    v_prof = profile_path("2-D V-cycle", lambda: gmg(b), set(wrappers), sum(vcounts.values()),
                          reps=5, classes={"reduction": None, "copy": None})
    v_host = host_ms(lambda: gmg(b), reps=5, warmup=1)
    print(f"2-D V-cycle: port launches {vcounts}, host time to issue {v_host:.4f} ms", flush=True)
    tr = gmg.transfers[-1]
    numbers = dict(nref=INDEX2D_GMG_NREF, degree=INDEX2D_DEGREE, dtype="float32", tol=1e-5,
                   setup_s=setup_s, levels=levels, iterations=iters, rel_res=rel,
                   solve_s=solve_s, s_per_iter=solve_s / max(iters, 1), warmup_s=warm_s,
                   launches=counts, vcycle=dict(launches=vcounts, host_ms=v_host,
                                                profile=v_prof))
    del gmg, op, b, x, x0, vc

    nref, p = INDEX2D_GMG_CHECK
    its, dx, err, _, _ = index_gmg_solves(mt, 2, nref, p, 1e-10, dev, wrappers)
    numbers["f64_check"] = dict(nref=nref, degree=p, iterations=its[str(dev)],
                                iterations_cpu=its["cpu"], solution_diff=dx, err=err)
    return numbers, tr


def index2d_oracle_checks(mt, dev):
    """float64 through the kernels at the reference's 2-D cases: the vmult
    (fast and slow) against the scipy oracle at INDEX2D_ORACLE and the
    elasticity vmult (mu=1.3, lam=0.7) against the dense oracle at
    INDEX2D_ELASTIC_ORACLE (1e-12)."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import elasticity_oracle, vmult_oracle

    out = {}
    for geo, nref, p in INDEX2D_ORACLE:
        tria = mt.create_geometry(geo, 2, nref)
        mf = mt.MatrixFree(tria, p)
        u = np.random.default_rng(SEED).standard_normal(mf.n_dofs)
        ref = vmult_oracle(tria, p, u)
        for slow in (False, True):
            got = mt.LaplaceOperator(mf, slow=slow, device=dev).vmult(u).cpu().numpy()
            err = float(np.abs(got - ref).max() / np.abs(ref).max())
            key = f"{geo} nref={nref} p={p}{' slow' if slow else ''}"
            out[key] = err
            print(f"2-D index vmult {key} f64 vs scipy oracle: max rel err {err:.3e} (tol 1e-12)",
                  flush=True)
            check(err <= 1e-12, f"2-D float64 vmult {key} disagrees with the oracle: {err:.3e}")
    geo, nref, p = INDEX2D_ELASTIC_ORACLE
    tria = mt.create_geometry(geo, 2, nref)
    mf = mt.MatrixFree(tria, p)
    u = np.random.default_rng(SEED).standard_normal((mf.n_dofs, 2))
    ref = elasticity_oracle(tria, p, 1.3, 0.7, u)
    got = mt.ElasticityOperator(mf, 1.3, 0.7, device=dev).vmult(u).cpu().numpy()
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    out[f"elasticity {geo} nref={nref} p={p}"] = err
    print(f"2-D elasticity vmult {geo} nref={nref} p={p} f64 vs dense oracle: max rel err "
          f"{err:.3e} (tol 1e-12)", flush=True)
    check(err <= 1e-12, f"2-D float64 elasticity disagrees with the oracle: {err:.3e}")
    return out


def index2d_elasticity(mt, mf, xe, dev, wrappers, smi, nnz):
    """The 2-D index elasticity of phase 14 on mf (quadrant nref=INDEX2D_NREF
    p=4 f32) and the displacement xe [n_dofs, 2]: cell_elasticity's 2-D index
    instance and dof_scatter's component axis at k = 2 against their plain
    versions, timed with their bounds and library calls (none for
    cell_elasticity: its coupled map's nonzeros go into nnz, not built;
    ``index_add_`` for dof_scatter); the elastic vmult (``index2d_run``: 2
    launches, the plain float64 path, timed, GDoF/s over 2 n_dofs, the
    profile). Returns ({kernel: [part]}, the vmult's numbers)."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import cell_elasticity, dof_scatter

    tol, f32, p = 1e-5, torch.float32, mf.degree
    el_args = (xe, *mf.cell_laplace_args(dev, f32), 1.0, 1.0)
    fac = cell_elasticity.factor_tables(mf._sources["S"], mf._sources["Dc"])
    rows2 = cell_elasticity.cell_elasticity(*el_args, factors=fac)
    scatter = mf.scatter_tables(False, dev)
    # the coupled map composed: a dense (2 n_loc)^2 block a cell
    nnz["cell_elasticity (not built)"] = mf.n_cells * (2 * (p + 1) ** 2) ** 2
    print(f"2-D elasticity's coupled map, not built: {nnz['cell_elasticity (not built)']} "
          f"nonzeros (int64 indices from 2^31 on; cuSPARSE's SpMV raised an internal error on "
          f"this matrix, 2,629,172,500 nonzeros at quadrant nref=11 p=4, on an H100)",
          flush=True)
    dof = mf._on("dofmap", dev).reshape(-1).long()
    src2 = rows2.reshape(2, -1).T.contiguous()
    out2 = torch.zeros((mf.n_dofs, 2), dtype=f32, device=dev)
    el_parts = [("2-D index", lambda: cell_elasticity.cell_elasticity(*el_args, factors=fac),
                 lambda: cell_elasticity.cell_elasticity_plain(*el_args),
                 cell_elasticity.bytes_and_flops(*el_args), None, None)]
    sc_parts = [("2-D components k=2", lambda: dof_scatter.dof_scatter(rows2, *scatter),
                 lambda: dof_scatter.dof_scatter_plain(rows2, *scatter),
                 dof_scatter.bytes_and_flops(rows2, *scatter), None, None)]
    parts = {"cell_elasticity": measure_parts("cell_elasticity", el_parts, [None], {}, f32, tol),
             "dof_scatter": measure_parts("dof_scatter", sc_parts,
                                          [lambda: out2.zero_().index_add_(0, dof, src2)], {},
                                          f32, tol)}
    del rows2, src2, out2
    torch.cuda.empty_cache()
    op_e = mt.ElasticityOperator(mf, device=dev)
    res = index2d_run("elasticity", lambda: op_e.vmult(xe),
                      lambda: op_e.vmult(xe.double(), plain=True), wrappers,
                      INDEX2D_LAUNCHES["elasticity"], tol, n_dofs=2 * mf.n_dofs)
    return parts, res


def index2d_phase(mt, dev, wrappers, smi, index_only=False):
    """2-D on the index engine at quadrant nref=INDEX2D_NREF p=4 float32:
    the setup by step and the sizes; every 2-D kernel instance against its
    plain version (1e-5), timed with its bound and library call (each map
    composed into one CSR matrix: hn_interp's, cell_laplace's four launches,
    cell_transfer's; none for cell_elasticity, its count printed;
    dof_scatter's index_add_); the vmult (fast, slow,
    constraints=False), the deformed vmult, the elasticity vmult and
    apply_hanging_node_constraints against the plain float64 path (1e-5),
    launches checked, bit-identical, timed, profiled; the HN overhead;
    float64 against the oracles; the GMG-CG solve. index_only: the Laplace
    paths alone (no elasticity, no GMG-CG; ``--index``). Returns (numbers,
    {kernel: [part]}, the compact engine's MatrixFree, which phase 15 reuses,
    and the deformed MatrixFree, which phase 16 reuses)."""
    tol, f32 = 1e-5, torch.float32
    p = INDEX2D_DEGREE
    setup = {}
    t0 = time.perf_counter()
    tria = mt.create_quadrant(2, INDEX2D_NREF)
    setup["mesh"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mf = mt.MatrixFree(tria, p, dtype=np.float32)
    setup["matrix_free"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mfs = {"compact": mf, "sorted": mt.MatrixFree(tria, p, dtype=np.float32, hn_mode="sorted")}
    setup["runner sorted"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for mode in ("all", "matrix"):  # the compact engine's host tables under another runner
        mfs[mode] = mt.MatrixFree.from_tables(mf._np, mf.n_dofs, hn_mode=mode)
    setup["runners all, matrix (from the tables)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mf.scatter_tables(False, dev), mf.scatter_tables(True, dev), mf.slow_tables(dev, f32)
    mf._on("dofmap", dev), mf._on("masks", dev), mf._on("hn_idx", dev)
    torch.cuda.synchronize()
    setup["device tables"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tria_d = tria if INDEX2D_DEFORMED_NREF == INDEX2D_NREF else mt.create_quadrant(
        2, INDEX2D_DEFORMED_NREF)
    mf_d = mt.MatrixFree(tria_d, p, dtype=np.float32, high_order_mapping=True)
    setup["deformed matrix_free"] = time.perf_counter() - t0
    setup["deformed metric"], peak, metric_bytes = metric_build(mf_d, dev)
    setup["deformed metric host peak bytes"] = peak
    masks = np.asarray(mf._np["masks"])
    sizes = dict(cells=mf.n_cells, n_dofs=mf.n_dofs, constrained_cells=mf.n_hn_cells,
                 codes=int(np.unique(masks).size), codes_list=np.unique(masks).tolist(),
                 slaves=int(len(mf._np["slow"]["slave"])),
                 dofmap_bytes=int(mf._np["dofmap"].nbytes),
                 row_bytes=mf.n_cells * (p + 1) ** 2 * 4, metric_bytes=metric_bytes,
                 deformed_nref=INDEX2D_DEFORMED_NREF, deformed_cells=mf_d.n_cells)
    print(f"2-D index setup (quadrant nref={INDEX2D_NREF} p={p} f32), seconds by step: "
          f"{json.dumps(setup)}; sizes: {json.dumps(sizes)}", flush=True)
    check(mf.n_hn_cells > 0 and sizes["codes"] > 2, "the 2-D mesh has too few constrained cells")

    x = op_input(mf, dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = torch.randn(mf.n_cells, (p + 1) ** 2, generator=g, device=dev, dtype=f32)
    x_d = op_input(mf_d, dev)
    xe = torch.randn(mf.n_dofs, 2, generator=g, device=dev, dtype=f32)

    # ---- each kernel instance against its plain version, timed with its bound and library
    t0 = time.perf_counter()
    calls, inter = index_kernel_calls(mfs, x, rows, deformed=(mf_d, x_d),
                                      deformed_nref=INDEX2D_DEFORMED_NREF)
    lib, nnz = index_yardsticks(mfs, inter, {k: len(v) for k, v in calls.items()})
    mats = {}
    launched = ((mf, x, False, True), (mf, inter["x_dist"], True, False), (mf, x, False, False),
                (mf_d, x_d, False, True))  # index_kernel_calls' order: fast, slow, cf, deformed
    for i, (m, src, slow, hn) in enumerate(launched):
        mats[i], nnz[f"cell_laplace[{calls['cell_laplace'][i][0]}]"] = laplace_library(
            m, dev, f32, slow, hn)
        lib["cell_laplace"][i] = lambda M=mats[i], v=src: M @ v
    torch.cuda.synchronize()
    nnz.pop("cell_laplace (not built)")
    print(f"2-D index maps composed into one CSR matrix each (the library calls; "
          f"{time.perf_counter() - t0:.1f} s), nonzeros: {nnz}", flush=True)
    parts = {name: measure_parts(name, cparts, lib[name], {}, f32, tol)
             for name, cparts in calls.items()}
    del calls, inter, lib, mats
    torch.cuda.empty_cache()

    if not index_only:
        el_parts, res_e = index2d_elasticity(mt, mf, xe, dev, wrappers, smi, nnz)
        for name, plist in el_parts.items():
            parts[name] = parts.get(name, []) + plist

    # ---- the end-to-end calls
    LO = mt.LaplaceOperator
    ops = {"vmult": LO(mf, device=dev), "vmult slow": LO(mf, slow=True, device=dev),
           "vmult constraints=False": LO(mf, constraints=False, device=dev)}
    op_d = LO(mf_d, device=dev)
    x64, rows64 = x.double(), rows.double()
    runs = {call: (lambda o=o: o.vmult(x), lambda o=o: o.vmult(x64, plain=True), mf.n_dofs, 0)
            for call, o in ops.items()}
    runs["vmult deformed"] = (lambda: op_d.vmult(x_d),
                              lambda: op_d.vmult(x_d.double(), plain=True), mf_d.n_dofs, 0)
    runs["apply_hanging_node_constraints"] = (
        lambda: mf.apply_hanging_node_constraints(rows, False),
        lambda: mf.apply_hanging_node_constraints(rows64, False, plain=True), None, 1)
    res = {call: index2d_run(call, fn, plain, wrappers, INDEX2D_LAUNCHES[call], tol,
                             copies=copies, n_dofs=n)
           for call, (fn, plain, n, copies) in runs.items()}
    if not index_only:
        res["elasticity"] = res_e
    runners = {}
    for mode, m in mfs.items():
        op = LO(m, device=dev)
        out, n = counted(wrappers, lambda: op.vmult(x))
        n = {k: c for k, c in n.items() if c}
        check(n == INDEX2D_LAUNCHES["vmult"], f"2-D runner {mode} launched {n}")
        v_err = errors(out, ops["vmult"].vmult(x64, plain=True))[1]
        check(v_err <= tol, f"2-D runner {mode}'s vmult disagrees: {v_err:.3e}")
        runners[mode] = dict(vmult_ms=time_ms(lambda: op.vmult(x), reps=20, warmup=3),
                             vmult_err=v_err,
                             hn_ms=time_ms(lambda: m.apply_hanging_node_constraints(rows, False),
                                           reps=20, warmup=3))
        del op
    base = res["vmult constraints=False"]["ms"]
    overhead = {"fast": res["vmult"]["ms"] / base, "slow": res["vmult slow"]["ms"] / base}
    print(f"2-D index engine nref={INDEX2D_NREF} p={p} f32 on {smi}: vmult "
          f"{res['vmult']['ms']:.4f} ms ({res['vmult']['gdofs_per_s']:.4f} GDoF/s), slow "
          f"{res['vmult slow']['ms']:.4f}, constraints=False {base:.4f}; HN overhead fast "
          f"{overhead['fast']:.4f}, slow {overhead['slow']:.4f}; deformed "
          f"{res['vmult deformed']['ms']:.4f} ms; "
          + ("" if index_only else f"elasticity {res['elasticity']['ms']:.4f} ms "
             f"({res['elasticity']['gdofs_per_s']:.4f} GDoF/s over 2 n_dofs); ")
          + f"runners {json.dumps(runners)}", flush=True)
    del ops, op_d, mfs, x64, rows64
    torch.cuda.empty_cache()

    # ---- float64 against the oracles, and the GMG-CG solve
    t0 = time.perf_counter()
    oracle = index2d_oracle_checks(mt, dev)
    oracle_s = time.perf_counter() - t0
    gmg = None
    if not index_only:
        t0 = time.perf_counter()
        gmg, tr = index2d_gmg(mt, dev, wrappers, smi)
        gmg["phase_s"] = time.perf_counter() - t0
        tr_calls, tr_lib, nnz["cell_transfer"] = cell_transfer_calls(tr, dev)
        parts["cell_transfer"] = measure_parts("cell_transfer", [
            (f"2-D {mode} nref {INDEX2D_GMG_NREF - 1} -> {INDEX2D_GMG_NREF}", *rest)
            for mode, *rest in tr_calls], tr_lib, {}, f32, tol)
        del tr, tr_calls, tr_lib
        torch.cuda.empty_cache()

    # each part named 2-D, with the launches of the call that runs it
    def call_of(name, mode):
        if name == "hn_interp":
            return "apply_hanging_node_constraints"
        if name == "cell_laplace":
            return "vmult deformed" if "deformed" in mode else mode
        if name == "dof_scatter":
            return {"fast map": "vmult", "plain map": "vmult slow"}.get(mode, "elasticity")
        return {"constraints_slow": "vmult slow", "cell_elasticity": "elasticity"}[name]

    for name, plist in parts.items():
        for part in plist:
            if name == "cell_transfer":
                part["launches"] = gmg["launches"].get(name, 0)
                part["call"] = "2-D GMG-CG solve"
            else:
                call = call_of(name, part["mode"])
                part["launches"] = res[call]["launches"].get(name, 0)
                part["call"] = f"2-D {call}"
            if not part["mode"].startswith("2-D"):
                part["mode"] = f"2-D {part['mode']}"
    shares = scatter_shares(mf)
    print(f"dof_scatter's schedule at 2-D quadrant nref={INDEX2D_NREF} p={p} (host): "
          f"{json.dumps(shares)}", flush=True)
    numbers = dict(nref=INDEX2D_NREF, degree=p, dtype="float32", setup_s=setup, sizes=sizes,
                   **res, runners=runners, hn_overhead=overhead, f64_oracle=oracle,
                   f64_oracle_s=oracle_s, gmg=gmg, library_nnz=nnz,
                   dof_scatter_shares=shares, card=smi)
    return numbers, parts, mf, mf_d


# 2-D on the brick engine (phase 15): every degree on phase 14's mesh (quadrant
# nref=INDEX2D_NREF; p=4 on phase 14's own MatrixFree, p <= 3 on a new one each), the multi-RHS
# vmult at p=4, and float64 against the oracle at the reference's 2-D cases (tests/test_bricks.py:
# test_brick_mm_2d, the face planes at quadrant nref=5 p=3, uniform nref=3 p=4) and at quadrant
# nref=4 p=3, 4: (geometry, nref, degree, face_planes)
BRICK2D_DEGREES = (4, 3, 2, 1)
BRICK2D_MULTI_K = 8
BRICK2D_ORACLE = (("quadrant", 3, 2, None), ("step", 3, 1, None), ("uniform", 2, 2, None),
                  ("quadrant", 3, 5, None), ("quadrant", 2, 6, None), ("quadrant", 5, 3, True),
                  ("uniform", 3, 4, None), ("quadrant", 4, 3, None), ("quadrant", 4, 4, None))


def brick2d_oracle_checks(mt, dev):
    """float64 through the kernels at BRICK2D_ORACLE: the vmult against the
    scipy oracle (at the non-hanging DoFs; 1e-12), vmult_plain and refill
    against their plain paths (1e-12). Returns {case: error}."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import vmult_oracle

    out = {}
    for geo, nref, p, fp in BRICK2D_ORACLE:
        tria = mt.create_geometry(geo, 2, nref)
        mf = mt.MatrixFree(tria, p, dtype=np.float64)
        op = mt.BrickLaplaceMM(mf, device=dev, face_planes=fp)
        u = np.random.default_rng(SEED).standard_normal(mf.n_dofs)
        x = op.from_dof_vector(u)
        y = op.vmult(x)
        ref = vmult_oracle(tria, p, u)
        err = float(np.abs(op.to_dof_vector(y, zero_hanging=True).cpu().numpy() - ref).max()
                    / np.abs(ref).max())
        key = f"{geo} nref={nref} p={p}" + (" face_planes" if fp else "")
        plain = {call: errors(getattr(op, call)(z), getattr(op, call)(z, plain=True))[1]
                 for call, z in (("vmult_plain", x), ("refill", y))}
        out[key] = dict(vmult=err, **plain)
        print(f"2-D brick vmult {key} f64 vs scipy oracle: max rel err {err:.3e} (tol 1e-12); "
              f"vmult_plain, refill vs their plain paths {plain}", flush=True)
        check(err <= 1e-12, f"2-D float64 brick vmult {key} disagrees with the oracle: {err:.3e}")
        for call, e in plain.items():
            check(e <= 1e-12, f"2-D float64 brick {call} {key} disagrees with its plain path")
    return out


def brick2d_phase(mt, mf, index_vmult_ms, dev, wrappers, smi):
    """2-D on the brick engine at quadrant nref=INDEX2D_NREF float32, on
    phase 14's mesh: at each degree of BRICK2D_DEGREES (p=4 on phase 14's
    MatrixFree mf, p <= 3 on a new one each) ``degree_phase`` with the tag
    "2-D brick ": the setup by step and the sizes; every kernel instance
    against its plain version (1e-5), timed with its bound and library
    call; vmult, vmult_plain and refill against the plain float64 path
    (1e-5), launches checked exactly (p >= 4: 5, 4, 2; p = 3: 5, 3, 2;
    p <= 2: 8, 3, 3), two calls bit-identical, timed (GDoF/s, host_ms,
    busy and idle share); the HN overhead; the p=4 brick vmult over the
    2-D index vmult of phase 14 (index_vmult_ms); vmult_multi at k=8 and
    p=4 (launches, each RHS bit-identical to vmult of it); float64 against
    the oracle. Returns (numbers, {kernel: [part]}, the p=4 float32
    operator, which phase 16's elasticity wraps)."""
    numbers, parts, keep = {}, {}, {}
    for p in BRICK2D_DEGREES:
        t0 = time.perf_counter()
        own = mf if p == mf.degree else None
        numbers[f"p={p}"], pparts = degree_phase(mt, mf.tria, INDEX2D_NREF, p, dev, wrappers, smi,
                                                 keep=keep if own is not None else None, mf=own,
                                                 tag="2-D brick ")
        numbers[f"p={p}"]["phase_s"] = time.perf_counter() - t0
        for name, plist in pparts.items():
            parts.setdefault(name, []).extend(plist)
        torch.cuda.empty_cache()
    op = keep.pop(mf.degree)
    bvk = multi_inputs(op, BRICK2D_MULTI_K, SEED)
    multi, _ = multi_run(op, bvk, wrappers, smi, f"2-D p={op.p} k={BRICK2D_MULTI_K}")
    del bvk
    torch.cuda.empty_cache()
    main = numbers[f"p={mf.degree}"]["vmult"]["ms"]
    ratio = main / index_vmult_ms
    print(f"2-D brick engine quadrant nref={INDEX2D_NREF} on {smi}: HN overhead (vmult / "
          f"vmult_plain) " + ", ".join(f"{k} {v['hn_overhead']:.4f}" for k, v in numbers.items())
          + f"; the p={mf.degree} brick vmult {main:.4f} ms over the 2-D index vmult "
          f"{index_vmult_ms:.4f} ms: {ratio:.4f}", flush=True)
    t0 = time.perf_counter()
    oracle = brick2d_oracle_checks(mt, dev)
    numbers.update(multi=multi, brick_over_index=ratio, index_vmult_ms=index_vmult_ms,
                   f64_oracle=oracle, f64_oracle_s=time.perf_counter() - t0, card=smi)
    return numbers, parts, op


# ---- the rest of 2-D on the brick engine (phase 16) -------------------------------------
# the deformed 2-D brick engine on phase 14's deformed MatrixFree (quadrant nref=
# INDEX2D_DEFORMED_NREF, p=4) and at BRICK2D_DEFORMED_LOW (the B=16 class); float64 at the
# reference's 2-D deformed case (tests/test_bricks.py: quadrant nref=4 p=3) and one case a
# (p, B) class; the 2-D brick GMG-CG at quadrant nref=BRICK2D_GMG_NREF p=4 f32 and at
# BRICK2D_GMG_CHECK in float64; the 2-D brick elasticity on phase 15's p=4
# operator (quadrant nref=INDEX2D_NREF) and against the dense oracle at BRICK2D_ELASTIC_ORACLE
BRICK2D_DEFORMED_LOW = (2, 11)  # degree, quadrant nref
# the 2-D brick GMG-CG's quadrant nref, one below the index GMG's so that the whole run fits
# its time limit
BRICK2D_GMG_NREF = 9
BRICK2D_DEFORMED_F64 = (("quadrant", 4, 3), ("quadrant", 6, 1), ("quadrant", 4, 2),
                        ("quadrant", 4, 4), ("quadrant", 3, 5), ("quadrant", 3, 6))
BRICK2D_GMG_CHECK = (4, 2)  # quadrant nref, degree of the float64 solve held to the CPU's count
BRICK2D_ELASTIC_ORACLE = (("quadrant", 3, 2), ("quadrant", 3, 4))


def brick2d_deformed(mt, mf_d, index_ms, dev, wrappers, smi):
    """The deformed 2-D brick engine at quadrant nref=INDEX2D_DEFORMED_NREF
    p=4 f32 on phase 14's deformed MatrixFree mf_d (its host metric built
    there): the operator's setup; brick_deformed (with and without cell
    rows), cell_apply's and hn_cell's deformed modes against their plain
    versions (1e-5), timed with their bounds and library calls; vmult,
    vmult_plain and refill (``deformed_run``: 5 / 2 / 2 launches, two calls
    bit-identical, the plain float64 path, times, profiles); GDoF/s and the
    ratio to phase 14's deformed index vmult (index_ms); the f32 vmult
    against the deformed index engine's (1e-5); BRICK2D_DEFORMED_LOW the
    same without profiles; float64 at BRICK2D_DEFORMED_F64. Returns
    (numbers, {kernel: [part]})."""
    t0 = time.perf_counter()
    op = mt.BrickLaplaceMM(mf_d, device=dev)
    torch.cuda.synchronize()
    op_s = time.perf_counter() - t0
    op64 = mt.BrickLaplaceMM(mf_d, device=dev, dtype=torch.float64)
    torch.cuda.synchronize()
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import brick_deformed

    n_present = int(brick_deformed.present_cells(op.present_bits, op.C).numel())
    setup = dict(operator=op_s, operator_steps=op.setup_s,
                 operator_f64=time.perf_counter() - t0 - op_s,
                 metric_device_bytes=op.metric.numel() * op.metric.element_size())
    sizes = dict(n_dofs=mf_d.n_dofs, bricks=op.n_bricks, B=op.B, NB=op.NB,
                 subset_bricks=op.n_sub, constrained_rows=op.n_hn, present_cells=n_present)
    print(f"2-D deformed brick setup (quadrant nref={INDEX2D_DEFORMED_NREF} p={op.p} f32): "
          f"{json.dumps(setup)}; sizes {json.dumps(sizes)}", flush=True)
    check(op.dim == 2 and op.deformed and op.n_hn > 0, "the 2-D deformed operator is malformed")
    u = np.random.default_rng(SEED).standard_normal(mf_d.n_dofs).astype(np.float32)
    x = op.from_dof_vector(u)
    calls, libs, nnz = deformed_kernel_calls(op, x)
    print(f"2-D deformed maps composed into one CSR matrix each (the library calls), nonzeros: "
          f"{nnz}; brick_deformed's over the brick nodes, the cells' {op.n_loc}^2 blocks summed "
          f"where they share a node", flush=True)
    parts = {name: measure_parts(name, cparts, libs[name], {}, x.dtype, 1e-5)
             for name, cparts in calls.items()}
    deformed_plan(op, parts["brick_deformed"], dev, smi)
    del calls, libs
    torch.cuda.empty_cache()
    what = f"2-D deformed p={op.p} nref={INDEX2D_DEFORMED_NREF}"
    numbers, launches = deformed_run(op, op64, x, wrappers, smi, what)
    ms = numbers["vmult"]["ms"]
    idx = mt.LaplaceOperator(mf_d, device=dev)
    ref = idx.vmult(torch.from_numpy(u).to(dev))
    ref[torch.from_numpy(mf_d.constraints.constrained_dof_marker()).to(dev)] = 0.0
    cross = errors(op.to_dof_vector(op.vmult(x), zero_hanging=True), ref)[1]
    check(cross <= 1e-5, f"the 2-D deformed brick vmult disagrees with the index engine's: "
                         f"{cross:.3e}")
    numbers.update(setup=setup, sizes=sizes, gdofs_per_s=mf_d.n_dofs / ms / 1e6,
                   index_vmult_ms=index_ms, brick_over_index=ms / index_ms,
                   vs_index_max_rel_err=cross, library_nnz=nnz, card=smi)
    print(f"{what} f32 on {smi}: vmult {ms:.4f} ms ({numbers['gdofs_per_s']:.4f} GDoF/s), "
          f"vmult_plain {numbers['vmult_plain']['ms']:.4f}, refill "
          f"{numbers['refill']['ms']:.4f}; HN overhead {numbers['hn_overhead']:.4f}; over the "
          f"2-D deformed index vmult {index_ms:.4f} ms: {ms / index_ms:.4f}; against the "
          f"deformed index vmult (f32, through its kernels) max rel err {cross:.3e} (tol 1e-5)",
          flush=True)
    del op, op64, idx, ref, x
    torch.cuda.empty_cache()

    p, nref = BRICK2D_DEFORMED_LOW
    t0 = time.perf_counter()
    tria = mf_d.tria if nref == INDEX2D_DEFORMED_NREF else mt.create_quadrant(2, nref)
    mf_l = mt.MatrixFree(tria, p, dtype=np.float32, high_order_mapping=True)
    op_l = mt.BrickLaplaceMM(mf_l, device=dev)
    op_l64 = mt.BrickLaplaceMM(mf_l, device=dev, dtype=torch.float64)
    torch.cuda.synchronize()
    low_setup = time.perf_counter() - t0
    x_l = op_l.from_dof_vector(np.random.default_rng(SEED).standard_normal(mf_l.n_dofs))
    low, _ = deformed_run(op_l, op_l64, x_l, wrappers, smi, f"2-D deformed p={p} nref={nref}",
                          profile=False)
    low.update(setup_s=low_setup, n_dofs=mf_l.n_dofs, B=op_l.B,
               gdofs_per_s=mf_l.n_dofs / low["vmult"]["ms"] / 1e6)
    numbers[f"p={p} nref={nref}"] = low
    del op_l, op_l64, mf_l, x_l
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers["f64"] = deformed_f64_checks(mt, dev, wrappers, dim=2, cases=BRICK2D_DEFORMED_F64)
    numbers["f64_s"] = time.perf_counter() - t0
    for name, plist in parts.items():
        for i, part in enumerate(plist):
            call = "vmult_plain" if name == "brick_deformed" and i == 1 else "vmult"
            part["launches"] = numbers[call]["launches"].get(name, 0)
            part["call"] = f"2-D deformed {call}"
            part["mode"] = f"2-D {part['mode']}"
    return numbers, parts


def brick2d_gmg(mt, dev, wrappers, smi):
    """The 2-D brick GMG-CG (BrickGMGPreconditioner in 2-D, its device
    solver) at quadrant nref=BRICK2D_GMG_NREF p=4 f32, tol 1e-5: the setup
    and levels, a warm-up solve, then the counted solve (iterations,
    relative residual, seconds a solve and an iteration, two solves
    bit-identical, brick_transfer and dof_embed launched); one V-cycle's
    launches by kernel, the host's time to issue it and its profile;
    brick_transfer's and dof_embed's dim=2 instances at the finest transfer
    against their plain versions (1e-5), timed with bounds and library
    calls (each map one CSR matrix); at BRICK2D_GMG_CHECK in float64 (tol
    1e-10) the iteration count on the card against the CPU's plain path.
    Returns (numbers, {kernel: [part]})."""
    p = INDEX2D_DEGREE
    t0 = time.perf_counter()
    gmg = mt.BrickGMGPreconditioner("quadrant", 2, BRICK2D_GMG_NREF, p, dtype=np.float32,
                                    device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    levels = [dict(cells=mf.n_cells, n_dofs=mf.n_dofs, bricks=mm.n_bricks,
                   subset_bricks=mm.n_sub, constrained_rows=mm.n_hn)
              for mf, mm in zip(gmg.levels, gmg.mms)]
    op, mm, mf = gmg.fine_op, gmg.fine_mm, gmg.fine_mf
    print(f"2-D brick GMG setup: {setup_s:.1f} s (quadrant nref={BRICK2D_GMG_NREF} p={p} f32, "
          f"B={mm.B}, {len(levels)} levels: {levels})", flush=True)
    xs = mf.constraints.distribute(np.random.default_rng(SEED).standard_normal(mf.n_dofs))
    xs[mf.dof_handler.boundary_dofs()] = 0.0
    b = op.vmult(mm.from_dof_vector(xs.astype(np.float32)))
    solve = gmg.make_device_solver(tol=1e-5, max_iter=100)
    t0 = time.perf_counter()
    x0, it0, _ = solve(b)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (x, iters, res), counts = counted(wrappers, lambda: solve(b))
    solve_s = time.perf_counter() - t0
    counts = {k: c for k, c in counts.items() if c}
    b_norm = float(torch.sqrt(mm.dot(b, b)))
    r = b - op.vmult(x)
    true_res = float(torch.sqrt(mm.dot(r, r))) / b_norm
    print(f"2-D brick GMG-CG quadrant nref={BRICK2D_GMG_NREF} p={p} f32 on {smi}: {iters} "
          f"iterations, relative residual {res / b_norm:.3e} (recomputed b - A x: "
          f"{true_res:.3e}); solve {solve_s:.4f} s, {solve_s / max(iters, 1):.4f} s an "
          f"iteration (warm-up {warm_s:.2f} s); launches {counts}", flush=True)
    check(bool(torch.isfinite(x).all()) and iters < 100 and res / b_norm <= 1e-5,
          f"the 2-D brick GMG-CG did not converge: {iters} iterations, {res / b_norm:.3e}")
    check(it0 == iters and torch.equal(x0, x), "two 2-D brick GMG solves are not bit-identical")
    for name in ("brick_transfer", "dof_embed"):
        check(counts.get(name, 0) > 0, f"the 2-D brick GMG solve never launched {name}")
    vc, vcounts = counted(wrappers, lambda: gmg(b))
    vcounts = {k: c for k, c in vcounts.items() if c}
    check(bool(torch.isfinite(vc).all()), "the 2-D brick V-cycle gave non-finite values")
    v_prof = profile_path("2-D brick V-cycle", lambda: gmg(b), set(wrappers),
                          sum(vcounts.values()), reps=5,
                          classes={"index": 1, "dense product": 1, "reduction": 0})
    v_host = host_ms(lambda: gmg(b), reps=5, warmup=1)
    print(f"2-D brick V-cycle: port launches {vcounts}, host time to issue {v_host:.4f} ms",
          flush=True)
    print(f"2-D brick V-cycle's device time by port kernel (profile): "
          f"{v_prof['port_kernels_by_name']}", flush=True)
    finest, others, sweep = gmg_transfer_sweep(gmg, dev, "2-D ", 1e-5)
    side = gmg_side_timings(gmg, dev, "2-D ")
    parts = {}
    for name in ("brick_transfer", "dof_embed"):
        for part in finest[name]:
            part["mode"] = f"2-D {part['mode']} nref {BRICK2D_GMG_NREF - 1} -> {BRICK2D_GMG_NREF}"
        parts[name] = finest[name] + others[name]
        for part in parts[name]:
            part["launches"] = counts.get(name, 0)
            part["call"] = "2-D brick GMG-CG solve"
    numbers = dict(nref=BRICK2D_GMG_NREF, degree=p, dtype="float32", tol=1e-5, setup_s=setup_s,
                   levels=levels, iterations=iters, rel_res=res / b_norm,
                   rel_res_recomputed=true_res, solve_s=solve_s,
                   s_per_iter=solve_s / max(iters, 1), warmup_s=warm_s, launches=counts,
                   vcycle=dict(launches=vcounts, host_ms=v_host, profile=v_prof),
                   transfers=sweep, side=side, card=smi)
    del gmg, op, mm, b, x, x0, vc, r
    torch.cuda.empty_cache()

    nref, p = BRICK2D_GMG_CHECK
    t0 = time.perf_counter()
    its = {}
    for where in ("cpu", dev):
        g = mt.BrickGMGPreconditioner("quadrant", 2, nref, p, device=where)
        m, f = g.fine_mm, g.fine_mf
        xs = f.constraints.distribute(np.random.default_rng(SEED).standard_normal(f.n_dofs))
        xs[f.dof_handler.boundary_dofs()] = 0.0
        bb = g.fine_op.vmult(m.from_dof_vector(xs))
        _, its[str(where)], _ = g.make_device_solver(tol=1e-10, max_iter=100)(bb)
    print(f"2-D brick GMG-CG quadrant nref={nref} p={p} f64 tol 1e-10: {its[str(dev)]} iterations "
          f"on the card, {its['cpu']} on the CPU's plain path ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    check(its[str(dev)] == its["cpu"] < 30, "the 2-D brick GMG-CG's float64 iteration count "
                                            "differs from the CPU's plain path")
    numbers["f64_check"] = dict(nref=nref, degree=p, iterations=its[str(dev)],
                                iterations_cpu=its["cpu"])
    return numbers, parts


def elastic2d_libraries(opb, x):
    """The composed maps of the 2-D brick elasticity's cell kernels as CSR
    matrices (int32 indices) from the component bricks x [2, nb, N3p]:
    cell_elasticity's bricks mode (a dense coupled [2 n_loc, 2 n_loc] block
    a subset cell, times its geo) and hn_cell's elastic mode (the fill
    composed with each row's Q_b Kel Q_f a component pair). Returns
    ({kernel: call}, {kernel: nonzeros})."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.cell_apply import cell_nodes
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.cell_elasticity import elastic_rows

    mm, dev, dt = opb.mm, x.device, x.dtype
    d, n = opb.dim, mm.n_loc
    ar = lambda k: torch.arange(k, device=dev)
    # Kel[c, i, k, j]: component c node i of the coupled operator on unit input (k, j), geo 1
    eye = torch.eye(d * n, dtype=torch.float64, device=dev).reshape(d * n, d, n).transpose(0, 1)
    Kel = elastic_rows(eye.contiguous(), opb.S.double(), opb.Dc.double(), opb.quad_w.double(),
                       torch.ones((d * n, d), dtype=torch.float64, device=dev), opb.mu,
                       opb.lam)  # [c, (k j), i]
    Kel = Kel.permute(0, 2, 1).reshape(d, n, d, n)
    R, cs = mm.n_sub * mm.C, x.shape[1] * x.shape[2]
    nodes = cell_nodes(ar(R), mm.B, mm.p, mm.N3p, dev)  # [R, n]
    rows = (ar(d)[:, None, None] * R * n + ar(R)[None, :, None] * n + ar(n)).reshape(-1)
    cols = (ar(d)[:, None, None] * cs + nodes[None]).permute(1, 0, 2).reshape(R, d * n)
    vals = Kel.reshape(d, n, d * n)[:, None] * mm.geo_cell_sub.double()[None, :, None, None]
    ce = torch.sparse_csr_tensor((ar(d * R * n + 1) * (d * n)).to(torch.int32),
                                 cols[None, :, None, :].expand(d, R, n, d * n).reshape(-1)
                                 .to(torch.int32), vals.reshape(-1).to(dt), (d * R * n, d * cs))
    # hn_cell's elastic mode: block (c, k) maps component k's subset nodes to component c's rows
    fill_rows, fill_cols = fill_entries(mm)
    Qf, Qb = (hn_dense(mm, d_, dt).double() for d_ in ("fwd", "bwd"))
    q = mm.hn_q.long()
    qq = torch.where(q >= 0, q, Qf.shape[0] - 1)
    n_sub_vals = mm.n_sub * mm.N3p
    blocks_r, blocks_c, blocks_v = [], [], []
    for c in range(d):
        for k in range(d):
            maps = (Qb[qq] @ Kel[c, :, k, :] @ Qf[qq]).to(dt)
            M = hn_map(mm, maps, ar(mm.n_hn), fill_rows, fill_cols, n_sub_vals,
                       scale=mm.geo_hn.to(dt)).to_sparse_coo().coalesce()
            r_, c_ = M.indices()
            blocks_r.append(r_ + c * mm.n_hn * n)
            blocks_c.append(c_ + k * cs)
            blocks_v.append(M.values())
    hn = sparse_csr(torch.cat(blocks_r), torch.cat(blocks_c), torch.cat(blocks_v),
                    (d * mm.n_hn * n, d * cs))
    xf = x.reshape(-1)
    torch.cuda.synchronize()
    return ({"cell_elasticity": lambda: ce @ xf, "hn_cell": lambda: hn @ xf},
            {"cell_elasticity[bricks]": ce._nnz(), "hn_cell[elastic]": hn._nnz()})


def brick2d_elasticity(mt, mf, op2, index_ms, dev, wrappers, smi):
    """The 2-D brick elasticity (mu = lam = 1) at quadrant nref=INDEX2D_NREF
    p=4 f32 on phase 15's p=4 operator op2 (and a float64 one on the same
    MatrixFree mf): ``elastic_config`` without the index engine, which
    phase 14 measured (the brick vmult, 5 launches, and vmult_plain, 4;
    against the plain float64 path, 1e-5, bit-identical, timed, GDoF/s
    over 2 n_dofs, profiles, the HN overhead); the brick vmult over phase
    14's index elasticity (index_ms); every 2-D instance on the brick path
    (cell_elasticity's bricks mode, hn_cell's elastic mode, corr_compact and
    dss_surface on their component axis at k = 2, brick_elasticity) against
    its plain version (1e-5), timed with its bound and library call (the
    composed maps as CSR, the component-axis maps over two columns, the
    dense el_A by torch.mm); float64 against the dense oracle at
    BRICK2D_ELASTIC_ORACLE (1e-12, mu=1.3, lam=0.7). Returns (numbers,
    {kernel: [part]})."""
    t0 = time.perf_counter()
    opb = mt.BrickElasticity.on_operator(op2, ELASTIC_MU, ELASTIC_LAM)
    op64 = mt.BrickLaplaceMM(mf, device=dev, dtype=torch.float64)
    opb64 = mt.BrickElasticity.on_operator(op64, ELASTIC_MU, ELASTIC_LAM)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(opb.dim == 2, "the 2-D brick elasticity is not 2-D")
    res, x, xi = elastic_config(mt, "2-D", mf, opb, opb64, dev, wrappers, smi, index=False)
    ratio = res["vmult"]["ms"] / index_ms
    print(f"2-D brick elasticity on {smi}: vmult {res['vmult']['ms']:.4f} ms over phase 14's "
          f"index elasticity {index_ms:.4f} ms: {ratio:.4f}", flush=True)
    calls, libs, nnz = elastic_kernel_calls(opb, mf, x, xi)
    libs_el, nnz_el = elastic2d_libraries(opb, x)
    nnz.update(nnz_el)
    print(f"2-D elastic library matrices, nonzeros: {nnz}; brick_elasticity's library call is one "
          f"torch.mm by the dense el_A [{2 * opb.mm.N3}, {2 * opb.mm.N3}]", flush=True)
    keep = {"cell_elasticity": "bricks", "hn_cell": "elastic", "corr_compact": "components",
            "brick_elasticity": "fused", "dss_surface": "components"}
    parts = {}
    for name, mode in keep.items():
        i = next(k for k, c in enumerate(calls[name]) if c[0] == mode)
        lib = libs_el.get(name, libs[name][i])
        parts[name] = measure_parts(name, [calls[name][i]], [lib], {}, torch.float32, 1e-5)
        for part in parts[name]:
            part["mode"] = f"2-D {part['mode']}"
            part["launches"] = res["vmult"]["launches"].get(name, 0)
            part["call"] = "2-D elastic vmult"
    del calls, libs, libs_el
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    oracle = elastic_oracle_checks(mt, dev, dim=2, cases=BRICK2D_ELASTIC_ORACLE)
    numbers = dict(res, nref=INDEX2D_NREF, degree=op2.p, dtype="float32", n_dofs=mf.n_dofs,
                   component_dofs=2 * mf.n_dofs, setup_s=setup_s, index_elasticity_ms=index_ms,
                   brick_over_index=ratio, library_nnz=nnz, oracle_max_rel_err=oracle,
                   oracle_s=time.perf_counter() - t0, card=smi)
    del opb, opb64, op64, x, xi
    torch.cuda.empty_cache()
    return numbers, parts


def brick2d_paths_phase(mt, mf2, mf2_d, op2, index2d, dev, wrappers, smi):
    """Phase 16, the rest of 2-D on the brick engine: the deformed mapping
    (``brick2d_deformed``), the brick GMG-CG (``brick2d_gmg``) and brick
    elasticity (``brick2d_elasticity``), each timed. Returns (numbers,
    {kernel: [part]})."""
    numbers, parts = {}, {}
    for key, run in (
            ("deformed", lambda: brick2d_deformed(mt, mf2_d, index2d["vmult deformed"]["ms"], dev,
                                                  wrappers, smi)),
            ("gmg", lambda: brick2d_gmg(mt, dev, wrappers, smi)),
            ("elasticity", lambda: brick2d_elasticity(mt, mf2, op2, index2d["elasticity"]["ms"],
                                                      dev, wrappers, smi))):
        t0 = time.perf_counter()
        numbers[key], pparts = run()
        numbers[key]["phase_s"] = time.perf_counter() - t0
        print(f"2-D brick {key}: {numbers[key]['phase_s']:.1f} s", flush=True)
        for name, plist in pparts.items():
            parts.setdefault(name, []).extend(plist)
        torch.cuda.empty_cache()
    return numbers, parts


# ---- the distributed engines (phase 17) ------------------------------------------------
# one NCCL rank on the card at phase 3's mesh (quadrant nref=7 p=4 f32); the deformed brick
# engine at DIST_DEFORMED_NREF; float64 at DIST_F64_NREF against the oracle; the GMG-CG at
# DIST_GMG_CHECK in float64 (the CPU plain path's iterations) and at DIST_GMG_F32; the new
# kernels held on every rank's tables of the DIST_CHECK_RANKS-rank plans at DIST_CHECK_NREF;
# DIST_GLOO_RANKS gloo ranks on the one card, if gloo takes CUDA tensors in every collective
DIST_DEFORMED_NREF, DIST_F64_NREF, DIST_CHECK_NREF, DIST_CHECK_RANKS = 6, 4, 5, 4
DIST_GMG_CHECK, DIST_GMG_F32 = (3, 2), (5, 4)  # (quadrant nref, degree)
DIST_GMG_F32_TOL = 1e-4
DIST_GLOO_RANKS, DIST_GLOO_NREF, DIST_GLOO_TIMEOUT = 2, 4, 240
DIST_NEW = ("halo_pack", "dss_pools", "chain_halo")
DIST_BRICK_COMMON = {"cell_apply": 1, "hn_interp": 2, "chain_halo": 2, "corr_compact": 1,
                     "dss_pools": 2, "refill_update": 1}
DIST_LAUNCHES = {
    "index allgather": {"cell_laplace": 1, "dof_scatter": 1},
    "index halo": {"halo_pack": 2, "cell_laplace": 1, "dof_scatter": 1},
    "brick halo": {**DIST_BRICK_COMMON, "halo_pack": 7, "brick_apply": 1},
    "brick replicated": {**DIST_BRICK_COMMON, "halo_pack": 2, "brick_apply": 1},
    "deformed halo": {**DIST_BRICK_COMMON, "halo_pack": 7, "brick_deformed": 1},
}  # one rank: halo_pack's add has no destination there and launches nothing
DIST_MAIN = "brick halo"  # the path whose launches the new kernels report


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_run(what, op, x, ref_fn, wrappers, smi, single_ms, n_dofs, tol):
    """One distributed vmult (one rank): its launches by kernel (counted from
    0 around one call; DIST_LAUNCHES), against the single-device engine
    (ref_fn(y) -> (got, ref) as DoF vectors), two calls bit-identical, timed
    as phase 5 times its vmult, the host's time to issue it (``host_ms``),
    profiled (the port's kernels and the backend's collectives, nothing
    else)."""
    y, counts = counted(wrappers, lambda: op.vmult(x))
    counts = {k: n for k, n in counts.items() if n}
    check(counts == DIST_LAUNCHES[what], f"the {what} vmult launched {counts}, not "
                                         f"{DIST_LAUNCHES[what]}")
    got, ref = ref_fn(y)
    check(bool(torch.isfinite(y).all()), f"the {what} vmult gave non-finite values")
    err = errors(torch.as_tensor(got), torch.as_tensor(ref))[1]
    check(err <= tol, f"the {what} vmult disagrees with the single-device engine: {err:.3e}")
    same = bool(torch.equal(op.vmult(x), y))
    check(same, f"two {what} vmults differ")
    ms = time_ms(lambda: op.vmult(x), reps=30, warmup=5)
    issue_ms = host_ms(lambda: op.vmult(x))
    prof = profile_path(f"distributed {what} vmult", lambda: op.vmult(x), set(wrappers),
                        sum(DIST_LAUNCHES[what].values()), collectives=True)
    res = dict(ms=ms, gdofs_per_s=n_dofs / ms / 1e6, over_single_device=ms / single_ms,
               single_device_ms=single_ms, host_ms=issue_ms, launches=counts, max_rel_err=err,
               bit_identical=same, profile=prof, card=smi)
    print(f"distributed {what} vmult on {smi}: {ms:.4f} ms ({res['gdofs_per_s']:.4f} GDoF/s), "
          f"{res['over_single_device']:.4f} x the single-device vmult ({single_ms:.4f} ms), "
          f"issued in {issue_ms:.4f} ms; rel err {err:.3e} (tol {tol:g}); launches {counts}",
          flush=True)
    return res, y


def csr_call(ptr, src, w, n_cols, x):
    """A CSR product's library call: (call, matrix) for rows (ptr, src, w)."""
    A = torch.sparse_csr_tensor(ptr.long(), src.long(), w, (ptr.numel() - 1, n_cols))
    return lambda: (A @ x.reshape(-1, 1)).reshape(-1)


def one_hot_csr(idx, valid, n_cols):
    """The pack as a CSR matrix: row i has valid[i] at column idx[i] (none where
    valid is 0)."""
    sel = (valid.reshape(-1) != 0)
    counts = sel.long()
    ptr = torch.zeros(counts.numel() + 1, dtype=torch.long, device=idx.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return torch.sparse_csr_tensor(ptr, idx.reshape(-1)[sel].long(), valid.reshape(-1)[sel],
                                   (counts.numel(), n_cols))


def dss_matrix_csr(op, dev, dt):
    """dss_pools' whole map (accumulate, then read) on the slab as one CSR
    matrix: a valid surface node sums its pool's copies, a valid interior
    node keeps its value, an invalid node is 0."""
    import scipy.sparse as sps

    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels.dss_pools import valid_mask

    surf_node, ent_off, pool_off, pool_ptr, pool_src, n_slots = (
        t.cpu().numpy() if torch.is_tensor(t) else t for t in op.dss_acc)
    node_ent, read_base, valid_bits = (t.cpu().numpy() for t in op.dss_read)
    nb, N3p = op.nb_max, op.N3p
    sizes = np.diff(pool_off)
    slot_pool = np.repeat(np.arange(len(sizes)), sizes)
    j = np.arange(n_slots) - pool_off[slot_pool]
    cnt = np.diff(pool_ptr)[slot_pool]
    rows = np.repeat(np.arange(n_slots), cnt)
    first = np.repeat(pool_ptr[slot_pool], cnt)
    e = first + np.arange(len(rows)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    c = pool_src[e].astype(np.int64)
    cols = (c >> 5) * N3p + surf_node[ent_off[c & 31] + j[rows]]
    ones = lambda r, c, shape: sps.csr_matrix((np.ones(len(r)), (r, c)), shape=shape)
    acc = ones(rows, cols, (n_slots, nb * N3p))
    valid = valid_mask(torch.from_numpy(valid_bits), N3p).numpy()
    b, node = np.nonzero(valid)
    code = node_ent[node]
    surf = code >= 0
    rd = read_base[b[surf], code[surf] >> 16] + (code[surf] & 0xFFFF)
    read = ones(np.nonzero(surf)[0], rd, (len(b), n_slots))
    keep = ones(np.nonzero(~surf)[0], (b * N3p + node)[~surf], (len(b), nb * N3p))
    M = (read @ acc + keep).tocoo()
    out_rows = (b * N3p + node)[M.row]
    return sparse_csr(torch.from_numpy(out_rows).to(dev), torch.from_numpy(M.col).to(dev),
                      torch.from_numpy(M.data).to(dev, dt), (nb * N3p, nb * N3p))


def add_library(tgt, rv, dst, ptr, srcs, w):
    """halo_pack's add as one library call: torch.addmm of the runs as a CSR
    matrix [tgt, recv] onto the target."""
    counts = torch.zeros(tgt.numel(), dtype=torch.long, device=tgt.device).index_add_(
        0, dst.long(), (ptr[1:] - ptr[:-1]).long())
    crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    A = torch.sparse_csr_tensor(crow, srcs.long(), w, (tgt.numel(), rv.numel()))
    return lambda: torch.addmm(tgt.reshape(-1, 1), A, rv.reshape(-1, 1)).reshape(-1)


def dist_kernel_parts(op, x, iop, ix, adds):
    """The new kernels' launches at the shapes the one-rank brick halo vmult
    gives them (op on slab x), each (mode, kernel, plain, (bytes, flops),
    fresh, reset) with its library call and whether the kernel's totals count
    it: halo_pack's 7 (pack: one-hot CSR products; set: none), dss_pools'
    accumulate and read in one part on a scratch copy (the DSS map composed
    into one CSR), chain_halo's fold and fill (the composed chain as CSR);
    beside them, not in the totals, the index halo's pack and set (iop on
    block ix) and the add mode on `adds`, [(label, target, recv, runs)] of
    the 4-rank plans (one rank has no add: nothing to add there)."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        brick_apply, cell_apply, chain_halo, dss_pools, halo_pack)

    dt, dev = x.dtype, x.device
    plain = cell_apply.cell_apply(x[: op.n_sub], *op.factors_host, op.geo_cell_sub, op.B)
    u = brick_apply.brick_apply(x, *op.brick_factors_host, op.geo, op.p)
    v = op.vmult(x)
    pools = dss_pools.dss_pools(v, *op.dss_acc, mode="accumulate")
    parts, libs, main = ({n: [] for n in DIST_NEW} for _ in range(3))

    def part(name, mode, kern, plain_fn, bf, lib, fresh=None, reset=None, in_main=True):
        parts[name].append((mode, kern, plain_fn, bf, fresh, reset))
        libs[name].append(lib)
        main[name].append(in_main)

    hp, hpp = halo_pack.halo_pack, halo_pack.halo_pack_plain
    block = hp(plain, *op.block, mode="pack")
    block2 = hp(v, *op.fill_block, mode="pack")

    def pack(mode, src, tabs, in_main=True):
        A = one_hot_csr(tabs[0], tabs[1], src.numel())
        part("halo_pack", mode, lambda: hp(src, *tabs, mode="pack"),
             lambda: hpp(src, *tabs, mode="pack"),
             halo_pack.bytes_and_flops(src, *tabs, mode="pack"),
             lambda: (A @ src.reshape(-1, 1)).reshape(-1), in_main=in_main)

    def setp(mode, own, tabs, in_main=True):
        recv = hp(own, *tabs[:2], mode="pack")
        part("halo_pack", mode, lambda: hp(own, recv, tabs[2], mode="set"),
             lambda: hpp(own, recv, tabs[2], mode="set"),
             halo_pack.bytes_and_flops(own, recv, tabs[2], mode="set"), None, in_main=in_main)

    pack("pack chain block", plain, op.block)
    pack("pack fold send", block, op.xch["fold"][:2])
    setp("set fold buffer", block, op.xch["fold"])
    pack("pack dss send", pools, op.dss_send)
    pack("pack fill block", v, op.fill_block)
    pack("pack fill send", block2, op.xch["fill"][:2])
    setp("set fill buffer", block2, op.xch["fill"])
    pack("index: pack send", ix, (iop.send_idx, iop.send_valid), in_main=False)
    setp("index: set [own | ghosts]", ix, (iop.send_idx, iop.send_valid, iop.set_map),
         in_main=False)
    for label, tgt, rv, runs in adds:
        scratch = tgt.clone()
        part("halo_pack", label, lambda s=scratch, r=rv, t=runs: hp(s, r, *t, mode="add"),
             lambda s=tgt, r=rv, t=runs: hpp(s.clone(), r, *t, mode="add"),
             halo_pack.bytes_and_flops(tgt, rv, *runs, mode="add"), add_library(tgt, rv, *runs),
             fresh=lambda s=tgt, r=rv, t=runs: (hp(s.clone(), r, *t, mode="add"),
                                                  hpp(s.clone(), r, *t, mode="add")),
             reset=lambda s=scratch, t=tgt: s.copy_(t), in_main=False)
    # dss_pools: accumulate then read, on a scratch copy of the brick_apply output
    scratch = u.clone()
    both = lambda s: dss_pools.dss_pools(s, dss_pools.dss_pools(s, *op.dss_acc,
                                                                mode="accumulate"),
                                         *op.dss_read, mode="read")
    both_plain = lambda s: dss_pools.dss_pools_plain(
        s, dss_pools.dss_pools_plain(s, *op.dss_acc, mode="accumulate"), *op.dss_read,
        mode="read")
    ba, fa = dss_pools.bytes_and_flops(u, *op.dss_acc, mode="accumulate")
    br, fr = dss_pools.bytes_and_flops(u, pools, *op.dss_read, mode="read")
    M = dss_matrix_csr(op, dev, dt)
    part("dss_pools", "accumulate + read", lambda: both(scratch), lambda: both_plain(u.clone()),
         (ba + br, fa + fr), lambda: (M @ u.reshape(-1, 1)).reshape(op.nb_max, op.N3p),
         fresh=lambda: (both(u.clone()), both_plain(u.clone())),
         reset=lambda: scratch.copy_(u))
    for mode, m_, b in (("fold", op.fold_map, op._exchange(block, "fold")),
                        ("fill", op.fill_map, op._exchange(block2, "fill"))):
        part("chain_halo", mode, lambda b=b, m_=m_: chain_halo.chain_halo(b, *m_),
             lambda b=b, m_=m_: chain_halo.chain_halo_plain(b, *m_),
             chain_halo.bytes_and_flops(b, *m_), csr_call(*m_, b.numel(), b))
    return parts, libs, main


def dist_plan_checks(mt, dev):
    """The new kernels against their plain versions on every rank's tables
    of the DIST_CHECK_RANKS-rank plans (brick engine, both exchanges; index
    engine, the halo) at quadrant nref=DIST_CHECK_NREF p=4, float32 (1e-5)
    and float64 (1e-12); returns (the number of calls held, the add mode's
    timed parts: [(label, target, recv, runs)] of the ranks with the most
    entries, float32)."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import chain_halo, dss_pools, halo_pack
    from dealii_matrixfree_hanging_nodes_tpu_torch.parallel import (DistributedBrickPlan,
                                                                    DistributedLaplacePlan)

    mf = mt.MatrixFree(mt.create_quadrant(3, DIST_CHECK_NREF), 4)
    R = DIST_CHECK_RANKS
    plans = [DistributedBrickPlan(mf, R, exchange=ex) for ex in ("halo", "replicated")]
    iplan = DistributedLaplacePlan(mf, R, exchange="halo")
    n = 0
    for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        g = torch.Generator(device=dev).manual_seed(SEED)
        rand = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=dt)
        on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            dev, dt if np.asarray(a).dtype.kind == "f" else torch.int32)
        calls = {n_: [] for n_ in DIST_NEW}

        def hold(name, mode, kern, plain):
            calls[name].append((mode, kern, plain, None, None, None))

        for plan in plans:
            n_loc = (plan.bs.p + 1) ** 3
            for r in range(R):
                t = plan.rank_tables(r)
                tag = f"{plan.exchange} rank {r}"
                v = rand(plan.nb_max, plan.const["N3p"])
                d = t["dss"]
                acc = (*(on(d[k]) for k in ("surf_node", "ent_off", "pool_off", "pool_ptr",
                                            "pool_src")), d["n_slots"])
                pools = dss_pools.dss_pools(v, *acc, mode="accumulate")
                read = (pools, on(d["node_ent"]), on(d["read_base"]), on(t["valid_bits"]))
                hold("dss_pools", f"accumulate {tag}",
                     lambda v=v, a=acc: dss_pools.dss_pools(v, *a, mode="accumulate"),
                     lambda v=v, a=acc: dss_pools.dss_pools_plain(v, *a, mode="accumulate"))
                hold("dss_pools", f"read {tag}",
                     lambda v=v, rd=read: dss_pools.dss_pools(v.clone(), *rd, mode="read"),
                     lambda v=v, rd=read: dss_pools.dss_pools_plain(v.clone(), *rd, mode="read"))
                if not plan.has_chain:
                    continue
                for key in ("fold_map", "fill_map"):
                    m = tuple(on(a) for a in t[key])
                    xb = rand(m[0].numel() - 1)
                    hold("chain_halo", f"{key} {tag}",
                         lambda xb=xb, m=m: chain_halo.chain_halo(xb, *m),
                         lambda xb=xb, m=m: chain_halo.chain_halo_plain(xb, *m))
                blk = (on(t["fill_idx"]), on(t["block_valid"]))
                hold("halo_pack", f"pack fill block {tag}",
                     lambda v=v, b=blk: halo_pack.halo_pack(v, *b, mode="pack"),
                     lambda v=v, b=blk: halo_pack.halo_pack_plain(v, *b, mode="pack"))
                if plan.exchange != "halo":
                    continue
                block = rand(plan.n_chain_max, n_loc)
                for tg in ("fold", "fill"):
                    x_ = t[tg]
                    snd = (on(x_["send_idx"]), on(x_["send_valid"]))
                    recv = rand(*x_["send_idx"].shape)
                    sm = on(x_["set_map"])
                    hold("halo_pack", f"pack {tg} send {tag}",
                         lambda b=block, s=snd: halo_pack.halo_pack(b, *s, mode="pack"),
                         lambda b=block, s=snd: halo_pack.halo_pack_plain(b, *s, mode="pack"))
                    hold("halo_pack", f"set {tg} {tag}",
                         lambda b=block, r_=recv, s=sm: halo_pack.halo_pack(b, r_, s, mode="set"),
                         lambda b=block, r_=recv, s=sm: halo_pack.halo_pack_plain(b, r_, s,
                                                                                 mode="set"))
                add = tuple(on(a) for a in t["dss_add"])
                recv = rand(*t["dss_send"][0].shape)
                hold("halo_pack", f"add dss {tag}",
                     lambda p=pools, r_=recv, a=add: halo_pack.halo_pack(p.clone(), r_, *a,
                                                                       mode="add"),
                     lambda p=pools, r_=recv, a=add: halo_pack.halo_pack_plain(p.clone(), r_, *a,
                                                                             mode="add"))
        for r in range(R):
            t = iplan.rank_tables(r)
            src = rand(iplan.n_own_max)
            recv = rand(R, iplan.halo_max_pair)
            add = tuple(on(a) for a in t["add"])
            hold("halo_pack", f"add index owners rank {r}",
                 lambda s=src, r_=recv, a=add: halo_pack.halo_pack(s.clone(), r_, *a, mode="add"),
                 lambda s=src, r_=recv, a=add: halo_pack.halo_pack_plain(s.clone(), r_, *a,
                                                                       mode="add"))
        check_kernels(calls, tol, f"the new kernels on every rank's tables of the {R}-rank "
                                  f"plans at quadrant nref={DIST_CHECK_NREF} p=4 {dt}")
        n += sum(len(c) for c in calls.values())
    # the add mode's timed parts (float32): the rank with the most entries of each list
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        dev, torch.float32 if np.asarray(a).dtype.kind == "f" else torch.int32)
    g = torch.Generator(device=dev).manual_seed(SEED)
    rand = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=torch.float32)
    tabs = [plans[0].rank_tables(r) for r in range(R)]
    r = max(range(R), key=lambda k: len(tabs[k]["dss_add"][2]))
    adds = [(f"add dss pools ({R} ranks, nref={DIST_CHECK_NREF}, rank {r})",
             rand(tabs[r]["dss"]["n_slots"]), rand(*tabs[r]["dss_send"][0].shape),
             tuple(on(a) for a in tabs[r]["dss_add"]))]
    itabs = [iplan.rank_tables(k) for k in range(R)]
    r = max(range(R), key=lambda k: len(itabs[k]["add"][2]))
    adds.append((f"add index owners ({R} ranks, nref={DIST_CHECK_NREF}, rank {r})",
                 rand(iplan.n_own_max), rand(R, iplan.halo_max_pair),
                 tuple(on(a) for a in itabs[r]["add"])))
    return n, adds


def dist_gloo_worker(rank, n_ranks, init_file, out_file):
    """One of DIST_GLOO_RANKS gloo ranks on the one card: which collectives
    gloo takes on CUDA tensors; where it takes all that the engines use,
    both engines' exchanges at quadrant nref=DIST_GLOO_NREF p=4 float64
    against the single-device engines (1e-12)."""
    import torch.distributed as dist

    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch import parallel

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=n_ranks)
    res = {"ops": {}}
    try:
        x = torch.arange(4, dtype=torch.float64, device=dev)
        probes = {"all_gather": lambda: dist.all_gather_into_tensor(
                      torch.empty(4 * n_ranks, dtype=x.dtype, device=dev), x),
                  "reduce_scatter": lambda: dist.reduce_scatter_tensor(
                      torch.empty(4, dtype=x.dtype, device=dev), x.repeat(n_ranks)),
                  "all_to_all": lambda: dist.all_to_all_single(
                      torch.empty(2 * n_ranks, dtype=x.dtype, device=dev),
                      torch.ones(2 * n_ranks, dtype=x.dtype, device=dev)),
                  "all_reduce": lambda: dist.all_reduce(x.clone())}
        for name, fn in probes.items():
            try:
                fn()
                torch.cuda.synchronize()
                res["ops"][name] = "ok"
            except (RuntimeError, ValueError, NotImplementedError) as e:  # gloo's refusal
                res["ops"][name] = f"refused: {str(e).splitlines()[0][:160]}"
        if all(v == "ok" for v in res["ops"].values()):
            mf = mt.MatrixFree(mt.create_quadrant(3, DIST_GLOO_NREF), 4)
            u = np.random.default_rng(SEED).standard_normal(mf.n_dofs)
            ref_i = mt.LaplaceOperator(mf, device=dev).vmult(u).cpu().numpy()
            mm = mt.BrickLaplaceMM(mf, device=dev)
            ref_b = mm.to_dof_vector(mm.vmult(mm.from_dof_vector(u)),
                                     zero_hanging=True).cpu().numpy()
            for ex in ("allgather", "halo"):
                op = parallel.DistributedLaplace(mf, exchange=ex, device=dev)
                got = op.gather_vector(op.vmult(op.scatter_vector(u)))
                res[f"index {ex}"] = float(np.abs(got - ref_i).max() / np.abs(ref_i).max())
            for ex in ("halo", "replicated"):
                op = parallel.DistributedBrickLaplace(mf, exchange=ex, device=dev)
                got = op.to_dof_vector(op.vmult(op.from_dof_vector(u)), zero_hanging=True)
                res[f"brick {ex}"] = float(np.abs(got - ref_b).max() / np.abs(ref_b).max())
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_file, "w") as fh:
            json.dump(res, fh)


def dist_gloo_phase(tmp):
    """DIST_GLOO_RANKS spawned gloo ranks on the one card
    (``dist_gloo_worker``); fails where a run that gloo allowed disagrees.
    Returns the worker's record."""
    import torch.multiprocessing as mp

    init_file, out_file = f"{tmp}/gloo-init", f"{tmp}/gloo.json"
    t0 = time.perf_counter()
    ctx = mp.start_processes(dist_gloo_worker, args=(DIST_GLOO_RANKS, init_file, out_file),
                             nprocs=DIST_GLOO_RANKS, join=False, start_method="spawn")
    deadline = time.perf_counter() + DIST_GLOO_TIMEOUT
    while not ctx.join(timeout=1):
        if time.perf_counter() > deadline:
            for p in ctx.processes:
                p.kill()
            raise RuntimeError(f"chip_smoke: the gloo ranks did not finish in "
                               f"{DIST_GLOO_TIMEOUT} s")
    with open(out_file) as fh:
        res = json.load(fh)
    res["seconds"] = time.perf_counter() - t0
    for key, err in res.items():
        if key.startswith(("index", "brick")):
            check(err <= 1e-12, f"{DIST_GLOO_RANKS} gloo ranks on the card: the {key} vmult "
                                f"disagrees with the single-device engine: {err:.3e}")
    print(f"{DIST_GLOO_RANKS} gloo ranks on the one card: {json.dumps(res)}", flush=True)
    return res


def dist_transfer(mt, g, dev, wrappers, smi):
    """The distributed GMG's finest transfer (float32): prolongate and
    restrict against the single-device Transfer on the card (1e-5), their
    launches by kernel, their times, and each kernel of theirs alone at
    these shapes against its plain version, with its bound."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (cell_laplace, cell_transfer,
                                                                   dof_scatter)

    tr, opc, opf = g.transfers[-1], g.ops[-2], g.ops[-1]
    mfc, mff = g.levels[-2], g.levels[-1]
    rng = np.random.default_rng(SEED)
    uc, uf = rng.standard_normal(mfc.n_dofs), rng.standard_normal(mff.n_dofs)
    xc, xf = opc.scatter_vector(uc), opf.scatter_vector(uf)
    single = mt.Transfer(mfc, mff, device=dev)
    refs = {"prolongate": single.prolongate(torch.from_numpy(uc).to(dev, torch.float32)),
            "restrict": single.restrict(torch.from_numpy(uf).to(dev, torch.float32))}
    fns = {"prolongate": lambda: tr.prolongate(xc), "restrict": lambda: tr.restrict(xf)}
    res = {}
    for mode, fn in fns.items():
        y, counts = counted(wrappers, fn)
        got = (opf if mode == "prolongate" else opc).gather_vector(y)
        err = errors(torch.from_numpy(got), refs[mode].cpu().double())[1]
        check(err <= 1e-5, f"the distributed {mode} disagrees with the single-device one: "
                           f"{err:.3e}")
        res[mode] = dict(ms=time_ms(fn, reps=20, warmup=3), max_rel_err=err,
                         launches={k: n for k, n in counts.items() if n})
    # each kernel alone, at the shapes these calls give it
    full_c = xc  # one rank: the gathered coarse vector is its block
    rows = cell_laplace.cell_laplace(full_c, tr.covmap, tr.cov_masks, tr.P, None, None, None,
                                     None, quad=False, hn_in=True, hn_out=False)
    vals = cell_transfer.cell_transfer(rows, tr.E, tr.cdf_local, tr.own, tr.ident, tr.ident_ptr,
                                       tr.ident, tr.n_owned, tr.blocks, mode="prolongate")
    rrows = cell_transfer.cell_transfer(xf, tr.E, tr.cdf, tr.own, tr.ident, tr.ident_ptr,
                                        tr.ident, tr.n_padded_f, tr.blocks, mode="restrict")
    calls = {
        "prolongate: cell_laplace (read, HN)": (cell_laplace, (full_c, tr.covmap, tr.cov_masks,
            tr.P, None, None, None, None), dict(quad=False, hn_in=True, hn_out=False)),
        "prolongate: cell_transfer": (cell_transfer, (rows, tr.E, tr.cdf_local, tr.own, tr.ident,
            tr.ident_ptr, tr.ident, tr.n_owned, tr.blocks), dict(mode="prolongate")),
        "prolongate: dof_scatter": (dof_scatter, (vals.view(-1, 1), *tr.prolong_map), {}),
        "restrict: cell_transfer": (cell_transfer, (xf, tr.E, tr.cdf, tr.own, tr.ident,
            tr.ident_ptr, tr.ident, tr.n_padded_f, tr.blocks), dict(mode="restrict")),
        "restrict: cell_laplace (HN^T)": (cell_laplace, (rrows, None, tr.cov_masks, tr.P, None,
            None, None, None), dict(quad=False, hn_in=False, hn_out=True)),
        "restrict: dof_scatter": (dof_scatter, (rrows, *tr.restrict_map), {}),
    }
    # library calls at these shapes: cell_transfer's maps as CSR products, dof_scatter's
    # index_add_ (none for cell_laplace, as in phase 7)
    P_pro = cell_transfer_maps(tr.E, tr.cdf_local, tr.own, tr.ident, tr.n_owned,
                               rows.shape[0])[0]
    R_res = cell_transfer_maps(tr.E, tr.cdf, tr.own, tr.ident, tr.n_padded_f,
                               rrows.shape[0])[1]
    libs = {"prolongate: cell_transfer": lambda: P_pro @ rows.reshape(-1),
            "prolongate: dof_scatter": scatter_library(vals.view(-1, 1), *tr.prolong_map[:2]),
            "restrict: cell_transfer": lambda: R_res @ xf,
            "restrict: dof_scatter": scatter_library(rrows, *tr.restrict_map[:2])}
    res["kernels"] = {}
    for what, (mod, args, kw) in calls.items():
        kern = lambda m=mod, a=args, k=kw: getattr(m, m.NAME)(*a, **k)
        plain = lambda m=mod, a=args, k=kw: getattr(m, f"{m.NAME}_plain")(*a, **k)
        ref = plain()
        err = errors(kern(), ref)[1]
        check(err <= 1e-5, f"{what} disagrees with its plain version: {err:.3e}")
        b_ms, b_by = bound(*mod.bytes_and_flops(*args, **kw), torch.float32)
        lib = libs.get(what)
        if lib is not None:
            lib_err = errors(lib().reshape(-1), ref.reshape(-1))[1]
            check(lib_err <= LIBRARY_TOL, f"{what}'s library call disagrees with its plain "
                                          f"version: {lib_err:.3e}")
        res["kernels"][what] = dict(ms=time_ms(kern, device_only=True),
                                    plain_ms=time_ms(plain, device_only=True), bound_ms=b_ms,
                                    bound_by=b_by, max_rel_err=err,
                                    library_ms=None if lib is None else time_ms(
                                        lib, device_only=True))
    print(f"distributed transfer, quadrant nref {DIST_GMG_F32[0] - 1} -> {DIST_GMG_F32[0]} "
          f"p={DIST_GMG_F32[1]} f32, on {smi}: {json.dumps(res)}", flush=True)
    return res


def dist_gmg(mt, dev, wrappers, smi):
    """The distributed GMG-CG on one NCCL rank: at DIST_GMG_CHECK in float64
    (tol 1e-10) against the same solve on the CPU's plain path (the gloo half
    of the group): the same iterations; at DIST_GMG_F32 in float32: setup,
    iterations, time, its residual; its finest transfer (``dist_transfer``)."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.parallel import DistributedGMGPreconditioner

    out = {}
    nref, p = DIST_GMG_CHECK
    runs = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        g = DistributedGMGPreconditioner("quadrant", 3, nref, p, device=device)
        op, mf = g.fine_op, g.fine_mf
        xs = mf.constraints.distribute(np.random.default_rng(SEED).standard_normal(mf.n_dofs))
        xs[mf.dof_handler.boundary_dofs()] = 0.0
        b = op.vmult(op.scatter_vector(xs))
        x, it, res = mt.solve_cg(op, b, M=g, tol=1e-10, max_iter=100, dot=op.dot)
        runs[name] = (it, op.gather_vector(x))
    err = float(np.abs(runs["card"][1] - runs["cpu"][1]).max() / np.abs(runs["cpu"][1]).max())
    check(runs["card"][0] == runs["cpu"][0], f"the distributed GMG-CG took {runs['card'][0]} "
                                             f"iterations on the card, {runs['cpu'][0]} on the "
                                             f"CPU's plain path")
    check(err <= 1e-8, f"the distributed GMG-CG's solutions differ: {err:.3e}")
    out["f64_check"] = dict(nref=nref, p=p, iterations=runs["card"][0],
                            cpu_iterations=runs["cpu"][0], solution_rel_diff=err)
    nref, p = DIST_GMG_F32
    t0 = time.perf_counter()
    g = DistributedGMGPreconditioner("quadrant", 3, nref, p, device=dev, dtype=np.float32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    op, mf = g.fine_op, g.fine_mf
    xs = mf.constraints.distribute(np.random.default_rng(SEED).standard_normal(mf.n_dofs))
    xs[mf.dof_handler.boundary_dofs()] = 0.0
    b = op.vmult(op.scatter_vector(xs))
    mt.solve_cg(op, b, M=g, tol=DIST_GMG_F32_TOL, max_iter=100, dot=op.dot)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, it, res = mt.solve_cg(op, b, M=g, tol=DIST_GMG_F32_TOL, max_iter=100, dot=op.dot)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    rel = res / float(op.norm(b))
    check(bool(torch.isfinite(x).all()) and rel <= DIST_GMG_F32_TOL,
          f"the float32 distributed GMG-CG did not reach {DIST_GMG_F32_TOL:g}: {rel:.3e}")
    out["f32"] = dict(nref=nref, p=p, n_dofs=mf.n_dofs, tol=DIST_GMG_F32_TOL, iterations=it,
                      rel_residual=rel, setup_s=setup_s, solve_s=solve_s, card=smi)
    out["transfer"] = dist_transfer(mt, g, dev, wrappers, smi)
    print(f"distributed GMG-CG on {smi}: float64 quadrant nref={DIST_GMG_CHECK[0]} "
          f"p={DIST_GMG_CHECK[1]}: {out['f64_check']['iterations']} iterations (CPU plain path "
          f"{out['f64_check']['cpu_iterations']}); float32 nref={nref} p={p} ({mf.n_dofs} "
          f"DoFs): {it} iterations to {DIST_GMG_F32_TOL:g}, solve {solve_s:.3f} s, setup "
          f"{setup_s:.1f} s", flush=True)
    return out


def distributed_phase(mt, tria, mf, dev, wrappers, smi):
    """Phase 17: the distributed engines on one NCCL rank (a default group of
    NCCL for CUDA tensors and gloo for CPU ones, one process). At phase 3's
    mesh (quadrant nref=7 p=4 f32): DistributedLaplace (allgather, halo) and
    DistributedBrickLaplace (halo, replicated), each against the
    single-device engine in this process (1e-5), timed, profiled, counted
    (``dist_run``); the deformed brick engine (halo) at DIST_DEFORMED_NREF;
    float64 at DIST_F64_NREF against the scipy oracle and the single-device
    engines (1e-12); the new kernels at the main path's shapes with bounds and
    library calls (``dist_kernel_parts``) and on every rank's tables of the
    4-rank plans (``dist_plan_checks``); the GMG-CG (``dist_gmg``); the gloo
    ranks on the card (``dist_gloo_phase``). Returns (numbers, {kernel:
    record} of the new kernels)."""
    import tempfile

    import torch.distributed as dist

    from dealii_matrixfree_hanging_nodes_tpu_torch import parallel
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import KERNEL_MODULES
    from dealii_matrixfree_hanging_nodes_tpu_torch.oracle import vmult_oracle

    t_phase = time.perf_counter()
    torch.cuda.set_device(dev)
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    out, records = {}, {}
    try:
        u = np.random.default_rng(SEED).standard_normal(mf.n_dofs)
        # the single-device engines
        lap = mt.LaplaceOperator(mf, device=dev)
        ui = torch.from_numpy(u.astype(np.float32)).to(dev)
        ref_i = lap.vmult(ui)
        single_i = time_ms(lambda: lap.vmult(ui), reps=30, warmup=5)
        t0 = time.perf_counter()
        mm = mt.BrickLaplaceMM(mf, device=dev)
        torch.cuda.synchronize()
        mm_s = time.perf_counter() - t0
        xb = mm.from_dof_vector(u)
        ref_b = mm.to_dof_vector(mm.vmult(xb), zero_hanging=True)
        single_b = time_ms(lambda: mm.vmult(xb), reps=30, warmup=5)
        del mm, xb
        torch.cuda.empty_cache()
        setup = {"single_device_brick_s": mm_s}
        out["profiler_priming_sessions"] = prime_profiler("distributed engines",
                                                          lambda: lap.vmult(ui))
        for ex in ("allgather", "halo"):
            t0 = time.perf_counter()
            op = parallel.DistributedLaplace(mf, exchange=ex, device=dev)
            torch.cuda.synchronize()
            setup[f"index {ex}_s"] = time.perf_counter() - t0
            x = op.scatter_vector(u)
            out[f"index {ex}"], _ = dist_run(
                f"index {ex}", op, x, lambda y: (op.gather_vector(y), ref_i.cpu().numpy()),
                wrappers, smi, single_i, mf.n_dofs, 1e-5)
            if ex == "halo":
                iop, ix = op, x
        for ex in ("halo", "replicated"):
            t0 = time.perf_counter()
            op = parallel.DistributedBrickLaplace(mf, exchange=ex, device=dev)
            torch.cuda.synchronize()
            setup[f"brick {ex}"] = dict(op.setup_s, total=time.perf_counter() - t0)
            x = op.from_dof_vector(u)
            out[f"brick {ex}"], _ = dist_run(
                f"brick {ex}", op, x,
                lambda y: (op.to_dof_vector(y, zero_hanging=True), ref_b.cpu().numpy()),
                wrappers, smi, single_b, mf.n_dofs, 1e-5)
            if ex == "halo":
                bop, bx = op, x
        out["setup_s"] = setup
        print(f"distributed setup (quadrant nref=7 p=4 f32, seconds by step): "
              f"{json.dumps(setup)}", flush=True)
        # the new kernels on every rank's tables of the 4-rank plans, then at the main
        # path's shapes (the add mode, which one rank does not launch, on the plans')
        out["plan_checks"], adds = dist_plan_checks(mt, dev)
        parts, libs, main = dist_kernel_parts(bop, bx, iop, ix, adds)
        main_counts = out[DIST_MAIN]["launches"]
        for mod in [m for m in KERNEL_MODULES if m.NAME in DIST_NEW]:
            rec = kernel_record(mod)
            rec["parts"] = measure_parts(mod.NAME, parts[mod.NAME], libs[mod.NAME], {},
                                         bx.dtype, 1e-5)
            on_path = [p_ for p_, m_ in zip(rec["parts"], main[mod.NAME]) if m_]
            for p_, m_ in zip(rec["parts"], main[mod.NAME]):
                p_["main_path"] = m_
            for key in ("ms", "plain_ms", "bound_ms"):
                rec[key] = sum(p_[key] for p_ in on_path)
            lib = [p_["library_ms"] for p_ in on_path]
            rec["library_ms"] = sum(v for v in lib if v is not None) if any(
                v is not None for v in lib) else None
            rec["bound_by"] = max((p_["bound_ms"], p_["bound_by"]) for p_ in on_path)[1]
            rec["max_abs_err"] = max(p_["max_abs_err"] for p_ in rec["parts"])
            rec["max_rel_err"] = max(p_["max_rel_err"] for p_ in rec["parts"])
            rec["launches"] = main_counts[mod.NAME]
            records[mod.NAME] = rec
        del bop, bx, iop, ix, op, x, parts, libs
        torch.cuda.empty_cache()
        # the deformed brick engine
        trid = mt.create_quadrant(3, DIST_DEFORMED_NREF)
        mfd = mt.MatrixFree(trid, 4, dtype=np.float32, high_order_mapping=True)
        ud = np.random.default_rng(SEED).standard_normal(mfd.n_dofs)
        mmd = mt.BrickLaplaceMM(mfd, device=dev)
        xd = mmd.from_dof_vector(ud)
        ref_d = mmd.to_dof_vector(mmd.vmult(xd), zero_hanging=True)
        single_d = time_ms(lambda: mmd.vmult(xd), reps=30, warmup=5)
        del mmd, xd
        op = parallel.DistributedBrickLaplace(mfd, device=dev)
        out["deformed halo"], _ = dist_run(
            "deformed halo", op, op.from_dof_vector(ud),
            lambda y: (op.to_dof_vector(y, zero_hanging=True), ref_d.cpu().numpy()),
            wrappers, smi, single_d, mfd.n_dofs, 1e-5)
        out["deformed halo"]["nref"] = DIST_DEFORMED_NREF
        del op, mfd, trid
        torch.cuda.empty_cache()
        # float64 against the oracle and the single-device engines
        tria4 = mt.create_quadrant(3, DIST_F64_NREF)
        mf4 = mt.MatrixFree(tria4, 4, dtype=np.float64)
        u4 = np.random.default_rng(SEED).standard_normal(mf4.n_dofs)
        oracle = vmult_oracle(tria4, 4, u4)
        single4 = mt.LaplaceOperator(mf4, device=dev).vmult(u4).cpu().numpy()
        mm4 = mt.BrickLaplaceMM(mf4, device=dev)
        single4b = mm4.to_dof_vector(mm4.vmult(mm4.from_dof_vector(u4)),
                                     zero_hanging=True).cpu().numpy()
        f64 = {}
        for engine, ex in (("index", "allgather"), ("index", "halo"), ("brick", "halo"),
                           ("brick", "replicated")):
            if engine == "index":
                op = parallel.DistributedLaplace(mf4, exchange=ex, device=dev)
                got, single = op.gather_vector(op.vmult(op.scatter_vector(u4))), single4
            else:
                op = parallel.DistributedBrickLaplace(mf4, exchange=ex, device=dev)
                got = op.to_dof_vector(op.vmult(op.from_dof_vector(u4)), zero_hanging=True)
                single = single4b
            e_o = float(np.abs(got - oracle).max() / np.abs(oracle).max())
            e_s = float(np.abs(got - single).max() / np.abs(single).max())
            check(e_o <= 1e-12 and e_s <= 1e-12,
                  f"the float64 {engine} {ex} vmult disagrees: oracle {e_o:.3e}, single-device "
                  f"{e_s:.3e}")
            f64[f"{engine} {ex}"] = dict(oracle=e_o, single_device=e_s)
        out["f64"] = dict(nref=DIST_F64_NREF, **f64)
        print(f"float64 quadrant nref={DIST_F64_NREF} p=4 against the scipy oracle and the "
              f"single-device engines: {json.dumps(f64)}", flush=True)
        out["gmg"] = dist_gmg(mt, dev, wrappers, smi)
    finally:
        dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        out["gloo"] = dist_gloo_phase(tmp)
    out["phase_s"] = time.perf_counter() - t_phase
    return out, records


def elasticity_alone(mt, dev, wrappers, smi):
    """``python3 chip_smoke.py --elasticity``: phase 11 on phase 3's mesh
    (quadrant nref=7 p=4 f32, its scalar brick operators built here), then
    the 2-D elasticity of phase 14 (``index2d_elasticity``) and phase 16
    (``brick2d_elasticity`` on a p=4 brick operator of phase 14's mesh), each
    as in the whole run. Returns (numbers, the records of cell_elasticity and
    brick_elasticity with their 2-D parts, {kernel: [part]} of the others)."""
    t0 = time.perf_counter()
    mf = mt.MatrixFree(mt.create_quadrant(3, 7), 4, dtype=np.float32)
    op = mt.BrickLaplaceMM(mf, device=dev)
    op64 = mt.BrickLaplaceMM(mf, device=dev, dtype=torch.float64)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    elastic, records, parts = elasticity_phase(mt, mf, op, op64, dev, wrappers, smi)
    elastic["phase_s"] = time.perf_counter() - t0
    elastic["setup_s"] = setup_s
    print(f"elasticity phase: {elastic['phase_s']:.1f} s", flush=True)
    del mf, op, op64
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mf2 = mt.MatrixFree(mt.create_quadrant(2, INDEX2D_NREF), INDEX2D_DEGREE, dtype=np.float32)
    g = torch.Generator(device=dev).manual_seed(SEED)
    xe = torch.randn(mf2.n_dofs, 2, generator=g, device=dev, dtype=torch.float32)
    nnz = {}
    parts14, res14 = index2d_elasticity(mt, mf2, xe, dev, wrappers, smi, nnz)
    for name, plist in parts14.items():
        for part in plist:
            part["launches"] = res14["launches"].get(name, 0)
            part["call"] = "2-D elasticity"
    elastic["index_2d"] = dict(res14, library_nnz=nnz, phase_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    op2 = mt.BrickLaplaceMM(mf2, device=dev)
    elastic["brick_2d"], parts16 = brick2d_elasticity(mt, mf2, op2, res14["ms"], dev, wrappers,
                                                      smi)
    elastic["brick_2d"]["phase_s"] = time.perf_counter() - t0
    for name, plist in list(parts14.items()) + list(parts16.items()):
        if name in records:
            records[name]["parts"].extend(plist)
        else:
            parts.setdefault(name, []).extend(plist)
    del mf2, op2, xe
    torch.cuda.empty_cache()
    return elastic, records, parts


def index_alone(mt, dev, wrappers, smi):
    """``python3 chip_smoke.py --index``: phase 7 on phase 3's mesh (quadrant
    nref=7 p=4 f32), phase 9's index-engine float64 checks (quadrant nref=4
    p=4 and the oracle cases) and the Laplace paths of phase 14 (2-D
    quadrant nref=11: every instance of the index kernels, the vmults, the
    runners, the oracles; no elasticity, no GMG-CG), each as in the whole
    run. Returns (numbers, the records of the index kernels with their 2-D
    parts)."""
    t0 = time.perf_counter()
    tria = mt.create_quadrant(3, 7)
    mf = mt.MatrixFree(tria, 4, dtype=np.float32)
    index, records = index_phase(mt, tria, mf, dev, wrappers, smi)
    index["phase_s"] = phase_seconds(7, "the index engine", t0)
    del tria, mf
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tria4 = mt.create_quadrant(3, 4)
    index_f64_checks(mt, tria4, mt.MatrixFree(tria4, 4, dtype=np.float64), dev)
    index["f64_checks_s"] = phase_seconds(9, "the index engine's float64 checks", t0)
    t0 = time.perf_counter()
    index2d, parts, _, _ = index2d_phase(mt, dev, wrappers, smi, index_only=True)
    index2d["phase_s"] = phase_seconds(14, "2-D index paths", t0)
    for name, plist in parts.items():
        records[name]["parts"].extend(plist)
        for part in plist:
            for key in ("max_abs_err", "max_rel_err"):
                records[name][key] = max(records[name][key], part[key])
    index["index_2d"] = index2d
    torch.cuda.empty_cache()
    return index, records


def deformed_alone(mt, dev, wrappers, smi):
    """``python3 chip_smoke.py --deformed``: phase 13 on phase 3's mesh
    (quadrant nref=7 p=4 f32, with its Cartesian operator for the deformed /
    Cartesian ratio) and phase 16's deformed mapping (2-D quadrant nref=11
    p=4 f32, with the deformed index vmult timed for its ratio as phase 14
    times it), each as in the whole run. Returns (numbers, brick_deformed's
    record with its 2-D parts)."""
    t0 = time.perf_counter()
    tria = mt.create_quadrant(3, DEFORMED_NREF_BRICK)
    mf = mt.MatrixFree(tria, DEFORMED_DEGREE, dtype=np.float32)
    op_c = mt.BrickLaplaceMM(mf, device=dev)
    deformed, record, _ = deformed_phase(mt, tria, op_c, dev, wrappers, smi)
    deformed["phase_s"] = phase_seconds(13, "the deformed brick engine", t0)
    del tria, mf, op_c
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mf_d = mt.MatrixFree(mt.create_quadrant(2, INDEX2D_DEFORMED_NREF), INDEX2D_DEGREE,
                         dtype=np.float32, high_order_mapping=True)
    metric_build(mf_d, dev)
    op_d = mt.LaplaceOperator(mf_d, device=dev)
    x_d = torch.from_numpy(np.random.default_rng(SEED).standard_normal(mf_d.n_dofs)
                           .astype(np.float32)).to(dev)
    index_ms = time_ms(lambda: op_d.vmult(x_d), reps=20, warmup=3)
    print(f"2-D deformed index vmult nref={INDEX2D_DEFORMED_NREF} p={INDEX2D_DEGREE} f32 on "
          f"{smi}: {index_ms:.4f} ms", flush=True)
    del op_d, x_d
    paths2d, parts2d = brick2d_deformed(mt, mf_d, index_ms, dev, wrappers, smi)
    paths2d["phase_s"] = phase_seconds(16, "2-D deformed bricks", t0)
    for part in parts2d["brick_deformed"]:
        record["parts"].append(part)
        for key in ("max_abs_err", "max_rel_err"):
            record[key] = max(record[key], part[key])
    del mf_d
    torch.cuda.empty_cache()
    return {"deformed": deformed, "brick_2d_deformed": paths2d}, record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2

    t_phase = time.perf_counter()
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    if sys.argv[1:] == ["--metric-host"]:
        metric_host_comparison(mt)
        return 0
    only_distributed = sys.argv[1:] == ["--distributed"]
    only_gmg = sys.argv[1:] == ["--gmg"]
    only_elasticity = sys.argv[1:] == ["--elasticity"]
    only_index = sys.argv[1:] == ["--index"]
    only_deformed = sys.argv[1:] == ["--deformed"]
    from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import auto_brick_size, kronecker_sum
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        KERNEL_MODULES, _build, brick_apply, brick_deformed, brick_elasticity, brick_transfer,
        corr_compact, dss_surface, hn_cell, refill_update,
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
    phase_seconds(1, "the card", t_phase)

    # ---- 2. build (a whole run makes phase 3's mesh and MatrixFree meanwhile) --
    t0 = t_phase = time.perf_counter()
    whole = not (only_distributed or only_gmg or only_index or only_elasticity or only_deformed)
    with ThreadPoolExecutor(1) as pool:  # the nvcc processes run while this one works
        building = pool.submit(_build.build)
        if whole:  # host work only: neither launches nor loads a kernel
            tria = mt.create_quadrant(3, 7)
            mf = mt.MatrixFree(tria, 4, dtype=np.float32)
            print(f"phase 3's mesh and MatrixFree during the build: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        logs = building.result()
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
        for NB, p in sorted(brick_apply.SUPPORTED_2D, key=lambda t: t[1]):
            plans = [brick_apply.plan(dt, p, m, device=dev, dim=2) for m in (0, 1)]
            print(f"  brick_apply2_kernel {dt} p={p} NB={NB}: shared memory bytes, blocks per SM "
                  f"{plans[0]} without cell rows, {plans[1]} with")
        for p, B, d in sorted(brick_deformed.SUPPORTED, key=lambda t: (-t[2], t[0])):
            print(f"  brick_deformed{'2' if d == 2 else ''}_kernel {dt} p={p} B={B}: threads, "
                  f"shared memory bytes, blocks per SM "
                  f"{brick_deformed.plan(dt, p, B, d, device=dev)}")
        for p in range(1, 7):  # the 2-D brick elasticity's instances (B = 16, 16, 16, 8, 8, 8)
            print(f"  brick_elasticity2_kernel {dt} p={p}: threads, shared memory bytes, blocks "
                  f"per SM {brick_elasticity.plan(dt, p, 2, dev)}; hn_cell_elastic2_kernel "
                  f"{hn_cell.elastic_plan(dt, p, 16 if p <= 3 else 8, 2, dev)}")
        for d, degrees in _build.BRICK_DEGREES.items():
            for p in degrees:
                plans = {m: brick_transfer.plan(dt, p, d, m, dev) for m in brick_transfer.MODES}
                print(f"  brick_transfer {dt} dim={d} p={p}: threads, shared memory bytes, blocks "
                      f"per SM, clusters resident, rows a round: prolongate "
                      f"{plans['prolongate']}, restrict {plans['restrict']}")
                for m, plan in plans.items():  # the host's schedules use round_rows
                    host = brick_transfer.round_rows(d, p, auto_brick_size(p, d), m)
                    check(plan[4] == host, f"brick_transfer {m} dim={d} p={p}: the kernel takes "
                                           f"{plan[4]} rows a round, round_rows {host}")
    phase_seconds(2, "build and plans", t_phase)

    if only_distributed:  # phases 1, 2 and 17 alone, on phase 3's mesh
        tria = mt.create_quadrant(3, 7)
        mf = mt.MatrixFree(tria, 4, dtype=np.float32)
        wrappers = {mod.NAME: getattr(mod, mod.NAME) for mod in KERNEL_MODULES}
        distributed, records = distributed_phase(mt, tria, mf, dev, wrappers, smi)
        print(json.dumps({"distributed": distributed}))
        print(json.dumps({"kernels": list(records.values())}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0

    if only_gmg:  # phases 1, 2, 10 and phase 16's 2-D brick GMG alone
        wrappers = {mod.NAME: getattr(mod, mod.NAME) for mod in KERNEL_MODULES}
        gmg_numbers, records = gmg_phase(mt, dev, wrappers, smi)
        gmg2d, parts2d = brick2d_gmg(mt, dev, wrappers, smi)
        for name, plist in parts2d.items():
            records[name]["parts"].extend(plist)
        print(json.dumps({"gmg": gmg_numbers}))
        print(json.dumps({"brick_2d_gmg": gmg2d}))
        print(json.dumps({"gmg_kernels": [records[name] for name in GMG_KERNELS]}))
        print(json.dumps({"partial": "phases 1, 2, 10 and phase 16's 2-D brick GMG; no smoke "
                                     "result (run without arguments for that)"}))
        return 0

    if only_index:  # phases 1, 2, 7, 9's index checks and phase 14's index paths alone
        wrappers = {mod.NAME: getattr(mod, mod.NAME) for mod in KERNEL_MODULES}
        index, records = index_alone(mt, dev, wrappers, smi)
        print(json.dumps({"index": index}))
        print(json.dumps({"index_kernels": list(records.values())}))
        print(json.dumps({"partial": "phases 1, 2, 7, phase 9's index checks and phase 14's "
                                     "index paths; no smoke result (run without arguments for "
                                     "that)"}))
        return 0

    if only_deformed:  # phases 1, 2, 13 and phase 16's deformed mapping alone
        wrappers = {mod.NAME: getattr(mod, mod.NAME) for mod in KERNEL_MODULES}
        numbers, record = deformed_alone(mt, dev, wrappers, smi)
        print(json.dumps(numbers))
        print(json.dumps({"deformed_kernels": [record]}))
        print(json.dumps({"partial": "phases 1, 2, 13 and phase 16's deformed mapping; no smoke "
                                     "result (run without arguments for that)"}))
        return 0

    if only_elasticity:  # phases 1, 2, 11 and the 2-D elasticity of phases 14 and 16 alone
        wrappers = {mod.NAME: getattr(mod, mod.NAME) for mod in KERNEL_MODULES}
        elastic, records, _ = elasticity_alone(mt, dev, wrappers, smi)
        print(json.dumps({"elasticity": elastic}))
        print(json.dumps({"elastic_kernels": list(records.values())}))
        print(json.dumps({"partial": "phases 1, 2, 11 and the 2-D elasticity of phases 14 and "
                                     "16; no smoke result (run without arguments for that)"}))
        return 0

    # ---- 3. setup: quadrant nref=7, p=4, float32 ----------------------------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    op = mt.BrickLaplaceMM(mf, device=dev)
    torch.cuda.synchronize()
    print(f"setup: {time.perf_counter() - t0:.1f} s after the mesh  (quadrant nref=7 p=4 f32: "
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

    phase_seconds(3, "setup", t_phase)

    # ---- 4. each kernel against its plain version ---------------------------
    t_phase = time.perf_counter()
    tol32 = 1e-5
    calls, inter = kernel_calls(op, x, y)
    check_kernels(calls, tol32, "nref=7 f32")
    # library yardsticks: one PyTorch call computing the same function (timed
    # here only; the port never calls them)
    library = {name: [None] * len(parts) for name, parts in calls.items()}
    K = torch.from_numpy(kronecker_sum(op.K1.cpu().numpy(), op.M1.cpu().numpy())).to(dev, x.dtype)
    multi_mats = {}  # the composed matrices, applied to k columns in phase 12
    lib_calls, hn_steps, lib_nnz = yardsticks(op, inter, K, keep=multi_mats)
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

    phase_seconds(4, "each kernel against its plain version", t_phase)

    # ---- 5. end-to-end vmult, nref=7, float32, through the kernels ---------
    t_phase = time.perf_counter()
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

    phase_seconds(5, "vmult", t_phase)

    # ---- 6. refill, nref=7, float32, through the kernels --------------------
    t_phase = time.perf_counter()
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
    del x64, ref, got, x, y, yp  # op and op64 stay for the elasticity phase
    torch.cuda.empty_cache()

    phase_seconds(6, "refill", t_phase)

    # ---- 7. the index engine, nref=7, float32, through the kernels ----------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    index, index_records = index_phase(mt, tria, mf, dev, wrappers, smi)
    index["phase_s"] = time.perf_counter() - t0
    print(f"index engine phase: {index['phase_s']:.1f} s", flush=True)
    results.update(index_records)

    phase_seconds(7, "the index engine", t_phase)

    # ---- 8. the degree <= 3 schedule, float32 through the kernels -----------
    t_phase = time.perf_counter()
    low, low_parts, low_ops = {}, {}, {}
    trias = {7: tria}
    for p, nref in LOW_DEGREES:
        if nref not in trias:
            trias[nref] = mt.create_quadrant(3, nref)
        numbers, parts = degree_phase(mt, trias[nref], nref, p, dev, wrappers, smi,
                                      keep=low_ops if (p, nref) == (3, 7) else None)
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

    phase_seconds(8, "the degree <= 3 schedule", t_phase)

    # ---- 9. float64 through the kernels --------------------------------------
    t_phase = time.perf_counter()
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

    phase_seconds(9, "float64", t_phase)

    # ---- 10. the GMG-CG solve, quadrant nref=6 p=4 float32, and the index GMG --
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    gmg_numbers, gmg_records = gmg_phase(mt, dev, wrappers, smi)
    gmg_numbers["phase_s"] = time.perf_counter() - t0
    print(f"GMG phase: {gmg_numbers['phase_s']:.1f} s", flush=True)
    results.update(gmg_records)

    phase_seconds(10, "GMG-CG", t_phase)

    # ---- 11. linear elasticity on both engines ---------------------------------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    elastic, elastic_records, elastic_parts = elasticity_phase(mt, mf, op, op64, dev, wrappers,
                                                                smi)
    elastic["phase_s"] = time.perf_counter() - t0
    print(f"elasticity phase: {elastic['phase_s']:.1f} s", flush=True)
    results.update(elastic_records)

    phase_seconds(11, "elasticity", t_phase)

    # ---- 12. the multi-RHS vmult ------------------------------------------------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    multi, multi_parts = multi_phase(mt, op, op64, low_ops.pop(3), multi_mats, dev, wrappers,
                                     smi)
    multi["phase_s"] = time.perf_counter() - t0
    multi["single_vmult_busy_ms"] = vm_prof["busy_ms"]
    print(f"multi-RHS phase: {multi['phase_s']:.1f} s", flush=True)
    del op64, multi_mats
    torch.cuda.empty_cache()

    phase_seconds(12, "multi-RHS vmult", t_phase)

    # ---- 13. the deformed brick engine ------------------------------------------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    deformed, results["brick_deformed"], deformed_parts = deformed_phase(mt, tria, op, dev,
                                                                         wrappers, smi)
    deformed["phase_s"] = time.perf_counter() - t0
    print(f"deformed brick engine phase: {deformed['phase_s']:.1f} s", flush=True)
    del op
    torch.cuda.empty_cache()

    phase_seconds(13, "the deformed brick engine", t_phase)

    # ---- 14. 2-D on the index engine ----------------------------------------------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    index2d, index2d_parts, mf2, mf2_d = index2d_phase(mt, dev, wrappers, smi)
    index2d["phase_s"] = time.perf_counter() - t0
    print(f"2-D index engine phase: {index2d['phase_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()

    phase_seconds(14, "2-D index engine", t_phase)

    # ---- 15. 2-D on the brick engine, on phase 14's mesh ---------------------------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    brick2d, brick2d_parts, op2 = brick2d_phase(mt, mf2, index2d["vmult"]["ms"], dev, wrappers,
                                                smi)
    brick2d["phase_s"] = time.perf_counter() - t0
    print(f"2-D brick engine phase: {brick2d['phase_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()

    phase_seconds(15, "2-D brick engine", t_phase)

    # ---- 16. the rest of 2-D on the brick engine, on phase 14's and 15's meshes ---------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    paths2d, paths2d_parts = brick2d_paths_phase(mt, mf2, mf2_d, op2, index2d, dev, wrappers,
                                                 smi)
    paths2d["phase_s"] = time.perf_counter() - t0
    print(f"2-D brick paths phase: {paths2d['phase_s']:.1f} s", flush=True)
    del mf2, mf2_d, op2
    torch.cuda.empty_cache()

    phase_seconds(16, "2-D brick paths", t_phase)

    # ---- 17. the distributed engines on one NCCL rank, on phase 3's mesh ------------------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    distributed, dist_records = distributed_phase(mt, tria, mf, dev, wrappers, smi)
    print(f"distributed phase: {distributed['phase_s']:.1f} s", flush=True)
    results.update(dist_records)
    torch.cuda.empty_cache()
    # existing kernels: their elastic calls, their RHS-axis instances, their deformed
    # modes and their 2-D instances (index and brick engines) as parts
    for name, plist in (list(elastic_parts.items()) + list(multi_parts.items())
                        + list(deformed_parts.items()) + list(index2d_parts.items())
                        + list(brick2d_parts.items()) + list(paths2d_parts.items())):
        results[name]["parts"].extend(plist)
        for part in plist:
            for key in ("max_abs_err", "max_rel_err"):
                results[name][key] = max(results[name][key], part[key])
    check(sorted(results) == sorted(m.NAME for m in KERNEL_MODULES),
          f"the kernels line lacks {set(m.NAME for m in KERNEL_MODULES) - set(results)}")

    phase_seconds(17, "distributed", t_phase)

    # ---- 18. the numbers -----------------------------------------------------
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
    print(json.dumps({"gmg": gmg_numbers}))
    print(json.dumps({"elasticity": elastic}))
    print(json.dumps({"multi": multi}))
    print(json.dumps({"deformed": deformed}))
    print(json.dumps({"index_2d": index2d}))
    print(json.dumps({"brick_2d": brick2d}))
    print(json.dumps({"brick_2d_paths": paths2d}))
    print(json.dumps({"distributed": distributed}))
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
