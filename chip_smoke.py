"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
2. build the four CUDA kernels from ``dealii_matrixfree_hanging_nodes_tpu_torch/csrc``
   (one nvcc per source, all at once);
3. set up the bench workload: quadrant mesh, nref=7, degree 4, float32, on the card;
4. hold each kernel against its plain PyTorch version on the card at the
   shapes the vmult gives it (relative tolerance 1e-5 in float32), and time
   both with CUDA events (median over repetitions after warm-up);
5. the end-to-end constrained vmult at nref=7 in float32 through the kernels,
   held against the plain float64 path on the card (after zeroing the
   hanging entries, relative tolerance 1e-5), with every kernel's launch
   count read from that run; its time and DoF/s;
6. the float64 vmult at nref=4 through the kernels against the scipy oracle
   (relative tolerance 1e-12);
7. a JSON line with the vmult's numbers, one with the kernels' numbers,
   then the device line.

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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def errors(got: torch.Tensor, ref: torch.Tensor):
    diff = float((got.double() - ref.double()).abs().max())
    return diff, diff / max(float(ref.double().abs().max()), 1e-300)


def bound(nbytes: int, flops: int | None, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops or 0) / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def profile_vmult(op, x, kernel_names, reps: int = 10) -> None:
    """Where a vmult's time goes: device time by kernel from torch.profiler
    over `reps` vmults, the four port kernels against everything else (the
    plain-PyTorch chain), and the device's idle share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        op.vmult(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            op.vmult(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = []  # device kernels only: the aten ops that launch them would count twice
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / reps / 1e3, ev.count // reps, ev.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        print("profile: the profiler saw no device time (not measured)")
        return
    ours = sum(r[0] for r in rows if any(k in r[2] for k in kernel_names))
    print(f"profile (per vmult, {reps} vmults): wall {wall_ms:.4f} ms, device busy "
          f"{busy:.4f} ms (idle {100 * (1 - busy / wall_ms):.1f} %), port kernels "
          f"{ours:.4f} ms, other device work {busy - ours:.4f} ms in "
          f"{sum(r[1] for r in rows if not any(k in r[2] for k in kernel_names))} launches")
    for ms, count, key in sorted(rows, reverse=True)[:15]:
        print(f"  {ms:9.4f} ms  x{count:<4d} {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2

    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        KERNEL_MODULES, _build, brick_apply, cell_apply, cols_overlap_add, dss_surface,
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- 3. setup: quadrant nref=7, p=4, float32 ----------------------------
    t0 = time.perf_counter()
    tria = mt.create_quadrant(3, 7)
    mf = mt.MatrixFree(tria, 4, dtype=np.float32)
    op = mt.BrickLaplaceMM(mf, device=dev)
    torch.cuda.synchronize()
    print(f"setup: {time.perf_counter() - t0:.1f} s  (quadrant nref=7 p=4 f32: "
          f"{mf.n_dofs} DoFs, {tria.n_active_cells} cells, {op.n_bricks} bricks, "
          f"{op.n_sub} subset bricks, {op.n_hn} constrained rows)", flush=True)
    u = np.random.default_rng(SEED).standard_normal(mf.n_dofs).astype(np.float32)
    x = op.from_dof_vector(u)

    # the main path's intermediates, as the vmult hands them to each kernel
    u_sub = x[: op.n_sub]
    v0 = brick_apply.brick_apply(x, op.Kb, op.Mb, op.geo, op.p)
    plain_rows = cell_apply.cell_apply(u_sub, op.K, op.geo_cell_sub, brick_size=op.B)
    u_hat = op._fill_rows(u_sub)
    own = cell_apply.cell_apply(u_hat, op.K, op.geo_hn)
    dcols = op._corr_compact(plain_rows, plain_rows[op.hn_sub], op._hn_apply(own, True))
    v1 = v0.clone()
    cols_overlap_add.cols_overlap_add(v1[: op.n_sub], dcols, brick_size=op.B)
    torch.cuda.synchronize()

    # ---- 4. each kernel against its plain version ---------------------------
    tol32 = 1e-5
    isz = x.element_size()
    dss_args = (op.face_other, op.edge_contrib, op.corner_contrib, op.node_valid, op.NB)
    calls = {
        "brick_apply": [(
            "bricks",
            lambda: brick_apply.brick_apply(x, op.Kb, op.Mb, op.geo, op.p),
            lambda: brick_apply.brick_apply_plain(x, op.Kb, op.Mb, op.geo),
            brick_apply.bytes_and_flops(op.n_bricks, op.NB, op.p, op.N3p, isz), None,
        )],
        "cell_apply": [(
            "from_bricks",
            lambda: cell_apply.cell_apply(u_sub, op.K, op.geo_cell_sub, brick_size=op.B),
            lambda: cell_apply.cell_apply_plain(u_sub, op.K, op.geo_cell_sub, op.B),
            cell_apply.bytes_and_flops(u_sub.numel(), plain_rows.shape[0], op.n_loc, isz), None,
        ), (
            "from_rows",
            lambda: cell_apply.cell_apply(u_hat, op.K, op.geo_hn),
            lambda: cell_apply.cell_apply_plain(u_hat, op.K, op.geo_hn),
            cell_apply.bytes_and_flops(u_hat.numel(), op.n_hn, op.n_loc, isz), None,
        )],
    }
    v_tmp = v0[: op.n_sub].clone()
    flat_idx = cols_overlap_add.overlap_add_index(op.n_sub, op.B, op.p, op.N3p, dev)
    calls["cols_overlap_add"] = [(
        "into_bricks",
        lambda: cols_overlap_add.cols_overlap_add(v_tmp, dcols, op.B),
        lambda: cols_overlap_add.cols_overlap_add_plain(v_tmp, dcols, op.B),
        cols_overlap_add.bytes_and_flops(op.n_sub, op.B, op.p, op.N3p, isz),
        lambda: v_tmp.view(-1).index_add_(0, flat_idx, dcols.view(-1)),
    )]
    calls["dss_surface"] = [(
        "bricks",
        lambda: dss_surface.dss_surface(v1, *dss_args),
        lambda: dss_surface.dss_surface_plain(v1, *dss_args),
        dss_surface.bytes_and_flops(op.node_valid, op.face_other, op.edge_contrib,
                                    op.corner_contrib, op.NB, isz),
        None,
    )]
    # correctness on fresh copies (the overlap-add works in place)
    fresh = {
        "cols_overlap_add": (
            cols_overlap_add.cols_overlap_add(v0[: op.n_sub].clone(), dcols, op.B),
            cols_overlap_add.cols_overlap_add_plain(v0[: op.n_sub].clone(), dcols, op.B),
        ),
    }
    wrappers = {mod.NAME: getattr(mod, mod.NAME) for mod in KERNEL_MODULES}
    results = {}
    for mod in KERNEL_MODULES:
        name, parts = mod.NAME, calls[mod.NAME]
        rec = dict(name=name, route="cuda",
                   source=f"dealii_matrixfree_hanging_nodes_tpu_torch/csrc/{name}.cu",
                   replaces=mod.REPLACES, launches=None, max_abs_err=0.0, max_rel_err=0.0,
                   ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by=None, library_ms=None,
                   parts=[])
        bound_parts = []
        for mode, kern, plain, (nbytes, flops), library in parts:
            if name in fresh:
                got, ref = fresh[name]
            else:
                got, ref = kern(), plain()
            torch.cuda.synchronize()
            abs_err, rel_err = errors(got, ref)
            check(bool(torch.isfinite(got).all()), f"{name} gave non-finite values")
            check(rel_err <= tol32, f"{name} disagrees with its plain version: {rel_err:.3e}")
            k_ms, p_ms = time_ms(kern), time_ms(plain)
            b_ms, b_by = bound(nbytes, flops, x.dtype)
            bound_parts.append((b_ms, b_by))
            rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
            rec["max_rel_err"] = max(rec["max_rel_err"], rel_err)
            rec["ms"] += k_ms
            rec["plain_ms"] += p_ms
            rec["bound_ms"] += b_ms
            if library is not None:
                rec["library_ms"] = time_ms(library)
            rec["parts"].append(dict(mode=mode, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                     bound_by=b_by, max_abs_err=abs_err, max_rel_err=rel_err))
            print(f"{name}[{mode}]: max rel err {rel_err:.3e} (tol {tol32:g}), max abs err "
                  f"{abs_err:.3e}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
                  f"{(flops or 0) / 1e9:.3f} GFLOP)"
                  + (f", library {rec['library_ms']:.4f} ms" if library else ""), flush=True)
        rec["bound_by"] = max(bound_parts)[1]
        results[name] = rec

    # ---- 5. end-to-end vmult, nref=7, float32, through the kernels ---------
    op64 = mt.BrickLaplaceMM(mf, device=dev, dtype=torch.float64)
    x64 = x.double()
    ref = op64.to_dof_vector(op64.vmult(x64, plain=True), zero_hanging=True)
    for wrapper in wrappers.values():
        wrapper.launches = 0
    y = op.vmult(x)
    torch.cuda.synchronize()
    counts = {name: wrapper.launches for name, wrapper in wrappers.items()}
    got = op.to_dof_vector(y, zero_hanging=True)
    abs_err, rel_err = errors(got, ref)
    print(f"vmult nref=7 f32 vs plain f64 path: max rel err {rel_err:.3e} (tol 1e-5), "
          f"launches per vmult {counts}", flush=True)
    check(bool(torch.isfinite(y).all()) and got.shape == (mf.n_dofs,), "vmult output malformed")
    check(rel_err <= 1e-5, f"vmult disagrees with the float64 path: {rel_err:.3e}")
    for name, n in counts.items():
        check(n > 0, f"the vmult never launched {name}")
        results[name]["launches"] = n
    vm_ms = time_ms(lambda: op.vmult(x), reps=30, warmup=5)
    vm_plain_ms = time_ms(lambda: op.vmult(x, plain=True), reps=10, warmup=2)
    print(f"vmult nref=7 p=4 f32 on {smi}: {vm_ms:.4f} ms ({mf.n_dofs / vm_ms / 1e6:.4f} "
          f"GDoF/s); plain path {vm_plain_ms:.4f} ms", flush=True)
    del op64, x64, ref
    profile_vmult(op, x, set(wrappers))

    # ---- 6. float64 at nref=4 through the kernels against the oracle -------
    tria4 = mt.create_quadrant(3, 4)
    mf4 = mt.MatrixFree(tria4, 4, dtype=np.float64)
    op4 = mt.BrickLaplaceMM(mf4, device=dev)
    u4 = np.random.default_rng(SEED).standard_normal(mf4.n_dofs)
    got4 = op4.to_dof_vector(op4.vmult(op4.from_dof_vector(u4)), zero_hanging=True)
    ref4 = vmult_oracle(tria4, 4, u4)
    err4 = float(np.abs(got4.cpu().numpy() - ref4).max() / np.abs(ref4).max())
    print(f"vmult nref=4 f64 vs scipy oracle: max rel err {err4:.3e} (tol 1e-12)", flush=True)
    check(err4 <= 1e-12, f"float64 vmult disagrees with the oracle: {err4:.3e}")

    # ---- 7. the numbers ------------------------------------------------------
    print(json.dumps({"vmult": {"ms": vm_ms, "plain_ms": vm_plain_ms, "n_dofs": mf.n_dofs,
                                "gdofs_per_s": mf.n_dofs / vm_ms / 1e6, "card": smi}}))
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
