"""How often torch.profiler drops the kernel records of a session, and what
keeps them (one NVIDIA GPU).

    python3 profiler_probe.py [sessions] [variant ...]

Each variant (default: every one in ``VARIANTS``) runs in a process of its
own: `sessions` profiler sessions (default 40) shaped as
``chip_smoke.profile_path``'s (two synchronized warm-up steps, then 10
recorded calls), with other device work between sessions (CUDA-event timing,
a CSR product, a device sleep). A variant sets:
- the route of the recorded calls: "torch", call i launching its own
  PyTorch elementwise op (the kept records name the calls), or "ctypes", a
  kernel from a library that nvcc builds here into ``build/profiler_probe``
  and that ctypes launches on PyTorch's stream, as the port's kernels are;
- the seconds the card idles before a session, the seconds it idles at the
  start of the recorded window (a lead), the ms of a spin kernel launched
  just before the window opens, and ``TEARDOWN_CUPTI`` (unset: the
  profiler tears CUPTI down after each session; "0": it keeps it).
For each session the probe reads the raw records: the host's launch records
and the kernel records matched to them by correlation id, and from those the
kernel's start minus its launch's start ("skew", us; a kernel cannot start
before its launch, so a negative skew is the clock conversion's error). Prints
one JSON line a variant: sessions, whole sessions, the sessions that lost
records (kernel records kept, calls kept on the torch route, skew range) and
the skew range over all sessions; exits non-zero without a card.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

OPS = ("mul", "add", "sqrt", "exp", "log", "sin", "cos", "tanh", "sigmoid", "abs")
REPS = len(OPS)
# name: (route, seconds the card idles before the session, seconds it idles at the start
# of the recorded window, ms of a spin kernel launched just before the window opens,
# TEARDOWN_CUPTI or None)
VARIANTS = {
    "busy before": ("torch", 0.0, 0.0, 0.0, None),
    "idle 1 s before": ("torch", 1.0, 0.0, 0.0, None),
    "idle 1 s, lead 0.05 s": ("torch", 1.0, 0.05, 0.0, None),
    "idle 1 s, spin 20 ms": ("torch", 1.0, 0.0, 20.0, None),
    "idle 1 s, spin 5 ms": ("torch", 1.0, 0.0, 5.0, None),
    "ctypes, idle 1 s": ("ctypes", 1.0, 0.0, 0.0, None),
    "ctypes, idle 1 s, no teardown": ("ctypes", 1.0, 0.0, 0.0, "0"),
    "ctypes, idle 1 s, lead 0.05 s": ("ctypes", 1.0, 0.05, 0.0, None),
    "ctypes, idle 1 s, lead 0.05 s, no teardown": ("ctypes", 1.0, 0.05, 0.0, "0"),
    "ctypes, idle 1 s, spin 20 ms": ("ctypes", 1.0, 0.0, 20.0, None),
}
SPIN_CYCLES_PER_MS = 2_000_000  # torch.cuda._sleep's cycles at the H100's ~2 GHz clock
LIB_DIR = Path(__file__).resolve().parent / "build" / "profiler_probe"
KERNEL_SRC = r"""
#include <cuda_runtime.h>
__global__ void probe_kernel(float* y, const float* x, int n, float a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = a * x[i] + 1.0f;
}
extern "C" int probe_launch(float* y, const float* x, int n, float a, void* stream) {
  probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(y, x, n, a);
  return (int)cudaGetLastError();
}
"""


def build_library() -> Path:
    """The ctypes route's library, built by nvcc with the port's flags."""
    LIB_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = LIB_DIR / "probe.cu", LIB_DIR / "libprobe.so"
    src.write_text(KERNEL_SRC)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)], check=True)
    return lib


def run(sessions: int, route: str, idle_s: float, lead_s: float, spin_ms: float) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    dev = torch.device("cuda")
    x = torch.rand(1 << 22, device=dev) + 1
    y = torch.empty_like(x)
    if route == "torch":
        calls = [lambda op=op: getattr(torch, op)(x, 2.0, out=y) if op in ("mul", "add")
                 else getattr(torch, op)(x, out=y) for op in OPS]
    else:
        lib = ctypes.CDLL(str(LIB_DIR / "libprobe.so"))

        def launch(a):
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            code = lib.probe_launch(ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(x.data_ptr()),
                                    ctypes.c_int(x.numel()), ctypes.c_float(a), stream)
            assert code == 0, code
        calls = [lambda a=float(i): launch(a) for i in range(REPS)]

    def other():
        a = torch.randn(3000, 3000, device=dev)
        for _ in range(20):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            calls[0]()
            e.record()
            e.synchronize()
        idx = torch.randint(0, 3000, (2, 200_000), device=dev)
        m = torch.sparse_coo_tensor(idx, torch.ones(200_000, device=dev), (3000, 3000))
        (m.coalesce().to_sparse_csr() @ a[:, :8]).sum().item()
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()

    t_start = time.perf_counter()
    rows = []
    for s in range(sessions):
        other()
        time.sleep(idle_s)
        warm = 2
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True,
                     schedule=schedule(wait=0, warmup=warm, active=REPS)) as prof:
            for w in range(warm):
                calls[0]()
                torch.cuda.synchronize()
                if w == warm - 1 and spin_ms:
                    torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
                prof.step()
            time.sleep(lead_s)
            for i in range(REPS):
                calls[i]()
                if i < REPS - 1:
                    prof.step()
            torch.cuda.synchronize()
        kernels, launches = {}, {}
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() == DeviceType.CUDA and not ev.name().startswith("ProfilerStep") \
                    and "spin_kernel" not in ev.name():
                kernels[ev.correlation_id()] = (ev.name().lower(), ev.start_ns())
            elif "LaunchKernel" in ev.name():
                launches[ev.correlation_id()] = ev.start_ns()
        kept = sorted({i for i, op in enumerate(OPS) for name, _ in kernels.values() if op in name})
        skew = [(t - launches[c]) / 1e3 for c, (_, t) in kernels.items() if c in launches]
        rows.append(dict(session=s, t_s=round(time.perf_counter() - t_start, 2),
                         launches=len(launches), kernels=len(kernels),
                         calls_kept=kept if route == "torch" else None,
                         skew_us=[min(skew), max(skew)] if skew else None))
    skews = [r["skew_us"] for r in rows if r["skew_us"]]
    lost = [r for r in rows if r["kernels"] != REPS]
    return dict(sessions=sessions, whole=sessions - len(lost), lost=lost,
                skew_us=[min(s[0] for s in skews), max(s[1] for s in skews)] if skews else None,
                seconds=round(time.perf_counter() - t_start, 1))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profiler_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--child"]:  # one variant, in a process of its own
        sessions, route, *rest = sys.argv[2:]
        print(json.dumps(run(int(sessions), route, *map(float, rest))), flush=True)
        return 0
    sessions = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    names = sys.argv[2:] or list(VARIANTS)
    if any(VARIANTS[n][0] == "ctypes" for n in names):
        build_library()
    status = 0
    for name in names:
        route, idle_s, lead_s, spin_ms, teardown = VARIANTS[name]
        env = dict(os.environ)
        if teardown is not None:
            env["TEARDOWN_CUPTI"] = teardown
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", str(sessions),
                            route, str(idle_s), str(lead_s), str(spin_ms)],
                           env=env, capture_output=True, text=True, timeout=300)
        out = r.stdout.strip().splitlines()
        print(json.dumps({"variant": name, "rc": r.returncode,
                          **(json.loads(out[-1]) if r.returncode == 0 and out else
                             {"stderr": r.stderr[-2000:]})}), flush=True)
        status = status or r.returncode
    return status


if __name__ == "__main__":
    sys.exit(main())
