"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Libraries
go to ``build/kernels/`` beside the package (the repository's ``build/``),
named by a hash of the source, the ``csrc/*.cuh`` headers it includes and
the flags, so an edited source or header is rebuilt and an unchanged one is
reused. ``build()`` starts one ``nvcc`` per missing
library, all at once. Nothing is compiled or loaded at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("brick_apply", "cell_apply", "dss_surface", "hn_cell", "corr_compact", "refill_update",
           "masked_quad", "plane_fill", "plane_fold", "hn_interp", "cell_laplace", "dof_scatter",
           "constraints_slow")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def _sources(path: Path, seen: list[Path]) -> list[Path]:
    """path and every ``csrc`` header it includes, directly or through
    another header, each once, in the order first included."""
    if path not in seen:
        seen.append(path)
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M):
            _sources(CSRC / inc, seen)
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in _sources(CSRC / f"{name}.cu", []):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every named kernel whose library is missing, one nvcc
    process per source, all started together. Returns {name: nvcc log}
    (the ``-Xptxas -v`` register and shared-memory report) for the ones
    built; raises with the log of any that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=fh, stderr=subprocess.STDOUT,
            )
        jobs[name] = (proc, tmp, out, log)
    logs, failed = {}, []
    for name, (proc, tmp, out, log) in jobs.items():
        proc.wait()
        logs[name] = log.read_text()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{logs[name]}")
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def ptxas_usage(log: str):
    """[(kernel, "N registers, S bytes spill stores, ...")] from an nvcc log:
    each entry function's template arguments in mangled form, e.g.
    ``cell_apply_kernel<IfLi4ELi4E>`` for <float, 4, 4>."""
    out, kernel, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"([a-z][a-z_]*_kernel)(I\w*?E)?E*v", line)
        if "Compiling entry function" in line and m:
            kernel = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and kernel:
            out.append((kernel, line.split("Used", 1)[1].strip() + "; " + spill))
    return out


def function(name: str, symbol: str, argtypes):
    """The C entry point `symbol` of kernel library `name`, built on first
    use; it returns a cudaError_t as int."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = _libs[name] = ctypes.CDLL(str(path))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Call a C launcher on `device`'s current stream; raise if the launch
    was refused (cudaGetLastError() != 0)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, ctypes.c_void_p(stream))
    if code:
        msg = _libs[name].kernel_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {code} ({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda(name: str, float_dtype, **tensors) -> torch.device:
    """Each tensor must be a contiguous CUDA tensor on one device; floating
    ones must have `float_dtype` (float32 or float64)."""
    if float_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: takes float32 or float64, got {float_dtype}")
    device = None
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, expected CUDA")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        if t.is_floating_point() and t.dtype != float_dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {float_dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return device


def suffix(dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"
