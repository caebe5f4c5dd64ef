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
           "constraints_slow", "brick_transfer", "dof_embed", "cell_transfer", "cell_elasticity",
           "brick_elasticity", "brick_deformed", "halo_pack", "dss_pools", "chain_halo")
# -split-compile=0: each source's kernels are optimized in parallel on every core; the largest
# source (brick_elasticity.cu, its 2-D and 3-D instances) set chip_smoke.py's build at 201.9 s
# without it and 104.6 s with it (all sources at once on the 8-core host of an H100)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-split-compile=0",
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
        m = re.search(r"([a-z][a-z0-9_]*_kernel)(I\w*?E)?E*v", line)
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


MAX_RHS = 65535  # grid.y's cap: the most right-hand sides one launch takes


def rhs_axis(name: str, t: torch.Tensor, dims: int):
    """(k, stride, one) of `t`, a tensor of `dims` dimensions, or of those
    after a leading right-hand-side axis: k right-hand sides `stride`
    elements apart (0 without the axis) and the first of them, which stands
    for all in ``check_cuda``'s contiguity check (the leading axis may have
    any stride: the subset view ``bvk[:, :n_sub]`` has that of bvk). Raises
    for another rank and for k outside 1..MAX_RHS."""
    if t.dim() == dims:
        return 1, 0, t
    if t.dim() != dims + 1:
        raise ValueError(f"{name}: expected {dims} dimensions, or a right-hand-side axis "
                         f"before them, got {tuple(t.shape)}")
    k = t.shape[0]
    if not 1 <= k <= MAX_RHS:
        raise ValueError(f"{name}: {k} right-hand sides; a launch takes 1 to {MAX_RHS} "
                         f"(grid.y)")
    return k, t.stride(0), t[0]


def suffix(dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


DIMS = (2, 3)  # the index engine's kernels: 2-D and 3-D instances


def lattice_dim(name: str, n: int, n_loc: int) -> int:
    """The dimension of cells of n_loc values, n = p+1 nodes a side: the d
    in DIMS with n^d == n_loc (one at most: n^2 != n^3 for n >= 2); raises
    where there is none."""
    for d in DIMS:
        if n**d == n_loc:
            return d
    raise ValueError(f"{name}: {n_loc} values a cell are no {n}^d lattice for d in {DIMS}")


# the brick engine's kernels: degrees 1..8 in 3-D, 1..6 in 2-D (the ported 2-D brick sizes)
BRICK_DEGREES = {3: range(1, 9), 2: range(1, 7)}


def cell_shape(name: str, n_loc: int):
    """(p, dim) of brick-engine cells of n_loc = (p+1)^dim values: one pair
    at most among BRICK_DEGREES (64 is 4^3; 8^2 would be p=7 in 2-D, which
    no 2-D brick holds); raises where there is none."""
    for dim, degrees in BRICK_DEGREES.items():
        for p in degrees:
            if (p + 1) ** dim == n_loc:
                return p, dim
    raise ValueError(f"{name}: {n_loc} values a cell are no (p+1)^dim lattice of a brick cell")


def brick_dim(name: str, NB: int, N3p: int) -> int:
    """The dimension of brick rows of N3p values, NB nodes a side: 3 where a
    row holds NB^3 nodes, 2 where it holds NB^2 and not NB^3 (a 2-D row is
    padded to a multiple of 128, far below NB^3 for NB >= 11); raises where
    it holds neither."""
    if N3p >= NB**3:
        return 3
    if N3p >= NB**2:
        return 2
    raise ValueError(f"{name}: brick rows of {N3p} values hold no {NB}^2 or {NB}^3 brick")
