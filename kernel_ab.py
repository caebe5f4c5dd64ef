"""The port's cell kernels against a variant of their CUDA sources, in one
process on one NVIDIA GPU, through the port's own wrappers, at the vmults'
shapes.

    python3 kernel_ab.py VARIANT_CSRC [VARIANT_CSRC ...] [rounds]

Each VARIANT_CSRC is a directory holding a cell_laplace.cu, a cell_elasticity.cu,
a brick_elasticity.cu and/or a brick_deformed.cu with the port's current C
entries (a design
under trial, or an earlier tree's csrc: `git archive <commit>
<package>/csrc`; a variant's headers are looked up in its own directory
first, then in the port's csrc). The script builds each with the port's
nvcc flags into ``build/kernel_ab`` and the port's kernels, each nvcc in a
process of its own, all at once. It times each wrapper call with the port's
library ("port") and with each variant's ("variant") on the same seeded
inputs in the order port, variant, variant, port, `rounds` times (default
3), variant after variant on the same operators; each time is the median of 20 calls timed with CUDA events behind a
device spin (``chip_smoke.time_ms(device_only=True)``). The instances, all
f32 at p=4:

- cell_laplace: 3-D quadrant nref=7 on the fast map with the cells' codes
  (the index vmult's launch), 3-D deformed at nref=6, 2-D quadrant nref=11
  fast, 2-D deformed at nref=11;
- cell_elasticity: 3-D nref=7 index mode with the codes and bricks mode,
  2-D nref=11 index mode (mu = lam = 1);
- brick_elasticity: 3-D nref=7 and 2-D nref=11 with the subset's cell rows;
- brick_deformed (``high_order_mapping=True``): 3-D quadrant nref=7 with
  seeded cell rows for the subset bricks (the deformed vmult's launch) and
  without (vmult_plain's), 2-D nref=11 with cell rows.

Prints the card's name and power limit, one line an instance and variant
with every time in order, the largest difference of the variant's output from the
port's (absolute, and relative to the port's largest value), whether the
two outputs are bit-identical and whether two variant calls are, and one
JSON line; exits non-zero without a card.
"""
import contextlib
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNELS = ("cell_laplace", "cell_elasticity", "brick_elasticity", "brick_deformed")


def build_variant(src: Path, tag: str):
    """The variant library of src's kernel, built with the port's flags into
    build/kernel_ab/<tag>."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import _build

    out = ROOT / "build" / "kernel_ab" / tag / f"lib{src.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src.parent), "-I",
                           str(_build.CSRC), "-o", str(out), str(src)], capture_output=True,
                          text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{done.stderr[-4000:]}")
    lib = ctypes.CDLL(str(out))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def library(name, lib):
    """The port's wrappers of kernel `name` launch from `lib` meanwhile."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import _build

    saved = _build._libs.get(name)
    _build._libs[name] = lib
    try:
        yield
    finally:
        _build._libs[name] = saved


def main() -> int:
    args = sys.argv[1:]
    rounds = int(args.pop()) if args and args[-1].isdigit() else 3
    if not torch.cuda.is_available() or not args:
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import (
        _build, brick_deformed, cell_elasticity, cell_laplace,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    srcs = [(d, k, Path(d) / f"{k}.cu") for d in args for k in KERNELS
            if (Path(d) / f"{k}.cu").exists()]
    libs = {}  # kernel: [(variant directory, library)]
    with ThreadPoolExecutor(len(srcs) + 1) as pool:
        built = pool.submit(_build.build, KERNELS)
        made = pool.map(lambda i: build_variant(srcs[i][2], str(i)), range(len(srcs)))
        for (d, k, _), lib in zip(srcs, made):
            libs.setdefault(k, []).append((d, lib))
        built.result()

    g = torch.Generator(device=dev).manual_seed(0)
    results = []
    f32 = torch.float32
    if "cell_laplace" in libs:
        for dim, nref, deformed in ((3, 7, False), (3, 6, True), (2, 11, False), (2, 11, True)):
            mf = mt.MatrixFree(mt.create_quadrant(dim, nref), 4, dtype=np.float32,
                               high_order_mapping=deformed)
            x = torch.randn(mf.n_dofs, generator=g, device=dev)
            cargs = (x, *mf.cell_laplace_args(dev, f32))
            label = (f"{dim}-D cell_laplace {'deformed' if deformed else 'fast, codes'} "
                     f"nref={nref}")
            results += ab(chip_smoke, label, "cell_laplace", libs["cell_laplace"],
                          lambda a=cargs, f=mf.kernel_factors:
                          cell_laplace.cell_laplace(*a, factors=f), rounds)
            del mf, x, cargs
            torch.cuda.empty_cache()
    for dim, nref in ((3, 7), (2, 11)):
        if not {"cell_elasticity", "brick_elasticity"} & set(libs):
            break
        mf = mt.MatrixFree(mt.create_quadrant(dim, nref), 4, dtype=np.float32)
        op = mt.BrickElasticity(mf, 1.0, 1.0, device=dev)
        mm = op.mm
        bv = torch.randn(dim, mm.n_bricks, mm.N3p, generator=g, device=dev)
        x = torch.randn(mf.n_dofs, dim, generator=g, device=dev)
        index = (x, *mf.cell_laplace_args(dev, f32), 1.0, 1.0)
        dcols = op.cell_rows(bv)
        cases = [("cell_elasticity", f"{dim}-D cell_elasticity index",
                  lambda a=index: cell_elasticity.cell_elasticity(
                      *a, factors=op.cell_kernel_factors))]
        if dim == 3:
            cases.append(("cell_elasticity", "3-D cell_elasticity bricks",
                          lambda: op.cell_rows(bv)))
        cases.append(("brick_elasticity", f"{dim}-D brick_elasticity with cell rows",
                      lambda: op.brick_apply(bv, dcols)))
        for name, label, fn in cases:
            if name in libs:
                results += ab(chip_smoke, label, name, libs[name], fn, rounds)
        del op, mm, bv, x, dcols, index, mf, cases
        torch.cuda.empty_cache()
    for dim, nref in ((3, 7), (2, 11)):
        if "brick_deformed" not in libs:
            break
        mf = mt.MatrixFree(mt.create_quadrant(dim, nref), 4, dtype=np.float32,
                           high_order_mapping=True)
        op = mt.BrickLaplaceMM(mf, device=dev)
        bv = torch.randn(op.n_bricks, op.N3p, generator=g, device=dev)
        cols = torch.randn(op.n_sub * op.C, op.n_loc, generator=g, device=dev)
        bd = (bv, op.metric, op.present_bits, op.S, op.Dc)
        for d in (cols, None) if dim == 3 else (cols,):
            label = f"{dim}-D brick_deformed {'with' if d is not None else 'without'} cell rows"
            results += ab(chip_smoke, label, "brick_deformed", libs["brick_deformed"],
                          lambda d=d: brick_deformed.brick_deformed(
                              *bd, dcols=d, brick_size=op.B, factors=op.kernel_factors),
                          rounds)
        del op, mf, bv, cols, bd
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "kernel_ab": results}))
    return 0


def ab(chip_smoke, label, name, variants, fn, rounds):
    """fn with the port's library and with each variant's [(directory,
    library)] in the order port, variant, variant, port, `rounds` times; the
    variant's output against the port's. Returns a row a variant."""
    rows = []
    ref = fn()
    scale = float(ref.abs().max())
    for where, lib in variants:
        with library(name, lib):
            got, again = fn(), fn()
        diff = float((got - ref).abs().max())
        row = dict(instance=label, variant=where, ms={"port": [], "variant": []},
                   max_abs_diff=diff, rel_diff=diff / scale,
                   bit_identical=bool(torch.equal(got, ref)),
                   variant_bit_identical=bool(torch.equal(got, again)))
        del got, again
        for _ in range(rounds):
            for which in ("port", "variant", "variant", "port"):
                with library(name, lib) if which == "variant" else contextlib.nullcontext():
                    row["ms"][which].append(chip_smoke.time_ms(fn, device_only=True))
        print(f"{label} [{where}]: " + "; ".join(f"{k} {', '.join(f'{t:.4f}' for t in v)} ms"
                                                 for k, v in row["ms"].items())
              + f"; variant against port: largest difference {diff:.3e} (relative "
              f"{row['rel_diff']:.3e}), bit-identical {row['bit_identical']}; two variant calls "
              f"bit-identical {row['variant_bit_identical']}", flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    sys.exit(main())
