"""dof_embed's kernel against an earlier build of it, in one process on one
NVIDIA GPU, on the brick GMG's levels.

    git show <commit>:dealii_matrixfree_hanging_nodes_tpu_torch/csrc/dof_embed.cu > OLD.cu
    python3 embed_ab.py OLD.cu [rounds]

OLD.cu is a dof_embed source with the C entry of before the long-row split,
``dof_embed_f32(x, ptr, idx, w, out, n, stream)`` (a thread a destination).
The script builds it with the port's nvcc flags into ``build/embed_ab``,
builds the current kernel through the port, and on the f32 tables of
``DofEmbed`` at the 3-D quadrant nref=5 p=4 level (chip_smoke.py phase 10's
finest transfer's coarse level) and the 2-D quadrant nref=9 p=4 level
(phase 16's) times both modes of both kernels on the same inputs in the
order old, new, new, old, `rounds` times (default 3). Each time is the
median of 20 calls timed with CUDA events behind a device spin
(``chip_smoke.time_ms(device_only=True)``). Prints the card's name and power
limit, one line a (level, mode) with every time in order and whether the two
kernels' outputs are bit-identical, and one JSON line; exits non-zero
without a card.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
LEVELS = (("3-D nref=5 p=4", 3, 5), ("2-D nref=9 p=4", 2, 9))


def build_old(src: Path):
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import _build

    out = ROOT / "build" / "embed_ab" / "libdof_embed_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(out)).dof_embed_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu_torch.kernels import _build, dof_embed
    from dealii_matrixfree_hanging_nodes_tpu_torch.models.multigrid_bricks import DofEmbed

    rounds = int(sys.argv[2]) if len(sys.argv) == 3 else 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    _build.build(("dof_embed",))
    old_fn = build_old(Path(sys.argv[1]))
    g = torch.Generator(device=dev).manual_seed(0)
    results = []
    for label, dim, nref in LEVELS:
        mf = mt.MatrixFree(mt.create_quadrant(dim, nref), 4, dtype=np.float32)
        de = DofEmbed(mt.BrickLaplaceMM(mf, device=dev, face_planes=False))
        for mode, shape, n_in in (("embed", de.shape, de.n_dofs),
                                  ("embed_t", (de.n_dofs,), int(np.prod(de.shape)))):
            x = torch.randn(n_in, generator=g, device=dev, dtype=torch.float32)
            ptr, idx, w, long = de.tables(mode)
            n = ptr.numel() - 1

            def old():
                out = torch.empty(shape, dtype=x.dtype, device=dev)
                err = old_fn(*(_build.ptr(t) for t in (x, ptr, idx, w, out)), n,
                             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
                if err:
                    raise RuntimeError(f"the old dof_embed failed: error {err}")
                return out

            def new():
                return dof_embed.dof_embed(x, ptr, idx, w, long, shape)

            same = torch.equal(old(), new())
            times = {"old": [], "new": []}
            for _ in range(rounds):
                for which, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
                    times[which].append(chip_smoke.time_ms(fn, device_only=True))
            row = dict(level=label, mode=mode, rows=n, entries=int(idx.numel()),
                       long_rows=int(long.numel()), bit_identical=same, old_ms=times["old"],
                       new_ms=times["new"])
            results.append(row)
            print(f"{label} {mode}: {n} rows, {row['entries']} entries, {row['long_rows']} long; "
                  f"old {', '.join(f'{t:.4f}' for t in times['old'])} ms; new "
                  f"{', '.join(f'{t:.4f}' for t in times['new'])} ms; bit-identical {same}",
                  flush=True)
        del de, mf
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "embed_ab": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
