"""Shared cases for the PyTorch port's tests: the same mesh set up by the
JAX package (the reference) and by the port, in float64 on the CPU, built
once per test process."""

import ctypes
import ctypes.util
import functools
import gc
import sys

import numpy as np
import pytest

# (geometry, n_refinements, degree): p=4 with B=4 bricks, p=5,6 with B=2
CASES = [
    ("quadrant", 3, 4),
    ("quadrant", 4, 4),
    ("step", 3, 4),
    ("quadrant", 2, 5),
    ("quadrant", 2, 6),
]
IDS = [f"{g}-{n}-p{p}" for g, n, p in CASES]
# the degree <= 3 schedule: masked removal at p <= 3 (B = 4, 8, 16), face
# planes at p <= 2; quadrant nref=6 is the first p=1 quadrant mesh whose
# planes chain over two levels
LOW_CASES = [
    ("quadrant", 4, 3),
    ("quadrant", 4, 2),
    ("step", 4, 2),
    ("quadrant", 6, 1),
]
LOW_IDS = [f"{g}-{n}-p{p}" for g, n, p in LOW_CASES]
RTOL = 1e-12


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test of a module that imports this fixture runs with one PyTorch
    CPU thread: the plain versions are many small ops, which lose more to
    threads spinning on cores that parallel test workers share than they
    gain (a Chebyshev setup: 0.4 s on one thread, 17 s on eight with the
    cores busy)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def release_memory():
    """Collect garbage and hand the freed heap back to the system (glibc's
    malloc_trim, where the C library has it): a test worker runs many files
    in one process, and the arrays a module freed otherwise stay in the
    worker's resident memory (2.0-2.7 GB after each 2-D brick module, 0.6
    GB trimmed)."""
    gc.collect()
    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    if hasattr(libc, "malloc_trim"):
        libc.malloc_trim(0)


@pytest.fixture(autouse=True, scope="module")
def release_module_memory(request):
    """After a module's tests, clear its cached cases and the shared ones
    here (the functools caches of both namespaces), JAX's compile caches,
    and hand the freed heap back to the system. A test worker runs many
    files in one process (-n 6 --dist loadfile), and without this their
    caches add up: a whole-suite run held 9-16 GB in each of its six workers
    near its end and lost one to the machine's memory."""
    yield
    for namespace in (vars(request.module), globals()):
        for value in list(namespace.values()):
            if callable(getattr(value, "cache_clear", None)):
                value.cache_clear()
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
    release_memory()


@functools.lru_cache(maxsize=None)
def _reference_mesh(geo, nref, p, dim=3):
    import dealii_matrixfree_hanging_nodes_tpu as ref
    from dealii_matrixfree_hanging_nodes_tpu.matrix_free import MatrixFree

    tria = ref.create_geometry(geo, dim, nref)
    return tria, MatrixFree(tria, p, dtype=np.float64)


@functools.lru_cache(maxsize=None)
def reference(geo, nref, p, face_planes=None, dim=3):
    """(tria, mf, BrickLaplaceMM, staged device arrays) of the JAX package;
    face_planes as BrickLaplaceMM takes it (None: on at p <= 2). The
    operators of one mesh share its tria and mf."""
    from dealii_matrixfree_hanging_nodes_tpu.bricks import BrickLaplaceMM

    tria, mf = _reference_mesh(geo, nref, p, dim)
    bl = BrickLaplaceMM(mf, face_planes=face_planes)
    return tria, mf, bl, bl._stage()


@functools.lru_cache(maxsize=None)
def _port_mesh(geo, nref, p, dim=3):
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    tria = mt.create_geometry(geo, dim, nref)
    return tria, mt.MatrixFree(tria, p, dtype=np.float64)


@functools.lru_cache(maxsize=None)
def port(geo, nref, p, face_planes=None, dim=3):
    """(tria, mf, BrickLaplaceMM on the CPU in float64) of the port;
    face_planes as for ``reference``."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    tria, mf = _port_mesh(geo, nref, p, dim)
    return tria, mf, mt.BrickLaplaceMM(mf, device="cpu", face_planes=face_planes)


@functools.lru_cache(maxsize=None)
def port_tables(geo, nref, p, face_planes=None, dim=3):
    """(arrays, meta): the port's host operator tables, ``operator_tables``."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import operator_tables

    _, mf, op = port(geo, nref, p, face_planes, dim)
    return operator_tables(mf, op.bs)


def reference_meta(bl):
    """The reference's static metadata, as ``convert.from_reference`` takes it."""
    return dict(
        _hn_bounds=bl._hn_bounds, _flat_meta=bl._flat_meta, _n_sub=bl._n_sub,
        _n_chainb=bl._n_chainb, _sub_contig=bl._sub_contig,
        _use_masked_removal=bl._use_masked_removal, _plane_meta=bl._plane_meta,
        _plane_levels=getattr(bl, "_plane_levels", []), N3=bl.N3, N3p=bl.N3p,
        slot_idx=bl.slot_idx, _deformed=bl._deformed,
    )


def rng_array(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape)


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


# the GMG tests' levels: quadrant nref 2 -> 3 at p=2 and p=4
GMG_DEGREES = (2, 4)
GMG_COARSE, GMG_FINE = 2, 3


@functools.lru_cache(maxsize=None)
def gmg_levels(p):
    """The reference's and the port's coarse and fine MatrixFree at degree
    p, float64: dict rc, rf (reference), pc, pf (port)."""
    import dealii_matrixfree_hanging_nodes_tpu as ref
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu.matrix_free import MatrixFree

    out = {}
    for key, nref in (("c", GMG_COARSE), ("f", GMG_FINE)):
        out["r" + key] = MatrixFree(ref.create_quadrant(3, nref), p, dtype=np.float64)
        out["p" + key] = mt.MatrixFree(mt.create_quadrant(3, nref), p, dtype=np.float64)
    return out


@functools.lru_cache(maxsize=None)
def gmg_bricks(p):
    """Their brick operators with face_planes=False, as the reference's GMG
    builds them (the port's on the CPU): dict rbc, rbf, pbc, pbf."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt
    from dealii_matrixfree_hanging_nodes_tpu.bricks import BrickLaplaceMM

    lv = gmg_levels(p)
    out = {}
    for key in ("c", "f"):
        out["rb" + key] = BrickLaplaceMM(lv["r" + key], face_planes=False)
        out["pb" + key] = mt.BrickLaplaceMM(lv["p" + key], device="cpu", face_planes=False)
    return out
