"""Shared cases for the PyTorch port's tests: the same mesh set up by the
JAX package (the reference) and by the port, in float64 on the CPU, built
once per test process."""

import functools

import numpy as np

# (geometry, n_refinements, degree): p=4 with B=4 bricks, p=5,6 with B=2
CASES = [
    ("quadrant", 3, 4),
    ("quadrant", 4, 4),
    ("step", 3, 4),
    ("quadrant", 2, 5),
    ("quadrant", 2, 6),
]
IDS = [f"{g}-{n}-p{p}" for g, n, p in CASES]
RTOL = 1e-12


@functools.lru_cache(maxsize=None)
def reference(geo, nref, p):
    """(tria, mf, BrickLaplaceMM, staged device arrays) of the JAX package."""
    import dealii_matrixfree_hanging_nodes_tpu as ref
    from dealii_matrixfree_hanging_nodes_tpu.bricks import BrickLaplaceMM
    from dealii_matrixfree_hanging_nodes_tpu.matrix_free import MatrixFree

    tria = ref.create_geometry(geo, 3, nref)
    mf = MatrixFree(tria, p, dtype=np.float64)
    bl = BrickLaplaceMM(mf)
    return tria, mf, bl, bl._stage()


@functools.lru_cache(maxsize=None)
def port(geo, nref, p):
    """(tria, mf, BrickLaplaceMM on the CPU in float64) of the port."""
    import dealii_matrixfree_hanging_nodes_tpu_torch as mt

    tria = mt.create_geometry(geo, 3, nref)
    mf = mt.MatrixFree(tria, p, dtype=np.float64)
    return tria, mf, mt.BrickLaplaceMM(mf, device="cpu")


@functools.lru_cache(maxsize=None)
def port_tables(geo, nref, p):
    """(arrays, meta): the port's host operator tables, ``operator_tables``."""
    from dealii_matrixfree_hanging_nodes_tpu_torch.bricks import operator_tables

    _, mf, op = port(geo, nref, p)
    return operator_tables(mf, op.bs)


def reference_meta(bl):
    """The reference's static metadata, as ``convert.from_reference`` takes it."""
    return dict(
        _hn_bounds=bl._hn_bounds, _flat_meta=bl._flat_meta, _n_sub=bl._n_sub,
        _n_chainb=bl._n_chainb, _sub_contig=bl._sub_contig, N3=bl.N3,
        N3p=bl.N3p, slot_idx=bl.slot_idx,
    )


def rng_array(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape)


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))
