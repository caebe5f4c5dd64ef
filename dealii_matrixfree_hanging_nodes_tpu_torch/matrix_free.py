"""MatrixFree data structure and cell loop (capabilities C4-C7), the port of
``dealii_matrixfree_hanging_nodes_tpu.matrix_free.MatrixFree``.

Setup (NumPy) turns (Triangulation, degree) into the tables ``_np``, in the
reference's keys and order: the fast per-cell DoF map (hanging slots
replaced by coarse masters), the plain one, compressed constraint masks,
geometry factors (Cartesian, or the deformed metric), the 1-D shape
matrices and the slow-path constraint CSR. The brick operator reads only
the masks and the Cartesian geometry; every table that only the index
engine reads (the DoF maps under ``categorize``, the deformed metric, the
slow CSR) is built at its first use; the deformed metric on the device of
its first user (``deformed_metric``: in PyTorch on the card for a card
operator, in NumPy on the host otherwise) and kept on the host. ``_sources`` holds what the device
tables are staged from beyond ``_np``: the float64 sources of the floating
tables and the kernels' own tables (the transposed DoF maps, the constraint
tables by destination, the ``matrix`` runner's composite Q's), also built at
first use.

The engine runs 3-D and 2-D meshes (``dim`` from the triangulation): a 2-D
cell holds (p+1)^2 values, its mask sub bits 0-1 and face bits 2-3 and no
edge bits, its Cartesian geo [n_cells, 2] and its deformed metric [n_cells,
n_q, 3] (xx, xy, yy); each kernel reads the dimension from its rows' width
(n_loc = (p+1)^dim) and checks geo's whole shape against it.

Execution (the index engine) runs on the device of the tensor it is given,
with the tables staged there once and cached per device and type (``_on``).
It never writes its input. On the card every step is a hand-written kernel:

- ``cell_loop`` with a cell kernel that has a ``fused`` method (the Laplace
  cell kernel of ``models.laplace``): ``cell_laplace`` (gather, HN,
  quadrature, HN^T in one launch) then ``dof_scatter``: 2 launches; the slow
  path adds ``constraints_slow`` before and after: 4;
- ``apply_hanging_node_constraints``: a copy, then ``hn_interp`` in place on
  it with the chosen runner's rows;
- any other cell kernel: read (``cell_laplace`` without quadrature), the
  callable, then the transposed interpolation (``cell_laplace``) and
  ``dof_scatter``.

The runners (``hn_mode``): "compact" (the constrained rows by list),
"all" (every row, by its mask), "sorted" (the mask-sorted tail; forces
``categorize``, a stable sort of the cells by mask), "matrix" (one composite
Q per distinct mask) choose the rows of ``hn_interp``. They compute one
function, so inside ``cell_laplace`` every runner's cells interpolate by
their own masks: the four runners share one vmult kernel.
"""

from __future__ import annotations

import functools
from collections.abc import Mapping

import numpy as np
import torch

from .constraints import build_constraints
from .dof_handler import DoFHandler
from .elements import shape_info
from .kernels import cell_laplace, constraints_slow, dof_scatter, hn_interp
from .kernels._even_odd import factor_tables
from .mapping import cartesian_laplace_factors, deformed_laplace_factors
from .mesh import Triangulation
from .ops.hanging_nodes import hn_composite_matrix

__all__ = ["MatrixFree", "HostTables", "resolve_device", "HN_MODES"]

HN_MODES = ("compact", "all", "sorted", "matrix")
TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def resolve_device(device=None) -> torch.device:
    """The port runs on the card unless the caller asks for another device:
    device=None means CUDA and raises where no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class HostTables(Mapping):
    """The NumPy tables, in insertion order; a value given as a
    zero-argument callable is built at its first access and kept."""

    def __init__(self, **items):
        self._items = items

    def __getitem__(self, key):
        value = self._items[key]
        if callable(value):
            value = self._items[key] = value()
        return value

    def __iter__(self):
        return iter(self._items)

    def __len__(self):
        return len(self._items)


class MatrixFree:
    def __init__(self, tria: Triangulation, degree: int, dtype=np.float64,
                 hn_mode: str = "compact", categorize: bool = False,
                 high_order_mapping: bool = False):
        if hn_mode not in HN_MODES:
            raise ValueError(f"unknown hn_mode {hn_mode!r}")
        if hn_mode == "sorted":
            categorize = True
        self.tria = tria
        self.degree = degree
        self.dim = tria.dim
        self.dtype = np.dtype(dtype)
        self.hn_mode = hn_mode
        self.categorize = bool(categorize)
        self.high_order_mapping = bool(high_order_mapping)
        self._metric = None  # the deformed metric, built by its first user (deformed_metric)
        self.shape = shape_info(degree)
        self.dof_handler = DoFHandler(tria, degree)
        self.constraints = ci = build_constraints(self.dof_handler)
        self.n_dofs = self.dof_handler.n_dofs
        self.n_cells = tria.n_active_cells

        masks = ci.masks.astype(np.int32)
        self.cell_permutation = np.arange(self.n_cells)
        if self.categorize:
            # stable sort by mask: unconstrained cells (mask 0) first, then
            # groups of identical masks
            self.cell_permutation = np.argsort(masks, kind="stable")
            masks = masks[self.cell_permutation]
        perm = self._permute
        sh = self.shape

        def geo64():
            if self.high_order_mapping:
                return self.deformed_metric()
            return perm(cartesian_laplace_factors(tria))

        def slow():
            return dict(
                slave=ci.slave_dofs.astype(np.int32),
                row=np.repeat(np.arange(len(ci.slave_dofs), dtype=np.int32),
                              np.diff(ci.row_ptr)),
                col=ci.col.astype(np.int32),
                w=ci.weight.astype(self.dtype),
            )

        # float64 sources of the floating tables: the device tables of any
        # type are cast from these
        f64 = dict(geo=geo64, S=sh.S, D=sh.D, Dc=sh.Dc, P=sh.P,
                   quad_w=lambda: sh.quad_weights_tensor(self.dim), w=lambda: ci.weight)
        self._set_sources(f64)
        f = lambda key: lambda: np.asarray(self._sources[key]).astype(self.dtype)
        hn_idx = np.nonzero(masks != 0)[0]

        def dof_map(cell_dofs):
            def build():
                if self.n_dofs >= 2**31:
                    raise NotImplementedError("the index engine's DoF maps exceed int32")
                return perm(np.asarray(cell_dofs, dtype=np.int32))
            return build

        # the Cartesian factors are eager: the brick operator reads them
        self._np = HostTables(
            dofmap=dof_map(ci.cell_dofs_fast),
            dofmap_plain=dof_map(self.dof_handler.cell_dofs),
            masks=masks,
            hn_idx=hn_idx.astype(np.int32),
            hn_masks=masks[hn_idx],
            geo=f("geo") if self.high_order_mapping else f("geo")(),
            S=f("S"), D=f("D"), Dc=f("Dc"), P=f("P"), quad_w=f("quad_w"),
            slow=slow,
        )
        self._setup_execution()

    @classmethod
    def from_tables(cls, np_tables: Mapping, n_dofs: int, hn_mode: str = "compact",
                    categorize: bool = False, cell_permutation=None) -> "MatrixFree":
        """The index engine from host tables alone (the reference's
        ``MatrixFree._np`` layout, NumPy) and the reference's ``n_dofs``,
        ``categorize`` and ``cell_permutation`` (None: the identity): its
        execution side works (cell loop, runners, slow path); the mesh, the
        DoF handler and the constraint object are absent. Cells stay in the
        tables' order (a categorized reference's tables are permuted
        already). The tables are checked against n_dofs and categorize."""
        if hn_mode not in HN_MODES:
            raise ValueError(f"unknown hn_mode {hn_mode!r}")
        self = cls.__new__(cls)
        t = HostTables(**{k: np_tables[k] for k in np_tables})
        self.tria = self.dof_handler = self.constraints = self.shape = None
        self.degree = np.asarray(t["S"]).shape[1] - 1
        n_loc = np.asarray(t["dofmap"]).shape[1]
        self.dim = next(d for d in (1, 2, 3) if (self.degree + 1) ** d == n_loc)
        self.dtype = np.asarray(t["geo"]).dtype
        self.hn_mode = hn_mode
        self.categorize = bool(categorize) or hn_mode == "sorted"
        self.high_order_mapping = np.asarray(t["geo"]).ndim == 3
        self._metric = np.asarray(t["geo"], dtype=np.float64) if self.high_order_mapping else None
        self.n_cells = np.asarray(t["dofmap"]).shape[0]
        self.n_dofs = int(n_dofs)
        plain = np.asarray(t["dofmap_plain"])
        if plain.size and (plain.min() != 0 or plain.max() + 1 != self.n_dofs):
            raise ValueError(f"dofmap_plain names DoFs {plain.min()} .. {plain.max()}, not "
                             f"0 .. n_dofs-1 = {self.n_dofs - 1}")
        fast = np.asarray(t["dofmap"])
        if fast.size and (fast.min() < 0 or fast.max() >= self.n_dofs):
            raise ValueError("dofmap names DoFs outside 0 .. n_dofs-1")
        geo = np.asarray(t["geo"])
        n, dim = self.degree + 1, self.dim
        if geo.shape not in ((self.n_cells, dim), (self.n_cells, n**dim, dim * (dim + 1) // 2)):
            raise ValueError(f"geo {geo.shape} is neither the Cartesian factors nor the packed "
                             f"metric of {self.n_cells} dim={dim} cells")
        masks = np.asarray(t["masks"])
        mask_bits = 9 if dim == 3 else 4  # sub, face (and in 3-D edge) bits
        if masks.size and (masks.min() < 0 or masks.max() >= 1 << mask_bits):
            raise ValueError(f"masks hold bits past a dim={dim} mask's {mask_bits}")
        if self.categorize and np.any(np.diff(np.asarray(t["masks"])) < 0):
            raise ValueError("categorize: the tables' masks are not sorted")
        perm = (np.arange(self.n_cells) if cell_permutation is None
                else np.asarray(cell_permutation))
        if not np.array_equal(np.sort(perm), np.arange(self.n_cells)) or (
                not self.categorize and np.any(perm != np.arange(self.n_cells))):
            raise ValueError("cell_permutation is not a permutation of the cells (or not the "
                             "identity without categorize)")
        self.cell_permutation = perm
        self._np = t
        f64 = {k: (lambda k=k: np.asarray(t[k], dtype=np.float64))
               for k in ("geo", "S", "D", "Dc", "P", "quad_w")}
        f64["w"] = lambda: np.asarray(t["slow"]["w"], dtype=np.float64)
        self._set_sources(f64)
        self._setup_execution()
        return self

    def _permute(self, a):
        return a[self.cell_permutation] if self.categorize else a

    def deformed_metric(self, device=None) -> np.ndarray:
        """The deformed mapping's metric, float64 [n_cells, n_q, dim (dim+1)
        / 2] on the host in the cells' order, built at the first call
        (``mapping.deformed_laplace_factors``): on a CUDA device in PyTorch
        there, else in NumPy on the host. The operators call it with their
        device before they stage the metric, so a card operator's metric is
        computed on the card."""
        if self._metric is None:
            if not self.high_order_mapping:
                raise ValueError("deformed_metric: the MatrixFree has no deformed mapping")
            dev = None if device is None or torch.device(device).type == "cpu" else device
            self._metric = self._permute(deformed_laplace_factors(self.tria, self.shape,
                                                                  device=dev))
        return self._metric

    def _set_sources(self, f64: dict):
        """``_sources``: f64, the float64 sources of the floating tables, and
        the kernels' own tables, all built at first use."""
        self._sources = HostTables(
            **f64,
            scatter=lambda: dof_scatter.transpose_map(self._np["dofmap"], self.n_dofs),
            scatter_plain=lambda: dof_scatter.transpose_map(self._np["dofmap_plain"],
                                                            self.n_dofs),
            constraints_slow=self._slow_tables,
            matrix=self._matrix_tables,
        )

    def _setup_execution(self):
        hn_idx = np.asarray(self._np["hn_idx"])
        self.n_hn_cells = len(hn_idx)
        self._first_hn = int(hn_idx[0]) if len(hn_idx) else self.n_cells
        self._device = {}  # (key, device, dtype) -> staged table, or a device_tables view

    # ------------------------------------------------------------ host tables
    def _slow_tables(self):
        s = self._np["slow"]
        n_s = len(s["slave"])
        row = np.asarray(s["row"], dtype=np.int64)
        if np.any(np.diff(row) < 0):
            raise ValueError("slow CSR entries must be sorted by row")
        row_ptr = np.zeros(n_s + 1, dtype=np.int64)
        np.cumsum(np.bincount(row, minlength=n_s), out=row_ptr[1:])
        return constraints_slow.tables(s["slave"], row_ptr, s["col"], self._sources["w"],
                                       self.n_dofs)

    def _matrix_tables(self):
        """The matrix runner's tables: Q [nQ, n_loc, n_loc], one per distinct
        mask of the constrained cells, with forward(u) = u @ Q
        (``hn_composite_matrix``), and each constrained cell's group (in
        hn_idx order). The reference's split into large groups and a padded
        batch of small ones is an MXU workaround and is not ported."""
        hn_masks = np.asarray(self._np["hn_masks"])
        uniq, group = np.unique(hn_masks, return_inverse=True)
        n_loc = (self.degree + 1) ** self.dim
        Q = np.stack([hn_composite_matrix(int(m), self._sources["P"], self.dim) for m in uniq]
                     ) if len(uniq) else np.zeros((0, n_loc, n_loc))
        return dict(Q=Q, hn_group=group.astype(np.int32))

    # ------------------------------------------------------------ device tables
    def _stage(self, a, device, dtype):
        """A host table on device (a tuple or dict entry by entry; None and
        flags as they are), floating arrays in dtype."""
        if a is None or isinstance(a, bool):
            return a
        if isinstance(a, tuple):
            return tuple(self._stage(x, device, dtype) for x in a)
        if isinstance(a, Mapping):
            return {k: self._stage(x, device, dtype) for k, x in a.items()}
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a)
        return t.to(device, dtype) if a.dtype.kind == "f" else t.to(device)

    def _on(self, key, device, dtype=None):
        """Table `key` on device, floating ones in dtype, staged once from
        ``_sources[key]`` (else ``_np[key]``)."""
        ck = (key, str(device), dtype)
        if ck not in self._device:
            if key == "geo" and self.high_order_mapping:
                self.deformed_metric(device)
            source = self._sources[key] if key in self._sources else self._np[key]
            self._device[ck] = self._stage(source, device, dtype)
        return self._device[ck]

    def device_tables(self, device, dtype) -> Mapping:
        """Every ``_np`` table on device (floating ones in dtype), staged at
        first access: the argument ``a`` of a cell kernel. One view per
        device and type."""
        ck = (None, str(device), dtype)
        if ck not in self._device:
            self._device[ck] = HostTables(**{k: (lambda k=k: self._on(k, device, dtype))
                                             for k in self._np})
        return self._device[ck]

    def check_input(self, x):
        """(device, dtype) of an index-engine input; raises for a dim other
        than 2 or 3 and a type other than float32 or float64."""
        if self.dim not in (2, 3):
            raise NotImplementedError("the port's index engine supports dim=2 and dim=3")
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the index engine takes float32 or float64, got {x.dtype}")
        return x.device, x.dtype

    def _masks(self, device):
        """cell_laplace's codes, every runner's: each cell's mask (None
        without constrained cells)."""
        return self._on("masks", device) if self.n_hn_cells else None

    def _dofmap(self, slow, device):
        return self._on("dofmap_plain" if slow else "dofmap", device)

    @staticmethod
    def _fn(mod, plain):
        return getattr(mod, f"{mod.NAME}_plain" if plain else mod.NAME)

    # ------------------------------------------------------------ execution
    def initialize_dof_vector(self, fill=0.0, device=None) -> torch.Tensor:
        return torch.full((self.n_dofs,), fill, dtype=TORCH_DTYPES[self.dtype],
                          device=resolve_device(device))

    def hn_interp_args(self, device, dtype) -> dict:
        """hn_interp's keyword arguments (codes, P, rows, first, Q) for
        the runner of ``hn_mode``: all (every row, its mask), sorted (the
        tail from the first constrained row), compact (hn_idx and its masks),
        matrix (hn_idx, each one's group and the Q table)."""
        P = self._on("P", device, dtype)
        if self.hn_mode == "all":
            return dict(codes=self._on("masks", device), P=P)
        if self.hn_mode == "sorted":
            return dict(codes=self._on("masks", device)[self._first_hn:], P=P,
                        first=self._first_hn)
        if self.hn_mode == "compact":
            return dict(codes=self._on("hn_masks", device), P=P, rows=self._on("hn_idx", device))
        m = self._on("matrix", device, dtype)
        return dict(codes=m["hn_group"], P=P, rows=self._on("hn_idx", device), Q=m["Q"])

    def apply_hanging_node_constraints(self, u: torch.Tensor, transpose: bool,
                                       plain: bool = False) -> torch.Tensor:
        """The HN interpolation on cell rows [n_cells, n_loc] by the runner
        of ``hn_mode``: a new tensor (u itself without constrained cells).
        plain=True runs the kernel's plain version on u's device."""
        dev, dt = self.check_input(u)
        if self.n_hn_cells == 0:
            return u
        return self._fn(hn_interp, plain)(u.clone(), transpose=transpose,
                                          **self.hn_interp_args(dev, dt))

    def slow_tables(self, device, dtype) -> dict:
        """constraints_slow's arguments after the vector, by mode
        ("distribute", "compress")."""
        return self._on("constraints_slow", device, dtype)

    def scatter_tables(self, slow: bool, device):
        """dof_scatter's (ptr, ent, sched) for the plain (slow) or the fast DoF
        map."""
        return self._on("scatter_plain" if slow else "scatter", device)

    @functools.cached_property
    def kernel_factors(self):
        """The launch parameters (``factors``) of cell_laplace and of
        cell_elasticity's index mode: the even-odd tables of S, D = Dc S and
        their transposes, float64 NumPy, built once from the float64
        sources."""
        return factor_tables(self._sources["S"], self._sources["Dc"])

    def cell_laplace_args(self, device, dtype, slow: bool = False, hn: bool = True):
        """cell_laplace's positional arguments after src for the cell loop:
        the DoF map (plain when slow), the masks (hn and not slow), P, S, Dc,
        quad_w, geo."""
        codes = self._masks(device) if hn and not slow else None
        on = lambda key: self._on(key, device, dtype)
        return (self._dofmap(slow, device), codes, on("P"), on("S"), on("Dc"), on("quad_w"),
                on("geo"))

    def distribute_slow(self, src: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """u[slave] <- sum w * u[master] (AffineConstraints::distribute)."""
        dev, dt = self.check_input(src)
        if len(self._np["slow"]["slave"]) == 0:
            return src
        return self._fn(constraints_slow, plain)(src, *self.slow_tables(dev, dt)["distribute"])

    def compress_slow(self, dst: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """Fold slave rows into masters (C^T), zeroing slave entries."""
        dev, dt = self.check_input(dst)
        if len(self._np["slow"]["slave"]) == 0:
            return dst
        return self._fn(constraints_slow, plain)(dst, *self.slow_tables(dev, dt)["compress"])

    def _read(self, src, slow, hn, plain):
        dev, dt = self.check_input(src)
        return self._fn(cell_laplace, plain)(
            src, self._dofmap(slow, dev), self._masks(dev) if hn else None,
            self._on("P", dev, dt), None, None, None, None, hn_in=True, quad=False, hn_out=False)

    def read_dof_values_plain(self, src: torch.Tensor, slow: bool = False,
                              plain: bool = False) -> torch.Tensor:
        return self._read(src, slow, False, plain)

    def read_dof_values(self, src: torch.Tensor, slow: bool = False,
                        plain: bool = False) -> torch.Tensor:
        if slow:
            return self._read(self.distribute_slow(src, plain), True, False, plain)
        return self._read(src, False, True, plain)

    def _scatter(self, u, slow, plain):
        dev, _ = self.check_input(u)
        return self._fn(dof_scatter, plain)(u, *self.scatter_tables(slow, dev))

    def distribute_local_to_global_plain(self, u: torch.Tensor, slow: bool = False,
                                         plain: bool = False) -> torch.Tensor:
        return self._scatter(u, slow, plain)

    def distribute_local_to_global(self, u: torch.Tensor, slow: bool = False,
                                   plain: bool = False) -> torch.Tensor:
        if slow:
            return self.compress_slow(self._scatter(u, True, plain), plain)
        dev, dt = self.check_input(u)
        codes = self._masks(dev)
        if codes is not None:
            u = self._fn(cell_laplace, plain)(
                u, None, codes, self._on("P", dev, dt), None, None, None, None,
                hn_in=False, quad=False, hn_out=True)
        return self._scatter(u, False, plain)

    def cell_loop(self, cell_kernel, src: torch.Tensor, *, constraints: bool = True,
                  slow: bool = False, plain: bool = False) -> torch.Tensor:
        """dst = scatter(kernel(gather(src))). A cell kernel with a
        ``fused`` method (the Laplace cell kernel of ``models.laplace``) runs
        the whole loop itself: ``cell_kernel.fused(self, src, constraints=,
        slow=, plain=)``. Any other callable ``cell_kernel(rows, a)`` (``a``:
        the device tables) runs between read_dof_values and
        distribute_local_to_global. plain=True runs the kernels' plain
        versions on src's device."""
        fused = getattr(cell_kernel, "fused", None)
        if fused is not None:
            return fused(self, src, constraints=constraints, slow=slow, plain=plain)
        dev, dt = self.check_input(src)
        if constraints:
            u = self.read_dof_values(src, slow=slow, plain=plain)
        else:
            u = self.read_dof_values_plain(src, slow=slow, plain=plain)
        v = cell_kernel(u, self.device_tables(dev, dt))
        if constraints:
            return self.distribute_local_to_global(v, slow=slow, plain=plain)
        return self.distribute_local_to_global_plain(v, slow=slow, plain=plain)
