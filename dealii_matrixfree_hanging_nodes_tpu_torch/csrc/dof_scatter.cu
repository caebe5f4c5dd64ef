// dof_scatter: the index engine's scatter-add of cell rows into a global vector, by destination.
// With the transposed DoF map (ptr [n_dofs+1] into ent, the flat (cell, slot) positions of each
// DoF in ascending order), every DoF i gets
//   dst[i] = sum of rows[ent[e]] over e = ptr[i] .. ptr[i+1]    (0 where the range is empty).
// With a component axis (K = 2 or 3: rows [K, n_cells, n_loc], component-major, as
// cell_elasticity writes them in 2-D and 3-D), dst is [n_dofs, K], DoF-major, the reference's
// layout of a displacement:
//   dst[i, c] = sum of rows[c][ent[e]] over the same entries,
// so the transpose back from component-major rides the scatter. Each component's sum runs in the
// scalar kernel's order: a component is bit-identical to a scalar call on rows[c].
//
// Replaces: MatrixFree.distribute_local_to_global(_plain) (dealii_matrixfree_hanging_nodes_tpu/
//   matrix_free.py:281-297): `zeros(n_dofs).at[dofmap.reshape(-1)].add(rows.reshape(-1))`, an
//   XLA scatter-add with repeated ids on the TPU (no Pallas kernel); with K = 2, 3 the K such
//   scatters and the stack of ElasticityOperator._vmult (models/elasticity.py:92-98).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (dof_scatter.bytes_and_flops): memory. The
//   rows (269,991 x 125, 135 MB) read once, one int32 DoF index an entry (33.7 M, 135 MB; the
//   DoF map's size) read once, dst (17.55 M DoFs, 70 MB) written once: 340 MB, 0.10 ms at
//   3.35 TB/s; one add an entry. ptr (70 MB) is left out: only this layout needs it. At 2-D
//   quadrant nref=11 p=4 f32 (1,051,669 cells of 25 values, 16.84 M DoFs), the same count:
//   105 MB of rows, 105 MB of indices, 67 MB of dst, 0.083 ms; with K = 2 (2-D elasticity)
//   the rows and dst twice: 0.13 ms.
//
// Design: one owner thread a DoF sums its entries in the fixed ascending order and writes once:
//   no atomics, no memset (a DoF with no entry, a hanging DoF under the fast map, writes 0), and
//   two calls give bit-identical results. Neighbouring threads read neighbouring ranges of ent
//   (DoFs are numbered cell by cell, so their entries sit close); the row values are a gather.
//   Fusing this scatter into cell_laplace needs a coloring of the cells or atomics (not done).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
dof_scatter_kernel(const T* __restrict__ rows, const int* __restrict__ ptr,
                   const int* __restrict__ ent, T* __restrict__ dst, int n_dofs,
                   long long cstride) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_dofs) return;
  const int e1 = __ldg(ptr + i + 1);
  T acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = T(0);
  for (int e = __ldg(ptr + i); e < e1; ++e) {
    const int s = __ldg(ent + e);
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] += __ldg(rows + c * cstride + s);
  }
#pragma unroll
  for (int c = 0; c < K; ++c) dst[static_cast<size_t>(i) * K + c] = acc[c];
}

template <typename T, int K>
int launch(const void* rows, const void* ptr, const void* ent, void* dst, int n_dofs,
           long long cstride, cudaStream_t stream) {
  if (n_dofs > 0) {
    dof_scatter_kernel<T, K><<<(n_dofs + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        static_cast<const T*>(rows), static_cast<const int*>(ptr), static_cast<const int*>(ent),
        static_cast<T*>(dst), n_dofs, cstride);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* rows, const void* ptr, const void* ent, void* dst, int n_dofs, int k,
             long long cstride, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (k == 1) return launch<T, 1>(rows, ptr, ent, dst, n_dofs, cstride, s);
  if (k == 2) return launch<T, 2>(rows, ptr, ent, dst, n_dofs, cstride, s);
  if (k == 3) return launch<T, 3>(rows, ptr, ent, dst, n_dofs, cstride, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// k components of rows, cstride values apart (k = 1, 2 or 3); dst [n_dofs, k]
int dof_scatter_f32(const void* rows, const void* ptr, const void* ent, void* dst, int n_dofs,
                    int k, long long cstride, void* stream) {
  return dispatch<float>(rows, ptr, ent, dst, n_dofs, k, cstride, stream);
}

int dof_scatter_f64(const void* rows, const void* ptr, const void* ent, void* dst, int n_dofs,
                    int k, long long cstride, void* stream) {
  return dispatch<double>(rows, ptr, ent, dst, n_dofs, k, cstride, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
