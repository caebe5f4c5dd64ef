// cols_overlap_add: v[b, node] += sum over the cells of brick b that hold `node` of
// cols[b * B^3 + slot, j], in place on v [m, N3p] (the first m bricks of the vector),
// cols [m * B^3, n_loc], n_loc = (p+1)^3, NB = B*p + 1.
//
// Replaces: BrickLaplaceMM._scatter_cols / _col2im_sep, the im2col adjoint
//   (dealii_matrixfree_hanging_nodes_tpu/bricks.py:2196-2241), and the merge of the result into
//   the leading subset slice v.at[:n_sub].add(corr) (bricks.py:2082-2083, 2553-2559). The TPU
//   side ran it as a one-hot matmul (no Pallas kernel).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (1,025 subset bricks): memory. cols is
//   read once (32.8 MB) and the subset's nodes are read and written once (2 x 20.1 MB):
//   73 MB, 22 us at 3.35 TB/s. One add per cols entry (8.2 MFLOP) is negligible.
//
// Design: gather form, one thread per brick node, no atomics. Along each axis a node
//   coordinate c belongs to one cell (c inside a cell: cell c/p, local c%p) or, on an
//   interior cell boundary (c % p == 0), to two (cell c/p - 1 at local p, cell c/p at
//   local 0); the node's contributions are the product of the three axes' lists, 1 to 8
//   terms, summed in a fixed order, so the result is deterministic. Neighbouring threads
//   take neighbouring x, so the v accesses are coalesced; the cols reads of a warp fall in a
//   few rows of cols.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int cells_of(int c, int B, int p, int NB, int* cell, int* loc) {
  if (c == 0) {
    cell[0] = 0;
    loc[0] = 0;
    return 1;
  }
  if (c == NB - 1) {
    cell[0] = B - 1;
    loc[0] = p;
    return 1;
  }
  const int q = c / p, r = c - q * p;
  if (r == 0) {
    cell[0] = q - 1;
    loc[0] = p;
    cell[1] = q;
    loc[1] = 0;
    return 2;
  }
  cell[0] = q;
  loc[0] = r;
  return 1;
}

template <typename T>
__global__ void cols_overlap_add_kernel(T* __restrict__ v, const T* __restrict__ cols,
                                        int m, int B, int p, int N3p) {
  const int NB = B * p + 1;
  const int N3 = NB * NB * NB;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(m) * N3) return;
  const int brick = static_cast<int>(t / N3);
  const int node = static_cast<int>(t - static_cast<long long>(brick) * N3);
  const int x = node % NB, y = (node / NB) % NB, z = node / (NB * NB);
  const int n = p + 1;
  const int n_loc = n * n * n;
  const int C = B * B * B;
  int cx[2], lx[2], cy[2], ly[2], cz[2], lz[2];
  const int nx = cells_of(x, B, p, NB, cx, lx);
  const int ny = cells_of(y, B, p, NB, cy, ly);
  const int nz = cells_of(z, B, p, NB, cz, lz);
  const T* cb = cols + static_cast<size_t>(brick) * C * n_loc;
  T sum = T(0);
  for (int a = 0; a < nz; ++a)
    for (int b = 0; b < ny; ++b)
      for (int c = 0; c < nx; ++c) {
        const int slot = (cz[a] * B + cy[b]) * B + cx[c];
        const int j = (lz[a] * n + ly[b]) * n + lx[c];
        sum += cb[static_cast<size_t>(slot) * n_loc + j];
      }
  v[static_cast<size_t>(brick) * N3p + node] += sum;
}

template <typename T>
int launch(void* v, const void* cols, int m, int B, int p, int N3p, cudaStream_t stream) {
  const int NB = B * p + 1;
  const long long total = static_cast<long long>(m) * NB * NB * NB;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
    cols_overlap_add_kernel<T><<<blocks, threads, 0, stream>>>(
        static_cast<T*>(v), static_cast<const T*>(cols), m, B, p, N3p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cols_overlap_add_f32(void* v, const void* cols, int m, int B, int p, int N3p,
                         void* stream) {
  return launch<float>(v, cols, m, B, p, N3p, static_cast<cudaStream_t>(stream));
}

int cols_overlap_add_f64(void* v, const void* cols, int m, int B, int p, int N3p,
                         void* stream) {
  return launch<double>(v, cols, m, B, p, N3p, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
