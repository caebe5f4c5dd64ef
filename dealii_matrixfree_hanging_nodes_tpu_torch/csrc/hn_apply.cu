// hn_apply: out[r, j] = sum_e w[e] * rows[r, col[e]] over the entries e of output slot j of
// row r's composite hanging-node matrix (ptr[q, j] .. ptr[q, j+1], q = q_of_row[r]), or
// out[r, j] = rows[r, j] where q_of_row[r] < 0 (an identity mask range). The lists hold Q by
// columns for the forward apply (u @ Q, the fill) and by rows for the transposed one
// (u @ Q^T, HN^T); the wrapper passes one set.
//
// Replaces: BrickLaplaceMM._hn_apply (dealii_matrixfree_hanging_nodes_tpu/bricks.py:2244-2258),
//   one dense [n_loc, n_loc] matmul per distinct-mask range of the constrained rows, run on the
//   TPU as XLA MXU matmuls (no Pallas kernel).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (16,744 rows of 125): memory. The rows
//   read once and written once (2 x 8.4 MB) and the lists (a few KB): about 16.8 MB, 5 us at
//   3.35 TB/s. The work is ~389 multiply-adds per row (13 MFLOP), nothing beside the bytes;
//   the dense form the reference runs is 0.52 GFLOP per direction.
//
// Design: one thread per (row, slot), gather only, so each output is written once with no
//   atomics and every entry list is summed in one order. A row's 125-500 inputs are read by
//   its own threads from L1; the lists (25 Q's at nref=7) stay in L1/L2. Reads of rows and
//   writes of out are coalesced across the slots of a row. Any degree and any number of
//   nonzeros per slot: nothing is sized at compile time.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void hn_apply_kernel(const T* __restrict__ rows, const int* __restrict__ q_of_row,
                                const int* __restrict__ ptr, const int* __restrict__ col,
                                const T* __restrict__ w, T* __restrict__ out, int n_hn,
                                int n_loc) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n_hn) * n_loc) return;
  const int r = static_cast<int>(t / n_loc);
  const int j = static_cast<int>(t - static_cast<long long>(r) * n_loc);
  const T* x = rows + static_cast<size_t>(r) * n_loc;
  const int q = q_of_row[r];
  if (q < 0) {
    out[t] = x[j];
    return;
  }
  const int* p = ptr + static_cast<size_t>(q) * (n_loc + 1) + j;
  T acc = T(0);
  for (int e = p[0]; e < p[1]; ++e) acc += w[e] * x[col[e]];
  out[t] = acc;
}

template <typename T>
int launch(const void* rows, const void* q, const void* ptr, const void* col, const void* w,
           void* out, int n_hn, int n_loc, cudaStream_t stream) {
  const long long total = static_cast<long long>(n_hn) * n_loc;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
    hn_apply_kernel<T><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(rows), static_cast<const int*>(q), static_cast<const int*>(ptr),
        static_cast<const int*>(col), static_cast<const T*>(w), static_cast<T*>(out), n_hn,
        n_loc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hn_apply_f32(const void* rows, const void* q, const void* ptr, const void* col,
                 const void* w, void* out, int n_hn, int n_loc, void* stream) {
  return launch<float>(rows, q, ptr, col, w, out, n_hn, n_loc, static_cast<cudaStream_t>(stream));
}

int hn_apply_f64(const void* rows, const void* q, const void* ptr, const void* col,
                 const void* w, void* out, int n_hn, int n_loc, void* stream) {
  return launch<double>(rows, q, ptr, col, w, out, n_hn, n_loc,
                        static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
