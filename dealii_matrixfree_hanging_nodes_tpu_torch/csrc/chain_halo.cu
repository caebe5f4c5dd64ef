// chain_halo: the hanging-node fold and fill chains of the distributed brick engine on its chain
// buffer ([N+1] rows of n_loc values, flat), one launch for all levels. The chain is linear, so
// the host composes its levels (per level: save the level's rows times their keep mask, add the
// fine rows times T into the coarse rows -- or, filling, zero the level's rows first and add
// the coarse rows times T^T into the fine rows -- restore) into one map M on the flat buffer,
// written by destination:
//   out[i] = sum of w[e] * x[src[e]] over e = ptr[i] .. ptr[i+1],
// every position one row of M: an untouched value is its own one entry of weight 1, a zeroed one
// has none. The same kernel runs the fold (finest level first) and the fill (coarsest first),
// on the halo exchange's need buffer with its per-rank tables or on the replicated exchange's
// gathered buffer with the replicated tables; the mode is the table set.
//
// Replaces: DistributedBrickLaplace._chain_fold_halo and _chain_fill_halo
//   (dealii_matrixfree_hanging_nodes_tpu/parallel/bricks_distributed.py:955-997: per level a
//   take, a batched einsum with the T stacks, a scatter-add and the level-zero set) and the
//   replicated exchange's per-level folds and fills in its step (:1061-1092, :1145-1162); XLA
//   on the TPU (no Pallas kernel).
//
// Bound on an H100 SXM: memory. x read once (the values the entries name), the lists read once,
//   out written once; two flops an entry.
//
// Design: one thread a buffer value, blocks of 256 consecutive values (coalesced ptr reads and
//   out writes); it sums its row's entries in list order (ascending source): no atomics, two
//   calls give the same bits. Out of place, so a level's reads never see its own writes.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
chain_halo_kernel(const T* __restrict__ x, const int* __restrict__ ptr,
                  const int* __restrict__ src, const T* __restrict__ w, T* __restrict__ out,
                  int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int e1 = ptr[i + 1];
  T acc = T(0);
  for (int e = ptr[i]; e < e1; ++e) acc += w[e] * __ldg(x + src[e]);
  out[i] = acc;
}

template <typename T>
int launch(const void* x, const void* ptr, const void* src, const void* w, void* out, int n,
           cudaStream_t stream) {
  if (n > 0) {
    chain_halo_kernel<T><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int*>(ptr), static_cast<const int*>(src),
        static_cast<const T*>(w), static_cast<T*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [n], ptr int32 [n+1], src int32, w -> out [n]
int chain_halo_f32(const void* x, const void* ptr, const void* src, const void* w, void* out,
                   int n, void* stream) {
  return launch<float>(x, ptr, src, w, out, n, static_cast<cudaStream_t>(stream));
}

int chain_halo_f64(const void* x, const void* ptr, const void* src, const void* w, void* out,
                   int n, void* stream) {
  return launch<double>(x, ptr, src, w, out, n, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
