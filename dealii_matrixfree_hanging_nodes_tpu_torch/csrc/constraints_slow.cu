// constraints_slow: the index engine's constraint CSR on a global vector (the slow path), by
// destination, out a new vector. With base(i) = (i in zero_bits ? 0 : x[i]):
//   out[i]          = base(i)                                              (i not a target)
//   out[targets[k]] = (accumulate ? base(targets[k]) : 0)
//                     + sum of w[e] * x[idx[e]] over e = ptr[k] .. ptr[k+1]   (in order)
// reading the original x throughout. distribute: targets the slaves, idx their masters, no
// zero bits, accumulate off (u[slave] <- sum w u[master]). compress: targets the masters, idx
// the slave of each entry, zero_bits the slaves, accumulate on (C^T with the slaves zeroed; a
// master that is also a slave starts from 0, as the reference's set-then-add gives).
//
// Replaces: MatrixFree.distribute_slow and compress_slow (dealii_matrixfree_hanging_nodes_tpu/
//   matrix_free.py:251-268): a segment_sum and `.at[slave].set` (distribute), `.at[slave].set(0)`
//   and `.at[col].add` with repeated ids (compress), XLA on the TPU (no Pallas kernel).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (constraints_slow.bytes_and_flops): memory.
//   x read once and out written once (17.55 M DoFs: 140 MB), the tables read once (4.39 M
//   entries: index and weight, 35 MB; targets, ptr and two bit tables): ~0.055 ms at 3.35 TB/s.
//
// Design: one launch, two kinds of thread. Threads 0 .. n-1 copy (or zero) every DoF that is not
//   a target, which a bit table says (1 bit a DoF, 2.2 MB at nref=7, in place of an int per DoF);
//   threads n .. n + n_targets - 1 own one target each and sum its entries in ascending order.
//   No two threads write one value: no atomics, bit-identical results from call to call.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
struct Args {
  const T* x;
  const int* targets;
  const int* ptr;
  const int* idx;
  const T* w;
  const int* target_bits;
  const int* zero_bits;  // may be null
  T* out;
};

__device__ __forceinline__ bool bit(const int* bits, int i) {
  return (__ldg(bits + (i >> 5)) >> (i & 31)) & 1;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
constraints_slow_kernel(const Args<T> a, int n, int n_targets, int accumulate) {
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (tid < n) {
    const int i = static_cast<int>(tid);
    if (bit(a.target_bits, i)) return;  // its owner below writes it
    a.out[i] = (a.zero_bits && bit(a.zero_bits, i)) ? T(0) : __ldg(a.x + i);
    return;
  }
  if (tid >= static_cast<long long>(n) + n_targets) return;
  const int k = static_cast<int>(tid - n);
  const int t = __ldg(a.targets + k);
  T acc = T(0);
  if (accumulate && !(a.zero_bits && bit(a.zero_bits, t))) acc = __ldg(a.x + t);
  const int e1 = __ldg(a.ptr + k + 1);
  for (int e = __ldg(a.ptr + k); e < e1; ++e) acc += __ldg(a.w + e) * __ldg(a.x + __ldg(a.idx + e));
  a.out[t] = acc;
}

template <typename T>
int launch(const void* const* p, int n, int n_targets, int accumulate, cudaStream_t stream) {
  Args<T> a{static_cast<const T*>(p[0]),   static_cast<const int*>(p[1]),
            static_cast<const int*>(p[2]), static_cast<const int*>(p[3]),
            static_cast<const T*>(p[4]),   static_cast<const int*>(p[5]),
            static_cast<const int*>(p[6]), static_cast<T*>(const_cast<void*>(p[7]))};
  const long long total = static_cast<long long>(n) + n_targets;
  if (total > 0) {
    const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
    constraints_slow_kernel<T><<<blocks, THREADS, 0, stream>>>(a, n, n_targets, accumulate);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int constraints_slow_f32(const void* const* ptrs, int n, int n_targets, int accumulate,
                         void* stream) {
  return launch<float>(ptrs, n, n_targets, accumulate, static_cast<cudaStream_t>(stream));
}

int constraints_slow_f64(const void* const* ptrs, int n, int n_targets, int accumulate,
                         void* stream) {
  return launch<double>(ptrs, n, n_targets, accumulate, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
