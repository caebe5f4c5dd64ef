// halo_pack: the distributed engines' halo buffers, three modes over index lists built on the
// host (parallel/distributed.py, parallel/bricks_distributed.py):
//   pack: out[i] = valid[i] != 0 ? x[idx[i]] * valid[i] : 0, i over the [R, m] send buffer (or
//         any gather of rows by a flat list: the chain block from the cell rows or the slab);
//   set:  out[i] = own[i] for i < n_own (the own block first), else recv[map[i - n_own]] where
//         the map names a received value and 0 where it is -1 (the need buffer of the chain
//         exchange, the index halo's [own | ghosts] vector);
//   add:  x[dst[q]] += sum of recv[src[e]] * w[e] over e = ptr[q] .. ptr[q+1], in place, by
//         destination: the owner add after the reverse halo and the received partial pool sums.
//         An owned DoF or a touched pool goes to several ranks, so a destination has several
//         entries; the host transposes the [R, m] lists into per-destination runs in ascending
//         (source rank, slot) order, and one thread a destination adds them in that order:
//         no atomics, two calls give the same bits.
//
// Replaces: XLA gathers and scatters inside shard_map on the TPU (no Pallas kernel):
//   DistributedLaplace.local_vmult_halo's `src_own[send_idx] * send_valid`, the concatenation
//   `[src_own; recv]` and `own.at[send_idx].add(back * send_valid)`
//   (dealii_matrixfree_hanging_nodes_tpu/parallel/distributed.py:261-284);
//   DistributedBrickLaplace._dss_local_halo's `bflat[dsend_idx] * dsend_valid` and
//   `bflat.at[dsend_idx].add(recv * dsend_valid)` (bricks_distributed.py:888-901);
//   _chain_exchange's `bflat[send_scal] * send_scal_valid`, `buf.at[recv_scal].set(recv)` and
//   `buf.at[:n_own].set(block)` (bricks_distributed.py:933-953); the step's
//   `take(final, chain_src) * chain_valid` and the fill pass's chain block read from the slab.
//
// Bound on an H100 SXM: memory. Each mode reads its lists once, the values its entries name
//   once, and writes its output once; one multiply (and add) an entry.
//
// Design: one thread an output value (pack, set) or a destination (add), blocks of 256
//   consecutive outputs, so list reads and output writes are coalesced; the values are a
//   gather. A pad entry (valid 0, map -1) reads nothing: padded slots and trash rows are never
//   read.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
halo_pack_pack_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                      const T* __restrict__ valid, T* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const T v = valid[i];
  out[i] = v != T(0) ? __ldg(x + idx[i]) * v : T(0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
halo_pack_set_kernel(const T* __restrict__ own, const T* __restrict__ recv,
                     const int* __restrict__ map, T* __restrict__ out, long long n_own,
                     long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  if (i < n_own) {
    out[i] = own[i];
  } else {
    const int m = map[i - n_own];
    out[i] = m >= 0 ? __ldg(recv + m) : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
halo_pack_add_kernel(T* __restrict__ x, const T* __restrict__ recv, const int* __restrict__ dst,
                     const int* __restrict__ ptr, const int* __restrict__ src,
                     const T* __restrict__ w, int n_dst) {
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= n_dst) return;
  const int d = dst[q], e1 = ptr[q + 1];
  T acc = x[d];
  for (int e = ptr[q]; e < e1; ++e) acc += __ldg(recv + src[e]) * w[e];
  x[d] = acc;
}

inline unsigned blocks(long long n) { return static_cast<unsigned>((n + THREADS - 1) / THREADS); }

template <typename T>
int pack_values(const void* x, const void* idx, const void* valid, void* out, long long n,
                cudaStream_t s) {
  if (n > 0)
    halo_pack_pack_kernel<T><<<blocks(n), THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const int*>(idx), static_cast<const T*>(valid),
        static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int set_values(const void* own, const void* recv, const void* map, void* out, long long n_own,
               long long n, cudaStream_t s) {
  if (n > 0)
    halo_pack_set_kernel<T><<<blocks(n), THREADS, 0, s>>>(
        static_cast<const T*>(own), static_cast<const T*>(recv), static_cast<const int*>(map),
        static_cast<T*>(out), n_own, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int add_values(void* x, const void* recv, const void* dst, const void* ptr, const void* src,
               const void* w, int n_dst, cudaStream_t s) {
  if (n_dst > 0)
    halo_pack_add_kernel<T><<<blocks(n_dst), THREADS, 0, s>>>(
        static_cast<T*>(x), static_cast<const T*>(recv), static_cast<const int*>(dst),
        static_cast<const int*>(ptr), static_cast<const int*>(src), static_cast<const T*>(w),
        n_dst);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// pack: x values, idx int32 [n], valid [n] -> out [n]
int halo_pack_pack_f32(const void* x, const void* idx, const void* valid, void* out, long long n,
                       void* stream) {
  return pack_values<float>(x, idx, valid, out, n, static_cast<cudaStream_t>(stream));
}
int halo_pack_pack_f64(const void* x, const void* idx, const void* valid, void* out, long long n,
                       void* stream) {
  return pack_values<double>(x, idx, valid, out, n, static_cast<cudaStream_t>(stream));
}

// set: own [n_own], recv, map int32 [n - n_own] -> out [n]
int halo_pack_set_f32(const void* own, const void* recv, const void* map, void* out,
                      long long n_own, long long n, void* stream) {
  return set_values<float>(own, recv, map, out, n_own, n, static_cast<cudaStream_t>(stream));
}
int halo_pack_set_f64(const void* own, const void* recv, const void* map, void* out,
                      long long n_own, long long n, void* stream) {
  return set_values<double>(own, recv, map, out, n_own, n, static_cast<cudaStream_t>(stream));
}

// add: x updated in place at dst [n_dst] from recv through the runs ptr [n_dst+1], src, w
int halo_pack_add_f32(void* x, const void* recv, const void* dst, const void* ptr,
                      const void* src, const void* w, int n_dst, void* stream) {
  return add_values<float>(x, recv, dst, ptr, src, w, n_dst,
                           static_cast<cudaStream_t>(stream));
}
int halo_pack_add_f64(void* x, const void* recv, const void* dst, const void* ptr,
                      const void* src, const void* w, int n_dst, void* stream) {
  return add_values<double>(x, recv, dst, ptr, src, w, n_dst,
                            static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
