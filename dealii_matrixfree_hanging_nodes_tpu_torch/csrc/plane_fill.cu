// plane_fill: out [nb, N3p] from u [nb, N3p]: out = u, except at the covered nodes
// cov[k] (flat brick * N3p + node, ascending; brick b's at k = cov_ptr[b] .. cov_ptr[b+1]):
//   out[cov[k]] = sum of w[e] * u_flat[src[e]] over e = fill_ptr[k] .. fill_ptr[k+1], in order.
// The entries are the face-plane fill of every level composed on the host
// (bricks._plane_tables): each source is a node no level writes, so the launch reads u alone.
//
// Replaces: BrickLaplaceMM._plane_fill (dealii_matrixfree_hanging_nodes_tpu/bricks.py:
//   3044-3102): per level, coarse first, a gather of the plane-touched bricks, the coarse
//   quarter faces through [NB, Nh] interpolations (P1 q P1^T), a scatter-add of the covered
//   updates into the fine faces, and the scatter back into a new vector. The TPU side ran it as
//   XLA gathers, einsums and scatters (no Pallas kernel).
//
// Bound on an H100 SXM (chip_smoke.py prints it at p = 2 and 1, plane_fill.bytes_and_flops):
//   memory. u read once (bar its covered nodes) and out written once, the tables read once.
//
// Design: one block per brick, which owns the brick's nodes in out: it copies the brick in
//   16-byte vectors (a row of N3p, a multiple of 32 values, is whole vectors), and a brick
//   with covered nodes then, after a barrier that orders the copy's stores first, writes each
//   covered node's sum, one thread a node, its entries in order (2-4 at p = 1, up to 9 at p = 2,
//   more where the levels chain). Levels need no order on the card: the composition put it in
//   the entries. No atomics: every value of out is written by its brick's block.

// 2-D bricks run the same kernel: the host composes their side-line fill (1-D P1) into the
// same lists.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int W = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int W = 2;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
plane_fill_kernel(const T* __restrict__ u, T* __restrict__ out, const int* __restrict__ cov,
                  const int* __restrict__ cov_ptr, const int* __restrict__ fill_ptr,
                  const int* __restrict__ fill_src, const T* __restrict__ fill_w, int N3p) {
  using V = typename Vec<T>::type;
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t row = static_cast<size_t>(b) * N3p;
  const V* src = reinterpret_cast<const V*>(u + row);
  V* dst = reinterpret_cast<V*>(out + row);
  for (int i = tid; i < N3p / Vec<T>::W; i += THREADS) dst[i] = src[i];
  const int k0 = cov_ptr[b], k1 = cov_ptr[b + 1];
  if (k0 == k1) return;  // the same for the whole block
  __syncthreads();
  for (int k = k0 + tid; k < k1; k += THREADS) {
    const int e1 = __ldg(fill_ptr + k + 1);
    T acc = T(0);
    for (int e = __ldg(fill_ptr + k); e < e1; ++e) acc += __ldg(fill_w + e) * u[__ldg(fill_src + e)];
    out[__ldg(cov + k)] = acc;
  }
}

template <typename T>
int launch(const void* u, void* out, const void* cov, const void* cov_ptr, const void* fill_ptr,
           const void* fill_src, const void* fill_w, int nb, int N3p, cudaStream_t stream) {
  if (N3p % Vec<T>::W) return static_cast<int>(cudaErrorInvalidValue);
  if (nb > 0) {
    plane_fill_kernel<T><<<nb, THREADS, 0, stream>>>(
        static_cast<const T*>(u), static_cast<T*>(out), static_cast<const int*>(cov),
        static_cast<const int*>(cov_ptr), static_cast<const int*>(fill_ptr),
        static_cast<const int*>(fill_src), static_cast<const T*>(fill_w), N3p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int plane_fill_f32(const void* u, void* out, const void* cov, const void* cov_ptr,
                   const void* fill_ptr, const void* fill_src, const void* fill_w, int nb, int N3p,
                   void* stream) {
  return launch<float>(u, out, cov, cov_ptr, fill_ptr, fill_src, fill_w, nb, N3p,
                       static_cast<cudaStream_t>(stream));
}

int plane_fill_f64(const void* u, void* out, const void* cov, const void* cov_ptr,
                   const void* fill_ptr, const void* fill_src, const void* fill_w, int nb, int N3p,
                   void* stream) {
  return launch<double>(u, out, cov, cov_ptr, fill_ptr, fill_src, fill_w, nb, N3p,
                        static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
