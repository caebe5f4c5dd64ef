// plane_fold, in place on v [nb, N3p], the transpose of plane_fill's map, in two launches:
//   mode 0, the sums: v[tgt[t]] += sum of w[e] * v_flat[src[e]] over e = ptr[t] .. ptr[t+1], in
//           order (src: covered nodes, ascending; no target is covered);
//   mode 1, the zeros: v[cov[k]] = 0 for every covered node (reduced outputs).
// Flat indices are brick * N3p + node.
//
// Replaces: BrickLaplaceMM._plane_corr (dealii_matrixfree_hanging_nodes_tpu/bricks.py:
//   3104-3167): per level, fine first, the covered fine face nodes through P1^T into the coarse
//   quarter faces (a scatter-add with repeated ids, bricks.py:3163) and zeroed. The TPU side
//   ran it as XLA gathers, einsums and scatters (no Pallas kernel). The host composes the
//   levels into one map (bricks._plane_tables), so each target's sum reads only the values the
//   fold starts from.
//
// Bound on an H100 SXM (chip_smoke.py prints it at p = 2 and 1, plane_fold.bytes_and_flops):
//   memory. Each target read and written once, each covered node read once and written once
//   (its zero), the tables read once.
//
// Design: gather by owner. A coarse node on the boundary of the quarter faces that fold into
//   it receives from 2-4 of them, so the fold is written by destination: one thread owns a
//   target, sums its entries in ascending source order and adds the sum once; no two threads
//   write one value and no atomics are needed (as dss_surface owns its pools). The sums read
//   the covered nodes that the zeros clear, so the zeros are a second launch, one thread a
//   covered node; a barrier inside one launch orders only a block.

// 2-D bricks run the same kernel on the transpose of their side-line fill.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
plane_fold_kernel(T* __restrict__ v, const int* __restrict__ tgt, const int* __restrict__ ptr,
                  const int* __restrict__ src, const T* __restrict__ w,
                  const int* __restrict__ cov, int n_tgt, int n_cov, int mode) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (mode == 0) {
    if (i >= n_tgt) return;
    const int e1 = __ldg(ptr + i + 1);
    T acc = T(0);
    for (int e = __ldg(ptr + i); e < e1; ++e) acc += __ldg(w + e) * v[__ldg(src + e)];
    v[__ldg(tgt + i)] += acc;
  } else if (i < n_cov) {
    v[__ldg(cov + i)] = T(0);
  }
}

template <typename T>
int launch(void* v, const void* tgt, const void* ptr, const void* src, const void* w,
           const void* cov, int n_tgt, int n_cov, int mode, cudaStream_t stream) {
  const int n = mode == 0 ? n_tgt : n_cov;
  if (n > 0) {
    plane_fold_kernel<T><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        static_cast<T*>(v), static_cast<const int*>(tgt), static_cast<const int*>(ptr),
        static_cast<const int*>(src), static_cast<const T*>(w), static_cast<const int*>(cov),
        n_tgt, n_cov, mode);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int plane_fold_f32(void* v, const void* tgt, const void* ptr, const void* src, const void* w,
                   const void* cov, int n_tgt, int n_cov, int mode, void* stream) {
  return launch<float>(v, tgt, ptr, src, w, cov, n_tgt, n_cov, mode,
                       static_cast<cudaStream_t>(stream));
}

int plane_fold_f64(void* v, const void* tgt, const void* ptr, const void* src, const void* w,
                   const void* cov, int n_tgt, int n_cov, int mode, void* stream) {
  return launch<double>(v, tgt, ptr, src, w, cov, n_tgt, n_cov, mode,
                        static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
