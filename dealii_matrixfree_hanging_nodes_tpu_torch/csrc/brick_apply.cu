// brick_apply: v_b = geo_b * (Mz (x) (My (x) Kx + Ky (x) Mx) + Kz (x) My (x) Mx) u_b
// on every brick b of a [n_bricks, N3p] vector (node (z, y, x) at (z*NB + y)*NB + x,
// N3 = NB^3 nodes, padded to N3p).
//
// Replaces: experiments/queue/_mb_main.py:63 pallas_fused, the unadopted Pallas form
//   of BrickLaplaceMM._main_apply (dealii_matrixfree_hanging_nodes_tpu/bricks.py:2321-2348)
//   times the per-brick geo scale (bricks.py:2367).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (4400 bricks, NB=17, N3p=4992):
//   memory. The least traffic is one read of u and one write of v, 2 x 87.9 MB = 176 MB,
//   52 us at 3.35 TB/s. The sweeps below do 2.4 GFLOP, 35 us at 67 TFLOP/s (f32 outside the
//   tensor cores), so the bytes bound.
//
// Design: one block per brick; the brick lives in shared memory (two NB^3 buffers, 39 KB
//   in f32, 79 KB in f64) and is read from and written to device memory once, coalesced.
//   The operator is applied as three rounds of 1-D sweeps instead of the TPU kernel's
//   289 x 289 xy-plane matmuls:
//     x round, one thread per (z, y) line:  a = Mb u,          b = Kb u
//     y round, one thread per (z, x) line:  c1 = Mb b + Kb a,  c2 = Mb a
//     z round, one thread per (y, x) line:  v = geo (Mb c1 + Kb c2), stored to device memory
//   A thread keeps its lines in registers (NB and p are template parameters, so every loop
//   unrolls) and writes its results back in place. Kb and Mb are assembled from cell
//   blocks, so row i is zero outside |i - j| <= p: each output sums at most 2p+1 terms.
//   Line strides are odd (NB, NB^2), so the f32 shared-memory accesses do not conflict.
//   The padded tail N3..N3p is written as zeros.

#include <cuda_runtime.h>

namespace {

// Kb and Mb vanish outside the band |i - j| <= P. With i and j unrolled loop counters
// the test folds at compile time, so the lines stay in registers.
template <int P>
__device__ __forceinline__ constexpr bool in_band(int i, int j) {
  return j >= i - P && j <= i + P;
}

template <typename T, int NB, int P>
__global__ void __launch_bounds__(320)
brick_apply_kernel(const T* __restrict__ u, const T* __restrict__ Kb,
                   const T* __restrict__ Mb, const T* __restrict__ geo,
                   T* __restrict__ v, int N3p) {
  constexpr int N2 = NB * NB;
  constexpr int N3 = N2 * NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s0 = reinterpret_cast<T*>(smem_raw);
  T* s1 = s0 + N3;
  T* sK = s1 + N3;
  T* sM = sK + N2;

  const size_t base = static_cast<size_t>(blockIdx.x) * N3p;
  const T* ub = u + base;
  T* vb = v + base;
  for (int i = threadIdx.x; i < N3; i += blockDim.x) s0[i] = ub[i];
  for (int i = threadIdx.x; i < N2; i += blockDim.x) {
    sK[i] = Kb[i];
    sM[i] = Mb[i];
  }
  for (int i = N3 + threadIdx.x; i < N3p; i += blockDim.x) vb[i] = T(0);
  __syncthreads();

  // One line per thread in each round (blockDim >= N2). A loop over lines would let the
  // compiler hoist all 2 NB^2 factor entries into registers across iterations and spill.
  const int l = threadIdx.x;

  // x round: line l = (z, y), contiguous
  if (l < N2) {
    T r[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) r[k] = s0[l * NB + k];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      T a = T(0), b = T(0);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (in_band<P>(i, j)) {
          a += sM[i * NB + j] * r[j];
          b += sK[i * NB + j] * r[j];
        }
      }
      s0[l * NB + i] = a;
      s1[l * NB + i] = b;
    }
  }
  __syncthreads();

  // y round: line l = (z, x), stride NB
  if (l < N2) {
    const int z = l / NB;
    const int o = z * N2 + (l - z * NB);
    T a[NB], b[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      a[k] = s0[o + k * NB];
      b[k] = s1[o + k * NB];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      T c1 = T(0), c2 = T(0);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (in_band<P>(i, j)) {
          c1 += sM[i * NB + j] * b[j] + sK[i * NB + j] * a[j];
          c2 += sM[i * NB + j] * a[j];
        }
      }
      s0[o + i * NB] = c1;
      s1[o + i * NB] = c2;
    }
  }
  __syncthreads();

  // z round: line l = (y, x), stride N2; results go straight to device memory
  if (l < N2) {
    const T g = geo[blockIdx.x];
    T c1[NB], c2[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      c1[k] = s0[l + k * N2];
      c2[k] = s1[l + k * N2];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (in_band<P>(i, j)) acc += sM[i * NB + j] * c1[j] + sK[i * NB + j] * c2[j];
      }
      vb[l + i * N2] = g * acc;
    }
  }
}

template <typename T, int NB, int P>
int launch(const void* u, const void* Kb, const void* Mb, const void* geo, void* v,
           int nb, int N3p, cudaStream_t stream) {
  constexpr int N2 = NB * NB;
  constexpr int N3 = N2 * NB;
  const int smem = static_cast<int>((2 * N3 + 2 * N2) * sizeof(T));
  auto kernel = brick_apply_kernel<T, NB, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = ((N2 + 31) / 32) * 32;
  if (nb > 0) {
    kernel<<<nb, threads, smem, stream>>>(
        static_cast<const T*>(u), static_cast<const T*>(Kb), static_cast<const T*>(Mb),
        static_cast<const T*>(geo), static_cast<T*>(v), N3p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* u, const void* Kb, const void* Mb, const void* geo, void* v,
             int nb, int NB, int p, int N3p, cudaStream_t stream) {
  if (NB == 17 && p == 4) return launch<T, 17, 4>(u, Kb, Mb, geo, v, nb, N3p, stream);
  if (NB == 11 && p == 5) return launch<T, 11, 5>(u, Kb, Mb, geo, v, nb, N3p, stream);
  if (NB == 13 && p == 6) return launch<T, 13, 6>(u, Kb, Mb, geo, v, nb, N3p, stream);
  if (NB == 15 && p == 7) return launch<T, 15, 7>(u, Kb, Mb, geo, v, nb, N3p, stream);
  if (NB == 17 && p == 8) return launch<T, 17, 8>(u, Kb, Mb, geo, v, nb, N3p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int brick_apply_f32(const void* u, const void* Kb, const void* Mb, const void* geo,
                    void* v, int nb, int NB, int p, int N3p, void* stream) {
  return dispatch<float>(u, Kb, Mb, geo, v, nb, NB, p, N3p,
                         static_cast<cudaStream_t>(stream));
}

int brick_apply_f64(const void* u, const void* Kb, const void* Mb, const void* geo,
                    void* v, int nb, int NB, int p, int N3p, void* stream) {
  return dispatch<double>(u, Kb, Mb, geo, v, nb, NB, p, N3p,
                          static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
