// masked_quad, in place on v [nb, N3p]: for every brick b of the list (brick[k], k < n_blk),
//   v[b] -= sum over its selected cells c of geo[b] * E_c^T K E_c u[b],
// E_c the gather of cell c's n_loc = (p+1)^3 nodes from its brick (node (z, y, x) at
// (z*NB + y)*NB + x, NB = B*p + 1; cell slot and local node x fastest), K the Kronecker sum of
// the 1-D factors K1 and M1. The cells of list entry k are its slots slot[ptr[k,0] .. ptr[k,8]],
// in 8 parity classes (class c: ptr[k,c] .. ptr[k,c+1]; x%2 + 2 (y%2) + 4 (z%2) of the cell's
// place in the brick), so no two cells of a class share a node.
// With a right-hand-side axis (BrickLaplaceMM.vmult_multi with face_planes=False: v [k, nb, N3p],
// its RHS v_stride values apart; u [k, >= n_sub, N3p], its RHS u_stride values apart) grid.y is
// the RHS, whose blocks offset u and v by it: each RHS is bit-identical to a launch on it alone,
// and the lists are read by all k.
//
// Replaces: BrickLaplaceMM._masked_quad_apply (dealii_matrixfree_hanging_nodes_tpu/bricks.py:
//   3169-3244) and its subtraction from the subset bricks (corr = -masked_quad(u_sub, qmask),
//   bricks.py:2426-2429, 2934-2938): block-diagonal quadrature sweeps (Sqb [Q, NB], Dqb [Q, Q],
//   Q = B (p+1)) over every subset brick with the geo-premultiplied cell mask as the metric. The
//   TPU side ran them as XLA einsums (no Pallas kernel). p+1 Gauss points a cell axis integrate
//   the cell stiffness exactly, so the function is the sum of the selected cells' stiffnesses,
//   and this kernel visits those cells alone. With a RHS axis it stands in for the reference's
//   multi-RHS subset-row K at degree <= 3 (bricks.py:3470-3477, 3513-3515): the same operator
//   on the masked-removal schedule of the single vmult, launched on k vectors.
//
// Bound on an H100 SXM (chip_smoke.py prints it at each degree, masked_quad.bytes_and_flops):
//   memory. The distinct nodes of the selected cells read once from u and read and written
//   once in v, the lists and geo; the sweeps (7 of 2 n^4 a cell) are small beside them.
//
// Design: one block per listed brick, which owns the brick's nodes in v, so no atomics:
//   - the brick's sum lives in shared memory (acc, NB^3 values), zeroed first;
//   - the selected cells go through the sweeps G at a time (G = 64, 32, 16 at p = 1, 2, 3: about
//     256 lines a sweep), one parity class after another: the G cells' nodes are gathered from
//     u into buffer B, the 7 sweeps of sum_factorization.cuh (as hn_cell runs them) leave
//     geo * K u_c in B, and each thread adds its entries into acc; the cells of a class share
//     no node, so no two threads add into one value, and a node's 1-8 cells add in class
//     order: deterministic;
//   - at the end every node of the brick is read from v, acc subtracted and written back.
//   The factors travel as launch parameters (the constant bank), as in cell_apply and hn_cell.
//   2-D (masked_quad2_kernel; p = 1..3 at B = 16): the brick's sum NB^2 values, 4 parity
//   classes, G = 64 cells a group through the two 2-D sweeps. Bound at 2-D quadrant nref=11,
//   p=3, f32 (35,321 cells in 261 bricks, rem): memory, 4.2 MB, 0.0013 ms.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "sum_factorization.cuh"

namespace {

using sf::Factors;

template <int P>
struct Cfg {
  static constexpr int N = P + 1;
  static constexpr int N2 = N * N;
  static constexpr int NL = N2 * N;
  static constexpr int G = P == 1 ? 64 : (P == 2 ? 32 : 16);  // cells a group
  static constexpr int THREADS = (G * N2 + 31) / 32 * 32;
  static constexpr int SCR = G * NL;
};

template <typename T, int P, int B>
__global__ void __launch_bounds__(Cfg<P>::THREADS)
masked_quad_kernel(const T* __restrict__ u, T* __restrict__ v, const int* __restrict__ brick,
                   const int* __restrict__ ptr, const int* __restrict__ slot,
                   const T* __restrict__ geo, const Factors<T, P + 1> f, int N3p,
                   long long u_stride, long long v_stride) {
  using S = Cfg<P>;
  constexpr int N = S::N, N2 = S::N2, NL = S::NL, G = S::G;
  constexpr int NB = B * P + 1, N3 = NB * NB * NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // [N3] the brick's sum
  T* sa = acc + N3;                         // [G * NL] scratch
  T* sb = sa + S::SCR;                      // [G * NL] the cells' rows, then their products
  __shared__ int s_ptr[9];

  const size_t rhs = blockIdx.y;
  u += rhs * u_stride;
  v += rhs * v_stride;
  const int tid = threadIdx.x;
  const int b = brick[blockIdx.x];
  if (tid < 9) s_ptr[tid] = ptr[blockIdx.x * 9 + tid];
  for (int i = tid; i < N3; i += S::THREADS) acc[i] = T(0);
  const T g = geo[b];
  const T* ub = u + static_cast<size_t>(b) * N3p;
  __syncthreads();

  // the node of local index j in the cell at slot s
  auto node = [](int s, int j) {
    const int sx = s % B, sy = (s / B) % B, sz = s / (B * B);
    const int ix = j % N, iy = (j / N) % N, iz = j / N2;
    return ((sz * P + iz) * NB + sy * P + iy) * NB + sx * P + ix;
  };
  const int l = tid;
  const bool active = l < G * N2;
  for (int c = 0; c < 8; ++c) {
    for (int e0 = s_ptr[c]; e0 < s_ptr[c + 1]; e0 += G) {
      const int ng = min(G, s_ptr[c + 1] - e0);
      for (int t = tid; t < G * NL; t += S::THREADS) {
        const int k = t / NL;
        sb[t] = k < ng ? ub[node(__ldg(slot + e0 + k), t - k * NL)] : T(0);
      }
      __syncthreads();
      if (active) {
        T r[N];
        sf::load_line<T, N, 1>(sb + l * N, r);
        sf::sweep_x(f, r, sb, sa, l);
      }
      __syncthreads();
      if (active) sf::sweep_y(f, sb, sa, l);
      __syncthreads();
      if (active) {
        const int k = l / N2;
        sf::sweep_z(f, sb, sa, l, g, sb + k * NL + (l - k * N2));
      }
      __syncthreads();
      for (int t = tid; t < ng * NL; t += S::THREADS) {
        const int k = t / NL;
        acc[node(__ldg(slot + e0 + k), t - k * NL)] += sb[t];
      }
      __syncthreads();
    }
  }
  T* vb = v + static_cast<size_t>(b) * N3p;
  for (int i = tid; i < N3; i += S::THREADS) vb[i] -= acc[i];
}

// ---- 2-D: bricks of NB^2 nodes (node (y, x) at y*NB + x), cells of n^2 values, 4 parity
// classes (x%2 + 2 (y%2)), ptr [n_blk, 5]; the same steps with the two 2-D sweeps (sweep_x,
// sweep_y2), G = 64 cells a group (64 n lines).
template <int P>
struct Cfg2 {
  static constexpr int N = P + 1;
  static constexpr int NL = N * N;
  static constexpr int G = 64;
  static constexpr int THREADS = (G * N + 31) / 32 * 32;
  static constexpr int SCR = G * NL;
};

template <typename T, int P, int B>
__global__ void __launch_bounds__(Cfg2<P>::THREADS)
masked_quad2_kernel(const T* __restrict__ u, T* __restrict__ v, const int* __restrict__ brick,
                    const int* __restrict__ ptr, const int* __restrict__ slot,
                    const T* __restrict__ geo, const Factors<T, P + 1> f, int N3p,
                    long long u_stride, long long v_stride) {
  using S = Cfg2<P>;
  constexpr int N = S::N, NL = S::NL, G = S::G;
  constexpr int NB = B * P + 1, N2 = NB * NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // [N2] the brick's sum
  T* sa = acc + N2;                         // [G * NL] scratch
  T* sb = sa + S::SCR;                      // [G * NL] the cells' rows, then their products
  __shared__ int s_ptr[5];

  const size_t rhs = blockIdx.y;
  u += rhs * u_stride;
  v += rhs * v_stride;
  const int tid = threadIdx.x;
  const int b = brick[blockIdx.x];
  if (tid < 5) s_ptr[tid] = ptr[blockIdx.x * 5 + tid];
  for (int i = tid; i < N2; i += S::THREADS) acc[i] = T(0);
  const T g = geo[b];
  const T* ub = u + static_cast<size_t>(b) * N3p;
  __syncthreads();

  // the node of local index j in the cell at slot s
  auto node = [](int s, int j) {
    const int sx = s % B, sy = s / B;
    const int ix = j % N, iy = j / N;
    return (sy * P + iy) * NB + sx * P + ix;
  };
  const int l = tid;
  const bool active = l < G * N;
  for (int c = 0; c < 4; ++c) {
    for (int e0 = s_ptr[c]; e0 < s_ptr[c + 1]; e0 += G) {
      const int ng = min(G, s_ptr[c + 1] - e0);
      for (int t = tid; t < G * NL; t += S::THREADS) {
        const int k = t / NL;
        sb[t] = k < ng ? ub[node(__ldg(slot + e0 + k), t - k * NL)] : T(0);
      }
      __syncthreads();
      if (active) {
        T r[N];
        sf::load_line<T, N, 1>(sb + l * N, r);
        sf::sweep_x(f, r, sb, sa, l);
      }
      __syncthreads();
      if (active) {
        const int k = l / N;
        sf::sweep_y2(f, sb, sa, l, g, sb + k * NL + (l - k * N));
      }
      __syncthreads();
      for (int t = tid; t < ng * NL; t += S::THREADS) {
        const int k = t / NL;
        acc[node(__ldg(slot + e0 + k), t - k * NL)] += sb[t];
      }
      __syncthreads();
    }
  }
  T* vb = v + static_cast<size_t>(b) * N3p;
  for (int i = tid; i < N2; i += S::THREADS) vb[i] -= acc[i];
}

template <typename T, int P, int B>
int launch2(const void* u, void* v, const void* brick, const void* ptr, const void* slot,
            const void* geo, const void* K1, const void* M1, int n_blk, int N3p, int k,
            long long u_stride, long long v_stride, cudaStream_t stream) {
  using S = Cfg2<P>;
  constexpr int NB = B * P + 1;
  const int smem = static_cast<int>((NB * NB + 2 * S::SCR) * sizeof(T));
  auto kernel = masked_quad2_kernel<T, P, B>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  Factors<T, P + 1> f;
  std::memcpy(f.K, K1, sizeof(f.K));
  std::memcpy(f.M, M1, sizeof(f.M));
  if (n_blk > 0 && k > 0) {
    kernel<<<dim3(n_blk, k), S::THREADS, smem, stream>>>(
        static_cast<const T*>(u), static_cast<T*>(v), static_cast<const int*>(brick),
        static_cast<const int*>(ptr), static_cast<const int*>(slot), static_cast<const T*>(geo),
        f, N3p, u_stride, v_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P, int B>
int launch(const void* u, void* v, const void* brick, const void* ptr, const void* slot,
           const void* geo, const void* K1, const void* M1, int n_blk, int N3p, int k,
           long long u_stride, long long v_stride, cudaStream_t stream) {
  using S = Cfg<P>;
  constexpr int NB = B * P + 1;
  const int smem = static_cast<int>((NB * NB * NB + 2 * S::SCR) * sizeof(T));
  auto kernel = masked_quad_kernel<T, P, B>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  Factors<T, P + 1> f;
  std::memcpy(f.K, K1, sizeof(f.K));
  std::memcpy(f.M, M1, sizeof(f.M));
  if (n_blk > 0 && k > 0) {
    kernel<<<dim3(n_blk, k), S::THREADS, smem, stream>>>(
        static_cast<const T*>(u), static_cast<T*>(v), static_cast<const int*>(brick),
        static_cast<const int*>(ptr), static_cast<const int*>(slot), static_cast<const T*>(geo),
        f, N3p, u_stride, v_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// (p, B) as the brick size rule gives them at the degrees of the masked removal
template <typename T>
int dispatch(const void* u, void* v, const void* brick, const void* ptr, const void* slot,
             const void* geo, const void* K1, const void* M1, int n_blk, int p, int B, int N3p,
             int k, long long u_stride, long long v_stride, int dim, cudaStream_t stream) {
#define MQ_CASE2(p_, b_)                                                                   \
  if (dim == 2 && p == p_ && B == b_)                                                      \
    return launch2<T, p_, b_>(u, v, brick, ptr, slot, geo, K1, M1, n_blk, N3p, k, u_stride, \
                              v_stride, stream);
  MQ_CASE2(3, 16)
  MQ_CASE2(2, 16)
  MQ_CASE2(1, 16)
#undef MQ_CASE2
  if (dim != 3) return static_cast<int>(cudaErrorInvalidValue);
#define MQ_CASE(p_, b_)                                                                   \
  if (p == p_ && B == b_)                                                                 \
    return launch<T, p_, b_>(u, v, brick, ptr, slot, geo, K1, M1, n_blk, N3p, k, u_stride, \
                             v_stride, stream);
  MQ_CASE(3, 4)
  MQ_CASE(2, 8)
  MQ_CASE(1, 16)
#undef MQ_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// u .. geo: device pointers; K1, M1: host pointers to the 1-D factors (copied into the launch's
// parameters); k right-hand sides, u_stride values apart in u and v_stride in v; dim: 3 (ptr
// [n_blk, 9]) or 2 (ptr [n_blk, 5], NB^2-node bricks)
int masked_quad_f32(const void* u, void* v, const void* brick, const void* ptr, const void* slot,
                    const void* geo, const void* K1, const void* M1, int n_blk, int p, int B,
                    int N3p, int k, long long u_stride, long long v_stride, int dim,
                    void* stream) {
  return dispatch<float>(u, v, brick, ptr, slot, geo, K1, M1, n_blk, p, B, N3p, k, u_stride,
                         v_stride, dim, static_cast<cudaStream_t>(stream));
}

int masked_quad_f64(const void* u, void* v, const void* brick, const void* ptr, const void* slot,
                    const void* geo, const void* K1, const void* M1, int n_blk, int p, int B,
                    int N3p, int k, long long u_stride, long long v_stride, int dim,
                    void* stream) {
  return dispatch<double>(u, v, brick, ptr, slot, geo, K1, M1, n_blk, p, B, N3p, k, u_stride,
                          v_stride, dim, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
