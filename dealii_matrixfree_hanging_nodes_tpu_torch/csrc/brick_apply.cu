// brick_apply: v_b = geo_b * (Mz (x) (My (x) Kx + Ky (x) Mx) + Kz (x) My (x) Mx) u_b
// on every brick b of a [n_bricks, N3p] vector (node (z, y, x) at (z*NB + y)*NB + x,
// N3 = NB^3 nodes, padded to N3p), and on the first m bricks, as an epilogue, the
// overlap-add of their cell rows: v_b[node] += the 1-8 entries dcols[b*B^3 + slot, j] of
// the (cell slot, local node) pairs that sit on that node (dcols [m*B^3, n_loc],
// n_loc = (p+1)^3, NB = B*p + 1, cell slots and local nodes x fastest).
// With a right-hand-side axis (BrickLaplaceMM.vmult_multi: u [k, n_bricks, N3p], its RHS
// u_stride values apart; v [k, n_bricks, N3p] and dcols [k, m*B^3, n_loc] contiguous) grid.y is
// the RHS, whose blocks offset u, v and dcols by it: each RHS is bit-identical to a launch on it
// alone, and the factors, launch parameters, are shared by all k.
//
// Replaces: experiments/queue/_mb_main.py:63 pallas_fused, the unadopted Pallas form
//   of BrickLaplaceMM._main_apply (dealii_matrixfree_hanging_nodes_tpu/bricks.py:2321-2348)
//   times the per-brick geo scale (bricks.py:2367); and, in the epilogue, _scatter_cols /
//   _col2im_sep (bricks.py:2196-2241) with the merge v.at[:n_sub].add(corr)
//   (bricks.py:2553-2559), which the TPU side ran as a one-hot matmul. With a RHS axis, the
//   same on the k-major layout of _vmult_multi_impl (bricks.py:3459-3461, 3513-3515).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (4400 bricks, NB=17, N3p=4992, 1025
//   bricks with cell rows): memory. u's N3 nodes are read once (86.5 MB), v is written once
//   with its zero padding (87.9 MB) and the cell rows read once (32.8 MB): 207.1 MB, 61.8 us
//   at 3.35 TB/s (52.0 us without the cell rows). Kb and Mb are assembled
//   from cell blocks, so row i of either has 97 structural nonzeros in all at p=4 (p+1 in a
//   row inside a cell, 2p+1 on an interior cell boundary): the 7 sweeps below do 1.73 GFLOP,
//   26 us at 67 TFLOP/s (f32 outside the tensor cores).
//
// Design: one block per brick; the brick lives in shared memory and is read from and
//   written to device memory once. The operator is applied as 1-D sweeps in three rounds,
//   one line per thread (NB^2 lines, 289 in 320 threads at NB=17):
//     x round, line (z, y), contiguous:  a = Mb u,          b = Kb u
//     y round, line (z, x), stride NB:   c1 = Mb b + Kb a,  c2 = Mb a
//     z round, line (y, x), stride NB^2: v = geo (Mb c1 + Kb c2) [+ the cell rows' entries]
//   A thread holds its line in registers and writes its results back in place, so a brick
//   needs two buffers; the z round stores to device memory directly, coalesced (a warp's
//   lanes write neighbouring x), and the padded tail N3..N3p is written as zeros.
//   Factors: only the structural nonzeros of Kb and Mb, packed row by row on the host
//   (97 per factor at p=4: 776 B in f32; 2,576 B in f64 at p=8), travel with the launch as
//   its parameters (the constant bank). NB and p are template parameters, so every loop
//   unrolls, the structure folds at compile time and each factor entry is an operand of
//   its FMA (ptxas brings them in with ULDC into uniform registers): no sweep loads a
//   factor from shared or device memory. Each product is its own FMA: a sum of two
//   products added to an accumulator compiles to FMUL, FFMA and FADD.
//   Loads: the brick and, for the first m bricks, its B^3 contiguous cell rows (32,000 B
//   in f32 at p=4) come in with 16-byte cp.async copies in two groups; the x round waits
//   for the brick only, the z round for the cell rows. At p = 1 in f64 a brick's cell rows
//   (4096 cells of 8 values, 262 KB) do not fit in shared memory: the epilogue reads them
//   from device memory there (Cfg::STAGE_D). Three blocks stay resident on an SM
//   in f32 at p=4, so one block's copies run under the others' sweeps.
//   Epilogue: a node's entries are summed in a fixed order, z cells outer, then y, then x,
//   each axis listing a node inside a cell once and a node on an interior cell boundary
//   twice (the cell before at local p, the cell after at local 0), from 0, then added to
//   geo * the sweeps: no atomics, deterministic.
//   What holds it back at p=4 f32: the instruction stream, not bytes. Per line a thread
//   runs 679 FFMA (7 sweeps of 97 nonzeros), a ULDC for every one or two factor entries, 85
//   shared loads, 68 shared stores and 17 global stores; a brick takes 10 warps (the tenth
//   holds one line), each running all of that.
//   Tried and not kept: two or three lines per thread, to share each ULDC (ptxas then
//   asks for 168-255 registers and spills); the factors in __constant__ memory (the same
//   ULDC code, plus a copy a launch); a y round without bank conflicts (no faster: shared
//   memory does not bound it); persistent blocks that prefetch their next brick with
//   cp.async into a third buffer (no faster on the fused launch than resident blocks).
//   Resources (ptxas, sm_90a, CUDA 12.8; chip_smoke.py phase 2 prints them; no spills and
//   no stack in any instantiation; shared memory without / with cell rows):
//     f32 p=4: 56 registers, 320 threads, 39,328 / 71,328 B, 3 blocks an SM
//     f32 p=5: 48, 128, 10,656 / 17,568 B, 10;  p=6: 48, 192, 17,600 / 28,576 B, 6
//     f32 p=7: 48, 256, 27,008 / 43,392 B, 5;   p=8: 56, 320, 39,328 / 62,656 B, 3
//     f64 p=4: 100 registers, 78,624 / 142,624 B, 1 block an SM
//     f64 p=5: 84, 21,312 / 35,136 B, 5;  p=6: 94, 35,168 / 57,120 B, 3
//     f64 p=7: 93, 54,016 / 86,784 B, 2;  p=8: 100, 78,624 / 125,280 B, 1

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "brick_band.cuh"

namespace {

template <typename T, int NB, int P>
struct Cfg {
  static constexpr int B = (NB - 1) / P;
  static constexpr int N2 = NB * NB;
  static constexpr int N3 = N2 * NB;
  static constexpr int VW = 16 / sizeof(T);               // values per 16-byte word
  static constexpr int N3R = (N3 + VW - 1) / VW * VW;     // a brick buffer, whole words
  static constexpr int NL = (P + 1) * (P + 1) * (P + 1);  // local nodes of a cell
  static constexpr int DC = B * B * B * NL;               // a brick's cell rows
  static constexpr int DCR = (DC + VW - 1) / VW * VW;
  static constexpr int NNZ = row_offset<NB, P>(NB);
  static constexpr int THREADS = (N2 + 31) / 32 * 32;
  // a brick's cell rows staged in shared memory beside its two buffers, where they fit (all
  // but p = 1 in f64, 262 KB of rows); else the epilogue reads them from device memory
  static constexpr bool STAGE_D = (2 * N3R + DCR) * sizeof(T) <= 200 * 1024;
  static constexpr int SMEM_D = STAGE_D ? DCR : 0;  // shared values for the cell rows
  static_assert(NNZ == 1 + B * P * (P + 2), "packed factor size");
};

// The structural nonzeros of Kb and Mb, packed row by row, as launch parameters.
template <typename T, int NNZ>
struct Factors {
  T K[NNZ];
  T M[NNZ];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying `count` values into shared memory: 16-byte cp.async copies where both
// sides allow them (the tail may read up to the next 16 bytes, inside the callers' padding),
// else plain loads, complete on return.
template <typename T>
__device__ __forceinline__ void stage(T* __restrict__ dst, const T* __restrict__ src,
                                      int count, bool vec) {
  if (vec) {
    constexpr int VW = 16 / sizeof(T);
    for (int i = threadIdx.x; i * VW < count; i += blockDim.x) cp_async16(dst + i * VW, src + i * VW);
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  }
}

// The 1-2 (cell, local node) pairs of coordinate c along one axis, as offsets into a brick's
// cell rows with that axis' cell and local strides; returns their number.
template <int NB, int P>
__device__ __forceinline__ int axis_terms(int c, int cell_stride, int loc_stride, int (&off)[2]) {
  const int q = c / P, r = c - q * P;
  if (c == NB - 1) {
    off[0] = (q - 1) * cell_stride + P * loc_stride;
    return 1;
  }
  if (r == 0 && c > 0) {
    off[0] = (q - 1) * cell_stride + P * loc_stride;
    off[1] = q * cell_stride;
    return 2;
  }
  off[0] = q * cell_stride + r * loc_stride;
  return 1;
}

template <typename T, int NB, int P>
__global__ void __launch_bounds__(Cfg<T, NB, P>::THREADS, sizeof(T) == 4 ? 2 : 1)
brick_apply_kernel(const T* __restrict__ u, const Factors<T, Cfg<T, NB, P>::NNZ> f,
                   const T* __restrict__ geo, const T* __restrict__ dcols, T* __restrict__ v,
                   int m, int N3p, long long u_stride, int vec_u, int vec_d) {
  using S = Cfg<T, NB, P>;
  constexpr int N2 = S::N2, N3 = S::N3, N = P + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const s0 = reinterpret_cast<T*>(smem_raw);  // the brick, then a, then c1
  T* const s1 = s0 + S::N3R;                     // b, then c2
  T* const sd = s1 + S::N3R;                     // the brick's cell rows (brick < m)

  const int brick = blockIdx.x;
  const size_t rhs = blockIdx.y;
  const bool rows = brick < m;
  stage(s0, u + rhs * u_stride + static_cast<size_t>(brick) * N3p, N3, vec_u);
  cp_async_commit();
  const T* const db = dcols + (rhs * m + brick) * S::DC;
  if (rows && S::STAGE_D) stage(sd, db, S::DC, vec_d);
  cp_async_commit();
  const T* const dr = S::STAGE_D ? sd : db;  // where the epilogue reads the cell rows
  T* const vb = v + (rhs * gridDim.x + brick) * N3p;
  for (int i = N3 + threadIdx.x; i < N3p; i += blockDim.x) vb[i] = T(0);
  cp_async_wait<1>();  // the brick; its cell rows may still be in flight
  __syncthreads();

  // One line per thread in each round; the threads past N2 only copy and wait.
  const int l = threadIdx.x;
  const bool active = l < N2;

  // x round: line l = (z, y), contiguous
  if (active) {
    T r[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) r[j] = s0[l * NB + j];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      T a = T(0), b = T(0);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j >= lo<NB, P>(i) && j <= hi<NB, P>(i)) {
          const int e = row_offset<NB, P>(i) + j - lo<NB, P>(i);
          a += f.M[e] * r[j];
          b += f.K[e] * r[j];
        }
      }
      s0[l * NB + i] = a;
      s1[l * NB + i] = b;
    }
  }
  __syncthreads();

  // y round: line l = (z, x), stride NB
  if (active) {
    const int z = l / NB;
    const int o = z * N2 + (l - z * NB);
    T a[NB], b[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      a[j] = s0[o + j * NB];
      b[j] = s1[o + j * NB];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      T c1 = T(0), c2 = T(0);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j >= lo<NB, P>(i) && j <= hi<NB, P>(i)) {
          const int e = row_offset<NB, P>(i) + j - lo<NB, P>(i);
          c1 += f.M[e] * b[j];  // one FMA a term: a sum of two products
          c1 += f.K[e] * a[j];  // would compile to FMUL, FFMA and FADD
          c2 += f.M[e] * a[j];
        }
      }
      s0[o + i * NB] = c1;
      s1[o + i * NB] = c2;
    }
  }
  cp_async_wait<0>();  // the cell rows
  __syncthreads();

  // z round: line l = (y, x), stride N2; results straight to device memory
  if (active) {
    int oy[2] = {0, 0}, ox[2] = {0, 0};  // the cell-row offsets of (y, x)
    const int ny = axis_terms<NB, P>(l / NB, S::B * S::NL, N, oy);
    const int nx = axis_terms<NB, P>(l % NB, S::NL, 1, ox);
    const T g = geo[brick];
    T c1[NB], c2[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      c1[j] = s0[l + j * N2];
      c2[j] = s1[l + j * N2];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j >= lo<NB, P>(i) && j <= hi<NB, P>(i)) {
          const int e = row_offset<NB, P>(i) + j - lo<NB, P>(i);
          acc += f.M[e] * c1[j];
          acc += f.K[e] * c2[j];
        }
      }
      T out = g * acc;
      if (rows) {
        int oz[2] = {0, 0};
        const int nz = axis_terms<NB, P>(i, S::B * S::B * S::NL, N * N, oz);
        T corr = T(0);  // fixed indices, so the term lists stay in registers
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (a < nz && b < ny && c < nx) corr += dr[oz[a] + oy[b] + ox[c]];
        out += corr;
      }
      vb[l + i * N2] = out;
    }
  }
}

// ---- 2-D: v_b = geo_b (My (x) Kx + Ky (x) Mx) u_b on NB^2-node bricks (node (y, x) at y*NB + x),
// with the overlap-add of the first m bricks' cell rows dcols [m*B^2, (p+1)^2] in the epilogue.
// A brick has only NB lines an axis (17..49), so a block takes G bricks (about 256 lines, as
// many as its shared memory holds: G = 15, 7, 6, 5 in f32 at NB = 17, 33, 41, 49), one line a
// thread:
//   x round, line (g, y), contiguous: a = Mb u, b = Kb u   (the line in registers, written back)
//   y round, line (g, x), stride NB:  v = geo (Mb b + Kb a) [+ the cell rows' 1-4 entries]
// The block's bricks come in with 16-byte cp.async copies, all in flight at once. The y round
// reads a and b from shared memory as it sums (no line in registers, so f64 at NB=49 does not
// spill) and stores straight to device memory, a warp's lanes on neighbouring x; the cell rows
// are read from device memory in the epilogue (1-4 values a node, in the order of the 3-D
// epilogue: y cells outer, then x). The rows and each row's band are written out at compile time
// (brick_band.cuh's each_row, band): left to `#pragma unroll`, the 33 x 33 loop with its band
// conditions stayed rolled (in its SASS at NB=33: 536 LDC factor loads, 443 ISETP, 169 branches,
// 528 FFMA; 0.5624 ms at 2-D quadrant nref=11 p=4 f32, 12x the bound); written out, 772 FFMA,
// each factor entry an operand (471 ULDC), no LDC.
// Bound on an H100 SXM at 2-D quadrant nref=11, p=4, f32 (16,646 bricks, NB=33, N3p=1152, 517
//   bricks with cell rows): memory, u's NB^2 nodes read once, v written with its padding, the
//   cell rows: 152.6 MB, 0.0455 ms at 3.35 TB/s (0.867 GFLOP, 0.013 ms at 67 TFLOP/s).
template <typename T, int NB, int P>
struct Cfg2 {
  static constexpr int B = (NB - 1) / P;
  static constexpr int N2 = NB * NB;
  static constexpr int N2R = (N2 + 3) / 4 * 4;  // a brick buffer, 16-byte aligned
  static constexpr int NL = (P + 1) * (P + 1);
  static constexpr int DC = B * B * NL;           // a brick's cell rows
  static constexpr int NNZ = row_offset<NB, P>(NB);
  static constexpr int BYTES = 2 * N2R * static_cast<int>(sizeof(T));  // shared memory a brick
  static constexpr int G0 = 256 / NB;
  static constexpr int G = G0 * BYTES <= 96 * 1024 ? G0 : (96 * 1024 / BYTES > 0 ? 96 * 1024 / BYTES : 1);
  static constexpr int THREADS = (G * NB + 31) / 32 * 32;
  static_assert(NNZ == 1 + B * P * (P + 2), "packed factor size");
};

template <typename T, int NB, int P>
__global__ void __launch_bounds__(Cfg2<T, NB, P>::THREADS)
brick_apply2_kernel(const T* __restrict__ u, const Factors<T, Cfg2<T, NB, P>::NNZ> f,
                    const T* __restrict__ geo, const T* __restrict__ dcols, T* __restrict__ v,
                    int nb, int m, int N3p, long long u_stride, int vec_u) {
  using S = Cfg2<T, NB, P>;
  constexpr int N2 = S::N2, G = S::G, N = P + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const s0 = reinterpret_cast<T*>(smem_raw);  // [G][N2R] the bricks, then a
  T* const s1 = s0 + G * S::N2R;                 // [G][N2R] b

  const size_t rhs = blockIdx.y;
  const int b0 = blockIdx.x * G;
  const int nbk = min(G, nb - b0);  // bricks of this block
  const T* const ub = u + rhs * u_stride;
  // the block's bricks, all in flight at once (16-byte cp.async copies; a brick's last word
  // reads up to 3 values of its padding, N2R <= N3p)
  for (int g = 0; g < nbk; ++g)
    stage(s0 + g * S::N2R, ub + static_cast<size_t>(b0 + g) * N3p, N2, vec_u);
  cp_async_commit();
  T* const vr = v + rhs * static_cast<size_t>(nb) * N3p;
  for (int g = 0; g < nbk; ++g) {  // the padding
    T* const vp = vr + static_cast<size_t>(b0 + g) * N3p;
    for (int i = N2 + threadIdx.x; i < N3p; i += S::THREADS) vp[i] = T(0);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int l = threadIdx.x, g = l / NB, c = l - g * NB;
  const bool active = g < nbk;
  // x round: line (g, y = c), contiguous; the line in registers, a and b written back over it
  if (active) {
    T* const row0 = s0 + g * S::N2R + c * NB;
    T* const row1 = s1 + g * S::N2R + c * NB;
    T r[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) r[j] = row0[j];
    each_row<NB>([&](auto ic) {
      constexpr int i = decltype(ic)::value;
      T a = T(0), b = T(0);
      band<NB, P, i>([&](auto e, auto j) {
        a += f.M[decltype(e)::value] * r[decltype(j)::value];
        b += f.K[decltype(e)::value] * r[decltype(j)::value];
      });
      row0[i] = a;
      row1[i] = b;
    });
  }
  __syncthreads();
  // y round: line (g, x = c), stride NB, straight to device memory
  if (active) {
    const int brick = b0 + g;
    const T* const a = s0 + g * S::N2R + c;
    const T* const b = s1 + g * S::N2R + c;
    const T gb = geo[brick];
    const bool rows = brick < m;
    int ox[2] = {0, 0};
    const int nx = axis_terms<NB, P>(c, S::NL, 1, ox);
    const T* const db = dcols + (rhs * m + brick) * S::DC;
    T* const vb = vr + static_cast<size_t>(brick) * N3p + c;
    each_row<NB>([&](auto ic) {
      constexpr int i = decltype(ic)::value;
      T acc = T(0);
      band<NB, P, i>([&](auto e, auto j) {
        constexpr int o = decltype(j)::value * NB;
        acc += f.M[decltype(e)::value] * b[o];  // one FMA a term
        acc += f.K[decltype(e)::value] * a[o];
      });
      T out = gb * acc;
      if (rows) {
        int oy[2] = {0, 0};
        const int ny = axis_terms<NB, P>(i, S::B * S::NL, N, oy);
        T corr = T(0);
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (p < ny && q < nx) corr += __ldg(db + oy[p] + ox[q]);
        out += corr;
      }
      vb[i * NB] = out;
    });
  }
}

template <typename T, int NB, int P>
int launch2(const void* u, const void* Kp, const void* Mp, const void* geo, const void* dcols,
            void* v, int nb, int m, int N3p, int k, long long u_stride, int* info,
            cudaStream_t stream) {
  using S = Cfg2<T, NB, P>;
  const int smem = S::G * S::BYTES;
  auto kernel = brick_apply2_kernel<T, NB, P>;
  static unsigned long long smem_set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(smem_set & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set |= bit;
  }
  if (info) {  // a dry run: report shared memory and blocks per SM, launch nothing
    info[0] = smem;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], kernel, S::THREADS, smem));
  }
  Factors<T, S::NNZ> f;
  std::memcpy(f.K, Kp, sizeof(f.K));
  std::memcpy(f.M, Mp, sizeof(f.M));
  // 16-byte copies need 16-byte rows; a brick's whole words must stay inside its row
  const int vec_u = reinterpret_cast<uintptr_t>(u) % 16 == 0 && (N3p * sizeof(T)) % 16 == 0 &&
                    (u_stride * sizeof(T)) % 16 == 0 && S::N2R <= N3p;
  const int blocks = (nb + S::G - 1) / S::G;
  if (blocks > 0 && k > 0) {
    kernel<<<dim3(blocks, k), S::THREADS, smem, stream>>>(
        static_cast<const T*>(u), f, static_cast<const T*>(geo), static_cast<const T*>(dcols),
        static_cast<T*>(v), nb, m, N3p, u_stride, vec_u);
  }
  return static_cast<int>(cudaGetLastError());
}

// Raise the kernel's dynamic shared-memory limit to its largest launch (with cell rows),
// once per device and instantiation: no attribute call on the launches after the first.
template <typename T, int NB, int P>
cudaError_t allow_smem() {
  using S = Cfg<T, NB, P>;
  static unsigned long long done = 0;  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(brick_apply_kernel<T, NB, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>((2 * S::N3R + S::SMEM_D) * sizeof(T)));
  if (err == cudaSuccess) done |= bit;
  return err;
}

template <typename T, int NB, int P>
int launch(const void* u, const void* Kp, const void* Mp, const void* geo, const void* dcols,
           void* v, int nb, int m, int N3p, int k, long long u_stride, int* info,
           cudaStream_t stream) {
  using S = Cfg<T, NB, P>;
  const int smem = static_cast<int>((2 * S::N3R + (m > 0 ? S::SMEM_D : 0)) * sizeof(T));
  cudaError_t err = allow_smem<T, NB, P>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info) {  // a dry run: report shared memory and blocks per SM, launch nothing
    info[0] = smem;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info[1], brick_apply_kernel<T, NB, P>, S::THREADS, smem));
  }
  Factors<T, S::NNZ> f;
  std::memcpy(f.K, Kp, sizeof(f.K));
  std::memcpy(f.M, Mp, sizeof(f.M));
  // 16-byte copies need 16-byte rows: N3p and the cell rows of a brick in whole words
  const int vec_u = reinterpret_cast<uintptr_t>(u) % 16 == 0 && (N3p * sizeof(T)) % 16 == 0 &&
                    (u_stride * sizeof(T)) % 16 == 0;
  const int vec_d = reinterpret_cast<uintptr_t>(dcols) % 16 == 0 && S::DC % S::VW == 0;
  if (nb > 0 && k > 0) {
    brick_apply_kernel<T, NB, P><<<dim3(nb, k), S::THREADS, smem, stream>>>(
        static_cast<const T*>(u), f, static_cast<const T*>(geo), static_cast<const T*>(dcols),
        static_cast<T*>(v), m, N3p, u_stride, vec_u, vec_d);
  }
  return static_cast<int>(cudaGetLastError());
}

// (NB, p) as the brick size rule gives them: B = 16, 8, 4 at p = 1, 2, 3 and 4; B = 2 at
// p = 5..8
template <typename T>
int dispatch(const void* u, const void* Kp, const void* Mp, const void* geo, const void* dcols,
             void* v, int nb, int m, int NB, int p, int N3p, int k, long long u_stride, int* info,
             int dim, cudaStream_t stream) {
  // 2-D: B = 16 at p = 1..3, B = 8 at p = 4..6
#define BRICK_CASE2(nb_, p_) \
  if (dim == 2 && NB == nb_ && p == p_) \
    return launch2<T, nb_, p_>(u, Kp, Mp, geo, dcols, v, nb, m, N3p, k, u_stride, info, stream);
  BRICK_CASE2(17, 1)
  BRICK_CASE2(33, 2)
  BRICK_CASE2(49, 3)
  BRICK_CASE2(33, 4)
  BRICK_CASE2(41, 5)
  BRICK_CASE2(49, 6)
#undef BRICK_CASE2
  if (dim != 3) return static_cast<int>(cudaErrorInvalidValue);
#define BRICK_CASE(nb_, p_) \
  if (NB == nb_ && p == p_) \
    return launch<T, nb_, p_>(u, Kp, Mp, geo, dcols, v, nb, m, N3p, k, u_stride, info, stream);
  BRICK_CASE(17, 1)
  BRICK_CASE(17, 2)
  BRICK_CASE(13, 3)
  BRICK_CASE(17, 4)
  BRICK_CASE(11, 5)
  BRICK_CASE(13, 6)
  BRICK_CASE(15, 7)
  BRICK_CASE(17, 8)
#undef BRICK_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Kp, Mp: host pointers to the packed factors (copied into the launch's parameters).
// k right-hand sides, u_stride values apart in u (n_bricks * N3p apart in v, m * B^3 cell rows
// apart in dcols).
// info: null to launch; else [shared-memory bytes, blocks per SM] of the launch, not launched.
// dim: 3 (NB^3-node bricks) or 2 (NB^2-node bricks, cell rows of (p+1)^2 values).
int brick_apply_f32(const void* u, const void* Kp, const void* Mp, const void* geo,
                    const void* dcols, void* v, int nb, int m, int NB, int p, int N3p, int k,
                    long long u_stride, int* info, int dim, void* stream) {
  return dispatch<float>(u, Kp, Mp, geo, dcols, v, nb, m, NB, p, N3p, k, u_stride, info, dim,
                         static_cast<cudaStream_t>(stream));
}

int brick_apply_f64(const void* u, const void* Kp, const void* Mp, const void* geo,
                    const void* dcols, void* v, int nb, int m, int NB, int p, int N3p, int k,
                    long long u_stride, int* info, int dim, void* stream) {
  return dispatch<double>(u, Kp, Mp, geo, dcols, v, nb, m, NB, p, N3p, k, u_stride, info, dim,
                          static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
