// cell_transfer: the index engine's GMG transfer between two levels of global coarsening, on cell
// rows of N^DIM values (N = p+1, x fastest; DIM 3 or 2). Fine cell f is covered by the coarse
// cell cover[f] and embeds it with E[f] [DIM][N][N]; own[f][j] marks the one owner (f, j) of each
// fine DoF. The children of coarse cell c are child[child_ptr[c] .. child_ptr[c+1]] (ascending;
// the inverse of cover): a coarse cell and its children are a family.
//   prolongate: x the coarse rows [n_c][N^DIM] (read_dof_values of the coarse vector), out the fine
//     DoF vector [n_fine_dofs]: u_f = sweeps of E[f] on x[cover[f]]; out[cdf[f][j]] = u_f[j]
//     where own[f][j]. Every fine DoF has one owner, so every entry is written once.
//   restrict: x the fine DoF vector, out the coarse rows [n_c][N^DIM]: row c = the sum over its
//     children (ascending) of the transposed sweeps of own[f] * x[cdf[f]]; a coarse cell without
//     children gets 0.
//
// Replaces: Transfer.prolongate and Transfer.restrict (dealii_matrixfree_hanging_nodes_tpu/
//   models/multigrid.py:274-296): the cover gather, the _embed / _embed_t einsums (253-271),
//   .at[cdf].add and .at[cover].add; XLA on the TPU (no Pallas kernel).
//
// Bound on an H100 SXM (cell_transfer.bytes_and_flops): memory. x read once, out written once,
//   E (DIM N^2 values a fine cell), cdf (int32, at the owned slots) and own (a bit a slot) read
//   once; the DIM sweeps (2 DIM N^(DIM+1) flops a fine cell) are small beside those bytes.
//
// Design: one thread a line of a fine cell, about 256 lines a block; a block's loads are issued
//   together before its first barrier; the sweeps run in shared memory (transfer.cuh).
//   Restrict: a block takes whole families by a host schedule `blocks` [n_blocks+1][3]
//   (cell_transfer.schedule: each block's first coarse cell, its first position in the child
//   lists, and its first fine cell where its children are consecutive fine cells, else -1):
//   the most refined families within 256 lines (transfer.cuh's Families; a refined 3-D family
//   at p=5, 6 is 288, 392 lines, and its block takes that many threads). Every child's
//   own * x[cdf] is gathered (own and cdf read together, then x) and swept at once, so a block
//   makes one pass and a small level spreads over many blocks (nref 3 at p=2: 5); then each
//   value of each coarse row sums its family's children in ascending order from shared memory
//   and is written once (coalesced).
//   Prolongate: a block takes G consecutive fine cells (transfer.cuh's Group), each gathering
//   its coarse row x[cover[f]] (the siblings' rows hit in L1; whole families a block would
//   leave a 3-D p=4 block 200 of 224 threads busy), with own and cdf read before the barrier,
//   one register a slot (cdf where owned, else -1); the owned slots go straight into out (one
//   writer a DoF: no atomics, no memset).
//   Sums run from 0 in ascending child order: fixed order, no atomics, two calls give the same
//   bits.

#include <cuda_runtime.h>

#include <cstddef>

#include "transfer.cuh"

namespace {

template <typename T, int DIM, int P>
struct Layout {
  using F = xfer::Families<P + 1, DIM>;
  using Gr = xfer::Group<P + 1, DIM>;
  static constexpr int N = P + 1, NN = F::LINES, NL = NN * N, EL = DIM * N * N;
  static constexpr int MAXF = F::MAXF, THREADS = F::THREADS;  // restrict
  static constexpr int G = Gr::G, PTHREADS = Gr::THREADS;     // prolongate
  // restrict's dynamic shared memory: the children's rows and E
  static constexpr size_t BYTES = sizeof(T) * static_cast<size_t>(MAXF) * (NL + EL);
};

// the DIM sweeps of a cell, line j, in place
template <typename T, int DIM, int N, bool TR>
__device__ __forceinline__ void sweeps(T* cell, const T* E, int j, bool active) {
  if constexpr (DIM == 3) {
    xfer::embed_sweeps<T, N, TR>(cell, E, j, active);
  } else {
    xfer::embed_sweeps2<T, N, TR>(cell, E, j, active);
  }
}

template <typename T, int DIM, int P>
__global__ void __launch_bounds__(Layout<T, DIM, P>::PTHREADS)
cell_transfer_prolongate_kernel(const T* __restrict__ x, const T* __restrict__ E,
                                const int* __restrict__ cdf,
                                const unsigned char* __restrict__ own,
                                const int* __restrict__ cover, T* __restrict__ out, int n_f) {
  using L = Layout<T, DIM, P>;
  constexpr int N = L::N, NN = L::NN, NL = L::NL, EL = L::EL, G = L::G;
  constexpr int THREADS = L::PTHREADS, ITERS = (G * NL + THREADS - 1) / THREADS;
  __shared__ T buf[G * NL];
  __shared__ T e[G * EL];
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * G, ng = min(G, n_f - f0);
  for (int t = tid; t < ng * NL; t += THREADS) {
    const int k = t / NL;
    buf[t] = __ldg(x + static_cast<size_t>(__ldg(cover + f0 + k)) * NL + (t - k * NL));
  }
  for (int t = tid; t < ng * EL; t += THREADS) e[t] = __ldg(E + static_cast<size_t>(f0) * EL + t);
  int d[ITERS];  // the DoF each of the thread's slots writes, -1 where it owns none
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int t = tid + it * THREADS;
    d[it] = -1;
    if (t < ng * NL) {
      const size_t s = static_cast<size_t>(f0) * NL + t;
      const unsigned char o = __ldg(own + s);
      const int c = __ldg(cdf + s);
      d[it] = o ? c : -1;
    }
  }
  __syncthreads();
  const int k = min(tid / NN, G - 1), j = tid - (tid / NN) * NN;
  sweeps<T, DIM, N, false>(buf + k * NL, e + k * EL, j, tid < ng * NN);
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    if (d[it] >= 0) out[d[it]] = buf[tid + it * THREADS];
  }
}

template <typename T, int DIM, int P>
__global__ void __launch_bounds__(Layout<T, DIM, P>::THREADS)
cell_transfer_restrict_kernel(const T* __restrict__ x, const T* __restrict__ E,
                              const int* __restrict__ cdf, const unsigned char* __restrict__ own,
                              const int* __restrict__ child_ptr, const int* __restrict__ child,
                              const int* __restrict__ blocks, T* __restrict__ out) {
  using L = Layout<T, DIM, P>;
  constexpr int N = L::N, NN = L::NN, NL = L::NL, EL = L::EL, MAXF = L::MAXF;
  constexpr int THREADS = L::THREADS, ITERS = (MAXF * NL + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);  // [MAXF][NL] the children
  T* e = buf + MAXF * NL;               // [MAXF][EL]
  __shared__ int s_ptr[MAXF + 1];       // each coarse cell's first child, block-local
  const int tid = threadIdx.x;
  const int* bk = blocks + 3 * blockIdx.x;
  const int c0 = __ldg(bk), p0 = __ldg(bk + 1), cf = __ldg(bk + 2);
  const int nc = __ldg(bk + 3) - c0, nf = __ldg(bk + 4) - p0;
  if (nc > MAXF || nf > MAXF) __trap();  // not a schedule of this instance
  // the block's q-th fine cell: consecutive from cf, else listed
  auto fine = [&](int q) { return cf >= 0 ? cf + q : __ldg(child + p0 + q); };
  if (tid <= nc) s_ptr[tid] = __ldg(child_ptr + c0 + tid) - p0;
  for (int t = tid; t < nf * EL; t += THREADS) {
    const int k = t / EL;
    e[t] = __ldg(E + static_cast<size_t>(fine(k)) * EL + (t - k * EL));
  }
  int d[ITERS];  // the DoF each of the thread's slots reads, -1 where it owns none
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int t = tid + it * THREADS, q = t / NL;
    d[it] = -1;
    if (t < nf * NL) {
      const size_t s = static_cast<size_t>(fine(q)) * NL + (t - q * NL);
      const unsigned char o = __ldg(own + s);
      const int c = __ldg(cdf + s);
      d[it] = o ? c : -1;
    }
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int t = tid + it * THREADS;
    if (t < nf * NL) buf[t] = d[it] >= 0 ? __ldg(x + d[it]) : T(0);
  }
  __syncthreads();
  const int k = min(tid / NN, MAXF - 1), j = tid - (tid / NN) * NN;
  sweeps<T, DIM, N, true>(buf + k * NL, e + k * EL, j, tid < nf * NN);
  for (int t = tid; t < nc * NL; t += THREADS) {
    const int c = t / NL, v = t - c * NL;
    T acc = T(0);
    for (int q = s_ptr[c]; q < s_ptr[c + 1]; ++q) acc += buf[q * NL + v];
    out[static_cast<size_t>(c0) * NL + t] = acc;
  }
}

template <typename T, int DIM, int P>
int launch(const void* const* a, void* out, int n_f, int n_blocks, int restrict_,
           cudaStream_t stream) {
  using L = Layout<T, DIM, P>;
  const T* x = static_cast<const T*>(a[0]);
  const T* E = static_cast<const T*>(a[1]);
  const int* cdf = static_cast<const int*>(a[2]);
  const auto* own = static_cast<const unsigned char*>(a[3]);
  if (!restrict_) {
    if (n_f > 0) {
      const int blocks = (n_f + L::G - 1) / L::G;
      cell_transfer_prolongate_kernel<T, DIM, P><<<blocks, L::PTHREADS, 0, stream>>>(
          x, E, cdf, own, static_cast<const int*>(a[4]), static_cast<T*>(out), n_f);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (n_blocks > 0) {
    auto kernel = cell_transfer_restrict_kernel<T, DIM, P>;
    if (L::BYTES > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::BYTES));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<n_blocks, L::THREADS, L::BYTES, stream>>>(
        x, E, cdf, own, static_cast<const int*>(a[5]), static_cast<const int*>(a[6]),
        static_cast<const int*>(a[7]), static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DIM>
int by_degree(const void* const* a, void* out, int n_f, int n_blocks, int p, int restrict_,
              cudaStream_t stream) {
  switch (p) {
    case 1: return launch<T, DIM, 1>(a, out, n_f, n_blocks, restrict_, stream);
    case 2: return launch<T, DIM, 2>(a, out, n_f, n_blocks, restrict_, stream);
    case 3: return launch<T, DIM, 3>(a, out, n_f, n_blocks, restrict_, stream);
    case 4: return launch<T, DIM, 4>(a, out, n_f, n_blocks, restrict_, stream);
    case 5: return launch<T, DIM, 5>(a, out, n_f, n_blocks, restrict_, stream);
    case 6: return launch<T, DIM, 6>(a, out, n_f, n_blocks, restrict_, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* const* a, void* out, int n_f, int n_blocks, int p, int restrict_,
             int dim, cudaStream_t stream) {
  if (dim == 3) return by_degree<T, 3>(a, out, n_f, n_blocks, p, restrict_, stream);
  if (dim == 2) return by_degree<T, 2>(a, out, n_f, n_blocks, p, restrict_, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// x, E, cdf, own, cover, child_ptr, child, blocks, out: device pointers; n_f fine cells;
// n_blocks: the schedule's blocks (blocks holds n_blocks + 1 rows; restrict reads it,
// prolongate reads cover); dim: 3 or 2
int cell_transfer_f32(const void* x, const void* E, const void* cdf, const void* own,
                      const void* cover, const void* child_ptr, const void* child,
                      const void* blocks, void* out, int n_f, int n_blocks, int p, int restrict_,
                      int dim, void* stream) {
  const void* a[8] = {x, E, cdf, own, cover, child_ptr, child, blocks};
  return dispatch<float>(a, out, n_f, n_blocks, p, restrict_, dim,
                         static_cast<cudaStream_t>(stream));
}

int cell_transfer_f64(const void* x, const void* E, const void* cdf, const void* own,
                      const void* cover, const void* child_ptr, const void* child,
                      const void* blocks, void* out, int n_f, int n_blocks, int p, int restrict_,
                      int dim, void* stream) {
  const void* a[8] = {x, E, cdf, own, cover, child_ptr, child, blocks};
  return dispatch<double>(a, out, n_f, n_blocks, p, restrict_, dim,
                          static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
