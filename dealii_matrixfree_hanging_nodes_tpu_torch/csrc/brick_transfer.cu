// brick_transfer: the brick GMG's transfer between two levels of global coarsening, brick vector
// to brick vector ([nb, N3p] each, NB = B p + 1 nodes a side, N3 = NB^3 of N3p used; cells of N^3
// nodes, N = p+1, node (z, y, x) of the cell at slot (sz, sy, sx) at ((sz p + z) NB + sy p + y) NB
// + sx p + x). Fine brick-cell row r (brick r / C, slot r % C, C = B^3) is covered by the coarse
// row src_lin[r] and embeds it with E[r] [3][N][N]; own[r][j] bit 0 marks the one writer of each
// fine node, bit 1 that writer where the fine dot mask W_f is 1.
//   prolongate (x the coarse bricks): fine brick b gets, for each present row r of it
//     (p_rows[p_ptr[b] .. p_ptr[b+1]]), the sweeps of E[r] on the coarse cell src_lin[r] read
//     from the coarse bricks, at the nodes r owns; every other node (holes) and the padding 0.
//   restrict (x the fine bricks; the exact adjoint with W_f): coarse brick b gets, for each of its
//     listed cells (r_slot[r_ptr[b][0] .. r_ptr[b][8]], in 8 parity classes), the sum of its fine
//     rows (c_rows[c_ptr[e] .. c_ptr[e+1]], ascending) through the transposed sweeps of
//     (own bit 1) * x at the row's nodes, overlap-added into the brick's nodes; 0 elsewhere.
//
// Replaces: BrickTransfer._pb (dealii_matrixfree_hanging_nodes_tpu/models/multigrid_bricks.py:
//   217-233: _extract_cols, the src_lin gather, the E_rows einsums, the own_w product,
//   _scatter_cols) and its jax.linear_transpose with yw = rf_b * wf in _restrict_impl (242-250);
//   XLA on the TPU (no Pallas kernel).
//
// Bound on an H100 SXM (brick_transfer.bytes_and_flops): memory. The input nodes the rows read,
//   read once, the output bricks written once, E (3 N^2 values a row), own (a bit a slot) and the
//   lists read once; the sweeps (6 N^4 flops a row) are small beside those bytes.
//
// Design: one block a brick of the output, which owns all of that brick's nodes: the brick is
//   summed in shared memory (zeroed first) and stored once, coalesced, so no atomics and no
//   memset. Rows go G at a time (transfer.cuh: about 256 lines), one thread a line: their nodes
//   are gathered from the input bricks into shared memory with their E, the sweeps run in place
//   (transfer.cuh). Prolongate: each owned node is written into the brick by its one writer.
//   Restrict: G coarse cells of one parity class walk their fine rows in step (row i of every
//   cell at once), each thread keeping its x-line of the cell's sum in registers; then the G
//   cells, which share no node, add their rows into the brick, class after class: every node
//   sums its 1-8 cells in class order, and every cell its rows in ascending order, so two calls
//   give the same bits.

#include <cuda_runtime.h>

#include <cstddef>

#include "sum_factorization.cuh"
#include "transfer.cuh"

namespace {

struct Lists {
  const int* src_lin;
  const unsigned char* own;
  const int* p_ptr;
  const int* p_rows;
  const int* r_ptr;
  const int* r_slot;
  const int* c_ptr;
  const int* c_rows;
};

// the brick node of local node j of the cell at slot s (DIM = 3 or 2)
template <int DIM, int P>
__device__ __forceinline__ int node(int s, int j, int B, int NB) {
  constexpr int N = P + 1;
  const int sx = s % B, sy = (s / B) % B, ix = j % N, iy = (j / N) % N;
  if constexpr (DIM == 2) return (sy * P + iy) * NB + sx * P + ix;
  const int sz = s / (B * B), iz = j / (N * N);
  return ((sz * P + iz) * NB + sy * P + iy) * NB + sx * P + ix;
}

// the embedding sweeps in DIM dimensions
template <typename T, int DIM, int N, bool TR>
__device__ __forceinline__ void sweeps(T* cell, const T* E, int j, bool active) {
  if constexpr (DIM == 3) {
    xfer::embed_sweeps<T, N, TR>(cell, E, j, active);
  } else {
    xfer::embed_sweeps2<T, N, TR>(cell, E, j, active);
  }
}

template <typename T, int DIM, int P>
__global__ void __launch_bounds__(xfer::Group<P + 1, DIM>::THREADS)
brick_transfer_prolongate_kernel(const T* __restrict__ x, const T* __restrict__ E, Lists l,
                                 T* __restrict__ out, int B, int N3p) {
  using Gr = xfer::Group<P + 1, DIM>;
  constexpr int N = P + 1, NN = Gr::LINES, NL = NN * N, EL = DIM * N * N;
  constexpr int G = Gr::G, THREADS = Gr::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // [N3p] the brick
  T* buf = acc + N3p;                       // [G NL] the rows
  T* e = buf + G * NL;                      // [G EL] their E
  const int tid = threadIdx.x;
  const int k = min(tid / NN, G - 1), j = tid - (tid / NN) * NN;
  const int NB = B * P + 1, C = DIM == 3 ? B * B * B : B * B;
  const int b = blockIdx.x;
  for (int i = tid; i < N3p; i += THREADS) acc[i] = T(0);
  const int r0 = l.p_ptr[b], r1 = l.p_ptr[b + 1];
  for (int g0 = r0; g0 < r1; g0 += G) {
    const int ng = min(G, r1 - g0);
    for (int t = tid; t < G * NL; t += THREADS) {
      const int c = t / NL;
      T v = T(0);
      if (c < ng) {
        const int lc = l.src_lin[l.p_rows[g0 + c]];
        v = x[static_cast<size_t>(lc / C) * N3p + node<DIM, P>(lc % C, t - c * NL, B, NB)];
      }
      buf[t] = v;
    }
    for (int t = tid; t < G * EL; t += THREADS) {
      const int c = t / EL;
      e[t] = c < ng ? E[static_cast<size_t>(l.p_rows[g0 + c]) * EL + (t - c * EL)] : T(0);
    }
    __syncthreads();
    sweeps<T, DIM, N, false>(buf + k * NL, e + k * EL, j, tid < ng * NN);
    for (int t = tid; t < ng * NL; t += THREADS) {
      const int c = t / NL, jj = t - c * NL;
      const int r = l.p_rows[g0 + c];
      if (l.own[static_cast<size_t>(r) * NL + jj] & 1) acc[node<DIM, P>(r % C, jj, B, NB)] = buf[t];
    }
    __syncthreads();
  }
  T* ob = out + static_cast<size_t>(b) * N3p;
  for (int i = tid; i < N3p; i += THREADS) ob[i] = acc[i];
}

template <typename T, int DIM, int P>
__global__ void __launch_bounds__(xfer::Group<P + 1, DIM>::THREADS)
brick_transfer_restrict_kernel(const T* __restrict__ x, const T* __restrict__ E, Lists l,
                               T* __restrict__ out, int B, int N3p) {
  using Gr = xfer::Group<P + 1, DIM>;
  constexpr int N = P + 1, NN = Gr::LINES, NL = NN * N, EL = DIM * N * N;
  constexpr int G = Gr::G, THREADS = Gr::THREADS, NCLS = 1 << DIM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);
  T* buf = acc + N3p;
  T* e = buf + G * NL;
  __shared__ int s_cls[NCLS + 1];
  __shared__ int s_ptr[G + 1];
  __shared__ int s_max;
  const int tid = threadIdx.x;
  const int k = min(tid / NN, G - 1), j = tid - (tid / NN) * NN;
  const int NB = B * P + 1, C = DIM == 3 ? B * B * B : B * B;
  const int b = blockIdx.x;
  for (int i = tid; i < N3p; i += THREADS) acc[i] = T(0);
  if (tid <= NCLS) s_cls[tid] = l.r_ptr[b * (NCLS + 1) + tid];
  int base = j * N;  // this thread's x-line after the sweeps (2-D: line j along x)
  if constexpr (DIM == 3) {
    int ca, cb;
    base = hn::line_base<N, 0>(j, ca, cb);
  }
  __syncthreads();
  for (int cls = 0; cls < NCLS; ++cls) {
    for (int e0 = s_cls[cls]; e0 < s_cls[cls + 1]; e0 += G) {
      const int ng = min(G, s_cls[cls + 1] - e0);
      if (tid <= ng) s_ptr[tid] = l.c_ptr[e0 + tid];
      __syncthreads();
      if (tid == 0) {
        int m = 0;
        for (int c = 0; c < ng; ++c) m = max(m, s_ptr[c + 1] - s_ptr[c]);
        s_max = m;
      }
      __syncthreads();
      const bool line = tid < ng * NN;
      const int cnt = line ? s_ptr[k + 1] - s_ptr[k] : 0;
      T sum[N];
#pragma unroll
      for (int q = 0; q < N; ++q) sum[q] = T(0);
      for (int i = 0; i < s_max; ++i) {
        for (int t = tid; t < G * NL; t += THREADS) {
          const int c = t / NL;
          T v = T(0);
          if (c < ng && i < s_ptr[c + 1] - s_ptr[c]) {
            const int r = l.c_rows[s_ptr[c] + i], jj = t - c * NL;
            if (l.own[static_cast<size_t>(r) * NL + jj] & 2) {
              v = x[static_cast<size_t>(r / C) * N3p + node<DIM, P>(r % C, jj, B, NB)];
            }
          }
          buf[t] = v;
        }
        for (int t = tid; t < G * EL; t += THREADS) {
          const int c = t / EL;
          e[t] = c < ng && i < s_ptr[c + 1] - s_ptr[c]
                     ? E[static_cast<size_t>(l.c_rows[s_ptr[c] + i]) * EL + (t - c * EL)]
                     : T(0);
        }
        __syncthreads();
        const bool active = line && i < cnt;
        sweeps<T, DIM, N, true>(buf + k * NL, e + k * EL, j, active);
        if (active) {
#pragma unroll
          for (int q = 0; q < N; ++q) sum[q] += buf[k * NL + base + q];
        }
        __syncthreads();
      }
      if (line) {  // the class's cells share no node: no two threads add into one
        const int s = l.r_slot[e0 + k];
#pragma unroll
        for (int q = 0; q < N; ++q) acc[node<DIM, P>(s, base + q, B, NB)] += sum[q];
      }
      __syncthreads();
    }
  }
  T* ob = out + static_cast<size_t>(b) * N3p;
  for (int i = tid; i < N3p; i += THREADS) ob[i] = acc[i];
}

template <typename T, int DIM, int P>
int launch(const T* x, const T* E, const Lists& l, T* out, int nb_f, int nb_c, int B, int N3p,
           int restrict_, cudaStream_t stream) {
  using Gr = xfer::Group<P + 1, DIM>;
  constexpr int N = P + 1;
  const int smem =
      static_cast<int>((N3p + Gr::G * (Gr::LINES * N + DIM * N * N)) * sizeof(T));
  const int blocks = restrict_ ? nb_c : nb_f;
  cudaError_t err;
  if (restrict_) {
    static unsigned long long smem_set = 0;
    err = sf::allow_smem_once(brick_transfer_restrict_kernel<T, DIM, P>, 232448 - 1024,
                              smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks > 0) {
      brick_transfer_restrict_kernel<T, DIM, P><<<blocks, Gr::THREADS, smem, stream>>>(
          x, E, l, out, B, N3p);
    }
  } else {
    static unsigned long long smem_set = 0;
    err = sf::allow_smem_once(brick_transfer_prolongate_kernel<T, DIM, P>, 232448 - 1024,
                              smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks > 0) {
      brick_transfer_prolongate_kernel<T, DIM, P><<<blocks, Gr::THREADS, smem, stream>>>(
          x, E, l, out, B, N3p);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* const* a, void* out, int nb_f, int nb_c, int p, int B, int N3p,
             int restrict_, int dim, cudaStream_t stream) {
  const T* x = static_cast<const T*>(a[0]);
  const T* E = static_cast<const T*>(a[2]);
  Lists l{static_cast<const int*>(a[1]), static_cast<const unsigned char*>(a[3]),
          static_cast<const int*>(a[4]), static_cast<const int*>(a[5]),
          static_cast<const int*>(a[6]), static_cast<const int*>(a[7]),
          static_cast<const int*>(a[8]), static_cast<const int*>(a[9])};
  T* o = static_cast<T*>(out);
  if (dim == 2) {
#define BT_CASE2(p_) \
  case p_: return launch<T, 2, p_>(x, E, l, o, nb_f, nb_c, B, N3p, restrict_, stream);
    switch (p) {
      BT_CASE2(1)
      BT_CASE2(2)
      BT_CASE2(3)
      BT_CASE2(4)
      BT_CASE2(5)
      BT_CASE2(6)
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef BT_CASE2
  }
  if (dim != 3) return static_cast<int>(cudaErrorInvalidValue);
#define BT_CASE(p_) \
  case p_: return launch<T, 3, p_>(x, E, l, o, nb_f, nb_c, B, N3p, restrict_, stream);
  switch (p) {
    BT_CASE(1)
    BT_CASE(2)
    BT_CASE(3)
    BT_CASE(4)
    BT_CASE(5)
    BT_CASE(6)
    BT_CASE(7)
    BT_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BT_CASE
}

}  // namespace

extern "C" {

// x, src_lin, E, own, p_ptr, p_rows, r_ptr, r_slot, c_ptr, c_rows, out: device pointers;
// dim: 3, or 2 (NB^2-node bricks, E [nlin_f][2][N][N], r_ptr [nb_c][5])
int brick_transfer_f32(const void* x, const void* src_lin, const void* E, const void* own,
                       const void* p_ptr, const void* p_rows, const void* r_ptr,
                       const void* r_slot, const void* c_ptr, const void* c_rows, void* out,
                       int nb_f, int nb_c, int p, int B, int N3p, int restrict_, int dim,
                       void* stream) {
  const void* a[10] = {x, src_lin, E, own, p_ptr, p_rows, r_ptr, r_slot, c_ptr, c_rows};
  return dispatch<float>(a, out, nb_f, nb_c, p, B, N3p, restrict_, dim,
                         static_cast<cudaStream_t>(stream));
}

int brick_transfer_f64(const void* x, const void* src_lin, const void* E, const void* own,
                       const void* p_ptr, const void* p_rows, const void* r_ptr,
                       const void* r_slot, const void* c_ptr, const void* c_rows, void* out,
                       int nb_f, int nb_c, int p, int B, int N3p, int restrict_, int dim,
                       void* stream) {
  const void* a[10] = {x, src_lin, E, own, p_ptr, p_rows, r_ptr, r_slot, c_ptr, c_rows};
  return dispatch<double>(a, out, nb_f, nb_c, p, B, N3p, restrict_, dim,
                          static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
