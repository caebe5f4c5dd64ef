// brick_transfer: the brick GMG's transfer between two levels of global coarsening, brick vector
// to brick vector ([nb, N3p] each, NB = B p + 1 nodes a side, N3 = NB^3 of N3p used; cells of N^3
// nodes, N = p+1, node (z, y, x) of the cell at slot (sz, sy, sx) at ((sz p + z) NB + sy p + y) NB
// + sx p + x). Fine brick-cell row r (brick r / C, slot r % C, C = B^3) is covered by the coarse
// row src_lin[r] and embeds it with E[r] [3][N][N]; own[r][j] bit 0 marks the one writer of each
// fine node, bit 1 that writer where the fine dot mask W_f is 1.
//   prolongate (x the coarse bricks): fine brick b gets, for each of its rows that own a node,
//     the sweeps of E[r] on the coarse cell src_lin[r] read from the coarse bricks, at the nodes
//     r owns; every other node (holes) and the padding 0.
//   restrict (x the fine bricks; the exact adjoint with W_f): coarse brick b gets, for each of its
//     listed cells (r_ptr[b][0 .. 8], in 8 parity classes), the sum of its fine rows (c_rows,
//     ascending) through the transposed sweeps of (own bit 1) * x at the row's nodes,
//     overlap-added into the brick's nodes; 0 elsewhere.
// 2-D (DIM = 2): NB^2-node bricks, E [2][N][N], 4 parity classes.
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
// Design: every instance takes B = bricks.auto_brick_size(p, dim), the only brick size the
//   engine makes, as a compile-time constant (Cfg), so C, NB and N3p are constants: a slot's
//   first node is shifts and multiplies, and a cell node's offset comes from a table of N^DIM
//   entries in shared memory. A block owns whole output bricks' nodes (or, in restrict, one
//   parity class's), sums in shared memory and stores coalesced: no atomics, no memset, and two
//   calls give the same bits. A round takes as many rows as the shared memory holds in float64
//   (Cfg::PROWS, RROWS; brick_transfer.round_rows), the lines dealt out to 512 threads (256 in
//   2-D), one barrier a sweep (transfer.cuh: sweep_rows). A round first puts its rows' (and
//   parents') indices in shared memory, then gathers its values with 4 loads in flight a thread
//   (gather), so a thread does not wait a load's latency an item. The launch bounds hold the
//   registers to what lets as many blocks stay resident as the shared memory allows.
//   Prolongate: one block a fine brick, its rows in rounds of a host schedule (p_sched,
//     p_bround; 3-D p=4: one round of up to 64 rows): the round's distinct parent cells (p_par,
//     mean 7.9 a brick at 3-D p=4) are read from the coarse bricks once, with the rows' E and own
//     bits; each row's first sweep reads its parent (p_slot) from shared memory; each owned node
//     is written into the brick by its one writer.
//   Restrict: a thread block cluster of 2^DIM blocks a coarse brick (Hopper's distributed
//     shared memory), block rank = parity class. A block sweeps all of its class's rows at once
//     (in 2-D and at 3-D p >= 3 a class's rows fit one round; at 3-D p <= 2 more rounds carry
//     the sums in the accumulator) and sums each cell's rows in ascending order into a
//     brick-sized accumulator of its own (the cells of a class share no node, so one thread a
//     (cell, node) adds that cell's rows in turn; the class's cells' row pointers and first
//     nodes sit in shared memory). After cluster.sync() each block sums a 2^-DIM share of the
//     brick's nodes over the 2^DIM accumulators in class order, read through distributed shared
//     memory, and stores it; a second cluster.sync() keeps every accumulator alive until read.
//     Every node sums from 0 in class order, then each cell's rows ascending (the CPU plain
//     version's order), and with 2^DIM blocks a brick a block takes few rounds (3-D p=4: one).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "sum_factorization.cuh"
#include "transfer.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SMEM_BYTES = 232448 - 1024;  // a block's dynamic shared memory (brick_transfer.py)
constexpr int U = 4;                       // loads a thread keeps in flight in a gather

constexpr int ipow(int b, int e) { return e == 0 ? 1 : b * ipow(b, e - 1); }
constexpr int cmin(int a, int b) { return a < b ? a : b; }

// bricks.py:auto_brick_size: the largest B in (2, 4, 8, 16) with (B p + 1)^dim within the cap
constexpr int brick_size(int p, int dim) {
  int best = 2;
  for (int B = 2; B <= 16; B *= 2) {
    if (ipow(B * p + 1, dim) <= (dim == 3 ? 5100 : 2600)) best = B;
  }
  return best;
}

struct Lists {
  const unsigned char* own;
  const int* p_rows;
  const int* p_sched;
  const int* p_bround;
  const int* p_par;
  const int* p_slot;
  const int* r_ptr;
  const int* r_slot;
  const int* c_ptr;
  const int* c_rows;
};

template <int DIM, int P>
struct Cfg {
  static constexpr int N = P + 1, B = brick_size(P, DIM), NB = B * P + 1, C = ipow(B, DIM);
  static constexpr int N3P = (ipow(NB, DIM) + 127) / 128 * 128;
  static constexpr int NL = ipow(N, DIM), EL = DIM * N * N, NCLS = 1 << DIM;
  // 3-D: 512 threads (a 3-D p=4 round sweeps up to 1,600 lines); 2-D: 256, so more of the
  // many small bricks' blocks are resident at once
  static constexpr int THREADS = DIM == 3 ? 512 : 256;
  // __launch_bounds__' blocks an SM, a register cap of 65536 / (THREADS MIN_BLOCKS): as many
  // as the shared memory holds in float32 (3-D prolongate 2, restrict 3; 2-D 7, 8)
  static constexpr int PRO_MIN_BLOCKS = DIM == 3 ? 2 : 7, RES_MIN_BLOCKS = DIM == 3 ? 3 : 8;
  static constexpr int CELLS = C / NCLS;  // the cells of a parity class
  // rows (and prolongate's parents) a round: what fits SMEM_BYTES in float64 beside the brick
  // (brick_transfer.round_rows)
  static constexpr int FIXED = 8 * N3P + 4 * NL;
  static constexpr int PROWS = cmin(C, (SMEM_BYTES - FIXED) / (8 * (2 * NL + EL) + 16));
  static constexpr int RROWS =
      cmin(C, (SMEM_BYTES - FIXED - 8 * CELLS - 4) / (8 * (NL + EL) + 8));
  static constexpr int MINE = (PROWS * NL + THREADS - 1) / THREADS;  // a thread's round nodes
  static_assert(PROWS >= 1 && RROWS >= 1 && N3P % NCLS == 0, "a round holds a row");
  static_assert(MINE <= 32, "a thread's owned bits fit a word");

  template <typename T>
  static constexpr size_t prolongate_smem() {
    return sizeof(T) * (N3P + PROWS * (2 * NL + EL)) + 4 * (NL + 4 * PROWS);
  }
  template <typename T>
  static constexpr size_t restrict_smem() {
    return sizeof(T) * (N3P + RROWS * (NL + EL)) + 4 * (NL + 2 * RROWS + 2 * CELLS + 1);
  }

  // the brick node of slot s's first node
  __device__ static __forceinline__ int base(int s) {
    const int sx = s % B, sy = (s / B) % B;
    if constexpr (DIM == 2) {
      return sy * P * NB + sx * P;
    } else {
      return ((s / (B * B)) * P * NB + sy * P) * NB + sx * P;
    }
  }
  // the first node of brick-cell row r in a brick vector
  __device__ static __forceinline__ int row_base(int r) { return (r / C) * N3P + base(r % C); }
  // local node j's (x fastest) offset from its cell's first node
  __device__ static __forceinline__ int offset(int j) {
    const int ix = j % N, iy = (j / N) % N;
    if constexpr (DIM == 2) {
      return iy * NB + ix;
    } else {
      return ((j / (N * N)) * NB + iy) * NB + ix;
    }
  }
};

// out(i, in(i)) for i < n, the n items dealt out to the threads in turn; a thread issues the
// loads of U items before their stores, so U of its loads are in flight at once
template <int THREADS, typename In, typename Out>
__device__ __forceinline__ void gather(int n, In in, Out out) {
  for (int i0 = threadIdx.x; i0 < n; i0 += U * THREADS) {
    decltype(in(0)) v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u * THREADS < n) v[u] = in(i0 + u * THREADS);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u * THREADS < n) out(i0 + u * THREADS, v[u]);
    }
  }
}

template <typename T, int DIM, int P>
__global__ void __launch_bounds__(Cfg<DIM, P>::THREADS, Cfg<DIM, P>::PRO_MIN_BLOCKS)
brick_transfer_prolongate_kernel(const T* __restrict__ x, const T* __restrict__ E, Lists l,
                                 T* __restrict__ out) {
  using K = Cfg<DIM, P>;
  constexpr int NL = K::NL, EL = K::EL, ROWS = K::PROWS, THREADS = K::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);             // [N3P] the fine brick
  T* par = acc + K::N3P;                               // [ROWS NL] the round's parent cells
  T* buf = par + ROWS * NL;                            // [ROWS NL] its rows
  T* e = buf + ROWS * NL;                              // [ROWS EL] their E
  int* s_off = reinterpret_cast<int*>(e + ROWS * EL);  // [NL] a cell node's offset
  int* s_row = s_off + NL;                             // [ROWS] the round's rows
  int* s_dst = s_row + ROWS;                           // [ROWS] their first node in the brick
  int* s_slot = s_dst + ROWS;                          // [ROWS] their parent's place in par
  int* s_par = s_slot + ROWS;                          // [ROWS] the parents' first node in x
  const int tid = threadIdx.x, b = blockIdx.x;
  for (int i = tid; i < K::N3P; i += THREADS) acc[i] = T(0);
  for (int j = tid; j < NL; j += THREADS) s_off[j] = K::offset(j);
  const int k1 = l.p_bround[b + 1];
  for (int k = l.p_bround[b]; k < k1; ++k) {
    const int row0 = l.p_sched[2 * k], par0 = l.p_sched[2 * k + 1];
    const int nr = l.p_sched[2 * k + 2] - row0, np = l.p_sched[2 * k + 3] - par0;
    if (nr > ROWS || np > ROWS) __trap();  // a schedule made for another round size
    __syncthreads();  // s_off written; the last round's buffers read
    for (int i = tid; i < nr; i += THREADS) {
      const int r = l.p_rows[row0 + i];
      s_row[i] = r;
      s_dst[i] = K::base(r % K::C);
      s_slot[i] = l.p_slot[row0 + i];
    }
    for (int i = tid; i < np; i += THREADS) s_par[i] = K::row_base(l.p_par[par0 + i]);
    __syncthreads();
    gather<THREADS>(np * NL, [&](int i) {
      const int q = i / NL;
      return x[s_par[q] + s_off[i - q * NL]];
    }, [&](int i, T v) { par[i] = v; });
    gather<THREADS>(nr * EL, [&](int i) {
      const int q = i / EL;
      return E[static_cast<size_t>(s_row[q]) * EL + (i - q * EL)];
    }, [&](int i, T v) { e[i] = v; });
    unsigned mine = 0;  // bit m: this thread's node tid + m THREADS of the round is owned
#pragma unroll
    for (int m = 0; m < K::MINE; ++m) {
      const int i = tid + m * THREADS, q = i / NL;
      if (i < nr * NL) mine |= (l.own[static_cast<size_t>(s_row[q]) * NL + (i - q * NL)] & 1u) << m;
    }
    __syncthreads();
    xfer::embed_rows_from<T, DIM, K::N, THREADS>(par, s_slot, buf, e, nr);
#pragma unroll
    for (int m = 0; m < K::MINE; ++m) {
      const int i = tid + m * THREADS, q = i / NL;
      if ((mine >> m) & 1u) acc[s_dst[q] + s_off[i - q * NL]] = buf[i];
    }
  }
  __syncthreads();
  T* ob = out + static_cast<size_t>(b) * K::N3P;
  for (int i = tid; i < K::N3P; i += THREADS) ob[i] = acc[i];
}

template <typename T, int DIM, int P>
__global__ void __launch_bounds__(Cfg<DIM, P>::THREADS, Cfg<DIM, P>::RES_MIN_BLOCKS)
brick_transfer_restrict_kernel(const T* __restrict__ x, const T* __restrict__ E, Lists l,
                               T* __restrict__ out) {
  using K = Cfg<DIM, P>;
  constexpr int NL = K::NL, EL = K::EL, ROWS = K::RROWS, NCLS = K::NCLS, THREADS = K::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);             // [N3P] this class's cells' sums
  T* buf = acc + K::N3P;                               // [ROWS NL] the round's rows
  T* e = buf + ROWS * NL;                              // [ROWS EL] their E
  int* s_off = reinterpret_cast<int*>(e + ROWS * EL);  // [NL] a cell node's offset
  int* s_row = s_off + NL;                             // [ROWS] the round's rows
  int* s_src = s_row + ROWS;                           // [ROWS] their first node in x
  int* s_cptr = s_src + ROWS;                          // [CELLS + 1] the class's cells' rows
  int* s_cbase = s_cptr + K::CELLS + 1;                // [CELLS] their first node in the brick
  cg::cluster_group cluster = cg::this_cluster();
  const int cls = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, b = blockIdx.x / NCLS;
  for (int i = tid; i < K::N3P; i += THREADS) acc[i] = T(0);
  for (int j = tid; j < NL; j += THREADS) s_off[j] = K::offset(j);
  const int* rp = l.r_ptr + b * (NCLS + 1) + cls;
  const int e0 = rp[0], n_cells = rp[1] - e0;
  if (n_cells > K::CELLS) __trap();  // lists made for another brick size
  for (int i = tid; i <= n_cells; i += THREADS) {
    s_cptr[i] = l.c_ptr[e0 + i];
    if (i < n_cells) s_cbase[i] = K::base(l.r_slot[e0 + i]);
  }
  __syncthreads();
  const int first = s_cptr[0], last = s_cptr[n_cells];
  for (int g0 = first; g0 < last; g0 += ROWS) {
    const int ng = min(ROWS, last - g0);
    if (g0 > first) __syncthreads();  // the last round's buffers read
    for (int i = tid; i < ng; i += THREADS) {
      const int r = l.c_rows[g0 + i];
      s_row[i] = r;
      s_src[i] = K::row_base(r);
    }
    __syncthreads();
    gather<THREADS>(ng * EL, [&](int i) {
      const int q = i / EL;
      return E[static_cast<size_t>(s_row[q]) * EL + (i - q * EL)];
    }, [&](int i, T v) { e[i] = v; });
    gather<THREADS>(ng * NL, [&](int i) {
      const int q = i / NL, j = i - q * NL;
      const T v = x[s_src[q] + s_off[j]];
      return (l.own[static_cast<size_t>(s_row[q]) * NL + j] & 2) ? v : T(0);
    }, [&](int i, T v) { buf[i] = v; });
    __syncthreads();
    xfer::embed_rows_t<T, DIM, K::N, THREADS>(buf, e, ng);
    // one thread a (cell, node): the cell's rows in the round added in ascending order to what
    // its earlier rounds left (the cells of a class share no node)
    for (int i = tid; i < n_cells * NL; i += THREADS) {
      const int c = i / NL, j = i - c * NL;
      const int r0 = max(s_cptr[c], g0) - g0, r1 = min(s_cptr[c + 1], g0 + ng) - g0;
      if (r0 >= r1) continue;
      T* a = acc + s_cbase[c] + s_off[j];
      T v = *a;
      for (int r = r0; r < r1; ++r) v += buf[r * NL + j];
      *a = v;
    }
  }
  cluster.sync();  // every class's accumulator is whole
  constexpr int SHARE = K::N3P / NCLS;
  T* ob = out + static_cast<size_t>(b) * K::N3P;
  for (int i = cls * SHARE + tid; i < (cls + 1) * SHARE; i += THREADS) {
    T v = T(0);
#pragma unroll
    for (int c = 0; c < NCLS; ++c) v += cluster.map_shared_rank(acc, c)[i];
    ob[i] = v;
  }
  cluster.sync();  // no block leaves while another reads its accumulator
}

// info: launch nothing and write (threads, shared-memory bytes, blocks per SM, restrict: the
// clusters resident at once on the card, prolongate: 0; the rows a round) into info[0..4]
template <typename T, int DIM, int P>
int launch(const T* x, const T* E, const Lists& l, T* out, int nb_f, int nb_c, int B, int N3p,
           int restrict_, int* info, cudaStream_t stream) {
  using K = Cfg<DIM, P>;
  if (!info && (B != K::B || N3p != K::N3P)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (restrict_) {
    auto kernel = brick_transfer_restrict_kernel<T, DIM, P>;
    static unsigned long long smem_set = 0;
    err = sf::allow_smem_once(kernel, SMEM_BYTES, smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((info ? 1 : nb_c) * K::NCLS);
    cfg.blockDim = dim3(K::THREADS);
    cfg.dynamicSmemBytes = K::template restrict_smem<T>();
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K::NCLS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (info) {
      info[0] = K::THREADS;
      info[1] = static_cast<int>(cfg.dynamicSmemBytes);
      info[4] = K::RROWS;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(info + 2, kernel, K::THREADS,
                                                          cfg.dynamicSmemBytes);
      if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(info + 3, kernel, &cfg);
      return static_cast<int>(err);
    }
    if (nb_c > 0) {
      err = cudaLaunchKernelEx(&cfg, kernel, x, E, l, out);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  } else {
    auto kernel = brick_transfer_prolongate_kernel<T, DIM, P>;
    static unsigned long long smem_set = 0;
    err = sf::allow_smem_once(kernel, SMEM_BYTES, smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = K::template prolongate_smem<T>();
    if (info) {
      info[0] = K::THREADS;
      info[1] = static_cast<int>(smem);
      info[3] = 0;
      info[4] = K::PROWS;
      return static_cast<int>(
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(info + 2, kernel, K::THREADS, smem));
    }
    if (nb_f > 0) kernel<<<nb_f, K::THREADS, smem, stream>>>(x, E, l, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* const* a, void* out, int nb_f, int nb_c, int p, int B, int N3p,
             int restrict_, int dim, int* info, cudaStream_t stream) {
  const T* x = static_cast<const T*>(a[0]);
  const T* E = static_cast<const T*>(a[1]);
  auto li = [a](int i) { return static_cast<const int*>(a[3 + i]); };
  Lists l{static_cast<const unsigned char*>(a[2]), li(0), li(1), li(2), li(3), li(4),
          li(5), li(6), li(7), li(8)};
  T* o = static_cast<T*>(out);
  if (dim == 2) {
#define BT_CASE2(p_) \
  case p_: return launch<T, 2, p_>(x, E, l, o, nb_f, nb_c, B, N3p, restrict_, info, stream);
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
  case p_: return launch<T, 3, p_>(x, E, l, o, nb_f, nb_c, B, N3p, restrict_, info, stream);
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

// x, E, own, p_rows, p_sched, p_bround, p_par, p_slot, r_ptr, r_slot, c_ptr, c_rows, out:
// device pointers; B must be auto_brick_size(p, dim) and N3p its padded brick; dim: 3, or 2
// (NB^2-node bricks, E [nlin_f][2][N][N], r_ptr [nb_c][5]); info: null, or 5 ints for the
// launch's plan (nothing is launched)
int brick_transfer_f32(const void* x, const void* E, const void* own, const void* p_rows,
                       const void* p_sched, const void* p_bround, const void* p_par,
                       const void* p_slot, const void* r_ptr, const void* r_slot,
                       const void* c_ptr, const void* c_rows, void* out, int nb_f, int nb_c,
                       int p, int B, int N3p, int restrict_, int dim, int* info,
                       void* stream) {
  const void* a[12] = {x,     E,     own,   p_rows, p_sched, p_bround,
                       p_par, p_slot, r_ptr, r_slot, c_ptr,  c_rows};
  return dispatch<float>(a, out, nb_f, nb_c, p, B, N3p, restrict_, dim, info,
                         static_cast<cudaStream_t>(stream));
}

int brick_transfer_f64(const void* x, const void* E, const void* own, const void* p_rows,
                       const void* p_sched, const void* p_bround, const void* p_par,
                       const void* p_slot, const void* r_ptr, const void* r_slot,
                       const void* c_ptr, const void* c_rows, void* out, int nb_f, int nb_c,
                       int p, int B, int N3p, int restrict_, int dim, int* info,
                       void* stream) {
  const void* a[12] = {x,     E,     own,   p_rows, p_sched, p_bround,
                       p_par, p_slot, r_ptr, r_slot, c_ptr,  c_rows};
  return dispatch<double>(a, out, nb_f, nb_c, p, B, N3p, restrict_, dim, info,
                          static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
