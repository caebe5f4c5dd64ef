// dof_scatter: the index engine's scatter-add of cell rows into a global vector, by destination.
// With the transposed DoF map (ptr [n_dofs+1] into ent, the flat (cell, slot) positions of each
// DoF in ascending order), every DoF i gets
//   dst[i] = sum of rows[ent[e]] over e = ptr[i] .. ptr[i+1]    (0 where the range is empty).
// With a component axis (K = 2 or 3: rows [K, n_cells, n_loc], component-major, as
// cell_elasticity writes them in 2-D and 3-D), dst is [n_dofs, K], DoF-major, the reference's
// layout of a displacement:
//   dst[i, c] = sum of rows[c][ent[e]] over the same entries,
// so the transpose back from component-major rides the scatter. Each component's sum runs in the
// scalar kernel's order: a component is bit-identical to a scalar call on rows[c].
//
// Replaces: MatrixFree.distribute_local_to_global(_plain) (dealii_matrixfree_hanging_nodes_tpu/
//   matrix_free.py:281-297): `zeros(n_dofs).at[dofmap.reshape(-1)].add(rows.reshape(-1))`, an
//   XLA scatter-add with repeated ids on the TPU (no Pallas kernel); with K = 2, 3 the K such
//   scatters and the stack of ElasticityOperator._vmult (models/elasticity.py:92-98).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (dof_scatter.bytes_and_flops): memory. The
//   rows (269,991 x 125, 135 MB) read once, one int32 DoF index an entry (33.7 M, 135 MB; the
//   DoF map's size) read once, dst (17.55 M DoFs, 70 MB) written once: 340 MB, 0.10 ms at
//   3.35 TB/s; one add an entry. ptr (70 MB) and the schedule (70 MB) are left out: only this
//   layout needs them. At 2-D quadrant nref=11 p=4 f32 (1,051,669 cells of 25 values, 16.84 M
//   DoFs), the same count: 105 MB of rows, 105 MB of indices, 67 MB of dst, 0.083 ms; with
//   K = 2 (2-D elasticity) the rows and dst twice: 0.13 ms.
//
// Design: one owner thread a DoF sums its entries in the fixed ascending order and writes once:
//   no atomics, no memset (a DoF with no entry, a hanging DoF under the fast map, writes 0), and
//   two calls give bit-identical results. Read by destination, the rows are a gather that
//   coalesces badly (a warp's row loads touch 4.7x the 32-byte sectors their values fill at
//   quadrant nref=5 p=4; 3x more at K = 3, whose planes lie cstride apart), and the DoF
//   numbering (by entity class, then position) puts a warp's DoFs' ptr, ent and dst far apart.
//   But the cells that share a DoF are neighbours, and neighbours lie close in the cell order,
//   so most DoFs have every entry among a few consecutive cells. A host schedule
//   (dof_scatter.schedule) cuts the cells into chunks of at most cmax consecutive cells (cmax
//   n_loc <= 8192 values) and sorts the DoFs into 2 n_chunks blocks of one launch: block 2j
//   stages chunk j's rows (K planes) into shared memory with coalesced 16-byte loads and sums
//   the DoFs whose every entry lies in chunk j from there, their entries read in block order
//   from the schedule as 16-bit offsets into the chunk (lptr, loff: coalesced, where ptr and
//   ent by DoF are not); block 2j+1 sums the DoFs whose last entry lies in chunk j but whose
//   entries cross chunks (and a share of the DoFs with no entry) by ptr and ent from the
//   global rows, right after the chunks whose rows it reads went through L2. Every DoF's sum
//   has the same terms in the same order as a single by-destination pass, so the bits are those
//   of the kernel this design replaced. A thread sums U = 2 DoFs at once, so their index loads
//   are in flight together. Shared memory: about 8192 K values at most (f64, K = 3: 192 KB,
//   one block an SM; f32, K = 1: 32 KB), a plane starting at the 16-byte boundary before its
//   first value.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 512;
constexpr int U = 2;  // DoFs a thread sums at once: their index loads in flight together

// Sums U DoFs of the block's list (positions q, q + THREADS, ...; those at q1 and after are
// none) into dst: range(q, i, e0, n) gives position q's DoF and its entries e0 .. e0 + n,
// entry(e) an entry's place and val(c, s) its value in component c; each DoF's entries in
// ascending order from 0.
template <typename T, int K, typename Range, typename Entry, typename Val>
__device__ __forceinline__ void sum_dofs(int q, int q1, T* __restrict__ dst, Range range,
                                         Entry entry, Val val) {
  int i[U], e0[U], n[U];
  int m = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    i[u] = -1;
    e0[u] = n[u] = 0;
    if (q + u * THREADS < q1) range(q + u * THREADS, i[u], e0[u], n[u]);
    m = max(m, n[u]);
  }
  T acc[U][K];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int c = 0; c < K; ++c) acc[u][c] = T(0);
  }
  for (int r = 0; r < m; ++r) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r < n[u]) {
        const int s = entry(e0[u] + r);
#pragma unroll
        for (int c = 0; c < K; ++c) acc[u][c] += val(c, s);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (i[u] >= 0) {
#pragma unroll
      for (int c = 0; c < K; ++c) dst[static_cast<size_t>(i[u]) * K + c] = acc[u][c];
    }
  }
}

// Values a 16-byte load holds; a chunk's plane in shared memory is padded by that many values
template <typename T>
constexpr int VEC = 16 / static_cast<int>(sizeof(T));

// The values of a plane of a chunk, planes PLANE(nv) apart in shared memory
template <typename T>
__host__ __device__ constexpr int plane(int nv) {
  return (nv + 2 * VEC<T> - 1) / VEC<T> * VEC<T>;
}

// The block copies src[0 .. n) to dst[a .. a + n), a = src's offset from a 16-byte boundary in
// values (dst 16-byte aligned): 16-byte loads and stores but for a scalar head and tail.
template <typename T>
__device__ __forceinline__ int stage(const T* __restrict__ src, T* __restrict__ dst, int n,
                                     int tid) {
  constexpr int V = VEC<T>;
  const int a = static_cast<int>(reinterpret_cast<size_t>(src) / sizeof(T)) & (V - 1);
  const int head = min(n, (V - a) & (V - 1));
  if (tid < head) dst[a + tid] = __ldg(src + tid);
  const int nvec = (n - head) / V;
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  uint4* vdst = reinterpret_cast<uint4*>(dst + a + head);
#pragma unroll 4
  for (int t = tid; t < nvec; t += THREADS) vdst[t] = __ldg(vsrc + t);
  for (int t = head + nvec * V + tid; t < n; t += THREADS) dst[a + t] = __ldg(src + t);
  return a;
}

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
dof_scatter_kernel(const T* __restrict__ rows, const int* __restrict__ ptr,
                   const int* __restrict__ ent, const int* __restrict__ sched,
                   T* __restrict__ dst, int n_dofs, int n_loc, int n_chunks, int cmax,
                   long long cstride) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sh = reinterpret_cast<T*>(smem);  // [K][plane(C n_loc)] the chunk's rows
  const int* cstart = sched;                 // [n_chunks + 1] the chunks' first cells
  const int* dptr = sched + n_chunks + 1;    // [2 n_chunks + 1] each block's DoFs in ids
  const int* ids = dptr + 2 * n_chunks + 1;  // [n_dofs] the DoFs, by block
  const int* lptr = ids + n_dofs;            // [n_dofs + 1] a local DoF's entries in loff
  const auto* loff = reinterpret_cast<const unsigned short*>(lptr + n_dofs + 1);
  const int b = blockIdx.x, tid = threadIdx.x;
  const int q0 = __ldg(dptr + b), q1 = __ldg(dptr + b + 1);
  if (q0 == q1) return;
  if (b & 1) {  // DoFs whose entries cross chunks: their entries by ptr and ent, the rows from
                // device memory
    for (int q = q0 + tid; q < q1; q += U * THREADS) {
      sum_dofs<T, K>(
          q, q1, dst,
          [&](int p, int& i, int& e0, int& n) {
            i = __ldg(ids + p);
            e0 = __ldg(ptr + i);
            n = __ldg(ptr + i + 1) - e0;
          },
          [&](int e) { return __ldg(ent + e); },
          [&](int c, int s) { return __ldg(rows + c * cstride + s); });
    }
    return;
  }
  const int j = b >> 1;
  const int c0 = __ldg(cstart + j), nc = __ldg(cstart + j + 1) - c0;
  if (nc > cmax) __trap();  // not a schedule of this chunk size
  const int nv = nc * n_loc, np = plane<T>(nv);
  int base[K];  // where each plane's first value sits in shared memory
#pragma unroll
  for (int c = 0; c < K; ++c) {
    base[c] = c * np + stage(rows + c * cstride + static_cast<size_t>(c0) * n_loc, sh + c * np,
                             nv, tid);
  }
  __syncthreads();
  for (int q = q0 + tid; q < q1; q += U * THREADS) {  // local DoFs: entries by lptr and loff
    sum_dofs<T, K>(
        q, q1, dst,
        [&](int p, int& i, int& e0, int& n) {
          i = __ldg(ids + p);
          e0 = __ldg(lptr + p);
          n = __ldg(lptr + p + 1) - e0;
        },
        [&](int e) { return static_cast<int>(__ldg(loff + e)); },
        [&](int c, int s) { return sh[base[c] + s]; });
  }
}

template <typename T, int K>
int launch(const void* rows, const void* ptr, const void* ent, const void* sched, void* dst,
           int n_dofs, int n_loc, int n_chunks, int cmax, long long cstride,
           cudaStream_t stream) {
  if (n_chunks > 0) {
    auto kernel = dof_scatter_kernel<T, K>;
    const int bytes = plane<T>(cmax * n_loc) * K * static_cast<int>(sizeof(T));
    if (bytes > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<2 * n_chunks, THREADS, bytes, stream>>>(
        static_cast<const T*>(rows), static_cast<const int*>(ptr), static_cast<const int*>(ent),
        static_cast<const int*>(sched), static_cast<T*>(dst), n_dofs, n_loc, n_chunks, cmax,
        cstride);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* rows, const void* ptr, const void* ent, const void* sched, void* dst,
             int n_dofs, int n_loc, int n_chunks, int cmax, int k, long long cstride,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (k == 1) return launch<T, 1>(rows, ptr, ent, sched, dst, n_dofs, n_loc, n_chunks, cmax,
                                   cstride, s);
  if (k == 2) return launch<T, 2>(rows, ptr, ent, sched, dst, n_dofs, n_loc, n_chunks, cmax,
                                   cstride, s);
  if (k == 3) return launch<T, 3>(rows, ptr, ent, sched, dst, n_dofs, n_loc, n_chunks, cmax,
                                   cstride, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// k components of rows, cstride values apart (k = 1, 2 or 3); dst [n_dofs, k]; sched the host
// schedule of n_chunks chunks of at most cmax cells of n_loc values
int dof_scatter_f32(const void* rows, const void* ptr, const void* ent, const void* sched,
                    void* dst, int n_dofs, int n_loc, int n_chunks, int cmax, int k,
                    long long cstride, void* stream) {
  return dispatch<float>(rows, ptr, ent, sched, dst, n_dofs, n_loc, n_chunks, cmax, k, cstride,
                         stream);
}

int dof_scatter_f64(const void* rows, const void* ptr, const void* ent, const void* sched,
                    void* dst, int n_dofs, int n_loc, int n_chunks, int cmax, int k,
                    long long cstride, void* stream) {
  return dispatch<double>(rows, ptr, ent, sched, dst, n_dofs, n_loc, n_chunks, cmax, k, cstride,
                          stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
