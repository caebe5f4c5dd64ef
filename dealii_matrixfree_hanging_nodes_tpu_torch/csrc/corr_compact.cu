// corr_compact: dcols [n_rows, n_loc] (n_rows = n_sub * B^3 subset cell rows) from the cell
// rows' plain stiffness plain [n_rows, n_loc] and the HN^T-applied constrained rows
// sub_raw [n_hn, n_loc]. The fold arrives as runs: run s sums sub_raw_flat[ent_src[e]] over its
// entries e = seg_ptr[s] .. seg_ptr[s+1] in order into the flat dcols slot seg_dst[s] (ascending);
// acc is that sum, zero where no run lands. Then, with j the slot of row r:
//   cell_code[r] = h >= 0:  keep[h, j] ? (sub_raw[h, j] + acc[r, j]) - plain[r, j] : -plain[r, j]
//   cell_code[r] == -2:     -plain[r, j]          (absent cells)
//   otherwise:              acc[r, j]             (fold targets; zero elsewhere)
// plain may be null, read as zeros (the assembled schedule of degree <= 3).
// The runs are the whole fold chain (stage 1 and its tails) composed on the host.
// With a leading axis of k components or right-hand sides (elasticity's k = 3: plain and dcols
// [3, n_rows, n_loc], sub_raw [3, n_hn, n_loc], component-major; BrickLaplaceMM.vmult_multi's k
// right-hand sides, k-major) each goes through the same tables: grid.y is the component or RHS,
// whose blocks offset plain, sub_raw and dcols by it (64-bit offsets), so each is bit-identical to
// a scalar call on its slices, in one launch.
//
// Replaces: BrickLaplaceMM._corr_compact (dealii_matrixfree_hanging_nodes_tpu/bricks.py:
//   2775-2849) and the plain_rows[hn_sub] gather before it (2465): the stage-1 one-hot
//   transfer matmuls, the scatter-adds into a zeroed acc and into the non-hn rows, the tail
//   stages on sub_raw + acc, the keep mask, final - plain and -plain on absent rows. The TPU
//   side ran these as XLA gathers, MXU matmuls and scatters (no Pallas kernel). With k = 3, the
//   same on the trailing component axis of BrickElasticity's rows (models/elasticity_bricks.py:
//   241-249); with k right-hand sides, _corr_compact on plain3 [nsC, k, n_loc] of
//   _vmult_multi_impl (bricks.py:3484-3485).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (65,600 rows, 16,744 constrained, 11,609
//   absent; 426,424 entries in 107,083 runs): memory. sub_raw read once (8.4 MB), plain read at
//   the constrained and absent rows (14.2 MB), dcols written once (32.8 MB), keep at one bit a
//   slot, cell_code, the runs and the schedule (~3 MB): about 58.5 MB, 17.5 us at 3.35 TB/s;
//   the adds are nothing beside it.
//
// Design: each block takes a range of whole rows from the host's schedule (blocks [n_blocks+1]
//   of (first row, first run)): at most cap_rows rows (~4,096 values) and, but for a group of 4
//   rows that holds more, at most one run a thread, so the 4,282 rows that hold every fold
//   entry spread over many blocks instead of setting the tail. A block
//   - zeroes its rows' run sums in shared memory and stages their codes; each thread loads and
//     sums its first run meanwhile (4 entries' sources, then their values, in flight together,
//     added in entry order) and stores it after the barrier, so no two threads write one slot
//     and no atomics are needed;
//   - writes its rows in 16-byte vectors (a block's first row is a multiple of 4, so its rows
//     start 16-byte aligned in f32 and f64), each value by its row's formula; plain is loaded
//     as a vector only where one of the vector's (at most two) rows needs it, sub_raw and keep
//     only at constrained rows.
//   The rows of code -1 that no run reaches are written as zeros without a read.
//   Resources (ptxas, sm_90a): 32 registers in f32 at p=4 (42 at p=7), 40 in f64 (32 at
//   p=5); no stack, no spills; 16.5 KB of shared memory a block at p=4 in f32.
//   What holds it back: the row phase (chip_smoke.py prints the kernel without its runs beside
//   it): the loads of plain, sub_raw and keep behind each vector's codes, one vector at a time.
//   Tried on the card in scratch builds and not kept: two or four row vectors' loads in flight
//   a thread (64 and 109 registers: fewer blocks an SM, slower), blocks of 8, 16 or 64 rows
//   (32 is the fastest).
//   2-D (cells of (p+1)^2 values, p = 1..6): the same kernel at NL = 4 .. 49; at 2-D quadrant
//   nref=11, p=4, f32 (33,088 rows, 10,297 runs): 5.8 MB, 0.0017 ms, launch-bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // corr_compact.THREADS: the schedule gives a block <= one run each

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

// component k of a vector (k a constant once the loops are unrolled, so no local memory)
__device__ __forceinline__ float& at(float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ double& at(double2& v, int k) { return k == 0 ? v.x : v.y; }

// The sum of src[ent_src[e]] for e in [e, e1), in entry order: four sources, then their four
// values, in flight together.
template <typename T>
__device__ __forceinline__ T run_sum(int e, int e1, const int* __restrict__ ent_src,
                                     const T* __restrict__ src) {
  T acc = T(0);
  for (; e < e1; e += 4) {
    int i[4];
    T x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) i[k] = e + k < e1 ? __ldg(ent_src + e + k) : -1;
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = i[k] >= 0 ? __ldg(src + i[k]) : T(0);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i[k] >= 0) acc += x[k];
  }
  return acc;
}

// dcols[r, j] by the row's code c, from its run sum a and plain value pl
template <typename T, int NL>
__device__ __forceinline__ T row_value(int c, int j, T a, T pl, const T* __restrict__ sub_raw,
                                       const bool* __restrict__ keep) {
  if (c >= 0) {
    const size_t o = static_cast<size_t>(c) * NL + j;
    const bool kept = keep[o];
    const T s = __ldg(sub_raw + o);
    return kept ? (s + a) - pl : -pl;
  }
  return c == -2 ? -pl : a;
}

template <typename T, int NL, bool MULTI>
__global__ void __launch_bounds__(THREADS)
corr_compact_kernel(const T* __restrict__ plain, const T* __restrict__ sub_raw,
                    const int* __restrict__ cell_code, const bool* __restrict__ keep,
                    const int* __restrict__ seg_ptr, const int* __restrict__ seg_dst,
                    const int* __restrict__ ent_src, const int2* __restrict__ blocks,
                    T* __restrict__ dcols, int cap_rows, long long rows_stride,
                    long long hn_stride) {
  if constexpr (MULTI) {  // the component or right-hand side of a leading axis
    if (plain != nullptr) plain += blockIdx.y * rows_stride;
    sub_raw += blockIdx.y * hn_stride;
    dcols += blockIdx.y * rows_stride;
  }
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::W;
  extern __shared__ __align__(16) unsigned char smem[];
  T* acc = reinterpret_cast<T*>(smem);                  // [cap_rows * NL] the run sums
  int* s_code = reinterpret_cast<int*>(acc + cap_rows * NL);  // [cap_rows] the row codes
  const int tid = threadIdx.x;
  const int2 lo = blocks[blockIdx.x], hi = blocks[blockIdx.x + 1];
  const int nrows = hi.x - lo.x, count = nrows * NL, base = lo.x * NL;
  if (nrows > cap_rows) __trap();  // a schedule built for another block size

  // the run sums: zeroed, then each run stored by the thread that summed it; a thread's first
  // run is summed while the zeros are written
  for (int i = tid; i < count; i += THREADS) acc[i] = T(0);
  for (int i = tid; i < nrows; i += THREADS) s_code[i] = cell_code[lo.x + i];
  int s = lo.y + tid, d = -1;
  T sum = T(0);
  if (s < hi.y) {
    d = seg_dst[s] - base;
    sum = run_sum(seg_ptr[s], seg_ptr[s + 1], ent_src, sub_raw);
  }
  __syncthreads();
  if (d >= 0) acc[d] = sum;
  for (s += THREADS; s < hi.y; s += THREADS)
    acc[seg_dst[s] - base] = run_sum(seg_ptr[s], seg_ptr[s + 1], ent_src, sub_raw);
  __syncthreads();

  // the rows, each value by its row's formula
  T* out = dcols + base;
  const bool has_plain = plain != nullptr;
  const T* pl = has_plain ? plain + base : nullptr;
  const bool vec = ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(pl)) & 15) == 0;
  const int nv = vec ? count / W : 0;
  for (int q = tid; q < nv; q += THREADS) {
    const int i0 = q * W;
    const int g0 = i0 / NL, g1 = (i0 + W - 1) / NL;  // W < NL: at most two rows
    const int c0 = s_code[g0], c1 = s_code[g1];
    V pv{};
    if (has_plain && (c0 != -1 || c1 != -1)) pv = reinterpret_cast<const V*>(pl)[q];
    V av = reinterpret_cast<const V*>(acc)[q];
    V rv;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int i = i0 + k;
      const bool second = i >= (g0 + 1) * NL;
      const int g = second ? g1 : g0;
      at(rv, k) = row_value<T, NL>(second ? c1 : c0, i - g * NL, at(av, k), at(pv, k), sub_raw,
                                   keep);
    }
    reinterpret_cast<V*>(out)[q] = rv;
  }
  for (int i = nv * W + tid; i < count; i += THREADS) {
    const int g = i / NL, c = s_code[g];
    out[i] = row_value<T, NL>(c, i - g * NL, acc[i], has_plain && c != -1 ? pl[i] : T(0),
                              sub_raw, keep);
  }
}

template <typename T, int NL>
int launch(const void* const* a, void* out, int n_blocks, int cap_rows, int k,
           long long rows_stride, long long hn_stride, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(cap_rows) * (NL * sizeof(T) + sizeof(int));
  if (n_blocks > 0) {
    // a scalar call runs the instance without the component offsets
    auto kernel = k > 1 ? corr_compact_kernel<T, NL, true> : corr_compact_kernel<T, NL, false>;
    kernel<<<dim3(n_blocks, k), THREADS, smem, stream>>>(
        static_cast<const T*>(a[0]), static_cast<const T*>(a[1]), static_cast<const int*>(a[2]),
        static_cast<const bool*>(a[3]), static_cast<const int*>(a[4]),
        static_cast<const int*>(a[5]), static_cast<const int*>(a[6]),
        static_cast<const int2*>(a[7]), static_cast<T*>(out), cap_rows, rows_stride, hn_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* const* a, void* out, int n_blocks, int cap_rows, int n_loc, int p,
             int k, long long rows_stride, long long hn_stride, cudaStream_t stream) {
#define CORR_CASE(p_)                                                                \
  if (p == p_ && n_loc == (p_ + 1) * (p_ + 1) * (p_ + 1))                            \
    return launch<T, (p_ + 1) * (p_ + 1) * (p_ + 1)>(a, out, n_blocks, cap_rows, k,  \
                                                     rows_stride, hn_stride, stream);
  CORR_CASE(1)
  CORR_CASE(2)
  CORR_CASE(3)
  CORR_CASE(4)
  CORR_CASE(5)
  CORR_CASE(6)
  CORR_CASE(7)
  CORR_CASE(8)
#undef CORR_CASE
  // 2-D cells of (p+1)^2 values, p = 1..6 (none of them a 3-D cell's size)
#define CORR_CASE2(p_)                                                               \
  if (p == p_ && n_loc == (p_ + 1) * (p_ + 1))                                       \
    return launch<T, (p_ + 1) * (p_ + 1)>(a, out, n_blocks, cap_rows, k, rows_stride, \
                                          hn_stride, stream);
  CORR_CASE2(1)
  CORR_CASE2(2)
  CORR_CASE2(3)
  CORR_CASE2(4)
  CORR_CASE2(5)
  CORR_CASE2(6)
#undef CORR_CASE2
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// plain .. blocks: device pointers (plain, sub_raw, cell_code, keep, seg_ptr, seg_dst, ent_src,
// blocks), as the wrapper passes them; k components or right-hand sides, rows_stride and
// hn_stride values apart in plain and dcols, and in sub_raw
int corr_compact_f32(const void* plain, const void* sub_raw, const void* cell_code,
                     const void* keep, const void* seg_ptr, const void* seg_dst,
                     const void* ent_src, const void* blocks, void* dcols, int n_blocks,
                     int cap_rows, int n_loc, int p, int k, long long rows_stride,
                     long long hn_stride, void* stream) {
  const void* a[8] = {plain, sub_raw, cell_code, keep, seg_ptr, seg_dst, ent_src, blocks};
  return dispatch<float>(a, dcols, n_blocks, cap_rows, n_loc, p, k, rows_stride, hn_stride,
                         static_cast<cudaStream_t>(stream));
}

int corr_compact_f64(const void* plain, const void* sub_raw, const void* cell_code,
                     const void* keep, const void* seg_ptr, const void* seg_dst,
                     const void* ent_src, const void* blocks, void* dcols, int n_blocks,
                     int cap_rows, int n_loc, int p, int k, long long rows_stride,
                     long long hn_stride, void* stream) {
  const void* a[8] = {plain, sub_raw, cell_code, keep, seg_ptr, seg_dst, ent_src, blocks};
  return dispatch<double>(a, dcols, n_blocks, cap_rows, n_loc, p, k, rows_stride, hn_stride,
                          static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
