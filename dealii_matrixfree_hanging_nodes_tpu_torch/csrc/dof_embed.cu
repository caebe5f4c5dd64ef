// dof_embed: the brick GMG's DoF embedding and its exact transpose, each one sparse gather by
// destination: out[i] = sum of w[e] * x[idx[e]] over e = ptr[i] .. ptr[i+1] (0 where empty),
// from lists composed on the host (dof_embed.tables):
//   embed (x a DoF vector, out a brick vector [nb][N3p]): a valid node of a free DoF reads the
//     DoF, a valid node of a slave reads the slave's masters with their weights; holes and
//     padding get 0;
//   embed_t (x a brick vector, out a DoF vector): the transpose, rows by DoF in ascending node
//     order: a free DoF sums its node copies, each master adds w times the copies of the slaves it
//     serves (the slave fold is composed into the lists: one launch).
//
// Replaces: DofEmbed.embed (dealii_matrixfree_hanging_nodes_tpu/models/multigrid_bricks.py:89-105:
//   segment_sum of the constraint rows, .at[slave].set, .at[valid_idx].set, the padding) and its
//   jax.linear_transpose inside BrickTransfer._restrict_impl (252-255); XLA on the TPU (no Pallas
//   kernel).
//
// Bound on an H100 SXM (dof_embed.bytes_and_flops): memory. The x values the entries name read
//   once, ptr, idx and w read once, out written once; two flops an entry.
//
// Design: row lengths spread widely (3-D quadrant level 5, p=4: embed_t's rows hold 0-4
//   entries but 1.5 % of them, the masters of many slave copies, hold 9-296 and 48 % of the
//   entries; embed's slave rows hold up to 25). A thread a row would keep a warp waiting on its
//   longest row's chain of dependent loads, so the host splits the destinations at `split`
//   entries (dof_embed.LONG_ROW, 32): the rows above it are listed (`long_rows`) and take a warp
//   each, in the grid's first blocks so that their chains start first. A warp loads 32 entries
//   at a time (idx, w and the x values, all lanes in parallel) and folds them in list order from
//   registers by shuffles; the other rows take a thread each (blocks of 256 consecutive
//   destinations: the ptr reads and the out writes are coalesced), which skips a long row. A
//   table with no long row (embed's at every level, embed_t's on 2-D levels at p <= 4) takes an
//   instance without the warps' blocks and the length test: the thread-a-row kernel as it was
//   before the split. (At a split of 8, embed's 25-entry rows ran slower on warps than on
//   threads; a warp taking 256 entries at a time, 8 loads in flight a lane, and a short row's
//   loads all at once measured no faster.) Every destination has one writer that sums its
//   entries in list order with the same fused multiply-add as before the split
//   (acc = fma(w, x, acc)): no atomics, no memset (an empty row writes 0), two calls give the
//   same bits.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// LONG: the table lists long rows (the grid's first long_blocks blocks take them); without, every
// row takes a thread and no length is tested
template <typename T, bool LONG>
__global__ void __launch_bounds__(THREADS)
dof_embed_kernel(const T* __restrict__ x, const int* __restrict__ ptr, const int* __restrict__ idx,
                 const T* __restrict__ w, const int* __restrict__ long_rows, T* __restrict__ out,
                 int n, int n_long, int long_blocks, int split) {
  if (LONG && static_cast<int>(blockIdx.x) < long_blocks) {  // a warp a long row
    const int r = blockIdx.x * WARPS + threadIdx.x / 32;
    if (r >= n_long) return;  // the whole warp
    const int lane = threadIdx.x & 31;
    const int i = long_rows[r];
    const int e1 = ptr[i + 1];
    T acc = T(0);
    for (int e = ptr[i]; e < e1; e += 32) {
      const int m = min(32, e1 - e);
      T wv = T(0), xv = T(0);
      if (lane < m) {
        wv = w[e + lane];
        xv = __ldg(x + idx[e + lane]);
      }
      // every lane folds the 32 entries in list order (the same bits in each lane)
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const T wk = __shfl_sync(FULL, wv, k), xk = __shfl_sync(FULL, xv, k);
        if (k < m) acc = fma(wk, xk, acc);
      }
    }
    if (lane == 0) out[i] = acc;
    return;
  }
  // a thread a short row
  const int i = (blockIdx.x - (LONG ? long_blocks : 0)) * THREADS + threadIdx.x;
  if (i >= n) return;
  const int e0 = ptr[i], e1 = ptr[i + 1];
  if (LONG && e1 - e0 > split) return;  // a long row: its warp writes it
  T acc = T(0);
  for (int e = e0; e < e1; ++e) acc = fma(w[e], __ldg(x + idx[e]), acc);
  out[i] = acc;
}

template <typename T>
int launch(const void* x, const void* ptr, const void* idx, const void* w, const void* long_rows,
           void* out, int n, int n_long, int split, cudaStream_t stream) {
  const int long_blocks = (n_long + WARPS - 1) / WARPS;
  const int blocks = long_blocks + (n + THREADS - 1) / THREADS;
  if (blocks > 0) {
    auto kernel = n_long > 0 ? dof_embed_kernel<T, true> : dof_embed_kernel<T, false>;
    kernel<<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int*>(ptr), static_cast<const int*>(idx),
        static_cast<const T*>(w), static_cast<const int*>(long_rows), static_cast<T*>(out), n,
        n_long, long_blocks, split);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, ptr, idx, w, long_rows, out: device pointers; n: the destinations, n_long: the listed long
// rows (every row of more than split entries; 0: none), split: a row above it is long and its
// thread skips it
int dof_embed_f32(const void* x, const void* ptr, const void* idx, const void* w,
                  const void* long_rows, void* out, int n, int n_long, int split, void* stream) {
  return launch<float>(x, ptr, idx, w, long_rows, out, n, n_long, split,
                       static_cast<cudaStream_t>(stream));
}

int dof_embed_f64(const void* x, const void* ptr, const void* idx, const void* w,
                  const void* long_rows, void* out, int n, int n_long, int split, void* stream) {
  return launch<double>(x, ptr, idx, w, long_rows, out, n, n_long, split,
                        static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
