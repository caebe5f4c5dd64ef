// corr_compact: dcols [n_rows, n_loc] (n_rows = n_sub * B^3 subset cell rows) from the cell
// rows' plain stiffness plain [n_rows, n_loc] and the HN^T-applied constrained rows
// sub_raw [n_hn, n_loc]. With acc[r, j] = sum of sub_raw_flat[ent_src[e]] over the entries e
// of row r (row_ptr[r] .. row_ptr[r+1], sorted by slot) with ent_slot[e] == j:
//   cell_code[r] = h >= 0:  keep[h, j] ? (sub_raw[h, j] + acc[r, j]) - plain[r, j] : -plain[r, j]
//   cell_code[r] == -2:     -plain[r, j]          (absent cells)
//   otherwise:              acc[r, j]             (fold targets; zero elsewhere)
// The entries are the whole fold chain (stage 1 and its tails) composed on the host.
//
// Replaces: BrickLaplaceMM._corr_compact (dealii_matrixfree_hanging_nodes_tpu/bricks.py:
//   2775-2849) and the plain_rows[hn_sub] gather before it (2465): the stage-1 one-hot
//   transfer matmuls, the scatter-adds into a zeroed acc and into the non-hn rows, the tail
//   stages on sub_raw + acc, the keep mask, final - plain and -plain on absent rows. The TPU
//   side ran these as XLA gathers, MXU matmuls and scatters (no Pallas kernel).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (65,600 rows, 16,744 constrained,
//   11,609 absent, ~0.45 M entries): memory. sub_raw read once (8.4 MB), plain read at the
//   constrained and absent rows (14.2 MB), dcols written once (32.8 MB), keep, cell_code and
//   the lists (~6 MB): about 61 MB, 18 us at 3.35 TB/s; the adds are nothing beside it.
//
// Design: one warp per dcols row, one pass. The lanes sum each run of entries with one slot
//   (the lane holding the run's first entry sums it in order) into a row buffer in shared
//   memory, then write the row coalesced, picking the formula by the row's code. plain is
//   read only where the formula needs it, so the plain_rows[hn_sub] gather and the zeroed
//   dcols of the reference go away, and no atomics are needed. The tails' dependence on
//   stage 1 lives in the host-composed lists, so one launch serves all stages. Shared
//   memory: 8 rows per block, 8 * n_loc values (22 KB at p=6 in f64), sized at launch.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
corr_compact_kernel(const T* __restrict__ plain, const T* __restrict__ sub_raw,
                    const int* __restrict__ cell_code, const bool* __restrict__ keep,
                    const int* __restrict__ row_ptr, const int* __restrict__ ent_slot,
                    const int* __restrict__ ent_src, T* __restrict__ dcols, int n_rows,
                    int n_loc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + warp;
  if (r >= n_rows) return;  // the whole warp leaves together
  T* acc = reinterpret_cast<T*>(smem) + warp * n_loc;
  for (int j = lane; j < n_loc; j += 32) acc[j] = T(0);
  __syncwarp();
  const int e0 = row_ptr[r], e1 = row_ptr[r + 1];
  for (int e = e0 + lane; e < e1; e += 32) {
    const int s = ent_slot[e];
    if (e > e0 && ent_slot[e - 1] == s) continue;  // not the first entry of its slot
    T sum = T(0);
    for (int k = e; k < e1 && ent_slot[k] == s; ++k) sum += sub_raw[ent_src[k]];
    acc[s] = sum;
  }
  __syncwarp();
  const int code = cell_code[r];
  const size_t row = static_cast<size_t>(r) * n_loc;
  if (code >= 0) {
    const size_t hrow = static_cast<size_t>(code) * n_loc;
    for (int j = lane; j < n_loc; j += 32)
      dcols[row + j] = keep[hrow + j] ? (sub_raw[hrow + j] + acc[j]) - plain[row + j]
                                      : -plain[row + j];
  } else if (code == -2) {
    for (int j = lane; j < n_loc; j += 32) dcols[row + j] = -plain[row + j];
  } else {
    for (int j = lane; j < n_loc; j += 32) dcols[row + j] = acc[j];
  }
}

template <typename T>
int launch(const void* plain, const void* sub_raw, const void* cell_code, const void* keep,
           const void* row_ptr, const void* ent_slot, const void* ent_src, void* dcols,
           int n_rows, int n_loc, cudaStream_t stream) {
  if (n_rows > 0) {
    const size_t shmem = static_cast<size_t>(WARPS) * n_loc * sizeof(T);
    corr_compact_kernel<T><<<(n_rows + WARPS - 1) / WARPS, WARPS * 32, shmem, stream>>>(
        static_cast<const T*>(plain), static_cast<const T*>(sub_raw),
        static_cast<const int*>(cell_code), static_cast<const bool*>(keep),
        static_cast<const int*>(row_ptr), static_cast<const int*>(ent_slot),
        static_cast<const int*>(ent_src), static_cast<T*>(dcols), n_rows, n_loc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int corr_compact_f32(const void* plain, const void* sub_raw, const void* cell_code,
                     const void* keep, const void* row_ptr, const void* ent_slot,
                     const void* ent_src, void* dcols, int n_rows, int n_loc, void* stream) {
  return launch<float>(plain, sub_raw, cell_code, keep, row_ptr, ent_slot, ent_src, dcols,
                       n_rows, n_loc, static_cast<cudaStream_t>(stream));
}

int corr_compact_f64(const void* plain, const void* sub_raw, const void* cell_code,
                     const void* keep, const void* row_ptr, const void* ent_slot,
                     const void* ent_src, void* dcols, int n_rows, int n_loc, void* stream) {
  return launch<double>(plain, sub_raw, cell_code, keep, row_ptr, ent_slot, ent_src, dcols,
                        n_rows, n_loc, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
