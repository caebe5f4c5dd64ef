// fill_hn: the filled constrained rows out [n_hn, n_loc] from the subset bricks u [n_sub, N3p].
// Row h is cell c = hn_sub[h] (brick c / B^3, slot c % B^3, x fastest); its node (ix, iy, iz)
// sits at brick node ((sz*p + iz)*NB + sy*p + iy)*NB + sx*p + ix, NB = B*p + 1. Then
//   out[h, j] = (keep[h, j] ? u(c, j) : 0) + sum of u_flat[ent_src[e]] over the entries e of
//               row h (row_ptr[h] .. row_ptr[h+1], sorted by slot) with ent_slot[e] == j.
// The entries are the whole fill chain (stage 1 and its tails) composed on the host.
//
// Replaces: BrickLaplaceMM._fill_hn_compact (dealii_matrixfree_hanging_nodes_tpu/bricks.py:
//   2728-2773) fed by _extract_cols (2178-2194): the masked gather of the constrained rows,
//   the fill_fix_idx overwrite, the stage-1 [G, m, n_loc] x [G, n_loc, n_loc] one-hot matmuls
//   with their scatter-add, and the tail stages. The TPU side ran these as XLA gathers,
//   MXU matmuls and scatters (no Pallas kernel).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (16,744 rows, ~0.43 M entries): memory.
//   The distinct brick nodes the rows read (at most 8.4 MB), out written once (8.4 MB), the
//   keep mask (2.1 MB as bytes) and the lists (~3.5 MB): about 20 MB, 6 us at 3.35 TB/s.
//   One add per entry: nothing beside the bytes. The reference's stage-1 matmuls are
//   ~0.56 GFLOP of one-hot products for these copies.
//
// Design: one warp per row. The lanes gather the row's own nodes (masked) into a row buffer in
//   shared memory, coalesced along x; then each lane takes the first entry of a run of entries
//   with one slot and sums the run in order into that slot, so no two lanes write one slot
//   and no atomics are needed; then the row is written out coalesced. Composing the stages
//   on the host makes it one launch with no intermediate rows and no grid-wide ordering: the
//   tails' dependence on stage 1 lives in the lists. Shared memory: 8 rows per block,
//   8 * n_loc values (11 KB at p=6 in f64), sized at launch.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
fill_hn_kernel(const T* __restrict__ u, const int* __restrict__ hn_sub,
               const bool* __restrict__ keep, const int* __restrict__ row_ptr,
               const int* __restrict__ ent_slot, const int* __restrict__ ent_src,
               T* __restrict__ out, int n_hn, int p, int B, int N3p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = p + 1;
  const int n_loc = n * n * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x * WARPS + warp;
  if (h >= n_hn) return;  // the whole warp leaves together
  T* buf = reinterpret_cast<T*>(smem) + warp * n_loc;
  const int NB = B * p + 1, C = B * B * B;
  const int cell = hn_sub[h];
  const int brick = cell / C, slot = cell - (cell / C) * C;
  const int sx = slot % B, sy = (slot / B) % B, sz = slot / (B * B);
  const T* ub = u + static_cast<size_t>(brick) * N3p + (sz * p * NB + sy * p) * NB + sx * p;
  const bool* kh = keep + static_cast<size_t>(h) * n_loc;
  for (int j = lane; j < n_loc; j += 32) {
    const int ix = j % n, iy = (j / n) % n, iz = j / (n * n);
    buf[j] = kh[j] ? ub[(iz * NB + iy) * NB + ix] : T(0);
  }
  __syncwarp();
  const int e0 = row_ptr[h], e1 = row_ptr[h + 1];
  for (int e = e0 + lane; e < e1; e += 32) {
    const int s = ent_slot[e];
    if (e > e0 && ent_slot[e - 1] == s) continue;  // not the first entry of its slot
    T acc = T(0);
    for (int k = e; k < e1 && ent_slot[k] == s; ++k) acc += u[ent_src[k]];
    buf[s] += acc;
  }
  __syncwarp();
  T* oh = out + static_cast<size_t>(h) * n_loc;
  for (int j = lane; j < n_loc; j += 32) oh[j] = buf[j];
}

template <typename T>
int launch(const void* u, const void* hn_sub, const void* keep, const void* row_ptr,
           const void* ent_slot, const void* ent_src, void* out, int n_hn, int p, int B,
           int N3p, cudaStream_t stream) {
  if (n_hn > 0) {
    const int n_loc = (p + 1) * (p + 1) * (p + 1);
    const size_t shmem = static_cast<size_t>(WARPS) * n_loc * sizeof(T);
    fill_hn_kernel<T><<<(n_hn + WARPS - 1) / WARPS, WARPS * 32, shmem, stream>>>(
        static_cast<const T*>(u), static_cast<const int*>(hn_sub),
        static_cast<const bool*>(keep), static_cast<const int*>(row_ptr),
        static_cast<const int*>(ent_slot), static_cast<const int*>(ent_src),
        static_cast<T*>(out), n_hn, p, B, N3p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fill_hn_f32(const void* u, const void* hn_sub, const void* keep, const void* row_ptr,
                const void* ent_slot, const void* ent_src, void* out, int n_hn, int p, int B,
                int N3p, void* stream) {
  return launch<float>(u, hn_sub, keep, row_ptr, ent_slot, ent_src, out, n_hn, p, B, N3p,
                       static_cast<cudaStream_t>(stream));
}

int fill_hn_f64(const void* u, const void* hn_sub, const void* keep, const void* row_ptr,
                const void* ent_slot, const void* ent_src, void* out, int n_hn, int p, int B,
                int N3p, void* stream) {
  return launch<double>(u, hn_sub, keep, row_ptr, ent_slot, ent_src, out, n_hn, p, B, N3p,
                        static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
