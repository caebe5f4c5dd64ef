// cell_apply: out[r, j] = scale[r] * sum_i K[j, i] x[r, i] for every cell row r, with
// n_loc = (p+1)^3 local nodes per row (x fastest). Two input modes, chosen by B:
//   B > 0 (from bricks): x[r] are the nodes of cell r read from its brick: cell r is slot
//     r % B^3 (x fastest) of brick r / B^3 of src [m, N3p], its node (ix, iy, iz) sits at
//     brick node ((sz*p + iz)*NB + sy*p + iy)*NB + sx*p + ix, NB = B*p + 1;
//   B == 0 (from rows): x[r] = src[r, :], src [rows, n_loc].
//
// Replaces: BrickLaplaceMM._extract_cols (dealii_matrixfree_hanging_nodes_tpu/bricks.py:
//   2178-2194) fused with the local stiffness apply `cols @ K.T * geo_cell_sub`
//   (bricks.py:2449-2453), and `u_hat @ K.T * geo_cell_sub[hn_sub]` (bricks.py:2469-2471).
//   The TPU side ran these as XLA conv-patch extraction and MXU matmuls (no Pallas kernel).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32: operations. From bricks, 65,600 rows:
//   2.05 GFLOP (31 us at 67 TFLOP/s f32 outside the tensor cores) against 53 MB of least
//   traffic (16 us); from rows, 16,744 rows: 0.52 GFLOP (8 us) against 17 MB.
//
// Design: a tiled product out = X K^T with the gather fused into the X-tile load. A block of
//   256 threads owns a 64-row x 128-column output tile (the 125 columns of p=4 in one tile)
//   and walks the shared dimension in chunks of 16: it stages the X chunk (gathered from
//   the bricks, or read from the rows) and the K^T chunk in shared memory, then each thread
//   accumulates 8 rows x 4 columns in registers; K (62 KB in f32) stays in L2 for all
//   blocks. The scale is applied once per output. Any degree fits: neither K nor a cell has
//   to fit in shared memory (24.6 KB per block in f64).

#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;   // rows per block
constexpr int TN = 128;  // output columns per block
constexpr int TK = 16;   // shared-dimension chunk
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
cell_apply_kernel(const T* __restrict__ src, const T* __restrict__ K,
                  const T* __restrict__ scale, T* __restrict__ out, int rows, int p, int B,
                  int N3p) {
  __shared__ T Xs[TK][TM + 1];
  __shared__ T Ks[TK][TN];
  const int n = p + 1;
  const int n_loc = n * n * n;
  const int NB = B * p + 1;
  const int C = B * B * B;
  const int r0 = blockIdx.x * TM;
  const int c0 = blockIdx.y * TN;
  const int tx = threadIdx.x & 31;  // column lane: columns tx + 32 c
  const int ty = threadIdx.x >> 5;  // row group: rows 8 ty .. 8 ty + 7

  T acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = T(0);

  for (int k0 = 0; k0 < n_loc; k0 += TK) {
    for (int e = threadIdx.x; e < TM * TK; e += THREADS) {
      const int rr = e / TK, kk = e - (e / TK) * TK;
      const int row = r0 + rr, i = k0 + kk;
      T val = T(0);
      if (row < rows && i < n_loc) {
        if (B > 0) {
          const int brick = row / C, slot = row - brick * C;
          const int sx = slot % B, sy = (slot / B) % B, sz = slot / (B * B);
          const int ix = i % n, iy = (i / n) % n, iz = i / (n * n);
          const size_t node =
              (static_cast<size_t>(sz * p + iz) * NB + (sy * p + iy)) * NB + (sx * p + ix);
          val = src[static_cast<size_t>(brick) * N3p + node];
        } else {
          val = src[static_cast<size_t>(row) * n_loc + i];
        }
      }
      Xs[kk][rr] = val;
    }
    for (int e = threadIdx.x; e < TN * TK; e += THREADS) {
      const int cc = e / TK, kk = e - (e / TK) * TK;
      const int col = c0 + cc, i = k0 + kk;
      Ks[kk][cc] = (col < n_loc && i < n_loc) ? K[static_cast<size_t>(col) * n_loc + i] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      T a[8], b[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = Xs[kk][ty * 8 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Ks[kk][tx + 32 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += a[r] * b[c];
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = r0 + ty * 8 + r;
    if (row >= rows) continue;
    const T s = scale[row];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c0 + tx + 32 * c;
      if (col < n_loc) out[static_cast<size_t>(row) * n_loc + col] = s * acc[r][c];
    }
  }
}

template <typename T>
int launch(const void* src, const void* K, const void* scale, void* out, int rows, int p,
           int B, int N3p, cudaStream_t stream) {
  const int n_loc = (p + 1) * (p + 1) * (p + 1);
  if (rows > 0) {
    dim3 grid((rows + TM - 1) / TM, (n_loc + TN - 1) / TN);
    cell_apply_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(src), static_cast<const T*>(K), static_cast<const T*>(scale),
        static_cast<T*>(out), rows, p, B, N3p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cell_apply_f32(const void* src, const void* K, const void* scale, void* out, int rows,
                   int p, int B, int N3p, void* stream) {
  return launch<float>(src, K, scale, out, rows, p, B, N3p, static_cast<cudaStream_t>(stream));
}

int cell_apply_f64(const void* src, const void* K, const void* scale, void* out, int rows,
                   int p, int B, int N3p, void* stream) {
  return launch<double>(src, K, scale, out, rows, p, B, N3p, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
