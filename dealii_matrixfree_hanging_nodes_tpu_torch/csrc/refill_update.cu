// refill_update: out [nb, N3p] from a brick vector v [nb, N3p] and the filled constrained rows
// u_hat [n_hn, n_loc]. For brick b and node (x, y, z) (x fastest, NB = B*p + 1 per axis):
//   out = node_valid ? v + invden[b, pos] * sum (u_hat[h, j] - v) : 0,
// where pos = refill_pos[node] >= 0 marks a node the fill writes (no update where pos < 0 or
// b >= n_sub), and the sum runs over the cells of brick b that hold the node, in cell-slot
// order (slot = cx + B*(cy + B*cz)), that are constrained rows h = cell_code[b*B^3 + slot] >= 0,
// with j the node's local index in that cell.
//
// Replaces: the write-back of BrickLaplaceMM._refill_impl (dealii_matrixfree_hanging_nodes_tpu/
//   bricks.py:2884-2899) through _fill_chain_efx (2851-2865): the zeroed [n_sub*B^3, n_loc]
//   delta with the hn rows set, the EFX one-hot product, the coverage divide, the Es / EsI
//   one-hot scatters back into the bricks and the node_valid mask. The TPU side ran these as
//   XLA matmuls and scatters (no Pallas kernel).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (4,400 bricks, N3p = 4992): memory. v
//   read once and out written once (2 x 87.9 MB), node_valid as stored (22 MB, one byte a
//   node), u_hat (8.4 MB), invden (12.2 MB) and the small tables: about 218 MB, 65 us at
//   3.35 TB/s.
//
// Design: one thread per (brick, node), gather only: a node's coordinates give the 1-8 cells
//   of its brick that hold it and its local index in each, so the thread sums the
//   differences of the constrained ones in cell-slot order (the plain version's order) with
//   no atomics and no per-brick lists. Every writer of a node carries the same value, so the
//   coverage mean restores it up to rounding. v, node_valid and out are read and written
//   coalesced; only the subset bricks' written nodes (a small share) do more than copy.

#include <cuda_runtime.h>

namespace {

// The cells (along one axis) holding lattice coordinate x: their cell coordinate and the
// node's local index in each, ascending in the cell coordinate. Returns how many (1 or 2).
__device__ __forceinline__ int holders(int x, int p, int B, int* c, int* i) {
  const int q = x / p, r = x - (x / p) * p;
  if (r != 0) {
    c[0] = q;
    i[0] = r;
    return 1;
  }
  int k = 0;
  if (q >= 1) {
    c[k] = q - 1;
    i[k++] = p;
  }
  if (q <= B - 1) {
    c[k] = q;
    i[k++] = 0;
  }
  return k;
}

template <typename T>
__global__ void refill_update_kernel(const T* __restrict__ v, const T* __restrict__ u_hat,
                                     const bool* __restrict__ node_valid,
                                     const int* __restrict__ cell_code,
                                     const int* __restrict__ refill_pos,
                                     const T* __restrict__ invden, T* __restrict__ out, int nb,
                                     int n_sub, int n_pos, int N3p, int n_loc, int p, int B) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(nb) * N3p) return;
  if (!node_valid[t]) {
    out[t] = T(0);
    return;
  }
  const int b = static_cast<int>(t / N3p);
  const int node = static_cast<int>(t - static_cast<long long>(b) * N3p);
  T val = v[t];
  const int pos = b < n_sub ? refill_pos[node] : -1;
  if (pos >= 0) {
    const int NB = B * p + 1, n = p + 1, C = B * B * B;
    int cx[2], ix[2], cy[2], iy[2], cz[2], iz[2];
    const int nx = holders(node % NB, p, B, cx, ix);
    const int ny = holders((node / NB) % NB, p, B, cy, iy);
    const int nz = holders(node / (NB * NB), p, B, cz, iz);
    const int* codes = cell_code + static_cast<size_t>(b) * C;
    T acc = T(0);
    for (int a = 0; a < nz; ++a)
      for (int e = 0; e < ny; ++e)
        for (int f = 0; f < nx; ++f) {
          const int h = codes[cx[f] + B * (cy[e] + B * cz[a])];
          if (h >= 0) acc += u_hat[static_cast<size_t>(h) * n_loc + ix[f] + n * (iy[e] + n * iz[a])] - val;
        }
    val = val + acc * invden[static_cast<size_t>(b) * n_pos + pos];
  }
  out[t] = val;
}

template <typename T>
int launch(const void* v, const void* u_hat, const void* node_valid, const void* cell_code,
           const void* refill_pos, const void* invden, void* out, int nb, int n_sub, int n_pos,
           int N3p, int n_loc, int p, int B, cudaStream_t stream) {
  const long long total = static_cast<long long>(nb) * N3p;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
    refill_update_kernel<T><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(v), static_cast<const T*>(u_hat),
        static_cast<const bool*>(node_valid), static_cast<const int*>(cell_code),
        static_cast<const int*>(refill_pos), static_cast<const T*>(invden), static_cast<T*>(out),
        nb, n_sub, n_pos, N3p, n_loc, p, B);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int refill_update_f32(const void* v, const void* u_hat, const void* node_valid,
                      const void* cell_code, const void* refill_pos, const void* invden,
                      void* out, int nb, int n_sub, int n_pos, int N3p, int n_loc, int p, int B,
                      void* stream) {
  return launch<float>(v, u_hat, node_valid, cell_code, refill_pos, invden, out, nb, n_sub,
                       n_pos, N3p, n_loc, p, B, static_cast<cudaStream_t>(stream));
}

int refill_update_f64(const void* v, const void* u_hat, const void* node_valid,
                      const void* cell_code, const void* refill_pos, const void* invden,
                      void* out, int nb, int n_sub, int n_pos, int N3p, int n_loc, int p, int B,
                      void* stream) {
  return launch<double>(v, u_hat, node_valid, cell_code, refill_pos, invden, out, nb, n_sub,
                        n_pos, N3p, n_loc, p, B, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
