// refill_update: out [nb, N3p] from a brick vector v [nb, N3p] and the filled constrained rows
// u_hat [n_hn, n_loc]. For brick b and node k:
//   out = valid ? v + invden[b, w] * sum (u_hat[h, j] - v) : 0,
// valid = bit k % 32 of word k / 32 of brick b's row of valid_bits [nb, N3p/32]. The update runs
// only at the written nodes k = nodes[w] of the subset bricks (b < n_sub); the sum runs over the
// node's holders holders[w, 0..7] = slot << 16 | j (the cells of a brick that hold the node, in
// ascending slot order, -1 padded) whose cell is a constrained row h = cell_code[b*C + slot] >= 0,
// in that order (the plain version's), with j the node's local index in the cell.
//
// Replaces: the write-back of BrickLaplaceMM._refill_impl (dealii_matrixfree_hanging_nodes_tpu/
//   bricks.py:2884-2899) through _fill_chain_efx (2851-2865): the zeroed [n_sub*B^3, n_loc]
//   delta with the hn rows set, the EFX one-hot product, the coverage divide, the Es / EsI
//   one-hot scatters back into the bricks and the node_valid mask. The TPU side ran these as
//   XLA matmuls and scatters (no Pallas kernel).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (4,400 bricks, N3p = 4992; 1,025 subset
//   bricks with 1,538 written nodes each): memory. out written once at every node (87.9 MB),
//   v read once at the valid nodes only (94.6 % of them, 83.1 MB), the validity at one bit a
//   node (2.75 MB), the u_hat entries that valid written nodes read (at most 8.4 MB), invden
//   at the valid written nodes (at most 6.3 MB) and the small tables: about 184 MB, 55 us at
//   3.35 TB/s (refill_update.bytes_and_flops).
//
// Design: one block per brick, so the brick comes from blockIdx and no thread divides.
//   - pass 1, the masked copy out = valid ? v : 0, in 16-byte vectors (a brick row of N3p, a
//     multiple of 32, is whole vectors in f32 and f64): each thread loads its UNROLL vectors and
//     their validity words before it stores any, so a block keeps ~20 KB in flight; the validity
//     is one bit a node, 8x less than a bool;
//   - pass 2, in the subset bricks' blocks only, after the barrier that orders it after pass 1's
//     stores: one thread a written node. Its two 16-byte holder loads come from a table that
//     every brick shares (~49 KB at p=4, so it stays in L1 / L2), the brick's cell codes from
//     shared memory (staged once), so the u_hat loads of all 8 holders are issued together and
//     summed in holder order; the result overwrites out at the node. The loops over the 8
//     holders are unrolled, so every holder stays in a register and nothing goes to the stack.
//   No atomics: every output value is written by one block, pass 2 after pass 1. The subset
//   bricks lead the grid, so their longer blocks start in the first wave.
//   Resources (ptxas, sm_90a): 48 registers in f32 and f64, 256 bytes of shared memory, no
//   stack, no spills; 5 blocks of 256 threads an SM (the registers).
//   What holds it back: pass 2 (chip_smoke.py prints the masked copy alone, with no subset
//   bricks, beside a device copy_ of v): a chain of dependent loads (the node, then v and the
//   bits; the holders, then the codes, then u_hat), six nodes a thread at p=4, that the subset
//   blocks run in the first wave. Tried on the card in scratch builds and not kept (each
//   slower): the subset bricks spread through the grid, pass 2 unrolled by two, 512 threads
//   with 3 vectors a thread, 128 with 10, 3 vectors a thread, streaming cache hints on the copy.

// 2-D bricks (B^2 cells, at most 4 holders a node, padded to 8) run the same kernel: C = 64 at
// p = 4..6 and 256 at p <= 3 take the CMAX 64 and 512 instances.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 5;   // vectors a thread has in flight: 1,248 f32 vectors a brick at p=4
constexpr int HOLDERS = 8;  // the cells of a brick that share a node: 2 an axis

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

// x with the values whose bit in m (lowest bit first) is clear set to zero
__device__ __forceinline__ float4 masked(float4 x, unsigned m) {
  x.x = (m & 1u) ? x.x : 0.0f;
  x.y = (m & 2u) ? x.y : 0.0f;
  x.z = (m & 4u) ? x.z : 0.0f;
  x.w = (m & 8u) ? x.w : 0.0f;
  return x;
}

__device__ __forceinline__ double2 masked(double2 x, unsigned m) {
  x.x = (m & 1u) ? x.x : 0.0;
  x.y = (m & 2u) ? x.y : 0.0;
  return x;
}

// CMAX: the most cells a brick of the instance holds (64 at B <= 4; 512 and 4096 at B = 8, 16)
template <typename T, int CMAX>
__global__ void __launch_bounds__(THREADS)
refill_update_kernel(const T* __restrict__ v, const T* __restrict__ u_hat,
                     const unsigned* __restrict__ valid_bits, const int* __restrict__ cell_code,
                     const int* __restrict__ nodes, const int4* __restrict__ holders,
                     const T* __restrict__ invden, T* __restrict__ out, int n_sub, int n_w,
                     int N3p, int n_loc, int C) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::W;
  __shared__ int s_code[CMAX];
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t row = static_cast<size_t>(b) * N3p;
  const unsigned* bits = valid_bits + static_cast<size_t>(b) * (N3p / 32);
  const bool sub = b < n_sub;  // the same for the whole block
  if constexpr (CMAX <= THREADS) {  // one code a thread
    if (sub && tid < C) s_code[tid] = cell_code[b * C + tid];
  } else if (sub) {
    for (int i = tid; i < C; i += THREADS) s_code[i] = cell_code[static_cast<size_t>(b) * C + i];
  }

  // pass 1: the masked copy
  const V* src = reinterpret_cast<const V*>(v + row);
  V* dst = reinterpret_cast<V*>(out + row);
  const int nv = N3p / W;
  for (int i0 = tid; i0 < nv; i0 += UNROLL * THREADS) {
    V x[UNROLL];
    unsigned m[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < nv) {
        x[u] = src[i];
        m[u] = bits[(i * W) >> 5] >> ((i * W) & 31);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < nv) dst[i] = masked(x[u], m[u]);
    }
  }
  if (!sub) return;
  __syncthreads();

  // pass 2: the written nodes
  const T* vb = v + row;
  T* ob = out + row;
  const T* inv = invden + static_cast<size_t>(b) * n_w;
  for (int w = tid; w < n_w; w += THREADS) {
    const int node = __ldg(nodes + w);
    const int4 ha = __ldg(holders + 2 * w), hb = __ldg(holders + 2 * w + 1);
    const T val = vb[node];
    const T scale = inv[w];
    const bool valid = (bits[node >> 5] >> (node & 31)) & 1u;
    const int hv[HOLDERS] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
    T term[HOLDERS];
    bool use[HOLDERS];
#pragma unroll
    for (int k = 0; k < HOLDERS; ++k) {
      const int h = hv[k] >= 0 ? s_code[hv[k] >> 16] : -1;
      use[k] = h >= 0;
      const size_t o = static_cast<size_t>(h) * n_loc + (hv[k] & 0xFFFF);
      term[k] = use[k] ? __ldg(u_hat + o) : T(0);
    }
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < HOLDERS; ++k)
      if (use[k]) acc += term[k] - val;
    if (valid) ob[node] = val + acc * scale;  // an invalid node keeps pass 1's zero
  }
}

template <typename T, int CMAX>
int launch(const void* v, const void* u_hat, const void* valid_bits, const void* cell_code,
           const void* nodes, const void* holders, const void* invden, void* out, int nb,
           int n_sub, int n_w, int N3p, int n_loc, int C, cudaStream_t stream) {
  if (nb > 0) {
    refill_update_kernel<T, CMAX><<<nb, THREADS, 0, stream>>>(
        static_cast<const T*>(v), static_cast<const T*>(u_hat),
        static_cast<const unsigned*>(valid_bits), static_cast<const int*>(cell_code),
        static_cast<const int*>(nodes), static_cast<const int4*>(holders),
        static_cast<const T*>(invden), static_cast<T*>(out), n_sub, n_w, N3p, n_loc, C);
  }
  return static_cast<int>(cudaGetLastError());
}

// the instance whose cell-code table holds the brick's C cells: B <= 4, 8, 16
template <typename T>
int dispatch(const void* v, const void* u_hat, const void* valid_bits, const void* cell_code,
             const void* nodes, const void* holders, const void* invden, void* out, int nb,
             int n_sub, int n_w, int N3p, int n_loc, int C, cudaStream_t stream) {
  if (N3p % 32) return static_cast<int>(cudaErrorInvalidValue);
#define REFILL_CASE(cmax_)                                                                   \
  if (C <= cmax_)                                                                            \
    return launch<T, cmax_>(v, u_hat, valid_bits, cell_code, nodes, holders, invden, out, nb, \
                            n_sub, n_w, N3p, n_loc, C, stream);
  REFILL_CASE(64)
  REFILL_CASE(512)
  REFILL_CASE(4096)
#undef REFILL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int refill_update_f32(const void* v, const void* u_hat, const void* valid_bits,
                      const void* cell_code, const void* nodes, const void* holders,
                      const void* invden, void* out, int nb, int n_sub, int n_w, int N3p,
                      int n_loc, int C, void* stream) {
  return dispatch<float>(v, u_hat, valid_bits, cell_code, nodes, holders, invden, out, nb, n_sub,
                       n_w, N3p, n_loc, C, static_cast<cudaStream_t>(stream));
}

int refill_update_f64(const void* v, const void* u_hat, const void* valid_bits,
                      const void* cell_code, const void* nodes, const void* holders,
                      const void* invden, void* out, int nb, int n_sub, int n_w, int N3p,
                      int n_loc, int C, void* stream) {
  return dispatch<double>(v, u_hat, valid_bits, cell_code, nodes, holders, invden, out, nb, n_sub,
                        n_w, N3p, n_loc, C, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
