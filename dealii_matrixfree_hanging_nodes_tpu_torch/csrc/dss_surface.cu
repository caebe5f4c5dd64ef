// dss_surface, in place on v [nb, N3p] (node (z, y, x) of a brick at (z*NB + y)*NB + x):
// every copy of a shared brick-surface node becomes the sum of all the copies of its
// interface pool, then every node outside the mesh (node_valid false: holes and padding)
// becomes 0. Interior nodes and valid unshared copies keep their values.
// With a leading axis of k components or right-hand sides (elasticity's k = 3: v [3, nb, N3p];
// BrickLaplaceMM.vmult_multi's k right-hand sides) each goes through the same tables: grid.y is
// the component or RHS, whose blocks offset v by it, so each is bit-identical to a scalar call on
// v[c], in one launch.
//
// Replaces: the input-fill branch of BrickLaplaceMM._dss_fill
//   (dealii_matrixfree_hanging_nodes_tpu/bricks.py:2562-2568, 2608-2612) with
//   BrickLaplaceMM._dss_surface (bricks.py:2096-2136): the one-hot surface extract, the pooled
//   face/edge/corner scatter-add and gather-back, the one-hot scatter of the delta, and the
//   node_valid mask. The TPU side ran it as XLA matmuls and scatters (no Pallas kernel). With
//   a leading axis, _dss_surface_multi (bricks.py:3303) with the node_valid mask of
//   _vmult_multi_impl (3563-3579) and of BrickElasticity (models/elasticity_bricks.py:258-263).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (4,400 bricks, N3p=4992): memory. In
//   words (kernels/dss_surface.py:moved_nodes, bytes_and_flops): every copy of a pool of
//   two or more copies read once and written once, a zero written at each invalid copy of
//   a pool of one copy and at each hole or padding node off the surface (valid unshared
//   copies and interior nodes do not move), and the work lists and bit tables as this
//   kernel reads them: 55.7 MB, 16.6 us at 3.35 TB/s. In 32-byte sectors, the unit the
//   memory moves (sector_bytes, an estimate beside the bound): x is the fastest axis, so a
//   node of an x-face shares its sector only with the node across the next row, which
//   belongs to the brick's other x-face. The moved nodes cover 111.1 MB of sectors, each
//   read and written once (33 us); where each surface block of a brick (its two x-faces
//   above all) pays its own sectors, 199.8 MB (60 us). The kernel (~104 us) stands nearer
//   that sector traffic than the bound in words.
//
// Design: gather by pool, in place, one launch. The host turns the pools into work lists
//   (bricks.kernel_tables): face pairs (or a lone face), edge pools and corner pools, each
//   with its copies in pool-canonical order as flat indices (face b*6+f, f = 2d+side;
//   edge b*12 + 4e + 2sa + sb; corner b*8 + c, bit d of c set where the corner sits at
//   NB-1 on axis d), the validity of every surface copy as one bit per surface position
//   (the order of kernels/dss_surface.py:surface_nodes), and the hole bricks with one bit
//   per brick node at the invalid nodes off the surface. The pools are disjoint, so each
//   has one owner that reads its copies from the unchanged v, sums them in canonical order
//   and writes the sum to each valid copy and 0 to each invalid one: copies come out
//   bit-identical with no atomics and no race. A pool of one copy is only zeroed where it
//   is invalid. Roles by block range, the long-latency ones first so that the bulk hides
//   them:
//     holes:   a block per hole brick, a thread per node whose bit is set;
//     corners: a thread per corner pool;
//     faces:   a warp per face entry, lanes over (row i, column j) of the face, 16 columns
//              a row, so on a y- or z-face a half-warp reads one contiguous row and on an
//              x-face a lane per (y, z) node; a lane loads all its nodes before it stores;
//     edges:   16 lanes per edge pool, a lane per edge node;
//     padding: a warp per brick zeroes N3..N3p.
//   NB is a template parameter (11, 13, 15, 17), so the loops over a face unroll.
//   2-D (dss_surface2_kernel, NB = 17, 33, 41, 49): side lines of NB-2 nodes, a thread per node
//   of a side entry, corner pools of up to 4 copies, no edges; the same roles otherwise. Bound
//   at 2-D quadrant nref=11, p=4, f32 (16,646 bricks, 33,820 side entries, 17,184 corner
//   pools): memory, 22.7 MB in words, 0.0068 ms; an x-side's nodes lie NB apart, one a 32-byte
//   sector, as the 3-D x-faces' do.
//   Positions come from the table entry (brick and face, edge or corner, decoded once per
//   copy) and the loop counters; interior nodes are never read, node_valid bytes never.
//   Resources (ptxas, sm_90a, CUDA 12.8): 64 registers in f32 at NB=17 (4 blocks of 256
//   threads an SM; the batched face loads take the registers), 80 in f64, 40-62 at NB=11-15;
//   no shared memory, no spills, no stack.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXC = 8;  // copies of a pool: 2 (face), 4 (edge), 8 (corner) in 3-D
constexpr int FACE_PER_BLOCK = THREADS / 32;
constexpr int EDGE_PER_BLOCK = THREADS / 16;
constexpr int PAD_PER_BLOCK = THREADS / 32;

struct Tables {
  const int* face_pairs;  // [n_face, 2], second -1 for a lone face
  const int* edge_pools;  // [n_edge, edge_w], -1 padded
  const int* corner_pools;  // [n_corner, corner_w], -1 padded
  const unsigned* valid_bits;  // [nb, valid_words]: bit s <-> surface position s
  const int* hole_bricks;  // [n_hole]
  const unsigned* hole_bits;  // [n_hole, hole_words]: bit k <-> brick node k
  int n_face, n_edge, edge_w, n_corner, corner_w, valid_words, n_hole, hole_words;
  int nb, N3p;
  int hole_blocks, corner_blocks, face_blocks, edge_blocks;
};

__device__ __forceinline__ bool bit(const unsigned* __restrict__ w, int i) {
  return (w[i >> 5] >> (i & 31)) & 1u;
}

template <int NB>
__device__ __forceinline__ int stride(int axis) {
  return axis == 0 ? 1 : (axis == 1 ? NB : NB * NB);
}

template <typename T, int NB>
__device__ __forceinline__ void holes(T* __restrict__ v, const Tables& t, int h) {
  T* __restrict__ vb = v + t.hole_bricks[h] * t.N3p;
  const unsigned* __restrict__ w = t.hole_bits + h * t.hole_words;
  for (int k = threadIdx.x; k < NB * NB * NB; k += THREADS)
    if (bit(w, k)) vb[k] = T(0);
}

// The copies of one edge or corner pool: their first nodes and first validity bits.
template <typename T>
__device__ __forceinline__ void pool_sum(T* __restrict__ v, const unsigned* __restrict__ vbits,
                                         const int (&pos)[MAXC], const int (&vb)[MAXC],
                                         int cnt, int o, int k) {
  if (cnt == 1) {
    if (!bit(vbits, vb[0] + k)) v[pos[0] + o] = T(0);
    return;
  }
  T x[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < cnt) x[c] = v[pos[c] + o];
  T s = x[0];
#pragma unroll
  for (int c = 1; c < MAXC; ++c)
    if (c < cnt) s += x[c];
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < cnt) v[pos[c] + o] = bit(vbits, vb[c] + k) ? s : T(0);
}

template <typename T, int NB>
__device__ __forceinline__ void corners(T* __restrict__ v, const Tables& t, int blk) {
  constexpr int L = NB - 1, M = NB - 2;
  const int e = blk * THREADS + threadIdx.x;
  if (e >= t.n_corner) return;
  const int* list = t.corner_pools + e * t.corner_w;
  int pos[MAXC], vb[MAXC], cnt = 0;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    const int r = c < t.corner_w ? list[c] : -1;
    if (r < 0) continue;
    const int b = r >> 3, k = r & 7;  // bit d of k: the corner sits at NB-1 on axis d
    pos[c] = b * t.N3p + ((k & 1) + ((k >> 1) & 1) * NB + ((k >> 2) & 1) * NB * NB) * L;
    vb[c] = b * 32 * t.valid_words + 6 * M * M + 12 * M + k;
    cnt = c + 1;
  }
  pool_sum(v, t.valid_bits, pos, vb, cnt, 0, 0);
}

template <typename T, int NB>
__device__ __forceinline__ void faces(T* __restrict__ v, const Tables& t, int blk) {
  constexpr int L = NB - 1, M = NB - 2, R = (M + 1) / 2;
  static_assert(M <= 16, "a face row fits in 16 lanes");
  const int e = blk * FACE_PER_BLOCK + (threadIdx.x >> 5);
  if (e >= t.n_face) return;
  const int r0 = t.face_pairs[2 * e], r1 = t.face_pairs[2 * e + 1];
  // face f = 2d + side: node (i, j) at side*L on axis d, i+1 on the slower tangential
  // axis, j+1 on the faster one (x, or y on an x-face); a partner is on the other side
  const int d = (r0 % 6) >> 1;
  const int sd = stride<NB>(d), si = stride<NB>(d == 2 ? 1 : 2), sj = stride<NB>(d == 0);
  const int vbits = 32 * t.valid_words;
  auto base = [&](int r) { return (r / 6) * t.N3p + ((r % 6) & 1) * L * sd + si + sj; };
  auto vbase = [&](int r) { return (r / 6) * vbits + (r % 6) * M * M; };
  const int p0 = base(r0), b0 = vbase(r0);
  const int lane = threadIdx.x & 31, i0 = lane >> 4, j = lane & 15;
  if (j >= M) return;
  if (r1 < 0) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = i0 + 2 * q;
      if (i < M && !bit(t.valid_bits, b0 + i * M + j)) v[p0 + i * si + j * sj] = T(0);
    }
    return;
  }
  const int p1 = base(r1), b1 = vbase(r1);
  T x0[R], x1[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = i0 + 2 * q;
    if (i < M) {
      x0[q] = v[p0 + i * si + j * sj];
      x1[q] = v[p1 + i * si + j * sj];
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = i0 + 2 * q;
    if (i < M) {
      const T s = x0[q] + x1[q];
      const int o = i * si + j * sj, k = i * M + j;
      v[p0 + o] = bit(t.valid_bits, b0 + k) ? s : T(0);
      v[p1 + o] = bit(t.valid_bits, b1 + k) ? s : T(0);
    }
  }
}

template <typename T, int NB>
__device__ __forceinline__ void edges(T* __restrict__ v, const Tables& t, int blk) {
  constexpr int L = NB - 1, M = NB - 2;
  const int e = blk * EDGE_PER_BLOCK + (threadIdx.x >> 4), j = threadIdx.x & 15;
  if (e >= t.n_edge || j >= M) return;
  const int* list = t.edge_pools + e * t.edge_w;
  // edge l = 4 ax + 2 sa + sb along axis ax, at sa*L, sb*L on the other axes (ascending)
  int pos[MAXC], vb[MAXC], cnt = 0, step = 0;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    const int r = c < t.edge_w ? list[c] : -1;
    if (r < 0) continue;
    const int b = r / 12, l = r - 12 * b, ax = l >> 2;
    step = stride<NB>(ax);
    pos[c] = b * t.N3p + ((l >> 1) & 1) * L * stride<NB>(ax == 0 ? 1 : 0) +
             (l & 1) * L * stride<NB>(ax == 2 ? 1 : 2) + step;
    vb[c] = b * 32 * t.valid_words + 6 * M * M + l * M;
    cnt = c + 1;
  }
  pool_sum(v, t.valid_bits, pos, vb, cnt, j * step, j);
}

// the padding N3..N3p of each brick, N3 = NB^3 (NB^2 in 2-D)
template <typename T, int N3>
__device__ __forceinline__ void padding(T* __restrict__ v, const Tables& t, int blk) {
  const int b = blk * PAD_PER_BLOCK + (threadIdx.x >> 5);
  if (b >= t.nb) return;
  for (int k = N3 + (threadIdx.x & 31); k < t.N3p; k += 32) v[b * t.N3p + k] = T(0);
}

template <typename T, int NB, bool MULTI>
__global__ void __launch_bounds__(THREADS) dss_surface_kernel(T* __restrict__ v, Tables t) {
  if constexpr (MULTI) v += static_cast<size_t>(blockIdx.y) * t.nb * t.N3p;  // the component
  int blk = blockIdx.x;
  if (blk < t.hole_blocks) return holes<T, NB>(v, t, blk);
  blk -= t.hole_blocks;
  if (blk < t.corner_blocks) return corners<T, NB>(v, t, blk);
  blk -= t.corner_blocks;
  if (blk < t.face_blocks) return faces<T, NB>(v, t, blk);
  blk -= t.face_blocks;
  if (blk < t.edge_blocks) return edges<T, NB>(v, t, blk);
  padding<T, NB * NB * NB>(v, t, blk - t.edge_blocks);
}

// ---- 2-D: a brick of NB^2 nodes (node (y, x) at y*NB + x) has 4 side lines, f = 2d + side
// (d = 0: the x-sides, x = side*L, y = i+1; d = 1: the y-sides, y = side*L, x = i+1; surface
// positions f*M + i) and 4 corners (bit d of c set where the corner sits at L on axis d; position
// 4M + c), no edges. Roles by block range as in 3-D: holes (a block per hole brick), corners (a
// thread per corner pool of up to 4 copies), sides (a thread per node of a side entry: a lone
// side zeroed where invalid, a pair summed), padding (a warp per brick).
template <typename T, int NB>
__device__ __forceinline__ void holes2(T* __restrict__ v, const Tables& t, int h) {
  T* __restrict__ vb = v + t.hole_bricks[h] * t.N3p;
  const unsigned* __restrict__ w = t.hole_bits + h * t.hole_words;
  for (int k = threadIdx.x; k < NB * NB; k += THREADS)
    if (bit(w, k)) vb[k] = T(0);
}

template <typename T, int NB>
__device__ __forceinline__ void corners2(T* __restrict__ v, const Tables& t, int blk) {
  constexpr int L = NB - 1, M = NB - 2;
  const int e = blk * THREADS + threadIdx.x;
  if (e >= t.n_corner) return;
  const int* list = t.corner_pools + e * t.corner_w;
  int pos[MAXC], vb[MAXC], cnt = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int r = c < t.corner_w ? list[c] : -1;
    if (r < 0) continue;
    const int b = r >> 2, k = r & 3;
    pos[c] = b * t.N3p + ((k & 1) + ((k >> 1) & 1) * NB) * L;
    vb[c] = b * 32 * t.valid_words + 4 * M + k;
    cnt = c + 1;
  }
  pool_sum(v, t.valid_bits, pos, vb, cnt, 0, 0);
}

template <typename T, int NB>
__device__ __forceinline__ void sides2(T* __restrict__ v, const Tables& t, int blk) {
  constexpr int L = NB - 1, M = NB - 2;
  const int q = blk * THREADS + threadIdx.x, e = q / M, i = q - e * M;
  if (e >= t.n_face) return;
  const int r0 = t.face_pairs[2 * e], r1 = t.face_pairs[2 * e + 1];
  const int d = (r0 & 3) >> 1;
  const int sd = d == 0 ? 1 : NB, st = d == 0 ? NB : 1;  // normal, along the side
  const int vbits = 32 * t.valid_words;
  auto node = [&](int r) { return (r >> 2) * t.N3p + (r & 1) * L * sd + (i + 1) * st; };
  auto vpos = [&](int r) { return (r >> 2) * vbits + (r & 3) * M + i; };
  const int n0 = node(r0);
  if (r1 < 0) {
    if (!bit(t.valid_bits, vpos(r0))) v[n0] = T(0);
    return;
  }
  const int n1 = node(r1);
  const T s = v[n0] + v[n1];
  v[n0] = bit(t.valid_bits, vpos(r0)) ? s : T(0);
  v[n1] = bit(t.valid_bits, vpos(r1)) ? s : T(0);
}

template <typename T, int NB, bool MULTI>
__global__ void __launch_bounds__(THREADS) dss_surface2_kernel(T* __restrict__ v, Tables t) {
  if constexpr (MULTI) v += static_cast<size_t>(blockIdx.y) * t.nb * t.N3p;  // the component
  int blk = blockIdx.x;
  if (blk < t.hole_blocks) return holes2<T, NB>(v, t, blk);
  blk -= t.hole_blocks;
  if (blk < t.corner_blocks) return corners2<T, NB>(v, t, blk);
  blk -= t.corner_blocks;
  if (blk < t.face_blocks) return sides2<T, NB>(v, t, blk);
  padding<T, NB * NB>(v, t, blk - t.face_blocks);
}

template <typename T, int NB>
int launch2(void* v, Tables t, int k, cudaStream_t stream) {
  auto blocks = [](int n, int per) { return (n + per - 1) / per; };
  if (t.n_edge || t.corner_w > 4) return static_cast<int>(cudaErrorInvalidValue);
  t.hole_blocks = t.n_hole;
  t.corner_blocks = blocks(t.n_corner, THREADS);
  t.face_blocks = blocks(t.n_face * (NB - 2), THREADS);
  t.edge_blocks = 0;
  const int total = t.hole_blocks + t.corner_blocks + t.face_blocks + blocks(t.nb, PAD_PER_BLOCK);
  if (total > 0)
    (k > 1 ? dss_surface2_kernel<T, NB, true> : dss_surface2_kernel<T, NB, false>)
        <<<dim3(total, k), THREADS, 0, stream>>>(static_cast<T*>(v), t);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NB>
int launch(void* v, Tables t, int k, cudaStream_t stream) {
  auto blocks = [](int n, int per) { return (n + per - 1) / per; };
  t.hole_blocks = t.n_hole;
  t.corner_blocks = blocks(t.n_corner, THREADS);
  t.face_blocks = blocks(t.n_face, FACE_PER_BLOCK);
  t.edge_blocks = blocks(t.n_edge, EDGE_PER_BLOCK);
  const int total = t.hole_blocks + t.corner_blocks + t.face_blocks + t.edge_blocks +
                    blocks(t.nb, PAD_PER_BLOCK);
  if (total > 0)
    (k > 1 ? dss_surface_kernel<T, NB, true> : dss_surface_kernel<T, NB, false>)
        <<<dim3(total, k), THREADS, 0, stream>>>(static_cast<T*>(v), t);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int entry(void* v, const void* face_pairs, int n_face, const void* edge_pools, int n_edge,
          int edge_w, const void* corner_pools, int n_corner, int corner_w,
          const void* valid_bits, int valid_words, const void* hole_bricks,
          const void* hole_bits, int n_hole, int hole_words, int nb, int NB, int N3p, int k,
          int dim, void* stream) {
  if (edge_w > MAXC || corner_w > MAXC) return static_cast<int>(cudaErrorInvalidValue);
  Tables t{};
  t.face_pairs = static_cast<const int*>(face_pairs);
  t.edge_pools = static_cast<const int*>(edge_pools);
  t.corner_pools = static_cast<const int*>(corner_pools);
  t.valid_bits = static_cast<const unsigned*>(valid_bits);
  t.hole_bricks = static_cast<const int*>(hole_bricks);
  t.hole_bits = static_cast<const unsigned*>(hole_bits);
  t.n_face = n_face;
  t.n_edge = n_edge;
  t.edge_w = edge_w;
  t.n_corner = n_corner;
  t.corner_w = corner_w;
  t.valid_words = valid_words;
  t.n_hole = n_hole;
  t.hole_words = hole_words;
  t.nb = nb;
  t.N3p = N3p;
  auto s = static_cast<cudaStream_t>(stream);
  if (dim == 2) {
    switch (NB) {  // NB = B*p + 1 in 2-D: 17 (p=1), 33 (p=2, 4), 41 (p=5), 49 (p=3, 6)
      case 17: return launch2<T, 17>(v, t, k, s);
      case 33: return launch2<T, 33>(v, t, k, s);
      case 41: return launch2<T, 41>(v, t, k, s);
      case 49: return launch2<T, 49>(v, t, k, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dim != 3) return static_cast<int>(cudaErrorInvalidValue);
  switch (NB) {  // NB = B*p + 1 of the brick size rule: p=5, 6, 7 at B=2; p=4 at B=4, p=8 at B=2
    case 11: return launch<T, 11>(v, t, k, s);
    case 13: return launch<T, 13>(v, t, k, s);
    case 15: return launch<T, 15>(v, t, k, s);
    case 17: return launch<T, 17>(v, t, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// k components of v (1 or 3), nb * N3p values apart; dim: 3 (NB^3-node bricks) or 2 (NB^2)
int dss_surface_f32(void* v, const void* face_pairs, int n_face, const void* edge_pools,
                    int n_edge, int edge_w, const void* corner_pools, int n_corner,
                    int corner_w, const void* valid_bits, int valid_words,
                    const void* hole_bricks, const void* hole_bits, int n_hole, int hole_words,
                    int nb, int NB, int N3p, int k, int dim, void* stream) {
  return entry<float>(v, face_pairs, n_face, edge_pools, n_edge, edge_w, corner_pools,
                      n_corner, corner_w, valid_bits, valid_words, hole_bricks, hole_bits,
                      n_hole, hole_words, nb, NB, N3p, k, dim, stream);
}

int dss_surface_f64(void* v, const void* face_pairs, int n_face, const void* edge_pools,
                    int n_edge, int edge_w, const void* corner_pools, int n_corner,
                    int corner_w, const void* valid_bits, int valid_words,
                    const void* hole_bricks, const void* hole_bits, int n_hole, int hole_words,
                    int nb, int NB, int N3p, int k, int dim, void* stream) {
  return entry<double>(v, face_pairs, n_face, edge_pools, n_edge, edge_w, corner_pools,
                       n_corner, corner_w, valid_bits, valid_words, hole_bricks, hole_bits,
                       n_hole, hole_words, nb, NB, N3p, k, dim, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
