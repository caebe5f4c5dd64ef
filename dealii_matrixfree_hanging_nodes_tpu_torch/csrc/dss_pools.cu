// dss_pools: the distributed brick engine's cross-brick direct-stiffness summation on a rank's
// slab [nb, N3p], in two launches around the exchange of the shared pools:
//   accumulate: every pool value of the rank's pools buffer (its regions, host-built: the
//     boundary pools -- global ids under the replicated exchange, the touched pools and a trash
//     value under the halo exchange -- then the internal pools, face, edge and corner kinds each
//     a run of pools of equal size) sums its contributing surface copies, read straight from
//     the slab: pool q's contributors are the (brick, entity) pairs pool_src[pool_ptr[q] ..
//     pool_ptr[q+1]] (brick << 5 | entity), and position j of the pool reads node
//     surf_node[ent_off[entity] + j] of that brick. A pool with no contributor (a trash value,
//     a boundary pool that the rank does not touch) sums to 0.
//   read (in place): every node of the slab that node_valid masks becomes 0; every valid
//     surface node, of entity k at position j (node_ent = k << 16 | j), takes the value of
//     pools[read_base[brick][k] + j], the boundary or internal pool that its flag names.
// The collective (an all_reduce of the boundary region, or the halo pack, all_to_all and add)
// runs between the two launches on the rank's stream.
// 3-D surfaces hold 6 faces, 12 edges and 8 corners; 2-D ones 4 sides and 4 corners, as
// dss_surface2_kernel's (the entity layout comes from the host: ent_off, node_ent).
//
// Replaces: DistributedBrickLaplace._dss_local and _dss_local_halo with the step's surface
//   extract and write-back (dealii_matrixfree_hanging_nodes_tpu/parallel/bricks_distributed.py:
//   793-931, 1097-1107: `surf = v @ Es^T`, per kind the internal and boundary pool scatter-adds,
//   the where-by-flag read, `v + (surf_new - surf) @ Es` and the node_valid mask); XLA one-hot
//   matmuls and scatters on the TPU (no Pallas kernel).
//
// Bound on an H100 SXM: memory. Accumulate: the surface copies of the slab read once, the pool
//   lists read once, the pools written once; read: the slab's valid surface nodes written once
//   from the pools, the invalid nodes written once (as zeros), the node tables read once.
//
// Design: accumulate runs one thread a pool value (the pool found by a binary search in
//   pool_off: pools of one kind are contiguous and of equal size), summing its contributors in
//   their fixed host order (ascending slab position), so no atomics and two calls give the same
//   bits; read runs one thread a slab node, blocks of 256 consecutive nodes of one brick row.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
dss_pools_accumulate_kernel(const T* __restrict__ v, const int* __restrict__ surf_node,
                            const int* __restrict__ ent_off, const int* __restrict__ pool_off,
                            const int* __restrict__ pool_ptr, const int* __restrict__ pool_src,
                            T* __restrict__ pools, int n_slots, int n_pools, int N3p) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_slots) return;
  int lo = 0, hi = n_pools;  // the pool q with pool_off[q] <= t < pool_off[q + 1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pool_off[mid] <= t) lo = mid; else hi = mid;
  }
  const int j = t - pool_off[lo], e1 = pool_ptr[lo + 1];
  T acc = T(0);
  for (int e = pool_ptr[lo]; e < e1; ++e) {
    const int c = pool_src[e];
    const int node = surf_node[ent_off[c & 31] + j];
    acc += __ldg(v + static_cast<long long>(c >> 5) * N3p + node);
  }
  pools[t] = acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dss_pools_read_kernel(T* __restrict__ v, const T* __restrict__ pools,
                      const int* __restrict__ node_ent, const int* __restrict__ read_base,
                      const int* __restrict__ valid_bits, int n_ent, int N3p) {
  const int node = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (node >= N3p) return;
  const long long g = static_cast<long long>(b) * N3p + node;
  const int word = valid_bits[b * (N3p >> 5) + (node >> 5)];
  if (!((word >> (node & 31)) & 1)) {
    v[g] = T(0);
    return;
  }
  const int code = node_ent[node];
  if (code >= 0) v[g] = pools[read_base[b * n_ent + (code >> 16)] + (code & 0xFFFF)];
}

template <typename T>
int accumulate_pools(const void* v, const void* surf_node, const void* ent_off,
                     const void* pool_off, const void* pool_ptr, const void* pool_src, void* pools,
                     int n_slots, int n_pools, int N3p, cudaStream_t s) {
  if (n_slots > 0)
    dss_pools_accumulate_kernel<T><<<(n_slots + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        static_cast<const T*>(v), static_cast<const int*>(surf_node),
        static_cast<const int*>(ent_off), static_cast<const int*>(pool_off),
        static_cast<const int*>(pool_ptr), static_cast<const int*>(pool_src),
        static_cast<T*>(pools), n_slots, n_pools, N3p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int read_pools(void* v, const void* pools, const void* node_ent, const void* read_base,
               const void* valid_bits, int nb, int n_ent, int N3p, cudaStream_t s) {
  if (nb > 0 && N3p > 0)
    dss_pools_read_kernel<T><<<dim3((N3p + THREADS - 1) / THREADS, nb), THREADS, 0, s>>>(
        static_cast<T*>(v), static_cast<const T*>(pools), static_cast<const int*>(node_ent),
        static_cast<const int*>(read_base), static_cast<const int*>(valid_bits), n_ent, N3p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// accumulate: v [nb][N3p] -> pools [n_slots] (n_slots = pool_off[n_pools])
int dss_pools_accumulate_f32(const void* v, const void* surf_node, const void* ent_off,
                             const void* pool_off, const void* pool_ptr, const void* pool_src,
                             void* pools, int n_slots, int n_pools, int N3p, void* stream) {
  return accumulate_pools<float>(v, surf_node, ent_off, pool_off, pool_ptr, pool_src, pools,
                                 n_slots, n_pools, N3p, static_cast<cudaStream_t>(stream));
}
int dss_pools_accumulate_f64(const void* v, const void* surf_node, const void* ent_off,
                             const void* pool_off, const void* pool_ptr, const void* pool_src,
                             void* pools, int n_slots, int n_pools, int N3p, void* stream) {
  return accumulate_pools<double>(v, surf_node, ent_off, pool_off, pool_ptr, pool_src, pools,
                                  n_slots, n_pools, N3p, static_cast<cudaStream_t>(stream));
}

// read: v [nb][N3p] in place from pools; node_ent [N3p], read_base [nb][n_ent], valid_bits
// [nb][N3p / 32]
int dss_pools_read_f32(void* v, const void* pools, const void* node_ent, const void* read_base,
                       const void* valid_bits, int nb, int n_ent, int N3p, void* stream) {
  return read_pools<float>(v, pools, node_ent, read_base, valid_bits, nb, n_ent, N3p,
                           static_cast<cudaStream_t>(stream));
}
int dss_pools_read_f64(void* v, const void* pools, const void* node_ent, const void* read_base,
                       const void* valid_bits, int nb, int n_ent, int N3p, void* stream) {
  return read_pools<double>(v, pools, node_ent, read_base, valid_bits, nb, n_ent, N3p,
                            static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
