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
// Design: one thread a destination (blocks of 256 consecutive destinations, so the ptr reads and
//   the out writes are coalesced; embed's rows are brick nodes in storage order), which sums its
//   entries in list order: no atomics, no memset (an empty row writes 0), two calls give the same
//   bits. Rows hold 1-8 entries (a slave's masters), so a thread a row leaves no long tail.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
dof_embed_kernel(const T* __restrict__ x, const int* __restrict__ ptr, const int* __restrict__ idx,
                 const T* __restrict__ w, T* __restrict__ out, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int e1 = ptr[i + 1];
  T acc = T(0);
  for (int e = ptr[i]; e < e1; ++e) acc += w[e] * __ldg(x + idx[e]);
  out[i] = acc;
}

template <typename T>
int launch(const void* x, const void* ptr, const void* idx, const void* w, void* out, int n,
           cudaStream_t stream) {
  if (n > 0) {
    dof_embed_kernel<T><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int*>(ptr), static_cast<const int*>(idx),
        static_cast<const T*>(w), static_cast<T*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, ptr, idx, w, out: device pointers; n destinations
int dof_embed_f32(const void* x, const void* ptr, const void* idx, const void* w, void* out, int n,
                  void* stream) {
  return launch<float>(x, ptr, idx, w, out, n, static_cast<cudaStream_t>(stream));
}

int dof_embed_f64(const void* x, const void* ptr, const void* idx, const void* w, void* out, int n,
                  void* stream) {
  return launch<double>(x, ptr, idx, w, out, n, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
