// dss_surface: out[b, node] = node_valid[b, node] ? dss(v)[b, node] : 0 on v [nb, N3p],
// where dss replaces every copy of a shared brick-surface node by the sum of all its copies
// over the interface pool, and leaves interior nodes and unshared copies as they are.
//
// Replaces: the input-fill branch of BrickLaplaceMM._dss_fill
//   (dealii_matrixfree_hanging_nodes_tpu/bricks.py:2562-2568, 2608-2612) with
//   BrickLaplaceMM._dss_surface (bricks.py:2096-2136): the one-hot surface extract, the pooled
//   face/edge/corner scatter-add and gather-back, the one-hot scatter of the delta, and the
//   node_valid mask. The TPU side ran it as XLA matmuls and scatters (no Pallas kernel).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (4,400 bricks, N3p=4992): memory, for
//   the function done in place on v. Each brick's 1,538 surface copies read once and written
//   once (2 x 27.1 MB), a zero written at each hole or padding node off the surface (padding
//   alone 1.4 MB), the hole pattern at one bit per node (2.7 MB) and the pair tables
//   (1.7 MB): about 63 MB, 19 us at 3.35 TB/s. This out-of-place kernel moves 199 MB (all of
//   v and node_valid read, all of out written); an in-place two-pass form would not.
//
// Design: one fused pass, one thread per (brick, node), gather only. A node's coordinates
//   say what it is: no coordinate on the brick boundary (0 or NB-1) is interior, one is a
//   face interior, two an edge interior, three a corner. A face copy adds its one partner
//   (face_other; faces pair at most two bricks); an edge or corner copy sums the full
//   contributor list of its pool (edge_contrib, corner_contrib), which is the same list in
//   the same pool-canonical order for every copy. So all copies of a node come out
//   bit-identical with no atomics: a + b == b + a exactly, and longer sums run in one order.
//   The partner node's position follows from the partner's face/edge/corner index and the
//   shared coordinates. Reads and writes of v and out are coalesced across x; the partner
//   reads land on the partner brick's matching face row.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void dss_surface_kernel(const T* __restrict__ v, const int* __restrict__ face_other,
                                   int face_w, const int* __restrict__ edge_contrib,
                                   int edge_w, const int* __restrict__ corner_contrib,
                                   int corner_w, const bool* __restrict__ node_valid,
                                   T* __restrict__ out, int nb, int NB, int N3p) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(nb) * N3p) return;
  const int b = static_cast<int>(t / N3p);
  const int node = static_cast<int>(t - static_cast<long long>(b) * N3p);
  const int N3 = NB * NB * NB;
  if (node >= N3 || !node_valid[t]) {
    out[t] = T(0);
    return;
  }
  const int L = NB - 1;
  int c[3] = {node % NB, (node / NB) % NB, node / (NB * NB)};
  int on[3], n_on = 0;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    on[d] = (c[d] == 0 || c[d] == L);
    n_on += on[d];
  }
  auto at = [&](int brick, const int* cc) -> T {
    return v[static_cast<size_t>(brick) * N3p + (cc[2] * NB + cc[1]) * NB + cc[0]];
  };
  T val;
  if (n_on == 0) {
    val = v[t];
  } else if (n_on == 1) {  // face interior: self + partner
    const int d = on[0] ? 0 : (on[1] ? 1 : 2);
    val = v[t];
    if (face_w) {
      const int r = face_other[b * 6 + 2 * d + (c[d] == L)];
      if (r < nb * 6) {
        const int f2 = r % 6;
        int c2[3] = {c[0], c[1], c[2]};
        c2[f2 >> 1] = (f2 & 1) ? L : 0;
        val = val + at(r / 6, c2);
      }
    }
  } else if (n_on == 2) {  // edge interior along axis e, the other axes ascending (a, a2)
    const int e = !on[0] ? 0 : (!on[1] ? 1 : 2);
    const int a = (e == 0) ? 1 : 0;
    const int a2 = (e == 2) ? 1 : 2;
    const int idx = e * 4 + (c[a] == L) * 2 + (c[a2] == L);
    const int* list = edge_contrib + static_cast<size_t>(b * 12 + idx) * edge_w;
    val = T(0);
    for (int k = 0; k < edge_w; ++k) {
      const int r = list[k];
      if (r >= nb * 12) continue;
      const int i2 = r % 12;
      int c2[3];
      c2[e] = c[e];
      c2[a] = ((i2 >> 1) & 1) ? L : 0;
      c2[a2] = (i2 & 1) ? L : 0;
      val += at(r / 12, c2);
    }
  } else {  // corner: bit d set where the corner sits at NB-1 on axis d
    const int combo = (c[0] == L) | ((c[1] == L) << 1) | ((c[2] == L) << 2);
    const int* list = corner_contrib + static_cast<size_t>(b * 8 + combo) * corner_w;
    val = T(0);
    for (int k = 0; k < corner_w; ++k) {
      const int r = list[k];
      if (r >= nb * 8) continue;
      const int co = r % 8;
      int c2[3] = {(co & 1) ? L : 0, ((co >> 1) & 1) ? L : 0, ((co >> 2) & 1) ? L : 0};
      val += at(r / 8, c2);
    }
  }
  out[t] = val;
}

template <typename T>
int launch(const void* v, const void* face_other, int face_w, const void* edge_contrib,
           int edge_w, const void* corner_contrib, int corner_w, const void* node_valid,
           void* out, int nb, int NB, int N3p, cudaStream_t stream) {
  const long long total = static_cast<long long>(nb) * N3p;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
    dss_surface_kernel<T><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(v), static_cast<const int*>(face_other), face_w,
        static_cast<const int*>(edge_contrib), edge_w,
        static_cast<const int*>(corner_contrib), corner_w,
        static_cast<const bool*>(node_valid), static_cast<T*>(out), nb, NB, N3p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dss_surface_f32(const void* v, const void* face_other, int face_w,
                    const void* edge_contrib, int edge_w, const void* corner_contrib,
                    int corner_w, const void* node_valid, void* out, int nb, int NB, int N3p,
                    void* stream) {
  return launch<float>(v, face_other, face_w, edge_contrib, edge_w, corner_contrib, corner_w,
                       node_valid, out, nb, NB, N3p, static_cast<cudaStream_t>(stream));
}

int dss_surface_f64(const void* v, const void* face_other, int face_w,
                    const void* edge_contrib, int edge_w, const void* corner_contrib,
                    int corner_w, const void* node_valid, void* out, int nb, int NB, int N3p,
                    void* stream) {
  return launch<double>(v, face_other, face_w, edge_contrib, edge_w, corner_contrib,
                        corner_w, node_valid, out, nb, NB, N3p,
                        static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
