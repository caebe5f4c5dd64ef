// The band structure of the brick-assembled 1-D factors (Kb, Mb, Gb, Gb^T: cell blocks of p+1
// summed along a brick of NB = B p + 1 nodes), shared by brick_apply.cu and brick_elasticity.cu,
// whose kernels take the structural nonzeros packed row by row as launch parameters; and the
// compile-time expansion of their 2-D rounds over those bands.

#pragma once

#include <utility>

namespace {

// Structural nonzeros of row i of a brick factor: columns lo(i)..hi(i).
template <int NB, int P>
__host__ __device__ constexpr int lo(int i) {
  return i == 0 ? 0 : (i - 1) / P * P;
}
template <int NB, int P>
__host__ __device__ constexpr int hi(int i) {
  return (i / P + 1) * P < NB - 1 ? (i / P + 1) * P : NB - 1;
}
// Offset of row i in the packed factor: p+1 entries a row, p more on each interior cell
// boundary before row i.
template <int NB, int P>
__host__ __device__ constexpr int row_offset(int i) {
  const int b = i == 0 ? 0 : (i - 1) / P;
  return i * (P + 1) + P * (b < (NB - 1) / P - 1 ? b : (NB - 1) / P - 1);
}

// Compile-time expansion of the 2-D rounds: fn(integral_constant<I>) for each row I < NB, and
// term(e, j) for each structural nonzero j = lo(I) .. hi(I) of row I, e its place in the packed
// factor (both as integral constants). Written out by parameter packs, not left to `#pragma
// unroll` (which leaves a 33 x 33 loop with conditions rolled: factor loads by LDC and the band
// decided at run time).
template <int... I, typename Fn>
__device__ __forceinline__ void each_row_seq(Fn&& fn, std::integer_sequence<int, I...>) {
  (fn(std::integral_constant<int, I>{}), ...);
}
template <int NB, typename Fn>
__device__ __forceinline__ void each_row(Fn&& fn) {
  each_row_seq(fn, std::make_integer_sequence<int, NB>{});
}
template <int NB, int P, int I, int... J, typename Fn>
__device__ __forceinline__ void band_seq(Fn&& term, std::integer_sequence<int, J...>) {
  (term(std::integral_constant<int, row_offset<NB, P>(I) + J>{},
        std::integral_constant<int, lo<NB, P>(I) + J>{}), ...);
}
template <int NB, int P, int I, typename Fn>
__device__ __forceinline__ void band(Fn&& term) {
  band_seq<NB, P, I>(term, std::make_integer_sequence<int, hi<NB, P>(I) - lo<NB, P>(I) + 1>{});
}

}  // namespace
