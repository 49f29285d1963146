// The split decode instances of paged_attention.cu for f32 q over
// int8 pools: head_dim 64, 128, 256 x groups of 1, 2, 4, 8 (12 of the
// 72), a translation unit of their own, linked into its library.
#include "../paged_attention.cuh"

namespace paged_attention_impl {
template cudaError_t split_by_dim<float, int8_t>(const DecodeArgs& a);
}  // namespace paged_attention_impl
