// PackedInt transport words: pack an int32 image into k = 32/bits fields per
// int32 word, and unpack an n-worker word sum back into the summed image.
//
// Replaces the TPU kernels src/repro/kernels/wire_pack.py::pack_words_2d
// (`_pack_kernel`) and ::unpack_words_2d (`_unpack_kernel`). The Pallas
// wrappers copy the image into a padded chunk-major (k, rows, cols) view;
// here thread w indexes the flat image in place: field j of word w is image
// element j*m + w, with m = ceil(d / k) words. Past the end of the image a
// field holds 0 + lim, as the zero-padded JAX image does.
//
//   pack:   word[w] = sum_j (x[j*m + w] + lim) << (j*bits)       (mod 2^32)
//   unpack: out[j*m + w] = ((word[w] >> (j*bits)) & mask) - nlim,
//           written only where j*m + w < d
//
// Field arithmetic is uint32, so the wrap-around the n-worker word sum relies
// on (packed8 sets bit 31) is defined behaviour here.
//
// Bound on the card: memory. pack reads 4 bytes and writes 4/k bytes per
// image element, unpack the reverse; a handful of integer operations per
// element. Design: one thread per word in a grid-stride loop; for each j the
// threads of a warp read (or write) consecutive image elements, so every
// access is coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void pack_words_kernel(const int32_t* __restrict__ x,
                                  int32_t* __restrict__ words, int64_t d,
                                  int64_t m, int k, int bits, int32_t lim) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       w < m; w += stride) {
    uint32_t word = 0u;
    for (int j = 0; j < k; ++j) {
      const int64_t idx = static_cast<int64_t>(j) * m + w;
      const int32_t v = idx < d ? x[idx] : 0;
      word += (static_cast<uint32_t>(v) + static_cast<uint32_t>(lim))
              << (j * bits);
    }
    words[w] = static_cast<int32_t>(word);
  }
}

__global__ void unpack_words_kernel(const int32_t* __restrict__ words,
                                    int32_t* __restrict__ out, int64_t d,
                                    int64_t m, int k, int bits, int32_t nlim) {
  const uint32_t mask = (bits == 32) ? 0xFFFFFFFFu : ((1u << bits) - 1u);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       w < m; w += stride) {
    const uint32_t word = static_cast<uint32_t>(words[w]);
    for (int j = 0; j < k; ++j) {
      const int64_t idx = static_cast<int64_t>(j) * m + w;
      if (idx < d) {
        const uint32_t field = (word >> (j * bits)) & mask;
        out[idx] = static_cast<int32_t>(field - static_cast<uint32_t>(nlim));
      }
    }
  }
}

inline unsigned grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return static_cast<unsigned>(blocks);
}

}  // namespace

extern "C" int repro_pack_words(const int32_t* x, int32_t* words, int64_t d,
                                int64_t m, int32_t k, int32_t bits,
                                int32_t lim, cudaStream_t stream) {
  if (m <= 0) return 0;
  pack_words_kernel<<<grid_for(m, 256), 256, 0, stream>>>(x, words, d, m, k,
                                                          bits, lim);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_unpack_words(const int32_t* words, int32_t* out,
                                  int64_t d, int64_t m, int32_t k,
                                  int32_t bits, int32_t nlim,
                                  cudaStream_t stream) {
  if (m <= 0) return 0;
  unpack_words_kernel<<<grid_for(m, 256), 256, 0, stream>>>(words, out, d, m,
                                                            k, bits, nlim);
  return static_cast<int>(cudaGetLastError());
}
