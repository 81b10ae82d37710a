// Fused decode + heavy-ball SGD step straight off PackedInt transport words.
//
// Replaces the SGD body of the TPU kernel
// src/repro/kernels/fused_update.py::fused_unpack_apply_2d
// (`_unpack_sgd_kernel`, no IntDIANA shift). The Pallas wrapper copies
// param and momentum into a padded chunk-major (k, rows, cols) view; here
// thread w reads word w once and updates image elements j*m + w in place of
// that view (m = ceil(d / k) words, k = 32/bits fields per word).
//
// Per field, in float32 and in this order (scalars = [inv_nalpha, clip, lr,
// mu, wd], read from device memory, so the launch needs no host sync):
//   s     = float(((word >> j*bits) & mask) - nlim)
//   g     = clip * (s * inv_nalpha) + wd * p
//   m_new = mu * m + g
//   p_new = p - lr * m_new
// p_new and m_new go to fresh output tensors: the step needs the old params
// afterwards for the alpha rule's ||x' - x||^2.
//
// Build with --fmad=false: every product is rounded before its sum, as the
// plain PyTorch version (one elementwise op per line above) rounds it, so the
// two agree bit for bit on the card.
//
// Bound on the card: memory. 4/k bytes of words plus 16 bytes of f32 state
// (p and m read, p' and m' written) per element, about 7 float operations per
// element. Design: one thread per word in a grid-stride loop; for each field
// the threads of a warp touch consecutive elements, so all accesses coalesce.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void fused_unpack_sgd_kernel(const int32_t* __restrict__ words,
                                        const float* __restrict__ p,
                                        const float* __restrict__ mom,
                                        const float* __restrict__ scalars,
                                        float* __restrict__ p_out,
                                        float* __restrict__ m_out, int64_t d,
                                        int64_t m, int k, int bits,
                                        int32_t nlim) {
  const float inv_nalpha = scalars[0];
  const float clip = scalars[1];
  const float lr = scalars[2];
  const float mu = scalars[3];
  const float wd = scalars[4];
  const uint32_t mask = (1u << bits) - 1u;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       w < m; w += stride) {
    const uint32_t word = static_cast<uint32_t>(words[w]);
    for (int j = 0; j < k; ++j) {
      const int64_t idx = static_cast<int64_t>(j) * m + w;
      if (idx >= d) break;  // fields past the image end only at the tail
      const int32_t field = static_cast<int32_t>((word >> (j * bits)) & mask);
      const float s = static_cast<float>(field - nlim);
      const float pv = p[idx];
      const float g = clip * (s * inv_nalpha) + wd * pv;
      const float m_new = mu * mom[idx] + g;
      p_out[idx] = pv - lr * m_new;
      m_out[idx] = m_new;
    }
  }
}

}  // namespace

extern "C" int repro_fused_unpack_sgd(const int32_t* words, const float* p,
                                      const float* mom, const float* scalars,
                                      float* p_out, float* m_out, int64_t d,
                                      int64_t m, int32_t k, int32_t bits,
                                      int32_t nlim, cudaStream_t stream) {
  if (m <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (m + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  fused_unpack_sgd_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                            stream>>>(words, p, mom, scalars, p_out, m_out, d,
                                      m, k, bits, nlim);
  return static_cast<int>(cudaGetLastError());
}
