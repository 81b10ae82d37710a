// Fused decode + optimizer step: {SGD, AdamW} x {no shift, IntDIANA shift}
// x {PackedInt words, dense int8/int16/int32 lanes}, one pass per leaf.
//
// Replaces the TPU kernels of src/repro/kernels/fused_update.py:
//   fused_unpack_apply_2d (packed words; bodies _unpack_sgd_kernel and
//     _unpack_adamw_kernel, both with has_shift)   -> fused_unpack_kernel
//   fused_apply_2d (dense lanes; bodies _sgd_kernel and _adamw_kernel, both
//     with has_shift)                               -> fused_apply_kernel
// The Pallas wrappers copy param and state into padded 2-D (packed: chunk-
// major (k, rows, cols)) views. Here the packed kernel's thread w reads word
// w once and updates image elements j*m + w in place of that view (m =
// ceil(d / k) words, k = 32/bits fields per word); the dense kernel reads
// lane i for element i.
//
// Per element, in float32 and in the JAX kernels' order (fused_update.py
// _apply_sgd / _apply_adamw), with every scalar read from device memory so
// the launch needs no host sync:
//   s     = packed: float(((word >> j*bits) & mask) - nlim); dense: float(lane)
//   g_agg = s * inv_nalpha            (+ h, emitted as h' when kShift: the
//                                      new IntDIANA global shift, pre-clip)
//   SGD    [inv_nalpha, clip, lr, mu, wd]:
//     g = clip * g_agg + wd * p;  m' = mu * m + g;  p' = p - lr * m'
//   AdamW  [inv_nalpha, clip, lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2]:
//     g = clip * g_agg;  m' = b1 * m + omb1 * g;  v' = b2 * v + (omb2 * g) * g
//     step = (m' / bc1) / (sqrtf(v' / bc2) + eps);  p' = p - lr * (step + wd*p)
// Outputs go to fresh tensors: the step needs the old params afterwards for
// the alpha rule's ||x' - x||^2.
//
// The param is float32 or bf16 (the JAX step's default param_dtype); the
// bf16 variants (the _bf16 entry points) read p as bf16, widen it exactly,
// run the same float32 arithmetic and round p' to bf16, nearest even. The
// state and the shift stay float32. The JAX wrappers cast a bf16 param to
// float32 before their kernel and back after it; reading it here saves two
// passes over the leaf.
//
// Build with --fmad=false and nvcc's default -prec-div=true -prec-sqrt=true
// (no --use_fast_math, no rsqrtf or __fdividef): every product is rounded
// before its sum and every division and square root is IEEE-rounded, as the
// plain PyTorch version (one elementwise op per line above) rounds them, so
// the two agree bit for bit on the card.
//
// Bound on the card: memory. Bytes per element, each input read once and
// each output written once (k = 4 for packed8; a bf16 param saves 4):
//   packed SGD 4/k + 16 (+ 8 shift)    dense SGD lane + 16 (+ 8 shift)
//   packed AdamW 4/k + 24 (+ 8 shift)  dense AdamW lane + 24 (+ 8 shift)
// At the slice's largest leaf (234,881,024 elements, 3.35 TB/s) that is
// 1.19 ms (packed8 SGD; 0.91 with a bf16 param), 1.75 ms (packed8 AdamW,
// or with shift the SGD body; 1.47 bf16), 2.31 ms (AdamW with shift). Compute is far below: about 15 f32
// operations per element plus one sqrt and two divisions for AdamW.
// Design: a simple grid-stride loop, one thread per word (packed) or per
// lane (dense); for each field the threads of a warp touch consecutive
// elements, so every access coalesces. Loads are scalar, so a bf16 param
// needs no alignment beyond its own 2 bytes. Making it faster is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// The tensors of one launch. P is the param's type (float or
// __nv_bfloat16); state, shift and scalars are float32 whatever P is. State
// slot 1 is unused by SGD; h and h_out are null unless the launch carries
// an IntDIANA shift.
template <typename P>
struct Args {
  const P* p;
  const float* s0;  // SGD: momentum; AdamW: mu
  const float* s1;  // AdamW: nu
  const float* h;
  const float* scalars;
  P* p_out;
  float* s0_out;
  float* s1_out;
  float* h_out;
};

// A bf16 param is widened exactly and its new value rounded to nearest
// even (cvt.rn.bf16.f32, what torch's .to(torch.bfloat16) runs on the card;
// a NaN comes out as that instruction's NaN, compared as NaN, not by bits).
__device__ __forceinline__ float load_p(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_p(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_p(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_p(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

struct SgdBody {
  float inv_nalpha, clip, lr, mu, wd;
  __device__ explicit SgdBody(const float* sc)
      : inv_nalpha(sc[0]), clip(sc[1]), lr(sc[2]), mu(sc[3]), wd(sc[4]) {}
  template <typename P>
  __device__ void operator()(const Args<P>& a, int64_t i, float g_agg) const {
    const float pv = load_p(a.p, i);
    const float g = clip * g_agg + wd * pv;
    const float m_new = mu * a.s0[i] + g;
    store_p(a.p_out, i, pv - lr * m_new);
    a.s0_out[i] = m_new;
  }
};

struct AdamwBody {
  float inv_nalpha, clip, lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2;
  __device__ explicit AdamwBody(const float* sc)
      : inv_nalpha(sc[0]), clip(sc[1]), lr(sc[2]), b1(sc[3]), omb1(sc[4]),
        b2(sc[5]), omb2(sc[6]), eps(sc[7]), wd(sc[8]), bc1(sc[9]),
        bc2(sc[10]) {}
  template <typename P>
  __device__ void operator()(const Args<P>& a, int64_t i, float g_agg) const {
    const float pv = load_p(a.p, i);
    const float g = clip * g_agg;
    const float m_new = b1 * a.s0[i] + omb1 * g;
    const float v_new = b2 * a.s1[i] + (omb2 * g) * g;
    const float step = (m_new / bc1) / (sqrtf(v_new / bc2) + eps);
    store_p(a.p_out, i, pv - lr * (step + wd * pv));
    a.s0_out[i] = m_new;
    a.s1_out[i] = v_new;
  }
};

template <class Body, bool kShift, typename P>
__device__ __forceinline__ void update(const Args<P>& a, const Body& body,
                                       int64_t i, float s) {
  float g_agg = s * body.inv_nalpha;
  if constexpr (kShift) {
    g_agg = g_agg + a.h[i];
    a.h_out[i] = g_agg;
  }
  body(a, i, g_agg);
}

template <class Body, bool kShift, typename P>
__global__ void fused_unpack_kernel(const int32_t* __restrict__ words, Args<P> a,
                                    int64_t d, int64_t m, int k, int bits,
                                    int32_t nlim) {
  const Body body(a.scalars);
  const uint32_t mask = (1u << bits) - 1u;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       w < m; w += stride) {
    const uint32_t word = static_cast<uint32_t>(words[w]);
    for (int j = 0; j < k; ++j) {
      const int64_t idx = static_cast<int64_t>(j) * m + w;
      if (idx >= d) break;  // fields past the image end only at the tail
      const int32_t field = static_cast<int32_t>((word >> (j * bits)) & mask);
      update<Body, kShift, P>(a, body, idx, static_cast<float>(field - nlim));
    }
  }
}

template <class Body, bool kShift, typename Lane, typename P>
__global__ void fused_apply_kernel(const Lane* __restrict__ ints, Args<P> a,
                                   int64_t d) {
  const Body body(a.scalars);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < d; i += stride) {
    update<Body, kShift, P>(a, body, i,
                         static_cast<float>(static_cast<int32_t>(ints[i])));
  }
}

constexpr int kThreads = 256;

unsigned blocks_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return static_cast<unsigned>(blocks);
}

template <class Body, typename P>
int launch_unpack(const int32_t* words, const Args<P>& a, int64_t d, int64_t m,
                  int32_t k, int32_t bits, int32_t nlim, cudaStream_t stream) {
  if (m <= 0) return 0;
  if (a.h != nullptr) {
    fused_unpack_kernel<Body, true, P><<<blocks_for(m), kThreads, 0, stream>>>(
        words, a, d, m, k, bits, nlim);
  } else {
    fused_unpack_kernel<Body, false, P><<<blocks_for(m), kThreads, 0, stream>>>(
        words, a, d, m, k, bits, nlim);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Body, typename Lane, typename P>
void launch_apply_lane(const void* ints, const Args<P>& a, int64_t d,
                       cudaStream_t stream) {
  const Lane* lanes = static_cast<const Lane*>(ints);
  if (a.h != nullptr) {
    fused_apply_kernel<Body, true, Lane, P>
        <<<blocks_for(d), kThreads, 0, stream>>>(lanes, a, d);
  } else {
    fused_apply_kernel<Body, false, Lane, P>
        <<<blocks_for(d), kThreads, 0, stream>>>(lanes, a, d);
  }
}

template <class Body, typename P>
int launch_apply(const void* ints, int32_t lane_bytes, const Args<P>& a,
                 int64_t d, cudaStream_t stream) {
  if (d <= 0) return 0;
  switch (lane_bytes) {
    case 1: launch_apply_lane<Body, int8_t, P>(ints, a, d, stream); break;
    case 2: launch_apply_lane<Body, int16_t, P>(ints, a, d, stream); break;
    case 4: launch_apply_lane<Body, int32_t, P>(ints, a, d, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The four entry points, each for a float32 and a bf16 param.
template <typename P>
int unpack_sgd(const int32_t* words, const P* p, const float* mom,
               const float* h, const float* scalars, P* p_out, float* m_out,
               float* h_out, int64_t d, int64_t m, int32_t k, int32_t bits,
               int32_t nlim, cudaStream_t stream) {
  const Args<P> a{p, mom, nullptr, h, scalars, p_out, m_out, nullptr, h_out};
  return launch_unpack<SgdBody>(words, a, d, m, k, bits, nlim, stream);
}

template <typename P>
int unpack_adamw(const int32_t* words, const P* p, const float* mu,
                 const float* nu, const float* h, const float* scalars,
                 P* p_out, float* mu_out, float* nu_out, float* h_out,
                 int64_t d, int64_t m, int32_t k, int32_t bits, int32_t nlim,
                 cudaStream_t stream) {
  const Args<P> a{p, mu, nu, h, scalars, p_out, mu_out, nu_out, h_out};
  return launch_unpack<AdamwBody>(words, a, d, m, k, bits, nlim, stream);
}

template <typename P>
int apply_sgd(const void* ints, int32_t lane_bytes, const P* p,
              const float* mom, const float* h, const float* scalars, P* p_out,
              float* m_out, float* h_out, int64_t d, cudaStream_t stream) {
  const Args<P> a{p, mom, nullptr, h, scalars, p_out, m_out, nullptr, h_out};
  return launch_apply<SgdBody>(ints, lane_bytes, a, d, stream);
}

template <typename P>
int apply_adamw(const void* ints, int32_t lane_bytes, const P* p,
                const float* mu, const float* nu, const float* h,
                const float* scalars, P* p_out, float* mu_out, float* nu_out,
                float* h_out, int64_t d, cudaStream_t stream) {
  const Args<P> a{p, mu, nu, h, scalars, p_out, mu_out, nu_out, h_out};
  return launch_apply<AdamwBody>(ints, lane_bytes, a, d, stream);
}

}  // namespace

// Packed words, SGD body. h / h_out: null, or the IntDIANA shift and its
// fresh output. The _bf16 entry points take and write a bf16 param.
extern "C" int repro_fused_unpack_sgd(const int32_t* words, const float* p,
                                      const float* mom, const float* h,
                                      const float* scalars, float* p_out,
                                      float* m_out, float* h_out, int64_t d,
                                      int64_t m, int32_t k, int32_t bits,
                                      int32_t nlim, cudaStream_t stream) {
  return unpack_sgd(words, p, mom, h, scalars, p_out, m_out, h_out, d, m, k,
                    bits, nlim, stream);
}

extern "C" int repro_fused_unpack_sgd_bf16(
    const int32_t* words, const __nv_bfloat16* p, const float* mom,
    const float* h, const float* scalars, __nv_bfloat16* p_out, float* m_out,
    float* h_out, int64_t d, int64_t m, int32_t k, int32_t bits, int32_t nlim,
    cudaStream_t stream) {
  return unpack_sgd(words, p, mom, h, scalars, p_out, m_out, h_out, d, m, k,
                    bits, nlim, stream);
}

// Packed words, AdamW body.
extern "C" int repro_fused_unpack_adamw(
    const int32_t* words, const float* p, const float* mu, const float* nu,
    const float* h, const float* scalars, float* p_out, float* mu_out,
    float* nu_out, float* h_out, int64_t d, int64_t m, int32_t k, int32_t bits,
    int32_t nlim, cudaStream_t stream) {
  return unpack_adamw(words, p, mu, nu, h, scalars, p_out, mu_out, nu_out,
                      h_out, d, m, k, bits, nlim, stream);
}

extern "C" int repro_fused_unpack_adamw_bf16(
    const int32_t* words, const __nv_bfloat16* p, const float* mu,
    const float* nu, const float* h, const float* scalars,
    __nv_bfloat16* p_out, float* mu_out, float* nu_out, float* h_out,
    int64_t d, int64_t m, int32_t k, int32_t bits, int32_t nlim,
    cudaStream_t stream) {
  return unpack_adamw(words, p, mu, nu, h, scalars, p_out, mu_out, nu_out,
                      h_out, d, m, k, bits, nlim, stream);
}

// Dense lanes of lane_bytes (1: int8, 2: int16, 4: int32), SGD body.
extern "C" int repro_fused_apply_sgd(const void* ints, int32_t lane_bytes,
                                     const float* p, const float* mom,
                                     const float* h, const float* scalars,
                                     float* p_out, float* m_out, float* h_out,
                                     int64_t d, cudaStream_t stream) {
  return apply_sgd(ints, lane_bytes, p, mom, h, scalars, p_out, m_out, h_out,
                   d, stream);
}

extern "C" int repro_fused_apply_sgd_bf16(
    const void* ints, int32_t lane_bytes, const __nv_bfloat16* p,
    const float* mom, const float* h, const float* scalars,
    __nv_bfloat16* p_out, float* m_out, float* h_out, int64_t d,
    cudaStream_t stream) {
  return apply_sgd(ints, lane_bytes, p, mom, h, scalars, p_out, m_out, h_out,
                   d, stream);
}

// Dense lanes, AdamW body.
extern "C" int repro_fused_apply_adamw(const void* ints, int32_t lane_bytes,
                                       const float* p, const float* mu,
                                       const float* nu, const float* h,
                                       const float* scalars, float* p_out,
                                       float* mu_out, float* nu_out,
                                       float* h_out, int64_t d,
                                       cudaStream_t stream) {
  return apply_adamw(ints, lane_bytes, p, mu, nu, h, scalars, p_out, mu_out,
                     nu_out, h_out, d, stream);
}

extern "C" int repro_fused_apply_adamw_bf16(
    const void* ints, int32_t lane_bytes, const __nv_bfloat16* p,
    const float* mu, const float* nu, const float* h, const float* scalars,
    __nv_bfloat16* p_out, float* mu_out, float* nu_out, float* h_out,
    int64_t d, cudaStream_t stream) {
  return apply_adamw(ints, lane_bytes, p, mu, nu, h, scalars, p_out, mu_out,
                     nu_out, h_out, d, stream);
}
