// Int(alpha * x) with the paper's section 5.1 clip, float32 or bf16 in,
// int32 out. A bf16 gradient (the bf16-param train step's) is read as is and
// widened exactly, so its image is bit-equal to the float32 kernel's on
// x.float(); the JAX package casts it to float32 outside its kernel.
//
// Replaces the TPU kernel src/repro/kernels/int_compress.py::int_compress_2d
// (Pallas body `_kernel`). The Pallas kernel tiles a padded (rows, cols)
// view and derives its PRNG counter from the tile coordinates; because the
// wrapper pads at the end, that counter equals the logical flat index, which
// is what this kernel uses directly (no padded copy).
//
// Arithmetic, element i (all of it float32, in this order):
//   scaled = x[i] * alpha
//   stochastic:     h = fmix32(uint32(i) * 0x9E3779B9 + uint32(seed))
//                   u = (h >> 8) * 2^-24
//                   r = floor(scaled) + (u < scaled - floor(scaled))
//   deterministic:  r = rint(scaled)            (half to even, as jnp.round)
//   r clipped to [-lim, lim] in float32, then converted with round-toward-zero
//   saturation (cvt.rzi.s32.f32: out of range saturates, NaN gives 0), which
//   is what XLA's f32 -> s32 convert does at the int32 edge (bits=32, n=1).
//
// With `amax` (a float32 scalar on the card, not null) the kernel also
// raises *amax to the image's largest |value|, as float32: the train step's
// max_local_int, which the JAX package takes in a pass of its own. Each
// thread keeps its running max, each warp reduces it, and lane 0 does one
// atomicMax on the float's bits (non-negative floats order as their bits),
// so the result does not depend on the order of the atomics.
//
// Build with --fmad=false: `x * alpha - floor(...)` must not contract into an
// FMA, or the stochastic threshold sees an unrounded product.
//
// Bound on the card: memory. 8 bytes per element (one f32 read, one int32
// write; 6 for a bf16 read) and about 20 integer/float operations per element; one H100 moves
// the bytes in far more time than it takes to do the operations. alpha and
// the seed are read from device memory, so the launch needs no host sync.
// Design: one thread per element in a grid-stride loop; neighbouring threads
// touch neighbouring addresses, so every load and store is coalesced.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void int_compress_kernel(const T* __restrict__ x,
                                    int32_t* __restrict__ out,
                                    const float* __restrict__ alpha,
                                    const int32_t* __restrict__ seed,
                                    int64_t n, float lim, int stochastic,
                                    float* __restrict__ amax) {
  const float a = *alpha;
  float peak = 0.0f;
  const uint32_t s = static_cast<uint32_t>(*seed);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float scaled = widen(x[i]) * a;
    float r;
    if (stochastic) {
      const uint32_t h = fmix32(static_cast<uint32_t>(i) * 0x9E3779B9u + s);
      const float u = static_cast<float>(h >> 8) * 5.9604644775390625e-08f;
      const float lo = floorf(scaled);
      r = lo + ((u < scaled - lo) ? 1.0f : 0.0f);
    } else {
      r = rintf(scaled);
    }
    // comparisons, not fminf/fmaxf: a NaN must survive the clip (and become
    // 0 in the conversion) exactly as jnp.clip lets it through
    r = r < -lim ? -lim : r;
    r = r > lim ? lim : r;
    const int32_t v = __float2int_rz(r);
    out[i] = v;
    peak = fmaxf(peak, fabsf(static_cast<float>(v)));
  }
  if (amax == nullptr) return;
  for (int off = 16; off > 0; off >>= 1) {
    peak = fmaxf(peak, __shfl_xor_sync(0xffffffffu, peak, off));
  }
  if ((threadIdx.x & 31) == 0 && peak > 0.0f) {
    atomicMax(reinterpret_cast<int*>(amax), __float_as_int(peak));
  }
}

template <typename T>
int launch(const T* x, int32_t* out, const float* alpha, const int32_t* seed,
           int64_t n, int32_t lim, int32_t stochastic, float* amax,
           cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  int_compress_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      x, out, alpha, seed, n, static_cast<float>(lim), stochastic, amax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// amax: null, or a float32 scalar on the card that the launch raises to
// the image's largest |value|.
extern "C" int repro_int_compress(const float* x, int32_t* out,
                                  const float* alpha, const int32_t* seed,
                                  int64_t n, int32_t lim, int32_t stochastic,
                                  float* amax, cudaStream_t stream) {
  return launch(x, out, alpha, seed, n, lim, stochastic, amax, stream);
}

extern "C" int repro_int_compress_bf16(const __nv_bfloat16* x, int32_t* out,
                                       const float* alpha, const int32_t* seed,
                                       int64_t n, int32_t lim,
                                       int32_t stochastic, float* amax,
                                       cudaStream_t stream) {
  return launch(x, out, alpha, seed, n, lim, stochastic, amax, stream);
}
