// Sum of squares of each of `nblocks` contiguous chunks of a flat tensor,
// float32 or int32 in, float32 out: the per-leaf ||x_l||^2 of blockwise
// alpha (Alg. 2 / Prop. 4), of the model update ||dx_l||^2 and of the clip
// factor's summed integer image.
//
// Replaces the TPU kernel src/repro/kernels/block_norms.py::block_norms_2d
// (Pallas body `_kernel`). The Pallas kernel walks the tiles of a block in
// order and carries the block's sum in its output across grid steps, which
// the TPU's sequential grid makes well defined. Hopper CTAs run concurrently
// and in no order, so this is a two-stage reduction with no atomics:
//
//   stage 1 (block_norms_partial): grid (ctas, nblocks). CTA c of chunk b
//     reads its grid-stride groups of four consecutive elements (one 16-byte
//     load where the base is 16-byte aligned, four scalar loads otherwise:
//     the same elements in the same order either way), casts each element
//     to float32 in registers (int32 rounds to nearest, as XLA's and
//     PyTorch's casts do), squares it in float32 as the TPU kernel does with
//     `x * x`, and adds the square to a float64 running sum. Warp shuffles,
//     then shared memory, reduce the CTA's sums in a fixed tree; thread 0
//     writes one float64 partial.
//   stage 2 (block_norms_finish): one warp per chunk sums its `ctas`
//     partials in a fixed order and rounds to float32 once.
//
// The chunk length and the CTA count depend only on (numel, nblocks) (the
// wrapper computes both), never on timing or on the card, and no float
// atomic is used: the result is bit-identical from run to run. float64
// accumulation keeps a per-thread sum of about 900 terms at the largest leaf
// exact to float32 rounding; it costs nothing on a pass bound by reading x.
//
// Chunk b covers flat elements [b*chunk, (b+1)*chunk); elements past the end
// of the tensor count as zero, as the JAX wrapper's zero padding does.
//
// Bound on the card: memory. 4 bytes read per element, 2 operations (square,
// add); the float32 output is nblocks values.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCtas = 1024;

template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<int32_t> {
  using type = int4;
};

// square in float32, widen the square to float64
__device__ __forceinline__ double sq(float v) {
  return static_cast<double>(v * v);
}

__device__ __forceinline__ double warp_sum(double s) {
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

template <typename T, bool kAligned>
__global__ void block_norms_partial(const T* __restrict__ x,
                                    double* __restrict__ partial, int64_t numel,
                                    int64_t chunk) {
  const int64_t lo = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t hi = lo + chunk < numel ? lo + chunk : numel;
  const int64_t n = hi > lo ? hi - lo : 0;
  const T* base = x + lo;
  const int64_t groups = n / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  double acc = 0.0;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < groups; g += stride) {
    float a, b, c, d;
    if (kAligned) {
      const typename Vec4<T>::type v =
          reinterpret_cast<const typename Vec4<T>::type*>(base)[g];
      a = static_cast<float>(v.x);
      b = static_cast<float>(v.y);
      c = static_cast<float>(v.z);
      d = static_cast<float>(v.w);
    } else {
      a = static_cast<float>(base[4 * g]);
      b = static_cast<float>(base[4 * g + 1]);
      c = static_cast<float>(base[4 * g + 2]);
      d = static_cast<float>(base[4 * g + 3]);
    }
    acc += sq(a);
    acc += sq(b);
    acc += sq(c);
    acc += sq(d);
  }
  // the chunk's last n % 4 elements: CTA 0, one thread each
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * groups) {
    acc += sq(static_cast<float>(base[4 * groups + threadIdx.x]));
  }
  acc = warp_sum(acc);
  __shared__ double warp_sums[kWarps];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
    partial[static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x] = s;
  }
}

__global__ void block_norms_finish(const double* __restrict__ partial,
                                   float* __restrict__ out, int ctas) {
  const double* p = partial + static_cast<int64_t>(blockIdx.x) * ctas;
  double s = 0.0;
  for (int c = threadIdx.x; c < ctas; c += 32) s += p[c];
  s = warp_sum(s);
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<float>(s);
}

template <typename T>
void launch_partial(const void* x, double* scratch, int64_t numel,
                    int64_t chunk, dim3 grid, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 && chunk % 4 == 0) {
    block_norms_partial<T, true><<<grid, kThreads, 0, stream>>>(xt, scratch, numel, chunk);
  } else {
    block_norms_partial<T, false><<<grid, kThreads, 0, stream>>>(xt, scratch, numel, chunk);
  }
}

}  // namespace

// dtype: 0 float32, 1 int32. scratch holds nblocks * ctas doubles.
extern "C" int repro_block_norms(const void* x, int32_t dtype, float* out,
                                 double* scratch, int64_t numel, int64_t chunk,
                                 int32_t nblocks, int32_t ctas,
                                 cudaStream_t stream) {
  if (nblocks <= 0 || nblocks > 65535 || ctas <= 0 || ctas > kMaxCtas ||
      chunk < 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(nblocks));
  if (dtype == 0) {
    launch_partial<float>(x, scratch, numel, chunk, grid, stream);
  } else {
    launch_partial<int32_t>(x, scratch, numel, chunk, grid, stream);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  block_norms_finish<<<static_cast<unsigned>(nblocks), 32, 0, stream>>>(scratch, out, ctas);
  return static_cast<int>(cudaGetLastError());
}
