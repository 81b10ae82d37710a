// Sum of squares of each of `nblocks` contiguous chunks of a flat tensor,
// float32 or int32 in, float32 out: the per-leaf ||x_l||^2 of blockwise
// alpha (Alg. 2 / Prop. 4), of the model update ||dx_l||^2 and of the clip
// factor's summed integer image.
//
// Replaces the TPU kernel src/repro/kernels/block_norms.py::block_norms_2d
// (Pallas body `_kernel`). The Pallas kernel walks the tiles of a block in
// order and carries the block's sum in its output across grid steps, which
// the TPU's sequential grid makes well defined. Hopper CTAs run concurrently
// and in no order, so this is one launch of a grid (ctas, nblocks) that
// ends in a last-CTA ticket, with no float atomics:
//
//   CTA c of chunk b reads its grid-stride groups of four consecutive
//   elements, kUnroll groups at a time: all kUnroll loads are issued before
//   any is summed (one 16-byte load per group where the base is 16-byte
//   aligned, four scalar loads otherwise: the same elements in the same
//   order either way). Each element is cast to float32 in registers (int32
//   rounds to nearest, as XLA's and PyTorch's casts do) and squared in
//   float32 as the TPU kernel does with `x * x`; the group's four squares
//   are summed in float32 as (a² + b²) + (c² + d²), and the group's sum is
//   added to a float64 running sum, group by group in index order. Warp
//   shuffles, then shared memory, reduce the CTA's sums in a fixed tree,
//   and thread 0 writes the CTA's float64 partial.
//
//   The ticket: thread 0 then fences (__threadfence) and takes a ticket
//   with an integer atomicAdd on the chunk's counter, which is exact and
//   order-free. The CTA that draws the last ticket, whichever it is, sums
//   the chunk's `ctas` partials in index order through the same fixed
//   tree, rounds to float32 once, writes out[b] and sets the counter back
//   to 0. A chunk with one CTA writes out[b] directly.
//
// Invariant: every counter is 0 between launches. The wrapper allocates the
// 65,535 counters once per device, zeroed, and each launch leaves them as
// it found them, so no launch needs a memset. Two launches in flight at
// once on one device (two streams) would share them: the wrapper launches
// on the current stream only.
//
// The grid is a constant: kMaxCtas = 1,024 CTAs in all at the largest
// chunks, fewer where a chunk has fewer groups. __launch_bounds__(256, 8)
// holds the kernel to 32 registers, so 8 CTAs fit on an SM and all 1,024
// run in one wave on the H100's 132 SMs (at 40 registers only 6 fit, and
// 1,024 CTAs take 1.3 waves). 1,056 = 8 x 132, every SM equally loaded,
// measured slower in turns on the card, not faster. The wrapper computes the grid
// from (numel, nblocks) alone and never reads the SM count, so the
// summation order, and the result, is bit-identical from run to run and
// from card to card. float64 accumulation keeps a per-thread sum of about
// 220 group sums at the largest leaf exact to float32 rounding.
//
// Chunk b covers flat elements [b*chunk, (b+1)*chunk); elements past the end
// of the tensor count as zero, as the JAX wrapper's zero padding does.
//
// Bound on the card: memory. 4 bytes read per element, 2 operations (square,
// add); the float32 output is nblocks values. 256 threads and 8 CTAs per SM
// (__launch_bounds__) with kUnroll 16-byte loads each keep 8·256·16·kUnroll
// bytes in flight per SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
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

// four elements, cast to float32 and squared in float32, summed in a
// fixed float32 tree
struct Group {
  float a, b, c, d;
  __device__ __forceinline__ float sum_sq() const {
    return (a * a + b * b) + (c * c + d * d);
  }
};

template <typename T, bool kAligned>
__device__ __forceinline__ Group load_group(const T* __restrict__ base, int64_t g) {
  if (kAligned) {
    const typename Vec4<T>::type v =
        reinterpret_cast<const typename Vec4<T>::type*>(base)[g];
    return {static_cast<float>(v.x), static_cast<float>(v.y),
            static_cast<float>(v.z), static_cast<float>(v.w)};
  }
  return {static_cast<float>(base[4 * g]), static_cast<float>(base[4 * g + 1]),
          static_cast<float>(base[4 * g + 2]), static_cast<float>(base[4 * g + 3])};
}

__device__ __forceinline__ double warp_sum(double s) {
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

// the CTA's sum in a fixed tree: warp shuffles, then the warps in order;
// the result is valid in thread 0
__device__ __forceinline__ double cta_sum(double s, double* warp_sums) {
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) t += warp_sums[w];
  }
  return t;
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads, 8)
block_norms_kernel(const T* __restrict__ x, float* __restrict__ out,
                   double* __restrict__ partial, int32_t* __restrict__ counters,
                   int64_t numel, int64_t chunk) {
  __shared__ double warp_sums[kWarps];
  __shared__ bool last;
  const int b = blockIdx.y;
  const int64_t lo = static_cast<int64_t>(b) * chunk;
  const int64_t hi = lo + chunk < numel ? lo + chunk : numel;
  const int64_t n = hi > lo ? hi - lo : 0;
  const T* base = x + lo;
  const int64_t groups = n / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  double acc = 0.0;
  int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (; g + (kUnroll - 1) * stride < groups; g += kUnroll * stride) {
    Group v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load_group<T, kAligned>(base, g + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += static_cast<double>(v[u].sum_sq());
  }
  for (; g < groups; g += stride) {
    acc += static_cast<double>(load_group<T, kAligned>(base, g).sum_sq());
  }
  // the chunk's last n % 4 elements: CTA 0, one thread each
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * groups) {
    const float v = static_cast<float>(base[4 * groups + threadIdx.x]);
    acc += static_cast<double>(v * v);
  }
  const double s = cta_sum(acc, warp_sums);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) out[b] = static_cast<float>(s);
    return;
  }
  double* p = partial + static_cast<int64_t>(b) * gridDim.x;
  if (threadIdx.x == 0) {
    p[blockIdx.x] = s;
    __threadfence();  // the partial is visible device-wide before the ticket
    last = atomicAdd(counters + b, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();  // also: thread 0 is done reading warp_sums
  if (!last) return;
  __threadfence();
  double t = 0.0;
  for (int c = threadIdx.x; c < static_cast<int>(gridDim.x); c += kThreads) t += __ldcg(p + c);
  t = cta_sum(t, warp_sums);
  if (threadIdx.x == 0) {
    out[b] = static_cast<float>(t);
    counters[b] = 0;
  }
}

template <typename T>
void launch(const void* x, float* out, double* partial, int32_t* counters,
            int64_t numel, int64_t chunk, dim3 grid, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 && chunk % 4 == 0) {
    block_norms_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xt, out, partial, counters, numel, chunk);
  } else {
    block_norms_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xt, out, partial, counters, numel, chunk);
  }
}

}  // namespace

// dtype: 0 float32, 1 int32. partial holds nblocks * ctas doubles (unused
// when ctas is 1); counters holds at least nblocks int32 zeros and is left
// zero.
extern "C" int repro_block_norms(const void* x, int32_t dtype, float* out,
                                 double* partial, int32_t* counters,
                                 int64_t numel, int64_t chunk, int32_t nblocks,
                                 int32_t ctas, cudaStream_t stream) {
  if (nblocks <= 0 || nblocks > 65535 || ctas <= 0 || ctas > kMaxCtas ||
      chunk < 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(nblocks));
  if (dtype == 0) {
    launch<float>(x, out, partial, counters, numel, chunk, grid, stream);
  } else {
    launch<int32_t>(x, out, partial, counters, numel, chunk, grid, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
