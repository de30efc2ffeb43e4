// Same-padded dilated conv1d with a fused leaky-ReLU input, for Hopper
// (sm_90a), fp32 on CUDA cores.
//
// Replaces the Pallas TPU kernel piper_tpu/ops/pallas/conv.py:
//   piper_conv1d_same  <- pallas_conv1d_same (_kernel):
//                         out = conv1d_same(act(x), w, b, dilation=d),
// act(v) = v >= 0 ? v : v * slope (slope 1 is the identity), odd k, square
// (C, C, k) weights, zero padding on both sides. No mask and no bounds: the
// caller passes x * mask and the output is not masked.
//
// What bounds it on the H100: the ResBlock2 convs of Piper's x_low voices
// are narrow (C = 32 or 64), short in taps (k = 3/5/7) and long in time.
// Per output sample a conv does C*k FMAs for each of C channels against 8
// bytes of traffic, so device memory is no limit. A level holds only
// C/8 * N/2 threads of 8 channels x 2 samples: a few warps per SM at
// Piper's lengths, so the time is one thread's chain of 16*C*k FMAs and
// the loads it waits on rather than the card's FMA rate.
//
// Design: one block per (time tile, row), one pass of the block over the
// tile. The block copies the tile's window [t0 - pad, t0 + tile + pad) of x
// (pad = (k-1)/2*d, zero outside [0, N)) and the weights, transposed to
// (C_in, K, C_out), into shared memory with cp.async, so that all of a
// thread's loads are in flight at once; then it applies act once per
// window sample. The tap loop reads only shared memory: per (input
// channel, tap) a thread reads 2 activations, each feeding 8 FMAs, and 8
// weights as two float4 loads (the same address across the warp), each
// feeding 2. The tap loop is unrolled for K = 3/5/7/11. Measured
// on the H100 at x_low's shapes: weights read through L1 instead of shared
// memory were 1.7-2.6x slower, and 4 samples per thread instead of 2 (half
// the warps) up to 1.5x slower below ~200 frames. Nothing in the halo is
// recomputed (K1 only loads it), so the tile trades the per-block staging
// of the weights against spreading the warps over the SMs; the wrapper
// picks it. No tensor cores: the products run at the tier of tiers.cuh on
// CUDA-core FMAs, split into bf16 parts in registers at the read.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "tiers.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kRCo = 8;  // output channels per thread
constexpr int kRT = 2;   // time samples per thread, strided by the row width

template <int K, int kTier>
__global__ void __launch_bounds__(kMaxThreads) conv1d_same_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, int C, int N, int k_rt,
    int dil, int tile, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int taps = K > 0 ? K : k_rt;
  const int pad = (taps - 1) / 2 * dil;
  const int W = tile + 2 * pad;
  float* wbuf = smem;                // (C_in, taps, C_out): the weights
  float* win = smem + C * taps * C;  // (C, W): act(x) over the tile's window
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int n_out = min(tile, N - t0);
  const float* xb = x + (size_t)b * C * N;

  for (int idx = threadIdx.x; idx < C * W; idx += blockDim.x) {
    const int c = idx / W;
    const int g = t0 - pad + (idx - c * W);
    const bool inside = g >= 0 && g < N;
    // Outside [0, N) the copy reads nothing and zero-fills its 4 bytes.
    __pipeline_memcpy_async(win + idx, inside ? xb + (size_t)c * N + g : xb, sizeof(float),
                            inside ? 0 : sizeof(float));
  }
  // 16-byte copies of the weights (C is a multiple of 8, w 16-byte aligned).
  for (int i = threadIdx.x; i < C * taps * C / 4; i += blockDim.x)
    __pipeline_memcpy_async(reinterpret_cast<float4*>(wbuf) + i,
                            reinterpret_cast<const float4*>(w) + i, sizeof(float4));
  __pipeline_commit();
  __pipeline_wait_prior(0);  // this thread's copies have landed
  if (slope != 1.f) {
    for (int idx = threadIdx.x; idx < C * W; idx += blockDim.x) {
      const float v = win[idx];
      win[idx] = v >= 0.f ? v : v * slope;
    }
  }
  __syncthreads();

  const int row_threads = blockDim.x / (C / kRCo);  // the block is whole groups
  const int cg = threadIdx.x / row_threads;
  const int tx = threadIdx.x - cg * row_threads;
  const int co0 = cg * kRCo;
  float acc[kRCo][kRT];
#pragma unroll
  for (int c = 0; c < kRCo; ++c) {
    const float bv = __ldg(bias + co0 + c);
#pragma unroll
    for (int i = 0; i < kRT; ++i) acc[c][i] = bv;
  }
  // Output lane l reads window lanes l + j*dil. Lanes past the tile's
  // output read a clamped (valid) lane; their sums are discarded below.
  int lane[kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i) lane[i] = min(tx + i * row_threads, n_out - 1);
  for (int ci = 0; ci < C; ++ci) {
    const float* row = win + ci * W;
    const float* wrow = wbuf + ci * taps * C + co0;
#pragma unroll
    for (int j = 0; j < taps; ++j) {
      float v[kRT];
#pragma unroll
      for (int i = 0; i < kRT; ++i) v[i] = row[lane[i] + j * dil];
      const float4 wa = *reinterpret_cast<const float4*>(wrow + j * C);
      const float4 wb = *reinterpret_cast<const float4*>(wrow + j * C + 4);
      const float wv[kRCo] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      piper::tier_fma<kTier>(wv, v, acc);
    }
  }
  float* ob = out + (size_t)b * C * N + t0;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int pos = tx + i * row_threads;
    if (pos >= n_out) continue;
#pragma unroll
    for (int c = 0; c < kRCo; ++c) ob[(size_t)(co0 + c) * N + pos] = acc[c][i];
  }
}

template <int K, int kTier>
int launch_tier(const float* x, const float* w, const float* bias, float* out, int B, int C,
                int N, int k, int dil, int tile, float slope, int device, void* stream) {
  const int threads = C / kRCo * ((tile + kRT - 1) / kRT);  // one pass over the tile
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)C * k * C + (size_t)C * (tile + (k - 1) * dil));
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(conv1d_same_kernel<K, kTier>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + tile - 1) / tile, B);
  conv1d_same_kernel<K, kTier><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, out, C, N, k, dil, tile, slope);
  return (int)cudaGetLastError();
}

template <int K>
int launch(const float* x, const float* w, const float* bias, float* out, int B, int C,
           int N, int k, int dil, int tile, float slope, int tier, int device, void* stream) {
  switch (tier) {
    case 0: return launch_tier<K, 0>(x, w, bias, out, B, C, N, k, dil, tile, slope, device, stream);
    case 1: return launch_tier<K, 1>(x, w, bias, out, B, C, N, k, dil, tile, slope, device, stream);
    case 2: return launch_tier<K, 2>(x, w, bias, out, B, C, N, k, dil, tile, slope, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x, out (B, C, N); w (C_in, K, C_out) contiguous and 16-byte aligned; bias
// (C,); tier 0/1/2 (tiers.cuh). Returns a cudaError_t code (0 on success).
int piper_conv1d_same(const float* x, const float* w, const float* bias, float* out,
                      int B, int C, int N, int k, int dil, int tile, float slope,
                      int tier, int device, void* stream) {
  if (C < kRCo || C % kRCo != 0 || k < 1 || k % 2 == 0 || dil < 1 || tile < 1 ||
      N < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  switch (k) {  // HiFi-GAN's kernel sizes get an unrolled tap loop
    case 3: return launch<3>(x, w, bias, out, B, C, N, k, dil, tile, slope, tier, device, stream);
    case 5: return launch<5>(x, w, bias, out, B, C, N, k, dil, tile, slope, tier, device, stream);
    case 7: return launch<7>(x, w, bias, out, B, C, N, k, dil, tile, slope, tier, device, stream);
    case 11: return launch<11>(x, w, bias, out, B, C, N, k, dil, tile, slope, tier, device, stream);
    default: return launch<0>(x, w, bias, out, B, C, N, k, dil, tile, slope, tier, device, stream);
  }
}

}  // extern "C"
