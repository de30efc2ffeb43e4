// JAX's threefry-2x32 normals, for Hopper (sm_90a): piper_threefry_normal.
//
// Replaces no TPU kernel. The JAX package draws its seeded noise with
// jax.random (threefry-2x32 under jax_threefry_partitionable), which XLA
// lowers to fused integer code. The port computes the same numbers
// (ops/kernels/prng.py, whose docstring defines the draw and its three
// layouts); on the card it does so in this one kernel, because the plain
// PyTorch version is some 150 elementwise launches a draw and the port's
// B=1 path is bound by launches.
//
// out[r, c, w] (rows, n, W; W = 1 without frames) is element i of
// jax.random.normal(key), where
//   key = fold_in(fold_in(PRNGKey(seed), stream), frame)   (with frames)
//   key = fold_in(PRNGKey(seed), stream)                   (without)
//   seed, frame = seeds[r], frames[r * W + w]; i = c        (per_row)
//   seed, frame = seeds[0] or the host seed, frames[w]; i = r * n + c
//
// What bounds it on the H100: integer operations. An element's 32 bits are
// one threefry2x32 (20 rounds of add, rotate and xor, 5 key injections:
// ~80 32-bit operations) against 4 bytes stored: at the SMs' 64 INT32 lanes
// a clock, ~4.8 ps an element, against 1.2 ps for the store at 3.35 TB/s.
//
// Design: one thread per element, w fastest, so a warp stores 128
// contiguous bytes. Each thread derives its own key (one or two threefry2x32
// more than the least work, which would share a key across its elements:
// simple first), then its bits, uniform and normal. Rounding: the integer
// part is exact; the uniform's subtraction, scale and shift are __fsub_rn /
// __fmul_rn / __fadd_rn, so no contraction moves their last bit and the
// uniforms equal the plain version's bit for bit; the erf_inv's Horner steps
// are explicit fused multiply-adds (XLA's CPU code contracts them, and the
// plain version rounds each once too); log1pf and sqrtf are CUDA's (the
// library is built without --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) { return __funnelshift_l(v, v, r); }

// threefry2x32 of (x0, x1) under (k0, k1), in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// jax.random.fold_in: the key becomes threefry2x32(key, 0, data).
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1, uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// XLA's fp32 ErfInv (M. Giles' single-precision polynomial).
__device__ __forceinline__ float erf_inv(float x) {
  float w = -log1pf(__fmul_rn(-x, x));
  float p;
  if (w < 5.0f) {
    w = __fsub_rn(w, 2.5f);
    p = 2.81022636e-08f;
    p = __fmaf_rn(p, w, 3.43273939e-07f);
    p = __fmaf_rn(p, w, -3.5233877e-06f);
    p = __fmaf_rn(p, w, -4.39150654e-06f);
    p = __fmaf_rn(p, w, 0.00021858087f);
    p = __fmaf_rn(p, w, -0.00125372503f);
    p = __fmaf_rn(p, w, -0.00417768164f);
    p = __fmaf_rn(p, w, 0.246640727f);
    p = __fmaf_rn(p, w, 1.50140941f);
  } else {
    w = __fsub_rn(sqrtf(w), 3.0f);
    p = -0.000200214257f;
    p = __fmaf_rn(p, w, 0.000100950558f);
    p = __fmaf_rn(p, w, 0.00134934322f);
    p = __fmaf_rn(p, w, -0.00367342844f);
    p = __fmaf_rn(p, w, 0.00573950773f);
    p = __fmaf_rn(p, w, -0.0076224613f);
    p = __fmaf_rn(p, w, 0.00943887047f);
    p = __fmaf_rn(p, w, 1.00167406f);
    p = __fmaf_rn(p, w, 2.83297682f);
  }
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7f800000)) : __fmul_rn(p, x);
}

// kind: 0 the normal (float), 1 its uniform (float), 2 its bits (uint32).
__global__ void __launch_bounds__(kThreads) threefry_normal_kernel(
    void* __restrict__ out, int rows, int n, int width, const long long* __restrict__ seeds,
    uint32_t host_seed, int per_row, uint32_t stream, const long long* __restrict__ frames,
    int kind) {
  const int total = rows * n * width;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int w = e % width;
  const int c = (e / width) % n;
  const int r = e / (width * n);
  uint32_t k0 = 0u;
  uint32_t k1 = seeds ? static_cast<uint32_t>(seeds[per_row ? r : 0]) : host_seed;
  fold_in(k0, k1, stream);
  if (frames) fold_in(k0, k1, static_cast<uint32_t>(frames[per_row ? r * width + w : w]));
  const uint64_t i = per_row ? static_cast<uint64_t>(c)
                             : static_cast<uint64_t>(r) * static_cast<uint64_t>(n) + c;
  uint32_t x0 = static_cast<uint32_t>(i >> 32), x1 = static_cast<uint32_t>(i);
  threefry2x32(k0, k1, x0, x1);
  const uint32_t bits = x0 ^ x1;
  if (kind == 2) {
    static_cast<uint32_t*>(out)[e] = bits;
    return;
  }
  // jax.random.uniform(key, minval=nextafter(-1, 0), maxval=1) in fp32.
  const float lo = -0x1.fffffep-1f;  // nextafter(-1, 0)
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(f, __fsub_rn(1.0f, lo)), lo));
  static_cast<float*>(out)[e] = kind == 1 ? u : __fmul_rn(1.41421354f, erf_inv(u));
}

}  // namespace

extern "C" {

// out (rows, n, width): float32 for kind 0 (normals) and 1 (uniforms),
// uint32 for kind 2 (bits), contiguous. seeds: nullptr (the host seed) or
// int64 on the device, rows of them when per_row, else one; frames: nullptr
// (width must be 1) or int64 on the device, (rows, width) when per_row, else
// (width,). rows * n * width < 2^31. Returns a cudaError_t code (0 on
// success).
int piper_threefry_normal(void* out, int rows, int n, int width, const long long* seeds,
                          unsigned int host_seed, int per_row, unsigned int stream,
                          const long long* frames, int kind, int device, void* cuda_stream) {
  if (rows < 1 || n < 1 || width < 1 || kind < 0 || kind > 2 || (!frames && width != 1) ||
      (per_row && !seeds) ||
      static_cast<long long>(rows) * n * width >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int total = rows * n * width;
  const int blocks = (total + kThreads - 1) / kThreads;
  threefry_normal_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      out, rows, n, width, seeds, host_seed, per_row, stream, frames, kind);
  return (int)cudaGetLastError();
}

}  // extern "C"
