// The lane interleave of the polyphase conv-transpose, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/ct_probe.py:
//   piper_interleave  <- mosaic_interleave (_int_kernel):
//                        out[b, ci, qi*r + ri] = y[b, ri, ci, qi],
// y (B, r, c, q) and out (B, c, q*r), float32, contiguous. The TPU kernel pads
// q to its 2048-lane tile and crops afterwards; here each block masks the
// ragged end of q itself, so nothing is padded or copied twice.
//
// What bounds it on the H100: it is a permutation, no arithmetic. Every input
// byte is read once and every output byte written once, 2*B*r*c*q*4 bytes at
// 3.35 TB/s. The only way to lose time is to read or write device memory in
// pieces smaller than a warp's 128-byte line, or to stall on shared memory.
//
// Design: one block per (q-tile, ci, b). The block reads the r input rows
// y[b, :, ci, q0:q0+kTQ] with consecutive threads on consecutive addresses
// (each row is contiguous in y), into shared memory laid out as [r][kTQ + pad].
// Then it writes the kTQ*r outputs out[b, ci, q0*r : (q0+kTQ)*r], which are
// contiguous in `out`, again one thread per consecutive address; output j
// reads shared memory at [j % r][j / r]. With pad = 32 / r for r dividing 32,
// the 32 lanes of a warp, which read r rows at 32/r consecutive columns, land
// on 32 distinct banks (a pad of 1 would put r = 8's warp on 11 banks, 2 or 3
// lanes each). For other r the pad is 1. r is a template parameter (1..8), so
// j % r and j / r are multiplications.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTQ = kThreads * kPerThread;  // q samples per block

template <int R>
__global__ void __launch_bounds__(kThreads) interleave_kernel(const float* __restrict__ y,
                                                             float* __restrict__ out, int c,
                                                             int q) {
  constexpr int S = kTQ + ((32 % R == 0) ? 32 / R : 1);  // the row stride, padded
  __shared__ float tile[R * S];
  const int q0 = blockIdx.x * kTQ;
  const int ci = blockIdx.y;
  const int b = blockIdx.z;
  const int n = min(kTQ, q - q0);  // valid columns of this tile
#pragma unroll
  for (int ri = 0; ri < R; ++ri) {
    const float* row = y + (((size_t)b * R + ri) * c + ci) * q + q0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int t = threadIdx.x + k * kThreads;
      if (t < n) tile[ri * S + t] = __ldg(row + t);
    }
  }
  __syncthreads();
  float* dst = out + ((size_t)b * c + ci) * ((size_t)q * R) + (size_t)q0 * R;
#pragma unroll
  for (int k = 0; k < R * kPerThread; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j < n * R) dst[j] = tile[(j % R) * S + j / R];
  }
}

template <int R>
int launch(const float* y, float* out, int B, int c, int q, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((q + kTQ - 1) / kTQ, c, B);
  interleave_kernel<R><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(y, out, c, q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (B, r, c, q) and out (B, c, q*r), float32, contiguous; 1 <= r <= 8,
// c and B at most 65535 (grid dimensions y and z). Returns a cudaError_t
// code (0 on success).
int piper_interleave(const float* y, float* out, int B, int r, int c, int q, int device,
                     void* stream) {
  if (B < 1 || c < 1 || q < 1 || B > 65535 || c > 65535) return (int)cudaErrorInvalidValue;
  switch (r) {
    case 1: return launch<1>(y, out, B, c, q, device, stream);
    case 2: return launch<2>(y, out, B, c, q, device, stream);
    case 3: return launch<3>(y, out, B, c, q, device, stream);
    case 4: return launch<4>(y, out, B, c, q, device, stream);
    case 5: return launch<5>(y, out, B, c, q, device, stream);
    case 6: return launch<6>(y, out, B, c, q, device, stream);
    case 7: return launch<7>(y, out, B, c, q, device, stream);
    case 8: return launch<8>(y, out, B, c, q, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
