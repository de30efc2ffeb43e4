// The K1 kernel and its launchers, shared by conv1d.cu ("high" and
// "default", and the C entry) and conv1d_highest.cu ("highest"), which nvcc
// compiles in parallel. conv1d.cu's header says what the kernel computes
// and how it is laid out; the stage's sizes, its weight images and its
// products are resblock1.cuh's (Wg) and wgmma.cuh's.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "resblock1.cuh"

namespace piper_k1 {

using piper::bf16;
using piper::load_f;
using piper_rb::Wg;

constexpr int kMaxThreads = 512;  // four warpgroups of 64 output lanes
constexpr int kMaxRing = 3;

struct Args {
  const void* x;       // (B, C, N), the kernel's TIO
  const void* w;       // the tier's B image of the (Cp, Cp, k) zero-padded weights
  const void* bias;    // (C,) TIO, or null
  const int* bounds;   // (B, bounds_cols) int32, or null with bounds_cols 0
  const void* residual;  // (B, C, N) TIO, or null
  void* out;           // (B, C, N), TIO
  int bounds_cols, B, C, N, k, dil, tile, ring, chunk;
  int warpgroups;      // the block's: ceil(tile / 64) of them run the products
  float slope;
};

// Row b's [lo, hi), clamped to [0, N]: bounds is (B, cols) int32, cols 2
// meaning [lo, hi), 1 meaning [0, hi), 0 (no bounds) meaning [0, N).
__device__ __forceinline__ void row_bounds(const Args& p, int b, int& lo, int& hi) {
  lo = p.bounds_cols == 2 ? p.bounds[2 * b] : 0;
  hi = p.bounds_cols > 0 ? p.bounds[b * p.bounds_cols + p.bounds_cols - 1] : p.N;
  lo = min(max(lo, 0), p.N);
  hi = min(max(hi, 0), p.N);
}

// The output stage's row stride in floats: at least the tile, and 4 past
// a multiple of 16, so that the D layout's stores (8 lanes by 4 channel
// pairs a warp) fall on 32 distinct banks.
__host__ __device__ constexpr int stage_stride(int tile) { return (tile + 11) / 16 * 16 + 4; }

// Shared bytes of the block (csrc/conv1d.cu's launch, ops/kernels/conv.py's
// smem_bytes): up to 1024 to align the ring, `depth` slots of `chunk` units
// (taps, or swizzle atoms of a tap: tap_units), their mbarriers, then the
// window's act(x) planes, W + 1 lanes a chunk plane, and a guard of 16
// bytes a lane for the rows of the last warpgroup past the tile, whose A
// reads run past the window; the fp32 output stage (C rows of
// stage_stride(tile)) goes over the planes once the products are done.
__host__ __device__ constexpr int smem_bytes(int cp, int c, int tier, int tile, int pad,
                                             int depth, int chunk) {
  const int elem = tier == 0 ? 4 : 2;
  const int planes = tier == 2 ? 1 : 2;
  const int rows = (tile + 63) / 64 * 64;
  const int act = planes * elem * cp * (tile + 2 * pad + 1) + 16 * (rows - tile);
  const int stage = 4 * c * stage_stride(tile);
  return 1024 +
         depth * piper_rb::ring_slot_bytes(chunk,
                                           piper_rb::tap_bytes(cp, tier) /
                                               piper_rb::tap_units(cp, tier)) +
         piper_rb::ring_barrier_bytes(depth) + (act > stage ? act : stage);
}

// One block per (tile of output samples, row) of `warpgroups` warpgroups:
// the first ceil(tile / 64) run the products, warpgroup w owning output
// lanes [64w, 64w + 64) on wgmma's M; every warp loads the window and
// stores the output (more warps than products keep more loads in flight
// where a level has few blocks). kC is C padded to a multiple of 16
// (wgmma's N and K), TIO the element type of x, the bias and the output
// (float, or bf16 at "default" only).
template <int kC, int kTier, typename TIO>
__global__ void __launch_bounds__(kMaxThreads) conv1d_same_kernel(const Args p) {
  static_assert(std::is_same_v<TIO, float> || kTier == 2,
                "bf16 activations run at \"default\" only");
  using G = Wg<kC, kTier>;
  using TA = typename G::TA;
  extern __shared__ __align__(16) unsigned char k1_smem[];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * p.tile;
  const int n_out = min(p.tile, p.N - t0);
  const int pad = (p.k - 1) / 2 * p.dil;
  const int W = p.tile + 2 * pad;  // window lane l is input sample t0 - pad + l
  const TIO* bias = static_cast<const TIO*>(p.bias);
  TIO* out = static_cast<TIO*>(p.out) + (size_t)b * p.C * p.N + t0;
  const TIO* res =
      p.residual ? static_cast<const TIO*>(p.residual) + (size_t)b * p.C * p.N + t0 : nullptr;
  int lo, hi;
  row_bounds(p, b, lo, hi);
  if (max(t0 - pad, lo) >= min(t0 + p.tile + pad, hi)) {
    // An all-zero window: the conv is the bias, and no product runs.
    for (int i = threadIdx.x; i < p.C * n_out; i += blockDim.x) {
      const int c = i / n_out;
      const size_t at = (size_t)c * p.N + (i - c * n_out);
      const float v = bias ? load_f(bias + c) : 0.f;
      piper::store_f(out + at, res ? load_f(res + at) + v : v);
    }
    return;
  }

  // Shared memory: the ring's slots from a 1024-byte boundary (the
  // swizzle is a function of the address bits), its barriers, the planes.
  const uint32_t raw = piper::smem_addr(k1_smem);
  const uint32_t align = (1024u - (raw & 1023u)) & 1023u;
  const int units = p.k * G::kUnits;
  const int total = (units + p.chunk - 1) / p.chunk;
  const int depth = min(p.ring, total);
  const int slot_bytes = piper_rb::ring_slot_bytes(p.chunk, G::kUnitBytes);
  const uint32_t slots = raw + align;
  const uint32_t full = slots + depth * slot_bytes;
  const uint32_t empty = full + 8 * depth;
  unsigned char* act_bytes =
      k1_smem + align + depth * slot_bytes + piper_rb::ring_barrier_bytes(depth);
  TA* planes = reinterpret_cast<TA*>(act_bytes);
  const int warps = blockDim.x >> 5;
  const int mma_warps = 4 * ((p.tile + 63) / 64);  // the warps that run products
  const char* w = static_cast<const char*>(p.w);
  // Chunk i of the conv's units into slot i % depth (thread 0 copies).
  auto issue = [&](int i) {
    const int u = i * p.chunk;
    const int n = min(p.chunk, units - u);
    piper::bulk_copy_if(threadIdx.x == 0, slots + (i % depth) * slot_bytes,
                        w + (size_t)u * G::kUnitBytes, n * G::kUnitBytes,
                        full + 8 * (i % depth));
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < depth; ++i) {
      piper::mbar_init(full + 8 * i, 1);
      piper::mbar_init(empty + 8 * i, mma_warps);
    }
    piper::mbar_init_fence();
  }
  __syncthreads();
  for (int i = 0; i < depth; ++i) issue(i);  // under the window's loads

  // act(x) over the window into the planes, split where it is written: a
  // warp walks 16 lanes at a time in the D layout (lane gid and gid + 8,
  // channels 2tig and 2tig + 1 of every 8), so each load instruction reads
  // 8 consecutive samples of 4 channels and each store fills 128 contiguous
  // bytes of a chunk plane. Channels from C to kC are zero; lanes past the
  // window store to lane W.
  const TIO* x = static_cast<const TIO*>(p.x) + (size_t)b * p.C * p.N;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int g0 = t0 - pad;
  for (int l0 = 16 * (threadIdx.x >> 5); l0 < W; l0 += 16 * warps) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int l = l0 + gid + 8 * rr;
      const int g = g0 + l;
      const bool in = l < W && g >= 0 && g < p.N;
      const int at = l < W ? l : W;
#pragma unroll
      for (int jj = 0; jj < kC / 8; ++jj) {
        const int c = 8 * jj + 2 * tig;
        const float v0 = in && c < p.C ? load_f(x + (size_t)c * p.N + g) : 0.f;
        const float v1 = in && c + 1 < p.C ? load_f(x + (size_t)(c + 1) * p.N + g) : 0.f;
        G::store2(planes, W + 1, at, c, piper_rb::act(v0, g, lo, hi, p.slope),
                  piper_rb::act(v1, g, lo, hi, p.slope));
      }
    }
  }
  piper::fence_async_shared();
  __syncthreads();

  // The products: per chunk of units, this warpgroup's over its taps and
  // their k-steps go out as one group; once the chunk before has
  // completed, its slot is released and, when all product warps have
  // released it, refilled. A of tap j: the 64 window lanes from this
  // warpgroup's first output lane + j*dil. D starts at the first product
  // (accumulate 0). Warpgroups past the tile's lanes skip to the epilogue.
  const int row0 = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0) * 64;
  const bool mma = row0 < p.tile;
  const uint32_t lbo = 16u * (W + 1);
  const uint32_t plane_bytes = (uint32_t)kC * (W + 1) * G::kElem;
  const uint32_t a0 = piper::smem_addr(planes) + (uint32_t)(row0 * 16);
  float d[G::kAcc];
  piper::fence_regs(d);
  for (int c = 0; mma && c < total; ++c) {
    const int u0 = c * p.chunk;
    const int u1 = min(u0 + p.chunk, units);
    const uint32_t slot = slots + (c % depth) * slot_bytes;
    piper::mbar_wait(full + 8 * (c % depth), (c / depth) & 1);
    piper::wgmma_fence();
    for (int u = u0; u < u1; ++u) {
      const int j = u / G::kUnits;  // the unit's tap, and its first k-step
      const int s0 = (u - j * G::kUnits) * G::kUnitSteps;
      const uint32_t tile = slot + (u - u0) * G::kUnitBytes;
      const uint32_t at = a0 + (uint32_t)(j * p.dil * 16);
#pragma unroll
      for (int s = 0; s < G::kUnitSteps; ++s) {
        const uint32_t ak = at + 2 * (s0 + s) * lbo;
        const uint64_t ahi = piper::a_desc(ak, lbo);
        const uint32_t wt = tile + G::b_offset(s);
        const uint64_t whi = piper::b_desc<G::kRowBytes>(wt);
        G::Mma::mma(d, ahi, whi, u > 0 || s > 0);  // v_hi w_hi (v_big w_big)
        if constexpr (G::kPlanes == 2) {
          G::Mma::mma(d, piper::a_desc(ak + plane_bytes, lbo), whi);  // v_lo w_hi
          G::Mma::mma(d, ahi, piper::b_desc<G::kRowBytes>(wt + G::kPlaneStride));  // v_hi w_lo
        }
      }
    }
    piper::wgmma_commit();
    piper::wgmma_wait<1>();
    if (c > 0) {
      const int i = c - 1;  // this warp no longer reads chunk i
      piper::mbar_arrive_if(lane == 0, empty + 8 * (i % depth));
      if (i + depth < total) {
        piper::mbar_wait(empty + 8 * (i % depth), (i / depth) & 1);
        issue(i + depth);
      }
    }
  }
  if (mma) piper::wgmma_wait<0>();
  piper::fence_regs(d);
  __syncthreads();  // every warpgroup's products have read the planes

  // The epilogue: the bias added, the raw sums through an fp32 stage over
  // the planes (C rows of stage_stride(tile)), then coalesced rows out,
  // rounded to TIO once; with a residual, the residual plus (conv + bias)
  // rounded to TIO, as PyTorch adds the conv's output to it. D's element
  // 4jj + 2rr + e is output lane row0 + 16 * warp + gid + 8rr, channel
  // 8jj + 2tig + e.
  float* stage = reinterpret_cast<float*>(act_bytes);
  const int ts = stage_stride(p.tile);
  const int row = row0 + 16 * ((threadIdx.x >> 5) & 3) + gid;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int o = row + 8 * rr;
    if (!mma || o >= n_out) continue;
#pragma unroll
    for (int jj = 0; jj < kC / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jj + 2 * tig + e;
        if (c < p.C) stage[c * ts + o] = d[4 * jj + 2 * rr + e] + (bias ? load_f(bias + c) : 0.f);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x >> 5; c < p.C; c += warps) {
    for (int l = lane; l < n_out; l += 32) {
      const size_t at = (size_t)c * p.N + l;
      const float v = stage[c * ts + l];
      piper::store_f(out + at, res ? load_f(res + at) + piper::round_as(out, v) : v);
    }
  }
}

template <int kC, int kTier, typename TIO>
int start(const Args& a, size_t smem, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(conv1d_same_kernel<kC, kTier, TIO>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.N + a.tile - 1) / a.tile, a.B);
  conv1d_same_kernel<kC, kTier, TIO>
      <<<grid, 128 * a.warpgroups, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The launch of a checked `a` at C padded to cp, a multiple of 16 up to 128.
template <int kTier, typename TIO>
int start_tier(const Args& a, int cp, size_t smem, int device, void* stream) {
  switch (cp) {
    case 16: return start<16, kTier, TIO>(a, smem, device, stream);
    case 32: return start<32, kTier, TIO>(a, smem, device, stream);
    case 48: return start<48, kTier, TIO>(a, smem, device, stream);
    case 64: return start<64, kTier, TIO>(a, smem, device, stream);
    case 80: return start<80, kTier, TIO>(a, smem, device, stream);
    case 96: return start<96, kTier, TIO>(a, smem, device, stream);
    case 112: return start<112, kTier, TIO>(a, smem, device, stream);
    default: return start<128, kTier, TIO>(a, smem, device, stream);
  }
}

// "highest" (conv1d_highest.cu).
int start_highest(const Args& a, int cp, size_t smem, int device, void* stream);

}  // namespace piper_k1
