// K1's wide design: the same function as conv1d.cuh's conv1d_same_kernel
// (out = residual + conv1d_same(act(x), w, b, dilation=d)) for square C
// from 128 up to 256, fp32 activations, at "highest" (3xTF32) and "high"
// (bf16x3), on warpgroup products (wgmma). conv1d_wide.cu's header says
// what bounds it on the H100 and how this design answers it; the C entry
// and the "high" instantiation are there, "highest" in
// conv1d_wide_highest.cu.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "conv1d.cuh"

namespace piper_k1w {

constexpr int kNT = 128;           // output channels a block: wgmma's N
constexpr int kChunkBytes = 64;    // bytes of K a chunk: of a window lane, of a weight row
constexpr int kPlanes = 2;         // hi and lo ("high"), big and small ("highest")
constexpr int kUnitBytes = kPlanes * kNT * kChunkBytes;  // one (chunk, tap) of weights: 16 KB
constexpr int kMaxThreads = 512;   // four warpgroups of 64 output lanes
constexpr int kMaxRing = 4;

struct Args {
  const float* x;         // (B, C, N)
  const void* w;          // the tier's wide image (ops/kernels/conv.py::wide_image)
  const float* bias;      // (C,), or null
  const int* bounds;      // (B, bounds_cols) int32, or null with bounds_cols 0
  const float* residual;  // (B, C, N), or null
  float* out;             // (B, C, N)
  int bounds_cols, B, C, cp, N, k, dil, tile, ring;
  float slope;
};

// The tier's sizes: the planes' element, the input channels of a 64-byte
// chunk (16 tf32 or 32 bf16), the product, and the window's stores, which
// are K2-K4's stage's at a width of one chunk.
template <int kTier>
struct Tier {
  static_assert(kTier == 0 || kTier == 1, "the wide design runs \"highest\" and \"high\"");
  using TA = std::conditional_t<kTier == 0, float, piper::bf16>;
  static constexpr int kElem = sizeof(TA);
  static constexpr int kKC = kChunkBytes / kElem;
  static constexpr int kGroups = kKC / 8;  // the staging's 8-channel groups a chunk
  using Mma = std::conditional_t<kTier == 0, piper::WgmmaTf32<kNT>, piper::Wgmma<kNT>>;
  using Window = piper_rb::Wg<kKC, kTier>;
};

// Bytes of one window buffer: both planes of one chunk, W + 1 lanes (lane
// W takes the stores of lanes past the window).
__host__ __device__ constexpr int window_bytes(int tile, int pad) {
  return kPlanes * kChunkBytes * (tile + 2 * pad + 1);
}

// Bytes of one raw buffer: a chunk's fp32 rows, kKC channels (16 at tier 0,
// 32 at tier 1) of stage_stride(W) floats.
__host__ __device__ constexpr int raw_bytes(int tile, int pad, int tier) {
  return 4 * (tier == 0 ? 16 : 32) * piper_k1::stage_stride(tile + 2 * pad);
}

// The block's shared memory (ops/kernels/conv.py::wide_smem_bytes): up to
// 1024 bytes to align the ring; the ring's slots, two window buffers and
// two raw buffers, or the fp32 output stage over them (kNT rows of
// stage_stride(tile)), whichever is larger, rounded to 128; then the
// ring's mbarriers.
__host__ __device__ constexpr int body_bytes(int tile, int pad, int ring, int tier) {
  const int body =
      ring * kUnitBytes + 2 * window_bytes(tile, pad) + 2 * raw_bytes(tile, pad, tier);
  const int stage = 4 * kNT * piper_k1::stage_stride(tile);
  return ((body > stage ? body : stage) + 127) / 128 * 128;
}
__host__ __device__ constexpr int smem_bytes(int tile, int pad, int ring, int tier) {
  return 1024 + body_bytes(tile, pad, ring, tier) + piper_rb::ring_barrier_bytes(ring);
}

// One block per (128 output channels, tile of output samples, row), of
// tile / 64 warpgroups, each owning 64 output lanes on wgmma's M. The input
// channels run in chunks of 64 bytes a plane; the image holds, per block of
// output channels, a unit per (chunk, tap): both planes of its 128 rows of
// 64 bytes, 64-byte swizzled, 16 KB, bulk-copied through the ring in that
// order. Chunk q + 1 of the window is written (act, masked by the row's
// bounds, split into the tier's planes) into one buffer, a k-th of it after
// each of chunk q's taps is issued, while the products read the other; its
// raw rows were copied two chunks ahead.
template <int kTier>
__global__ void __launch_bounds__(kMaxThreads, 1) conv1d_same_wide_kernel(const Args p) {
  using T = Tier<kTier>;
  using TA = typename T::TA;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int n0 = blockIdx.x * kNT;
  const int t0 = blockIdx.y * p.tile;
  const int b = blockIdx.z;
  const int n_out = min(p.tile, p.N - t0);
  const int c_end = min(n0 + kNT, p.C);
  const int pad = (p.k - 1) / 2 * p.dil;
  const int W = p.tile + 2 * pad;  // window lane l is input sample t0 - pad + l
  const size_t row = (size_t)b * p.C * p.N;
  float* out = p.out + row + t0;
  const float* res = p.residual ? p.residual + row + t0 : nullptr;
  int lo = p.bounds_cols == 2 ? p.bounds[2 * b] : 0;
  int hi = p.bounds_cols > 0 ? p.bounds[b * p.bounds_cols + p.bounds_cols - 1] : p.N;
  lo = min(max(lo, 0), p.N);
  hi = min(max(hi, 0), p.N);
  if (max(t0 - pad, lo) >= min(t0 + p.tile + pad, hi)) {
    // An all-zero window: the conv is the bias, and no product runs.
    for (int i = threadIdx.x; i < (c_end - n0) * n_out; i += blockDim.x) {
      const int c = n0 + i / n_out;
      const size_t at = (size_t)c * p.N + i % n_out;
      const float v = p.bias ? __ldg(p.bias + c) : 0.f;
      out[at] = res ? __ldg(res + at) + v : v;
    }
    return;
  }

  // Shared memory: the ring's slots from a 1024-byte boundary, the two
  // window buffers and the two raw buffers after them (the output stage
  // goes over all), the barriers last.
  const uint32_t raw = piper::smem_addr(wide_smem);
  const uint32_t align = (1024u - (raw & 1023u)) & 1023u;
  const int chunks = p.cp / T::kKC;
  const int total = chunks * p.k;  // units
  const int depth = min(p.ring, total);
  const uint32_t slots = raw + align;
  const uint32_t full = slots + body_bytes(p.tile, pad, depth, kTier);
  const uint32_t empty = full + 8 * depth;
  unsigned char* windows = wide_smem + align + depth * kUnitBytes;
  const int win_bytes = window_bytes(p.tile, pad);
  const int warps = blockDim.x >> 5;  // every warp runs products
  const char* w = static_cast<const char*>(p.w) + (size_t)blockIdx.x * total * kUnitBytes;
  auto issue = [&](int i) {
    piper::bulk_copy_if(threadIdx.x == 0, slots + (i % depth) * kUnitBytes,
                        w + (size_t)i * kUnitBytes, kUnitBytes, full + 8 * (i % depth));
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < depth; ++i) {
      piper::mbar_init(full + 8 * i, 1);
      piper::mbar_init(empty + 8 * i, warps);
    }
    piper::mbar_init_fence();
  }
  __syncthreads();
  for (int i = 0; i < depth; ++i) issue(i);  // under the first chunks' copies

  // The window's chunks: chunk q's raw fp32 rows (kKC channels of lanes
  // [0, W), rows rs floats apart) are copied by cp.async, each thread's
  // copies one group, into raw buffer q % 2 two chunks ahead of their use
  // (zeros for channels past C and samples outside the input); then
  // converted, items [i0, i1) at a time, into window buffer q % 2: act,
  // masked by the row's bounds, split into the tier's planes. An item is 16
  // lanes by 8 channels, a warp's in the D layout (lanes gid and gid + 8,
  // channels 2tig and 2tig + 1), so each store fills 128 contiguous bytes
  // of a chunk plane, and rs (4 past a multiple of 16) keeps its reads of
  // four channels' rows on distinct banks.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int items = (W + 15) / 16 * T::kGroups;
  const int rs = piper_k1::stage_stride(W);
  float* raws = reinterpret_cast<float*>(windows + 2 * win_bytes);
  const float* x = p.x + row;
  const int g0 = t0 - pad;
  auto fetch = [&](int q) {
    if (q < chunks) {
      const uint32_t dst = piper::smem_addr(raws + (q & 1) * T::kKC * rs);
      for (int c = warp; c < T::kKC; c += warps) {
        const int ch = q * T::kKC + c;
        for (int l = lane; l < W; l += 32) {
          const int g = g0 + l;
          const bool in = ch < p.C && g >= 0 && g < p.N;
          piper::cp_async4(dst + 4 * (c * rs + l), in ? x + (size_t)ch * p.N + g : x, in ? 4 : 0);
        }
      }
    }
    piper::cp_async_commit();
  };
  auto convert = [&](int q, int i0, int i1) {
    const float* raw = raws + (q & 1) * T::kKC * rs;
    TA* planes = reinterpret_cast<TA*>(windows + (q & 1) * win_bytes);
    for (int it = i0 + warp; it < i1; it += warps) {
      const int cc = 8 * (it % T::kGroups) + 2 * tig;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int l = 16 * (it / T::kGroups) + gid + 8 * rr;
        const int g = g0 + l;
        const float v0 = l < W ? raw[cc * rs + l] : 0.f;
        const float v1 = l < W ? raw[(cc + 1) * rs + l] : 0.f;
        T::Window::store2(planes, W + 1, l < W ? l : W, cc,
                          piper_rb::act(v0, g, lo, hi, p.slope),
                          piper_rb::act(v1, g, lo, hi, p.slope));
      }
    }
  };
  // Chunk q + 1 is converted in k slices, slice j after chunk q's tap j.
  auto slice = [&](int j) { return items * j / p.k; };
  fetch(0);
  fetch(1);
  piper::cp_async_wait<1>();
  __syncthreads();
  convert(0, 0, items);
  piper::fence_async_shared();
  __syncthreads();
  fetch(2);

  // The products: per unit (chunk q, tap j), this warpgroup's two k-steps
  // of three products go out as one group. A of tap j: the 64 window lanes
  // from this warpgroup's first output lane + j*dil, a k-step two chunk
  // planes. Once the unit before has completed, its slot is released and,
  // when every warp has released it, refilled; then slice j of chunk q + 1
  // is converted (after tap 0, once every warpgroup is past chunk q - 1,
  // whose buffer it overwrites). D starts at the first product (accumulate
  // 0), and the sums run in the order of the units, whatever the tile or
  // ring.
  const int row0 = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0) * 64;
  const uint32_t lbo = 16u * (W + 1);
  const uint32_t plane_bytes = (uint32_t)kChunkBytes * (W + 1);
  float d[kNT / 2];
  piper::fence_regs(d);
  for (int q = 0; q < chunks; ++q) {
    const uint32_t a0 = piper::smem_addr(windows + (q & 1) * win_bytes) + (uint32_t)(row0 * 16);
    for (int j = 0; j < p.k; ++j) {
      const int u = q * p.k + j;
      const uint32_t slot = slots + (u % depth) * kUnitBytes;
      piper::mbar_wait(full + 8 * (u % depth), (u / depth) & 1);
      piper::wgmma_fence();
      const uint32_t at = a0 + (uint32_t)(j * p.dil * 16);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t ak = at + 2 * s * lbo;
        const uint64_t ahi = piper::a_desc(ak, lbo);
        const uint64_t whi = piper::b_desc<kChunkBytes>(slot + 32 * s);
        T::Mma::mma(d, ahi, whi, u > 0 || s > 0);  // v_hi w_hi (v_big w_big)
        T::Mma::mma(d, piper::a_desc(ak + plane_bytes, lbo), whi);  // v_lo w_hi
        T::Mma::mma(d, ahi, piper::b_desc<kChunkBytes>(slot + kNT * kChunkBytes + 32 * s));
      }
      piper::wgmma_commit();
      piper::wgmma_wait<1>();
      if (u > 0) {
        const int i = u - 1;  // this warp no longer reads unit i
        piper::mbar_arrive_if(lane == 0, empty + 8 * (i % depth));
        if (i + depth < total) {
          piper::mbar_wait(empty + 8 * (i % depth), (i / depth) & 1);
          issue(i + depth);
        }
      }
      if (q + 1 < chunks) {
        if (j == 0) {
          // Chunk q + 1's rows have landed (the latest group is q + 2's),
          // and every warpgroup is past chunk q - 1, whose buffer they fill.
          piper::cp_async_wait<1>();
          __syncthreads();
        }
        convert(q + 1, slice(j), slice(j + 1));
      }
    }
    if (q + 1 < chunks) {
      piper::fence_async_shared();
      __syncthreads();
      fetch(q + 3);  // into the raw buffer chunk q + 1 has left
    }
  }
  piper::wgmma_wait<0>();
  piper::fence_regs(d);
  __syncthreads();  // every warpgroup's products have read the ring and windows

  // The epilogue: the bias added, the sums through an fp32 stage over the
  // ring and windows (kNT rows of stage_stride(tile)), then coalesced rows
  // out, each the residual plus (conv + bias), as PyTorch adds them. D's
  // element 4jj + 2rr + e is output lane row0 + 16 * warp + gid + 8rr,
  // channel n0 + 8jj + 2tig + e.
  float* st = reinterpret_cast<float*>(wide_smem + align);
  const int ts = piper_k1::stage_stride(p.tile);
  const int o0 = row0 + 16 * (warp & 3) + gid;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int o = o0 + 8 * rr;
    if (o >= n_out) continue;
#pragma unroll
    for (int jj = 0; jj < kNT / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jj + 2 * tig + e;
        if (n0 + c < p.C)
          st[c * ts + o] = d[4 * jj + 2 * rr + e] + (p.bias ? __ldg(p.bias + n0 + c) : 0.f);
      }
    }
  }
  __syncthreads();
  for (int c = warp; c < c_end - n0; c += warps) {
    const size_t at = (size_t)(n0 + c) * p.N;
    for (int l = lane; l < n_out; l += 32) {
      const float v = st[c * ts + l];
      out[at + l] = res ? __ldg(res + at + l) + v : v;
    }
  }
}

template <int kTier>
int start(const Args& a, size_t smem, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(conv1d_same_wide_kernel<kTier>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.cp / kNT, (a.N + a.tile - 1) / a.tile, a.B);
  conv1d_same_wide_kernel<kTier>
      <<<grid, 2 * a.tile, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// "highest" (conv1d_wide_highest.cu).
int start_highest(const Args& a, size_t smem, int device, void* stream);

}  // namespace piper_k1w
