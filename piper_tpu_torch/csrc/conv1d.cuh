// The K1 kernel and its launchers, shared by conv1d.cu ("high" and
// "default", and the C entry) and conv1d_highest.cu ("highest"), which nvcc
// compiles in parallel. conv1d.cu's header says what the kernel computes
// and how it is laid out.
#pragma once

#include <cuda_runtime.h>

#include "tiers.cuh"

namespace {

using piper::bf16;
using piper::load_f;
using piper::Planes;
using piper::store_act2;

constexpr int kMaxThreads = 512;
constexpr int kStagePad = 8;  // the output stage's row is tile + kStagePad floats

// Window planes beyond Planes: "highest" keeps act(x) split into its tf32
// big and small parts, one fp32 plane each, split once where they are
// written; the bf16 tiers keep their Planes.
template <int kTier>
constexpr int kXPlanes = kTier == 0 ? 2 : Planes<kTier>::kCount;

// v0, v1 (neighbours, `off` even) into the "highest" window's planes:
// split_tf32's big part into the first, its small part `plane` floats on.
__device__ __forceinline__ void store_tf32_split2(float* planes, int plane, int off, float v0,
                                                  float v1) {
  uint32_t b0, s0, b1, s1;
  piper::split_tf32(v0, b0, s0);
  piper::split_tf32(v1, b1, s1);
  *reinterpret_cast<float2*>(planes + off) = make_float2(__uint_as_float(b0), __uint_as_float(b1));
  *reinterpret_cast<float2*>(planes + plane + off) =
      make_float2(__uint_as_float(s0), __uint_as_float(s1));
}

// Row b's [lo, hi), clamped to [0, N]: bounds is (B, cols) int32, cols 2
// meaning [lo, hi), 1 meaning [0, hi), 0 (no bounds) meaning [0, N).
__device__ __forceinline__ void row_bounds(const int* bounds, int cols, int b, int N, int& lo,
                                           int& hi) {
  lo = cols == 2 ? bounds[2 * b] : 0;
  hi = cols > 0 ? bounds[b * cols + cols - 1] : N;
  lo = min(max(lo, 0), N);
  hi = min(max(hi, 0), N);
}

// act(v) at global sample g: leaky ReLU, then zero outside [lo, hi).
__device__ __forceinline__ float act(float v, int g, int lo, int hi, float slope) {
  return (g >= lo && g < hi) ? (v >= 0.f ? v : v * slope) : 0.f;
}

// Every tier on the tensor cores. One warp per work item of kMT m-tiles x
// kNT n-tiles of 8 lanes: the block is exactly (Cp/16/kMT) * (tile/(8*kNT))
// warps, Cp = C rounded up to 16, tile a multiple of 8*kNT. kNT is 2 at
// "high"/"default" (one ldmatrix.x4 of B); "highest" also takes 4, where
// each A fragment split on read feeds 12 mma. The grid is persistent:
// block i takes tiles i, i + gridDim.x, ... of the B * ceil(N/tile)
// (row, time tile) pairs. TIO is the element type of x, w, bias and out:
// float at every tier, or bf16 at "default" only, where the window and the
// weights are read straight into the bf16 planes they are staged in (a bf16
// value rounds to itself) and the fp32 sums are stored rounded to bf16.
template <int K, int kTier, int kMT, int kNT, typename TIO>
__global__ void __launch_bounds__(kMaxThreads) conv1d_same_mma_kernel(
    const TIO* __restrict__ x, const TIO* __restrict__ w,
    const TIO* __restrict__ bias, const int* __restrict__ bounds, int bounds_cols,
    TIO* __restrict__ out, int B, int C, int N, int k_rt, int dil, int tile, float slope) {
  static_assert(std::is_same_v<TIO, float> || kTier == 2,
                "bf16 activations run at \"default\" only");
  static_assert(kTier == 0 || kNT == 2, "the bf16 tiers' B fragment covers 2 n-tiles");
  using P = Planes<kTier>;
  using T = typename P::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int taps = K > 0 ? K : k_rt;
  const int pad = (taps - 1) / 2 * dil;
  const int W = tile + 2 * pad;
  const int Cp = (C + 15) / 16 * 16;
  const int S = Cp + P::kPad;
  const int wplane = taps * Cp * S;  // elements of one weight plane
  const int xplane = W * S;          // elements of one window plane
  const int TS = tile + kStagePad;
  T* wbuf = reinterpret_cast<T*>(smem_raw);       // [plane][tap][C_out][S]
  T* xbuf = wbuf + P::kCount * wplane;            // [kXPlanes][lane][S]
  float* stage = reinterpret_cast<float*>(xbuf);  // (C, TS), over the window's planes
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;

  // The weights, once per block: w[co][ci][j] -> plane[j][co][ci], zero for
  // the padded channels. A warp walks output channels, each lane a pair of
  // input channels (C is even), so the stores to shared memory are
  // consecutive words.
  for (int co = warp; co < Cp; co += nwarps) {
    for (int ci = 2 * lane; ci < Cp; ci += 64) {
      const bool real = co < C && ci < C;
      const TIO* wp = w + ((size_t)co * C + ci) * taps;
#pragma unroll
      for (int j = 0; j < taps; ++j)
        store_act2<kTier>(wbuf, wplane, (j * Cp + co) * S + ci, real ? load_f(wp + j) : 0.f,
                          real ? load_f(wp + taps + j) : 0.f);
    }
  }

  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int groups_n = tile / (8 * kNT);
  const int mt0 = warp / groups_n * kMT;
  const int n0 = (warp % groups_n) * kNT * 8;
  const int tiles_per_row = (N + tile - 1) / tile;

  for (int tix = blockIdx.x; tix < B * tiles_per_row; tix += gridDim.x) {
    const int b = tix / tiles_per_row;
    const int t0 = (tix - b * tiles_per_row) * tile;
    const int n_out = min(tile, N - t0);
    int lo, hi;
    row_bounds(bounds, bounds_cols, b, N, lo, hi);
    const bool dead = t0 - pad >= hi || t0 + tile + pad <= lo;  // an all-zero window
    if (!dead) {
      // act(x) over the window into the planes: a warp walks pairs of
      // channels, its lanes consecutive samples, so the loads are coalesced
      // rows and each lane stores one pair per plane.
      const TIO* xb = x + (size_t)b * C * N;
      for (int c = 2 * warp; c < Cp; c += 2 * nwarps) {
        const TIO* row = xb + (size_t)c * N;
        for (int l = lane; l < W; l += 32) {
          const int g = t0 - pad + l;
          const bool in = c < C && g >= 0 && g < N;
          const float v0 = act(in ? load_f(row + g) : 0.f, g, lo, hi, slope);
          const float v1 = act(in ? load_f(row + N + g) : 0.f, g, lo, hi, slope);
          if constexpr (kTier == 0) {
            store_tf32_split2(xbuf, xplane, l * S + c, v0, v1);
          } else {
            store_act2<kTier>(xbuf, xplane, l * S + c, v0, v1);
          }
        }
      }
    }
    __syncthreads();  // the weights (first tile) and the window are in place

    float acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int co = (mt0 + mt) * 16 + gid;
      const float b_top = bias && co < C ? load_f(bias + co) : 0.f;
      const float b_bot = bias && co + 8 < C ? load_f(bias + co + 8) : 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        acc[mt][nt][0] = acc[mt][nt][1] = b_top;
        acc[mt][nt][2] = acc[mt][nt][3] = b_bot;
      }
    }
    // Output lane p reads window lane p + j*dil.
    if (!dead) {
      if constexpr (kTier == 0) {
        // 3xTF32, two m16n8k8 steps per 16 input channels. This thread's
        // operands: B, window lane gid of each n-tile at channels tig and
        // tig + 4 of the k-chunk of 8, from the big and small planes; A,
        // output channels gid and gid + 8 of each m-tile at the same two
        // channels, in the order of the A fragment's a0..a3, split on read.
        const float* bsrc = xbuf + (n0 + gid) * S + tig;
        const float* asrc = wbuf + (mt0 * 16 + gid) * S + tig;
        for (int kc = 0; kc < Cp / 8; ++kc) {
#pragma unroll
          for (int j = 0; j < taps; ++j) {
            uint32_t vb[kNT][2], vs[kNT][2];
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              const float* bp = bsrc + (nt * 8 + j * dil) * S + kc * 8;
              vb[nt][0] = __float_as_uint(bp[0]);
              vb[nt][1] = __float_as_uint(bp[4]);
              vs[nt][0] = __float_as_uint(bp[xplane]);
              vs[nt][1] = __float_as_uint(bp[xplane + 4]);
            }
            const float* ap = asrc + j * Cp * S + kc * 8;
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              const float* am = ap + mt * 16 * S;
              uint4 ab, as;
              piper::split_tf32(am[0], ab.x, as.x);
              piper::split_tf32(am[8 * S], ab.y, as.y);
              piper::split_tf32(am[4], ab.z, as.z);
              piper::split_tf32(am[8 * S + 4], ab.w, as.w);
#pragma unroll
              for (int nt = 0; nt < kNT; ++nt) {
                piper::mma_tf32(acc[mt][nt], ab, vb[nt][0], vb[nt][1]);
                piper::mma_tf32(acc[mt][nt], ab, vs[nt][0], vs[nt][1]);
                piper::mma_tf32(acc[mt][nt], as, vb[nt][0], vb[nt][1]);
              }
            }
          }
        }
      } else {
        // bf16, one m16n8k16 step per 16 input channels. This thread's
        // ldmatrix rows. B (window, [lane][channel]): lane `lane & 7` of
        // n-tile `lane >> 4`, channels +0 (matrices 0 and 2) or +8 (1 and 3)
        // of the k-chunk. A (weights, [C_out][C_in]): row (lane & 7) +
        // 8 * ((lane >> 3) & 1), columns +0 (matrices 0 and 1) or +8 (2 and
        // 3), in the order of the A fragment's a0..a3.
        const int brow = (lane & 7) + (lane >> 4) * 8;
        const int bcol = ((lane >> 3) & 1) * 8;
        const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
        const int acol = (lane >> 4) * 8;
        for (int kc = 0; kc < Cp / 16; ++kc) {
#pragma unroll
          for (int j = 0; j < taps; ++j) {
            const bf16* bp = xbuf + (n0 + brow + j * dil) * S + kc * 16 + bcol;
            uint32_t bh[4], bl[4];
            piper::ldmatrix_x4(bh, bp);
            if (kTier == 1) piper::ldmatrix_x4(bl, bp + xplane);
            const bf16* ap = wbuf + (j * Cp + mt0 * 16 + arow) * S + kc * 16 + acol;
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              uint32_t a[4];
              piper::ldmatrix_x4(a, ap + mt * 16 * S);
              const uint4 ah = make_uint4(a[0], a[1], a[2], a[3]);
#pragma unroll
              for (int nt = 0; nt < kNT; ++nt)
                piper::mma_bf16(acc[mt][nt], ah, bh[2 * nt], bh[2 * nt + 1]);
              if (kTier == 1) {
                piper::ldmatrix_x4(a, ap + mt * 16 * S + wplane);
                const uint4 al = make_uint4(a[0], a[1], a[2], a[3]);
#pragma unroll
                for (int nt = 0; nt < kNT; ++nt) {
                  piper::mma_bf16(acc[mt][nt], ah, bl[2 * nt], bl[2 * nt + 1]);
                  piper::mma_bf16(acc[mt][nt], al, bh[2 * nt], bh[2 * nt + 1]);
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the planes: the stage goes over them

    // The accumulator fragment (m16n8k16 and m16n8k8 alike): element 2r + e
    // of acc[mt][nt] is output channel (mt0 + mt) * 16 + gid + 8r at lane
    // n0 + nt*8 + 2*tig + e.
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int co = (mt0 + mt) * 16 + gid + 8 * r;
        if (co >= C) continue;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          *reinterpret_cast<float2*>(stage + co * TS + n0 + nt * 8 + 2 * tig) =
              make_float2(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
      }
    }
    __syncthreads();
    TIO* ob = out + (size_t)b * C * N + t0;
    for (int c = warp; c < C; c += nwarps) {
      for (int l = lane; l < n_out; l += 32) piper::store_f(ob + (size_t)c * N + l, stage[c * TS + l]);
    }
    __syncthreads();  // the next tile's window goes over the stage
  }
}

cudaError_t prepare(const void* kernel, size_t smem, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int K, int kTier, int kMT, int kNT, typename TIO>
int launch_mma(const TIO* x, const TIO* w, const TIO* bias, const int* bounds,
               int bounds_cols, TIO* out, int B, int C, int N, int k, int dil, int tile,
               float slope, int device, void* stream) {
  using P = Planes<kTier>;
  const int Cp = (C + 15) / 16 * 16;
  const int threads = 32 * (Cp / 16 / kMT) * (tile / (8 * kNT));  // one warp per work item
  if (tile % (8 * kNT) || (Cp / 16) % kMT || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const size_t S = Cp + P::kPad;
  const size_t el = sizeof(typename P::T);
  const size_t window = el * kXPlanes<kTier> * (tile + (size_t)(k - 1) * dil) * S;
  const size_t stage = sizeof(float) * (size_t)C * (tile + kStagePad);
  const size_t smem = el * P::kCount * (size_t)k * Cp * S + (window > stage ? window : stage);
  const void* kernel = (const void*)conv1d_same_mma_kernel<K, kTier, kMT, kNT, TIO>;
  cudaError_t e = prepare(kernel, smem, device);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (long long)B * ((N + tile - 1) / tile);
  const int grid = (int)(tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms);
  conv1d_same_mma_kernel<K, kTier, kMT, kNT, TIO>
      <<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope);
  return (int)cudaGetLastError();
}

template <int K, int kTier, int kNT, typename TIO>
int launch_mt(const TIO* x, const TIO* w, const TIO* bias, const int* bounds,
              int bounds_cols, TIO* out, int B, int C, int N, int k, int dil, int tile,
              float slope, int m_tiles, int device, void* stream) {
  switch (m_tiles) {
    case 1: return launch_mma<K, kTier, 1, kNT, TIO>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, device, stream);
    case 2: return launch_mma<K, kTier, 2, kNT, TIO>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, device, stream);
    case 4:  // "highest" takes 1 or 2: 4 m-tiles by its n-tiles would spill
      if constexpr (kTier == 0) return (int)cudaErrorInvalidValue;
      else return launch_mma<K, kTier, 4, kNT, TIO>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One tier and n-tile count over HiFi-GAN's kernel sizes (an unrolled tap
// loop each; other odd k take the runtime loop).
template <int kTier, int kNT, typename TIO>
int launch_tier(const TIO* x, const TIO* w, const TIO* bias, const int* bounds,
                int bounds_cols, TIO* out, int B, int C, int N, int k, int dil, int tile,
                float slope, int m_tiles, int device, void* stream) {
  switch (k) {
    case 3: return launch_mt<3, kTier, kNT, TIO>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, m_tiles, device, stream);
    case 5: return launch_mt<5, kTier, kNT, TIO>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, m_tiles, device, stream);
    case 7: return launch_mt<7, kTier, kNT, TIO>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, m_tiles, device, stream);
    case 11: return launch_mt<11, kTier, kNT, TIO>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, m_tiles, device, stream);
    default: return launch_mt<0, kTier, kNT, TIO>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, m_tiles, device, stream);
  }
}

}  // namespace


// "highest" at n_tiles 2 or 4 (conv1d_highest.cu).
int conv1d_highest(const float* x, const float* w, const float* bias, const int* bounds,
                   int bounds_cols, float* out, int B, int C, int N, int k, int dil, int tile,
                   float slope, int m_tiles, int n_tiles, int device, void* stream);
