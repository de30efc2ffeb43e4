// Same-padded dilated conv1d with a fused leaky-ReLU input, for Hopper
// (sm_90a): fp32 on CUDA cores at "highest", bf16 mma.sync on the tensor
// cores at "high" and "default".
//
// Replaces the Pallas TPU kernel piper_tpu/ops/pallas/conv.py:
//   piper_conv1d_same  <- pallas_conv1d_same (_kernel):
//                         out = conv1d_same(act(x), w, b, dilation=d),
// act(v) = v >= 0 ? v : v * slope (slope 1 is the identity), odd k, square
// (C, C, k) weights, zero padding on both sides. Optional per-row bounds
// [lo, hi): act(v) is then also zero outside them, on the input only (for a
// 0/1 mask lrelu(x * m) = lrelu(x) * m, so this is the TPU kernel on
// x * mask). The output is not masked.
//
// What bounds it on the H100: the ResBlock2 convs of Piper's x_low voices
// are narrow (C = 32 or 64), short in taps (k = 3/5/7) and long in time.
// Per output sample a conv does C*k FMAs for each of C channels against 8
// bytes of traffic, so device memory is no limit; the products are. At
// batch 1 a level is only N/tile blocks (64 of 128 samples at C=64), so
// each block's own time, not the card's rate, sets the conv's time.
//
// "highest" (conv1d_same_kernel): one block per (time tile, row), one pass
// of the block over the tile. The block copies the tile's window
// [t0 - pad, t0 + tile + pad) of x (pad = (k-1)/2*d, zero outside [0, N))
// and the weights, transposed to (C_in, K, C_out), into shared memory with
// cp.async, so that all of a thread's loads are in flight at once; then it
// applies act once per window sample. The tap loop reads only shared
// memory: per (input channel, tap) a thread reads 2 activations, each
// feeding 8 FMAs, and 8 weights as two float4 loads (the same address
// across the warp), each feeding 2. Measured on the H100 at x_low's shapes:
// weights read through L1 instead of shared memory were 1.7-2.6x slower,
// and 4 samples per thread instead of 2 (half the warps) up to 1.5x slower
// below ~200 frames.
//
// "high" and "default" (conv1d_same_mma_kernel): the conv is one GEMM per
// time tile, M = C_out, N = the tile's lanes, K = C_in x taps, one
// mma.sync.m16n8k16 (bf16 in, fp32 sums) per (16 output channels, 8 lanes,
// tap, 16 input channels): "high" is three mma per step into one
// accumulator, (w_hi, v_hi) + (w_hi, v_lo) + (w_lo, v_hi), "default" one,
// (bf16(w), bf16(v)). Both operands are split into bf16 parts once, where
// they are written to shared memory, never at a read:
//   - the weights, read as the caller's fp32 (C_out, C_in, K), into planes
//     [tap][C_out][C_in + 8], once per block (blocks are persistent: a grid
//     of at most the SMs' resident blocks walks the tiles, so the staging
//     is paid once per SM, not once per tile); ldmatrix.x4 reads the A
//     fragments;
//   - the window, act(x) over [t0 - pad, t0 + tile + pad), into lane-major
//     planes [lane][C_in + 8], coalesced from device memory; the tap shift
//     is a row offset of j*d, and ldmatrix.x4 reads the B fragments.
// A row stride of C + 8 bf16 puts ldmatrix's eight 16-byte rows on
// distinct banks. A warp owns kMT m-tiles by 2 n-tiles of the block's one
// GEMM; its accumulators start at the bias. The accumulators leave through
// shared memory (over the window's planes), so that the stores to device
// memory are coalesced rows. C not a multiple of 16 is padded with zero
// channels in the planes and the weights: exact, and never stored.
// Tiles wholly outside [lo, hi) (their window is all zeros) skip the
// products: the output there is the bias.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "tiers.cuh"

namespace {

using piper::bf16;

constexpr int kMaxThreads = 512;
constexpr int kRCo = 8;  // "highest": output channels per thread
constexpr int kRT = 2;   // "highest": time samples per thread, strided by the row width
constexpr int kNT = 2;   // "high"/"default": 8-lane n-tiles per warp
constexpr int kPad = 8;  // "high"/"default": a bf16 plane's row is C + kPad
constexpr int kStagePad = 8;  // the output stage's row is tile + kStagePad floats

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

template <int K>
__global__ void __launch_bounds__(kMaxThreads) conv1d_same_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const int* __restrict__ bounds, int bounds_cols,
    float* __restrict__ out, int C, int N, int k_rt, int dil, int tile, float slope) {
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
  float* ob = out + (size_t)b * C * N + t0;
  int lo, hi;
  row_bounds(bounds, bounds_cols, b, N, lo, hi);

  if (t0 - pad >= hi || t0 + tile + pad <= lo) {  // the window is all zeros
    for (int idx = threadIdx.x; idx < C * n_out; idx += blockDim.x) {
      const int c = idx / n_out;
      ob[(size_t)c * N + idx - c * n_out] = bias ? __ldg(bias + c) : 0.f;
    }
    return;
  }
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
  // Lanes outside [0, N) are zero already: only bounds inside it mask.
  if (lo > max(t0 - pad, 0) || hi < min(t0 + tile + pad, N)) {
    int l = threadIdx.x % W;  // the lane of idx, stepped without a division
    for (int idx = threadIdx.x; idx < C * W; idx += blockDim.x) {
      win[idx] = act(win[idx], t0 - pad + l, lo, hi, slope);
      for (l += blockDim.x; l >= W; l -= W) {
      }
    }
  } else if (slope != 1.f) {
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
    const float bv = bias ? __ldg(bias + co0 + c) : 0.f;
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
      piper::fma_tile(wv, v, acc);
    }
  }
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int pos = tx + i * row_threads;
    if (pos >= n_out) continue;
#pragma unroll
    for (int c = 0; c < kRCo; ++c) ob[(size_t)(co0 + c) * N + pos] = acc[c][i];
  }
}

// "high" (kPasses 3) and "default" (1) on the tensor cores. One warp per
// work item of kMT m-tiles x kNT n-tiles: the block is exactly
// (Cp/16/kMT) * (tile/16) warps, Cp = C rounded up to 16, tile a multiple
// of 16. The grid is persistent: block i takes tiles i, i + gridDim.x, ...
// of the B * ceil(N/tile) (row, time tile) pairs.
template <int K, int kPasses, int kMT>
__global__ void __launch_bounds__(kMaxThreads) conv1d_same_mma_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const int* __restrict__ bounds, int bounds_cols,
    float* __restrict__ out, int B, int C, int N, int k_rt, int dil, int tile, float slope) {
  constexpr int kPlanes = kPasses == 3 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int taps = K > 0 ? K : k_rt;
  const int pad = (taps - 1) / 2 * dil;
  const int W = tile + 2 * pad;
  const int Cp = (C + 15) / 16 * 16;
  const int S = Cp + kPad;
  const int n16 = Cp / 16;
  const int wplane = taps * Cp * S;  // bf16 elements of one weight plane
  const int xplane = W * S;          // bf16 elements of one window plane
  const int TS = tile + kStagePad;
  bf16* wbuf = reinterpret_cast<bf16*>(smem_raw);  // [plane][tap][C_out][S]
  bf16* xbuf = wbuf + kPlanes * wplane;            // [plane][lane][S]
  float* stage = reinterpret_cast<float*>(xbuf);   // (C, TS), over the window's planes
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;

  // The weights, split once: w[co][ci][j] -> plane[j][co][ci], zero for the
  // padded channels. A warp walks output channels, each lane a pair of
  // input channels (C is even), so the stores to shared memory are
  // consecutive 4-byte words.
  for (int co = warp; co < Cp; co += nwarps) {
    for (int ci = 2 * lane; ci < Cp; ci += 64) {
      const bool real = co < C && ci < C;
      const float* wp = w + ((size_t)co * C + ci) * taps;
#pragma unroll
      for (int j = 0; j < taps; ++j)
        piper::store_split2<kPlanes>(wbuf, wplane, (j * Cp + co) * S + ci,
                                     real ? __ldg(wp + j) : 0.f,
                                     real ? __ldg(wp + taps + j) : 0.f);
    }
  }

  const int gid = lane >> 2;
  const int tig = lane & 3;
  // This thread's ldmatrix rows. B (window, [lane][channel]): lane
  // `lane & 7` of n-tile `lane >> 4`, channels +0 (matrices 0 and 2) or +8
  // (1 and 3) of the k-chunk. A (weights, [C_out][C_in]): row
  // (lane & 7) + 8 * ((lane >> 3) & 1), columns +0 (matrices 0 and 1) or +8
  // (2 and 3), in the order of the A fragment's a0..a3.
  const int brow = (lane & 7) + (lane >> 4) * 8;
  const int bcol = ((lane >> 3) & 1) * 8;
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int acol = (lane >> 4) * 8;
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
      // rows and each lane stores one 4-byte word per plane.
      const float* xb = x + (size_t)b * C * N;
      for (int c = 2 * warp; c < Cp; c += 2 * nwarps) {
        const float* row = xb + (size_t)c * N;
        for (int l = lane; l < W; l += 32) {
          const int g = t0 - pad + l;
          const bool in = c < C && g >= 0 && g < N;
          piper::store_split2<kPlanes>(xbuf, xplane, l * S + c,
                                       act(in ? __ldg(row + g) : 0.f, g, lo, hi, slope),
                                       act(in ? __ldg(row + N + g) : 0.f, g, lo, hi, slope));
        }
      }
    }
    __syncthreads();  // the weights (first tile) and the window are in place

    float acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int co = (mt0 + mt) * 16 + gid;
      const float b_top = bias && co < C ? __ldg(bias + co) : 0.f;
      const float b_bot = bias && co + 8 < C ? __ldg(bias + co + 8) : 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        acc[mt][nt][0] = acc[mt][nt][1] = b_top;
        acc[mt][nt][2] = acc[mt][nt][3] = b_bot;
      }
    }
    if (!dead) {
      for (int kc = 0; kc < n16; ++kc) {
#pragma unroll
        for (int j = 0; j < taps; ++j) {
          // Output lane p reads window lane p + j*dil.
          const bf16* bp = xbuf + (n0 + brow + j * dil) * S + kc * 16 + bcol;
          uint32_t bh[4], bl[4];
          piper::ldmatrix_x4(bh, bp);
          if (kPasses == 3) piper::ldmatrix_x4(bl, bp + xplane);
          const bf16* ap = wbuf + (j * Cp + mt0 * 16 + arow) * S + kc * 16 + acol;
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            uint32_t a[4];
            piper::ldmatrix_x4(a, ap + mt * 16 * S);
            const uint4 ah = make_uint4(a[0], a[1], a[2], a[3]);
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
              piper::mma_bf16(acc[mt][nt], ah, bh[2 * nt], bh[2 * nt + 1]);
            if (kPasses == 3) {
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
    __syncthreads();  // every warp is done with the planes: the stage goes over them

    // The accumulator fragment: element 2r + e of acc[mt][nt] is output
    // channel (mt0 + mt) * 16 + gid + 8r at lane n0 + nt*8 + 2*tig + e.
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
    float* ob = out + (size_t)b * C * N + t0;
    for (int c = warp; c < C; c += nwarps) {
      for (int l = lane; l < n_out; l += 32) ob[(size_t)c * N + l] = stage[c * TS + l];
    }
    __syncthreads();  // the next tile's window goes over the stage
  }
}

cudaError_t prepare(const void* kernel, size_t smem, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int K>
int launch_highest(const float* x, const float* w, const float* bias, const int* bounds,
                   int bounds_cols, float* out, int B, int C, int N, int k, int dil, int tile,
                   float slope, int device, void* stream) {
  const int threads = C / kRCo * ((tile + kRT - 1) / kRT);  // one pass over the tile
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)C * k * C + (size_t)C * (tile + (k - 1) * dil));
  const cudaError_t e = prepare((const void*)conv1d_same_kernel<K>, smem, device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + tile - 1) / tile, B);
  conv1d_same_kernel<K><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, bounds, bounds_cols, out, C, N, k, dil, tile, slope);
  return (int)cudaGetLastError();
}

template <int K, int kPasses, int kMT>
int launch_mma(const float* x, const float* w, const float* bias, const int* bounds,
               int bounds_cols, float* out, int B, int C, int N, int k, int dil, int tile,
               float slope, int device, void* stream) {
  constexpr int kPlanes = kPasses == 3 ? 2 : 1;
  const int Cp = (C + 15) / 16 * 16;
  const int threads = 32 * (Cp / 16 / kMT) * (tile / (8 * kNT));  // one warp per work item
  if (tile % (8 * kNT) || (Cp / 16) % kMT || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const size_t S = Cp + kPad;
  const size_t planes = sizeof(bf16) * kPlanes * (tile + (size_t)(k - 1) * dil) * S;
  const size_t stage = sizeof(float) * (size_t)C * (tile + kStagePad);
  const size_t smem = sizeof(bf16) * kPlanes * (size_t)k * Cp * S + (planes > stage ? planes : stage);
  const void* kernel = (const void*)conv1d_same_mma_kernel<K, kPasses, kMT>;
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
  conv1d_same_mma_kernel<K, kPasses, kMT>
      <<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope);
  return (int)cudaGetLastError();
}

template <int K, int kPasses>
int launch_mma_mt(const float* x, const float* w, const float* bias, const int* bounds,
                  int bounds_cols, float* out, int B, int C, int N, int k, int dil, int tile,
                  float slope, int m_tiles, int device, void* stream) {
  switch (m_tiles) {
    case 1: return launch_mma<K, kPasses, 1>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, device, stream);
    case 2: return launch_mma<K, kPasses, 2>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, device, stream);
    case 4: return launch_mma<K, kPasses, 4>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int K>
int launch(const float* x, const float* w, const float* bias, const int* bounds,
           int bounds_cols, float* out, int B, int C, int N, int k, int dil, int tile,
           float slope, int tier, int m_tiles, int device, void* stream) {
  switch (tier) {
    case 0: return launch_highest<K>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, device, stream);
    case 1: return launch_mma_mt<K, 3>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, m_tiles, device, stream);
    case 2: return launch_mma_mt<K, 1>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, m_tiles, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x, out (B, C, N); bias (C,) or null; bounds a device (B, bounds_cols)
// int32 array (bounds_cols 2: [lo, hi); 1: [0, hi)) or null with
// bounds_cols 0. w is tier 0 ("highest"): (C_in, K, C_out), 16-byte
// aligned; tiers 1/2 ("high"/"default"): the caller's (C_out, C_in, K).
// m_tiles (1, 2 or 4: 16-channel m-tiles per warp) is read at tiers 1/2
// only. Returns a cudaError_t code (0 on success).
int piper_conv1d_same(const float* x, const float* w, const float* bias, const int* bounds,
                      int bounds_cols, float* out, int B, int C, int N, int k, int dil,
                      int tile, float slope, int tier, int m_tiles, int device, void* stream) {
  if (C < kRCo || C % kRCo != 0 || k < 1 || k % 2 == 0 || dil < 1 || tile < 1 ||
      N < 1 || B < 1 || bounds_cols < 0 || bounds_cols > 2 || (bounds_cols > 0) != (bounds != nullptr))
    return (int)cudaErrorInvalidValue;
  switch (k) {  // HiFi-GAN's kernel sizes get an unrolled tap loop
    case 3: return launch<3>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, tier, m_tiles, device, stream);
    case 5: return launch<5>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, tier, m_tiles, device, stream);
    case 7: return launch<7>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, tier, m_tiles, device, stream);
    case 11: return launch<11>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, tier, m_tiles, device, stream);
    default: return launch<0>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, tier, m_tiles, device, stream);
  }
}

}  // extern "C"
