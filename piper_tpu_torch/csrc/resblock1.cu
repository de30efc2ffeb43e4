// HiFi-GAN ResBlock1 kernels for Hopper (sm_90a): fp32 sums, the convs'
// products on the tensor cores at every tier: warpgroup products (wgmma)
// at "high" and "default", 3xTF32 on mma.sync at "highest".
//
// Replaces three Pallas TPU kernels:
//   piper_resblock1_branch     <- pallas_resblock1_branch (_branch_kernel,
//                                 piper_tpu/ops/pallas/resblock.py): one
//                                 ResBlock1 branch, y = x; for d in dils:
//                                 y += conv2(act(conv1_d(act(y)))).
//   piper_resblock1_mrf        <- pallas_resblock1_mrf (_mrf_kernel, same
//                                 file): every branch from one shared window,
//                                 then their mean.
//   piper_resblock1_mrf_folded <- pallas_resblock1_mrf_folded
//                                 (_mrf_folded_kernel,
//                                 piper_tpu/ops/pallas/folded.py): the MRF
//                                 stage on the folded layout (B, F*C, N/F),
//                                 where sample g = F*q + r of channel c sits
//                                 at row r*C + c, lane q.
// act(v) is a leaky ReLU followed by the row's [lo, hi) mask on the global
// sample index; the output is exactly zero outside [lo, hi). The convs'
// products run at the tier of tiers.cuh.
//
// What bounds it on the H100: the six chained convs of a branch are narrow
// (C = 16, 32 or 64 channels) and long in time. Run one by one, each conv
// streams the level activation through device memory; fused, the work is
// the products (2*C*C*k per output sample per conv: 989 TFLOP/s in bf16 on
// the tensor cores, three passes at "high"; 495 in TF32, three passes at
// "highest") plus the halo recompute.
//
// Design: one block of 512 threads per (output tile of `tile` samples, row).
// The block loads the tile's haloed window [t0 - halo, t0 + tile + halo)
// once and walks the whole chain on chip, so the activation crosses device
// memory once in and once out (the MRF kernel reloads the window from L2
// for each branch). act(y) and act(conv1) are lane-major planes in shared
// memory, [lane][channel], so a tap's lane shift is a row offset. The valid
// region shrinks stage by stage exactly as _run_branch_chain shrinks it; a
// narrower MRF branch starts with the margin it does not need already
// consumed. Tiles wholly outside [lo, hi) write zeros and skip all work.
//
// "high" and "default": the wgmma stage (conv_stage_wgmma). Each conv is
// one GEMM per tap, M = the window's lanes, N = C_out, K = C_in, summed over
// the taps: the four warpgroups own 64 window lanes each (the window is at
// most 256 lanes), in every stage. A (act of the stage's input, bf16) is
// read from shared memory by descriptor: the planes hold 8 channels a lane
// in 16 bytes, lanes in order, 8 channels a chunk plane (wgmma.cuh), so a
// tap's lane shift is a 16-byte step of the start address. B (the tap's
// weights) arrives as the host's image of wgmma's K-major swizzled layout
// (ops/kernels/resblock.py::wgmma_weights) by cp.async.bulk, a chunk of up
// to `chunk` taps of one conv a copy, into a ring of `ring` slots completed
// on mbarriers: a slot is refilled once all 16 warps have released it, so
// the next chunk's copy runs under the current chunk's products. All four
// warpgroups read the same tiles. A chunk's products go out as one group,
// and the warpgroup waits only for the chunk before it; the fewer chunks a
// conv takes, the fewer waits (measured: per-tap waits cost more than the
// products at these widths). The residual y stays in registers, in
// the D layout: conv2 starts its accumulator at y and ends it as the new
// y once b2 is added (wgmma accumulates D += A.B), and the MRF's branch sum
// sits beside
// it, so the block keeps no fp32 buffer; each epilogue writes act() into a
// plane as bf16 pairs, a warp's 32 pairs on 128 contiguous bytes. A bf16
// product is exact in fp32, so "high" is three wgmma per (tap, 16 input
// channels) into one accumulator, (v_hi, w_hi) + (v_lo, w_hi) + (v_hi,
// w_lo), and "default" one, (bf16(v), bf16(w)): mxu_dot's passes, summed in
// another order. The activations are split into bf16 planes where they are
// written (store_split2). C is 16, 32 or 64 (N of one wgmma; the weight row
// one swizzle width). Lanes past a stage's width read neighbouring lanes
// (or the memory around the planes) and are not stored; a warpgroup with
// no lane in the stage only passes the stage's tiles through the ring.
//
// "highest": 3xTF32 (conv_stage_mma), two mma.sync.m16n8k8 steps (tf32 in,
// fp32 sums) per 16 input channels, each three mma into one accumulator,
// (w_big, v_big) + (w_big, v_small) + (w_small, v_big), M = C_out, N = the
// stage's lanes. The weights' big and small parts are split on the host
// into mma's A-fragment order (tf32_weights), read through L1; the
// activations stay one fp32 plane per buffer, row stride C + 4 words, split
// on read; the residual is an fp32 (C, W) buffer in shared memory.
//
// bf16 activations (the runtime's "bfloat16" mode, at "default" only): the
// branch and MRF kernels also take x, out and the biases as bf16 (a
// template parameter, TIO), read into fp32 where they are loaded and
// rounded to bf16 where the output is stored. Inside the block nothing
// changes: the residual is fp32 and act(y), act(conv1) the same bf16
// planes as at "default" on fp32 input, so the kernel on bf16 x equals the
// fp32-input kernel on the same (bf16-valued) x with its output rounded to
// bf16.
//
// The folded kernel is the MRF kernel with a folded gather and scatter: the
// TPU kernel's zero-padded folded weight GEMM fills the MXU's 128 sublanes
// at the cost of S/k redundant FLOPs, which no tier needs here, so the
// block walks the same chain over the same window of samples and only the
// addresses of the loads and stores change: it is bit-equal to the MRF
// kernel.

#include <cuda_runtime.h>

#include <cstdint>

#include "tiers.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNT = 2;  // 8-lane n-tiles per warp work item ("highest")
constexpr int kMaxBranches = 4;
constexpr int kMaxDils = 4;
constexpr int kWindow = 4 * 64;  // the wgmma stage's lanes: 64 per warpgroup
constexpr int kMaxRing = 8;

using piper::bf16;
using piper::load_f;
using piper::Planes;

struct Branch {
  // "highest": tf32 A fragments (2, M, K, C_in/8, C_out/16, 32 lanes, 4),
  // planes (big, small). "high"/"default": wgmma's B image (M, K, P, C, C)
  // bf16, P = 2 planes (hi, lo) at "high" and 1 at "default"
  // (ops/kernels/resblock.py::_kernel_weights).
  const void* w1;  // conv1 (dilated) weights
  const void* b1;  // (M, C), the kernel's TIO
  const void* w2;  // conv2 (dense) weights
  const void* b2;  // (M, C), the kernel's TIO
  int k;
  int n_dil;
  int halo;  // this branch's one-sided receptive field
  int dils[kMaxDils];
};

struct Args {
  const void* x;       // (B, C, N), or (B, fold*C, nq) folded; the kernel's TIO
  void* out;           // the layout and type of x
  const int* bounds;   // (B, 2) [lo, hi) with 0 <= lo, hi <= N
  int C, N, tile, width, halo, n_branches;
  int ring, chunk;     // the wgmma stage's weight slots, and taps a slot holds
  int fold, nq;        // folded layout: N = fold * nq samples
  float slope;
  Branch br[kMaxBranches];
};

// Offset of (channel c, sample g) within one row of x or out: (C, N) as is,
// or the folded (fold*C, nq) layout with g = fold*q + r at row r*C + c.
template <bool kFolded>
__device__ __forceinline__ size_t offset(const Args& p, int c, int g) {
  if (!kFolded) return (size_t)c * p.N + g;
  return ((size_t)(g % p.fold) * p.C + c) * p.nq + g / p.fold;
}

// act(v) at global sample index g: leaky ReLU, then zero outside [lo, hi).
__device__ __forceinline__ float act(float v, int g, int lo, int hi, float slope) {
  return (g >= lo && g < hi) ? (v >= 0.f ? v : v * slope) : 0.f;
}

// Zeros over a dead tile's outputs (no sample of it lies in [lo, hi)).
template <bool kFolded, typename TIO>
__device__ void zero_tile(const Args& p, TIO* out, int t0, int n_out) {
  for (int idx = threadIdx.x; idx < p.C * n_out; idx += kThreads) {
    const int c = idx / n_out;
    piper::store_f(out + offset<kFolded>(p, c, t0 + idx - c * n_out), 0.f);
  }
}

// ------------------------------------------------------------------------
// "highest": 3xTF32 on mma.sync.

// One conv of the chain over a window of `W` lanes. Output lane l in
// [a, a + width) reads input lanes l - h + j*step, j < K (K > 0 is a
// compile-time tap count, so the tap loop unrolls; K == 0 reads k_rt). src
// and dst are fp32 planes (W rows of C + 4); w points at this conv's A
// fragments of the big parts, and the small parts' are w_lo uint4s on.
// kConv1: store act(conv) into dst. Otherwise add the conv into the fp32
// residual ybuf ((C, W)) and store act(new residual) into dst.
template <int K, int kMT, bool kConv1>
__device__ void conv_stage_mma(const float* __restrict__ src, float* __restrict__ ybuf,
                               float* __restrict__ dst, const uint4* __restrict__ w,
                               size_t w_lo, const float* __restrict__ bias, int C, int W,
                               int k_rt, int step, int h, int a, int width, float slope, int g0,
                               int lo, int hi) {
  const int taps = K > 0 ? K : k_rt;
  const int S = C + Planes<0>::kPad;
  const int n16 = C / 16;  // m-tiles of C_out
  const int groups_n = ((width + 7) / 8 + kNT - 1) / kNT;
  const int items = n16 / kMT * groups_n;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int first = a - h;  // input lane read by output lane a at tap 0
  for (int item = threadIdx.x >> 5; item < items; item += kWarps) {
    const int mt0 = item / groups_n * kMT;
    const int n0 = (item % groups_n) * kNT * 8;
    float acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float b_top = load_f(bias + (mt0 + mt) * 16 + gid);
      const float b_bot = load_f(bias + (mt0 + mt) * 16 + gid + 8);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        acc[mt][nt][0] = acc[mt][nt][1] = b_top;
        acc[mt][nt][2] = acc[mt][nt][3] = b_bot;
      }
    }
    // Lanes past the stage's width read clamped (valid) lanes; their sums
    // are discarded below. This thread's B rows: lane gid of each n-tile,
    // channels tig and tig + 4 of each k-chunk of 8, split on read.
    const float* brow[kNT];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      brow[nt] = src + (size_t)(first + min(n0 + nt * 8 + gid, width - 1)) * S + tig;
    const int n8 = C / 8;  // k-chunks of C_in per tap
    for (int kc = 0; kc < n8; ++kc) {
#pragma unroll
      for (int j = 0; j < taps; ++j) {
        const int off = j * step * S + kc * 8;
        uint32_t vb[kNT][2], vs[kNT][2];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          piper::split_tf32(brow[nt][off], vb[nt][0], vs[nt][0]);
          piper::split_tf32(brow[nt][off + 4], vb[nt][1], vs[nt][1]);
        }
        const uint4* wp = w + (((size_t)j * n8 + kc) * n16 + mt0) * 32 + lane;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const uint4 ab = __ldg(wp + mt * 32);
          const uint4 as = __ldg(wp + w_lo + mt * 32);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            piper::mma_tf32(acc[mt][nt], ab, vb[nt][0], vb[nt][1]);
            piper::mma_tf32(acc[mt][nt], ab, vs[nt][0], vs[nt][1]);
            piper::mma_tf32(acc[mt][nt], as, vb[nt][0], vb[nt][1]);
          }
        }
      }
    }
    // The accumulator fragment: element 2r + e of acc[mt][nt] is output
    // channel (mt0 + mt) * 16 + gid + 8r at stage lane n0 + nt*8 + 2*tig + e.
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pos = n0 + nt * 8 + 2 * tig + e;
          if (pos >= width) continue;
          const int l = a + pos;
          const int g = g0 + l;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int co = (mt0 + mt) * 16 + gid + 8 * r;
            const float v = acc[mt][nt][2 * r + e];
            if (kConv1) {
              dst[l * S + co] = act(v, g, lo, hi, slope);
            } else {
              const int idx = co * W + l;
              const float y = ybuf[idx] + v;
              ybuf[idx] = y;
              dst[l * S + co] = act(y, g, lo, hi, slope);
            }
          }
        }
      }
    }
  }
}

// The branch chain, in place on ybuf (abuf holds act(y), tbuf act(conv1)).
// `margin0` is the margin already consumed on each side: 0 when the window
// halo equals this branch's receptive field, more for a narrower MRF
// branch. On return ybuf is exact on [margin0 + br.halo, W - margin0 -
// br.halo).
template <int K, int kMT>
__device__ void run_chain_k(float* ybuf, float* abuf, float* tbuf, const Branch& br,
                            const Args& p, int margin0, int g0, int lo, int hi) {
  const int C = p.C;
  const int W = p.width;
  const int h2 = (br.k - 1) / 2;
  const size_t wstride = (size_t)C * C * br.k / 4;  // uint4s of one conv's big parts
  const size_t w_lo = wstride * br.n_dil;
  const uint4* w1 = static_cast<const uint4*>(br.w1);
  const uint4* w2 = static_cast<const uint4*>(br.w2);
  const float* b1 = static_cast<const float*>(br.b1);
  const float* b2 = static_cast<const float*>(br.b2);
  int margin = margin0;
  for (int m = 0; m < br.n_dil; ++m) {
    const int d = br.dils[m];
    const int h1 = h2 * d;
    const int a1 = margin + h1;
    conv_stage_mma<K, kMT, true>(abuf, ybuf, tbuf, w1 + m * wstride, w_lo, b1 + m * C, C, W,
                                 br.k, d, h1, a1, W - 2 * a1, p.slope, g0, lo, hi);
    __syncthreads();
    const int a2 = a1 + h2;
    conv_stage_mma<K, kMT, false>(tbuf, ybuf, abuf, w2 + m * wstride, w_lo, b2 + m * C, C, W,
                                  br.k, 1, h2, a2, W - 2 * a2, p.slope, g0, lo, hi);
    __syncthreads();
    margin = a2;
  }
}

template <int kMT>
__device__ void run_chain_mt(float* ybuf, float* abuf, float* tbuf, const Branch& br,
                             const Args& p, int margin0, int g0, int lo, int hi) {
  switch (br.k) {  // ResBlock1's kernel sizes; others (k = 5 in tests) take the runtime loop
    case 3: run_chain_k<3, kMT>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi); break;
    case 7: run_chain_k<7, kMT>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi); break;
    case 11: run_chain_k<11, kMT>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi); break;
    default: run_chain_k<0, kMT>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi); break;
  }
}

// The "highest" block: m-tiles per warp work item 4 when C/16 allows
// (C = 64), else 2, else 1.
template <bool kMean, bool kFolded>
__device__ void tf32_block(const Args& p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C;
  const int W = p.width;
  const int S = C + Planes<0>::kPad;
  float* ybuf = smem;              // (C, W) raw residual y
  float* abuf = smem + C * W;      // act(y), lane-major (W, S)
  float* tbuf = abuf + W * S;      // act(conv1 output), the same
  float* acc = tbuf + W * S;       // (C, tile) branch sum, kMean only

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * p.tile;
  const int lo = p.bounds[2 * b];
  const int hi = p.bounds[2 * b + 1];
  const int n_out = min(p.tile, p.N - t0);
  float* out = static_cast<float*>(p.out) + (size_t)b * C * p.N;
  if (t0 >= hi || t0 + p.tile <= lo) return zero_tile<kFolded>(p, out, t0, n_out);

  const int g0 = t0 - p.halo;  // global sample index of window lane 0
  const float* x = static_cast<const float*>(p.x) + (size_t)b * C * p.N;
  if (kMean) {
    for (int idx = threadIdx.x; idx < C * p.tile; idx += kThreads) acc[idx] = 0.f;
  }
  const int n16 = C / 16;
  for (int bi = 0; bi < p.n_branches; ++bi) {
    for (int idx = threadIdx.x; idx < C * W; idx += kThreads) {
      const int c = idx / W;
      const int l = idx - c * W;
      const int g = g0 + l;
      const float v = (g >= 0 && g < p.N) ? load_f(x + offset<kFolded>(p, c, g)) : 0.f;
      ybuf[idx] = v;
      abuf[l * S + c] = act(v, g, lo, hi, p.slope);
    }
    __syncthreads();
    const Branch& br = p.br[bi];
    const int margin0 = p.halo - br.halo;
    if (n16 % 4 == 0) {
      run_chain_mt<4>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi);
    } else if (n16 % 2 == 0) {
      run_chain_mt<2>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi);
    } else {
      run_chain_mt<1>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi);
    }
    if (kMean) {
      for (int idx = threadIdx.x; idx < C * p.tile; idx += kThreads) {
        const int c = idx / p.tile;
        acc[idx] += ybuf[c * W + p.halo + (idx - c * p.tile)];
      }
      __syncthreads();  // the next branch reloads ybuf
    }
  }

  const float inv = 1.f / p.n_branches;
  for (int idx = threadIdx.x; idx < C * n_out; idx += kThreads) {
    const int c = idx / n_out;
    const int l = idx - c * n_out;
    const int g = t0 + l;
    const float v = kMean ? acc[c * p.tile + l] * inv : ybuf[c * W + p.halo + l];
    out[offset<kFolded>(p, c, g)] = (g >= lo && g < hi) ? v : 0.f;
  }
}

// ------------------------------------------------------------------------
// "high" and "default": wgmma, weights bulk-copied into shared memory.

// Sizes of the stage at C channels and tier kTier. A buffer of
// activations is kPlanes bf16 planes (hi, and lo at "high"), each C/8
// chunk planes of W + 1 lanes x 8 channels: (plane, lane l, channel c) at
// element plane * C * (W + 1) + (c / 8) * 8(W + 1) + 8l + c % 8. Lane W
// takes the stores of lanes outside a stage, so no store is a branch.
template <int kC, int kTier>
struct Wg {
  static constexpr int kPlanes = Planes<kTier>::kCount;  // bf16 planes a buffer
  static constexpr int kAcc = kC / 2;                    // D registers a thread
  static constexpr int kK16 = kC / 16;                   // k16 steps a tap
  static constexpr int kPlaneBytes = 2 * kC * kC;        // one tap's B image, one plane
  static constexpr int kTileBytes = kPlanes * kPlaneBytes;
};

// Element offset of (lane l, channels c and c + 1, c even) in one plane
// of `lanes` lanes.
__device__ __forceinline__ int chunk_offset(int lanes, int l, int c) {
  return (c >> 3) * 8 * lanes + 8 * l + (c & 7);
}

// Shared bytes of the ring's mbarriers (full and empty per slot), rounded
// to 128 so the planes after them stay aligned.
__host__ __device__ constexpr int ring_barrier_bytes(int ring) {
  return (16 * ring + 127) / 128 * 128;
}

// Bytes of one ring slot: `chunk` tap tiles, rounded up to 1024 (the
// swizzle's alignment).
__host__ __device__ constexpr int ring_slot_bytes(int chunk, int tile_bytes) {
  return (chunk * tile_bytes + 1023) / 1024 * 1024;
}

// The ring of weight chunks in shared memory: a chunk is up to `chunk`
// consecutive taps of one conv, one bulk copy (a conv's taps are contiguous
// in its image). Every thread walks the same sequence of chunks (per
// branch, per dilation: conv1's, then conv2's) and keeps `next`, the index
// of the next chunk it consumes, and the cursor of the next to issue.
struct Ring {
  uint32_t slots, full, empty;  // shared addresses: slot 0, full[0], empty[0]
  int depth, slot_bytes, chunk, total, next;
  int issued, bi, m, conv, j;   // the next chunk to issue: branch, dilation, conv, first tap
};

// Every thread: chunk `issued` goes into slot issued % depth (thread 0
// issues the copy), and the cursor moves on.
template <int kTileBytes>
__device__ __forceinline__ void ring_issue(Ring& r, const Args& p) {
  const Branch& br = p.br[r.bi];
  const char* w = static_cast<const char*>(r.conv ? br.w2 : br.w1);
  const int slot = r.issued % r.depth;
  const int taps = min(r.chunk, br.k - r.j);
  piper::bulk_copy_if(threadIdx.x == 0, r.slots + slot * r.slot_bytes,
                      w + ((size_t)r.m * br.k + r.j) * kTileBytes, taps * kTileBytes,
                      r.full + 8 * slot);
  ++r.issued;
  r.j += taps;
  if (r.j == br.k) {
    r.j = 0;
    if (++r.conv == 2) {
      r.conv = 0;
      if (++r.m == br.n_dil) {
        r.m = 0;
        ++r.bi;
      }
    }
  }
}

__device__ __forceinline__ void ring_wait(const Ring& r, int i) {
  piper::mbar_wait(r.full + 8 * (i % r.depth), (i / r.depth) & 1);
}

// The calling warp no longer reads chunk i (its products on it completed).
__device__ __forceinline__ void ring_arrive(const Ring& r, int i) {
  piper::mbar_arrive_if((threadIdx.x & 31) == 0, r.empty + 8 * (i % r.depth));
}

// ring_arrive, then: once all 16 warps have released chunk i, the slot
// takes chunk i + depth (chunks are released in order, so that is the next
// to issue); every thread waits for that, so no warpgroup runs more than a
// chunk ahead of another.
template <int kTileBytes>
__device__ __forceinline__ void ring_release(Ring& r, int i, const Args& p) {
  ring_arrive(r, i);
  if (r.issued < r.total) {
    piper::mbar_wait(r.empty + 8 * (i % r.depth), (i / r.depth) & 1);
    ring_issue<kTileBytes>(r, p);
  }
}

// After a __syncthreads that follows every warp's ring_arrive of a stage's
// last chunk: that slot takes the next chunk, with no wait on its barrier.
template <int kTileBytes>
__device__ __forceinline__ void ring_refill(Ring& r, const Args& p) {
  if (r.issued < r.total) ring_issue<kTileBytes>(r, p);
}

// One conv of the chain: output lanes [a, a + width) of the window read
// input lanes l - h + j*step, j < K (K == 0: k_rt taps at run time). src is
// the stage input's planes (shared address), dst the output's. d is the
// accumulator in the D layout: kConv1, it starts at 0 and dst gets
// act(conv + bias); otherwise d holds the residual y, gets the conv and
// then the bias added, and dst gets act(new y). TB is the bias type. Per
// chunk of taps,
// the warpgroup's products over its taps, their 16-channel steps (and the
// three passes at "high") go out as one group; once the chunk before has
// completed, its slot is released; the last chunk's slot is refilled by the
// caller after the stage's __syncthreads.
template <int K, int kC, int kTier, bool kConv1, typename TB>
__device__ __forceinline__ void conv_stage_wgmma(uint32_t src, bf16* __restrict__ dst,
                                                 float (&d)[Wg<kC, kTier>::kAcc], Ring& r,
                                                 const Args& p, const TB* __restrict__ bias,
                                                 int k_rt, int step, int h, int a, int width,
                                                 int g0, int lo, int hi) {
  using G = Wg<kC, kTier>;
  const int taps = K > 0 ? K : k_rt;
  const int chunks = (taps + r.chunk - 1) / r.chunk;
  const int first = r.next;
  r.next += chunks;
  // This warpgroup's first window lane, warp-uniform as the compiler sees it
  // (wgmma's descriptors live in uniform registers).
  const int row0 = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0) * 64;
  if (row0 >= a + width || row0 + 64 <= a) {  // no output lane here: pass the chunks on
    for (int c = 0; c < chunks; ++c) {
      ring_wait(r, first + c);
      if (c + 1 < chunks) {
        ring_release<G::kTileBytes>(r, first + c, p);
      } else {
        ring_arrive(r, first + c);
      }
    }
    return;
  }
  const int W = p.width;
  const int Wp = W + 1;  // lanes a chunk plane
  const int lane = threadIdx.x & 31;
  const int tig = lane & 3;
  // The bias is added after the products, so its loads run under them:
  // conv1's sum starts at 0 (its first product does not accumulate),
  // conv2's at y.
  float bv[kC / 4];
#pragma unroll
  for (int jj = 0; jj < kC / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[2 * jj + e] = load_f(bias + 8 * jj + 2 * tig + e);
  }
  // A of tap j: the 64 input lanes from row0 - h + j*step (lanes outside the
  // stage read neighbouring memory; their rows are not stored), 16(W + 1)
  // bytes per 8 channels.
  const uint32_t lbo = 16u * Wp;
  const uint32_t plane_bytes = (uint32_t)kC * Wp * 2;
  const uint32_t a0 = src + (uint32_t)((row0 - h) * 16);
  piper::fence_regs(d);
  for (int c = 0; c < chunks; ++c) {
    const int j0 = c * r.chunk;
    const int j1 = min(j0 + r.chunk, taps);
    const uint32_t slot = r.slots + ((first + c) % r.depth) * r.slot_bytes;
    ring_wait(r, first + c);
    piper::wgmma_fence();
    for (int j = j0; j < j1; ++j) {
      const uint32_t tile = slot + (j - j0) * G::kTileBytes;
      const uint32_t at = a0 + (uint32_t)(j * step * 16);
#pragma unroll
      for (int kc = 0; kc < G::kK16; ++kc) {
        const uint64_t ahi = piper::a_desc(at + 2 * kc * lbo, lbo);
        // conv1's first product overwrites d: its sum starts at 0
        piper::Wgmma<kC>::mma(d, ahi, piper::b_desc<kC>(tile + 32 * kc),
                              !kConv1 || j > 0 || kc > 0);  // v_hi w_hi
        if constexpr (G::kPlanes == 2) {
          piper::Wgmma<kC>::mma(d, piper::a_desc(at + plane_bytes + 2 * kc * lbo, lbo),
                                piper::b_desc<kC>(tile + 32 * kc));  // v_lo w_hi
          piper::Wgmma<kC>::mma(d, ahi, piper::b_desc<kC>(tile + G::kPlaneBytes +
                                                          32 * kc));  // v_hi w_lo
        }
      }
    }
    piper::wgmma_commit();
    piper::wgmma_wait<1>();
    if (c > 0) ring_release<G::kTileBytes>(r, first + c - 1, p);
  }
  piper::wgmma_wait<0>();
  piper::fence_regs(d);
  ring_arrive(r, first + chunks - 1);  // refilled after the stage's __syncthreads
  // The D layout: d[4jj + 2rr + e] is window lane row0 + 16 * warp + gid +
  // 8rr, channel 8jj + 2tig + e.
#pragma unroll
  for (int jj = 0; jj < kC / 8; ++jj) {
#pragma unroll
    for (int i = 0; i < 4; ++i) d[4 * jj + i] += bv[2 * jj + (i & 1)];
  }
  const int plane = kC * Wp;
  const int row = row0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int l = row + 8 * rr;
    const int at = (l >= a && l < a + width) ? l : W;  // outside the stage: lane W
    const int g = g0 + l;
#pragma unroll
    for (int jj = 0; jj < kC / 8; ++jj) {
      piper::store_split2<G::kPlanes>(dst, plane, chunk_offset(Wp, at, 8 * jj + 2 * tig),
                                      act(d[4 * jj + 2 * rr], g, lo, hi, p.slope),
                                      act(d[4 * jj + 2 * rr + 1], g, lo, hi, p.slope));
    }
  }
  piper::fence_async_shared();  // the next stage's wgmma reads dst
}

// The branch chain on y (registers, the D layout): abuf holds act(y), tbuf
// act(conv1), as the tier's planes; t is conv1's accumulator. margin0 as
// for run_chain_k.
template <int K, int kC, int kTier, typename TIO>
__device__ __forceinline__ void run_chain_wgmma_k(float (&y)[Wg<kC, kTier>::kAcc],
                                  float (&t)[Wg<kC, kTier>::kAcc], bf16* abuf, bf16* tbuf,
                                  Ring& r, const Branch& br, const Args& p, int margin0, int g0,
                                  int lo, int hi) {
  const int W = p.width;
  const int h2 = (br.k - 1) / 2;
  const TIO* b1 = static_cast<const TIO*>(br.b1);
  const TIO* b2 = static_cast<const TIO*>(br.b2);
  const uint32_t a_s = piper::smem_addr(abuf);
  const uint32_t t_s = piper::smem_addr(tbuf);
  int margin = margin0;
  for (int m = 0; m < br.n_dil; ++m) {
    const int d = br.dils[m];
    const int h1 = h2 * d;
    const int a1 = margin + h1;
    conv_stage_wgmma<K, kC, kTier, true>(a_s, tbuf, t, r, p, b1 + m * kC, br.k, d, h1, a1,
                                         W - 2 * a1, g0, lo, hi);
    __syncthreads();
    ring_refill<Wg<kC, kTier>::kTileBytes>(r, p);
    const int a2 = a1 + h2;
    conv_stage_wgmma<K, kC, kTier, false>(t_s, abuf, y, r, p, b2 + m * kC, br.k, 1, h2, a2,
                                          W - 2 * a2, g0, lo, hi);
    __syncthreads();
    ring_refill<Wg<kC, kTier>::kTileBytes>(r, p);
    margin = a2;
  }
}

template <bool kMean, bool kFolded, int kTier, typename TIO, int kC>
__device__ void wgmma_block(const Args& p) {
  using G = Wg<kC, kTier>;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const int W = p.width;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * p.tile;
  const int lo = p.bounds[2 * b];
  const int hi = p.bounds[2 * b + 1];
  const int n_out = min(p.tile, p.N - t0);
  TIO* out = static_cast<TIO*>(p.out) + (size_t)b * kC * p.N;
  if (t0 >= hi || t0 + p.tile <= lo) return zero_tile<kFolded>(p, out, t0, n_out);

  // Shared memory: the ring's slots from a 1024-byte boundary (the
  // swizzle is a function of the address bits), its barriers, then the
  // planes of act(y) and act(conv1).
  Ring r;
  const uint32_t raw = piper::smem_addr(wg_smem);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  r.depth = p.ring;
  r.chunk = p.chunk;
  r.slot_bytes = ring_slot_bytes(p.chunk, G::kTileBytes);
  r.slots = raw + pad;
  r.full = r.slots + p.ring * r.slot_bytes;
  r.empty = r.full + 8 * p.ring;
  bf16* abuf = reinterpret_cast<bf16*>(wg_smem + pad + p.ring * r.slot_bytes +
                                       ring_barrier_bytes(p.ring));
  bf16* tbuf = abuf + G::kPlanes * kC * (W + 1);
  r.total = 0;
  for (int bi = 0; bi < p.n_branches; ++bi)
    r.total += 2 * p.br[bi].n_dil * ((p.br[bi].k + p.chunk - 1) / p.chunk);
  r.next = r.issued = r.bi = r.m = r.conv = r.j = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < r.depth; ++i) {
      piper::mbar_init(r.full + 8 * i, 1);
      piper::mbar_init(r.empty + 8 * i, kWarps);
    }
    piper::mbar_init_fence();
  }
  __syncthreads();
  for (int i = 0; i < r.depth && i < r.total; ++i) ring_issue<G::kTileBytes>(r, p);

  const int g0 = t0 - p.halo;  // global sample index of window lane 0
  const TIO* x = static_cast<const TIO*>(p.x) + (size_t)b * kC * p.N;
  const int lane = threadIdx.x & 31;
  const int tig = lane & 3;
  const int row = 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int plane = kC * (W + 1);
  float y[G::kAcc], t[G::kAcc], mean[G::kAcc];  // mean: the MRF's branch sum
#pragma unroll
  for (int i = 0; i < G::kAcc; ++i) mean[i] = 0.f;
  for (int bi = 0; bi < p.n_branches; ++bi) {
    // The window: y = x on this thread's lanes, act(y) into abuf.
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int l = row + 8 * rr;
      const int g = g0 + l;
      const bool in = l < W && g >= 0 && g < p.N;
      const int at = l < W ? l : W;  // past the window: lane W
#pragma unroll
      for (int jj = 0; jj < kC / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          y[4 * jj + 2 * rr + e] = in ? load_f(x + offset<kFolded>(p, 8 * jj + 2 * tig + e, g))
                                      : 0.f;
        piper::store_split2<G::kPlanes>(abuf, plane, chunk_offset(W + 1, at, 8 * jj + 2 * tig),
                                        act(y[4 * jj + 2 * rr], g, lo, hi, p.slope),
                                        act(y[4 * jj + 2 * rr + 1], g, lo, hi, p.slope));
      }
    }
    piper::fence_async_shared();
    __syncthreads();
    const Branch& br = p.br[bi];
    const int margin0 = p.halo - br.halo;
    switch (br.k) {  // ResBlock1's kernel sizes; others take the runtime tap loop
      case 3:
        run_chain_wgmma_k<3, kC, kTier, TIO>(y, t, abuf, tbuf, r, br, p, margin0, g0, lo, hi);
        break;
      case 7:
        run_chain_wgmma_k<7, kC, kTier, TIO>(y, t, abuf, tbuf, r, br, p, margin0, g0, lo, hi);
        break;
      case 11:
        run_chain_wgmma_k<11, kC, kTier, TIO>(y, t, abuf, tbuf, r, br, p, margin0, g0, lo, hi);
        break;
      default:
        run_chain_wgmma_k<0, kC, kTier, TIO>(y, t, abuf, tbuf, r, br, p, margin0, g0, lo, hi);
        break;
    }
    if constexpr (kMean) {
#pragma unroll
      for (int i = 0; i < G::kAcc; ++i) mean[i] += y[i];
    }
  }

  const float inv = 1.f / p.n_branches;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int l = row + 8 * rr;
    if (l < p.halo || l >= p.halo + n_out) continue;
    const int g = g0 + l;
    const bool in = g >= lo && g < hi;
#pragma unroll
    for (int jj = 0; jj < kC / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * jj + 2 * rr + e;
        const float v = kMean ? mean[i] * inv : y[i];
        piper::store_f(out + offset<kFolded>(p, 8 * jj + 2 * tig + e, g), in ? v : 0.f);
      }
    }
  }
}

// kC is the wgmma stage's width (0 at "highest", which takes C at run time).
template <bool kMean, bool kFolded, int kTier, typename TIO, int kC>
__global__ void __launch_bounds__(kThreads, 1) resblock1_kernel(const Args p) {
  static_assert(std::is_same_v<TIO, float> || (kTier == 2 && !kFolded),
                "bf16 activations run the unfolded kernels at \"default\" only");
  if constexpr (kTier == 0) {
    tf32_block<kMean, kFolded>(p);
  } else {
    wgmma_block<kMean, kFolded, kTier, TIO, kC>(p);
  }
}

int branch_halo(int k, int n_dil, const int* dils) {
  int h = 0;
  for (int m = 0; m < n_dil; ++m) h += (k - 1) / 2 * dils[m] + (k - 1) / 2;
  return h;
}

template <bool kMean, bool kFolded, int kTier, typename TIO, int kC>
int start(const Args& a, int B, size_t smem, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(resblock1_kernel<kMean, kFolded, kTier, TIO, kC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.N + a.tile - 1) / a.tile, B);
  resblock1_kernel<kMean, kFolded, kTier, TIO, kC>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <bool kMean, bool kFolded, int kTier, typename TIO>
int start_wgmma(const Args& a, int B, size_t smem, int device, void* stream) {
  switch (a.C) {
    case 16: return start<kMean, kFolded, kTier, TIO, 16>(a, B, smem, device, stream);
    case 32: return start<kMean, kFolded, kTier, TIO, 32>(a, B, smem, device, stream);
    default: return start<kMean, kFolded, kTier, TIO, 64>(a, B, smem, device, stream);
  }
}

// bf16_io: x, out and the biases are bf16 (tier 2, unfolded only).
template <bool kMean, bool kFolded>
int launch(Args& a, int B, int tier, int bf16_io, int device, void* stream) {
  // Every tier runs on the tensor cores: C a multiple of 16; the wgmma
  // stage takes C = 16, 32 or 64, a window of at most 256 lanes and a ring
  // of 2 to kMaxRing slots of `chunk` taps each.
  if (a.C < 16 || a.C % 16 != 0 || tier < 0 || tier > 2 || a.n_branches < 1 ||
      (bf16_io && (tier != 2 || kFolded)) ||
      a.n_branches > kMaxBranches || a.tile < 1 || a.N < 1 || B < 1 || a.fold < 1)
    return (int)cudaErrorInvalidValue;
  a.halo = 0;
  for (int i = 0; i < a.n_branches; ++i) {
    Branch& br = a.br[i];
    if (br.n_dil < 1 || br.n_dil > kMaxDils || br.k < 1 || br.k % 2 == 0)
      return (int)cudaErrorInvalidValue;
    br.halo = branch_halo(br.k, br.n_dil, br.dils);
    if (br.halo > a.halo) a.halo = br.halo;
  }
  a.width = a.tile + 2 * a.halo;
  if (tier == 0) {
    // ybuf fp32 (C, W), act(y) and act(conv1) one fp32 plane each, and the
    // MRF's fp32 branch sum.
    const size_t smem = sizeof(float) * ((size_t)a.C * a.width +
                                         2 * (size_t)a.width * (a.C + Planes<0>::kPad) +
                                         (kMean ? (size_t)a.C * a.tile : 0));
    return start<kMean, kFolded, 0, float, 0>(a, B, smem, device, stream);
  }
  if ((a.C != 16 && a.C != 32 && a.C != 64) || a.width > kWindow || a.chunk < 1 ||
      a.ring < 2 || a.ring > kMaxRing)
    return (int)cudaErrorInvalidValue;
  // The ring's slots (after up to 1024 bytes of alignment) and barriers,
  // then act(y) and act(conv1) as the tier's bf16 planes (two at "high",
  // one at "default"), and a guard past them for the lanes a warpgroup
  // reads beyond the window (up to 256 - W + halo of them, 16 bytes each);
  // each chunk plane holds W + 1 lanes.
  const size_t planes = tier == 1 ? 2 : 1;
  const size_t slot = ring_slot_bytes(a.chunk, (int)planes * 2 * a.C * a.C);
  const size_t smem = 1024 + a.ring * slot + ring_barrier_bytes(a.ring) +
                      2 * planes * sizeof(bf16) * (a.width + 1) * a.C +
                      16 * (size_t)(kWindow - a.width + a.halo);
  if constexpr (!kFolded) {
    if (bf16_io) return start_wgmma<kMean, false, 2, bf16>(a, B, smem, device, stream);
  }
  return tier == 1 ? start_wgmma<kMean, kFolded, 1, float>(a, B, smem, device, stream)
                   : start_wgmma<kMean, kFolded, 2, float>(a, B, smem, device, stream);
}

// The per-branch arguments of the MRF entries into `a`.
int set_branches(Args& a, int n_branches, const void* const* w1, const void* const* b1,
                 const void* const* w2, const void* const* b2, const int* ks,
                 const int* n_dils, const int* dils) {
  if (n_branches < 1 || n_branches > kMaxBranches) return (int)cudaErrorInvalidValue;
  a.n_branches = n_branches;
  for (int i = 0; i < n_branches; ++i) {
    if (n_dils[i] < 1 || n_dils[i] > kMaxDils) return (int)cudaErrorInvalidValue;
    a.br[i] = Branch{w1[i], b1[i], w2[i], b2[i], ks[i], n_dils[i], 0, {0, 0, 0, 0}};
    for (int m = 0; m < n_dils[i]; ++m) a.br[i].dils[m] = dils[i * kMaxDils + m];
  }
  return 0;
}

}  // namespace

extern "C" {

const char* piper_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One ResBlock1 branch. Weights w1/w2 are 16-byte aligned and contiguous,
// in the layout of Branch for the tier; dils is a host array of M ints;
// bounds a device (B, 2) int32 array; tier 0/1/2 (tiers.cuh); ring and
// chunk the wgmma stage's weight slots and taps a slot holds (tiers 1 and
// 2). x, out, b1 and b2 are float,
// or bf16 when bf16_io is 1 (tier 2 only). Returns a cudaError_t code (0 on
// success).
int piper_resblock1_branch(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, int k, int n_dil, const int* dils,
                           const int* bounds, void* out, int B, int C, int N, int tile,
                           int ring, int chunk, float slope, int tier, int bf16_io,
                           int device, void* stream) {
  Args a = {};
  a.x = x;
  a.out = out;
  a.bounds = bounds;
  a.C = C;
  a.N = N;
  a.tile = tile;
  a.ring = ring;
  a.chunk = chunk;
  a.slope = slope;
  a.fold = 1;
  a.nq = N;
  a.n_branches = 1;
  if (n_dil < 1 || n_dil > kMaxDils) return (int)cudaErrorInvalidValue;
  a.br[0] = Branch{w1, b1, w2, b2, k, n_dil, 0, {0, 0, 0, 0}};
  for (int m = 0; m < n_dil; ++m) a.br[0].dils[m] = dils[m];
  return launch<false, false>(a, B, tier, bf16_io, device, stream);
}

// Every branch of the multi-receptive-field stage and their mean. Per-branch
// arguments are host arrays of length n_branches (device pointers for the
// weights); dils is a host array of n_branches * 4 ints (row i holds branch
// i's n_dils[i] dilations); ring, chunk and bf16_io as for the branch
// entry.
int piper_resblock1_mrf(const void* x, int n_branches, const void* const* w1,
                        const void* const* b1, const void* const* w2,
                        const void* const* b2, const int* ks, const int* n_dils,
                        const int* dils, const int* bounds, void* out, int B, int C,
                        int N, int tile, int ring, int chunk, float slope, int tier,
                        int bf16_io, int device, void* stream) {
  Args a = {};
  a.x = x;
  a.out = out;
  a.bounds = bounds;
  a.C = C;
  a.N = N;
  a.tile = tile;
  a.ring = ring;
  a.chunk = chunk;
  a.slope = slope;
  a.fold = 1;
  a.nq = N;
  const int e = set_branches(a, n_branches, w1, b1, w2, b2, ks, n_dils, dils);
  return e ? e : launch<true, false>(a, B, tier, bf16_io, device, stream);
}

// The MRF stage on the folded layout: x and out are (B, fold*C, nq), the
// time axis of N = fold*nq samples folded into rows (zero-padded past the
// true length, which bounds must not exceed). Otherwise as
// piper_resblock1_mrf; the tile counts samples, not lanes. fp32 only.
int piper_resblock1_mrf_folded(const float* x, int n_branches, const void* const* w1,
                               const void* const* b1, const void* const* w2,
                               const void* const* b2, const int* ks, const int* n_dils,
                               const int* dils, const int* bounds, float* out, int B,
                               int C, int nq, int fold, int tile, int ring, int chunk,
                               float slope, int tier, int device, void* stream) {
  if (fold < 1 || nq < 1) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = x;
  a.out = out;
  a.bounds = bounds;
  a.C = C;
  a.N = fold * nq;
  a.tile = tile;
  a.ring = ring;
  a.chunk = chunk;
  a.slope = slope;
  a.fold = fold;
  a.nq = nq;
  const int e = set_branches(a, n_branches, w1, b1, w2, b2, ks, n_dils, dils);
  return e ? e : launch<true, true>(a, B, tier, 0, device, stream);
}

}  // extern "C"
