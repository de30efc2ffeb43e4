// The ResBlock1 kernels' stage, shared by resblock1.cu (the bf16 tiers and
// the C entries) and resblock1_highest.cu ("highest"), which nvcc compiles
// side by side; resblock1.cu's header says what the kernels compute and how
// they are laid out.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tiers.cuh"
#include "wgmma.cuh"

namespace piper_rb {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBranches = 4;
constexpr int kMaxDils = 4;
constexpr int kWindow = 4 * 64;  // the stage's lanes: 64 per warpgroup
constexpr int kMaxRing = 8;

using piper::bf16;
using piper::load_f;

struct Branch {
  // wgmma's B image (M, K, P, C, C) per (conv, tap): P = 2 planes (hi, lo)
  // bf16 at "high", 1 at "default", 2 (big, small) fp32 at "highest"
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
  int ring, chunk;     // the weight slots, and taps a slot holds
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

// Every thread of the block meets here, as at __syncthreads, with its
// memory ordering; but the threads may arrive at different instructions
// (barrier.sync is not .aligned, where __syncthreads' bar.sync is), and it
// is barrier 1, apart from __syncthreads' barrier 0.
__device__ __forceinline__ void block_barrier() {
  asm volatile("barrier.sync 1, %0;\n" ::"n"(kThreads) : "memory");
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

// The widest swizzle atom, 128, 64 or 32 bytes of each row, that divides
// a weight row of `row` bytes (wgmma.cuh).
__host__ __device__ constexpr int atom_row_bytes(int row) {
  return row % 128 == 0 ? 128 : row % 64 == 0 ? 64 : 32;
}

// Bytes of one tap's weight image at C channels: bf16 hi and lo at "high",
// bf16 at "default", tf32 big and small (fp32 words) at "highest".
__host__ __device__ constexpr int tap_bytes(int c, int tier) {
  return (tier == 2 ? 1 : 2) * (tier == 0 ? 4 : 2) * c * c;
}

// The ring's units a tap: one, or where a tap's image passes 32 KB (at
// "highest" past C = 64: 51-128 KB; K1's "high" past C = 80) each swizzle
// atom of the tap with both its planes, so that two slots fit beside the
// window.
__host__ __device__ constexpr int tap_units(int c, int tier) {
  const int row = (tier == 0 ? 4 : 2) * c;  // bytes of one weight row
  return tap_bytes(c, tier) > 32768 ? row / atom_row_bytes(row) : 1;
}

// act(y) and act(conv1) share one buffer, overwritten in place: at
// "highest" from C = 48, where two buffers of tf32 planes do not fit
// beside a ring of taps.
__host__ __device__ constexpr bool in_place(int c, int tier) { return tier == 0 && c >= 48; }

// Sizes of the stage at C channels and tier kTier. A buffer of
// activations is kPlanes planes of TA (bf16 hi, and lo at "high"; fp32 tf32
// big and small at "highest"), each C/kChunk chunk planes of W + 1 lanes x
// kChunk channels (16 bytes): (plane, lane l, channel c) at element plane *
// C * (W + 1) + (c / kChunk) * kChunk * (W + 1) + kChunk * l + c % kChunk.
// Lane W takes the stores of lanes outside a stage, so no store is a
// branch. One product covers kKStep input channels (32 bytes of K); a tap's
// weights are kPlanes planes too (hi and lo, big and small), plane by
// plane, each all its swizzle atoms; where the ring's unit is one atom
// (tap_units: a tap's image past 32 KB), atom by atom, each both its planes.
// K1 (conv1d.cuh) runs one conv of this stage's sizes at every multiple of
// 16 up to 128.
template <int kC, int kTier>
struct Wg {
  using TA = std::conditional_t<kTier == 0, float, bf16>;
  static constexpr int kElem = sizeof(TA);
  static constexpr bool kInPlace = in_place(kC, kTier);
  static constexpr int kChunk = 16 / kElem;                  // channels a 16-byte chunk
  static constexpr int kKStep = 32 / kElem;                  // input channels a product
  static constexpr int kSteps = kC / kKStep;                 // products a tap and pass
  static constexpr int kPlanes = kTier == 2 ? 1 : 2;         // planes a buffer and a tap
  static constexpr int kRowBytes = atom_row_bytes(kC * kElem);  // one atom's rows
  static constexpr int kAtomSteps = kRowBytes / 32;          // products an atom
  static constexpr int kAtoms = kC * kElem / kRowBytes;      // atoms a row
  static constexpr int kAtomBytes = kC * kRowBytes;          // one atom of one plane
  static constexpr int kTileBytes = kPlanes * kElem * kC * kC;  // one tap's B image
  static constexpr int kUnits = tap_units(kC, kTier);        // the ring's units a tap
  static constexpr int kUnitBytes = kTileBytes / kUnits;
  static constexpr int kUnitSteps = kSteps / kUnits;         // products a unit and pass
  static constexpr int kPlaneStride = kUnits > 1 ? kAtomBytes : kAtoms * kAtomBytes;
  static constexpr int kAtomStride = kUnits > 1 ? kPlanes * kAtomBytes : kAtomBytes;
  static constexpr int kAcc = kC / 2;                        // D registers a thread

  // Offset in a unit of product step s's plane-0 B tile: 32 bytes along
  // the rows within an atom, the next atom every kAtomSteps; plane 1's is
  // kPlaneStride further.
  static __device__ __forceinline__ uint32_t b_offset(int s) {
    return (s / kAtomSteps) * kAtomStride + (s % kAtomSteps) * 32;
  }

  // The product, D += A x B by descriptor: tf32 m64nCk8 or bf16 m64nCk16.
  using Mma = std::conditional_t<kTier == 0, piper::WgmmaTf32<kC>, piper::Wgmma<kC>>;

  // v0, v1 (channels c and c + 1, c even, of lane l) into a buffer's planes.
  static __device__ __forceinline__ void store2(TA* planes, int lanes, int l, int c, float v0,
                                                float v1) {
    const int off = (c / kChunk) * kChunk * lanes + kChunk * l + c % kChunk;
    if constexpr (kTier == 0) {
      piper::store_tf32_split2(planes, kC * lanes, off, v0, v1);
    } else {
      piper::store_split2<kPlanes>(planes, kC * lanes, off, v0, v1);
    }
  }
};

// Shared bytes of the ring's mbarriers (full and empty per slot), rounded
// to 128 so the planes after them stay aligned.
__host__ __device__ constexpr int ring_barrier_bytes(int ring) {
  return (16 * ring + 127) / 128 * 128;
}

// Bytes of one ring slot: `chunk` units (taps, or atoms of a tap:
// tap_units), rounded up to 1024 (the swizzle's alignment).
__host__ __device__ constexpr int ring_slot_bytes(int chunk, int unit_bytes) {
  return (chunk * unit_bytes + 1023) / 1024 * 1024;
}

// The ring of weight chunks in shared memory: a chunk is up to `chunk`
// consecutive units of one conv, one bulk copy (a conv's taps, and a tap's
// units, are contiguous in its image). Every thread walks the same
// sequence of chunks (per branch, per dilation: conv1's, then conv2's) and
// keeps `next`, the index of the next chunk it consumes, and the cursor of
// the next to issue.
struct Ring {
  uint32_t slots, full, empty;  // shared addresses: slot 0, full[0], empty[0]
  int depth, slot_bytes, chunk, total, next;
  int issued, bi, m, conv, j;   // the next chunk to issue: branch, dilation, conv, first unit
};

// Every thread: chunk `issued` goes into slot issued % depth (thread 0
// issues the copy), and the cursor moves on. G is the stage's Wg.
template <class G>
__device__ __forceinline__ void ring_issue(Ring& r, const Args& p) {
  const Branch& br = p.br[r.bi];
  const char* w = static_cast<const char*>(r.conv ? br.w2 : br.w1);
  const int slot = r.issued % r.depth;
  const int units = br.k * G::kUnits;
  const int n = min(r.chunk, units - r.j);
  piper::bulk_copy_if(threadIdx.x == 0, r.slots + slot * r.slot_bytes,
                      w + ((size_t)r.m * units + r.j) * G::kUnitBytes, n * G::kUnitBytes,
                      r.full + 8 * slot);
  ++r.issued;
  r.j += n;
  if (r.j == units) {
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
template <class G>
__device__ __forceinline__ void ring_release(Ring& r, int i, const Args& p) {
  ring_arrive(r, i);
  if (r.issued < r.total) {
    piper::mbar_wait(r.empty + 8 * (i % r.depth), (i / r.depth) & 1);
    ring_issue<G>(r, p);
  }
}

// After a __syncthreads that follows every warp's ring_arrive of a stage's
// last chunk: that slot takes the next chunk, with no wait on its barrier.
template <class G>
__device__ __forceinline__ void ring_refill(Ring& r, const Args& p) {
  if (r.issued < r.total) ring_issue<G>(r, p);
}

// One conv of the chain: output lanes [a, a + width) of the window read
// input lanes l - h + j*step, j < K (K == 0: k_rt taps at run time). src is
// the stage input's planes, dst the output's (the same buffer in place). d
// is the accumulator in the D layout: kConv1, it starts at 0 and dst gets
// act(conv + bias). Otherwise y is the residual, and dst gets act(new y):
// at "high" and "default" d is y itself, which gets the conv and then the
// bias added; at "highest" d (conv1's accumulator, free by then) starts at
// 0 and y += conv + bias after the products, so no k-step's rounding
// scales with |y| (264 of them a conv at C=64, k=11). TB is the bias type. Per
// chunk of units, the warpgroup's products over its taps, their k-steps and
// passes go out as one group; once the chunk before has completed, its
// slot is released; the last chunk's slot is refilled by the caller after
// the stage's __syncthreads. A warpgroup with no output lane in the stage
// passes the chunks on and returns; in place, it first meets the others at
// the barrier before their epilogue (block_barrier: one not aligned, since
// the two arrive from different places in the code).
template <int K, int kC, int kTier, bool kConv1, typename TB>
__device__ __forceinline__ void conv_stage_wgmma(
    const typename Wg<kC, kTier>::TA* src, typename Wg<kC, kTier>::TA* dst,
    float (&d)[Wg<kC, kTier>::kAcc], float (&y)[Wg<kC, kTier>::kAcc], Ring& r, const Args& p,
    const TB* __restrict__ bias, int k_rt, int step, int h, int a, int width, int g0, int lo,
    int hi) {
  using G = Wg<kC, kTier>;
  constexpr bool kFromZero = kConv1 || kTier == 0;  // d's sum starts at 0
  constexpr bool kResidual = !kConv1 && kTier == 0;  // then y += d
  const int units = (K > 0 ? K : k_rt) * G::kUnits;
  const int chunks = (units + r.chunk - 1) / r.chunk;
  const int first = r.next;
  r.next += chunks;
  // This warpgroup's first window lane, warp-uniform as the compiler sees it
  // (wgmma's descriptors live in uniform registers).
  const int row0 = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0) * 64;
  if (row0 >= a + width || row0 + 64 <= a) {  // no output lane here: pass the chunks on
    for (int c = 0; c < chunks; ++c) {
      ring_wait(r, first + c);
      if (c + 1 < chunks) {
        ring_release<G>(r, first + c, p);
      } else {
        ring_arrive(r, first + c);
      }
    }
    if constexpr (G::kInPlace) block_barrier();  // the active warpgroups' reads of src
    return;
  }
  const int W = p.width;
  const int Wp = W + 1;  // lanes a chunk plane
  const int lane = threadIdx.x & 31;
  const int tig = lane & 3;
  const int warp = (threadIdx.x >> 5) & 3;
  // The bias is added after the products, so its loads run under them:
  // a sum from 0 skips its first product's accumulate.
  float bv[kC / 4];
#pragma unroll
  for (int jj = 0; jj < kC / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[2 * jj + e] = load_f(bias + 8 * jj + 2 * tig + e);
  }
  piper::fence_regs(d);
  // A of tap j: the 64 input lanes from row0 - h + j*step (lanes outside
  // the stage read neighbouring memory; their rows are not stored), 16(W +
  // 1) bytes per chunk of channels.
  const uint32_t lbo = 16u * Wp;
  const uint32_t plane_bytes = (uint32_t)kC * Wp * G::kElem;
  const uint32_t a0 = piper::smem_addr(src) + (uint32_t)((row0 - h) * 16);
  for (int c = 0; c < chunks; ++c) {
    const int u0 = c * r.chunk;
    const int u1 = min(u0 + r.chunk, units);
    const uint32_t slot = r.slots + ((first + c) % r.depth) * r.slot_bytes;
    ring_wait(r, first + c);
    piper::wgmma_fence();
    for (int u = u0; u < u1; ++u) {
      const int j = u / G::kUnits;  // the unit's tap, and its first k-step
      const int s0 = (u - j * G::kUnits) * G::kUnitSteps;
      const uint32_t tile = slot + (u - u0) * G::kUnitBytes;
      const uint32_t at = a0 + (uint32_t)(j * step * 16);
#pragma unroll
      for (int s = 0; s < G::kUnitSteps; ++s) {
        const uint32_t ak = at + 2 * (s0 + s) * lbo;
        const uint64_t ahi = piper::a_desc(ak, lbo);
        const uint32_t wt = tile + G::b_offset(s);
        const uint64_t whi = piper::b_desc<G::kRowBytes>(wt);
        // a sum from 0: the first product overwrites d
        G::Mma::mma(d, ahi, whi, !kFromZero || u > 0 || s > 0);  // v_hi w_hi (v_big w_big)
        if constexpr (G::kPlanes == 2) {
          G::Mma::mma(d, piper::a_desc(ak + plane_bytes, lbo), whi);  // v_lo w_hi
          G::Mma::mma(d, ahi, piper::b_desc<G::kRowBytes>(wt + G::kPlaneStride));  // v_hi w_lo
        }
      }
    }
    piper::wgmma_commit();
    piper::wgmma_wait<1>();
    if (c > 0) ring_release<G>(r, first + c - 1, p);
  }
  piper::wgmma_wait<0>();
  piper::fence_regs(d);
  ring_arrive(r, first + chunks - 1);  // refilled after the stage's __syncthreads
  if constexpr (G::kInPlace) block_barrier();  // every warpgroup has read src (== dst)
  // The D layout: d[4jj + 2rr + e] is window lane row0 + 16 * warp + gid +
  // 8rr, channel 8jj + 2tig + e.
#pragma unroll
  for (int jj = 0; jj < kC / 8; ++jj) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d[4 * jj + i] += bv[2 * jj + (i & 1)];
      if constexpr (kResidual) y[4 * jj + i] += d[4 * jj + i];
    }
  }
  float (&v)[G::kAcc] = kResidual ? y : d;  // what act() is taken of
  const int row = row0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int l = row + 8 * rr;
    const int at = (l >= a && l < a + width) ? l : W;  // outside the stage: lane W
    const int g = g0 + l;
#pragma unroll
    for (int jj = 0; jj < kC / 8; ++jj) {
      G::store2(dst, Wp, at, 8 * jj + 2 * tig, act(v[4 * jj + 2 * rr], g, lo, hi, p.slope),
                act(v[4 * jj + 2 * rr + 1], g, lo, hi, p.slope));
    }
  }
  piper::fence_async_shared();  // the next stage's wgmma reads dst
}

// The branch chain on y (registers, the D layout): abuf holds act(y), tbuf
// act(conv1) (the same buffer in place), as the tier's planes; t is conv1's
// accumulator. `margin0` is the margin already consumed on each side: 0
// when the window halo equals this branch's receptive field, more for a
// narrower MRF branch.
template <int K, int kC, int kTier, typename TIO>
__device__ __forceinline__ void run_chain_wgmma_k(
    float (&y)[Wg<kC, kTier>::kAcc], float (&t)[Wg<kC, kTier>::kAcc],
    typename Wg<kC, kTier>::TA* abuf, typename Wg<kC, kTier>::TA* tbuf, Ring& r,
    const Branch& br, const Args& p, int margin0, int g0, int lo, int hi) {
  using G = Wg<kC, kTier>;
  const int W = p.width;
  const int h2 = (br.k - 1) / 2;
  const TIO* b1 = static_cast<const TIO*>(br.b1);
  const TIO* b2 = static_cast<const TIO*>(br.b2);
  int margin = margin0;
  for (int m = 0; m < br.n_dil; ++m) {
    const int d = br.dils[m];
    const int h1 = h2 * d;
    const int a1 = margin + h1;
    conv_stage_wgmma<K, kC, kTier, true>(abuf, tbuf, t, y, r, p, b1 + m * kC, br.k, d, h1, a1,
                                         W - 2 * a1, g0, lo, hi);
    __syncthreads();
    ring_refill<G>(r, p);
    const int a2 = a1 + h2;
    // conv2 sums into y at "high"/"default", into t and then y at "highest"
    conv_stage_wgmma<K, kC, kTier, false>(tbuf, abuf, kTier == 0 ? t : y, y, r, p,
                                          b2 + m * kC, br.k, 1, h2, a2, W - 2 * a2, g0, lo, hi);
    __syncthreads();
    ring_refill<G>(r, p);
    margin = a2;
  }
}

template <bool kMean, bool kFolded, int kTier, typename TIO, int kC>
__device__ void wgmma_block(const Args& p) {
  using G = Wg<kC, kTier>;
  using TA = typename G::TA;
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
  r.slot_bytes = ring_slot_bytes(p.chunk, G::kUnitBytes);
  r.slots = raw + pad;
  r.full = r.slots + p.ring * r.slot_bytes;
  r.empty = r.full + 8 * p.ring;
  TA* abuf = reinterpret_cast<TA*>(wg_smem + pad + p.ring * r.slot_bytes +
                                   ring_barrier_bytes(p.ring));
  TA* tbuf = G::kInPlace ? abuf : abuf + G::kPlanes * kC * (W + 1);
  r.total = 0;
  for (int bi = 0; bi < p.n_branches; ++bi)
    r.total += 2 * p.br[bi].n_dil * ((p.br[bi].k * G::kUnits + p.chunk - 1) / p.chunk);
  r.next = r.issued = r.bi = r.m = r.conv = r.j = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < r.depth; ++i) {
      piper::mbar_init(r.full + 8 * i, 1);
      piper::mbar_init(r.empty + 8 * i, kWarps);
    }
    piper::mbar_init_fence();
  }
  __syncthreads();
  for (int i = 0; i < r.depth && i < r.total; ++i) ring_issue<G>(r, p);

  const int g0 = t0 - p.halo;  // global sample index of window lane 0
  const TIO* x = static_cast<const TIO*>(p.x) + (size_t)b * kC * p.N;
  const int lane = threadIdx.x & 31;
  const int tig = lane & 3;
  const int row = 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
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
        G::store2(abuf, W + 1, at, 8 * jj + 2 * tig, act(y[4 * jj + 2 * rr], g, lo, hi, p.slope),
                  act(y[4 * jj + 2 * rr + 1], g, lo, hi, p.slope));
      }
    }
    piper::fence_async_shared();
    __syncthreads();
    const Branch& br = p.br[bi];
    const int margin0 = p.halo - br.halo;
    switch (br.k) {  // ResBlock1's kernel sizes; others take the runtime tap loop
      case 3:
        run_chain_wgmma_k<3, kC, kTier, TIO>(y, t, abuf, tbuf, r, br, p, margin0, g0, lo,
                                                    hi);
        break;
      case 7:
        run_chain_wgmma_k<7, kC, kTier, TIO>(y, t, abuf, tbuf, r, br, p, margin0, g0, lo,
                                                    hi);
        break;
      case 11:
        run_chain_wgmma_k<11, kC, kTier, TIO>(y, t, abuf, tbuf, r, br, p, margin0, g0,
                                                     lo, hi);
        break;
      default:
        run_chain_wgmma_k<0, kC, kTier, TIO>(y, t, abuf, tbuf, r, br, p, margin0, g0, lo,
                                                    hi);
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

template <bool kMean, bool kFolded, int kTier, typename TIO, int kC>
__global__ void __launch_bounds__(kThreads, 1) resblock1_kernel(const Args p) {
  static_assert(std::is_same_v<TIO, float> || (kTier == 2 && !kFolded),
                "bf16 activations run the unfolded kernels at \"default\" only");
  wgmma_block<kMean, kFolded, kTier, TIO, kC>(p);
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

// The launch of a checked `a` at C = 16, 32 or 64, the widths of every tier.
template <bool kMean, bool kFolded, int kTier, typename TIO>
int start_wgmma(const Args& a, int B, size_t smem, int device, void* stream) {
  switch (a.C) {
    case 16: return start<kMean, kFolded, kTier, TIO, 16>(a, B, smem, device, stream);
    case 32: return start<kMean, kFolded, kTier, TIO, 32>(a, B, smem, device, stream);
    default: return start<kMean, kFolded, kTier, TIO, 64>(a, B, smem, device, stream);
  }
}

// "highest": the launch of a checked `a` at C = 16, 32 or 64
// (resblock1_highest.cu) and at the other multiples of 16 below 128, 48,
// 80, 96 and 112, which no preset voice has (resblock1_highest_other.cu).
template <bool kMean, bool kFolded>
int start_highest(const Args& a, int B, size_t smem, int device, void* stream);
template <bool kMean, bool kFolded>
int start_highest_other(const Args& a, int B, size_t smem, int device, void* stream);

}  // namespace piper_rb
