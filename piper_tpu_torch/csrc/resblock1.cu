// HiFi-GAN ResBlock1 kernels for Hopper (sm_90a): fp32 sums, the convs'
// products on the tensor cores at every tier, 3xTF32 at "highest" and bf16
// at "high" and "default".
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
// "highest", the same rate as six bf16 passes; 67 in fp32 on CUDA cores,
// which no tier uses here) plus the halo recompute.
//
// Design: one block of 512 threads per (output tile of `tile` samples, row).
// The block loads the tile's haloed window [t0 - halo, t0 + tile + halo)
// once into shared memory and walks the whole chain there, so the
// activation crosses device memory once in and once out (the MRF kernel
// reloads the window from L2 for each branch). Three buffers over the
// window: the raw residual y (fp32, (C, W)), act(y) (written by each conv2
// beside the residual, so conv1 reads its input as is) and act(conv1). The
// valid region shrinks stage by stage exactly as _run_branch_chain shrinks
// it; a narrower MRF branch starts with the margin it does not need
// already consumed. The window is about 2x the tile at the widest halo (60
// samples per side for k=11, dilations 1/3/5); the wrapper takes the
// largest tile whose window fits one pass of the block: measured on CUDA
// cores, a smaller tile that fills more SMs loses more to the halo it
// recomputes. Weights stay in global memory (one k=11 branch at C=64 is
// ~1 MB in fp32), read through L1. Tiles wholly outside [lo, hi) write
// zeros and skip all work.
//
// The conv stage (conv_stage_mma): each conv is a GEMM on the tensor
// cores, M = C_out, K = C_in x taps, N = the stage's lanes; the TPU
// kernel's im2col buffer is implicit, as the tap's lane offset. A warp owns
// all (at most 4) m-tiles of C_out by 2 n-tiles of 8 lanes, so each A
// fragment it loads feeds 2-6 mma; its accumulators start at the bias, and
// its epilogue adds the residual and applies the mask and the leaky ReLU in
// fp32. Lanes past a stage's width are computed on clamped lanes and
// discarded. C must be a multiple of 16 (m16). The weights are laid out on
// the host in mma's A-fragment order, one 16-byte load per lane, m-tile
// and plane. act(y) and act(conv1) are lane-major planes, [lane][channel],
// so the B fragment is a row per lane and the tap shift is a row offset;
// the window load and each conv's epilogue write them.
//   "high"/"default": one mma.sync.m16n8k16 (bf16 in, fp32 sums) per (16
//   output channels, 8 lanes, tap, 16 input channels). A bf16 product is
//   exact in fp32, so "high" is three mma per step into one accumulator,
//   (w_hi, v_hi) + (w_hi, v_lo) + (w_lo, v_hi), and "default" one, (bf16(w),
//   bf16(v)): mxu_dot's passes, summed in another order. The operands are
//   split into bf16 parts where they are written (the weights on the host,
//   the activations by store_split), as planes (hi, and lo at "high") with
//   a row stride of C + 8 bf16, so the B fragment of 8 lanes x 16 channels
//   is one ldmatrix with no transpose and its eight 16-byte rows fall on
//   distinct banks.
//   "highest": 3xTF32, two mma.sync.m16n8k8 steps (tf32 in, fp32 sums) per
//   16 input channels, each three mma into one accumulator, (w_big, v_big)
//   + (w_big, v_small) + (w_small, v_big). The weights' big and small parts
//   are split on the host; the activations stay one fp32 plane per buffer,
//   with a row stride of C + 4 words, and are split on read (tf32 operands
//   are fp32 registers, so ldmatrix does not apply): the B fragment is two
//   32-bit loads per thread, (lane gid, channel tig) and (gid, tig + 4),
//   which the stride puts on 32 distinct banks for C = 16, 32 and 64. Split
//   bf16 planes of the same accuracy (six passes at the same rate) would
//   need 278 KB at K2's widest shape (C=64, halo 60, tile 128); one fp32
//   plane per buffer needs 198 KB and keeps the tile.
//
// bf16 activations (the runtime's "bfloat16" mode, at "default" only): the
// branch and MRF kernels also take x, out and the biases as bf16 (a
// template parameter, TIO), read into fp32 where they are loaded and
// rounded to bf16 where the output is stored. Inside the block nothing
// changes: the residual is fp32 and act(y), act(conv1) the same bf16
// planes as at "default" on fp32 input, so the kernel on bf16 x equals the
// fp32-input kernel on the same (bf16-valued) x with its output rounded to
// bf16. The weights' fragments are bf16 at "default" either way.
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

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNT = 2;  // 8-lane n-tiles per warp work item
constexpr int kMaxBranches = 4;
constexpr int kMaxDils = 4;

using piper::bf16;
using piper::ldmatrix_x4;
using piper::load_f;
using piper::mma_bf16;
using piper::Planes;
using piper::store_act;

struct Branch {
  // A fragments (ops/kernels/resblock.py::_kernel_weights). "highest": tf32
  // (2, M, K, C_in/8, C_out/16, 32 lanes, 4), planes (big, small).
  // "high"/"default": bf16 (P, M, K, C_in/16, C_out/16, 32 lanes, 8), P = 2
  // planes (hi, lo) at "high" and 1 at "default".
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

// One conv of the chain over a window of `W` lanes, on the tensor cores at
// tier kTier. Output lane l in [a, a + width) reads input lanes
// l - h + j*step, j < K (K > 0 is a compile-time tap count, so the tap loop
// unrolls; K == 0 reads k_rt). src and dst are the tier's planes (plane =
// W * (C + kPad) elements; the second after the first); w points at this
// conv's A fragments in the first plane, and the second is w_lo uint4s on.
// kConv1: store act(conv) into dst. Otherwise add the conv into the fp32
// residual ybuf ((C, W)) and store act(new residual) into dst. The bias
// is float or bf16 (TB).
template <int K, int kTier, int kMT, bool kConv1, typename TB>
__device__ void conv_stage_mma(const typename Planes<kTier>::T* __restrict__ src,
                               float* __restrict__ ybuf,
                               typename Planes<kTier>::T* __restrict__ dst,
                               const uint4* __restrict__ w, size_t w_lo,
                               const TB* __restrict__ bias, int C, int W, int k_rt,
                               int step, int h, int a, int width, float slope, int g0, int lo,
                               int hi) {
  constexpr int kPasses = kTier == 2 ? 1 : 3;
  const int taps = K > 0 ? K : k_rt;
  const int S = C + Planes<kTier>::kPad;
  const int plane = W * S;
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
    // are discarded below.
    if constexpr (kTier == 0) {
      // This thread's B rows: lane gid of each n-tile, channels tig and
      // tig + 4 of each k-chunk of 8, split on read.
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
    } else {
      // This thread's ldmatrix row: lane `lane & 7` of n-tile `lane >> 4`,
      // channels +0 (matrices 0 and 2) or +8 (1 and 3) of the k-chunk.
      const int mrow = (lane & 7) + (lane >> 4) * 8;
      const int mcol = ((lane >> 3) & 1) * 8;
      const bf16* bsrc = src + (size_t)(first + min(n0 + mrow, width - 1)) * S + mcol;
      for (int kc = 0; kc < n16; ++kc) {
#pragma unroll
        for (int j = 0; j < taps; ++j) {
          const bf16* bp = bsrc + j * step * S + kc * 16;
          uint32_t bh[4], bl[4];
          ldmatrix_x4(bh, bp);
          if (kPasses == 3) ldmatrix_x4(bl, bp + plane);
          const uint4* wp = w + (((size_t)j * n16 + kc) * n16 + mt0) * 32 + lane;
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            const uint4 ah = __ldg(wp + mt * 32);
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[mt][nt], ah, bh[2 * nt], bh[2 * nt + 1]);
            if (kPasses == 3) {
              const uint4 al = __ldg(wp + w_lo + mt * 32);
#pragma unroll
              for (int nt = 0; nt < kNT; ++nt) {
                mma_bf16(acc[mt][nt], ah, bl[2 * nt], bl[2 * nt + 1]);
                mma_bf16(acc[mt][nt], al, bh[2 * nt], bh[2 * nt + 1]);
              }
            }
          }
        }
      }
    }
    // The accumulator fragment (m16n8k16 and m16n8k8 alike): element 2r + e
    // of acc[mt][nt] is output channel (mt0 + mt) * 16 + gid + 8r at stage
    // lane n0 + nt*8 + 2*tig + e.
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
              store_act<kTier>(dst, plane, l * S + co, act(v, g, lo, hi, slope));
            } else {
              const int idx = co * W + l;
              const float y = ybuf[idx] + v;
              ybuf[idx] = y;
              store_act<kTier>(dst, plane, l * S + co, act(y, g, lo, hi, slope));
            }
          }
        }
      }
    }
  }
}

// The branch chain, in place on ybuf (abuf holds act(y), tbuf act(conv1),
// as the tier's planes). `margin0` is the margin already consumed on each
// side: 0 when the window halo equals this branch's receptive field, more
// for a narrower MRF branch. On return ybuf is exact on
// [margin0 + br.halo, W - margin0 - br.halo). TIO is the biases' type.
template <int K, int kTier, int kMT, typename TIO>
__device__ void run_chain_k(float* ybuf, typename Planes<kTier>::T* abuf,
                            typename Planes<kTier>::T* tbuf, const Branch& br, const Args& p,
                            int margin0, int g0, int lo, int hi) {
  const int C = p.C;
  const int W = p.width;
  const int h2 = (br.k - 1) / 2;
  // uint4s of one conv's first plane: 4 tf32 or 8 bf16 values each
  const size_t wstride = (size_t)C * C * br.k / (kTier == 0 ? 4 : 8);
  const size_t w_lo = wstride * br.n_dil;
  const uint4* w1 = static_cast<const uint4*>(br.w1);
  const uint4* w2 = static_cast<const uint4*>(br.w2);
  const TIO* b1 = static_cast<const TIO*>(br.b1);
  const TIO* b2 = static_cast<const TIO*>(br.b2);
  int margin = margin0;
  for (int m = 0; m < br.n_dil; ++m) {
    const int d = br.dils[m];
    const int h1 = h2 * d;
    const int a1 = margin + h1;
    conv_stage_mma<K, kTier, kMT, true>(abuf, ybuf, tbuf, w1 + m * wstride, w_lo,
                                        b1 + m * C, C, W, br.k, d, h1, a1, W - 2 * a1,
                                        p.slope, g0, lo, hi);
    __syncthreads();
    const int a2 = a1 + h2;
    conv_stage_mma<K, kTier, kMT, false>(tbuf, ybuf, abuf, w2 + m * wstride, w_lo,
                                         b2 + m * C, C, W, br.k, 1, h2, a2, W - 2 * a2,
                                         p.slope, g0, lo, hi);
    __syncthreads();
    margin = a2;
  }
}

template <int kTier, int kMT, typename TIO>
__device__ void run_chain_mt(float* ybuf, typename Planes<kTier>::T* abuf,
                             typename Planes<kTier>::T* tbuf, const Branch& br, const Args& p,
                             int margin0, int g0, int lo, int hi) {
  switch (br.k) {  // ResBlock1's kernel sizes; others (k = 5 in tests) take the runtime loop
    case 3: run_chain_k<3, kTier, kMT, TIO>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi); break;
    case 7: run_chain_k<7, kTier, kMT, TIO>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi); break;
    case 11: run_chain_k<11, kTier, kMT, TIO>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi); break;
    default: run_chain_k<0, kTier, kMT, TIO>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi); break;
  }
}

// m-tiles per warp work item: 4 when C/16 allows (C = 64), else 2, else 1.
template <int kTier, typename TIO>
__device__ void run_chain(float* ybuf, typename Planes<kTier>::T* abuf,
                          typename Planes<kTier>::T* tbuf, const Branch& br, const Args& p,
                          int margin0, int g0, int lo, int hi) {
  const int n16 = p.C / 16;
  if (n16 % 4 == 0) {
    run_chain_mt<kTier, 4, TIO>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi);
  } else if (n16 % 2 == 0) {
    run_chain_mt<kTier, 2, TIO>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi);
  } else {
    run_chain_mt<kTier, 1, TIO>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi);
  }
}

template <bool kMean, bool kFolded, int kTier, typename TIO>
__global__ void __launch_bounds__(kThreads, 1) resblock1_kernel(const Args p) {
  static_assert(std::is_same_v<TIO, float> || (kTier == 2 && !kFolded),
                "bf16 activations run the unfolded kernels at \"default\" only");
  extern __shared__ __align__(16) float smem[];
  using T = typename Planes<kTier>::T;
  const int C = p.C;
  const int W = p.width;
  const int S = C + Planes<kTier>::kPad;
  const int plane = W * S;
  float* ybuf = smem;                                  // (C, W) raw residual y
  T* abuf = reinterpret_cast<T*>(smem + C * W);        // act(y), lane-major planes
  T* tbuf = abuf + Planes<kTier>::kCount * plane;      // act(conv1 output), the same
  float* acc = reinterpret_cast<float*>(tbuf + Planes<kTier>::kCount * plane);  // (C, tile)
                                                       // branch sum, kMean only

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * p.tile;
  const int lo = p.bounds[2 * b];
  const int hi = p.bounds[2 * b + 1];
  const int n_out = min(p.tile, p.N - t0);
  TIO* out = static_cast<TIO*>(p.out) + (size_t)b * C * p.N;

  if (t0 >= hi || t0 + p.tile <= lo) {  // dead tile: the output is zero
    for (int idx = threadIdx.x; idx < C * n_out; idx += kThreads) {
      const int c = idx / n_out;
      piper::store_f(out + offset<kFolded>(p, c, t0 + idx - c * n_out), 0.f);
    }
    return;
  }

  const int g0 = t0 - p.halo;  // global sample index of window lane 0
  const TIO* x = static_cast<const TIO*>(p.x) + (size_t)b * C * p.N;
  if (kMean) {
    for (int idx = threadIdx.x; idx < C * p.tile; idx += kThreads) acc[idx] = 0.f;
  }
  for (int bi = 0; bi < p.n_branches; ++bi) {
    for (int idx = threadIdx.x; idx < C * W; idx += kThreads) {
      const int c = idx / W;
      const int l = idx - c * W;
      const int g = g0 + l;
      const float v = (g >= 0 && g < p.N) ? load_f(x + offset<kFolded>(p, c, g)) : 0.f;
      ybuf[idx] = v;
      store_act<kTier>(abuf, plane, l * S + c, act(v, g, lo, hi, p.slope));
    }
    __syncthreads();
    run_chain<kTier, TIO>(ybuf, abuf, tbuf, p.br[bi], p, p.halo - p.br[bi].halo, g0, lo, hi);
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
    piper::store_f(out + offset<kFolded>(p, c, g), (g >= lo && g < hi) ? v : 0.f);
  }
}

int branch_halo(int k, int n_dil, const int* dils) {
  int h = 0;
  for (int m = 0; m < n_dil; ++m) h += (k - 1) / 2 * dils[m] + (k - 1) / 2;
  return h;
}

template <bool kMean, bool kFolded, int kTier, typename TIO = float>
int start(const Args& a, int B, size_t smem, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(resblock1_kernel<kMean, kFolded, kTier, TIO>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.N + a.tile - 1) / a.tile, B);
  resblock1_kernel<kMean, kFolded, kTier, TIO>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// bf16_io: x, out and the biases are bf16 (tier 2, unfolded only).
template <bool kMean, bool kFolded>
int launch(Args& a, int B, int tier, int bf16_io, int device, void* stream) {
  // Every tier runs on the tensor cores: C a multiple of 16 (m16).
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
  const size_t mean = kMean ? sizeof(float) * a.C * a.tile : 0;
  // ybuf fp32 (C, W), then act(y) and act(conv1) as the tier's planes:
  // one fp32 plane each at "highest", two bf16 at "high", one at "default".
  const size_t acts = tier == 0 ? 2 * sizeof(float) * a.width * (a.C + Planes<0>::kPad)
                                : 2 * sizeof(bf16) * (tier == 1 ? 2 : 1) * a.width *
                                      (a.C + Planes<1>::kPad);
  const size_t smem = sizeof(float) * a.C * a.width + acts + mean;
  if constexpr (!kFolded) {
    if (bf16_io) return start<kMean, false, 2, bf16>(a, B, smem, device, stream);
  }
  switch (tier) {
    case 0: return start<kMean, kFolded, 0>(a, B, smem, device, stream);
    case 1: return start<kMean, kFolded, 1>(a, B, smem, device, stream);
    default: return start<kMean, kFolded, 2>(a, B, smem, device, stream);
  }
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
// bounds a device (B, 2) int32 array; tier 0/1/2 (tiers.cuh). x, out, b1
// and b2 are float, or bf16 when bf16_io is 1 (tier 2 only). Returns a
// cudaError_t code (0 on success).
int piper_resblock1_branch(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, int k, int n_dil, const int* dils,
                           const int* bounds, void* out, int B, int C, int N, int tile,
                           float slope, int tier, int bf16_io, int device, void* stream) {
  Args a = {};
  a.x = x;
  a.out = out;
  a.bounds = bounds;
  a.C = C;
  a.N = N;
  a.tile = tile;
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
// i's n_dils[i] dilations); bf16_io as for the branch entry.
int piper_resblock1_mrf(const void* x, int n_branches, const void* const* w1,
                        const void* const* b1, const void* const* w2,
                        const void* const* b2, const int* ks, const int* n_dils,
                        const int* dils, const int* bounds, void* out, int B, int C,
                        int N, int tile, float slope, int tier, int bf16_io, int device,
                        void* stream) {
  Args a = {};
  a.x = x;
  a.out = out;
  a.bounds = bounds;
  a.C = C;
  a.N = N;
  a.tile = tile;
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
                               int C, int nq, int fold, int tile, float slope, int tier,
                               int device, void* stream) {
  if (fold < 1 || nq < 1) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = x;
  a.out = out;
  a.bounds = bounds;
  a.C = C;
  a.N = fold * nq;
  a.tile = tile;
  a.slope = slope;
  a.fold = fold;
  a.nq = nq;
  const int e = set_branches(a, n_branches, w1, b1, w2, b2, ks, n_dils, dils);
  return e ? e : launch<true, true>(a, B, tier, 0, device, stream);
}

}  // extern "C"
