// HiFi-GAN ResBlock1 kernels for Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces two Pallas TPU kernels of piper_tpu/ops/pallas/resblock.py:
//   piper_resblock1_branch  <- pallas_resblock1_branch (_branch_kernel): one
//                              ResBlock1 branch, y = x; for d in dils:
//                              y += conv2(act(conv1_d(act(y)))).
//   piper_resblock1_mrf     <- pallas_resblock1_mrf (_mrf_kernel): every
//                              branch from one shared window, then their mean.
// act(v) is a leaky ReLU followed by the row's [lo, hi) mask on the global
// sample index; the output is exactly zero outside [lo, hi).
//
// What bounds it on the H100: the six chained convs of a branch are narrow
// (C = 32 or 64 channels) and long in time. Run one by one, each conv
// streams the level activation through device memory; fused, the work is
// the fp32 FMAs (2*C*C*k per output sample per conv, ~67 TFLOP/s peak on
// CUDA cores) plus the halo recompute.
//
// Design: one block of 512 threads per (output tile of `tile` samples, row).
// The block loads the tile's haloed window [t0 - halo, t0 + tile + halo)
// once into shared memory and walks the whole chain there, so the
// activation crosses device memory once in and once out (the MRF kernel
// reloads the window from L2 for each branch). Three (C, window) buffers:
// the raw residual y, act(y) (written by each conv2 beside the residual, so
// conv1 reads its input as is) and act(conv1). The valid region shrinks
// stage by stage exactly as _run_branch_chain shrinks it; a narrower MRF
// branch starts with the margin it does not need already consumed. Each
// thread keeps an 8-channel x 4-sample register tile of accumulators: every
// activation it reads from shared memory feeds 8 FMAs, and each weight read
// (a warp-uniform float4 load of the (C_in, K, C_out) transposed weights,
// served by L1) feeds 4. The tap loop is unrolled for K = 3/5/7/11. Weights
// stay in global memory: one k=11 branch at C=64 is ~1 MB. The window is
// about 2x the tile at the widest halo (60 samples per side for k=11,
// dilations 1/3/5); the wrapper takes the largest tile whose window fits
// one pass of the block (128 at C=64, 256 at C=32): measured, a smaller
// tile that fills more SMs loses more to the halo it recomputes. No tensor
// cores: the "highest" tier is fp32. Tiles wholly outside [lo, hi) write
// zeros and skip all work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRCo = 8;  // output channels per thread
constexpr int kRT = 4;   // time samples per thread, strided by the row width
constexpr int kMaxBranches = 4;
constexpr int kMaxDils = 4;

struct Branch {
  const float* w1;  // (M, C_in, K, C_out): conv1 (dilated) weights
  const float* b1;  // (M, C)
  const float* w2;  // (M, C_in, K, C_out): conv2 (dense) weights
  const float* b2;  // (M, C)
  int k;
  int n_dil;
  int halo;  // this branch's one-sided receptive field
  int dils[kMaxDils];
};

struct Args {
  const float* x;      // (B, C, N)
  float* out;          // (B, C, N)
  const int* bounds;   // (B, 2) [lo, hi) with 0 <= lo, hi <= N
  int C, N, tile, width, halo, n_branches;
  float slope;
  Branch br[kMaxBranches];
};

// act(v) at global sample index g: leaky ReLU, then zero outside [lo, hi).
__device__ __forceinline__ float act(float v, int g, int lo, int hi, float slope) {
  return (g >= lo && g < hi) ? (v >= 0.f ? v : v * slope) : 0.f;
}

// One conv of the chain over a window of `W` lanes per channel: output lane
// l in [a, a + width) reads input lanes l - h + j*step, j < K (K > 0 is a
// compile-time tap count, so the tap loop unrolls; K == 0 reads k_rt).
// The input is already activated. kConv1: store act(conv) into dst (the
// next conv's input). Otherwise add the conv into the residual dst and store
// act(new residual) into adst (the next conv1's input).
template <int K, bool kConv1>
__device__ void conv_stage(const float* __restrict__ src, float* __restrict__ dst,
                           float* __restrict__ adst, const float* __restrict__ w,
                           const float* __restrict__ bias, int C, int W, int k_rt,
                           int step, int h, int a, int width, float slope, int g0,
                           int lo, int hi) {
  const int taps = K > 0 ? K : k_rt;
  const int groups = C / kRCo;
  const int row_threads = kThreads / groups;
  const int cg = threadIdx.x / row_threads;
  const int tx = threadIdx.x - cg * row_threads;
  const int co0 = cg * kRCo;
  const int first = a - h;  // input lane read by output lane a at tap 0
  for (int base = 0; base < width; base += row_threads * kRT) {
    float acc[kRCo][kRT];
#pragma unroll
    for (int c = 0; c < kRCo; ++c) {
      const float bv = __ldg(bias + co0 + c);
#pragma unroll
      for (int i = 0; i < kRT; ++i) acc[c][i] = bv;
    }
    // Lanes past the stage's width read clamped (valid) lanes; their sums
    // are discarded below.
    int lane[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) lane[i] = first + min(base + tx + i * row_threads, width - 1);
    for (int ci = 0; ci < C; ++ci) {
      const float* row = src + ci * W;
      const float* wrow = w + (size_t)ci * taps * C + co0;
#pragma unroll
      for (int j = 0; j < taps; ++j) {
        float v[kRT];
#pragma unroll
        for (int i = 0; i < kRT; ++i) v[i] = row[lane[i] + j * step];
        const float4 wa = __ldg(reinterpret_cast<const float4*>(wrow + j * C));
        const float4 wb = __ldg(reinterpret_cast<const float4*>(wrow + j * C + 4));
        const float wv[kRCo] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int c = 0; c < kRCo; ++c) {
#pragma unroll
          for (int i = 0; i < kRT; ++i) acc[c][i] = fmaf(wv[c], v[i], acc[c][i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const int pos = base + tx + i * row_threads;
      if (pos >= width) continue;
      const int l = a + pos;
      const int g = g0 + l;
#pragma unroll
      for (int c = 0; c < kRCo; ++c) {
        const int idx = (co0 + c) * W + l;
        if (kConv1) {
          dst[idx] = act(acc[c][i], g, lo, hi, slope);
        } else {
          const float y = dst[idx] + acc[c][i];
          dst[idx] = y;
          adst[idx] = act(y, g, lo, hi, slope);
        }
      }
    }
  }
}

// The branch chain, in place on ybuf (abuf holds act(y), tbuf act(conv1)).
// `margin0` is the margin already consumed on each side: 0 when the window
// halo equals this branch's receptive field, more for a narrower MRF branch.
// On return ybuf is exact on [margin0 + br.halo, W - margin0 - br.halo).
template <int K>
__device__ void run_chain_k(float* ybuf, float* abuf, float* tbuf, const Branch& br,
                            const Args& p, int margin0, int g0, int lo, int hi) {
  const int C = p.C;
  const int W = p.width;
  const int h2 = (br.k - 1) / 2;
  const size_t wstride = (size_t)C * C * br.k;
  int margin = margin0;
  for (int m = 0; m < br.n_dil; ++m) {
    const int d = br.dils[m];
    const int h1 = h2 * d;
    const int a1 = margin + h1;
    conv_stage<K, true>(abuf, tbuf, nullptr, br.w1 + m * wstride, br.b1 + m * C, C, W,
                        br.k, d, h1, a1, W - 2 * a1, p.slope, g0, lo, hi);
    __syncthreads();
    const int a2 = a1 + h2;
    conv_stage<K, false>(tbuf, ybuf, abuf, br.w2 + m * wstride, br.b2 + m * C, C, W,
                         br.k, 1, h2, a2, W - 2 * a2, p.slope, g0, lo, hi);
    __syncthreads();
    margin = a2;
  }
}

__device__ void run_chain(float* ybuf, float* abuf, float* tbuf, const Branch& br,
                          const Args& p, int margin0, int g0, int lo, int hi) {
  switch (br.k) {  // HiFi-GAN's kernel sizes get an unrolled tap loop
    case 3: run_chain_k<3>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi); break;
    case 5: run_chain_k<5>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi); break;
    case 7: run_chain_k<7>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi); break;
    case 11: run_chain_k<11>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi); break;
    default: run_chain_k<0>(ybuf, abuf, tbuf, br, p, margin0, g0, lo, hi); break;
  }
}

template <bool kMean>
__global__ void __launch_bounds__(kThreads, 1) resblock1_kernel(const Args p) {
  extern __shared__ float smem[];
  const int C = p.C;
  const int W = p.width;
  float* ybuf = smem;              // (C, W) raw residual y
  float* abuf = smem + C * W;      // (C, W) act(y)
  float* tbuf = abuf + C * W;      // (C, W) act(conv1 output)
  float* acc = tbuf + C * W;       // (C, tile) branch sum, kMean only

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * p.tile;
  const int lo = p.bounds[2 * b];
  const int hi = p.bounds[2 * b + 1];
  const int n_out = min(p.tile, p.N - t0);
  float* out = p.out + (size_t)b * C * p.N + t0;

  if (t0 >= hi || t0 + p.tile <= lo) {  // dead tile: the output is zero
    for (int idx = threadIdx.x; idx < C * n_out; idx += kThreads) {
      const int c = idx / n_out;
      out[(size_t)c * p.N + (idx - c * n_out)] = 0.f;
    }
    return;
  }

  const int g0 = t0 - p.halo;  // global sample index of window lane 0
  const float* x = p.x + (size_t)b * C * p.N;
  if (kMean) {
    for (int idx = threadIdx.x; idx < C * p.tile; idx += kThreads) acc[idx] = 0.f;
  }
  for (int bi = 0; bi < p.n_branches; ++bi) {
    for (int idx = threadIdx.x; idx < C * W; idx += kThreads) {
      const int c = idx / W;
      const int g = g0 + (idx - c * W);
      const float v = (g >= 0 && g < p.N) ? __ldg(x + (size_t)c * p.N + g) : 0.f;
      ybuf[idx] = v;
      abuf[idx] = act(v, g, lo, hi, p.slope);
    }
    __syncthreads();
    run_chain(ybuf, abuf, tbuf, p.br[bi], p, p.halo - p.br[bi].halo, g0, lo, hi);
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
    out[(size_t)c * p.N + l] = (g >= lo && g < hi) ? v : 0.f;
  }
}

int branch_halo(int k, int n_dil, const int* dils) {
  int h = 0;
  for (int m = 0; m < n_dil; ++m) h += (k - 1) / 2 * dils[m] + (k - 1) / 2;
  return h;
}

template <bool kMean>
int launch(Args& a, int B, int device, void* stream) {
  if (a.C % kRCo != 0 || kThreads % (a.C / kRCo) != 0 || a.n_branches < 1 ||
      a.n_branches > kMaxBranches || a.tile < 1 || a.N < 1 || B < 1)
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
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem =
      sizeof(float) * (3 * (size_t)a.C * a.width + (kMean ? (size_t)a.C * a.tile : 0));
  e = cudaFuncSetAttribute(resblock1_kernel<kMean>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.N + a.tile - 1) / a.tile, B);
  resblock1_kernel<kMean><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* piper_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One ResBlock1 branch. Weights w1/w2 are (M, C_in, K, C_out) contiguous and
// 16-byte aligned; dils is a host array of M ints; bounds a device (B, 2)
// int32 array. Returns a cudaError_t code (0 on success).
int piper_resblock1_branch(const float* x, const float* w1, const float* b1,
                           const float* w2, const float* b2, int k, int n_dil,
                           const int* dils, const int* bounds, float* out, int B,
                           int C, int N, int tile, float slope, int device,
                           void* stream) {
  Args a = {};
  a.x = x;
  a.out = out;
  a.bounds = bounds;
  a.C = C;
  a.N = N;
  a.tile = tile;
  a.slope = slope;
  a.n_branches = 1;
  if (n_dil < 1 || n_dil > kMaxDils) return (int)cudaErrorInvalidValue;
  a.br[0] = Branch{w1, b1, w2, b2, k, n_dil, 0, {0, 0, 0, 0}};
  for (int m = 0; m < n_dil; ++m) a.br[0].dils[m] = dils[m];
  return launch<false>(a, B, device, stream);
}

// Every branch of the multi-receptive-field stage and their mean. Per-branch
// arguments are host arrays of length n_branches (device pointers for the
// weights); dils is a host array of n_branches * 4 ints (row i holds branch
// i's n_dils[i] dilations).
int piper_resblock1_mrf(const float* x, int n_branches, const float* const* w1,
                        const float* const* b1, const float* const* w2,
                        const float* const* b2, const int* ks, const int* n_dils,
                        const int* dils, const int* bounds, float* out, int B, int C,
                        int N, int tile, float slope, int device, void* stream) {
  if (n_branches < 1 || n_branches > kMaxBranches) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = x;
  a.out = out;
  a.bounds = bounds;
  a.C = C;
  a.N = N;
  a.tile = tile;
  a.slope = slope;
  a.n_branches = n_branches;
  for (int i = 0; i < n_branches; ++i) {
    if (n_dils[i] < 1 || n_dils[i] > kMaxDils) return (int)cudaErrorInvalidValue;
    a.br[i] = Branch{w1[i], b1[i], w2[i], b2[i], ks[i], n_dils[i], 0, {0, 0, 0, 0}};
    for (int m = 0; m < n_dils[i]; ++m) a.br[i].dils[m] = dils[i * kMaxDils + m];
  }
  return launch<true>(a, B, device, stream);
}

}  // extern "C"
