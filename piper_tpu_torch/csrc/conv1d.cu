// Same-padded dilated conv1d with a fused leaky-ReLU input, for Hopper
// (sm_90a), on the tensor cores at every tier: 3xTF32 mma.sync at
// "highest", bf16 mma.sync at "high" and "default". At "default" it also
// takes bf16 activations, weights and bias (the runtime's "bfloat16" mode):
// the same stage, its loads and stores of that type (conv1d.cuh's TIO), fp32
// sums, the output rounded to bf16 once.
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
// Per output sample a conv does C*k multiply-adds for each of C channels
// against 8 bytes of traffic, so device memory is no limit; the products
// are (2*C*C*k flops per sample: 495/3 TFLOP/s as 3xTF32, 989/3 as bf16x3,
// 989 as one bf16 pass). At batch 1 a level is only N/tile blocks (64 of
// 128 samples at C=64), so each block's own time, not the card's rate,
// sets the conv's time; at a serving batch the products do.
//
// Design (conv1d_same_mma_kernel): the conv is one GEMM per time tile,
// M = C_out, N = the tile's lanes, K = C_in x taps. Both operands are
// staged into shared memory where they are read from device memory:
//   - the weights, read as the caller's fp32 (C_out, C_in, K), into planes
//     [tap][C_out][C_in + pad], once per block (blocks are persistent: a
//     grid of at most the SMs' resident blocks walks the tiles, so the
//     staging is paid once per SM, not once per tile, and no launch lays
//     the weights out);
//   - the window, act(x) over [t0 - pad, t0 + tile + pad), into lane-major
//     planes [lane][C_in + pad], coalesced from device memory; the tap shift
//     is a row offset of j*d.
// A warp owns kMT m-tiles by kNT n-tiles of 8 lanes of the block's one
// GEMM; its accumulators start at the bias, and they leave through shared memory
// (over the window's planes), so that the stores to device memory are
// coalesced rows. C not a multiple of 16 is padded with zero channels in
// the planes: exact, and never stored. Tiles wholly outside [lo, hi)
// (their window is all zeros) skip the products: the output there is the
// bias.
//   "high"/"default": one mma.sync.m16n8k16 (bf16 in, fp32 sums) per (16
//   output channels, 8 lanes, tap, 16 input channels): "high" is three mma
//   per step into one accumulator, (w_hi, v_hi) + (w_hi, v_lo) +
//   (w_lo, v_hi), "default" one, (bf16(w), bf16(v)). The operands are split
//   into bf16 planes where they are written (hi, and lo at "high"), with a
//   row stride of C + 8 bf16, so that ldmatrix.x4 reads the A and B
//   fragments and its eight 16-byte rows fall on distinct banks.
//   "highest": 3xTF32, two mma.sync.m16n8k8 steps (tf32 in, fp32 sums) per
//   16 input channels, each three mma into one accumulator, (w_big, v_big)
//   + (w_big, v_small) + (w_small, v_big), as the ResBlock1 kernels form it
//   (resblock1.cu). Planes of fp32 words, row stride C + 4 (tf32 operands
//   are fp32 registers, so ldmatrix does not apply: a fragment is 32-bit
//   loads, (row gid, channel tig) and (gid, tig + 4), which the stride puts
//   on 32 distinct banks). The window is split once, where it is written,
//   into a big and a small plane. The weights stay one plane, split on
//   read: two tf32 planes would need 243,712 bytes at x_low's widest conv
//   (C=64, k=7), past the 232,448 a block may have, and split on the host
//   into fragment order (as K2-K4 take them) they would cost seven
//   launches per call before the kernel. One weight plane and the window's
//   two need 230,656 bytes there at a 128-sample tile and d=12. A warp
//   owns 2 or 4 n-tiles (the wrapper picks): at 4, each A fragment split on
//   read feeds 12 mma.

#include "conv1d.cuh"

extern "C" {

// x, out (B, C, N); w the caller's (C_out, C_in, K) at every tier; bias
// (C,) or null; bounds a device (B, bounds_cols) int32 array (bounds_cols
// 2: [lo, hi); 1: [0, hi)) or null with bounds_cols 0. C is a multiple of
// 8. tier 0 "highest", 1 "high", 2 "default"; m_tiles (1, 2 or 4) and
// n_tiles (2, or 4 at tier 0) are a warp's 16-channel m-tiles and 8-lane
// n-tiles. x, w, bias and out are float, or bf16 when bf16_io is 1 (tier 2
// only: bf16 activations are the "bfloat16" mode's, which runs at
// "default"). Returns a cudaError_t code (0 on success).
int piper_conv1d_same(const void* x, const void* w, const void* bias, const int* bounds,
                      int bounds_cols, void* out, int B, int C, int N, int k, int dil,
                      int tile, float slope, int tier, int m_tiles, int n_tiles, int bf16_io,
                      int device, void* stream) {
  if (C < 8 || C % 8 != 0 || k < 1 || k % 2 == 0 || dil < 1 || tile < 1 ||
      N < 1 || B < 1 || bounds_cols < 0 || bounds_cols > 2 || (bounds_cols > 0) != (bounds != nullptr))
    return (int)cudaErrorInvalidValue;
  if (bf16_io) {
    if (tier != 2 || n_tiles != 2) return (int)cudaErrorInvalidValue;
    return launch_tier<2, 2>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                             static_cast<const bf16*>(bias), bounds, bounds_cols,
                             static_cast<bf16*>(out), B, C, N, k, dil, tile, slope, m_tiles,
                             device, stream);
  }
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  if (tier == 0)
    return conv1d_highest(xf, wf, bf, bounds, bounds_cols, of, B, C, N, k, dil, tile, slope,
                          m_tiles, n_tiles, device, stream);
  if (n_tiles != 2) return (int)cudaErrorInvalidValue;
  switch (tier) {
    case 1: return launch_tier<1, 2>(xf, wf, bf, bounds, bounds_cols, of, B, C, N, k, dil, tile, slope, m_tiles, device, stream);
    case 2: return launch_tier<2, 2>(xf, wf, bf, bounds, bounds_cols, of, B, C, N, k, dil, tile, slope, m_tiles, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
