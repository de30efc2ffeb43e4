// Same-padded dilated conv1d with a fused leaky-ReLU input, for Hopper
// (sm_90a), on warpgroup products (wgmma) at every tier: 3xTF32 at
// "highest", bf16 at "high" (three products) and "default" (one). At
// "default" it also takes bf16 activations, weights and bias (the runtime's
// "bfloat16" mode): the same stage, its loads and stores of that type
// (TIO), fp32 sums, the output rounded to bf16 once.
//
// Replaces the Pallas TPU kernel piper_tpu/ops/pallas/conv.py:
//   piper_conv1d_same  <- pallas_conv1d_same (_kernel):
//                         out = conv1d_same(act(x), w, b, dilation=d),
// act(v) = v >= 0 ? v : v * slope (slope 1 is the identity), odd k, square
// (C, C, k) weights, zero padding on both sides. Optional per-row bounds
// [lo, hi): act(v) is then also zero outside them, on the input only (for a
// 0/1 mask lrelu(x * m) = lrelu(x) * m, so this is the TPU kernel on
// x * mask). The output is not masked. An optional residual is added to
// the output last: out = residual + (conv + bias), each sum rounded as
// PyTorch rounds x + xt.
//
// What bounds it on the H100: the ResBlock2 convs of Piper's x_low voices
// (and the narrow ResBlock1 convs the ResBlock1 kernels do not take) are
// narrow (C = 32 or 64), short in taps and long in time. Per output sample
// a conv does C*k multiply-adds for each of C channels against 8 bytes of
// traffic, so device memory is no limit; the products are (2*C*C*k flops
// per sample: 495/3 TFLOP/s as 3xTF32, 989/3 as bf16x3, 989 as one bf16
// pass). At batch 1 a level is only N/tile blocks (128 of 64 samples at
// x_low's level 1), so each block's own latency, its window's loads and
// its chain of products, sets the conv's time; at a serving batch the
// tensor cores do.
//
// Design (conv1d.cuh's conv1d_same_kernel, the stage of resblock1.cuh for
// one conv): a block per (tile of output samples, row); each conv is one
// GEMM per tap, M = the tile's output lanes (64 a warpgroup, the first
// ceil(tile / 64) warpgroups of the block), N = C_out, K = C_in, summed
// over the taps, so no product is spent on the halo; the block may hold
// more warpgroups than that, which only load the window and store the
// output (where a level has fewer blocks than SMs). A (act(x), the tier's planes) is read from
// shared memory by descriptor: the block writes act(x) over the window
// [t0 - pad, t0 + tile + pad) once, masked by the row's bounds and split
// where it is written (tf32 big and small at "highest", bf16 hi and lo at
// "high", bf16 at "default"), into planes of 16-byte chunks of channels, so
// a tap's shift of j*d lanes is a 16*j*d-byte step of A's start address. B
// (a tap's weights) arrives as the host's swizzled image
// (ops/kernels/resblock.py::wgmma_tier_image of the weights zero-padded to
// C rounded up to 16; laid out once per weight tensor and tier,
// ops/kernels/conv.py) by cp.async.bulk, `chunk` units (taps, or past 32
// KB a tap one swizzle atom of it) a copy, into a ring of up to `ring`
// slots completed on mbarriers, so the next chunk's copy runs under the
// current chunk's products. C not a multiple of 16 runs as the next
// multiple: zero channels in the planes and the image, never stored, so
// any square C from 1 to 128 runs (wider ones, to 256, run the wide design
// of conv1d_wide.cu). The epilogue adds the bias and stores
// the raw sums (no act(), the output unmasked) through an fp32 stage over
// the planes as coalesced rows, rounded to bf16 once for bf16 I/O. Tiles
// whose window lies wholly outside [lo, hi) (all zeros) store the bias and
// run no product.
//
// bf16 activations at "default": x, the image (bf16(w) = w) and the bias
// are read as they are, into the same bf16 plane as the fp32-input kernel
// writes from the same values, with the same fp32 sums in the same order;
// so the kernel on bf16 x equals the fp32-input "default" kernel on x's
// values with its output rounded to bf16, bit for bit.

#include "conv1d.cuh"

using namespace piper_k1;

extern "C" {

// x, out (B, C, N); w the tier's image of the (C_out, C_in, K) weights
// zero-padded to Cp = C rounded up to 16 (16-byte aligned); bias (C,) or
// null; bounds a device (B, bounds_cols) int32 array (bounds_cols 2: [lo,
// hi); 1: [0, hi)) or null with bounds_cols 0; residual (B, C, N), added
// to the conv's output, or null. 1 <= C <= 128. tier 0
// "highest", 1 "high", 2 "default"; tile (1-256) the output samples a
// block, warpgroups (ceil(tile / 64) to 4) the block's, ring (1-3) the
// weight slots (1 only for a conv of one chunk) and chunk the units a slot
// holds. x,
// bias, residual and out are float, or bf16 when bf16_io is 1 (tier 2 only: bf16
// activations are the "bfloat16" mode's, which runs at "default"). Returns
// a cudaError_t code (0 on success).
int piper_conv1d_same(const void* x, const void* w, const void* bias, const int* bounds,
                      int bounds_cols, const void* residual, void* out, int B, int C, int N,
                      int k, int dil,
                      int tile, float slope, int tier, int warpgroups, int ring, int chunk,
                      int bf16_io, int device, void* stream) {
  if (C < 1 || C > 128 || k < 1 || k % 2 == 0 || dil < 1 || tile < 1 || tile > 256 ||
      warpgroups < (tile + 63) / 64 || warpgroups > kMaxThreads / 128 ||
      N < 1 || B < 1 || bounds_cols < 0 || bounds_cols > 2 ||
      (bounds_cols > 0) != (bounds != nullptr) || tier < 0 || tier > 2 || ring < 1 ||
      ring > kMaxRing || chunk < 1 || (bf16_io && tier != 2))
    return (int)cudaErrorInvalidValue;
  const int cp = (C + 15) / 16 * 16;
  const int units = k * piper_rb::tap_units(cp, tier);
  const int total = (units + chunk - 1) / chunk;
  if (ring == 1 && total > 1) return (int)cudaErrorInvalidValue;  // the slot would wait on itself
  const size_t smem = smem_bytes(cp, C, tier, tile, (k - 1) / 2 * dil,
                                 ring < total ? ring : total, chunk);
  const Args a{x, w,    bias, bounds, residual, out,   bounds_cols, B,    C,
               N, k,    dil,  tile,   ring,     chunk, warpgroups,  slope};
  if (bf16_io) return start_tier<2, bf16>(a, cp, smem, device, stream);
  switch (tier) {
    case 0: return start_highest(a, cp, smem, device, stream);
    case 1: return start_tier<1, float>(a, cp, smem, device, stream);
    default: return start_tier<2, float>(a, cp, smem, device, stream);
  }
}

}  // extern "C"
