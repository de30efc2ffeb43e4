// K1's wide design (conv1d_wide.cuh): the square ResBlock convs of 128 to
// 256 channels on fp32 activations, at "highest" (3xTF32) and "high"
// (bf16x3), on warpgroup products (wgmma); the C entry, and the "high"
// instantiation (conv1d_wide_highest.cu has "highest").
//
// Replaces the same Pallas TPU kernel as conv1d.cu (pallas_conv1d_same in
// piper_tpu/ops/pallas/conv.py): out = residual + conv1d_same(act(x), w, b,
// dilation=d), act(v) = v >= 0 ? v : v * slope, zero outside the row's
// bounds [lo, hi) on the input; the residual, where given, is added last,
// as PyTorch adds the conv's output to it. On the TPU the JAX package runs
// the wide levels' convs through XLA; here they are the vocoder's largest
// work (C = 256 and 128 of Piper's high voices, 252 C^2 flops a sample a
// level; level 0 of its medium voices at C = 128).
//
// What bounds it on the H100: the products, 2*C*C*k flops a sample a conv
// at 989/3 TFLOP/s ("high") or 495/3 ("highest"), against 8-12 bytes of
// activations a sample and channel. Shared memory is what shapes it: at C =
// 256 one tap's weights in the tier's two planes are 256 KB, more than the
// 227 KB a block may hold, and a full-depth window of 256 channels by 64 +
// 2*25 samples is 114 KB; neither a whole tap nor a deep window can stay
// resident as conv1d.cu keeps them below 128 channels.
//
// Design: a block owns 128 output channels (wgmma's N) by a tile of 64-256
// output samples (64 a warpgroup, M), and walks the input channels in chunks
// of 64 bytes a plane (32 bf16 or 16 tf32 channels). Per chunk, the window
// [t0 - pad, t0 + tile + pad) is written once into shared memory: act(x),
// masked by the row's bounds and split into the tier's planes where it is
// written (K1's stage, at the width of one chunk); two buffers, so chunk q +
// 1 is written, a k-th after each of chunk q's taps is issued, while the
// products read chunk q. Its raw fp32 rows come by cp.async into two more
// buffers two chunks ahead: loads waited on a tap later cost as much as the
// products at k = 11 (their latency, not their bytes), so no product waits
// on device memory for the window. The weights stream through a ring of 16
// KB units, one per (chunk, tap): both planes of the block's 128 rows of one
// chunk, 64-byte swizzled, bulk-copied (cp.async.bulk) on mbarriers from an
// image laid out once per weight tensor and tier
// (ops/kernels/conv.py::wide_image). Each conv is one GEMM per tap, summed
// over taps and chunks in registers (fp32), so no product is spent on the
// halo, and each weight byte fetched serves the tile's samples (128 FLOP of
// the conv a byte at a tile of 256). Each product reads both operands from
// shared memory, about 96 bytes a clock at the tensor cores' rate against
// the SM's 128, which is what holds the products near 60% of the tier's
// rate. The epilogue adds the bias, then the residual, through an fp32 stage
// as coalesced rows. Tiles whose window lies wholly outside [lo, hi) store
// the bias (plus the residual) and run no product. C not a multiple of 128
// runs as the next multiple: zero channels in the window and the image,
// never stored. Tile and ring are picked by shape
// (ops/kernels/conv.py::pick_wide); the output depends on neither.

#include "conv1d_wide.cuh"

using namespace piper_k1w;

extern "C" {

// x, residual, out (B, C, N) float; w the tier's wide image of the (C, C, k)
// weights zero-padded to Cp = C rounded up to 128 (16-byte aligned); bias
// (C,) or null; residual or null; bounds a device (B, bounds_cols) int32
// array (bounds_cols 2: [lo, hi); 1: [0, hi)) or null with bounds_cols 0.
// 1 <= C <= 256; tier 0 "highest" or 1 "high"; tile 64, 128, 192 or 256
// output samples a block (tile / 64 warpgroups); ring (2-4) the weight
// slots. Returns a cudaError_t code (0 on success).
int piper_conv1d_same_wide(const float* x, const void* w, const float* bias,
                           const int* bounds, int bounds_cols, const float* residual,
                           float* out, int B, int C, int N, int k, int dil, int tile,
                           float slope, int tier, int ring, int device, void* stream) {
  if (C < 1 || C > 256 || k < 1 || k % 2 == 0 || dil < 1 || tile < 64 || tile > 256 ||
      tile % 64 || N < 1 || B < 1 || B > 65535 || (N + tile - 1) / tile > 65535 ||
      bounds_cols < 0 || bounds_cols > 2 || (bounds_cols > 0) != (bounds != nullptr) ||
      tier < 0 || tier > 1 || ring < 2 || ring > kMaxRing)
    return (int)cudaErrorInvalidValue;
  const int cp = (C + kNT - 1) / kNT * kNT;
  const int total = cp / (tier == 0 ? Tier<0>::kKC : Tier<1>::kKC) * k;
  const int pad = (k - 1) / 2 * dil;
  const size_t smem = smem_bytes(tile, pad, ring < total ? ring : total, tier);
  const Args a{x, w, bias, bounds, residual, out, bounds_cols, B, C, cp, N, k, dil, tile,
               ring, slope};
  return tier == 0 ? start_highest(a, smem, device, stream) : start<1>(a, smem, device, stream);
}

}  // extern "C"
