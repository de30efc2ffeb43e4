// The precision tiers of the vocoder kernels' conv products, as
// piper_tpu/ops/pallas/conv.py:mxu_dot defines them on the TPU
// (piper_tpu_torch/ops/kernels/precision.py is the plain version):
//   0 "highest": fp32 products;
//   1 "high":    bf16x3, v = v_hi + v_lo and w = w_hi + w_lo with each part
//                a bf16 value; w_hi*v_hi + w_hi*v_lo + w_lo*v_hi (lo*lo
//                dropped);
//   2 "default": one product of the bf16-rounded operands.
// Every product of two bf16 values is exact in fp32, so the tiers differ
// from their plain versions only in the order of the fp32 sums.
// tier_fma is the CUDA-core form, with the split done in registers at the
// read: "high" costs three FMAs and the splits per product, so on CUDA
// cores it runs ~4x slower than "highest" (K1, conv1d.cu, at every tier;
// the ResBlock1 kernels at "highest"). The ResBlock1 kernels run "high"
// and "default" on the tensor cores instead (resblock1.cu,
// conv_stage_mma): mma.sync on bf16 operands with fp32 sums forms exactly
// these products, and the operands are split once, where they are written.

#pragma once

#include <cuda_bf16.h>

namespace piper {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc[c][i] += w[c] * v[i] at tier kTier, for a register tile of kCo output
// channels by kT samples.
template <int kTier, int kCo, int kT>
__device__ __forceinline__ void tier_fma(const float (&w)[kCo], const float (&v)[kT],
                                         float (&acc)[kCo][kT]) {
  if (kTier == 0) {
#pragma unroll
    for (int c = 0; c < kCo; ++c) {
#pragma unroll
      for (int i = 0; i < kT; ++i) acc[c][i] = fmaf(w[c], v[i], acc[c][i]);
    }
  } else if (kTier == 1) {
    float vh[kT], vl[kT];
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      vh[i] = bf16_round(v[i]);
      vl[i] = bf16_round(v[i] - vh[i]);
    }
#pragma unroll
    for (int c = 0; c < kCo; ++c) {
      const float wh = bf16_round(w[c]);
      const float wl = bf16_round(w[c] - wh);
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        float a = fmaf(wh, vh[i], acc[c][i]);
        a = fmaf(wh, vl[i], a);
        acc[c][i] = fmaf(wl, vh[i], a);
      }
    }
  } else {
    float vb[kT];
#pragma unroll
    for (int i = 0; i < kT; ++i) vb[i] = bf16_round(v[i]);
#pragma unroll
    for (int c = 0; c < kCo; ++c) {
      const float wb = bf16_round(w[c]);
#pragma unroll
      for (int i = 0; i < kT; ++i) acc[c][i] = fmaf(wb, vb[i], acc[c][i]);
    }
  }
}

}  // namespace piper
