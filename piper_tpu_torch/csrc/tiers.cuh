// The precision tiers of the vocoder kernels' conv products, as
// piper_tpu/ops/pallas/conv.py:mxu_dot defines them on the TPU
// (piper_tpu_torch/ops/kernels/precision.py is the plain version):
//   0 "highest": fp32-class products;
//   1 "high":    bf16x3, v = v_hi + v_lo and w = w_hi + w_lo with each part
//                a bf16 value; w_hi*v_hi + w_hi*v_lo + w_lo*v_hi (lo*lo
//                dropped);
//   2 "default": one product of the bf16-rounded operands.
// Every product of two bf16 values is exact in fp32, so "high" and
// "default" differ from their plain versions only in the order of the fp32
// sums.
//
// Where each tier is formed: every kernel on warpgroup products (wgmma),
// conv1d.cuh's conv1d_same_kernel and resblock1.cuh's conv_stage_wgmma.
// "high" and "default": bf16 operands with fp32 sums form exactly these
// products, and the activations are split once, where they are written
// (store_split2), into planes that wgmma reads. "highest": 3xTF32, the
// activations split where they are written into tf32 big and small planes
// (store_tf32_split2): v = big + small with big = tf32_rna(v), small =
// tf32_rna(v - big), and the same for w (precision.py::split_tf32);
// big*big + big*small + small*big, each product of two tf32 values exact in
// fp32. small*small and the rounding of small drop about 2^-21 of each
// product, where the plain version's fp32 product is exact; so "highest"
// differs from its plain version by that and by the order of the fp32 sums.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace piper {

using bf16 = __nv_bfloat16;

// v0 and v1 into bf16 planes at elements `off` and `off` + 1 (`off` even),
// one 4-byte store per plane: bf16_rn(v) into the hi plane and, with two
// planes, bf16_rn(v - hi) into the lo plane `plane` elements on
// (precision.py::split_bf16).
template <int kPlanes>
__device__ __forceinline__ void store_split2(bf16* planes, int plane, int off, float v0,
                                             float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(planes + off) = h;
  if (kPlanes == 2)
    *reinterpret_cast<__nv_bfloat162*>(planes + plane + off) =
        __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
}

// The kernels' loads and stores of activations, weights and biases, whose
// element type (float, or bf16 for bf16 activations at "default") is a
// template parameter: a value is read into fp32 and written from fp32 (to
// bf16 by round to nearest even, as torch.Tensor.to(torch.bfloat16)).
__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const bf16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
// v as a store of the type of `p` and a load back would give it.
__device__ __forceinline__ float round_as(const float*, float v) { return v; }
__device__ __forceinline__ float round_as(const bf16*, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero, as fp32 bits with the low 13 mantissa bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;  // wgmma ignores these bits; the split needs them zero
}

// v = big + small as two tf32 operands (precision.py::split_tf32).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// v0 and v1 into fp32 planes at elements `off` and `off` + 1 (`off` even),
// one 8-byte store per plane: split_tf32's big part into the first plane
// and its small part into the plane `plane` elements on, each tf32-exact
// (the low 13 bits zero, so wgmma drops nothing of them).
__device__ __forceinline__ void store_tf32_split2(float* planes, int plane, int off, float v0,
                                                  float v1) {
  uint32_t b0, s0, b1, s1;
  split_tf32(v0, b0, s0);
  split_tf32(v1, b1, s1);
  *reinterpret_cast<uint2*>(planes + off) = make_uint2(b0, b1);
  *reinterpret_cast<uint2*>(planes + plane + off) = make_uint2(s0, s1);
}

}  // namespace piper
