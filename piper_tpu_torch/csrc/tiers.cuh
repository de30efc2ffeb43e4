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
// Where each tier is formed: "high" and "default" on the tensor cores in
// every kernel (conv1d.cu's conv1d_same_mma_kernel on mma.sync,
// resblock1.cuh's conv_stage_wgmma on wgmma): bf16 operands with fp32 sums
// form exactly these products, and the activations are split once, where
// they are written (store_split2), into planes that wgmma or ldmatrix
// reads.
// "highest" on the tensor cores as 3xTF32 in both kernels (conv1d.cu's on
// mma.sync, splitting its activations on read; resblock1.cu's on wgmma,
// which reads tf32 big and small planes split where they are written,
// store_tf32_split2): v = big + small
// with big = tf32_rna(v), small = tf32_rna(v - big), and the same for w
// (precision.py::split_tf32); big*big + big*small + small*big, each product
// of two tf32 values exact in fp32. small*small and the rounding of small
// drop about 2^-21 of each product, where the plain version's fp32 product
// is exact; so "highest" differs from its plain version by that and by the
// order of the fp32 sums.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

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

// Four 8x8 b16 matrices from shared memory; thread t gives the address of
// row t % 8 of matrix t / 8 and receives, of matrix i in r[i], row t / 4,
// columns 2 * (t % 4) and 2 * (t % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += A (16x16 bf16, A-fragment registers a) x B (16x8 bf16, b0 b1), fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// v rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero, as fp32 bits with the low 13 mantissa bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;  // mma ignores these bits; the split needs them zero
}

// v = big + small as two tf32 operands (precision.py::split_tf32).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// d += A (16x8 tf32, A-fragment registers a) x B (8x8 tf32, b0 b1), fp32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint4& a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
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

// How a tier keeps a plane of operands in shared memory: the element type,
// the row stride past C (C + kPad elements), and the planes per buffer.
// "highest" keeps one fp32 plane, split into tf32 parts on read
// (split_tf32); "high" two bf16 planes (hi, lo) and "default" one, split
// where they are written (store_split2).
template <int kTier>
struct Planes {
  using T = std::conditional_t<kTier == 0, float, bf16>;
  static constexpr int kPad = kTier == 0 ? 4 : 8;
  static constexpr int kCount = kTier == 1 ? 2 : 1;
};

// Two neighbouring values (v0 at `off`, v1 at `off` + 1, `off` even) into
// the tier's planes, one store per plane.
template <int kTier>
__device__ __forceinline__ void store_act2(typename Planes<kTier>::T* planes, int plane,
                                           int off, float v0, float v1) {
  if constexpr (kTier == 0) {
    *reinterpret_cast<float2*>(planes + off) = make_float2(v0, v1);
  } else {
    store_split2<Planes<kTier>::kCount>(planes, plane, off, v0, v1);
  }
}

}  // namespace piper
