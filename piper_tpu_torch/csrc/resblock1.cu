// HiFi-GAN ResBlock1 kernels for Hopper (sm_90a): fp32 sums, the convs'
// products on warpgroup products (wgmma) at every tier: bf16 at "high" and
// "default", 3xTF32 at "highest". The stage is resblock1.cuh's; nvcc
// compiles "highest" in resblock1_highest.cu beside this file.
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
// The wgmma stage (conv_stage_wgmma, resblock1.cuh), described first at
// "high" and "default". Each conv is one GEMM per tap, M = the window's lanes, N = C_out, K = C_in, summed over
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
// "highest": the same stage on tf32, three m64nCk8 wgmma per (tap, 8 input
// channels) into one accumulator, (v_big, w_big) + (v_small, w_big) +
// (v_big, w_small), each product of two tf32 values exact in fp32
// (tiers.cuh). What bounds it: three TF32 passes, 495/3 TFLOP/s of
// fp32-class products, and at C = 32 and 16 the shared-memory reads of A
// (2 KB of A for every m64nCk8, 1 KB or less of B). The weights arrive as
// the host's image of their big and small planes
// (ops/kernels/resblock.py::wgmma_tf32_weights: fp32, K-major, 4C-byte
// rows cut into 128-byte swizzle atoms, two along C_in at C = 64, each
// atom's big plane then its small one; the 64-byte swizzle at C = 16), 32
// KB a tap at C = 64, one tap a slot in 3
// slots there (the most that fit), 6 or 11 taps a slot in 2 at C = 32 and
// 16. The activations are split once, where they are written
// (store_tf32_split2), into tf32 big and small planes of 4 channels a
// 16-byte chunk, so A is read by descriptor as at the bf16 tiers, with no
// split and no register on the products' path. Two such buffers of 256
// lanes at C = 64 (263 KB) do not fit beside a ring, so there act(y) and
// act(conv1) share one, overwritten in place: each stage's epilogue first
// waits at a block barrier for every warpgroup's last product (in_place;
// the warpgroups with no lane in the stage meet it at the same place).
// "highest" also takes the other multiples of 16 below 128 that the Pallas
// kernels take and no preset voice has (resblock1_highest_other.cu): C =
// 48 in place with whole taps a unit; C = 80, 96 and 112 in place with one
// swizzle atom of a tap (both planes: 10, 24 and 14 KB) a unit of the ring,
// since a whole tap (51-100 KB) leaves no room for two slots beside the
// window.
// conv2 sums from 0 in conv1's accumulator and adds the residual after its
// products: started at y, as at the bf16 tiers, each of its 264 k-steps (C
// = 64, k = 11) rounded at |y|'s scale (K2 at the main path's shape 1.7e-5
// from the plain version against 5.7e-5 on the H100, chip_smoke.py).
// Measured on the H100 and left out: A from registers, split on read from
// one fp32 plane (ptxas serialised every wgmma for registers, C7512: 17-21%
// slower), and at C <= 32 v_big against both weight planes in one product of
// N = 2C (the same, C7511: K3 0.301 against 0.256 ms).
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

#include "resblock1.cuh"

namespace piper_rb {

int branch_halo(int k, int n_dil, const int* dils) {
  int h = 0;
  for (int m = 0; m < n_dil; ++m) h += (k - 1) / 2 * dils[m] + (k - 1) / 2;
  return h;
}

// bf16_io: x, out and the biases are bf16 (tier 2, unfolded only).
template <bool kMean, bool kFolded>
int launch(Args& a, int B, int tier, int bf16_io, int device, void* stream) {
  // Every tier runs on the wgmma stage: C = 16, 32 or 64 (at "highest" any
  // multiple of 16 below 128), a window of at most 256 lanes and a ring of
  // 2 to kMaxRing slots of `chunk` units each (tap_units).
  if (a.C < 16 || a.C % 16 != 0 || tier < 0 || tier > 2 || a.n_branches < 1 ||
      (bf16_io && (tier != 2 || kFolded)) || a.n_branches > kMaxBranches || a.tile < 1 || a.N < 1 || B < 1 || a.fold < 1)
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
  if ((tier == 0 ? a.C > 112 : a.C != 16 && a.C != 32 && a.C != 64) || a.width > kWindow ||
      a.chunk < 1 || a.ring < 2 || a.ring > kMaxRing)
    return (int)cudaErrorInvalidValue;
  // The ring's slots (after up to 1024 bytes of alignment) and barriers,
  // then act(y) and act(conv1) as the tier's planes (bf16 hi and lo at
  // "high", bf16 at "default", fp32 tf32 big and small at "highest"; one
  // buffer in place at "highest" from C = 48: in_place), and a guard past
  // them for the lanes a warpgroup reads beyond the window (up to 256 - W +
  // halo of them, 16 bytes each); each chunk plane holds W + 1 lanes.
  const size_t elem = tier == 0 ? sizeof(float) : sizeof(bf16);
  const size_t planes = tier == 2 ? 1 : 2;
  const size_t buffers = in_place(a.C, tier) ? 1 : 2;
  const size_t slot =
      ring_slot_bytes(a.chunk, (int)(planes * elem) * a.C * a.C / tap_units(a.C, tier));
  const size_t smem = 1024 + a.ring * slot + ring_barrier_bytes(a.ring) +
                      buffers * planes * elem * (a.width + 1) * a.C +
                      16 * (size_t)(kWindow - a.width + a.halo);
  if (tier == 0) return start_highest<kMean, kFolded>(a, B, smem, device, stream);
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

}  // namespace piper_rb

using namespace piper_rb;

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
