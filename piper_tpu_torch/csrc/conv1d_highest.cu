// K1 at "highest" (3xTF32 on wgmma), in its own translation unit so that
// nvcc compiles it beside conv1d.cu's bf16 tiers; conv1d.cu's header says
// what the kernel computes and how it is laid out.

#include "conv1d.cuh"

namespace piper_k1 {

int start_highest(const Args& a, int cp, size_t smem, int device, void* stream) {
  return start_tier<0, float>(a, cp, smem, device, stream);
}

}  // namespace piper_k1
