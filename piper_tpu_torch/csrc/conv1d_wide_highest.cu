// K1's wide design at "highest" (3xTF32 on wgmma), in its own translation
// unit so that nvcc compiles it beside conv1d_wide.cu's "high";
// conv1d_wide.cu's header says what the kernel computes and how it is laid
// out.

#include "conv1d_wide.cuh"

namespace piper_k1w {

int start_highest(const Args& a, size_t smem, int device, void* stream) {
  return start<0>(a, smem, device, stream);
}

}  // namespace piper_k1w
